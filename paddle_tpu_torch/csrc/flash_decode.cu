// Single-query decode attention for Hopper (sm_90a): the ring-cache kernel
// (K5) and the paged-pool kernel (K6).
//
// K5 replaces the Pallas TPU kernel paddle_tpu/ops/pallas/flash_decode.py
// (_flash_decode_call :172, pallas_call :178, body _decode_kernel :121):
// one query row per (sequence, head) against its ring cache [Tmax, Dh],
// online softmax over the keys below the row's length, f32 statistics, a
// row of length 0 gives zeros (the l == 0 guard, :168).  K6 replaces
// paddle_tpu/ops/pallas/paged_flash_decode.py (_paged_flash_decode_call
// :155, pallas_call :185, body _paged_decode_kernel :104): the same row
// loop, with cache row j of row r read from pool block table[s, j / BL]
// (s = r / H) at offset j % BL, head h = r % H; a -1 entry is clamped to
// block 0 (safe_tab, :166), as is an id past the pool, and no block that
// starts at or past the length is read.
//
// What bounds it on the H100: bytes.  A row reads length x Dh keys and as
// many values once and does 4 x length x Dh flops, far below the ridge
// point; at 8 x 12 rows of 1024 keys and Dh 64 in float32 that is 50 MB,
// ~15 us at 3.35 TB/s.  The TPU kernel streams fixed 512-key blocks and
// skips those past the cursor; here the loop simply ends at the length,
// so a row that is 40 keys deep reads 40 keys.
//
// Design: one 256-thread block per row.  Eight lanes share one key: each
// holds Dh/8 consecutive elements of q, loads the same slice of the key
// and the value with 16-byte loads (a warp reads four whole rows, so the
// loads coalesce) and reduces the dot product with three shuffles.  The
// 32 lane groups of the block take keys j, j + 32, ... two at a time (to
// keep more loads in flight) and each keeps its own running max m, sum l
// and Dh/8 accumulators, so no group waits on another.  At the end the
// groups merge through shared memory: M = max m_g, L = sum l_g e^(m_g-M),
// o = sum acc_g e^(m_g-M) / L, with L == 0 read as 1.  A group that saw
// no key has m = -1e30 (NEG_INF) and l = 0 and adds nothing.  The
// unnormalised p is rounded to the cache's type before the PV product,
// as the TPU kernel's p.astype(v.dtype).  The paged kernel first copies
// the live part of its table row into shared memory, clamped, so the
// block lookup is a shared-memory read and not a dependent global load
// per 16-row block.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLanesPerKey = 8;
constexpr int kGroups = kThreads / kLanesPerKey;  // 32 keys in flight
constexpr float kNegInf = -1e30f;
constexpr int kMaxTableBlocks = 4096;  // 16 KB of table row in shared memory

template <typename T>
struct PerWord;  // elements of T in one 32-bit word
template <>
struct PerWord<float> {
  static constexpr int n = 1;
};
template <>
struct PerWord<__nv_bfloat16> {
  static constexpr int n = 2;
};

__device__ __forceinline__ void unpack(uint32_t w, float* out, float) {
  out[0] = __uint_as_float(w);
}
__device__ __forceinline__ void unpack(uint32_t w, float* out,
                                       __nv_bfloat16) {
  out[0] = __uint_as_float(w << 16);  // element 0 is the low half
  out[1] = __uint_as_float(w & 0xffff0000u);
}

// N consecutive elements of T at p (16-byte aligned: Dh is 64 or 128, so a
// lane's slice is 32 to 64 bytes) as floats, with 16-byte loads.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* __restrict__ p,
                                       float (&out)[N]) {
  constexpr int kPer = PerWord<T>::n;
  static_assert(N % (4 * kPer) == 0, "a lane's slice is whole uint4s");
#pragma unroll
  for (int i = 0; i < N / (4 * kPer); ++i) {
    const uint4 x = reinterpret_cast<const uint4*>(p)[i];
    float* o = out + 4 * i * kPer;
    unpack(x.x, o, T());
    unpack(x.y, o + kPer, T());
    unpack(x.z, o + 2 * kPer, T());
    unpack(x.w, o + 3 * kPer, T());
  }
}

// The byte offset of cache row j of this kernel's row: ring caches are
// [rows, Tmax, Dh]; the paged pool is [N, H, BL, Dh] reached through the
// staged table row.
struct RingRows {
  long long base;  // first element of this row's cache
  __device__ __forceinline__ long long at(int j, int dh) const {
    return base + (long long)j * dh;
  }
};

struct PagedRows {
  const int* tab;  // the staged, clamped table row (shared memory)
  int heads, head, block_len;
  __device__ __forceinline__ long long at(int j, int dh) const {
    const int blk = tab[j / block_len];
    return (((long long)blk * heads + head) * block_len + j % block_len) *
           (long long)dh;
  }
};

template <typename T, int DH, typename Rows>
__device__ __forceinline__ void decode_row(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int row, int len,
    float sm_scale, const Rows& rows) {
  constexpr int E = DH / kLanesPerKey;  // elements per lane
  __shared__ float s_m[kGroups];
  __shared__ float s_l[kGroups];
  __shared__ float s_acc[kGroups][DH];

  const int tid = threadIdx.x;
  const int group = tid / kLanesPerKey;
  const int sub = tid % kLanesPerKey;
  const int col = sub * E;

  float qf[E];
  load_f<T, E>(q + (long long)row * DH + col, qf);
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  float m = kNegInf, l = 0.f;

  // the loop bound is the warp's first key, so every lane of a warp runs
  // the same iterations and the full-mask shuffles are legal; a lane
  // group past the length only masks its keys out
  const int warp_first = (tid / 32) * (32 / kLanesPerKey);
  for (int w0 = warp_first; w0 < len; w0 += 2 * kGroups) {
    const int j0 = w0 + group - warp_first;
    const int j1 = j0 + kGroups;
    const bool has0 = j0 < len, has1 = j1 < len;
    float k0[E], v0[E], k1[E], v1[E];
    float d0 = 0.f, d1 = 0.f;
    if (has0) {
      load_f<T, E>(k + rows.at(j0, DH) + col, k0);
      load_f<T, E>(v + rows.at(j0, DH) + col, v0);
    }
    if (has1) {
      load_f<T, E>(k + rows.at(j1, DH) + col, k1);
      load_f<T, E>(v + rows.at(j1, DH) + col, v1);
    }
    if (has0) {
#pragma unroll
      for (int e = 0; e < E; ++e) d0 = fmaf(qf[e], k0[e], d0);
    }
    if (has1) {
#pragma unroll
      for (int e = 0; e < E; ++e) d1 = fmaf(qf[e], k1[e], d1);
    }
#pragma unroll
    for (int off = kLanesPerKey / 2; off > 0; off >>= 1) {
      d0 += __shfl_xor_sync(0xffffffffu, d0, off);
      d1 += __shfl_xor_sync(0xffffffffu, d1, off);
    }
    if (!has0) continue;  // has1 implies has0
    const float s0 = d0 * sm_scale;
    const float s1 = has1 ? d1 * sm_scale : kNegInf;
    const float m_new = fmaxf(m, fmaxf(s0, s1));
    const float alpha = expf(m - m_new);
    const float p0 = expf(s0 - m_new);
    const float p1 = has1 ? expf(s1 - m_new) : 0.f;
    l = l * alpha + p0 + p1;
    const float r0 = pt::round_to<T>(p0), r1 = pt::round_to<T>(p1);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float a = acc[e] * alpha + r0 * v0[e];
      if (has1) a = fmaf(r1, v1[e], a);
      acc[e] = a;
    }
    m = m_new;
  }

  if (sub == 0) {
    s_m[group] = m;
    s_l[group] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) s_acc[group][col + e] = acc[e];
  __syncthreads();
  if (tid < DH) {
    float big = kNegInf;
    for (int g = 0; g < kGroups; ++g) big = fmaxf(big, s_m[g]);
    float den = 0.f, num = 0.f;
    for (int g = 0; g < kGroups; ++g) {
      const float w = expf(s_m[g] - big);
      den = fmaf(s_l[g], w, den);
      num = fmaf(s_acc[g][tid], w, num);
    }
    if (den == 0.f) den = 1.f;  // no live key: zeros, not NaN
    o[(long long)row * DH + tid] = pt::from_f<T>(num / den);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ o, int tmax, float sm_scale) {
  const int row = blockIdx.x;
  const int len = min(max(lengths[row], 0), tmax);
  const RingRows rows{(long long)row * tmax * DH};
  decode_row<T, DH>(q, k, v, o, row, len, sm_scale, rows);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int* __restrict__ lengths,
                    const int* __restrict__ table, T* __restrict__ o,
                    int heads, int num_blocks, int block_len,
                    int max_blocks, float sm_scale) {
  extern __shared__ int s_tab[];
  const int row = blockIdx.x;
  const int seq = row / heads;
  const int len = min(max(lengths[row], 0), max_blocks * block_len);
  const int live = (len + block_len - 1) / block_len;
  const int* trow = table + (long long)seq * max_blocks;
  for (int i = threadIdx.x; i < live; i += kThreads) {
    const int b = trow[i];
    s_tab[i] = b < 0 ? 0 : (b >= num_blocks ? num_blocks - 1 : b);
  }
  __syncthreads();
  const PagedRows rows{s_tab, heads, row % heads, block_len};
  decode_row<T, DH>(q, k, v, o, row, len, sm_scale, rows);
}

template <typename T, int DH>
int launch_ring(const void* q, const void* k, const void* v,
                const int* lengths, void* o, int rows, int tmax,
                float sm_scale, cudaStream_t s) {
  decode_kernel<T, DH><<<rows, kThreads, 0, s>>>(
      (const T*)q, (const T*)k, (const T*)v, lengths, (T*)o, tmax,
      sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_paged(const void* q, const void* k, const void* v,
                 const int* lengths, const int* table, void* o, int rows,
                 int heads, int num_blocks, int block_len, int max_blocks,
                 float sm_scale, cudaStream_t s) {
  const size_t smem = sizeof(int) * (size_t)max_blocks;
  paged_decode_kernel<T, DH><<<rows, kThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, lengths, table, (T*)o, heads,
      num_blocks, block_len, max_blocks, sm_scale);
  return (int)cudaGetLastError();
}

// Returns LAUNCH<T, DH>(args...) for the dtype code and head dim, or
// cudaErrorInvalidValue for a pair the kernels do not take.
#define PT_DECODE_DISPATCH(LAUNCH, DTYPE, DH, ...)                       \
  do {                                                                  \
    if ((DTYPE) == pt::kFloat32) {                                      \
      switch (DH) {                                                     \
        case 64: return LAUNCH<float, 64>(__VA_ARGS__);                 \
        case 128: return LAUNCH<float, 128>(__VA_ARGS__);               \
      }                                                                 \
    } else if ((DTYPE) == pt::kBFloat16) {                              \
      switch (DH) {                                                     \
        case 64: return LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);         \
        case 128: return LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);       \
      }                                                                 \
    }                                                                   \
    return (int)cudaErrorInvalidValue;                                  \
  } while (0)

}  // namespace

// q [rows, Dh], k/v [rows, Tmax, Dh] contiguous in one dtype (float32 or
// bfloat16), lengths int32 [rows] (clamped to [0, Tmax] here too), o
// [rows, Dh] like q.  Dh is 64 or 128.  Returns the launch's
// cudaError_t.
extern "C" int pt_flash_decode_fwd(const void* q, const void* k,
                                   const void* v, const int* lengths,
                                   void* o, int rows, int tmax, int dh,
                                   float sm_scale, int dtype,
                                   void* stream) {
  if (rows < 1 || tmax < 1) return (int)cudaErrorInvalidValue;
  PT_DECODE_DISPATCH(launch_ring, dtype, dh, q, k, v, lengths, o, rows,
                     tmax, sm_scale, (cudaStream_t)stream);
}

// q [S*H, Dh]; k/v pools [N, H, BL, Dh] contiguous in q's dtype; lengths
// int32 [S*H] (clamped to [0, MB*BL]); table int32 [S, MB] (row s serves
// rows s*H .. s*H+H-1; -1 and ids >= N are clamped into the pool and
// never read past the length); o [S*H, Dh].  MB is at most 4096.
extern "C" int pt_paged_flash_decode_fwd(
    const void* q, const void* k, const void* v, const int* lengths,
    const int* table, void* o, int rows, int heads, int num_blocks,
    int block_len, int max_blocks, int dh, float sm_scale, int dtype,
    void* stream) {
  if (rows < 1 || heads < 1 || rows % heads || num_blocks < 1 ||
      block_len < 1 || max_blocks < 1 || max_blocks > kMaxTableBlocks)
    return (int)cudaErrorInvalidValue;
  PT_DECODE_DISPATCH(launch_paged, dtype, dh, q, k, v, lengths, table, o,
                     rows, heads, num_blocks, block_len, max_blocks,
                     sm_scale, (cudaStream_t)stream);
}
