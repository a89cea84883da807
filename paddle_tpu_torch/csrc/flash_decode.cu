// Single-query decode attention for Hopper (sm_90a): the ring-cache kernel
// (K5) and the paged-pool kernel (K6).
//
// K5 replaces the Pallas TPU kernel paddle_tpu/ops/pallas/flash_decode.py
// (_flash_decode_call :172, pallas_call :178, body _decode_kernel :121):
// one query row per (sequence, head) against its ring cache [Tmax, Dh],
// online softmax over the keys below the sequence's length, f32
// statistics, a row of length 0 gives zeros (the l == 0 guard, :168).  K6
// replaces paddle_tpu/ops/pallas/paged_flash_decode.py
// (_paged_flash_decode_call :155, pallas_call :185, body
// _paged_decode_kernel :104): the same row, with cache row j of row r read
// from pool block table[s, j / BL] (s = r / H) at offset j % BL, head
// h = r % H; a -1 entry is clamped to block 0 (safe_tab, :166), as is an
// id past the pool, and no block that starts at or past the length is
// read.
//
// What bounds it on the H100: bytes.  A row reads length x Dh keys and as
// many values once and does 4 x length x Dh flops, far below the ridge
// point; at 8 x 12 rows of 1024 keys and Dh 64 in float32 that is 50 MB,
// ~15 us at 3.35 TB/s.  The TPU kernel streams fixed 512-key blocks of a
// row in order and skips those past the cursor.  One block per row on
// this card leaves SMs idle and makes the longest row's single-SM stream
// the launch's time, so the keys of a row are split over many blocks
// ("flash-decoding") and merged in the same launch.
//
// Design.  The grid is rows x chunks (chunks = ceil(Tmax / C), from the
// shapes alone: the lengths stay on the device), C = 8192 / Dh keys a block
// (128 at Dh 64, 64 at Dh 128), blocks in chunk-major order so the chunks
// at the start of the rows, live in every row that is not empty, take the
// SMs first.  A block takes the keys [c*C, c*C + C) of one row and exits at
// once if they start at or past the row's length.  Its 256 threads form 32
// lane groups of 8 lanes; group g takes keys c*C + g, c*C + g + 32, ...,
// each lane Dh/8 consecutive elements of q, of the keys and of the values
// with 16-byte loads (a warp reads four whole rows, so the loads coalesce),
// all issued at once: a block keeps its whole chunk (64 KB at Dh 64 in
// float32) in flight. Dot products reduce over the 8 lanes with three
// shuffles; the chunk's max m_c comes from a warp shuffle and one pass
// through shared memory; then p = exp(s - m_c), rounded to the cache's type
// before the PV product (the TPU kernel's p.astype(v.dtype)), and l_c = sum
// p and acc_c = sum p v fold over a lane group's keys in order, over the
// warp's 4 lane groups (xor 8, 16) and then over the 8 warps in order.  A
// row that fits in one chunk writes o = acc_c / l_c.  Otherwise each live
// block writes its partial (m_c, l_c, acc_c[Dh]) in float32 to the
// workspace, and one thread draws a ticket from the row's counter (an
// acquire-release atomic, so no separate fence); the block that draws the
// last of the ceil(len / C) tickets stages the partials into shared memory
// (16-byte loads, 16 chunks at a time), merges them in chunk order (M = max
// m_c, L = sum l_c e^(m_c - M), o = sum acc_c e^(m_c - M) / L), writes o
// and sets the counter back to 0.  Arrival order never enters a sum, so a
// rerun gives the same bits, and the ring and paged kernels, which share
// this code and chunking, give the same bits for the same cache rows.  The
// paged kernel reads only its chunk's table entries (clamped into the pool)
// and stages the pool row of each of its keys into shared memory while the
// length is read: one division by the block length a thread, none per load.
// Lengths are per sequence (row / H), or one shared length read with a
// stride of 0.
//
// Probes on an H100 80GB HBM3 at 700 W (PERF.md): at Dh 64, chunks of 128
// keys and 256 threads a block were best or tied against 32 to 256 keys and
// 64 to 512 threads, and the merge staged in shared memory against one
// thread per column walking the partials in L2.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLanesPerKey = 8;
constexpr int kGroups = kThreads / kLanesPerKey;  // 32 lane groups
constexpr int kChunkElems = 8192;  // a chunk's K elements: 128 keys at Dh 64
constexpr int kMaxChunk = kChunkElems / 64;  // keys a block, at most
constexpr int kBatch = 16;         // partials staged at once by the merge
constexpr float kNegInf = -1e30f;

// keys a block takes at head dim DH (128 at Dh 64, 64 at Dh 128: each
// thread holds the same number of K and V values)
template <int DH>
__host__ __device__ constexpr int chunk_keys() {
  return kChunkElems / DH;
}

// a partial's floats: m, l, two words of padding (acc 16-byte aligned),
// acc[DH]
template <int DH>
__host__ __device__ constexpr int part_stride() {
  return DH + 4;
}

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
// lane's slice is 16 to 64 bytes) as floats, with 16-byte loads.
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

// The element offset of cache row j of this block's row: ring caches are
// [rows, Tmax, Dh]; in the paged pool [N, H, BL, Dh] the chunk's keys sit
// at the pool rows the block staged (key c0 first).
struct RingRows {
  long long base;  // first element of this row's cache
  __device__ __forceinline__ long long at(int j, int dh) const {
    return base + (long long)j * dh;
  }
};

struct PagedRows {
  const int* pos;  // pool row of each of the chunk's keys (shared memory)
  int c0;
  __device__ __forceinline__ long long at(int j, int dh) const {
    return (long long)pos[j - c0] * dh;
  }
};

// The row's last live block: o from the partials of its `live` chunks,
// merged in chunk order (M = max m_c, L = sum l_c e^(m_c - M), o = sum
// acc_c e^(m_c - M) / L), staged kBatch partials at a time into shared
// memory with 16-byte loads that skip L1 (other SMs wrote them).
template <typename T, int DH>
__device__ __forceinline__ void merge_partials(const float* prow, int live,
                                               T* __restrict__ orow) {
  constexpr int P = part_stride<DH>();
  __shared__ __align__(16) float s_part[kBatch * P];
  __shared__ float s_big[kWarps];
  const int tid = threadIdx.x;
  float big = kNegInf;
  if (live > kBatch) {  // the max first, when the partials take batches
    for (int c = tid; c < live; c += kThreads)
      big = fmaxf(big, __ldcg(prow + c * P));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      big = fmaxf(big, __shfl_xor_sync(0xffffffffu, big, off));
    if ((tid & 31) == 0) s_big[tid >> 5] = big;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) big = fmaxf(big, s_big[w]);
  }
  float den = 0.f, num = 0.f;
  for (int b0 = 0; b0 < live; b0 += kBatch) {
    const int n = min(kBatch, live - b0);
    const float4* src = reinterpret_cast<const float4*>(prow + b0 * P);
    for (int i = tid; i < n * P / 4; i += kThreads)
      reinterpret_cast<float4*>(s_part)[i] = __ldcg(src + i);
    __syncthreads();
    if (live <= kBatch)
      for (int c = 0; c < n; ++c) big = fmaxf(big, s_part[c * P]);
    if (tid < DH) {
      for (int c = 0; c < n; ++c) {
        const float w = expf(s_part[c * P] - big);
        den = fmaf(s_part[c * P + 1], w, den);
        num = fmaf(s_part[c * P + 4 + tid], w, num);
      }
    }
    __syncthreads();
  }
  if (tid < DH) orow[tid] = pt::from_f<T>(num / den);
}

// Chunk `chunk` of row `row` (len > chunk * chunk_keys<DH>()): the
// partial, and o if this block is the row's only or last live block.  qf
// is this lane's slice of q.
template <typename T, int DH, typename Rows>
__device__ __forceinline__ void decode_chunk(
    const float (&qf)[DH / kLanesPerKey], const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ ws,
    int* __restrict__ counters, int row, int chunk, int chunks, int len,
    float sm_scale, const Rows& rows) {
  constexpr int E = DH / kLanesPerKey;  // elements per lane
  constexpr int C = chunk_keys<DH>();
  constexpr int KPG = C / kGroups;      // keys per lane group
  constexpr int P = part_stride<DH>();
  __shared__ float s_max[kWarps];
  __shared__ float s_l[kWarps];
  __shared__ float s_acc[kWarps][DH];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int group = tid / kLanesPerKey;
  const int col = (tid % kLanesPerKey) * E;
  const int c0 = chunk * C;

  // every key and value of the chunk in flight at once
  float kk[KPG][E], vv[KPG][E];
  bool has[KPG];
#pragma unroll
  for (int i = 0; i < KPG; ++i) {
    const int j = c0 + group + i * kGroups;
    has[i] = j < len;
    if (has[i]) {
      load_f<T, E>(k + rows.at(j, DH) + col, kk[i]);
      load_f<T, E>(v + rows.at(j, DH) + col, vv[i]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) kk[i][e] = vv[i][e] = 0.f;
    }
  }
  float s[KPG];
  float mx = kNegInf;
#pragma unroll
  for (int i = 0; i < KPG; ++i) {
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) d = fmaf(qf[e], kk[i][e], d);
#pragma unroll
    for (int off = kLanesPerKey / 2; off > 0; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    s[i] = has[i] ? d * sm_scale : kNegInf;
    mx = fmaxf(mx, s[i]);
  }

  // the chunk's max: over the warp's 4 lane groups, then the 8 warps
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
  if (lane == 0) s_max[warp] = mx;
  __syncthreads();
  float m = s_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, s_max[w]);

  float l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
#pragma unroll
  for (int i = 0; i < KPG; ++i) {
    const float p = has[i] ? expf(s[i] - m) : 0.f;
    l += p;
    const float r = pt::round_to<T>(p);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = fmaf(r, vv[i][e], acc[e]);
  }
#pragma unroll
  for (int off = kLanesPerKey; off < 32; off <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  if (lane < kLanesPerKey) {
#pragma unroll
    for (int e = 0; e < E; ++e) s_acc[warp][col + e] = acc[e];
    if (lane == 0) s_l[warp] = l;
  }
  __syncthreads();

  const int live = (len + C - 1) / C;
  float a = 0.f, lsum = 0.f;
  if (tid < DH) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += s_acc[w][tid];
      lsum += s_l[w];
    }
  }
  T* orow = o + (long long)row * DH;
  if (live == 1) {  // the whole row: l >= 1 (its max key has p = 1)
    if (tid < DH) orow[tid] = pt::from_f<T>(a / lsum);
    return;
  }

  float* prow = ws + (long long)row * chunks * P;
  float* part = prow + chunk * P;
  if (tid < DH) part[4 + tid] = a;
  if (tid == 0) {
    part[0] = m;
    part[1] = lsum;
  }
  // the barrier orders the block's partial before thread 0's ticket, whose
  // release makes it visible to the row's last block and whose acquire
  // (in that block, passed on by the next barrier) shows it the others'
  __syncthreads();
  if (tid == 0) {
    int ticket;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(ticket)
                 : "l"(counters + row)
                 : "memory");
    s_last = ticket == live - 1;
  }
  __syncthreads();
  if (!s_last) return;
  merge_partials<T, DH>(prow, live, orow);
  if (tid == 0) counters[row] = 0;  // every ticket of the row is drawn
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ o, float* __restrict__ ws,
              int* __restrict__ counters, int heads, int tmax, int chunks,
              int len_stride, float sm_scale) {
  constexpr int E = DH / kLanesPerKey;
  const int rows_n = gridDim.x / chunks;
  const int chunk = blockIdx.x / rows_n;  // chunk-major: live blocks first
  const int row = blockIdx.x - chunk * rows_n;
  const int len =
      min(max(lengths[(row / heads) * len_stride], 0), tmax);
  float qf[E];
  load_f<T, E>(q + (long long)row * DH + (threadIdx.x % kLanesPerKey) * E,
               qf);
  if (len == 0) {  // no live key: the chunk-0 block writes the zeros
    if (chunk == 0 && threadIdx.x < DH)
      o[(long long)row * DH + threadIdx.x] = pt::from_f<T>(0.f);
    return;
  }
  if (chunk * chunk_keys<DH>() >= len) return;
  const RingRows rows{(long long)row * tmax * DH};
  decode_chunk<T, DH>(qf, k, v, o, ws, counters, row, chunk, chunks, len,
                      sm_scale, rows);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int* __restrict__ lengths,
                    const int* __restrict__ table, T* __restrict__ o,
                    float* __restrict__ ws, int* __restrict__ counters,
                    int heads, int num_blocks, int block_len,
                    int max_blocks, int chunks, int len_stride,
                    float sm_scale) {
  constexpr int E = DH / kLanesPerKey;
  constexpr int C = chunk_keys<DH>();
  __shared__ int s_pos[kMaxChunk];
  const int rows_n = gridDim.x / chunks;
  const int chunk = blockIdx.x / rows_n;  // chunk-major: live blocks first
  const int row = blockIdx.x - chunk * rows_n;
  const int seq = row / heads;
  const int tmax = max_blocks * block_len;
  const int c0 = chunk * C;
  // the pool row of each of the chunk's keys, from its table entry
  // (clamped into the pool), staged while the length is read
  if ((int)threadIdx.x < C) {
    const int j = min(c0 + (int)threadIdx.x, tmax - 1);
    const int e = j / block_len;
    int b = table[(long long)seq * max_blocks + e];
    b = b < 0 ? 0 : (b >= num_blocks ? num_blocks - 1 : b);
    s_pos[threadIdx.x] =
        (b * heads + row % heads) * block_len + (j - e * block_len);
  }
  const int len = min(max(lengths[seq * len_stride], 0), tmax);
  float qf[E];
  load_f<T, E>(q + (long long)row * DH + (threadIdx.x % kLanesPerKey) * E,
               qf);
  if (len == 0) {
    if (chunk == 0 && threadIdx.x < DH)
      o[(long long)row * DH + threadIdx.x] = pt::from_f<T>(0.f);
    return;
  }
  if (c0 >= len) return;
  __syncthreads();
  const PagedRows rows{s_pos, c0};
  decode_chunk<T, DH>(qf, k, v, o, ws, counters, row, chunk, chunks, len,
                      sm_scale, rows);
}

template <typename T, int DH>
int launch_ring(const void* q, const void* k, const void* v,
                const int* lengths, void* o, float* ws, int* counters,
                int rows, int heads, int tmax, int len_stride,
                float sm_scale, cudaStream_t s) {
  const int chunks = (tmax + chunk_keys<DH>() - 1) / chunk_keys<DH>();
  decode_kernel<T, DH><<<(unsigned)rows * chunks, kThreads, 0, s>>>(
      (const T*)q, (const T*)k, (const T*)v, lengths, (T*)o, ws, counters,
      heads, tmax, chunks, len_stride, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_paged(const void* q, const void* k, const void* v,
                 const int* lengths, const int* table, void* o, float* ws,
                 int* counters, int rows, int heads, int num_blocks,
                 int block_len, int max_blocks, int len_stride,
                 float sm_scale, cudaStream_t s) {
  const int tmax = max_blocks * block_len;
  const int chunks = (tmax + chunk_keys<DH>() - 1) / chunk_keys<DH>();
  paged_decode_kernel<T, DH><<<(unsigned)rows * chunks, kThreads, 0, s>>>(
      (const T*)q, (const T*)k, (const T*)v, lengths, table, (T*)o, ws,
      counters, heads, num_blocks, block_len, max_blocks, chunks,
      len_stride, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int occupancy(int paged) {
  int n = 0;
  const cudaError_t err =
      paged ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &n, paged_decode_kernel<T, DH>, kThreads, 0)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &n, decode_kernel<T, DH>, kThreads, 0);
  return err == cudaSuccess ? n : -(int)err;
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

// A launch the kernels do not take: the chunk the wrapper sized the
// workspace for is not the kernels' (kChunkElems / Dh), a lengths' stride
// other than 0 or 1, or more rows x chunks blocks than the grid holds.
bool bad_launch(int rows, int heads, long long tmax, int dh, int chunk,
                int len_stride) {
  if (rows < 1 || heads < 1 || rows % heads || tmax < 1 ||
      tmax > 0x7fffffffLL - kMaxChunk || dh < 1 ||
      chunk != kChunkElems / dh || (len_stride != 0 && len_stride != 1))
    return true;
  return rows * ((tmax + chunk - 1) / chunk) > 0x7fffffffLL;
}

}  // namespace

// q [rows, Dh], k/v [rows, Tmax, Dh] contiguous in one dtype (float32 or
// bfloat16), rows = S*H; lengths int32, the length of sequence s at
// lengths[s * len_stride] (stride 1: [S]; stride 0: one shared length),
// clamped to [0, Tmax] here; o [rows, Dh] like q; ws float32 [rows,
// chunks, Dh + 4] scratch (chunks = ceil(Tmax / chunk)); counters int32
// [rows], all 0, and left at 0.  chunk must be the kernels' keys a block,
// 8192 / Dh.  Dh is 64 or 128.  Returns the launch's cudaError_t.
extern "C" int pt_flash_decode_fwd(const void* q, const void* k,
                                   const void* v, const int* lengths,
                                   void* o, void* ws, void* counters,
                                   int rows, int heads, int tmax, int dh,
                                   int len_stride, int chunk,
                                   float sm_scale, int dtype,
                                   void* stream) {
  if (bad_launch(rows, heads, tmax, dh, chunk, len_stride))
    return (int)cudaErrorInvalidValue;
  PT_DECODE_DISPATCH(launch_ring, dtype, dh, q, k, v, lengths, o,
                     (float*)ws, (int*)counters, rows, heads, tmax,
                     len_stride, sm_scale, (cudaStream_t)stream);
}

// q [S*H, Dh]; k/v pools [N, H, BL, Dh] contiguous in q's dtype; lengths
// as for the ring kernel (clamped to [0, MB*BL]); table int32 [S, MB] (row
// s serves rows s*H .. s*H+H-1; -1 and ids >= N are clamped into the pool
// and never read past the length); o [S*H, Dh]; ws, counters and chunk as
// for the ring kernel with Tmax = MB*BL.
extern "C" int pt_paged_flash_decode_fwd(
    const void* q, const void* k, const void* v, const int* lengths,
    const int* table, void* o, void* ws, void* counters, int rows,
    int heads, int num_blocks, int block_len, int max_blocks, int dh,
    int len_stride, int chunk, float sm_scale, int dtype, void* stream) {
  if (num_blocks < 1 || block_len < 1 || max_blocks < 1 ||
      (long long)num_blocks * heads * block_len > 0x7fffffffLL ||
      bad_launch(rows, heads, (long long)max_blocks * block_len, dh, chunk,
                 len_stride))
    return (int)cudaErrorInvalidValue;
  PT_DECODE_DISPATCH(launch_paged, dtype, dh, q, k, v, lengths, table, o,
                     (float*)ws, (int*)counters, rows, heads, num_blocks,
                     block_len, max_blocks, len_stride, sm_scale,
                     (cudaStream_t)stream);
}

// Blocks of the ring (paged 0) or paged (1) kernel one SM holds at once
// for the dtype code and head dim (negated cudaError_t on failure).
extern "C" int pt_flash_decode_blocks_per_sm(int paged, int dh,
                                             int dtype) {
  PT_DECODE_DISPATCH(occupancy, dtype, dh, paged);
}
