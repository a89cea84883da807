// Embedding row gather for Hopper (sm_90a), and its backward: a
// deterministic sorted segment-sum.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/embedding.py
// (_pallas_gather :63, pallas_call :74, body _gather_kernel :58) together
// with the semantics its wrapper embedding_gather (:107-136) adds: a
// negative id reads row 0, an id >= V gives a row of NaN (jnp.take's fill
// mode), and an id equal to padding_idx gives a row of zeros.
//
// What bounds it on the H100: it only moves bytes, n rows of D elements
// read and written (25 MB per table at n=4096, D=768 in float32, ~7.5 us
// at 3.35 TB/s), plus the ids.
//
// Design: one warp per id, eight ids per 256-thread block.  The warp
// copies its row with the widest vector the row size allows: 16-byte
// (uint4) copies when the row is a multiple of 16 bytes, as every
// BERT table is (D=768), else 4- or 2-byte ones.  The TPU kernel gets its
// ids by scalar prefetch; here each warp loads its own id.  Fills are
// written with the same vector width: a float32 NaN is 0x7fc00000, a
// bfloat16 NaN 0x7fc0.

// The backward (segment_sum_kernel) replaces the scatter-add the reference
// leaves to XLA (_gather_core_bwd, embedding.py:96-101): duplicate ids
// accumulate in float32, a negative id feeds row 0, an id >= V or equal to
// padding_idx sends nothing, and the sums are cast to dout's type.  CUDA's
// atomics (index_add_) would add duplicates in an order that changes from
// run to run; here the order is fixed.  The wrapper sorts the clamped ids
// (a stable torch.sort; dropped ids take the key V and sort last) and finds
// each sorted position's segment [lo, hi) of equal keys (torch.searchsorted)
// -- index preparation, with no shape that depends on the data, so a CUDA
// graph captures it.  Then one launch, one block per sorted position: the
// block at the start of a piece of kPiece positions of a segment sums
// dout[perm[j]] over its piece in sorted order (one thread a column).  A
// segment of at most kPiece positions is written at once, in the order of
// the ids, as index_add_ adds them on the CPU; a longer one's pieces go to
// a float32 workspace, and the piece that arrives last (a ticket per
// segment, atomicAdd after a fence) adds the partials in piece order and
// writes the row.  Rows no id touches stay as the wrapper zeroed them.
//
// What bounds it: bytes -- the zeroed table written once (94 MB for
// BERT-base's vocabulary in float32) and dout read once (12.6 MB at
// n=4096, D=768).  The ticket makes the sums of long segments (the token
// type table: two ids over 4096 positions) run in parallel pieces.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;

template <typename V>
__device__ __forceinline__ V splat(uint32_t word);
template <>
__device__ __forceinline__ uint4 splat<uint4>(uint32_t w) {
  return make_uint4(w, w, w, w);
}
template <>
__device__ __forceinline__ uint32_t splat<uint32_t>(uint32_t w) { return w; }
template <>
__device__ __forceinline__ uint16_t splat<uint16_t>(uint32_t w) {
  return (uint16_t)(w & 0xffffu);
}

template <typename IdT, typename V>
__global__ void __launch_bounds__(kWarps * 32)
gather_kernel(const V* __restrict__ table, const IdT* __restrict__ ids,
              V* __restrict__ out, long long n, long long rows,
              long long vecs_per_row, long long padding_idx,
              uint32_t nan_word) {
  const int lane = threadIdx.x % 32;
  const long long i = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (i >= n) return;
  const long long id = (long long)ids[i];
  V* dst = out + i * vecs_per_row;
  const bool pad = padding_idx != -1 && id == padding_idx;
  if (pad || id >= rows) {
    const V fill = splat<V>(pad ? 0u : nan_word);
    for (long long c = lane; c < vecs_per_row; c += 32) dst[c] = fill;
    return;
  }
  const V* src = table + (id < 0 ? 0 : id) * vecs_per_row;
  for (long long c = lane; c < vecs_per_row; c += 32) dst[c] = src[c];
}

template <typename IdT, typename V>
int launch(const void* table, const void* ids, void* out, long long n,
           long long rows, long long row_bytes, long long padding_idx,
           uint32_t nan_word, cudaStream_t stream) {
  const long long blocks = (n + kWarps - 1) / kWarps;
  gather_kernel<IdT, V><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      (const V*)table, (const IdT*)ids, (V*)out, n, rows,
      row_bytes / (long long)sizeof(V), padding_idx, nan_word);
  return (int)cudaGetLastError();
}

template <typename IdT>
int dispatch(const void* table, const void* ids, void* out, long long n,
             long long rows, long long row_bytes, long long padding_idx,
             uint32_t nan_word, cudaStream_t stream) {
  if (row_bytes % 16 == 0)
    return launch<IdT, uint4>(table, ids, out, n, rows, row_bytes,
                              padding_idx, nan_word, stream);
  if (row_bytes % 4 == 0)
    return launch<IdT, uint32_t>(table, ids, out, n, rows, row_bytes,
                                 padding_idx, nan_word, stream);
  return launch<IdT, uint16_t>(table, ids, out, n, rows, row_bytes,
                               padding_idx, nan_word, stream);
}

constexpr int kPiece = 16;
constexpr int kBwdThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
segment_sum_kernel(const T* __restrict__ dout,
                   const long long* __restrict__ keys,
                   const long long* __restrict__ perm,
                   const long long* __restrict__ lo,
                   const long long* __restrict__ hi, T* __restrict__ out,
                   float* __restrict__ ws, int* __restrict__ tickets,
                   long long rows, int d) {
  const long long i = blockIdx.x;
  const long long key = keys[i];
  if (key >= rows) return;  // a dropped id
  const long long s0 = lo[i], s1 = hi[i];
  if ((i - s0) % kPiece != 0) return;  // not the start of a piece
  const long long end = i + kPiece < s1 ? i + kPiece : s1;
  const bool whole = s1 - s0 <= kPiece;
  for (int c = threadIdx.x; c < d; c += kBwdThreads) {
    float acc = 0.f;
#pragma unroll 4
    for (long long j = i; j < end; ++j) acc += pt::to_f(dout[perm[j] * d + c]);
    if (whole)
      out[key * d + c] = pt::from_f<T>(acc);
    else
      ws[i * d + c] = acc;
  }
  if (whole) return;
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int pieces = (int)((s1 - s0 + kPiece - 1) / kPiece);
    last = atomicAdd(&tickets[s0], 1) == pieces - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int c = threadIdx.x; c < d; c += kBwdThreads) {
    float acc = 0.f;
    for (long long j = s0; j < s1; j += kPiece) acc += __ldcg(&ws[j * d + c]);
    out[key * d + c] = pt::from_f<T>(acc);
  }
}

}  // namespace

// table [rows, d] contiguous float32 or bfloat16, ids [n] int32 or int64,
// out [n, d] like table; padding_idx -1 for none (any other value, even
// a negative one, zeroes the rows of ids equal to it, as the reference's
// jnp.where does).  Returns the launch's
// cudaError_t.
extern "C" int pt_embedding_gather_fwd(const void* table, const void* ids,
                                       void* out, long long n,
                                       long long rows, int d,
                                       long long padding_idx,
                                       int ids_are_int64, int dtype,
                                       void* stream) {
  if (n < 1 || rows < 1 || d < 1 || (n + kWarps - 1) / kWarps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  long long elt;
  uint32_t nan_word;
  if (dtype == pt::kFloat32) {
    elt = 4;
    nan_word = 0x7fc00000u;
  } else if (dtype == pt::kBFloat16) {
    elt = 2;
    nan_word = 0x7fc07fc0u;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const long long row_bytes = elt * d;
  cudaStream_t s = (cudaStream_t)stream;
  if (ids_are_int64)
    return dispatch<long long>(table, ids, out, n, rows, row_bytes,
                               padding_idx, nan_word, s);
  return dispatch<int>(table, ids, out, n, rows, row_bytes, padding_idx,
                       nan_word, s);
}

// The gather's table gradient.  dout [n, d] contiguous float32 or
// bfloat16; keys, perm, lo, hi [n] int64 from the wrapper's index
// preparation (sorted keys, their positions in the ids, each position's
// segment); out [rows, d] like dout, zeroed; ws [n, d] float32; tickets [n]
// int32, zeroed.  Returns the launch's cudaError_t.
extern "C" int pt_embedding_gather_bwd(const void* dout, const void* keys,
                                       const void* perm, const void* lo,
                                       const void* hi, void* out, void* ws,
                                       void* tickets, long long n,
                                       long long rows, int d, int dtype,
                                       void* stream) {
  if (n < 1 || rows < 1 || d < 1 || n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long *k = (const long long*)keys, *p = (const long long*)perm,
                  *l = (const long long*)lo, *h = (const long long*)hi;
  if (dtype == pt::kFloat32)
    segment_sum_kernel<float><<<(unsigned)n, kBwdThreads, 0, s>>>(
        (const float*)dout, k, p, l, h, (float*)out, (float*)ws,
        (int*)tickets, rows, d);
  else if (dtype == pt::kBFloat16)
    segment_sum_kernel<__nv_bfloat16><<<(unsigned)n, kBwdThreads, 0, s>>>(
        (const __nv_bfloat16*)dout, k, p, l, h, (__nv_bfloat16*)out,
        (float*)ws, (int*)tickets, rows, d);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
