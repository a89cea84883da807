// Embedding row gather for Hopper (sm_90a).
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
