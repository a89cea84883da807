// Embedding row gather for Hopper (sm_90a), and its backward: a
// deterministic scatter-add that writes every row of the table once.
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

// The backward replaces the scatter-add the reference leaves to XLA
// (_gather_core_bwd, embedding.py:96-101): duplicate ids accumulate in
// float32, a negative id feeds row 0, an id >= V or equal to padding_idx
// sends nothing, and the sums are cast to dout's type.  CUDA's atomics
// (index_add_) would add duplicates in an order that changes from run to
// run; here the order is fixed by the ids alone: a row with at most kLong
// ids adds them in the ids' order (as index_add_ does on the CPU), a
// longer row of L ids adds kParts parts of ids [k L / kParts, (k + 1) L /
// kParts), each in order, then the parts in order.  The ids are read as
// they come (int32 or int64); nothing runs on the host and nothing is
// sized by the data, so a CUDA graph captures the call.  Two launches:
//
// 1. embedding_bwd_rows_kernel writes every row of the table once.  Each
//    block owns up to 32 rows and scans all the ids itself (32 KB of
//    int64 at n=4096, from L2), keeping in shared memory each of its
//    rows' ids in order: no sort, no plan in device memory.  An untouched
//    row gets zeros; a row of at most kLong ids the sum of their rows of
//    dout, with 16-byte loads and stores where the row allows them.  A
//    longer row is marked (a bit a row) and left.
// 2. embedding_bwd_long_kernel sums the marked rows (the token-type
//    table: two ids over 4096 positions) as (row, 32 columns) items over
//    its blocks: warp w sums part w in order (32 loads in flight a lane),
//    the block adds the parts in part order and writes the 32 columns.
//    The merge is split over columns across blocks, with no serial tail.
//    With no marked row (BERT's word and position tables) its blocks read
//    the marks and exit; with n <= kLong it is not launched.
//
// What bounds it: bytes -- the table written once (94 MB for BERT-base's
// vocabulary in float32) and dout read once (12.6 MB at n=4096, D=768).
// The blocks' scans of the ids come from L2 (n x 8 bytes a block); no
// memset of the table and no second write of a row.

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

// ---- the backward: the rows (one pass over the table), then the long rows

constexpr int kBwdThreads = 512;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kIdsPerThread = 8;
constexpr int kChunk = kBwdThreads * kIdsPerThread;  // ids a block scans at once
constexpr int kMaxRowsPerBlock = 32;
constexpr int kMinRowBlocks = 132;    // a block an SM at least, rows allowing
constexpr int kLong = 32;             // a longer row is summed in parts
constexpr int kParts = kBwdWarps;
constexpr int kMaxLongBlocks = 2 * 132;
static_assert(kLong >= kParts, "every part of a long row is non-empty");

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// the table row an id sends its gradient to: row 0 for a negative id, -1
// for an id >= rows or equal to padding_idx (when that is not -1)
template <typename IdT>
__device__ __forceinline__ int row_of(IdT raw, int rows, long long pad) {
  const long long id = (long long)raw;
  if (id >= rows || (pad != -1 && id == pad)) return -1;
  return id < 0 ? 0 : (int)id;
}

// exclusive prefix sum of v over the block's threads in thread order;
// *total gets the sum.  Every thread of the block calls it.
__device__ __forceinline__ int block_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[w] = x;
  __syncthreads();
  if (w == 0) {
    int t = lane < kBwdWarps ? scratch[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kBwdWarps) scratch[lane] = t;
  }
  __syncthreads();
  *total = scratch[kBwdWarps - 1];
  const int before = w ? scratch[w - 1] : 0;
  __syncthreads();
  return before + x - v;
}

// Block k owns rows [k * per_block, (k + 1) * per_block).  It scans the
// ids a chunk at a time (kIdsPerThread consecutive ids a thread, so a
// block scan keeps their order), lists the positions that hit its rows in
// order, and one warp deals them to the rows' lists in order (each row's
// first kLong; __match_any_sync ranks a row's hits within 32) and counts
// them.  Then every row is written once: zeros, or the
// sum of its at most kLong rows of dout in the ids' order, VE elements an
// access, the block's (row, vector) pairs spread over its threads.  A row
// with more ids is left to embedding_bwd_long_kernel: its
// bit in the block's mask words (local row i: bit i % 32 of word
// k * words_per_block + i / 32) and its count in long_count[row].
template <typename IdT, typename T, int VE>
__global__ void __launch_bounds__(kBwdThreads)
embedding_bwd_rows_kernel(const IdT* __restrict__ ids, int n, int rows,
                          long long pad, const T* __restrict__ dout, int d,
                          int per_block, T* __restrict__ out,
                          unsigned* __restrict__ long_mask,
                          int* __restrict__ long_count) {
  __shared__ int hit_pos[kChunk];
  __shared__ unsigned char hit_row[kChunk];
  __shared__ int pos[kMaxRowsPerBlock][kLong];
  __shared__ int count[kMaxRowsPerBlock];
  __shared__ int scratch[kBwdWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r0 = blockIdx.x * per_block;
  const int nr = min(per_block, rows - r0);
  if (threadIdx.x < kMaxRowsPerBlock) count[threadIdx.x] = 0;
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int i0 = c0 + threadIdx.x * kIdsPerThread;
    int mine[kIdsPerThread], hits = 0;
#pragma unroll
    for (int k = 0; k < kIdsPerThread; ++k) {
      const int r = i0 + k < n ? row_of(ids[i0 + k], rows, pad) - r0 : -1;
      mine[k] = r >= 0 && r < nr ? r : -1;
      hits += mine[k] >= 0;
    }
    int total, at = block_scan(hits, scratch, &total);
#pragma unroll
    for (int k = 0; k < kIdsPerThread; ++k)
      if (mine[k] >= 0) {
        hit_pos[at] = i0 + k;
        hit_row[at] = (unsigned char)mine[k];
        ++at;
      }
    __syncthreads();
    if (w == 0) {  // the hits in order: each row's first kLong, and counts
      for (int s = 0; s < total; s += 32) {
        const bool ok = s + lane < total;
        const int r = ok ? hit_row[s + lane] : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, r);
        const unsigned before = peers & lanemask_lt();
        const int have = ok ? count[r] : 0;
        __syncwarp();
        const int slot = have + __popc(before);
        if (ok && slot < kLong) pos[r][slot] = hit_pos[s + lane];
        if (ok && !before) count[r] = have + __popc(peers);
        __syncwarp();
      }
    }
    __syncthreads();
  }
  const int words = (per_block + 31) / 32;
  if (w < words) {
    const int i = threadIdx.x;
    const bool is_long = i < nr && count[i] > kLong;
    const unsigned m = __ballot_sync(0xffffffffu, is_long);
    if (is_long) long_count[r0 + i] = count[i];
    if (lane == 0) long_mask[blockIdx.x * words + w] = m;
  }
  // (row, vector) pairs spread over the threads: every row written once
  const int nv = d / VE;
  for (int f = threadIdx.x; f < nr * nv; f += kBwdThreads) {
    const int r = f / nv, c = f - r * nv;
    const int len = count[r];
    if (len > kLong) continue;
    float acc[VE] = {};
    for (int q0 = 0; q0 < len; q0 += 8) {
      float v[8][VE];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (q0 + u < len)
          pt::load_vec(dout + (long long)pos[r][q0 + u] * d + c * VE, v[u]);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (q0 + u < len)
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[e] += v[u][e];
    }
    pt::store_vec(out + (long long)(r0 + r) * d + c * VE, acc);
  }
}

// acc += dout[pos[k], col] for k < K, in order: the K loads (a position
// a lane, passed round by shuffles) are all issued before the first add
template <int K, typename T>
__device__ __forceinline__ void add_in_order(float& acc,
                                             const T* __restrict__ dout,
                                             const int* pos, long long d,
                                             int col) {
  const int lane = threadIdx.x & 31;
  const int p_lane = lane < K ? pos[lane] : 0;
  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long p = __shfl_sync(0xffffffffu, p_lane, k);
    v[k] = pt::to_f(dout[p * d + col]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) acc += v[k];
}

// The rows with more than kLong ids, as (row, 32 columns) items spread
// over the blocks.  The rows come from long_mask in row order; for an
// item the block scans the ids again, a chunk at a time, listing the
// row's positions in order, and warp w sums its part of them -- ids
// [w L / kParts, (w + 1) L / kParts) of the row's L, fixed by L alone --
// with 32 loads in flight a lane (lane l: column 32 t + l).  The block
// adds the parts' sums in part order and writes the 32 columns.
template <typename IdT, typename T>
__global__ void __launch_bounds__(kBwdThreads)
embedding_bwd_long_kernel(const IdT* __restrict__ ids, int n, int rows,
                          long long pad, const T* __restrict__ dout, int d,
                          int per_block, int mask_words,
                          const unsigned* __restrict__ long_mask,
                          const int* __restrict__ long_count,
                          T* __restrict__ out) {
  __shared__ int hit_pos[kChunk];
  __shared__ int upto[kBwdThreads];  // long rows in words of threads <= t
  __shared__ float part[kParts][32];
  __shared__ int scratch[kBwdWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int per = (mask_words + kBwdThreads - 1) / kBwdThreads;
  const int words = (per_block + 31) / 32;  // a block's
  int c = 0;
  for (int k = 0; k < per; ++k) {
    const int wk = threadIdx.x * per + k;
    if (wk < mask_words) c += __popc(long_mask[wk]);
  }
  int longs;
  upto[threadIdx.x] = block_scan(c, scratch, &longs) + c;
  __syncthreads();
  const int tiles = (d + 31) / 32;
  const long long items = (long long)longs * tiles;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    // the q-th long row: in the words of the first thread t with upto[t] > q
    const int q = (int)(it / tiles), col = (int)(it % tiles) * 32 + lane;
    const int safe_col = min(col, d - 1);  // lanes past d load, write nothing
    int t = 0, hi = kBwdThreads - 1;
    while (t < hi) {
      const int mid = (t + hi) >> 1;
      if (upto[mid] > q)
        hi = mid;
      else
        t = mid + 1;
    }
    int left = q - (t ? upto[t - 1] : 0), row = -1;
    for (int k = 0; k < per && row < 0; ++k) {
      const int wk = t * per + k;
      unsigned word = long_mask[wk];
      const int bits = __popc(word);
      if (left < bits) {
        for (; left > 0; --left) word &= word - 1;
        row = wk / words * per_block + wk % words * 32 + __ffs(word) - 1;
      } else {
        left -= bits;
      }
    }
    const int len = long_count[row];
    const int a = (int)((long long)w * len / kParts);
    const int e = (int)((long long)(w + 1) * len / kParts);
    float acc = 0.f;
    int seen = 0;  // the row's ids in the chunks before this one
    for (int c0 = 0; c0 < n && seen < len; c0 += kChunk) {
      const int i0 = c0 + threadIdx.x * kIdsPerThread;
      bool is_row[kIdsPerThread];
      int hits = 0;
#pragma unroll
      for (int k = 0; k < kIdsPerThread; ++k) {
        is_row[k] = i0 + k < n && row_of(ids[i0 + k], rows, pad) == row;
        hits += is_row[k];
      }
      int total, at = block_scan(hits, scratch, &total);
#pragma unroll
      for (int k = 0; k < kIdsPerThread; ++k)
        if (is_row[k]) hit_pos[at++] = i0 + k;
      __syncthreads();
      const int lo = max(a - seen, 0), hi_s = min(e - seen, total);
      int s = lo;
      for (; s + 32 <= hi_s; s += 32)
        add_in_order<32>(acc, dout, hit_pos + s, d, safe_col);
      const int rest = max(hi_s - s, 0);
      if (rest & 16) add_in_order<16>(acc, dout, hit_pos + s, d, safe_col);
      s += rest & 16;
      if (rest & 8) add_in_order<8>(acc, dout, hit_pos + s, d, safe_col);
      s += rest & 8;
      if (rest & 4) add_in_order<4>(acc, dout, hit_pos + s, d, safe_col);
      s += rest & 4;
      if (rest & 2) add_in_order<2>(acc, dout, hit_pos + s, d, safe_col);
      s += rest & 2;
      if (rest & 1) add_in_order<1>(acc, dout, hit_pos + s, d, safe_col);
      seen += total;
      __syncthreads();
    }
    part[w][lane] = acc;
    __syncthreads();
    if (w == 0 && col < d) {
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kParts; ++k) sum += part[k][lane];
      out[(long long)row * d + col] = pt::from_f<T>(sum);
    }
    __syncthreads();
  }
}

// table rows a block of the backward writes: kMaxRowsPerBlock, or fewer
// (a power of 2) where that would leave an SM without a block
int rows_per_block(long long rows) {
  int per = kMaxRowsPerBlock;
  while (per > 1 && (rows + per - 1) / per < kMinRowBlocks) per /= 2;
  return per;
}

// the long-row mask's words: (per_block + 31) / 32 a block
long long mask_words_for(long long rows) {
  const int per = rows_per_block(rows);
  return (rows + per - 1) / per * ((per + 31) / 32);
}

struct BwdLaunch {
  const void *ids, *dout;
  void* out;
  unsigned* long_mask;
  int* long_count;
  int n, rows, d, per_block, row_blocks, mask_words, long_blocks;
  long long pad;
  cudaStream_t s;
  template <typename IdT, typename T, int VE>
  int run() {
    embedding_bwd_rows_kernel<IdT, T, VE>
        <<<(unsigned)row_blocks, kBwdThreads, 0, s>>>(
            (const IdT*)ids, n, rows, pad, (const T*)dout, d, per_block,
            (T*)out, long_mask, long_count);
    int err = (int)cudaGetLastError();
    if (err || !long_blocks) return err;
    embedding_bwd_long_kernel<IdT, T>
        <<<(unsigned)long_blocks, kBwdThreads, 0, s>>>(
            (const IdT*)ids, n, rows, pad, (const T*)dout, d, per_block,
            mask_words, long_mask, long_count, (T*)out);
    return (int)cudaGetLastError();
  }
};

template <typename IdT>
int bwd_dispatch(BwdLaunch b, int dtype, bool vec) {
  if (dtype == pt::kFloat32)
    return vec ? b.run<IdT, float, 4>() : b.run<IdT, float, 1>();
  return vec ? b.run<IdT, __nv_bfloat16, 8>()
             : b.run<IdT, __nv_bfloat16, 1>();
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

// The gather's table gradient: the backward's int32 workspace in words for
// n ids and `rows` table rows (negated cudaErrorInvalidValue for sizes it
// refuses): the long-row mask, a word per block of rows, and the long
// rows' counts.
extern "C" long long pt_embedding_gather_bwd_workspace(long long n,
                                                       long long rows) {
  if (n < 1 || rows < 1 || n > (1LL << 30) || rows >= 0x7fffffffLL)
    return -(long long)cudaErrorInvalidValue;
  return mask_words_for(rows) + rows;
}

// dout [n, d] contiguous float32 or bfloat16, ids [n] int32 or int64, out
// [rows, d] like dout (every row written), ws of
// pt_embedding_gather_bwd_workspace(n, rows) int32 words; padding_idx as
// the forward's.  One launch, and a second when a row can have more than
// kLong ids; returns the first failing one's cudaError_t.
extern "C" int pt_embedding_gather_bwd(const void* dout, const void* ids,
                                       void* out, void* ws, long long n,
                                       long long rows, int d,
                                       long long padding_idx,
                                       int ids_are_int64, int dtype,
                                       void* stream) {
  if (pt_embedding_gather_bwd_workspace(n, rows) < 0 || d < 1 ||
      (dtype != pt::kFloat32 && dtype != pt::kBFloat16))
    return (int)cudaErrorInvalidValue;
  BwdLaunch b;
  b.ids = ids;
  b.dout = dout;
  b.out = out;
  b.n = (int)n;
  b.rows = (int)rows;
  b.d = d;
  b.pad = padding_idx;
  b.per_block = rows_per_block(rows);
  b.row_blocks = (int)((rows + b.per_block - 1) / b.per_block);
  b.mask_words = (int)mask_words_for(rows);
  b.long_mask = (unsigned*)ws;
  b.long_count = (int*)ws + b.mask_words;
  long long items = n / (kLong + 1) * ((d + 31) / 32);  // the most
  b.long_blocks = (int)(items < kMaxLongBlocks ? items : kMaxLongBlocks);
  b.s = (cudaStream_t)stream;
  const int elems = dtype == pt::kFloat32 ? 4 : 8;  // a 16-byte access
  const bool vec = ((uintptr_t)dout | (uintptr_t)out) % 16 == 0 &&
                   d % elems == 0;
  return ids_are_int64 ? bwd_dispatch<long long>(b, dtype, vec)
                       : bwd_dispatch<int>(b, dtype, vec);
}
