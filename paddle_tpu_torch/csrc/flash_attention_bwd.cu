// Flash attention backward, dK/dV and dQ, on Hopper's tensor cores (sm_90a).
//
// Replaces the two backward Pallas TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py, driven by _flash_bwd (:428):
// dK/dV (pallas_call :473, body _bwd_dkv_kernel :312) and dQ (pallas_call
// :521, body _bwd_dq_kernel :379).  The function is the one the forward
// in flash_attention.cu saves for: p = exp(s - m) / l recomputed from the
// saved row max m and row sum l (_recompute_p :294), dP = dO V^T, the
// dropout mask of dropout.cuh (modes 1 and 2, the same (seed, b*h, row,
// col)) applied to p for dV and to dP, dS = p * (dP - delta) with delta
// = rowsum(dO * O) computed outside (as the reference, :434), dK and dQ
// scaled by `scale`.  A key past Tk, above the diagonal under the causal
// flag, or biased to -inf gets p = 0, so a row that sees no key has zero
// gradients.  Under bfloat16 the dropped p and dS are rounded to
// bfloat16 before their products, as the TPU kernel casts them to the
// operand dtype.
//
// What bounds it on the H100: at B*H = 96, T = 512, Dh = 64 the pair does
// 14 * B*H * T^2 * Dh = 22.5 GFLOP against ~76 MB moved, so arithmetic.
// The design puts every product on the tensor cores:
//
//  - MMA.  mma.sync (warp-level, m16n8k8 for TF32, m16n8k16 for bf16),
//    not wgmma: TF32 wgmma needs both operands K-major in shared memory,
//    which the transposed products dV = P_drop^T dO and dK = dS^T Q (and
//    dQ = dS K) would need as extra transposed copies of dO, Q and K;
//    mma.sync lets the P and dS operands stay in registers (below).
//  - float32 as 3xTF32.  Single-pass TF32 keeps 10 mantissa bits and
//    misses the float32 tolerance (1e-4 of the largest |ref|) by ~4x
//    (tests/test_torch_flash_bwd.py), so each operand x is split as big =
//    x truncated to TF32 and small = x - big (split(), below), and
//    acc += small*big + big*small + big*big in float32: as exact as the
//    float32 CUDA-core product, at three tensor-core MMAs per product.
//    bfloat16 operands go to the bf16 MMA as they are, with ldmatrix
//    (.trans for the operands read across their rows).
//  - Instruction issue, not the MMAs, bounds these kernels (two warps a
//    scheduler, ~10 other instructions per MMA): the split takes two
//    instructions, p = 2^(s*scale*log2e + bias*log2e - m*log2e) * (1/l)
//    runs on MUFU.EX2 and MUFU.RCP, the products have no guards (every
//    tile spans DMAX columns of Dh, zero-filled), and the epilogue is
//    compiled once per dropout mode and once without the masks for the
//    tiles that lie wholly inside T (and below the diagonal).
//  - Registers.  Each warp owns 16 rows of the block's fixed tile (query
//    rows for dQ, keys for dK/dV) and computes S and dP (for dK/dV their
//    transposes S^T = K Q^T, dP^T = V dO^T) into MMA accumulators; p, the
//    dropout mask and dS are formed on those fragments, and the fragments
//    become the A operand of the next product in registers: the bf16
//    accumulator layout of two n8 tiles is the m16n8k16 A layout, and for
//    TF32 the k index of each 8-wide step is permuted (A's k = t and t+4
//    are the accumulator's columns 2t and 2t+1; B's rows are read in the
//    same order).  Nothing of p or dS goes through shared memory.
//  - Asynchronous double-buffered staging.  The streamed tiles (Q, dO, m,
//    l, delta for dK/dV; K, V and the key bias for dQ) arrive by 16-byte
//    cp.async.cg (4-byte cp.async.ca for the row vectors) into one of two
//    buffers while the MMAs run on the other.  Rows past T and columns
//    past Dh are zero-filled (a source size of 0).  Where a row of Dh
//    elements is not a multiple of 16 bytes, or a pointer is not 16-byte
//    aligned, the same buffers are filled by plain loads instead.
//  - Banks.  Tiles are row-major with a padded stride: 4 floats for
//    float32 (the TF32 fragments' scalar loads, A/B at (g, t) and the
//    permuted (2t, g), hit 32 distinct banks) and 8 bf16 for bfloat16
//    (ldmatrix's eight 16-byte rows hit distinct bank groups).
//  - Two kernels, deterministic.  One block of 4 warps per (b*h, 64-key
//    tile) for dK/dV, per (b*h, 64-row query tile) for dQ; each block
//    loops over the other side's tiles in a fixed order (from the
//    diagonal on under the causal flag) with no atomics, so two runs give
//    the same bits.  The streamed tile is 64 rows for Dh <= 64 and 32 for
//    Dh <= 128, which keeps the float32 block at ~106 KB (two blocks an
//    SM) and ~136 KB.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "dropout.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // the block's fixed rows: 16 per warp

template <typename T, int DMAX>
struct Shape {
  // tile row stride, padded against bank conflicts (header: Banks)
  static constexpr int S = DMAX + (sizeof(T) == 4 ? 4 : 8);
  static constexpr int BN = DMAX <= 64 ? 64 : 32;  // streamed rows a tile
  static constexpr int NJ = BN / 8;                // n8 tiles of S, dP
  static constexpr int ND = DMAX / 8;              // n8 tiles of an output
};

// ---------------------------------------------------------------------------
// asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [r0, r0 + ROWS) of a [rows, dh] tensor into a [ROWS, S] tile;
// rows past `rows` and columns past dh are 0.  `vec`: 16-byte cp.async
// (dh * sizeof(T) a multiple of 16 and the base 16-byte aligned); else
// plain loads.
template <typename T, int ROWS, int DMAX, int S>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src,
                                           int r0, int rows, int dh,
                                           bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    constexpr int CPR = DMAX / E;  // chunks a row
    for (int idx = threadIdx.x; idx < ROWS * CPR; idx += kThreads) {
      const int r = idx / CPR, c = (idx % CPR) * E;
      const bool in = r0 + r < rows && c < dh;
      cp_async16(dst + r * S + c, in ? src + (size_t)(r0 + r) * dh + c : src,
                 in);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * DMAX; idx += kThreads) {
      const int r = idx / DMAX, c = idx % DMAX;
      T x = pt::from_f<T>(0.f);
      if (r0 + r < rows && c < dh) x = src[(size_t)(r0 + r) * dh + c];
      dst[r * S + c] = x;
    }
  }
}

// Stage n floats from src[i0 ...] (i < lim) into dst; past lim reads 0.
__device__ __forceinline__ void stage_vec(float* dst,
                                          const float* __restrict__ src,
                                          int i0, int n, int lim) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool in = i0 + i < lim;
    cp_async4(dst + i, in ? src + i0 + i : src, in);
  }
}

// ---------------------------------------------------------------------------
// MMA fragments
// ---------------------------------------------------------------------------

// x = big + small for 3xTF32.  A TF32 MMA operand is read as the sign,
// the exponent and the 10 leading mantissa bits of a float32 register;
// the low 13 bits are ignored.  big is x with those bits cleared (x
// truncated to TF32) and small = x - big, exact in float32, enters the MMA
// truncated to its own 10 leading bits: big + small keeps x to ~2^-21,
// float32's order.  Two instructions: cvt.rna.tf32.f32 compiles to a
// compare-and-select sequence on sm_90a that doubled the kernels' time.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// 2^x and 1/x on the special function unit (MUFU.EX2, MUFU.RCP)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// The products issue their MMAs in passes over independent accumulators
// (all n8 tiles of one pass, then the next), with every fragment of a
// step loaded before its first MMA: an mma.sync waits for the one before
// it on the same accumulator, and with two warps a scheduler nothing
// else hides that latency.  Every product runs over all DMAX columns of
// d (zero past Dh): no guard in the loops.

// c[16 x BN] += A[16 x d] B[BN x d]^T: A the warp's 16 rows of a tile, B a
// tile, both row-major with stride S in shared memory.  Accumulator
// layout (lane = 4 g + t): c[j] holds rows g, g, g+8, g+8 and columns
// 8j + 2t, 8j + 2t + 1, 8j + 2t, 8j + 2t + 1.
template <int BN, int DMAX, int S>
__device__ __forceinline__ void gemm_nt(float (&c)[BN / 8][4],
                                        const float* sA, const float* sB) {
  constexpr int NJ = BN / 8;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < DMAX / 8; ++kk) {
    const float* a = sA + g * S + kk * 8 + t;
    uint32_t ab[4], as[4], bb[NJ][2], bs[NJ][2];
    split(a[0], ab[0], as[0]);
    split(a[8 * S], ab[1], as[1]);
    split(a[4], ab[2], as[2]);
    split(a[8 * S + 4], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* b = sB + (8 * j + g) * S + kk * 8 + t;
      split(b[0], bb[j][0], bs[j][0]);
      split(b[4], bb[j][1], bs[j][1]);
    }
    // 3xTF32: the two small cross terms first, then big * big
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(c[j], as, bb[j][0], bb[j][1]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(c[j], ab, bs[j][0], bs[j][1]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(c[j], ab, bb[j][0], bb[j][1]);
  }
}

template <int BN, int DMAX, int S>
__device__ __forceinline__ void gemm_nt(float (&c)[BN / 8][4],
                                        const __nv_bfloat16* sA,
                                        const __nv_bfloat16* sB) {
  constexpr int NJJ = BN / 16, NK = DMAX / 16;
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* a0 = sA + (lane % 16) * S + (lane / 16) * 8;
  const __nv_bfloat16* b0 =
      sB + ((lane / 16) * 8 + lane % 8) * S + ((lane / 8) % 2) * 8;
  // the next step's fragments load while this step's MMAs run
  uint32_t a[2][4], b[2][NJJ][4];
  ldsm_x4(a[0], a0);
#pragma unroll
  for (int jj = 0; jj < NJJ; ++jj) ldsm_x4(b[0][jj], b0 + 16 * jj * S);
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const int cur = kk % 2, nxt = cur ^ 1;
    if (kk + 1 < NK) {
      ldsm_x4(a[nxt], a0 + (kk + 1) * 16);
#pragma unroll
      for (int jj = 0; jj < NJJ; ++jj)
        ldsm_x4(b[nxt][jj], b0 + 16 * jj * S + (kk + 1) * 16);
    }
#pragma unroll
    for (int jj = 0; jj < NJJ; ++jj) {
      mma_bf16(c[2 * jj], a[cur], b[cur][jj][0], b[cur][jj][1]);
      mma_bf16(c[2 * jj + 1], a[cur], b[cur][jj][2], b[cur][jj][3]);
    }
  }
}

// c[16 x d] += P[16 x BN] B[BN x d]: P in gemm_nt's accumulator layout
// (registers), B a row-major [BN, S] tile; eight n8 tiles of d at a time.
template <int BN, int DMAX, int S>
__device__ __forceinline__ void gemm_rs(float (&c)[DMAX / 8][4],
                                        const float (&p)[BN / 8][4],
                                        const float* sB) {
  constexpr int NG = 8;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    // A's k = t, t + 4 are the accumulator's columns 2t, 2t + 1
    uint32_t ab[4], as[4];
    split(p[j][0], ab[0], as[0]);
    split(p[j][2], ab[1], as[1]);
    split(p[j][1], ab[2], as[2]);
    split(p[j][3], ab[3], as[3]);
    const float* b = sB + (8 * j + 2 * t) * S + g;
#pragma unroll
    for (int n0 = 0; n0 < DMAX / 8; n0 += NG) {
      uint32_t bb[NG][2], bs[NG][2];
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        split(b[8 * (n0 + i)], bb[i][0], bs[i][0]);
        split(b[S + 8 * (n0 + i)], bb[i][1], bs[i][1]);
      }
#pragma unroll
      for (int i = 0; i < NG; ++i)
        mma_tf32(c[n0 + i], as, bb[i][0], bb[i][1]);
#pragma unroll
      for (int i = 0; i < NG; ++i)
        mma_tf32(c[n0 + i], ab, bs[i][0], bs[i][1]);
#pragma unroll
      for (int i = 0; i < NG; ++i)
        mma_tf32(c[n0 + i], ab, bb[i][0], bb[i][1]);
    }
  }
}

template <int BN, int DMAX, int S>
__device__ __forceinline__ void gemm_rs(float (&c)[DMAX / 8][4],
                                        const float (&p)[BN / 8][4],
                                        const __nv_bfloat16* sB) {
  constexpr int NN = DMAX / 16;
  const int lane = threadIdx.x % 32, mi = lane / 8;
  const __nv_bfloat16* b0 =
      sB + ((mi % 2) * 8 + lane % 8) * S + (mi / 2) * 8;
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    uint32_t r[NN][4];
#pragma unroll
    for (int nn = 0; nn < NN; ++nn)
      ldsm_x4_t(r[nn], b0 + 16 * j * S + 16 * nn);
    // two n8 accumulator tiles are one m16n8k16 A operand
    const uint32_t a[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                           pack_bf16(p[2 * j][2], p[2 * j][3]),
                           pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                           pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int nn = 0; nn < NN; ++nn) {
      mma_bf16(c[2 * nn], a, r[nn][0], r[nn][1]);
      mma_bf16(c[2 * nn + 1], a, r[nn][2], r[nn][3]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_pair(T* __restrict__ out, int row,
                                           int rows, int col, int dh,
                                           float x0, float x1) {
  if (row >= rows) return;
  if (col < dh) out[(size_t)row * dh + col] = pt::from_f<T>(x0);
  if (col + 1 < dh) out[(size_t)row * dh + col + 1] = pt::from_f<T>(x1);
}

template <typename T, int DMAX>
constexpr int smem_bytes(int row_vectors) {
  using Sh = Shape<T, DMAX>;
  return (2 * kBM + 4 * Sh::BN) * Sh::S * (int)sizeof(T) +
         row_vectors * 2 * Sh::BN * (int)sizeof(float);
}

// f(mask, mode) with the tile's masking (a tile that reaches past T, or
// crosses the diagonal under the causal flag) and the dropout mode as
// compile-time constants, so each epilogue is straight-line code.
template <typename F>
__device__ __forceinline__ void with_epilogue(bool mask, int mode, F&& f) {
  using M1 = std::integral_constant<int, 1>;
  using M2 = std::integral_constant<int, 2>;
  using M0 = std::integral_constant<int, 0>;
  if (mask) {
    if (mode == 1) f(std::true_type(), M1());
    else if (mode == 2) f(std::true_type(), M2());
    else f(std::true_type(), M0());
  } else {
    if (mode == 1) f(std::false_type(), M1());
    else if (mode == 2) f(std::false_type(), M2());
    else f(std::false_type(), M0());
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (b*h, 64-key tile); warp w owns keys 16w .. 16w+15
// ---------------------------------------------------------------------------

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ dout, const float* __restrict__ m,
                     const float* __restrict__ l,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int heads, int tq, int tk, int dh,
                     float scale, int causal, pt::Dropout drop, bool vec) {
  using Sh = Shape<T, DMAX>;
  constexpr int S = Sh::S, BN = Sh::BN, NJ = Sh::NJ, ND = Sh::ND;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kBM * S;
  T* sQ = sV + kBM * S;        // [2][BN * S]
  T* sdO = sQ + 2 * BN * S;    // [2][BN * S]
  float* sM = reinterpret_cast<float*>(sdO + 2 * BN * S);  // [2][BN]
  float* sL = sM + 2 * BN;
  float* sD = sL + 2 * BN;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBM;
  const size_t qoff = (size_t)bh * tq * dh;
  const size_t koff = (size_t)bh * tk * dh;
  const size_t roff = (size_t)bh * tq;

  // the thread's two keys and their bias, in log2 units as the scores
  const int key_lo = k0 + 16 * warp + g, key_hi = key_lo + 8;
  const float sl = scale * kLog2e;
  float bl_lo = 0.f, bl_hi = 0.f;
  if (bias) {
    const float* brow = bias + (size_t)(bh / heads) * tk;
    if (key_lo < tk) bl_lo = brow[key_lo] * kLog2e;
    if (key_hi < tk) bl_hi = brow[key_hi] * kLog2e;
  }

  float adk[ND][4], adv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  // under the causal flag no query row before this tile's first key sees it
  const int q_begin = causal ? k0 : 0;
  const int ntiles = q_begin < tq ? (tq - q_begin + BN - 1) / BN : 0;

  auto stage = [&](int it) {
    const int q0 = q_begin + it * BN, buf = it % 2;
    stage_tile<T, BN, DMAX, S>(sQ + buf * BN * S, q + qoff, q0, tq, dh, vec);
    stage_tile<T, BN, DMAX, S>(sdO + buf * BN * S, dout + qoff, q0, tq, dh,
                               vec);
    stage_vec(sM + buf * BN, m + roff, q0, BN, tq);
    stage_vec(sL + buf * BN, l + roff, q0, BN, tq);
    stage_vec(sD + buf * BN, delta + roff, q0, BN, tq);
  };

  stage_tile<T, kBM, DMAX, S>(sK, k + koff, k0, tk, dh, vec);
  stage_tile<T, kBM, DMAX, S>(sV, v + koff, k0, tk, dh, vec);
  if (ntiles > 0) stage(0);
  cp_commit();

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      stage(it + 1);  // into the buffer the previous iteration released
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int buf = it % 2, q0 = q_begin + it * BN;
    const T* tQ = sQ + buf * BN * S;
    const T* tdO = sdO + buf * BN * S;

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns query rows
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    gemm_nt<BN, DMAX, S>(s, sK + 16 * warp * S, tQ);
    gemm_nt<BN, DMAX, S>(dp, sV + 16 * warp * S, tdO);

    // s <- dropped p, dp <- dS, on the fragments; p = 2^(s * scale * log2 e
    // + bias * log2 e - m * log2 e) / l
    const bool edge =
        q0 + BN > tq || k0 + kBM > tk || (causal && k0 + kBM - 1 > q0);
    with_epilogue(edge, drop.mode, [&](auto mask, auto mode) {
      constexpr bool MASK = decltype(mask)::value;
      constexpr int MODE = decltype(mode)::value;
      pt::Dropout dd = drop;
      dd.mode = MODE;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const int c = 8 * j + 2 * t + par, row = q0 + c;
          const float ml = sM[buf * BN + c] * kLog2e;
          const float inv_l = rcp(sL[buf * BN + c]);
          const float dr = sD[buf * BN + c];
          const uint32_t rkey = MODE == 1 ? dd.row_key(bh, row) : 0u;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int e = 2 * half + par;
            const int key = half ? key_hi : key_lo;
            float p = ex2(fmaf(s[j][e], sl, half ? bl_hi : bl_lo) - ml) * inv_l;
            if (MASK && !(row < tq && key < tk && (!causal || key <= row)))
              p = 0.f;
            float pv = p, gr = dp[j][e];
            if (MODE) {
              const bool kept = dd.keep(rkey, bh, row, key);
              pv = kept ? p * dd.scale : 0.f;
              gr = kept ? gr * dd.scale : 0.f;
            }
            s[j][e] = pv;
            dp[j][e] = p * (gr - dr);
          }
        }
      }
    });

    // dV += P_drop^T dO, dK += dS^T Q
    gemm_rs<BN, DMAX, S>(adv, s, tdO);
    gemm_rs<BN, DMAX, S>(adk, dp, tQ);
    __syncthreads();  // this buffer is free for the tile after next
  }
  cp_wait<0>();  // no tile: K and V were staged for nothing

#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = 8 * n + 2 * t;
    store_pair(dk + koff, key_lo, tk, col, dh, adk[n][0] * scale,
               adk[n][1] * scale);
    store_pair(dk + koff, key_hi, tk, col, dh, adk[n][2] * scale,
               adk[n][3] * scale);
    store_pair(dv + koff, key_lo, tk, col, dh, adv[n][0], adv[n][1]);
    store_pair(dv + koff, key_hi, tk, col, dh, adv[n][2], adv[n][3]);
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (b*h, 64-row query tile); warp w owns rows 16w .. 16w+15
// ---------------------------------------------------------------------------

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const T* __restrict__ dout, const float* __restrict__ m,
                    const float* __restrict__ l,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int heads, int tq, int tk, int dh, float scale,
                    int causal, pt::Dropout drop, bool vec) {
  using Sh = Shape<T, DMAX>;
  constexpr int S = Sh::S, BN = Sh::BN, NJ = Sh::NJ, ND = Sh::ND;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + kBM * S;
  T* sK = sdO + kBM * S;      // [2][BN * S]
  T* sV = sK + 2 * BN * S;    // [2][BN * S]
  float* sB = reinterpret_cast<float*>(sV + 2 * BN * S);  // [2][BN]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBM;
  const size_t qoff = (size_t)bh * tq * dh;
  const size_t koff = (size_t)bh * tk * dh;
  const float* brow = bias ? bias + (size_t)(bh / heads) * tk : nullptr;

  // the thread's two query rows: statistics (m in log2 units) and dropout
  // keys
  const float sl = scale * kLog2e;
  int rows[2];
  float ml[2], inv_l[2], dr[2];
  uint32_t rkey[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rows[h] = q0 + 16 * warp + g + 8 * h;
    const bool in = rows[h] < tq;
    const size_t r = (size_t)bh * tq + rows[h];
    ml[h] = in ? m[r] * kLog2e : 0.f;
    inv_l[h] = in ? rcp(l[r]) : 0.f;
    dr[h] = in ? delta[r] : 0.f;
    rkey[h] = drop.mode == 1 ? drop.row_key(bh, rows[h]) : 0u;
  }

  float adq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[n][e] = 0.f;

  // under the causal flag no row of this tile sees a key past its last row
  const int k_end = causal ? min(tk, q0 + kBM) : tk;
  const int ntiles = (k_end + BN - 1) / BN;

  auto stage = [&](int it) {
    const int k0 = it * BN, buf = it % 2;
    stage_tile<T, BN, DMAX, S>(sK + buf * BN * S, k + koff, k0, tk, dh, vec);
    stage_tile<T, BN, DMAX, S>(sV + buf * BN * S, v + koff, k0, tk, dh, vec);
    if (brow) stage_vec(sB + buf * BN, brow, k0, BN, tk);
  };

  stage_tile<T, kBM, DMAX, S>(sQ, q + qoff, q0, tq, dh, vec);
  stage_tile<T, kBM, DMAX, S>(sdO, dout + qoff, q0, tq, dh, vec);
  stage(0);
  cp_commit();

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      stage(it + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int buf = it % 2, k0 = it * BN;
    const T* tK = sK + buf * BN * S;
    const T* tV = sV + buf * BN * S;

    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    gemm_nt<BN, DMAX, S>(s, sQ + 16 * warp * S, tK);
    gemm_nt<BN, DMAX, S>(dp, sdO + 16 * warp * S, tV);

    // dp <- dS on the fragments
    const bool edge =
        q0 + kBM > tq || k0 + BN > tk || (causal && k0 + BN - 1 > q0);
    with_epilogue(edge, drop.mode, [&](auto mask, auto mode) {
      constexpr bool MASK = decltype(mask)::value;
      constexpr int MODE = decltype(mode)::value;
      pt::Dropout dd = drop;
      dd.mode = MODE;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const int c = 8 * j + 2 * t + par, col = k0 + c;
          const float bl = brow ? sB[buf * BN + c] * kLog2e : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + par, row = rows[h];
            float p = ex2(fmaf(s[j][e], sl, bl) - ml[h]) * inv_l[h];
            if (MASK && !(row < tq && col < tk && (!causal || col <= row)))
              p = 0.f;
            float gr = dp[j][e];
            if (MODE)
              gr = dd.keep(rkey[h], bh, row, col) ? gr * dd.scale : 0.f;
            dp[j][e] = p * (gr - dr[h]);
          }
        }
      }
    });

    // dQ += dS K
    gemm_rs<BN, DMAX, S>(adq, dp, tK);
    __syncthreads();
  }

#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = 8 * n + 2 * t;
    store_pair(dq + qoff, rows[0], tq, col, dh, adq[n][0] * scale,
               adq[n][1] * scale);
    store_pair(dq + qoff, rows[1], tq, col, dh, adq[n][2] * scale,
               adq[n][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *bias, *dout, *m, *l, *delta;
  void *dq, *dk, *dv;
  int bh, heads, tq, tk, dh;
  float scale;
  int causal;
  pt::Dropout drop;
};

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// 16-byte cp.async of whole rows: every row of dh elements starts on 16
// bytes (the base pointers aligned and dh * sizeof(T) a multiple of 16)
template <typename T>
bool vec_ok(const Args& a) {
  return (a.dh * (int)sizeof(T)) % 16 == 0 && aligned16(a.q) &&
         aligned16(a.k) && aligned16(a.v) && aligned16(a.dout);
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int DMAX>
int launch_dkv(const Args& a, cudaStream_t stream) {
  const int smem = smem_bytes<T, DMAX>(3);
  auto kernel = flash_bwd_dkv_kernel<T, DMAX>;
  if (int err = set_smem(kernel, smem)) return err;
  dim3 grid(a.bh, (a.tk + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const float*)a.bias,
      (const T*)a.dout, (const float*)a.m, (const float*)a.l,
      (const float*)a.delta, (T*)a.dk, (T*)a.dv, a.heads, a.tq, a.tk, a.dh,
      a.scale, a.causal, a.drop, vec_ok<T>(a));
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_dq(const Args& a, cudaStream_t stream) {
  const int smem = smem_bytes<T, DMAX>(1);
  auto kernel = flash_bwd_dq_kernel<T, DMAX>;
  if (int err = set_smem(kernel, smem)) return err;
  dim3 grid(a.bh, (a.tq + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const float*)a.bias,
      (const T*)a.dout, (const float*)a.m, (const float*)a.l,
      (const float*)a.delta, (T*)a.dq, a.heads, a.tq, a.tk, a.dh, a.scale,
      a.causal, a.drop, vec_ok<T>(a));
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch(bool dkv, const Args& a, cudaStream_t stream) {
  return dkv ? launch_dkv<T, DMAX>(a, stream) : launch_dq<T, DMAX>(a, stream);
}

int dispatch(bool dkv, const Args& a, int dtype, void* stream) {
  if (a.dh < 1 || a.dh > 128 || a.bh < 1 || a.tq < 1 || a.tk < 1 ||
      a.heads < 1 || a.drop.mode < 0 || a.drop.mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pt::kFloat32)
    return a.dh <= 64 ? launch<float, 64>(dkv, a, s)
                      : launch<float, 128>(dkv, a, s);
  if (dtype == pt::kBFloat16)
    return a.dh <= 64 ? launch<__nv_bfloat16, 64>(dkv, a, s)
                      : launch<__nv_bfloat16, 128>(dkv, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The dK/dV kernel: q, k, v, dout [bh, t, dh] contiguous (dout like q);
// bias [bh / heads, tk] float32 or null; m, l, delta [bh, tq] float32; dk,
// dv like k.  Dropout: mode 0 off, 1 card generator, 2 debug hash
// (dropout.cuh).  Returns the launch's cudaError_t.
extern "C" int pt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* m, const void* l, const void* delta,
    void* dk, void* dv, int bh, int heads, int tq, int tk, int dh,
    float scale, int causal, int drop_mode, unsigned seed,
    unsigned threshold, float keep_scale, int dtype, void* stream) {
  Args a = {};
  a.q = q, a.k = k, a.v = v, a.bias = bias, a.dout = dout;
  a.m = m, a.l = l, a.delta = delta, a.dk = dk, a.dv = dv;
  a.bh = bh, a.heads = heads, a.tq = tq, a.tk = tk, a.dh = dh;
  a.scale = scale, a.causal = causal;
  a.drop = pt::make_dropout(drop_mode, seed, threshold, keep_scale);
  return dispatch(true, a, dtype, stream);
}

// The dQ kernel: as the dK/dV kernel, writing dq like q.
extern "C" int pt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* m, const void* l, const void* delta,
    void* dq, int bh, int heads, int tq, int tk, int dh, float scale,
    int causal, int drop_mode, unsigned seed, unsigned threshold,
    float keep_scale, int dtype, void* stream) {
  Args a = {};
  a.q = q, a.k = k, a.v = v, a.bias = bias, a.dout = dout;
  a.m = m, a.l = l, a.delta = delta, a.dq = dq;
  a.bh = bh, a.heads = heads, a.tq = tq, a.tk = tk, a.dh = dh;
  a.scale = scale, a.causal = causal;
  a.drop = pt::make_dropout(drop_mode, seed, threshold, keep_scale);
  return dispatch(false, a, dtype, stream);
}
