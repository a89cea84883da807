// Building blocks shared by the flash-attention kernels on Hopper's
// tensor cores: the forward (flash_attention.cu) and the backward's dK/dV
// and dQ kernels (flash_attention_bwd.cu).  Asynchronous tile staging
// (16-byte cp.async into double buffers, or plain loads where a row is
// not whole 16-byte chunks or a pointer is not 16-byte aligned), the
// 3xTF32 split, MUFU exp2 and reciprocal, the warp-level MMAs (m16n8k8
// TF32, m16n8k16 bf16 with ldmatrix) and the two products every kernel is
// built from: gemm_nt (C = A B^T, both from shared memory) and gemm_rs
// (C += P B, P in registers in gemm_nt's accumulator layout).  Each block
// is 4 warps, and each warp owns 16 rows of the block's fixed 64-row tile.
//
// Banks: tiles are row-major with a padded stride, 4 floats for float32
// (the TF32 fragments' scalar loads, A/B at (g, t) and the permuted
// (2t, g), hit 32 distinct banks) and 8 bf16 for bfloat16 (ldmatrix's
// eight 16-byte rows hit distinct bank groups).
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace pt {
namespace fa {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // the block's fixed rows: 16 per warp

template <typename T, int DMAX>
struct Shape {
  // tile row stride, padded against bank conflicts (Banks, above)
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

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace fa
}  // namespace pt
