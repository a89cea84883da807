// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
// the forward (_flash_fwd :235, pallas_call :266, body _fwd_kernel :152)
// and the two backward kernels of _flash_bwd (:428): dK/dV (pallas_call
// :473, body _bwd_dkv_kernel :312) and dQ (pallas_call :521, body
// _bwd_dq_kernel :379).  The FlashAttention-2 blocked online softmax over
// q/k/v [B*H, T, Dh] with an additive key bias [B, Tk] broadcast over the
// heads of one batch row (bias row = (b*H + h) / H), an optional causal
// mask, statistics in float32, and the row max m and row sum l saved
// separately (not lse: with a -1e4 padding bias on every visible key the
// float32 sum m + log(l) loses log(l), :227-230).  Attention dropout is
// FA2's: l sums the undropped probabilities and only the PV numerator is
// masked and scaled (:198-204); the mask comes from dropout.cuh, a pure
// function of (seed, b*h, row, col), so the backward redraws it.
//
// What bounds it on the H100: the forward does 4*B*H*T^2*Dh operations
// against ~4*B*H*T*Dh elements moved (~128 operations per float32 byte at
// T=512, Dh=64), the backward 2.5 times the operations over ~2x the
// bytes, so all three are bounded by arithmetic.  This version runs every
// product on the CUDA cores in float32 (no tensor cores): right and
// simple, far from the tensor-core rates.  wgmma, TMA and warp
// specialisation are later work (ROADMAP.md).
//
// Forward design: one block of 256 threads per (batch*head, 64-row query
// tile).  The query tile stays in shared memory; the loop walks 64-key
// tiles of K and V staged in shared memory, each thread computing a 4x4
// block of scores and keeping a 4 x (Dh/16) block of the output
// accumulator in registers.  Online softmax in float32: every row keeps
// its running max m (starting at NEG_INF = -1e30, never -inf, so exp never
// sees inf-inf) and running sum l in shared memory.  A key past Tk, or
// above the diagonal under the causal flag, is excluded (probability 0);
// tiles wholly above the diagonal are skipped.  A row that sees no key
// (every visible key biased to -inf) ends with l = 0 and returns 0, as
// the l == 0 guard of the TPU kernel (:225) does; l is then saved as 1, as
// there.  Under bfloat16 the probabilities are rounded to bfloat16 before
// the PV product, as the TPU kernel casts p to v's dtype (:208).
//
// Backward design.  The TPU's two kernels carry their accumulators across
// a sequential grid; here each becomes a grid of independent blocks that
// loop inside, so no atomics are needed:
//   dK/dV: one block per (batch*head, 64-key tile) keeps dK and dV for
//     its keys in registers and loops over the query tiles (from the
//     diagonal on under the causal flag);
//   dQ:    one block per (batch*head, 64-row query tile) keeps dQ in
//     registers and loops over the key tiles.
// Both recompute p = exp(s - m) / l from the saved m and l (_recompute_p
// :294), dP = dO V^T, apply the dropout mask to p (for dV) and to dP, and
// form dS = p * (dP - delta) with delta = rowsum(dO * O) computed outside
// (as the reference, :434).  Excluded keys get p = 0, as in the forward,
// so a fully masked row has zero gradients.  Under bfloat16 the dropped p
// and dS are rounded to bfloat16 before their products, as the TPU kernel
// casts them to the operand dtype.

#include "common.cuh"
#include "dropout.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4x4 scores each
constexpr float kNegInf = -1e30f;

template <int DMAX>
constexpr int fwd_smem_floats() {
  return kBQ * DMAX            // Q tile
         + kBK * (DMAX + 1)    // K tile, padded against bank conflicts
         + kBK * DMAX          // V tile
         + kBQ * (kBK + 1)     // scores / probabilities
         + 3 * kBQ;            // running max, running sum, rescale
}

// Stage rows [r0, r0 + 64) of a [rows, dh] tensor in a [64, stride] float
// tile; rows past `rows` and columns past dh read 0.
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ src, int r0,
                                          int rows, int dh) {
  for (int idx = threadIdx.x; idx < 64 * DMAX; idx += kThreads) {
    const int r = idx / DMAX, c = idx % DMAX;
    float x = 0.f;
    if (r0 + r < rows && c < dh) x = pt::to_f(src[(size_t)(r0 + r) * dh + c]);
    dst[r * stride + c] = x;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ o, float* __restrict__ m_out,
                 float* __restrict__ l_out, int heads, int tq, int tk,
                 int dh, float scale, int causal, pt::Dropout drop) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * DMAX;
  float* sV = sK + kBK * (DMAX + 1);
  float* sS = sV + kBK * DMAX;
  float* sM = sS + kBQ * (kBK + 1);
  float* sL = sM + kBQ;
  float* sA = sL + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const T* qb = q + (size_t)bh * tq * dh;
  const T* kb = k + (size_t)bh * tk * dh;
  const T* vb = v + (size_t)bh * tk * dh;
  const float* brow = bias ? bias + (size_t)(bh / heads) * tk : nullptr;

  load_tile<T, DMAX>(sQ, DMAX, qb, q0, tq, dh);
  if (tid < kBQ) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }

  constexpr int DJ = DMAX / 16;  // output columns per thread
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // the softmax step's row, and its dropout key (fixed over the key loop)
  const int srow = tid / 4, part = tid % 4;
  const uint32_t key = drop.mode == 1 ? drop.row_key(bh, q0 + srow) : 0u;

  // under the causal flag no row of this tile sees a key past its last row
  const int k_end = causal ? min(tk, q0 + kBQ) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<T, DMAX>(sK, DMAX + 1, kb, k0, tk, dh);
    load_tile<T, DMAX>(sV, DMAX, vb, k0, tk, dh);
    __syncthreads();

    // scores: rows ty + 16*i, keys tx + 16*j of the tile
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * DMAX + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * (DMAX + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int col = k0 + c;
        const bool visible = col < tk && (!causal || col <= q0 + r);
        float x = s[i][j] * scale;
        if (visible && brow) x += brow[col];
        sS[r * (kBK + 1) + c] = visible ? x : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: four threads per row, 16 keys each
    {
      const int r = srow;
      float mx = -INFINITY;
      for (int c = part; c < kBK; c += 4) mx = fmaxf(mx, sS[r * (kBK + 1) + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < kBK; c += 4) {
        float p = expf(sS[r * (kBK + 1) + c] - m_new);
        sum += p;  // the denominator takes the unrounded, undropped p
        if (drop.mode) p = drop.apply(p, key, bh, q0 + r, k0 + c);
        sS[r * (kBK + 1) + c] = pt::round_to<T>(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();  // every lane of the row has read sM[r]
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[r] = alpha;
        sL[r] = alpha * sL[r] + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = sA[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sS[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = sV[kk * DMAX + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= tq) continue;
    const float l = sL[r];
    const float denom = l == 0.f ? 1.f : l;
    T* orow = o + (size_t)bh * tq * dh + (size_t)(q0 + r) * dh;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < dh) orow[c] = pt::from_f<T>(acc[i][j] / denom);
    }
  }
  if (tid < kBQ && q0 + tid < tq) {
    const size_t row = (size_t)bh * tq + q0 + tid;
    m_out[row] = sM[tid];
    l_out[row] = sL[tid] == 0.f ? 1.f : sL[tid];
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

template <int DMAX>
constexpr int bwd_smem_floats() {
  return 4 * 64 * (DMAX + 1)   // Q, dO, K, V tiles, padded
         + 2 * 64 * (kBK + 1)  // P (dropped) and dS, [query row][key]
         + 3 * 64;             // m, l, delta of the query rows
}

// One 64 x 64 (query row, key) tile of the backward: with the query rows
// and keys staged, compute the recomputed p and dP for this thread's 4x4
// cells (rows ty + 16*i, keys tx + 16*j), apply the mask, and write the
// dropped p (rounded to T) and dS (rounded to T) to shared memory.
template <typename T, int DMAX>
__device__ __forceinline__ void bwd_tile(
    const float* sQ, const float* sdO, const float* sK, const float* sV,
    const float* sM, const float* sL, const float* sD, float* sP, float* sdS,
    const float* brow, int bh, int q0, int k0, int tq, int tk, int dh,
    float scale, int causal, const pt::Dropout& drop) {
  constexpr int P = DMAX + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < dh; ++d) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = sQ[(ty + 16 * i) * P + d];
      gv[i] = sdO[(ty + 16 * i) * P + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = sK[(tx + 16 * j) * P + d];
      vv[j] = sV[(tx + 16 * j) * P + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    const float m = sM[r], l = sL[r], delta = sD[r];
    const uint32_t key = drop.mode == 1 ? drop.row_key(bh, row) : 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int col = k0 + c;
      const bool visible =
          row < tq && col < tk && (!causal || col <= row);
      float p = 0.f;
      if (visible) {
        float x = s[i][j] * scale;
        if (brow) x += brow[col];
        p = expf(x - m) / l;
      }
      float pv = p, g = dp[i][j];
      if (drop.mode && visible && !drop.keep(key, bh, row, col)) {
        pv = 0.f;
        g = 0.f;
      } else if (drop.mode) {
        pv *= drop.scale;
        g *= drop.scale;
      }
      sP[r * (kBK + 1) + c] = pt::round_to<T>(pv);
      sdS[r * (kBK + 1) + c] = pt::round_to<T>(p * (g - delta));
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ dout, const float* __restrict__ m,
                     const float* __restrict__ l,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int heads, int tq, int tk, int dh,
                     float scale, int causal, pt::Dropout drop) {
  constexpr int P = DMAX + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + 64 * P;
  float* sK = sdO + 64 * P;
  float* sV = sK + 64 * P;
  float* sP = sV + 64 * P;
  float* sdS = sP + 64 * (kBK + 1);
  float* sM = sdS + 64 * (kBK + 1);
  float* sL = sM + 64;
  float* sD = sL + 64;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBK;
  const size_t qoff = (size_t)bh * tq * dh;
  const size_t koff = (size_t)bh * tk * dh;
  const float* brow = bias ? bias + (size_t)(bh / heads) * tk : nullptr;

  load_tile<T, DMAX>(sK, P, k + koff, k0, tk, dh);
  load_tile<T, DMAX>(sV, P, v + koff, k0, tk, dh);

  constexpr int DJ = DMAX / 16;
  float adk[4][DJ], adv[4][DJ];  // keys ty + 16*i, columns tx + 16*j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  // under the causal flag no query row before this tile's first key sees it
  const int q_begin = causal ? k0 : 0;
  for (int q0 = q_begin; q0 < tq; q0 += kBQ) {
    __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
    load_tile<T, DMAX>(sQ, P, q + qoff, q0, tq, dh);
    load_tile<T, DMAX>(sdO, P, dout + qoff, q0, tq, dh);
    if (tid < 64) {
      const bool in = q0 + tid < tq;
      const size_t row = (size_t)bh * tq + q0 + tid;
      sM[tid] = in ? m[row] : 0.f;
      sL[tid] = in ? l[row] : 1.f;
      sD[tid] = in ? delta[row] : 0.f;
    }
    __syncthreads();
    bwd_tile<T, DMAX>(sQ, sdO, sK, sV, sM, sL, sD, sP, sdS, brow, bh, q0, k0,
                      tq, tk, dh, scale, causal, drop);
    __syncthreads();
    // dV += P_drop^T dO, dK += dS^T Q over the tile's query rows
#pragma unroll 2
    for (int r = 0; r < kBQ; ++r) {
      float pv[4], ds[4], g[DJ], qq[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[r * (kBK + 1) + ty + 16 * i];
        ds[i] = sdS[r * (kBK + 1) + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        g[j] = sdO[r * P + tx + 16 * j];
        qq[j] = sQ[r * P + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          adv[i][j] = fmaf(pv[i], g[j], adv[i][j]);
          adk[i][j] = fmaf(ds[i], qq[j], adk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= tk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < dh) {
        dk[koff + (size_t)key * dh + c] = pt::from_f<T>(adk[i][j] * scale);
        dv[koff + (size_t)key * dh + c] = pt::from_f<T>(adv[i][j]);
      }
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const T* __restrict__ dout, const float* __restrict__ m,
                    const float* __restrict__ l,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int heads, int tq, int tk, int dh, float scale,
                    int causal, pt::Dropout drop) {
  constexpr int P = DMAX + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + 64 * P;
  float* sK = sdO + 64 * P;
  float* sV = sK + 64 * P;
  float* sP = sV + 64 * P;
  float* sdS = sP + 64 * (kBK + 1);
  float* sM = sdS + 64 * (kBK + 1);
  float* sL = sM + 64;
  float* sD = sL + 64;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const size_t qoff = (size_t)bh * tq * dh;
  const size_t koff = (size_t)bh * tk * dh;
  const float* brow = bias ? bias + (size_t)(bh / heads) * tk : nullptr;

  load_tile<T, DMAX>(sQ, P, q + qoff, q0, tq, dh);
  load_tile<T, DMAX>(sdO, P, dout + qoff, q0, tq, dh);
  if (tid < 64) {
    const bool in = q0 + tid < tq;
    const size_t row = (size_t)bh * tq + q0 + tid;
    sM[tid] = in ? m[row] : 0.f;
    sL[tid] = in ? l[row] : 1.f;
    sD[tid] = in ? delta[row] : 0.f;
  }

  constexpr int DJ = DMAX / 16;
  float adq[4][DJ];  // rows ty + 16*i, columns tx + 16*j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adq[i][j] = 0.f;

  const int k_end = causal ? min(tk, q0 + kBQ) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and dS are consumed
    load_tile<T, DMAX>(sK, P, k + koff, k0, tk, dh);
    load_tile<T, DMAX>(sV, P, v + koff, k0, tk, dh);
    __syncthreads();
    bwd_tile<T, DMAX>(sQ, sdO, sK, sV, sM, sL, sD, sP, sdS, brow, bh, q0, k0,
                      tq, tk, dh, scale, causal, drop);
    __syncthreads();
    // dQ += dS K over the tile's keys
#pragma unroll 2
    for (int kk = 0; kk < kBK; ++kk) {
      float ds[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sdS[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = sK[kk * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) adq[i][j] = fmaf(ds[i], kv[j], adq[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= tq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < dh) dq[qoff + (size_t)row * dh + c] = pt::from_f<T>(adq[i][j] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Args {
  const void *q, *k, *v, *bias, *dout, *m, *l, *delta;
  void *o, *mo, *lo, *dq, *dk, *dv;
  int bh, heads, tq, tk, dh;
  float scale;
  int causal;
  pt::Dropout drop;
};

template <typename T, int DMAX>
int launch_fwd(const Args& a, cudaStream_t stream) {
  const int smem = fwd_smem_floats<DMAX>() * (int)sizeof(float);
  auto kernel = flash_fwd_kernel<T, DMAX>;
  if (int err = set_smem(kernel, smem)) return err;
  dim3 grid(a.bh, (a.tq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const float*)a.bias,
      (T*)a.o, (float*)a.mo, (float*)a.lo, a.heads, a.tq, a.tk, a.dh,
      a.scale, a.causal, a.drop);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_dkv(const Args& a, cudaStream_t stream) {
  const int smem = bwd_smem_floats<DMAX>() * (int)sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<T, DMAX>;
  if (int err = set_smem(kernel, smem)) return err;
  dim3 grid(a.bh, (a.tk + kBK - 1) / kBK);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const float*)a.bias,
      (const T*)a.dout, (const float*)a.m, (const float*)a.l,
      (const float*)a.delta, (T*)a.dk, (T*)a.dv, a.heads, a.tq, a.tk, a.dh,
      a.scale, a.causal, a.drop);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_dq(const Args& a, cudaStream_t stream) {
  const int smem = bwd_smem_floats<DMAX>() * (int)sizeof(float);
  auto kernel = flash_bwd_dq_kernel<T, DMAX>;
  if (int err = set_smem(kernel, smem)) return err;
  dim3 grid(a.bh, (a.tq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const float*)a.bias,
      (const T*)a.dout, (const float*)a.m, (const float*)a.l,
      (const float*)a.delta, (T*)a.dq, a.heads, a.tq, a.tk, a.dh, a.scale,
      a.causal, a.drop);
  return (int)cudaGetLastError();
}

enum Which { kFwd, kDKV, kDQ };

template <typename T, int DMAX>
int launch(Which which, const Args& a, cudaStream_t stream) {
  if (which == kFwd) return launch_fwd<T, DMAX>(a, stream);
  if (which == kDKV) return launch_dkv<T, DMAX>(a, stream);
  return launch_dq<T, DMAX>(a, stream);
}

int dispatch(Which which, const Args& a, int dtype, void* stream) {
  if (a.dh < 1 || a.dh > 128 || a.bh < 1 || a.tq < 1 || a.tk < 1 ||
      a.heads < 1 || a.drop.mode < 0 || a.drop.mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pt::kFloat32)
    return a.dh <= 64 ? launch<float, 64>(which, a, s)
                      : launch<float, 128>(which, a, s);
  if (dtype == pt::kBFloat16)
    return a.dh <= 64 ? launch<__nv_bfloat16, 64>(which, a, s)
                      : launch<__nv_bfloat16, 128>(which, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v [bh, t, dh] contiguous; bias [bh / heads, tk] float32 or null;
// o like q; m, l [bh, tq] float32.  Dropout: mode 0 off, 1 card
// generator, 2 debug hash (dropout.cuh).  Returns the launch's cudaError_t.
extern "C" int pt_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      void* o, void* m, void* l, int bh,
                                      int heads, int tq, int tk, int dh,
                                      float scale, int causal, int drop_mode,
                                      unsigned seed, unsigned threshold,
                                      float keep_scale, int dtype,
                                      void* stream) {
  Args a = {};
  a.q = q, a.k = k, a.v = v, a.bias = bias, a.o = o, a.mo = m, a.lo = l;
  a.bh = bh, a.heads = heads, a.tq = tq, a.tk = tk, a.dh = dh;
  a.scale = scale, a.causal = causal;
  a.drop = pt::make_dropout(drop_mode, seed, threshold, keep_scale);
  return dispatch(kFwd, a, dtype, stream);
}

// The dK/dV kernel: q, k, v, dout like the forward's q/k/v/o; m, l, delta
// [bh, tq] float32; dk, dv like k.  Returns the launch's cudaError_t.
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
  return dispatch(kDKV, a, dtype, stream);
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
  return dispatch(kDQ, a, dtype, stream);
}
