// Flash attention forward for Hopper (sm_90a).
//
// Replaces the forward Pallas TPU kernel of
// paddle_tpu/ops/pallas/flash_attention.py (_flash_fwd :235, pallas_call
// :266, body _fwd_kernel :152); its two backward kernels are in
// flash_attention_bwd.cu.  The FlashAttention-2 blocked online softmax over
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
// T=512, Dh=64), so arithmetic.  This version runs every product on the
// CUDA cores in float32 (no tensor cores): right and simple, far from the
// tensor-core rates; the backward moved to the tensor cores first
// (ROADMAP.md, Queue B).
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
// launchers
// ---------------------------------------------------------------------------

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Args {
  const void *q, *k, *v, *bias;
  void *o, *mo, *lo;
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

int dispatch(const Args& a, int dtype, void* stream) {
  if (a.dh < 1 || a.dh > 128 || a.bh < 1 || a.tq < 1 || a.tk < 1 ||
      a.heads < 1 || a.drop.mode < 0 || a.drop.mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pt::kFloat32)
    return a.dh <= 64 ? launch_fwd<float, 64>(a, s)
                      : launch_fwd<float, 128>(a, s);
  if (dtype == pt::kBFloat16)
    return a.dh <= 64 ? launch_fwd<__nv_bfloat16, 64>(a, s)
                      : launch_fwd<__nv_bfloat16, 128>(a, s);
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
  return dispatch(a, dtype, stream);
}
