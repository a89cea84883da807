// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/flash_attention.py
// (_flash_fwd :235, pallas_call :266, body _fwd_kernel :152): the
// FlashAttention-2 blocked online softmax over q/k/v [B*H, T, Dh] with an
// additive key bias [B, Tk] broadcast over the heads of one batch row
// (bias row = (b*H + h) / H), an optional causal mask, statistics in
// float32, and the row max m and row sum l written separately for the
// backward of the training slice.
//
// What bounds it on the H100: 4*B*H*T^2*Dh operations against ~4*B*H*T*Dh
// elements moved, so at T=512, Dh=64 it does ~128 operations per byte of
// float32 and is bounded by arithmetic, not memory.  This first version
// runs the two products on the CUDA cores in float32 (no tensor cores):
// it is right and simple, and far from the 67 TFLOP/s float32 peak, let
// alone the tensor-core rates.  wgmma, TMA and warp specialisation are
// later work (ROADMAP.md).
//
// Design: one block of 256 threads per (batch*head, 64-row query tile).
// The query tile stays in shared memory; the loop walks 64-key tiles of K
// and V staged in shared memory, each thread computing a 4x4 block of
// scores and keeping a 4 x (Dh/16) block of the output accumulator in
// registers.  Online softmax in float32: every row keeps its running max
// m (starting at NEG_INF = -1e30, never -inf, so exp never sees inf-inf)
// and running sum l in shared memory.  A key past Tk, or above the
// diagonal under the causal flag, is excluded (probability 0); tiles
// wholly above the diagonal are skipped.  A row that sees no key (every
// visible key biased to -inf) ends with l = 0 and returns 0, as the
// l == 0 guard of the TPU kernel (:225) does; l is then saved as 1, as
// there.  Under bfloat16 the probabilities are rounded to bfloat16 before
// the PV product, as the TPU kernel casts p to v's dtype (:208).
// Dropout inside the kernel comes with the training slice.

#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4x4 scores each
constexpr float kNegInf = -1e30f;

template <int DMAX>
constexpr int smem_floats() {
  return kBQ * DMAX            // Q tile
         + kBK * (DMAX + 1)    // K tile, padded against bank conflicts
         + kBK * DMAX          // V tile
         + kBQ * (kBK + 1)     // scores / probabilities
         + 3 * kBQ;            // running max, running sum, rescale
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ o, float* __restrict__ m_out,
                 float* __restrict__ l_out, int heads, int tq, int tk,
                 int dh, float scale, int causal) {
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
  const size_t qbase = (size_t)bh * tq * dh;
  const size_t kbase = (size_t)bh * tk * dh;
  const float* brow = bias ? bias + (size_t)(bh / heads) * tk : nullptr;

  for (int idx = tid; idx < kBQ * DMAX; idx += kThreads) {
    const int r = idx / DMAX, c = idx % DMAX;
    float x = 0.f;
    if (q0 + r < tq && c < dh) x = pt::to_f(q[qbase + (size_t)(q0 + r) * dh + c]);
    sQ[idx] = x;
  }
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

  // under the causal flag no row of this tile sees a key past its last row
  const int k_end = causal ? min(tk, q0 + kBQ) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int idx = tid; idx < kBK * DMAX; idx += kThreads) {
      const int r = idx / DMAX, c = idx % DMAX;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < tk && c < dh) {
        const size_t off = kbase + (size_t)(k0 + r) * dh + c;
        kx = pt::to_f(k[off]);
        vx = pt::to_f(v[off]);
      }
      sK[r * (DMAX + 1) + c] = kx;
      sV[r * DMAX + c] = vx;
    }
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
      const int r = tid / 4, part = tid % 4;
      float mx = -INFINITY;
      for (int c = part; c < kBK; c += 4) mx = fmaxf(mx, sS[r * (kBK + 1) + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < kBK; c += 4) {
        const float p = expf(sS[r * (kBK + 1) + c] - m_new);
        sum += p;  // the denominator takes the unrounded p
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
    T* orow = o + qbase + (size_t)(q0 + r) * dh;
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

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* o, void* m, void* l, int bh, int heads, int tq, int tk,
           int dh, float scale, int causal, cudaStream_t stream) {
  const int smem = smem_floats<DMAX>() * (int)sizeof(float);
  auto kernel = flash_fwd_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (tq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (T*)o,
      (float*)m, (float*)l, heads, tq, tk, dh, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* bias,
             void* o, void* m, void* l, int bh, int heads, int tq, int tk,
             int dh, float scale, int causal, cudaStream_t stream) {
  if (dh <= 64)
    return launch<T, 64>(q, k, v, bias, o, m, l, bh, heads, tq, tk, dh,
                         scale, causal, stream);
  return launch<T, 128>(q, k, v, bias, o, m, l, bh, heads, tq, tk, dh, scale,
                        causal, stream);
}

}  // namespace

// q, k, v [bh, t, dh] contiguous; bias [bh / heads, tk] float32 or null;
// o like q; m, l [bh, tq] float32.  Returns the launch's cudaError_t.
extern "C" int pt_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      void* o, void* m, void* l, int bh,
                                      int heads, int tq, int tk, int dh,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  if (dh < 1 || dh > 128 || bh < 1 || tq < 1 || tk < 1 || heads < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pt::kFloat32)
    return dispatch<float>(q, k, v, bias, o, m, l, bh, heads, tq, tk, dh,
                           scale, causal, s);
  if (dtype == pt::kBFloat16)
    return dispatch<__nv_bfloat16>(q, k, v, bias, o, m, l, bh, heads, tq, tk,
                                   dh, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
