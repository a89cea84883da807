// Fused dropout + residual add + layer norm, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/fused_ln.py:
// the forward (_fwd_call :182, pallas_call :190, body _fwd_kernel :86),
// out = (y - mean) * rstd * gamma + beta with y = dropout(x) + residual
// over the last axis of [N, D] rows (variance by two passes over y,
// :95-98), and the backward (_bwd_call :217, pallas_call :224, body
// _bwd_kernel :108), dres = rstd * (dxhat - mean(dxhat) - xhat *
// mean(dxhat * xhat)) with dxhat = dout * gamma, dx = dropout(dres) with
// the forward's mask, dgamma = sum(dout * xhat), dbeta = sum(dout) over
// the rows.  y, mean and variance are float32 inside; y is saved in x's
// dtype for the backward, with mean and rstd in float32, as the reference
// does.  The dropout mask comes from dropout.cuh with b = 0 and the
// global (row, col), so the backward redraws it.
//
// What bounds it on the H100: the forward reads x and residual and writes
// out (and y when training), the backward reads dout and y and writes dx
// and dres, a few operations per element, so both are bounded by memory:
// at N=4096, D=768 in float32 each [N, D] tensor is 12.6 MB (~3.8 us at
// 3.35 TB/s).
//
// Forward design: one warp per row, four rows per 128-thread block.  Lane
// i reads elements i, i+32, ... (coalesced) and keeps its share of y in
// registers (VPT values, a template bound chosen from D), so x and
// residual are read once and the two reductions are warp shuffles; gamma
// and beta are read through the cache.  The saved y, mean and rstd are
// written only when the caller passes somewhere to write them (training).
//
// Backward design: one warp per row again, for the row's two reductions.
// dgamma and dbeta are sums over all N rows; the TPU kernel carries them
// across its sequential grid, which has no counterpart here, and float
// atomics would make the sums' order vary.  So the row kernel runs a fixed
// grid of at most kPartBlocks blocks whose warps stride over the rows,
// each lane summing its columns' dgamma/dbeta terms in shared memory (one
// row of [D] per warp, no two lanes on one address); each block then
// writes its [D] partials, and a second small kernel sums the [blocks, D]
// partials over the blocks in a fixed order.  The result is deterministic.

#include "common.cuh"
#include "dropout.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kPartBlocks = 264;  // two per SM of the H100

int ln_bwd_blocks(long long n) {
  const long long want = (n + kWarps - 1) / kWarps;
  return (int)(want < kPartBlocks ? want : kPartBlocks);
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kWarps * 32)
add_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ out,
                  T* __restrict__ y_out, float* __restrict__ mean_out,
                  float* __restrict__ rstd_out, long long n, int d,
                  float eps, pt::Dropout drop) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n) return;
  const T* xr = x + row * d;
  const T* rr = res + row * d;
  const uint32_t key = drop.mode == 1 ? drop.row_key(0u, (uint32_t)row) : 0u;

  float y[VPT];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    float t = 0.f;
    if (c < d) {
      float xv = pt::to_f(xr[c]);
      if (drop.mode) xv = drop.apply(xv, key, 0u, (uint32_t)row, c);
      t = xv + pt::to_f(rr[c]);
    }
    y[i] = t;
    sum += t;
  }
  const float mean = pt::warp_sum(sum) / (float)d;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    if (c < d) {
      const float t = y[i] - mean;
      sq += t * t;
    }
  }
  const float var = pt::warp_sum(sq) / (float)d;
  const float rstd = rsqrtf(var + eps);
  T* orow = out + row * d;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    if (c < d) orow[c] = pt::from_f<T>((y[i] - mean) * rstd * gamma[c] + beta[c]);
  }
  if (y_out != nullptr) {
    T* yrow = y_out + row * d;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = lane + 32 * i;
      if (c < d) yrow[c] = pt::from_f<T>(y[i]);
    }
    if (lane == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kWarps * 32)
add_ln_bwd_kernel(const T* __restrict__ dout, const T* __restrict__ y,
                  const float* __restrict__ gamma,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd, T* __restrict__ dx,
                  T* __restrict__ dres, float* __restrict__ part_g,
                  float* __restrict__ part_b, long long n, int d,
                  pt::Dropout drop) {
  extern __shared__ float smem[];  // [2][kWarps][d]: dgamma, dbeta terms
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float* sg = smem + (size_t)warp * d;
  float* sb = smem + (size_t)(kWarps + warp) * d;
  for (int c = lane; c < d; c += 32) sg[c] = sb[c] = 0.f;

  const long long stride = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < n;
       row += stride) {
    const T* gr = dout + row * d;
    const T* yr = y + row * d;
    const float mu = mean[row], rs = rstd[row];
    float g[VPT], xh[VPT];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = lane + 32 * i;
      g[i] = xh[i] = 0.f;
      if (c < d) {
        g[i] = pt::to_f(gr[c]);
        xh[i] = (pt::to_f(yr[c]) - mu) * rs;
        const float dxh = g[i] * gamma[c];
        s1 += dxh;
        s2 += dxh * xh[i];
        sg[c] += g[i] * xh[i];
        sb[c] += g[i];
      }
    }
    const float m1 = pt::warp_sum(s1) / (float)d;
    const float m2 = pt::warp_sum(s2) / (float)d;
    const uint32_t key = drop.mode == 1 ? drop.row_key(0u, (uint32_t)row) : 0u;
    T* dxr = dx + row * d;
    T* drr = dres + row * d;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = lane + 32 * i;
      if (c < d) {
        const float dy = rs * (g[i] * gamma[c] - m1 - xh[i] * m2);
        drr[c] = pt::from_f<T>(dy);
        dxr[c] = pt::from_f<T>(
            drop.mode ? drop.apply(dy, key, 0u, (uint32_t)row, c) : dy);
      }
    }
  }
  __syncthreads();
  // this block's partials: the warps' rows summed in warp order
  for (int c = threadIdx.x; c < d; c += kWarps * 32) {
    float tg = 0.f, tb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      tg += smem[(size_t)w * d + c];
      tb += smem[(size_t)(kWarps + w) * d + c];
    }
    part_g[(size_t)blockIdx.x * d + c] = tg;
    part_b[(size_t)blockIdx.x * d + c] = tb;
  }
}

// dgamma[c] = sum over blocks of part_g[block, c] (and dbeta), in block
// order; one thread per column.
__global__ void ln_bwd_reduce_kernel(const float* __restrict__ part_g,
                                     const float* __restrict__ part_b,
                                     int blocks, int d,
                                     float* __restrict__ dgamma,
                                     float* __restrict__ dbeta) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float tg = 0.f, tb = 0.f;
  for (int b = 0; b < blocks; ++b) {
    tg += part_g[(size_t)b * d + c];
    tb += part_b[(size_t)b * d + c];
  }
  dgamma[c] = tg;
  dbeta[c] = tb;
}

template <typename T, int VPT>
int launch_fwd(const void* x, const void* res, const float* gamma,
               const float* beta, void* out, void* y, float* mean,
               float* rstd, long long n, int d, float eps,
               const pt::Dropout& drop, cudaStream_t stream) {
  const long long blocks = (n + kWarps - 1) / kWarps;
  add_ln_fwd_kernel<T, VPT><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      (const T*)x, (const T*)res, gamma, beta, (T*)out, (T*)y, mean, rstd, n,
      d, eps, drop);
  return (int)cudaGetLastError();
}

template <typename T, int VPT>
int launch_bwd(const void* dout, const void* y, const float* gamma,
               const float* mean, const float* rstd, void* dx, void* dres,
               float* part_g, float* part_b, float* dgamma, float* dbeta,
               long long n, int d, const pt::Dropout& drop,
               cudaStream_t stream) {
  const int blocks = ln_bwd_blocks(n);
  const int smem = 2 * kWarps * d * (int)sizeof(float);
  auto kernel = add_ln_bwd_kernel<T, VPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kWarps * 32, smem, stream>>>(
      (const T*)dout, (const T*)y, gamma, mean, rstd, (T*)dx, (T*)dres,
      part_g, part_b, n, d, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ln_bwd_reduce_kernel<<<(d + 127) / 128, 128, 0, stream>>>(
      part_g, part_b, blocks, d, dgamma, dbeta);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the backward's row kernel, and so rows of its [blocks, d]
// partials, for n rows.
extern "C" int pt_fused_add_ln_bwd_blocks(long long n) {
  return ln_bwd_blocks(n);
}

// x, residual, out [n, d] contiguous, gamma/beta [d] float32, d <= 4096.
// y (like x), mean and rstd ([n] float32) are written when y is not null.
// Dropout: mode 0 off, 1 card generator, 2 debug hash (dropout.cuh).
// Returns the launch's cudaError_t.
extern "C" int pt_fused_add_ln_fwd(const void* x, const void* res,
                                   const void* gamma, const void* beta,
                                   void* out, void* y, void* mean,
                                   void* rstd, long long n, int d, float eps,
                                   int drop_mode, unsigned seed,
                                   unsigned threshold, float keep_scale,
                                   int dtype, void* stream) {
  if (n < 1 || d < 1 || d > 4096 || (n + kWarps - 1) / kWarps > 0x7fffffffLL ||
      drop_mode < 0 || drop_mode > 2 ||
      (y != nullptr && (mean == nullptr || rstd == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* g = (const float*)gamma;
  const float* b = (const float*)beta;
  float* mu = (float*)mean;
  float* rs = (float*)rstd;
  const pt::Dropout drop = pt::make_dropout(drop_mode, seed, threshold,
                                            keep_scale);
#define PT_LN_FWD(T, VPT) \
  launch_fwd<T, VPT>(x, res, g, b, out, y, mu, rs, n, d, eps, drop, s)
  if (dtype == pt::kFloat32) {
    if (d <= 256) return PT_LN_FWD(float, 8);
    if (d <= 1024) return PT_LN_FWD(float, 32);
    return PT_LN_FWD(float, 128);
  }
  if (dtype == pt::kBFloat16) {
    if (d <= 256) return PT_LN_FWD(__nv_bfloat16, 8);
    if (d <= 1024) return PT_LN_FWD(__nv_bfloat16, 32);
    return PT_LN_FWD(__nv_bfloat16, 128);
  }
#undef PT_LN_FWD
  return (int)cudaErrorInvalidValue;
}

// dout, y, dx, dres [n, d] contiguous (x's dtype); gamma [d], mean and
// rstd [n] float32; part_g, part_b [pt_fused_add_ln_bwd_blocks(n), d]
// float32 scratch; dgamma, dbeta [d] float32.  Dropout as the forward's.
// Returns the launches' cudaError_t.
extern "C" int pt_fused_add_ln_bwd(const void* dout, const void* y,
                                   const void* gamma, const void* mean,
                                   const void* rstd, void* dx, void* dres,
                                   void* part_g, void* part_b, void* dgamma,
                                   void* dbeta, long long n, int d,
                                   int drop_mode, unsigned seed,
                                   unsigned threshold, float keep_scale,
                                   int dtype, void* stream) {
  if (n < 1 || d < 1 || d > 4096 || drop_mode < 0 || drop_mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const pt::Dropout drop = pt::make_dropout(drop_mode, seed, threshold,
                                            keep_scale);
#define PT_LN_BWD(T, VPT)                                                     \
  launch_bwd<T, VPT>(dout, y, (const float*)gamma, (const float*)mean,        \
                     (const float*)rstd, dx, dres, (float*)part_g,            \
                     (float*)part_b, (float*)dgamma, (float*)dbeta, n, d, drop, \
                     s)
  if (dtype == pt::kFloat32) {
    if (d <= 256) return PT_LN_BWD(float, 8);
    if (d <= 1024) return PT_LN_BWD(float, 32);
    return PT_LN_BWD(float, 128);
  }
  if (dtype == pt::kBFloat16) {
    if (d <= 256) return PT_LN_BWD(__nv_bfloat16, 8);
    if (d <= 1024) return PT_LN_BWD(__nv_bfloat16, 32);
    return PT_LN_BWD(__nv_bfloat16, 128);
  }
#undef PT_LN_BWD
  return (int)cudaErrorInvalidValue;
}
