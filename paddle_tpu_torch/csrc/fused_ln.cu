// Fused residual add + layer norm forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/fused_ln.py
// (_fwd_call :182, pallas_call :190, body _fwd_kernel :86) on the serving
// path: out = (y - mean) * rstd * gamma + beta with y = x + residual, over
// the last axis of [N, D] rows; y, mean and variance in float32, variance
// by two passes over y (fused_ln.py:95-98), out in x's dtype.  Saving y,
// mean and rstd for the backward, and dropout inside the kernel, come
// with the training slice.
//
// What bounds it on the H100: it reads x and residual and writes out,
// three [N, D] tensors, for ~8 operations per element, so it is bounded
// by memory: 37.7 MB at N=4096, D=768 in float32 is ~11 us at 3.35 TB/s.
//
// Design: one warp per row, four rows per 128-thread block.  Lane i reads
// elements i, i+32, ... (coalesced) and keeps its share of y in registers
// (VPT values, a template bound chosen from D), so x and residual are read
// once and the two reductions are warp shuffles; gamma and beta are read
// through the cache.  Any D up to 4096 and any N; the ragged end of a row
// is masked.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;

template <typename T, int VPT>
__global__ void __launch_bounds__(kWarps * 32)
add_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ out,
                  long long n, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n) return;
  const T* xr = x + row * d;
  const T* rr = res + row * d;
  T* orow = out + row * d;

  float y[VPT];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    float t = 0.f;
    if (c < d) t = pt::to_f(xr[c]) + pt::to_f(rr[c]);
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
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    if (c < d) orow[c] = pt::from_f<T>((y[i] - mean) * rstd * gamma[c] + beta[c]);
  }
}

template <typename T, int VPT>
int launch(const void* x, const void* res, const float* gamma,
           const float* beta, void* out, long long n, int d, float eps,
           cudaStream_t stream) {
  const long long blocks = (n + kWarps - 1) / kWarps;
  add_ln_fwd_kernel<T, VPT><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      (const T*)x, (const T*)res, gamma, beta, (T*)out, n, d, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* res, const float* gamma,
             const float* beta, void* out, long long n, int d, float eps,
             cudaStream_t stream) {
  if (d <= 256) return launch<T, 8>(x, res, gamma, beta, out, n, d, eps, stream);
  if (d <= 1024) return launch<T, 32>(x, res, gamma, beta, out, n, d, eps, stream);
  return launch<T, 128>(x, res, gamma, beta, out, n, d, eps, stream);
}

}  // namespace

// x, residual, out [n, d] contiguous, gamma/beta [d] float32, d <= 4096.
// Returns the launch's cudaError_t.
extern "C" int pt_fused_add_ln_fwd(const void* x, const void* res,
                                   const void* gamma, const void* beta,
                                   void* out, long long n, int d, float eps,
                                   int dtype, void* stream) {
  if (n < 1 || d < 1 || d > 4096 || (n + kWarps - 1) / kWarps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* g = (const float*)gamma;
  const float* b = (const float*)beta;
  if (dtype == pt::kFloat32)
    return dispatch<float>(x, res, g, b, out, n, d, eps, s);
  if (dtype == pt::kBFloat16)
    return dispatch<__nv_bfloat16>(x, res, g, b, out, n, d, eps, s);
  return (int)cudaErrorInvalidValue;
}
