// Fused BatchNorm + activation epilogue over a channels-last conv output,
// forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/conv_bn_act.py:
// the forward (_fwd_call :148, pallas_call :153, body _fwd_kernel :102),
// out = act(cast((y - mean) * rstd * gamma + beta)) over the [R, C] view
// of an NHWC conv output (R = N*H*W), act identity or relu, in the float
// order of the unfused batch_norm: (y - m) * r, then * g + b, then the
// cast to y's dtype, then the act (:104-109); and the backward (_bwd_call
// :170, pallas_call :175, body _bwd_kernel :112): the relu mask recomputed
// from s = xhat * g + b (the gradient flows iff s > 0, :123-127), dy =
// dout' * (g * r) in y's dtype, and the per-channel sums dgamma =
// sum(dout' * xhat), dbeta = sum(dout'), dmean = -sum(dy), drstd =
// sum(dout' * g * (y - m)) over the rows.  The batch statistics themselves
// are computed outside (torch reductions), and their gradient chain to the
// conv output runs outside too, as in the reference (:28-30).
//
// Every product and sum of the elementwise part uses the _rn intrinsics,
// so nvcc does not contract them into FMAs: the forward output and dy are
// bit-identical with the plain PyTorch version's separate multiplies and
// adds.
//
// What bounds it on the H100: a few operations per element against 8 (fwd,
// f32: read y, write out) or 12 (bwd: read dout and y, write dy) bytes, so
// memory.  At ResNet-50's batch 64 the largest launch is the stem's
// [802816, 64] (205 MB in f32 per tensor, ~61 us at 3.35 TB/s).
//
// Design: the TPU kernel's eligibility (C % 128 == 0, R % 8 == 0) is its
// lane and sublane tiling and does not bind here; any C and R are taken.
// A block is tx x ty threads (256); thread x owns V adjacent channels (V =
// 4 floats or 8 bfloat16, one 16-byte load, when C and the pointers allow,
// else V = 1), holds their gamma/beta/mean/rstd in registers, and strides
// over the rows with the block's ty rows and the grid's gy row tiles.  A
// warp reads 32 x 16 contiguous bytes of one row (or whole rows where C is
// narrow).  The TPU kernel carries its per-channel sums across a
// sequential grid; here the blocks run in parallel and float atomics would
// make the sums' order vary, so each block sums its threads' registers
// over ty in a fixed order into its row tile's [C] partials ([4, gy, C]
// float32 scratch), and a second small kernel sums the gy partials per
// channel in a fixed order (8 warps over strided tiles, then the 8 in
// order).  The result is the same on every run on one card.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinRows = 4;       // rows per thread at least (bounds gy)
constexpr int kMaxTiles = 1024;   // row tiles at most
constexpr int kReduceWarps = 8;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T>
constexpr int vec_width() {
  return 16 / (int)sizeof(T);
}

struct Layout {
  int tx, ty, gx, gy;
};

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      n < 1) {
    cudaGetLastError();  // clear it: the launch reports its own error
    n = 132;
  }
  return n;
}

// tx threads across the C / v vector columns (a power of two up to 32), ty
// rows; gy row tiles: enough blocks for 8 per SM, each thread at least
// kMinRows rows, at most kMaxTiles tiles.
Layout layout(long long rows, int c, int v) {
  Layout L;
  const int cv = c / v;
  L.tx = 1;
  while (L.tx < cv && L.tx < 32) L.tx *= 2;
  L.ty = kThreads / L.tx;
  L.gx = (cv + L.tx - 1) / L.tx;
  long long gy = ((long long)sm_count() * (2048 / kThreads) + L.gx - 1) / L.gx;
  const long long per_tile = (long long)L.ty * kMinRows;
  const long long cap = (rows + per_tile - 1) / per_tile;
  if (gy > cap) gy = cap;
  if (gy > kMaxTiles) gy = kMaxTiles;
  if (gy < 1) gy = 1;
  L.gy = (int)gy;
  return L;
}

// The row tiles of the backward (the partials' rows), from the vector width
// a 16-byte aligned launch of this dtype takes.
int bwd_tiles(long long rows, int c, int dtype) {
  const int w = dtype == pt::kBFloat16 ? vec_width<__nv_bfloat16>()
                                       : vec_width<float>();
  return layout(rows, c, c % w == 0 ? w : 1).gy;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bn_act_fwd_kernel(const T* __restrict__ y, const float* __restrict__ gamma,
                  const float* __restrict__ beta,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd, T* __restrict__ out,
                  long long rows, int c) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;  // vector column
  if (col * V >= c) return;
  float g[V], b[V], m[V], r[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = col * V + j;
    g[j] = gamma[ch];
    b[j] = beta[ch];
    m[j] = mean[ch];
    r[j] = rstd[ch];
  }
  const long long step = (long long)gridDim.y * blockDim.y;
  for (long long row = (long long)blockIdx.y * blockDim.y + threadIdx.y;
       row < rows; row += step) {
    const long long off = row * c + (long long)col * V;
    const Pack<T, V> in = *reinterpret_cast<const Pack<T, V>*>(y + off);
    Pack<T, V> o;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float h = __fmul_rn(__fsub_rn(pt::to_f(in.v[j]), m[j]), r[j]);
      h = __fadd_rn(__fmul_rn(h, g[j]), b[j]);
      T t = pt::from_f<T>(h);
      if (kRelu && pt::to_f(t) < 0.f) t = pt::from_f<T>(0.f);  // NaN stays
      o.v[j] = t;
    }
    *reinterpret_cast<Pack<T, V>*>(out + off) = o;
  }
}

template <typename T, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bn_act_bwd_kernel(const T* __restrict__ dout, const T* __restrict__ y,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd, T* __restrict__ dy,
                  float* __restrict__ part, long long rows, int c) {
  __shared__ float red[kThreads * V];
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = col * V < c;
  // sums of dout' * xhat, dout', dy, dout' * g * (y - m) for V channels
  float acc[4][V];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[q][j] = 0.f;
  if (live) {
    float g[V], b[V], m[V], r[V], gr[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int ch = col * V + j;
      g[j] = gamma[ch];
      b[j] = beta[ch];
      m[j] = mean[ch];
      r[j] = rstd[ch];
      gr[j] = __fmul_rn(g[j], r[j]);
    }
    const long long step = (long long)gridDim.y * blockDim.y;
    for (long long row = (long long)blockIdx.y * blockDim.y + threadIdx.y;
         row < rows; row += step) {
      const long long off = row * c + (long long)col * V;
      const Pack<T, V> dp = *reinterpret_cast<const Pack<T, V>*>(dout + off);
      const Pack<T, V> yp = *reinterpret_cast<const Pack<T, V>*>(y + off);
      Pack<T, V> o;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float cen = __fsub_rn(pt::to_f(yp.v[j]), m[j]);
        const float xh = __fmul_rn(cen, r[j]);
        float d = pt::to_f(dp.v[j]);
        if (kRelu) {
          const float s = __fadd_rn(__fmul_rn(xh, g[j]), b[j]);
          if (!(s > 0.f)) d = 0.f;
        }
        const float dyv = __fmul_rn(d, gr[j]);
        acc[0][j] += d * xh;
        acc[1][j] += d;
        acc[2][j] += dyv;
        acc[3][j] += __fmul_rn(d, g[j]) * cen;
        o.v[j] = pt::from_f<T>(dyv);
      }
      *reinterpret_cast<Pack<T, V>*>(dy + off) = o;
    }
  }
  // this tile's partials: the block's ty rows of threads summed in order
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int j = 0; j < V; ++j) red[t * V + j] = acc[q][j];
    __syncthreads();
    if (threadIdx.y == 0 && live) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float s = 0.f;
        for (int k = 0; k < (int)blockDim.y; ++k)
          s += red[(k * blockDim.x + threadIdx.x) * V + j];
        part[((long long)q * gridDim.y + blockIdx.y) * c + col * V + j] = s;
      }
    }
    __syncthreads();
  }
}

// part [4, tiles, c] → the four [c] sums; dmean is minus the sum of dy.
__global__ void __launch_bounds__(kReduceWarps * 32)
bn_act_bwd_reduce_kernel(const float* __restrict__ part, int tiles, int c,
                         float* __restrict__ dgamma,
                         float* __restrict__ dbeta,
                         float* __restrict__ dmean,
                         float* __restrict__ drstd) {
  __shared__ float red[kReduceWarps][32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int ch = blockIdx.x * 32 + lane;
  const int q = blockIdx.y;
  float s = 0.f;
  if (ch < c)
    for (int t = w; t < tiles; t += kReduceWarps)
      s += part[((long long)q * tiles + t) * c + ch];
  red[w][lane] = s;
  __syncthreads();
  if (w == 0 && ch < c) {
    float tot = 0.f;
#pragma unroll
    for (int k = 0; k < kReduceWarps; ++k) tot += red[k][lane];
    if (q == 0) dgamma[ch] = tot;
    else if (q == 1) dbeta[ch] = tot;
    else if (q == 2) dmean[ch] = -tot;
    else drstd[ch] = tot;
  }
}

template <typename T, int V>
int launch_fwd(const void* y, const float* gamma, const float* beta,
               const float* mean, const float* rstd, void* out,
               long long rows, int c, bool relu, cudaStream_t s) {
  const Layout L = layout(rows, c, V);
  const dim3 block(L.tx, L.ty), grid(L.gx, L.gy);
  if (relu)
    bn_act_fwd_kernel<T, V, true><<<grid, block, 0, s>>>(
        (const T*)y, gamma, beta, mean, rstd, (T*)out, rows, c);
  else
    bn_act_fwd_kernel<T, V, false><<<grid, block, 0, s>>>(
        (const T*)y, gamma, beta, mean, rstd, (T*)out, rows, c);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_bwd(const void* dout, const void* y, const float* gamma,
               const float* beta, const float* mean, const float* rstd,
               void* dy, float* part, float* dgamma, float* dbeta,
               float* dmean, float* drstd, long long rows, int c, int tiles,
               bool relu, cudaStream_t s) {
  const Layout L = layout(rows, c, V);
  const dim3 block(L.tx, L.ty), grid(L.gx, tiles);
  if (relu)
    bn_act_bwd_kernel<T, V, true><<<grid, block, 0, s>>>(
        (const T*)dout, (const T*)y, gamma, beta, mean, rstd, (T*)dy, part,
        rows, c);
  else
    bn_act_bwd_kernel<T, V, false><<<grid, block, 0, s>>>(
        (const T*)dout, (const T*)y, gamma, beta, mean, rstd, (T*)dy, part,
        rows, c);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 rgrid((c + 31) / 32, 4);
  bn_act_bwd_reduce_kernel<<<rgrid, kReduceWarps * 32, 0, s>>>(
      part, tiles, c, dgamma, dbeta, dmean, drstd);
  return (int)cudaGetLastError();
}

}  // namespace

// rows, c → the row tiles of the backward's partials ([4, tiles, c]).
extern "C" int pt_bn_act_bwd_tiles(long long rows, int c, int dtype) {
  if (rows < 1 || c < 1) return 1;
  return bwd_tiles(rows, c, dtype);
}

// y, out [rows, c] contiguous in dtype (0 float32, 1 bfloat16); gamma,
// beta, mean, rstd [c] float32; act 0 identity, 1 relu.  Returns the
// launch's cudaError_t.
extern "C" int pt_bn_act_fwd(const void* y, const void* gamma,
                             const void* beta, const void* mean,
                             const void* rstd, void* out, long long rows,
                             int c, int act, int dtype, void* stream) {
  if (rows < 1 || c < 1 || act < 0 || act > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool relu = act == 1;
  const bool vec = aligned16(y) && aligned16(out);
#define PT_BN_FWD(T, V)                                                    \
  launch_fwd<T, V>(y, (const float*)gamma, (const float*)beta,            \
                   (const float*)mean, (const float*)rstd, out, rows, c, \
                   relu, s)
  if (dtype == pt::kFloat32)
    return vec && c % 4 == 0 ? PT_BN_FWD(float, 4) : PT_BN_FWD(float, 1);
  if (dtype == pt::kBFloat16)
    return vec && c % 8 == 0 ? PT_BN_FWD(__nv_bfloat16, 8)
                             : PT_BN_FWD(__nv_bfloat16, 1);
#undef PT_BN_FWD
  return (int)cudaErrorInvalidValue;
}

// dout, y, dy [rows, c] contiguous in dtype; gamma, beta, mean, rstd [c]
// float32; part [4, tiles, c] float32 scratch with tiles from
// pt_bn_act_bwd_tiles; dgamma, dbeta, dmean, drstd [c] float32.
extern "C" int pt_bn_act_bwd(const void* dout, const void* y,
                             const void* gamma, const void* beta,
                             const void* mean, const void* rstd, void* dy,
                             void* part, void* dgamma, void* dbeta,
                             void* dmean, void* drstd, long long rows, int c,
                             int act, int dtype, void* stream) {
  if (rows < 1 || c < 1 || act < 0 || act > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool relu = act == 1;
  const int tiles = bwd_tiles(rows, c, dtype);
  const bool vec = aligned16(dout) && aligned16(y) && aligned16(dy);
#define PT_BN_BWD(T, V)                                                      \
  launch_bwd<T, V>(dout, y, (const float*)gamma, (const float*)beta,        \
                   (const float*)mean, (const float*)rstd, dy, (float*)part, \
                   (float*)dgamma, (float*)dbeta, (float*)dmean,             \
                   (float*)drstd, rows, c, tiles, relu, s)
  if (dtype == pt::kFloat32)
    return vec && c % 4 == 0 ? PT_BN_BWD(float, 4) : PT_BN_BWD(float, 1);
  if (dtype == pt::kBFloat16)
    return vec && c % 8 == 0 ? PT_BN_BWD(__nv_bfloat16, 8)
                             : PT_BN_BWD(__nv_bfloat16, 1);
#undef PT_BN_BWD
  return (int)cudaErrorInvalidValue;
}
