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
// 3.35 TB/s), the backward's four 15 us.
//
// Forward design: one warp per row, four rows per 128-thread block.  Lane
// i reads elements i, i+32, ... (coalesced) and keeps its share of y in
// registers (VPT values, a template bound chosen from D), so x and
// residual are read once and the two reductions are warp shuffles; gamma
// and beta are read through the cache.  The saved y, mean and rstd are
// written only when the caller passes somewhere to write them (training).
//
// Backward design.  A memory-bound kernel is as fast as the bytes it keeps
// in flight, so:
//  - Full occupancy.  The grid is the card's SM count times the blocks an
//    SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor), capped by
//    the rows, and its 256-thread blocks stride over the rows.
//  - Loads in flight.  A row team (one warp for D <= 768, the whole
//    block's 8 warps for wider rows, so D = 4096 holds 16 values a thread
//    and nothing spills) loads its next row's dout, y, mean and rstd into
//    registers before it computes the current one.
//  - 16-byte accesses.  Each thread loads and stores 4 float32 or 8 bf16
//    at a time; a row that is not whole 16-byte chunks, or a tensor not
//    16-byte aligned, takes the same kernel with scalar accesses.
//  - Fixed columns.  A thread owns the same columns for every row it
//    visits: gamma is read once into registers, and the dgamma/dbeta terms
//    accumulate in registers over the thread's rows.  One fold through
//    shared memory at the end (the block's row teams in team order) gives
//    the block's [D] partials.
//  - A deterministic cross-block sum.  The TPU kernel carries dgamma and
//    dbeta across its sequential grid; Hopper's blocks run in no order, and
//    float atomics would vary the sums' order.  A second kernel sums the
//    [blocks, D] partials, 32 columns a block, its 32 warps over the
//    partial rows in a fixed interleave, then folded in warp order: the
//    same bits every run.

#include "common.cuh"
#include "dropout.cuh"

namespace {

constexpr int kWarps = 4;          // the forward's block: 4 rows
constexpr int kBwdThreads = 256;   // the backward's block: 8 warps

template <typename T, int VPT>
__global__ void __launch_bounds__(kWarps * 32)
add_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ out,
                  T* __restrict__ y_out, float* __restrict__ mean_out,
                  float* __restrict__ rstd_out, long long n, int d,
                  float eps, pt::Dropout drop) {
  drop.load_seed(0u);
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n) return;
  const T* xr = x + row * d;
  const T* rr = res + row * d;
  const uint32_t key = drop.mode == 1 ? drop.row_key((uint32_t)row) : 0u;

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

// V elements of T moved as one access (16 bytes when V * sizeof(T) = 16)
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T x[V];
};

// The backward's row kernel.  A team of WPR warps handles one row at a
// time; its thread tt owns the NV accesses of V columns at (tt + 32 * WPR
// * i) * V, i < NV, of every row (VPT = V * NV values); the next row's
// loads are issued before the current row computes.
// The explicit minimum of one block an SM keeps ptxas from capping the
// narrow variants at 80 registers (three blocks) with a few bytes of
// spills; the grid is sized from the occupancy the build gives.
template <typename T, int V, int NV, int WPR>
__global__ void __launch_bounds__(kBwdThreads, 1)
add_ln_bwd_kernel(const T* __restrict__ dout, const T* __restrict__ y,
                  const float* __restrict__ gamma,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd, T* __restrict__ dx,
                  T* __restrict__ dres, float* __restrict__ part_g,
                  float* __restrict__ part_b, long long n, int d,
                  pt::Dropout drop) {
  drop.load_seed(0u);
  constexpr int TEAM = 32 * WPR;
  constexpr int TEAMS = kBwdThreads / TEAM;
  constexpr int VPT = V * NV;
  using P = Pack<T, V>;
  extern __shared__ float fold[];  // [TEAMS][d] when TEAMS > 1
  __shared__ float red[2][2][WPR];  // WPR > 1: the team's row sums

  const int team = threadIdx.x / TEAM, tt = threadIdx.x % TEAM;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % WPR;
  bool in[NV];
  float gam[VPT], ag[VPT], ab[VPT];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c0 = (tt + TEAM * i) * V;
    in[i] = c0 < d;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      gam[i * V + u] = in[i] ? gamma[c0 + u] : 0.f;
      ag[i * V + u] = ab[i * V + u] = 0.f;
    }
  }

  const long long stride = (long long)gridDim.x * TEAMS;
  long long row = (long long)blockIdx.x * TEAMS + team;
  P gc[NV], yc[NV], gn[NV], yn[NV];
  float mu = 0.f, rs = 0.f, mu_n = 0.f, rs_n = 0.f;
  auto load = [&](long long r, P (&g)[NV], P (&yy)[NV], float& m,
                  float& s) {
    const P* gr = reinterpret_cast<const P*>(dout + r * d);
    const P* yr = reinterpret_cast<const P*>(y + r * d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (in[i]) {
        g[i] = gr[tt + TEAM * i];
        yy[i] = yr[tt + TEAM * i];
      }
    }
    m = mean[r];
    s = rstd[r];
  };
  if (row < n) load(row, gc, yc, mu, rs);

  int parity = 0;
  // every team of a block runs the same number of iterations (WPR > 1
  // means one team a block), so the block barrier below is uniform
  for (; row < n; row += stride) {
    if (row + stride < n) load(row + stride, gn, yn, mu_n, rs_n);
    float gv[VPT], xh[VPT];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int e = i * V + u;
        gv[e] = in[i] ? pt::to_f(gc[i].x[u]) : 0.f;
        xh[e] = in[i] ? (pt::to_f(yc[i].x[u]) - mu) * rs : 0.f;
        const float dxh = gv[e] * gam[e];
        s1 += dxh;
        s2 += dxh * xh[e];
        ag[e] += gv[e] * xh[e];
        ab[e] += gv[e];
      }
    }
    s1 = pt::warp_sum(s1);
    s2 = pt::warp_sum(s2);
    if constexpr (WPR > 1) {
      if (lane == 0) {
        red[parity][0][warp] = s1;
        red[parity][1][warp] = s2;
      }
      __syncthreads();
      s1 = s2 = 0.f;
#pragma unroll
      for (int w = 0; w < WPR; ++w) {
        s1 += red[parity][0][w];
        s2 += red[parity][1][w];
      }
      parity ^= 1;  // the next row writes the other slot: one barrier a row
    }
    const float m1 = s1 / (float)d, m2 = s2 / (float)d;
    const uint32_t key = drop.mode == 1 ? drop.row_key((uint32_t)row) : 0u;
    P* dxr = reinterpret_cast<P*>(dx + row * d);
    P* drr = reinterpret_cast<P*>(dres + row * d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (!in[i]) continue;
      const int c0 = (tt + TEAM * i) * V;
      P pr, px;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int e = i * V + u;
        const float dy = rs * (gv[e] * gam[e] - m1 - xh[e] * m2);
        pr.x[u] = pt::from_f<T>(dy);
        px.x[u] = pt::from_f<T>(
            drop.mode ? drop.apply(dy, key, 0u, (uint32_t)row, c0 + u) : dy);
      }
      drr[tt + TEAM * i] = pr;
      dxr[tt + TEAM * i] = px;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      gc[i] = gn[i];
      yc[i] = yn[i];
    }
    mu = mu_n;
    rs = rs_n;
  }

  // this block's partials: the row teams' sums folded in team order
  float* pg = part_g + (size_t)blockIdx.x * d;
  float* pb = part_b + (size_t)blockIdx.x * d;
  if constexpr (TEAMS == 1) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (!in[i]) continue;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        pg[(tt + TEAM * i) * V + u] = ag[i * V + u];
        pb[(tt + TEAM * i) * V + u] = ab[i * V + u];
      }
    }
  } else {
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const float* a = which ? ab : ag;
      float* out = which ? pb : pg;
      float* mine = fold + (size_t)team * d;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (!in[i]) continue;
#pragma unroll
        for (int u = 0; u < V; ++u)
          mine[(tt + TEAM * i) * V + u] = a[i * V + u];
      }
      __syncthreads();
      for (int c = threadIdx.x; c < d; c += kBwdThreads) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < TEAMS; ++w) s += fold[(size_t)w * d + c];
        out[c] = s;
      }
      __syncthreads();
    }
  }
}

// dgamma[c] (blockIdx.y = 0) or dbeta[c] (1) = the sum of the [blocks, d]
// partials' column c: 32 columns a block, warp w of 32 summing partial rows
// w, w + 32, ... in order (a few independent loads a thread, so one trip
// to L2 or so), then the 32 warps' sums folded in warp order.
constexpr int kReduceWarps = 32;

__global__ void __launch_bounds__(32 * kReduceWarps)
ln_bwd_reduce_kernel(const float* __restrict__ part_g,
                     const float* __restrict__ part_b, int blocks, int d,
                     float* __restrict__ dgamma, float* __restrict__ dbeta) {
  __shared__ float sums[kReduceWarps][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  const float* part = blockIdx.y ? part_b : part_g;
  float s = 0.f;
  if (c < d) {
#pragma unroll 4
    for (int b = warp; b < blocks; b += kReduceWarps)
      s += part[(size_t)b * d + c];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kReduceWarps; ++w) t += sums[w][lane];
    (blockIdx.y ? dbeta : dgamma)[c] = t;
  }
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

struct BwdArgs {
  const void *dout, *y;
  const float *gamma, *mean, *rstd;
  void *dx, *dres;
  float *part_g, *part_b, *dgamma, *dbeta;
  long long n;
  int d;
  pt::Dropout drop;
};

// The row kernel's grid: every SM full (the blocks an SM holds, from the
// occupancy calculator), or one block per team of rows if fewer.
template <typename K>
int bwd_grid(K kernel, int smem, long long n, int teams, int& per_sm) {
  if (per_sm < 1) {
    int b = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, kernel, kBwdThreads, smem);
    if (err != cudaSuccess) return -(int)err;
    per_sm = b < 1 ? 1 : b;
  }
  int dev = 0, sms = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return -(int)err;
  if (cudaError_t err = cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, dev))
    return -(int)err;
  const long long want = (n + teams - 1) / teams;
  const long long cap = (long long)sms * per_sm;
  return (int)(want < cap ? want : cap);
}

// The instance's grid (launch = false), or its launch into at most
// part_rows blocks followed by the partials' sum (launch = true).
// Returns the grid, or the launches' cudaError_t (negated for a grid).
template <typename T, int V, int NV, int WPR>
int run_bwd(const BwdArgs& a, bool launch, int part_rows,
            cudaStream_t stream) {
  constexpr int TEAMS = kBwdThreads / (32 * WPR);
  static int per_sm = 0;  // the occupancy query, once an instance
  auto kernel = add_ln_bwd_kernel<T, V, NV, WPR>;
  const int smem = TEAMS > 1 ? TEAMS * a.d * (int)sizeof(float) : 0;
  const int blocks = bwd_grid(kernel, smem, a.n, TEAMS, per_sm);
  if (!launch || blocks < 0) return blocks;
  if (blocks > part_rows) return (int)cudaErrorInvalidValue;
  kernel<<<blocks, kBwdThreads, smem, stream>>>(
      (const T*)a.dout, (const T*)a.y, a.gamma, a.mean, a.rstd, (T*)a.dx,
      (T*)a.dres, a.part_g, a.part_b, a.n, a.d, a.drop);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ln_bwd_reduce_kernel<<<dim3((a.d + 31) / 32, 2), 32 * kReduceWarps, 0,
                         stream>>>(a.part_g, a.part_b, blocks, a.d, a.dgamma,
                                   a.dbeta);
  return (int)cudaGetLastError();
}

// The instance for rows of d elements of T: 16-byte accesses (vec) or
// scalar ones; one warp a row up to 24 values a lane (D <= 768), else 8
// warps a row (16 values a thread cover D = 4096; 32 a lane would spill).
template <typename T>
int select_bwd(const BwdArgs& a, bool vec, bool launch, int part_rows,
               cudaStream_t s) {
  constexpr int E = 16 / sizeof(T);
#define PT_LN_BWD(V, NV, WPR) run_bwd<T, V, NV, WPR>(a, launch, part_rows, s)
  if (vec) {
    const int need = ((a.d / E + 31) / 32) * E;  // values a lane
    if (need <= 8) return PT_LN_BWD(E, 8 / E, 1);
    if (need <= 16) return PT_LN_BWD(E, 16 / E, 1);
    if (need <= 24) return PT_LN_BWD(E, 24 / E, 1);
    return PT_LN_BWD(E, 16 / E, 8);
  }
  const int need = (a.d + 31) / 32;
  if (need <= 8) return PT_LN_BWD(1, 8, 1);
  if (need <= 16) return PT_LN_BWD(1, 16, 1);
  if (need <= 24) return PT_LN_BWD(1, 24, 1);
  return PT_LN_BWD(1, 16, 8);
#undef PT_LN_BWD
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// 16-byte accesses: whole 16-byte chunks a row, every row tensor aligned
bool bwd_vec(const BwdArgs& a, int esize) {
  return (a.d * esize) % 16 == 0 && aligned16(a.dout) && aligned16(a.y) &&
         aligned16(a.dx) && aligned16(a.dres);
}

int dispatch_bwd(const BwdArgs& a, int dtype, bool launch, int part_rows,
                 cudaStream_t s) {
  if (dtype == pt::kFloat32)
    return select_bwd<float>(a, bwd_vec(a, 4), launch, part_rows, s);
  if (dtype == pt::kBFloat16)
    return select_bwd<__nv_bfloat16>(a, bwd_vec(a, 2), launch, part_rows, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Rows of the backward's [rows, d] dgamma/dbeta partials for n rows of d
// elements of dtype: the larger grid of its 16-byte and scalar kernels.
// Returns a negated cudaError_t on failure.
extern "C" int pt_fused_add_ln_bwd_blocks(long long n, int d, int dtype) {
  if (n < 1 || d < 1 || d > 4096 || (dtype != pt::kFloat32 &&
                                     dtype != pt::kBFloat16))
    return -(int)cudaErrorInvalidValue;
  BwdArgs a = {};
  a.n = n, a.d = d;
  const int esize = dtype == pt::kFloat32 ? 4 : 2;
  int best = 0;
  for (int vec = 0; vec < 2; ++vec) {
    if (vec && (d * esize) % 16 != 0) continue;
    const int b = dtype == pt::kFloat32
                      ? select_bwd<float>(a, vec, false, 0, nullptr)
                      : select_bwd<__nv_bfloat16>(a, vec, false, 0, nullptr);
    if (b < 0) return b;
    if (b > best) best = b;
  }
  return best;
}

// x, residual, out [n, d] contiguous, gamma/beta [d] float32, d <= 4096.
// y (like x), mean and rstd ([n] float32) are written when y is not null.
// Dropout: mode 0 off, 1 card generator, 2 debug hash; the seed is
// step_seed(*step, salt), or the salt when step is null (dropout.cuh).
// Returns the launch's cudaError_t.
extern "C" int pt_fused_add_ln_fwd(const void* x, const void* res,
                                   const void* gamma, const void* beta,
                                   void* out, void* y, void* mean,
                                   void* rstd, long long n, int d, float eps,
                                   int drop_mode, const void* step,
                                   unsigned salt, unsigned threshold,
                                   float keep_scale, int dtype,
                                   void* stream) {
  if (n < 1 || d < 1 || d > 4096 || (n + kWarps - 1) / kWarps > 0x7fffffffLL ||
      drop_mode < 0 || drop_mode > 2 ||
      (y != nullptr && (mean == nullptr || rstd == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* g = (const float*)gamma;
  const float* b = (const float*)beta;
  float* mu = (float*)mean;
  float* rs = (float*)rstd;
  const pt::Dropout drop =
      pt::make_dropout(drop_mode, step, salt, threshold, keep_scale);
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
// rstd [n] float32; part_g, part_b [part_rows, d] float32 scratch with
// part_rows = pt_fused_add_ln_bwd_blocks(n, d, dtype); dgamma, dbeta [d]
// float32.  Dropout as the forward's.  Returns the launches' cudaError_t.
extern "C" int pt_fused_add_ln_bwd(const void* dout, const void* y,
                                   const void* gamma, const void* mean,
                                   const void* rstd, void* dx, void* dres,
                                   void* part_g, void* part_b, void* dgamma,
                                   void* dbeta, long long n, int d,
                                   int part_rows, int drop_mode,
                                   const void* step, unsigned salt,
                                   unsigned threshold, float keep_scale,
                                   int dtype,
                                   void* stream) {
  if (n < 1 || d < 1 || d > 4096 || part_rows < 1 || drop_mode < 0 ||
      drop_mode > 2)
    return (int)cudaErrorInvalidValue;
  BwdArgs a = {};
  a.dout = dout, a.y = y, a.gamma = (const float*)gamma;
  a.mean = (const float*)mean, a.rstd = (const float*)rstd;
  a.dx = dx, a.dres = dres, a.part_g = (float*)part_g;
  a.part_b = (float*)part_b, a.dgamma = (float*)dgamma;
  a.dbeta = (float*)dbeta, a.n = n, a.d = d;
  a.drop = pt::make_dropout(drop_mode, step, salt, threshold, keep_scale);
  const int err = dispatch_bwd(a, dtype, true, part_rows,
                               (cudaStream_t)stream);
  return err < 0 ? -err : err;
}
