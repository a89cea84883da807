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
// does.  gamma and beta are float32 or x's dtype, widened in registers
// (exact).  The dropout mask comes from dropout.cuh with b = 0 and the
// global (row, col), so the backward redraws it.
//
// What bounds it on the H100: the forward reads x and residual and writes
// out (and y when training), the backward reads dout and y and writes dx
// and dres, a few operations per element, so both are bounded by memory:
// at N=4096, D=768 in float32 each [N, D] tensor is 12.6 MB (~3.8 us at
// 3.35 TB/s), the backward's four 15 us.
//
// Both kernels are built the same way, since a memory-bound kernel is as
// fast as the bytes it keeps in flight and the instructions it spends
// moving them:
//  - 16-byte accesses.  Each thread loads and stores 4 float32 or 8 bf16
//    at a time; a row that is not whole 16-byte chunks, or a tensor not
//    16-byte aligned, takes the same kernel with scalar accesses.
//  - Fixed columns.  A thread owns the same columns for every row it
//    visits: gamma (and beta) is read once into registers.
//  - A team per row, sized to the row.  One warp while a lane holds at
//    most 24 values (D <= 768; at 768 no lane carries a dead slot), its
//    sums warp shuffles; wider rows take several warps, 16 values a thread
//    (D = 4096 does not spill), whose warp sums fold through shared memory
//    in warp order.
//  - Full occupancy.  The grid is the card's SM count times the blocks an
//    SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor), capped by
//    the rows, and its blocks stride over the rows.
//  - Loads in flight.  A team loads its next row into registers before it
//    computes the current one.
//
// Forward.  Blocks of 128 threads (four one-warp teams), or one team of 2,
// 4 or 8 warps (D > 768).  The dropout seed's read goes out after the
// first row's loads, not before them.  The saved y, mean and rstd are
// written only when the caller passes somewhere to write them (training).
// On the H100 at [4096, 768] the float32 forms reach over half their byte
// bound and the bf16 forms ~40%: a bf16 call is short enough that the
// launch and the first and last rows' latency weigh (PERF.md section 6).
// Staging the next rows through shared memory by cp.async (no registers
// held) and three-warp teams (64 registers, more warps an SM) measured
// slower in bf16.
//
// Backward.  Blocks of 256 threads, one warp a row up to D = 768, else the
// block's 8 warps.  The dgamma/dbeta terms accumulate in registers over the
// thread's rows; one fold through shared memory at the end (the block's row
// teams in team order) gives the block's [D] partials.  A deterministic
// cross-block sum: the TPU kernel carries dgamma and dbeta across its
// sequential grid; Hopper's blocks run in no order, and float atomics would
// vary the sums' order.  A second kernel sums the [blocks, D] partials, 32
// columns a block, its 32 warps over the partial rows in a fixed
// interleave, then folded in warp order: the same bits every run.

#include "common.cuh"
#include "dropout.cuh"

namespace {

constexpr int kFwdThreads = 128;   // the forward's block: 4 one-warp teams
constexpr int kBwdThreads = 256;   // the backward's block: 8 warps

// V elements of T moved as one access (16 bytes when V * sizeof(T) = 16)
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T x[V];
};

// gamma (or beta) of G (float32, or bf16 widened: exact) at a thread's
// columns (tt + team * i) * V + u, into registers.  G is a template
// argument, not a runtime flag: a branch on the flag split the prologue,
// and the bf16 side's widening waited there for its loads instead of under
// the first row's (on an H100, 0.5-0.6 us more a call in both kernels).
template <int V, int NV, typename G>
__device__ __forceinline__ void load_params(const G* __restrict__ p,
                                            const bool (&in)[NV], int tt,
                                            int team, float (&out)[V * NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int u = 0; u < V; ++u)
      out[i * V + u] = in[i] ? pt::to_f(p[(tt + team * i) * V + u]) : 0.f;
}

// the sum of v over a team of WPR warps: warp shuffles, then (WPR > 1) the
// warp sums folded in warp order through red[parity], which alternates so
// that one barrier a sum suffices
template <int WPR>
__device__ __forceinline__ float team_sum(float v, float (*red)[WPR],
                                          int& parity, int lane, int warp) {
  v = pt::warp_sum(v);
  if constexpr (WPR > 1) {
    if (lane == 0) red[parity][warp] = v;
    __syncthreads();
    v = 0.f;
#pragma unroll
    for (int w = 0; w < WPR; ++w) v += red[parity][w];
    parity ^= 1;
  }
  return v;
}

// The forward's row kernel.  A team of WPR warps handles one row at a
// time; its thread tt owns the NV accesses of V columns at (tt + 32 * WPR
// * i) * V, i < NV, of every row (VPT = V * NV values).  WPR > 1 means one
// team a block, so every thread of a block visits the same rows and the
// barriers in team_sum are uniform.  As in the backward, the explicit
// minimum of one block an SM keeps ptxas from capping the narrow
// instances' registers with a few bytes of spills.
template <typename T, typename G, int V, int NV, int WPR>
__global__ void __launch_bounds__(WPR > 1 ? 32 * WPR : kFwdThreads, 1)
add_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                  const G* __restrict__ gamma, const G* __restrict__ beta,
                  T* __restrict__ out, T* __restrict__ y_out,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out,
                  long long n, int d, float eps, pt::Dropout drop) {
  constexpr int TEAM = 32 * WPR;
  constexpr int TEAMS = (WPR > 1 ? TEAM : kFwdThreads) / TEAM;
  constexpr int VPT = V * NV;
  using P = Pack<T, V>;
  __shared__ float red[2][WPR];

  const int team = threadIdx.x / TEAM, tt = threadIdx.x % TEAM;
  const int lane = threadIdx.x % 32, warp = tt / 32;
  const long long stride = (long long)gridDim.x * TEAMS;
  long long row = (long long)blockIdx.x * TEAMS + team;
  bool in[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) in[i] = (tt + TEAM * i) * V < d;

  P xc[NV], rc[NV];
  auto load = [&](long long r) {
    const P* xr = reinterpret_cast<const P*>(x + r * d);
    const P* rr = reinterpret_cast<const P*>(res + r * d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (in[i]) {
        xc[i] = xr[tt + TEAM * i];
        rc[i] = rr[tt + TEAM * i];
      }
    }
  };
  if (row < n) load(row);
  // the seed and gamma/beta arrive while the first row's loads are out
  drop.load_seed(0u);
  float gam[VPT], bet[VPT];
  load_params<V, NV>(gamma, in, tt, TEAM, gam);
  load_params<V, NV>(beta, in, tt, TEAM, bet);

  int parity = 0;
  for (; row < n; row += stride) {
    const uint32_t key = drop.mode == 1 ? drop.row_key((uint32_t)row) : 0u;
    float y[VPT];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c0 = (tt + TEAM * i) * V;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        float t = 0.f;
        if (in[i]) {
          float xv = pt::to_f(xc[i].x[u]);
          if (drop.mode) xv = drop.apply(xv, key, 0u, (uint32_t)row, c0 + u);
          t = xv + pt::to_f(rc[i].x[u]);
        }
        y[i * V + u] = t;
        s += t;
      }
    }
    // the next row's loads are in flight through this row's sums and
    // stores
    if (row + stride < n) load(row + stride);
    const float mean = team_sum<WPR>(s, red, parity, lane, warp) / (float)d;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        if (in[i]) {
          const float t = y[i * V + u] - mean;
          sq += t * t;
        }
      }
    }
    const float var = team_sum<WPR>(sq, red, parity, lane, warp) / (float)d;
    const float rstd = rsqrtf(var + eps);
    P* orow = reinterpret_cast<P*>(out + row * d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (!in[i]) continue;
      P po;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int e = i * V + u;
        po.x[u] = pt::from_f<T>((y[e] - mean) * rstd * gam[e] + bet[e]);
      }
      orow[tt + TEAM * i] = po;
    }
    if (y_out != nullptr) {
      P* yrow = reinterpret_cast<P*>(y_out + row * d);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (!in[i]) continue;
        P py;
#pragma unroll
        for (int u = 0; u < V; ++u) py.x[u] = pt::from_f<T>(y[i * V + u]);
        yrow[tt + TEAM * i] = py;
      }
      if (tt == 0) {
        mean_out[row] = mean;
        rstd_out[row] = rstd;
      }
    }
  }
}

// The backward's row kernel.  A team of WPR warps handles one row at a
// time; its thread tt owns the NV accesses of V columns at (tt + 32 * WPR
// * i) * V, i < NV, of every row (VPT = V * NV values); the next row's
// loads are issued before the current row computes.
// The explicit minimum of one block an SM keeps ptxas from capping the
// narrow variants at 80 registers (three blocks) with a few bytes of
// spills; the grid is sized from the occupancy the build gives.
template <typename T, typename G, int V, int NV, int WPR>
__global__ void __launch_bounds__(kBwdThreads, 1)
add_ln_bwd_kernel(const T* __restrict__ dout, const T* __restrict__ y,
                  const G* __restrict__ gamma,
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
    in[i] = (tt + TEAM * i) * V < d;
#pragma unroll
    for (int u = 0; u < V; ++u) ag[i * V + u] = ab[i * V + u] = 0.f;
  }
  load_params<V, NV>(gamma, in, tt, TEAM, gam);

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

// A row kernel's grid: every SM full (the blocks of `threads` an SM holds,
// from the occupancy calculator, queried once into per_sm), or one block
// per team of rows if fewer.  Returns a negated cudaError_t on failure.
template <typename K>
int row_grid(K kernel, int threads, int smem, long long n, int teams,
             int& per_sm) {
  if (per_sm < 1) {
    int b = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, kernel, threads, smem);
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

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

struct FwdArgs {
  const void *x, *res, *gamma, *beta;
  bool param_bf16;
  void *out, *y;
  float *mean, *rstd;
  long long n;
  int d;
  float eps;
  pt::Dropout drop;
};

// Launches the instance; returns the launch's cudaError_t.
template <typename T, typename G, int V, int NV, int WPR>
int run_fwd(const FwdArgs& a, cudaStream_t stream) {
  constexpr int THREADS = WPR > 1 ? 32 * WPR : kFwdThreads;
  static int per_sm = 0;  // the occupancy query, once an instance
  auto kernel = add_ln_fwd_kernel<T, G, V, NV, WPR>;
  const int blocks = row_grid(kernel, THREADS, 0, a.n,
                              THREADS / (32 * WPR), per_sm);
  if (blocks < 0) return -blocks;
  kernel<<<blocks, THREADS, 0, stream>>>(
      (const T*)a.x, (const T*)a.res, (const G*)a.gamma, (const G*)a.beta,
      (T*)a.out, (T*)a.y, a.mean, a.rstd, a.n, a.d, a.eps, a.drop);
  return (int)cudaGetLastError();
}

// The forward's instance for rows of d elements of T and gamma/beta of
// G: 16-byte accesses (vec) or scalar ones; one warp a row up to 24 values
// a lane (D <= 768), else the fewest warps (2, 4 or 8) that hold 16
// values a thread.
template <typename T, typename G>
int select_fwd(const FwdArgs& a, cudaStream_t s) {
  constexpr int E = 16 / sizeof(T);
  const bool vec = (a.d * (int)sizeof(T)) % 16 == 0 && aligned16(a.x) &&
                   aligned16(a.res) && aligned16(a.out) &&
                   (a.y == nullptr || aligned16(a.y));
#define PT_LN_FWD(V, NV, WPR) run_fwd<T, G, V, NV, WPR>(a, s)
  if (vec) {
    const int chunks = a.d / E;
    const int need = ((chunks + 31) / 32) * E;  // values a lane
    if (need <= 8) return PT_LN_FWD(E, 8 / E, 1);
    if (need <= 16) return PT_LN_FWD(E, 16 / E, 1);
    if (need <= 24) return PT_LN_FWD(E, 24 / E, 1);
    if (chunks <= 64 * (16 / E)) return PT_LN_FWD(E, 16 / E, 2);
    if (chunks <= 128 * (16 / E)) return PT_LN_FWD(E, 16 / E, 4);
    return PT_LN_FWD(E, 16 / E, 8);
  }
  const int need = (a.d + 31) / 32;
  if (need <= 8) return PT_LN_FWD(1, 8, 1);
  if (need <= 16) return PT_LN_FWD(1, 16, 1);
  if (need <= 24) return PT_LN_FWD(1, 24, 1);
  if (a.d <= 64 * 16) return PT_LN_FWD(1, 16, 2);
  if (a.d <= 128 * 16) return PT_LN_FWD(1, 16, 4);
  return PT_LN_FWD(1, 16, 8);
#undef PT_LN_FWD
}

struct BwdArgs {
  const void *dout, *y, *gamma;
  bool gamma_bf16;
  const float *mean, *rstd;
  void *dx, *dres;
  float *part_g, *part_b, *dgamma, *dbeta;
  long long n;
  int d;
  pt::Dropout drop;
};

// The instance's grid (launch = false), or its launch into at most
// part_rows blocks followed by the partials' sum (launch = true).
// Returns the grid, or the launches' cudaError_t (negated for a grid).
template <typename T, typename G, int V, int NV, int WPR>
int run_bwd(const BwdArgs& a, bool launch, int part_rows,
            cudaStream_t stream) {
  constexpr int TEAMS = kBwdThreads / (32 * WPR);
  static int per_sm = 0;  // the occupancy query, once an instance
  auto kernel = add_ln_bwd_kernel<T, G, V, NV, WPR>;
  const int smem = TEAMS > 1 ? TEAMS * a.d * (int)sizeof(float) : 0;
  const int blocks = row_grid(kernel, kBwdThreads, smem, a.n, TEAMS, per_sm);
  if (!launch || blocks < 0) return blocks;
  if (blocks > part_rows) return (int)cudaErrorInvalidValue;
  kernel<<<blocks, kBwdThreads, smem, stream>>>(
      (const T*)a.dout, (const T*)a.y, (const G*)a.gamma, a.mean, a.rstd,
      (T*)a.dx, (T*)a.dres, a.part_g, a.part_b, a.n, a.d, a.drop);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ln_bwd_reduce_kernel<<<dim3((a.d + 31) / 32, 2), 32 * kReduceWarps, 0,
                         stream>>>(a.part_g, a.part_b, blocks, a.d, a.dgamma,
                                   a.dbeta);
  return (int)cudaGetLastError();
}

// The backward's instance for rows of d elements of T: 16-byte accesses
// (vec) or scalar ones; one warp a row up to 24 values a lane (D <= 768),
// else 8 warps a row (16 values a thread cover D = 4096; 32 a lane would
// spill).
template <typename T, typename G>
int select_bwd(const BwdArgs& a, bool vec, bool launch, int part_rows,
               cudaStream_t s) {
  constexpr int E = 16 / sizeof(T);
#define PT_LN_BWD(V, NV, WPR) \
  run_bwd<T, G, V, NV, WPR>(a, launch, part_rows, s)
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

// 16-byte accesses: whole 16-byte chunks a row, every row tensor aligned
bool bwd_vec(const BwdArgs& a, int esize) {
  return (a.d * esize) % 16 == 0 && aligned16(a.dout) && aligned16(a.y) &&
         aligned16(a.dx) && aligned16(a.dres);
}

// The backward's instance for x's dtype and gamma's (bf16 gamma with bf16
// rows only): its grid (launch = false) or its launches, as run_bwd.
int dispatch_bwd(const BwdArgs& a, int dtype, bool vec, bool launch,
                 int part_rows, cudaStream_t s) {
  if (dtype == pt::kFloat32 && !a.gamma_bf16)
    return select_bwd<float, float>(a, vec, launch, part_rows, s);
  if (dtype == pt::kBFloat16)
    return a.gamma_bf16 ? select_bwd<__nv_bfloat16, __nv_bfloat16>(
                              a, vec, launch, part_rows, s)
                        : select_bwd<__nv_bfloat16, float>(
                              a, vec, launch, part_rows, s);
  return launch ? (int)cudaErrorInvalidValue : -(int)cudaErrorInvalidValue;
}

bool valid_dtypes(int dtype, int param_dtype) {
  return (dtype == pt::kFloat32 || dtype == pt::kBFloat16) &&
         (param_dtype == pt::kFloat32 || param_dtype == pt::kBFloat16);
}

}  // namespace

// Rows of the backward's [rows, d] dgamma/dbeta partials for n rows of d
// elements of dtype: the largest grid of its 16-byte and scalar kernels
// (for either gamma dtype).
// Returns a negated cudaError_t on failure.
extern "C" int pt_fused_add_ln_bwd_blocks(long long n, int d, int dtype) {
  if (n < 1 || d < 1 || d > 4096 || !valid_dtypes(dtype, pt::kFloat32))
    return -(int)cudaErrorInvalidValue;
  BwdArgs a = {};
  a.n = n, a.d = d;
  const int esize = dtype == pt::kFloat32 ? 4 : 2;
  int best = 0;
  for (int g = 0; g < (dtype == pt::kFloat32 ? 1 : 2); ++g) {
    a.gamma_bf16 = g == 1;
    for (int vec = 0; vec < 2; ++vec) {
      if (vec && (d * esize) % 16 != 0) continue;
      const int b = dispatch_bwd(a, dtype, vec, false, 0, nullptr);
      if (b < 0) return b;
      if (b > best) best = b;
    }
  }
  return best;
}

// x, residual, out [n, d] contiguous, gamma/beta [d] of param_dtype
// (float32 or bf16), d <= 4096.  y (like x), mean and rstd ([n] float32)
// are written when y is not null.  Dropout: mode 0 off, 1 card generator,
// 2 debug hash; the seed is step_seed(*step, salt), or the salt when step
// is null (dropout.cuh).  Returns the launch's cudaError_t.
extern "C" int pt_fused_add_ln_fwd(const void* x, const void* res,
                                   const void* gamma, const void* beta,
                                   void* out, void* y, void* mean,
                                   void* rstd, long long n, int d, float eps,
                                   int drop_mode, const void* step,
                                   unsigned salt, unsigned threshold,
                                   float keep_scale, int dtype,
                                   int param_dtype, void* stream) {
  if (n < 1 || d < 1 || d > 4096 || drop_mode < 0 || drop_mode > 2 ||
      !valid_dtypes(dtype, param_dtype) ||
      (y != nullptr && (mean == nullptr || rstd == nullptr)))
    return (int)cudaErrorInvalidValue;
  FwdArgs a = {};
  a.x = x, a.res = res, a.gamma = gamma, a.beta = beta;
  a.param_bf16 = param_dtype == pt::kBFloat16;
  a.out = out, a.y = y, a.mean = (float*)mean, a.rstd = (float*)rstd;
  a.n = n, a.d = d, a.eps = eps;
  a.drop = pt::make_dropout(drop_mode, step, salt, threshold, keep_scale);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pt::kFloat32)
    return a.param_bf16 ? (int)cudaErrorInvalidValue
                        : select_fwd<float, float>(a, s);
  return a.param_bf16 ? select_fwd<__nv_bfloat16, __nv_bfloat16>(a, s)
                      : select_fwd<__nv_bfloat16, float>(a, s);
}

// dout, y, dx, dres [n, d] contiguous (x's dtype); gamma [d] of
// param_dtype (float32 or bf16); mean and rstd [n] float32; part_g, part_b
// [part_rows, d] float32 scratch with part_rows =
// pt_fused_add_ln_bwd_blocks(n, d, dtype); dgamma, dbeta [d] float32.
// Dropout as the forward's.  Returns the launches' cudaError_t.
extern "C" int pt_fused_add_ln_bwd(const void* dout, const void* y,
                                   const void* gamma, const void* mean,
                                   const void* rstd, void* dx, void* dres,
                                   void* part_g, void* part_b, void* dgamma,
                                   void* dbeta, long long n, int d,
                                   int part_rows, int drop_mode,
                                   const void* step, unsigned salt,
                                   unsigned threshold, float keep_scale,
                                   int dtype, int param_dtype,
                                   void* stream) {
  if (n < 1 || d < 1 || d > 4096 || part_rows < 1 || drop_mode < 0 ||
      drop_mode > 2 || !valid_dtypes(dtype, param_dtype))
    return (int)cudaErrorInvalidValue;
  BwdArgs a = {};
  a.dout = dout, a.y = y, a.gamma = gamma;
  a.gamma_bf16 = param_dtype == pt::kBFloat16;
  a.mean = (const float*)mean, a.rstd = (const float*)rstd;
  a.dx = dx, a.dres = dres, a.part_g = (float*)part_g;
  a.part_b = (float*)part_b, a.dgamma = (float*)dgamma;
  a.dbeta = (float*)dbeta, a.n = n, a.d = d;
  a.drop = pt::make_dropout(drop_mode, step, salt, threshold, keep_scale);
  const int esize = dtype == pt::kFloat32 ? 4 : 2;
  const int err = dispatch_bwd(a, dtype, bwd_vec(a, esize), true, part_rows,
                               (cudaStream_t)stream);
  return err < 0 ? -err : err;
}
