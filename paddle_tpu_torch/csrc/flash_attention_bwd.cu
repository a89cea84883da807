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
//    x truncated to TF32 and small = x - big (split(), flash_mma.cuh), and
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

#include "common.cuh"
#include "dropout.cuh"
#include "flash_mma.cuh"

namespace {

using namespace pt::fa;

template <typename T, int DMAX>
constexpr int smem_bytes(int row_vectors) {
  using Sh = Shape<T, DMAX>;
  return (2 * kBM + 4 * Sh::BN) * Sh::S * (int)sizeof(T) +
         row_vectors * 2 * Sh::BN * (int)sizeof(float);
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
  drop.load_seed(blockIdx.x);
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
          const uint32_t rkey = MODE == 1 ? dd.row_key(row) : 0u;
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
  drop.load_seed(blockIdx.x);
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
    rkey[h] = drop.mode == 1 ? drop.row_key(rows[h]) : 0u;
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

// 16-byte cp.async of whole rows: every row of dh elements starts on 16
// bytes (the base pointers aligned and dh * sizeof(T) a multiple of 16)
template <typename T>
bool vec_ok(const Args& a) {
  return (a.dh * (int)sizeof(T)) % 16 == 0 && aligned16(a.q) &&
         aligned16(a.k) && aligned16(a.v) && aligned16(a.dout);
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
    float scale, int causal, int drop_mode, const void* step,
    unsigned salt, unsigned threshold, float keep_scale, int dtype,
    void* stream) {
  Args a = {};
  a.q = q, a.k = k, a.v = v, a.bias = bias, a.dout = dout;
  a.m = m, a.l = l, a.delta = delta, a.dk = dk, a.dv = dv;
  a.bh = bh, a.heads = heads, a.tq = tq, a.tk = tk, a.dh = dh;
  a.scale = scale, a.causal = causal;
  a.drop = pt::make_dropout(drop_mode, step, salt, threshold, keep_scale);
  return dispatch(true, a, dtype, stream);
}

// The dQ kernel: as the dK/dV kernel, writing dq like q.
extern "C" int pt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* m, const void* l, const void* delta,
    void* dq, int bh, int heads, int tq, int tk, int dh, float scale,
    int causal, int drop_mode, const void* step, unsigned salt,
    unsigned threshold, float keep_scale, int dtype, void* stream) {
  Args a = {};
  a.q = q, a.k = k, a.v = v, a.bias = bias, a.dout = dout;
  a.m = m, a.l = l, a.delta = delta, a.dq = dq;
  a.bh = bh, a.heads = heads, a.tq = tq, a.tk = tk, a.dh = dh;
  a.scale = scale, a.causal = causal;
  a.drop = pt::make_dropout(drop_mode, step, salt, threshold, keep_scale);
  return dispatch(false, a, dtype, stream);
}
