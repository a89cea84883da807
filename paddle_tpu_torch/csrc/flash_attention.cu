// Flash attention forward on Hopper's tensor cores (sm_90a).
//
// Replaces the forward Pallas TPU kernel of
// paddle_tpu/ops/pallas/flash_attention.py (_flash_fwd :235, pallas_call
// :266, body _fwd_kernel :152); its two backward kernels are in
// flash_attention_bwd.cu.  The FlashAttention-2 blocked online softmax over
// q/k/v [B*H, T, Dh] with an additive key bias [B, Tk] broadcast over the
// heads of one batch row (bias row = (b*H + h) / H), an optional causal
// mask (key col visible to query row iff col <= row, also for Tq != Tk),
// statistics in float32, and the row max m and row sum l saved separately
// (not lse: with a -1e4 padding bias on every visible key the float32 sum
// m + log(l) loses log(l), :227-230).  Attention dropout is FA2's: l sums
// the undropped probabilities and only the PV numerator is masked and
// scaled (:198-204); the mask comes from dropout.cuh, a pure function of
// (seed, b*h, row, col), so the backward redraws it.  A key past Tk or
// above the diagonal is excluded; a row that sees no key (every visible
// key biased to -inf) ends with l = 0, returns 0 and saves l = 1, as the
// l == 0 guard of the TPU kernel (:225); m starts at -1e30, never -inf,
// so no exp sees inf - inf.  Under bfloat16 the (dropped) probabilities
// are rounded to bfloat16 before the PV product, as the TPU kernel casts
// p to v's dtype (:208).
//
// What bounds it on the H100: 4 * B*H * Tq * Tk * Dh operations against
// ~4 * B*H * T * Dh elements moved (~128 operations per float32 byte at
// T = 512, Dh = 64), so arithmetic, and only on the tensor cores can the
// card approach it.  The design is the backward's (flash_attention_bwd.cu,
// with the building blocks in flash_mma.cuh), applied to the forward:
//
//  - MMA.  mma.sync m16n8k8 TF32 as 3xTF32 for float32 (each operand
//    split as big = x truncated to TF32, small = x - big; acc += small*big
//    + big*small + big*big: as exact as the float32 product), m16n8k16
//    bf16 with ldmatrix (.trans for V) for bfloat16.
//  - Q once.  One block of 4 warps per (b*h, 64-row query tile); warp w
//    owns query rows 16w .. 16w+15.  Its Q fragments are loaded, and for
//    float32 split, once for the whole key loop: the forward's advantage
//    over the backward, whose fixed tile is one of two operands it
//    re-reads.  At float32 Dh 128 the split fragments (128 registers)
//    would not fit beside the O accumulator, so they are re-read from the
//    Q tile in shared memory at every step.
//  - Asynchronous double-buffered staging: K, V and the key bias arrive by
//    16-byte cp.async (4-byte for the bias) into one buffer while the MMAs
//    run on the other; rows past Tk and columns past Dh are zero-filled.
//    Where a row of Dh elements is not whole 16-byte chunks or a pointer
//    is not 16-byte aligned, plain loads fill the same buffers.
//  - Softmax on the fragments.  S = Q K^T lands in MMA accumulators; the
//    scale, the bias and the causal mask are applied there, the row max
//    and (at the end) the row sum are quad shuffles, p = 2^(x log2 e - m
//    log2 e) runs on MUFU.EX2, and the O accumulator is rescaled by
//    alpha per row.  p stays in registers as the A operand of O += P V
//    (the bf16 accumulator pair is the m16n8k16 A layout; for TF32 the k
//    order of each 8-key step is permuted to the accumulator's columns):
//    nothing of S or P goes through shared memory.
//  - Issue, not the MMAs, bounds these mma.sync kernels (as measured for
//    the backward), so the epilogue is compiled once per dropout mode and
//    once without masks for the tiles that lie wholly inside Tq and Tk
//    and below the diagonal, the products have no guards (DMAX columns,
//    zero-filled), and tiles wholly above the diagonal are skipped.
//  - The 64-row query tile keeps the smallest grids of the main paths
//    (one prefill or serving bucket 1: b*h = 12, T = 512, 96 blocks) from
//    emptying more of the card's 132 SMs.  The streamed key tile is 64
//    rows for Dh <= 64 and 32 for Dh <= 128; the float32 block uses
//    ~87 KB (Dh 64) and ~101 KB (Dh 128) of shared memory, two blocks an
//    SM.

#include "common.cuh"
#include "dropout.cuh"
#include "flash_mma.cuh"

namespace {

using namespace pt::fa;

// The warp's Q fragments for S = Q K^T.  float32 at Dh <= 64: split once
// into registers; float32 at Dh 128: re-read and split at every step
// (gemm_nt); bfloat16: ldmatrix'd once into registers.
template <typename T, int DMAX, int S, bool REG>
struct QFrags;

template <int DMAX, int S>
struct QFrags<float, DMAX, S, true> {
  uint32_t big[DMAX / 8][4], small[DMAX / 8][4];

  __device__ __forceinline__ void load(const float* sQw) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const float* a = sQw + g * S + t;
#pragma unroll
    for (int kk = 0; kk < DMAX / 8; ++kk) {
      split(a[kk * 8], big[kk][0], small[kk][0]);
      split(a[8 * S + kk * 8], big[kk][1], small[kk][1]);
      split(a[kk * 8 + 4], big[kk][2], small[kk][2]);
      split(a[8 * S + kk * 8 + 4], big[kk][3], small[kk][3]);
    }
  }

  // c[16 x BN] += Q_w K^T, as gemm_nt with A from registers
  template <int BN>
  __device__ __forceinline__ void scores(float (&c)[BN / 8][4],
                                         const float* sK) const {
    constexpr int NJ = BN / 8;
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int kk = 0; kk < DMAX / 8; ++kk) {
      uint32_t bb[NJ][2], bs[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* b = sK + (8 * j + g) * S + kk * 8 + t;
        split(b[0], bb[j][0], bs[j][0]);
        split(b[4], bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma_tf32(c[j], small[kk], bb[j][0], bb[j][1]);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma_tf32(c[j], big[kk], bs[j][0], bs[j][1]);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma_tf32(c[j], big[kk], bb[j][0], bb[j][1]);
    }
  }
};

template <int DMAX, int S>
struct QFrags<float, DMAX, S, false> {
  const float* sQw;

  __device__ __forceinline__ void load(const float* p) { sQw = p; }

  template <int BN>
  __device__ __forceinline__ void scores(float (&c)[BN / 8][4],
                                         const float* sK) const {
    gemm_nt<BN, DMAX, S>(c, sQw, sK);
  }
};

template <int DMAX, int S>
struct QFrags<__nv_bfloat16, DMAX, S, true> {
  static constexpr int NK = DMAX / 16;
  uint32_t a[NK][4];

  __device__ __forceinline__ void load(const __nv_bfloat16* sQw) {
    const int lane = threadIdx.x % 32;
    const __nv_bfloat16* a0 = sQw + (lane % 16) * S + (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) ldsm_x4(a[kk], a0 + kk * 16);
  }

  template <int BN>
  __device__ __forceinline__ void scores(float (&c)[BN / 8][4],
                                         const __nv_bfloat16* sK) const {
    constexpr int NJJ = BN / 16;
    const int lane = threadIdx.x % 32;
    const __nv_bfloat16* b0 =
        sK + ((lane / 16) * 8 + lane % 8) * S + ((lane / 8) % 2) * 8;
    // the next step's B fragments load while this step's MMAs run
    uint32_t b[2][NJJ][4];
#pragma unroll
    for (int jj = 0; jj < NJJ; ++jj) ldsm_x4(b[0][jj], b0 + 16 * jj * S);
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int cur = kk % 2, nxt = cur ^ 1;
      if (kk + 1 < NK) {
#pragma unroll
        for (int jj = 0; jj < NJJ; ++jj)
          ldsm_x4(b[nxt][jj], b0 + 16 * jj * S + (kk + 1) * 16);
      }
#pragma unroll
      for (int jj = 0; jj < NJJ; ++jj) {
        mma_bf16(c[2 * jj], a[kk], b[cur][jj][0], b[cur][jj][1]);
        mma_bf16(c[2 * jj + 1], a[kk], b[cur][jj][2], b[cur][jj][3]);
      }
    }
  }
};

template <typename T, int DMAX>
constexpr int fwd_smem_bytes() {
  using Sh = Shape<T, DMAX>;
  return (kBM + 4 * Sh::BN) * Sh::S * (int)sizeof(T) +
         2 * Sh::BN * (int)sizeof(float);
}

constexpr float kNegInf = -1e30f;

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ o, float* __restrict__ m_out,
                 float* __restrict__ l_out, int heads, int tq, int tk,
                 int dh, float scale, int causal, pt::Dropout drop,
                 bool vec) {
  drop.load_seed(blockIdx.x);
  using Sh = Shape<T, DMAX>;
  constexpr int S = Sh::S, BN = Sh::BN, NJ = Sh::NJ, ND = Sh::ND;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kBM * S;       // [2][BN * S]
  T* sV = sK + 2 * BN * S;    // [2][BN * S]
  float* sB = reinterpret_cast<float*>(sV + 2 * BN * S);  // [2][BN]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBM;
  const size_t qoff = (size_t)bh * tq * dh;
  const size_t koff = (size_t)bh * tk * dh;
  const float* brow = bias ? bias + (size_t)(bh / heads) * tk : nullptr;

  // the thread's two query rows (g and g + 8 of the warp's 16), their
  // running max (natural units) and partial row sums, and dropout keys
  int rows[2];
  float m_run[2], l_run[2];
  uint32_t rkey[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rows[h] = q0 + 16 * warp + g + 8 * h;
    m_run[h] = kNegInf;
    l_run[h] = 0.f;
    rkey[h] = drop.mode == 1 ? drop.row_key(rows[h]) : 0u;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

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
  cp_commit();
  stage(0);
  cp_commit();
  cp_wait<1>();  // the Q tile
  __syncthreads();
  QFrags<T, DMAX, S, sizeof(T) == 2 || DMAX <= 64> qf;
  qf.load(sQ + 16 * warp * S);

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      stage(it + 1);  // into the buffer the previous iteration released
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int buf = it % 2, k0 = it * BN;
    const T* tK = sK + buf * BN * S;
    const T* tV = sV + buf * BN * S;

    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    qf.template scores<BN>(s, tK);

    // s <- the (dropped) p of the online softmax, on the fragments
    const bool edge =
        q0 + kBM > tq || k0 + BN > tk || (causal && k0 + BN - 1 > q0);
    with_epilogue(edge, drop.mode, [&](auto mask, auto mode) {
      constexpr bool MASK = decltype(mask)::value;
      constexpr int MODE = decltype(mode)::value;
      pt::Dropout dd = drop;
      dd.mode = MODE;
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const int c = 8 * j + 2 * t + par, col = k0 + c;
          const float b = brow ? sB[buf * BN + c] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + par;
            float x = fmaf(s[j][e], scale, b);
            if (MASK && !(col < tk && (!causal || col <= rows[h])))
              x = -INFINITY;
            s[j][e] = x;
            mx[h] = fmaxf(mx[h], x);
          }
        }
      }
      float ml[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float alpha = ex2((m_run[h] - mx[h]) * kLog2e);
        m_run[h] = mx[h];
        ml[h] = mx[h] * kLog2e;
        l_run[h] *= alpha;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          acc[n][2 * h] *= alpha;
          acc[n][2 * h + 1] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const int col = k0 + 8 * j + 2 * t + par;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + par;
            float p = ex2(fmaf(s[j][e], kLog2e, -ml[h]));
            l_run[h] += p;  // the denominator takes the undropped p
            if (MODE) p = dd.keep(rkey[h], bh, rows[h], col) ? p * dd.scale
                                                             : 0.f;
            s[j][e] = p;
          }
        }
      }
    });

    // O += P V (gemm_rs rounds p to bf16 for the bf16 MMA)
    gemm_rs<BN, DMAX, S>(acc, s, tV);
    __syncthreads();  // this buffer is free for the tile after next
  }

  // the row sums over the quad; o = acc / l, with l = 0 (no visible key)
  // giving o = 0 and a saved l of 1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float denom = l == 0.f ? 1.f : l;
    const float inv = 1.f / denom;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      store_pair(o + qoff, rows[h], tq, 8 * n + 2 * t, dh,
                 acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
    if (t == 0 && rows[h] < tq) {
      m_out[(size_t)bh * tq + rows[h]] = m_run[h];
      l_out[(size_t)bh * tq + rows[h]] = denom;
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *bias;
  void *o, *mo, *lo;
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
         aligned16(a.k) && aligned16(a.v);
}

template <typename T, int DMAX>
int launch_fwd(const Args& a, cudaStream_t stream) {
  const int smem = fwd_smem_bytes<T, DMAX>();
  auto kernel = flash_fwd_kernel<T, DMAX>;
  if (int err = set_smem(kernel, smem)) return err;
  dim3 grid(a.bh, (a.tq + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const float*)a.bias,
      (T*)a.o, (float*)a.mo, (float*)a.lo, a.heads, a.tq, a.tk, a.dh,
      a.scale, a.causal, a.drop, vec_ok<T>(a));
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
// generator, 2 debug hash; the seed is step_seed(*step, salt), or the
// salt when step is null (dropout.cuh).  Returns the launch's cudaError_t.
extern "C" int pt_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      void* o, void* m, void* l, int bh,
                                      int heads, int tq, int tk, int dh,
                                      float scale, int causal, int drop_mode,
                                      const void* step, unsigned salt,
                                      unsigned threshold, float keep_scale,
                                      int dtype,
                                      void* stream) {
  Args a = {};
  a.q = q, a.k = k, a.v = v, a.bias = bias, a.o = o, a.mo = m, a.lo = l;
  a.bh = bh, a.heads = heads, a.tq = tq, a.tk = tk, a.dh = dh;
  a.scale = scale, a.causal = causal;
  a.drop = pt::make_dropout(drop_mode, step, salt, threshold, keep_scale);
  return dispatch(a, dtype, stream);
}
