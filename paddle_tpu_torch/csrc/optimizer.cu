// Optimizer updates for Hopper (sm_90a), in place: Adam, Momentum (plain
// and Nesterov) and SGD, one launch per parameter, and the multi-tensor
// Adam and SGD that update every member of a fused op in one launch per
// chunk of members.
//
// Mirrors the update ops of paddle_tpu/ops/optimizer_ops.py (sgd :22,
// momentum :28-43, adam :46-77, fused_sgd :347-363, fused_adam :366-435).
// The reference has no Pallas kernel for them: XLA fuses each update into
// the jitted step and the step donates the buffers.  Here the update is a
// hand-written kernel that writes ParamOut into Param and the moments (or
// the velocity) into their inputs, so a captured step copies no state
// back.
//
// What bounds them on the H100: bytes.  Adam reads p, g, m1, m2 and writes
// p, m1, m2 (28 bytes a float32 parameter), Momentum 20, SGD 12; a few
// operations each, far below the card's operation rate.  Adam and
// Momentum are one grid-stride loop of 4-byte accesses.  SGD moves 16
// bytes an access (float4, 8 bfloat16) with kSgdUnroll vectors of p and g
// in flight a thread and a scalar head and tail where p is not 16-byte
// aligned; each block takes a fixed chunk of elements (one such run a
// thread), of the parameter or, in the multi-tensor SGD, of a member
// found by a binary search over the members' first blocks.  The
// multi-tensor kernels take their members' pointers as kernel arguments,
// by value (a table of at most kMaxAdam or kMaxSgd members, under the 4 KB
// argument limit), so a launch copies nothing from the host and a CUDA
// graph captures it as it is.
//
// Arithmetic.  Each element is computed as the plain PyTorch op computes
// it, one rounding per PyTorch kernel: __fmul_rn / __fadd_rn / __fsub_rn
// / __fdiv_rn / __fsqrt_rn keep nvcc from contracting a*b+c into an FMA,
// and the Momentum and SGD updates round every intermediate to the
// parameter's type, as PyTorch's bfloat16 kernels do; Adam computes in
// float32 and rounds once at the end (reference: lr_t = lr *
// sqrt(1 - beta2^t) / (1 - beta1^t), eps added to sqrt(m2)).  So a kernel
// matches its plain twin on the card bit for bit, and an eager step equals
// a replayed one.  LearningRate and the beta powers are read through
// device pointers (float32 or bfloat16), never on the host.
//
// The beta powers.  Every block of an Adam update reads Beta1Pow and
// Beta2Pow; advancing them in the same launch would let a late block read
// an advanced power.  A second launch on the same stream, one thread a
// member, advances them after the update (adam_pow_kernel,
// multi_adam_pow_kernel; not counted as launches of their own).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kMaxAdam = 56;
constexpr int kMaxSgd = 128;
constexpr int kSgdUnroll = 2;  // vectors of p and g in flight a thread

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float load_scalar(const void* p, int code) {
  return code == pt::kFloat32 ? *(const float*)p
                              : __bfloat162float(*(const bf16*)p);
}

__device__ __forceinline__ void store_scalar(void* p, int code, float x) {
  if (code == pt::kFloat32)
    *(float*)p = x;
  else
    *(bf16*)p = __float2bfloat16(x);
}

struct AdamHyper {
  float beta1, one_minus_beta1, beta2, one_minus_beta2, eps;
};

// lr * sqrt(1 - b2p) / (1 - b1p), as three float32 PyTorch ops
__device__ __forceinline__ float adam_lr_t(float lr, float b1p, float b2p) {
  return __fdiv_rn(__fmul_rn(lr, __fsqrt_rn(__fsub_rn(1.f, b2p))),
                   __fsub_rn(1.f, b1p));
}

template <typename P, typename G, typename M>
__device__ __forceinline__ void adam_elems(P* p, const G* g, M* m1, M* m2,
                                           long long n, long long first,
                                           long long stride, float lr_t,
                                           const AdamHyper& h) {
  for (long long i = first; i < n; i += stride) {
    const float gi = pt::to_f(g[i]);
    const float m1n = __fadd_rn(__fmul_rn(h.beta1, pt::to_f(m1[i])),
                                __fmul_rn(h.one_minus_beta1, gi));
    const float m2n = __fadd_rn(__fmul_rn(h.beta2, pt::to_f(m2[i])),
                                __fmul_rn(h.one_minus_beta2, __fmul_rn(gi, gi)));
    const float step = __fdiv_rn(__fmul_rn(lr_t, m1n),
                                 __fadd_rn(__fsqrt_rn(m2n), h.eps));
    p[i] = pt::from_f<P>(__fsub_rn(pt::to_f(p[i]), step));
    m1[i] = pt::from_f<M>(m1n);
    m2[i] = pt::from_f<M>(m2n);
  }
}

template <typename P, typename G, typename M>
__global__ void __launch_bounds__(kThreads)
adam_update_kernel(P* p, const G* g, M* m1, M* m2, const void* lr,
                   const void* b1p, const void* b2p, int lr_code,
                   int pow_code, long long n, AdamHyper h) {
  const float lr_t = adam_lr_t(load_scalar(lr, lr_code),
                               load_scalar(b1p, pow_code),
                               load_scalar(b2p, pow_code));
  adam_elems(p, g, m1, m2, n, (long long)blockIdx.x * kThreads + threadIdx.x,
             (long long)gridDim.x * kThreads, lr_t, h);
}

__global__ void adam_pow_kernel(void* b1p, void* b2p, int code, float beta1,
                                float beta2) {
  store_scalar(b1p, code, __fmul_rn(load_scalar(b1p, code), beta1));
  store_scalar(b2p, code, __fmul_rn(load_scalar(b2p, code), beta2));
}

// Momentum: v = mu * v + g; Nesterov p -= (g + mu * v) * lr, else
// p -= lr * v; every op rounded to the parameter's type T
template <typename T, typename G>
__global__ void __launch_bounds__(kThreads)
momentum_update_kernel(T* p, const G* g, T* v, const void* lr, int lr_code,
                       long long n, float mu, int nesterov) {
  const float lr_p = pt::round_to<T>(load_scalar(lr, lr_code));
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const float gi = pt::round_to<T>(pt::to_f(g[i]));
    const float vn = pt::round_to<T>(__fadd_rn(
        pt::round_to<T>(__fmul_rn(mu, pt::to_f(v[i]))), gi));
    float step;
    if (nesterov)
      step = pt::round_to<T>(__fmul_rn(
          pt::round_to<T>(__fadd_rn(gi, pt::round_to<T>(__fmul_rn(mu, vn)))),
          lr_p));
    else
      step = pt::round_to<T>(__fmul_rn(lr_p, vn));
    p[i] = pt::from_f<T>(__fsub_rn(pt::to_f(p[i]), step));
    v[i] = pt::from_f<T>(vn);
  }
}

// SGD: p -= lr * g, both ops rounded to the parameter's type T
template <typename T>
__device__ __forceinline__ float sgd_value(float p, float g, float lr_p) {
  const float step = pt::round_to<T>(__fmul_rn(lr_p, pt::round_to<T>(g)));
  return __fsub_rn(p, step);
}

// SGD over `count` runs of kW consecutive elements: thread tid takes
// every nthreads-th run, kSgdUnroll runs of p and g in flight
template <int kW, typename T, typename G>
__device__ __forceinline__ void sgd_runs(T* p, const G* g, long long count,
                                         long long tid, long long nthreads,
                                         float lr_p) {
  for (long long v0 = tid; v0 < count; v0 += nthreads * kSgdUnroll) {
    float pf[kSgdUnroll][kW], gf[kSgdUnroll][kW];
#pragma unroll
    for (int u = 0; u < kSgdUnroll; ++u) {
      const long long v = v0 + u * nthreads;
      if (v < count) {
        pt::load_vec(p + v * kW, pf[u]);
        pt::load_vec(g + v * kW, gf[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kSgdUnroll; ++u) {
      const long long v = v0 + u * nthreads;
      if (v < count) {
#pragma unroll
        for (int e = 0; e < kW; ++e)
          pf[u][e] = sgd_value<T>(pf[u][e], gf[u][e], lr_p);
        pt::store_vec(p + v * kW, pf[u]);
      }
    }
  }
}

// SGD over n elements by a block's threads: 16-byte accesses (kV elements
// of T; g's kV elements in one or two accesses) from p's first 16-byte
// boundary, the elements before it and after the last whole vector one
// a thread, loaded beside the vectors; all one element an access where
// g's vectors would not be aligned where p's are
template <typename T, typename G>
__device__ __forceinline__ void sgd_span(T* p, const G* g, long long n,
                                         long long tid, long long nthreads,
                                         float lr_p) {
  constexpr int kV = 16 / sizeof(T);
  constexpr int kGAlign = kV * sizeof(G) < 16 ? kV * sizeof(G) : 16;
  const uintptr_t to_edge = (16 - ((uintptr_t)p & 15)) & 15;
  long long head = (long long)(to_edge / sizeof(T));
  if (head > n) head = n;
  if (((uintptr_t)(g + head) & (kGAlign - 1)) != 0) {
    sgd_runs<1>(p, g, n, tid, nthreads, lr_p);
    return;
  }
  const long long vecs = (n - head) / kV;
  const long long tail = head + vecs * kV;
  long long one = -1;  // this thread's element outside the vectors
  float p1 = 0.f, g1 = 0.f;
  if (tid < head + (n - tail)) {
    one = tid < head ? tid : tail + (tid - head);
    p1 = pt::to_f(p[one]);
    g1 = pt::to_f(g[one]);
  }
  sgd_runs<kV>(p + head, g + head, vecs, tid, nthreads, lr_p);
  if (one >= 0) p[one] = pt::from_f<T>(sgd_value<T>(p1, g1, lr_p));
}

// elements an SGD block takes: one run of kSgdUnroll vectors a thread
template <typename T>
__host__ __device__ constexpr long long sgd_chunk() {
  return (long long)kThreads * kSgdUnroll * (16 / sizeof(T));
}

// block b takes elements [b, b + 1) * sgd_chunk<T>()
template <typename T, typename G>
__global__ void __launch_bounds__(kThreads)
sgd_update_kernel(T* p, const G* g, const void* lr, int lr_code,
                  long long n) {
  constexpr long long chunk = sgd_chunk<T>();
  const long long first = (long long)blockIdx.x * chunk;
  sgd_span(p + first, g + first, n - first < chunk ? n - first : chunk,
           threadIdx.x, kThreads, pt::round_to<T>(load_scalar(lr, lr_code)));
}

// ---- multi-tensor: a chunk's members by value; member k owns blocks
// [start[k], start[k + 1]) (Adam: strides over its elements with them;
// SGD: one fixed chunk of its elements a block)

struct AdamMember {
  void* p;
  const void* g;
  void* m1;
  void* m2;
  void* b1p;
  void* b2p;
  long long n;
};

struct AdamTable {
  int count;
  int start[kMaxAdam + 1];
  AdamMember m[kMaxAdam];
};

struct SgdMember {
  void* p;
  const void* g;
  long long n;
};

struct SgdTable {
  int count;
  int start[kMaxSgd + 1];
  SgdMember m[kMaxSgd];
};

template <int N>
__device__ __forceinline__ int member_of(const int (&start)[N], int count,
                                         int block) {
  int k = 0;
  while (k + 1 < count && start[k + 1] <= block) ++k;
  return k;
}

template <typename P, typename G, typename M>
__global__ void __launch_bounds__(kThreads)
multi_adam_kernel(const __grid_constant__ AdamTable t, const void* lr, int lr_code,
                  int pow_code, AdamHyper h) {
  const int k = member_of(t.start, t.count, blockIdx.x);
  const AdamMember& m = t.m[k];
  const float lr_t = adam_lr_t(load_scalar(lr, lr_code),
                               load_scalar(m.b1p, pow_code),
                               load_scalar(m.b2p, pow_code));
  const long long blocks = t.start[k + 1] - t.start[k];
  adam_elems((P*)m.p, (const G*)m.g, (M*)m.m1, (M*)m.m2, m.n,
             (long long)(blockIdx.x - t.start[k]) * kThreads + threadIdx.x,
             blocks * kThreads, lr_t, h);
}

__global__ void multi_adam_pow_kernel(const __grid_constant__ AdamTable t, int code,
                                      float beta1, float beta2) {
  const int k = threadIdx.x;
  if (k >= t.count) return;
  store_scalar(t.m[k].b1p, code,
               __fmul_rn(load_scalar(t.m[k].b1p, code), beta1));
  store_scalar(t.m[k].b2p, code,
               __fmul_rn(load_scalar(t.m[k].b2p, code), beta2));
}

// each block takes chunk c of member k, elements [c, c + 1) *
// sgd_chunk<T>(), where start[k] + c is its index: k by a binary search
// over start
template <typename T, typename G>
__global__ void __launch_bounds__(kThreads)
multi_sgd_kernel(const __grid_constant__ SgdTable t, const void* lr, int lr_code) {
  const int b = blockIdx.x;
  int k = 0, hi = t.count - 1;
  while (k < hi) {
    const int mid = (k + hi + 1) >> 1;
    if (t.start[mid] <= b)
      k = mid;
    else
      hi = mid - 1;
  }
  const SgdMember& m = t.m[k];
  constexpr long long chunk = sgd_chunk<T>();
  const long long first = (long long)(b - t.start[k]) * chunk;
  sgd_span((T*)m.p + first, (const G*)m.g + first,
           m.n - first < chunk ? m.n - first : chunk, threadIdx.x, kThreads,
           pt::round_to<T>(load_scalar(lr, lr_code)));
}

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

bool valid(int code) { return code == pt::kFloat32 || code == pt::kBFloat16; }

// f.template run<A, B>() with A, B the C++ types of two dtype codes
template <typename F>
int with_types2(int a, int b, F f) {
  if (a == pt::kFloat32 && b == pt::kFloat32) return f.template run<float, float>();
  if (a == pt::kFloat32) return f.template run<float, bf16>();
  if (b == pt::kFloat32) return f.template run<bf16, float>();
  return f.template run<bf16, bf16>();
}

template <typename F, typename C>
struct WithThird {
  F f;
  template <typename A, typename B>
  int run() { return f.template run<A, B, C>(); }
};

// f.template run<A, B, C>() for three dtype codes
template <typename F>
int with_types3(int a, int b, int c, F f) {
  if (c == pt::kFloat32) return with_types2(a, b, WithThird<F, float>{f});
  return with_types2(a, b, WithThird<F, bf16>{f});
}

struct AdamLaunch {
  void* p;
  const void* g;
  void* m1;
  void* m2;
  const void* lr;
  void* b1p;
  void* b2p;
  int lr_code, pow_code;
  long long n;
  AdamHyper h;
  cudaStream_t s;
  template <typename P, typename G, typename M>
  int run() {
    adam_update_kernel<P, G, M><<<blocks_for(n), kThreads, 0, s>>>(
        (P*)p, (const G*)g, (M*)m1, (M*)m2, lr, b1p, b2p, lr_code, pow_code,
        n, h);
    return (int)cudaGetLastError();
  }
};

struct MomentumLaunch {
  void* p;
  const void* g;
  void* v;
  const void* lr;
  int lr_code;
  long long n;
  float mu;
  int nesterov;
  cudaStream_t s;
  template <typename T, typename G>
  int run() {
    momentum_update_kernel<T, G><<<blocks_for(n), kThreads, 0, s>>>(
        (T*)p, (const G*)g, (T*)v, lr, lr_code, n, mu, nesterov);
    return (int)cudaGetLastError();
  }
};

struct SgdLaunch {
  void* p;
  const void* g;
  const void* lr;
  int lr_code;
  long long n;
  cudaStream_t s;
  template <typename T, typename G>
  int run() {
    sgd_update_kernel<T, G>
        <<<(unsigned)((n + sgd_chunk<T>() - 1) / sgd_chunk<T>()), kThreads,
           0, s>>>(
        (T*)p, (const G*)g, lr, lr_code, n);
    return (int)cudaGetLastError();
  }
};

struct MultiAdamLaunch {
  const AdamTable* t;
  int blocks;
  const void* lr;
  int lr_code, pow_code;
  AdamHyper h;
  cudaStream_t s;
  template <typename P, typename G, typename M>
  int run() {
    multi_adam_kernel<P, G, M><<<blocks, kThreads, 0, s>>>(*t, lr, lr_code,
                                                          pow_code, h);
    return (int)cudaGetLastError();
  }
};

struct MultiSgdLaunch {
  const SgdTable* t;
  int blocks;
  const void* lr;
  int lr_code;
  cudaStream_t s;
  template <typename T, typename G>
  int run() {
    multi_sgd_kernel<T, G><<<blocks, kThreads, 0, s>>>(*t, lr, lr_code);
    return (int)cudaGetLastError();
  }
};

// blocks of one member of a multi-tensor Adam chunk: a quarter of the
// per-parameter kernel's, at least one (each thread strides over ~4
// elements of a member that has them)
int member_blocks(long long n) {
  const long long b = (n + 4LL * kThreads - 1) / (4LL * kThreads);
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

}  // namespace

// Each entry point launches on `stream` and returns the cudaError_t of its
// launches (cudaErrorInvalidValue for arguments it refuses).  Dtype codes:
// 0 float32, 1 bfloat16 (common.cuh).  Pointers are of contiguous tensors.

// Adam on one parameter of n elements: p, g, m1, m2 in place, then the
// beta powers advanced by a second launch
extern "C" int pt_adam_update(void* p, const void* g, void* m1, void* m2,
                              const void* lr, void* b1p, void* b2p,
                              long long n, int p_code, int g_code,
                              int m_code, int lr_code, int pow_code,
                              float beta1, float one_minus_beta1, float beta2,
                              float one_minus_beta2, float eps,
                              void* stream) {
  if (n < 1 || !valid(p_code) || !valid(g_code) || !valid(m_code) ||
      !valid(lr_code) || !valid(pow_code))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const AdamHyper h{beta1, one_minus_beta1, beta2, one_minus_beta2, eps};
  int err = with_types3(p_code, g_code, m_code,
                        AdamLaunch{p, g, m1, m2, lr, b1p, b2p, lr_code,
                                   pow_code, n, h, s});
  if (err) return err;
  adam_pow_kernel<<<1, 1, 0, s>>>(b1p, b2p, pow_code, beta1, beta2);
  return (int)cudaGetLastError();
}

// Momentum on one parameter: p and v (of p's type) in place
extern "C" int pt_momentum_update(void* p, const void* g, void* v,
                                  const void* lr, long long n, int p_code,
                                  int g_code, int lr_code, float mu,
                                  int nesterov, void* stream) {
  if (n < 1 || !valid(p_code) || !valid(g_code) || !valid(lr_code))
    return (int)cudaErrorInvalidValue;
  return with_types2(p_code, g_code,
                     MomentumLaunch{p, g, v, lr, lr_code, n, mu, nesterov,
                                    (cudaStream_t)stream});
}

// SGD on one parameter: p in place
extern "C" int pt_sgd_update(void* p, const void* g, const void* lr,
                             long long n, int p_code, int g_code,
                             int lr_code, void* stream) {
  if (n < 1 || !valid(p_code) || !valid(g_code) || !valid(lr_code))
    return (int)cudaErrorInvalidValue;
  return with_types2(p_code, g_code,
                     SgdLaunch{p, g, lr, lr_code, n, (cudaStream_t)stream});
}

// Adam on `count` members (arrays of their pointers and sizes), in chunks
// of at most kMaxAdam members: per chunk one update launch and one launch
// advancing the chunk's beta powers
extern "C" int pt_multi_adam_update(void* const* p, const void* const* g,
                                    void* const* m1, void* const* m2,
                                    void* const* b1p, void* const* b2p,
                                    const long long* n, int count,
                                    const void* lr, int p_code, int g_code,
                                    int m_code, int lr_code, int pow_code,
                                    float beta1, float one_minus_beta1,
                                    float beta2, float one_minus_beta2,
                                    float eps, void* stream) {
  if (count < 1 || !valid(p_code) || !valid(g_code) || !valid(m_code) ||
      !valid(lr_code) || !valid(pow_code))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const AdamHyper h{beta1, one_minus_beta1, beta2, one_minus_beta2, eps};
  for (int c0 = 0; c0 < count; c0 += kMaxAdam) {
    AdamTable t;
    t.count = count - c0 < kMaxAdam ? count - c0 : kMaxAdam;
    t.start[0] = 0;
    for (int k = 0; k < t.count; ++k) {
      const int i = c0 + k;
      if (n[i] < 1) return (int)cudaErrorInvalidValue;
      t.m[k] = AdamMember{p[i], g[i], m1[i], m2[i], b1p[i], b2p[i], n[i]};
      t.start[k + 1] = t.start[k] + member_blocks(n[i]);
    }
    int err = with_types3(p_code, g_code, m_code,
                          MultiAdamLaunch{&t, t.start[t.count], lr, lr_code,
                                          pow_code, h, s});
    if (err) return err;
    multi_adam_pow_kernel<<<1, kMaxAdam, 0, s>>>(t, pow_code, beta1, beta2);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

// SGD on `count` members, in chunks of at most kMaxSgd members
extern "C" int pt_multi_sgd_update(void* const* p, const void* const* g,
                                   const long long* n, int count,
                                   const void* lr, int p_code, int g_code,
                                   int lr_code, void* stream) {
  if (count < 1 || !valid(p_code) || !valid(g_code) || !valid(lr_code))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  for (int c0 = 0; c0 < count; c0 += kMaxSgd) {
    SgdTable t;
    t.count = count - c0 < kMaxSgd ? count - c0 : kMaxSgd;
    t.start[0] = 0;
    for (int k = 0; k < t.count; ++k) {
      const int i = c0 + k;
      if (n[i] < 1) return (int)cudaErrorInvalidValue;
      t.m[k] = SgdMember{p[i], g[i], n[i]};
      const long long chunk = p_code == pt::kFloat32 ? sgd_chunk<float>()
                                                     : sgd_chunk<bf16>();
      const long long next = t.start[k] + (n[i] + chunk - 1) / chunk;
      if (next > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
      t.start[k + 1] = (int)next;
    }
    const int err = with_types2(p_code, g_code,
                                MultiSgdLaunch{&t, t.start[t.count], lr,
                                               lr_code, s});
    if (err) return err;
  }
  return 0;
}
