// K7: int8 block quantize and dequantize for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of paddle_tpu/quant/blockwise.py:
// _quantize_call (:137, pallas_call :142, body _quant_kernel :115) and
// _dequantize_call (:159, pallas_call :164, body _dequant_kernel :124).
// A flat tensor cut into blocks of B elements becomes, per block,
//   s = absmax / 127 (1 when absmax is not > 0),
//   q = clip(round_half_even(x / s), -127, 127) as int8,
// and the dequantize is q * s in float32, then cast to float32 or
// bfloat16.
//
// What bounds it on the H100: bytes.  The quantize reads 4 bytes an
// element and writes 1 plus 4/B (5.02 bytes an element at B = 256: a
// 32 MB bucket of 8.4M float32 moves 42.1 MB, 12.6 us at 3.35 TB/s); the
// dequantize the same the other way (2 bytes an element out for
// bfloat16).  Neither does more than a few operations an element.
//
// Design.  Quantize: one warp per block, eight blocks per 256-thread
// CTA.  The lanes stride over the block with 16-byte float4 loads when B
// is a multiple of 4 and the pointer is 16-byte aligned (every row then
// is), else with scalars, so any B > 0 works; the TPU kernel's
// block % 128, nblocks % 8 gate is its tiling and does not carry over.
// A first pass takes |x|'s maximum (a warp __shfl_xor max) and whether
// any element is NaN (a warp vote); the second pass reads the row again
// (from L1/L2: the warp just read it) and stores the int8 values packed
// four to a word on the vector path.  Dequantize: one elementwise pass,
// four elements a thread (a 4-byte int8 load, a 16-byte float32 or
// 8-byte bfloat16 store) where B is a multiple of 4, else one.
//
// Bit-exactness with the reference's float32 composite:
// - division, not a reciprocal multiply (__fdiv_rn), and round half to
//   even (rintf): 63.5 -> 64, 2.5 -> 2, -0.5 -> 0;
// - built without fast math and without flush-to-zero, so a subnormal
//   block gets a subnormal scale;
// - jnp.max propagates NaN where fmaxf drops it: a block holding a NaN
//   has absmax NaN, `absmax > 0` is false, and its scale is 1; the NaN
//   element itself becomes 0 (XLA's float -> int8 of NaN);
// - an inf block gets scale inf and every element 0 (x / inf = 0,
//   inf / inf = NaN -> 0).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kDequantThreads = 256;

__device__ __forceinline__ int8_t quantize_one(float x, float scale) {
  const float v = rintf(__fdiv_rn(x, scale));
  if (isnan(v)) return 0;
  return (int8_t)(int)fminf(fmaxf(v, -127.f), 127.f);
}

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, long long nblocks, int block) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= nblocks) return;
  const float* src = x + row * block;
  int8_t* dst = q + row * block;
  float absmax = 0.f;
  bool nan = false;
  if (kVec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int c = lane; c < block / 4; c += 32) {
      const float4 v = s4[c];
      nan |= isnan(v.x) | isnan(v.y) | isnan(v.z) | isnan(v.w);
      absmax = fmaxf(absmax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                                   fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  } else {
    for (int c = lane; c < block; c += 32) {
      const float v = src[c];
      nan |= isnan(v);
      absmax = fmaxf(absmax, fabsf(v));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    absmax = fmaxf(absmax, __shfl_xor_sync(0xffffffffu, absmax, o));
  nan = __any_sync(0xffffffffu, nan);
  // the reference's where(absmax > 0, absmax / 127, 1), with its NaN
  const float scale = (!nan && absmax > 0.f) ? __fdiv_rn(absmax, 127.f)
                                             : 1.f;
  if (lane == 0) scales[row] = scale;
  if (kVec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    uint32_t* d4 = reinterpret_cast<uint32_t*>(dst);
    for (int c = lane; c < block / 4; c += 32) {
      const float4 v = s4[c];
      const uint32_t b0 = (uint8_t)quantize_one(v.x, scale);
      const uint32_t b1 = (uint8_t)quantize_one(v.y, scale);
      const uint32_t b2 = (uint8_t)quantize_one(v.z, scale);
      const uint32_t b3 = (uint8_t)quantize_one(v.w, scale);
      d4[c] = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
    }
  } else {
    for (int c = lane; c < block; c += 32)
      dst[c] = quantize_one(src[c], scale);
  }
}

template <typename T>
__device__ __forceinline__ T dequant_one(int8_t q, float s) {
  return pt::from_f<T>(__fmul_rn((float)q, s));
}

template <typename T>
__global__ void __launch_bounds__(kDequantThreads)
dequantize_vec_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ scales, T* __restrict__ out,
                      long long groups, int groups_per_block) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const float s = scales[g / groups_per_block];
    const char4 v = reinterpret_cast<const char4*>(q)[g];
    T* o = out + 4 * g;
    o[0] = dequant_one<T>(v.x, s);
    o[1] = dequant_one<T>(v.y, s);
    o[2] = dequant_one<T>(v.z, s);
    o[3] = dequant_one<T>(v.w, s);
  }
}

template <typename T>
__global__ void __launch_bounds__(kDequantThreads)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, T* __restrict__ out,
                  long long n, int block) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = dequant_one<T>(q[i], scales[i / block]);
}

unsigned grid_for(long long work) {
  long long blocks = (work + kDequantThreads - 1) / kDequantThreads;
  const long long cap = 132LL * 16;  // enough CTAs to fill 132 SMs
  return (unsigned)(blocks < cap ? (blocks < 1 ? 1 : blocks) : cap);
}

template <typename T>
int launch_dequant(const int8_t* q, const float* s, void* out,
                   long long nblocks, int block, cudaStream_t stream) {
  const long long n = nblocks * block;
  T* o = (T*)out;
  // 16-byte float32 / 8-byte bfloat16 stores need 4 * sizeof(T) alignment
  const bool vec = block % 4 == 0 && ((uintptr_t)q % 4 == 0) &&
                   ((uintptr_t)out % (4 * sizeof(T)) == 0);
  if (vec) {
    const long long groups = n / 4;
    dequantize_vec_kernel<T><<<grid_for(groups), kDequantThreads, 0,
                               stream>>>(q, s, o, groups, block / 4);
  } else {
    dequantize_kernel<T><<<grid_for(n), kDequantThreads, 0, stream>>>(
        q, s, o, n, block);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x [nblocks, block] float32 contiguous -> q [nblocks, block] int8 and
// scales [nblocks] float32.  Returns the launch's cudaError_t.
extern "C" int pt_block_quantize(const void* x, void* q, void* scales,
                                 long long nblocks, int block,
                                 void* stream) {
  if (nblocks < 1 || block < 1 ||
      (nblocks + kWarps - 1) / kWarps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((nblocks + kWarps - 1) / kWarps);
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = block % 4 == 0 && ((uintptr_t)x % 16 == 0) &&
                   ((uintptr_t)q % 4 == 0);
  if (vec)
    quantize_kernel<true><<<grid, kWarps * 32, 0, s>>>(
        (const float*)x, (int8_t*)q, (float*)scales, nblocks, block);
  else
    quantize_kernel<false><<<grid, kWarps * 32, 0, s>>>(
        (const float*)x, (int8_t*)q, (float*)scales, nblocks, block);
  return (int)cudaGetLastError();
}

// q [nblocks, block] int8, scales [nblocks] float32 -> out [nblocks,
// block] float32 (dtype 0) or bfloat16 (dtype 1).  Returns the launch's
// cudaError_t.
extern "C" int pt_block_dequantize(const void* q, const void* scales,
                                   void* out, long long nblocks, int block,
                                   int dtype, void* stream) {
  if (nblocks < 1 || block < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pt::kFloat32)
    return launch_dequant<float>((const int8_t*)q, (const float*)scales,
                                 out, nblocks, block, s);
  if (dtype == pt::kBFloat16)
    return launch_dequant<__nv_bfloat16>((const int8_t*)q,
                                         (const float*)scales, out, nblocks,
                                         block, s);
  return (int)cudaErrorInvalidValue;
}
