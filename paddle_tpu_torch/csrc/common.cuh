// Shared helpers of the hand-written Hopper kernels: float/bfloat16
// conversion and warp reductions.  Every kernel computes in float32;
// inputs and outputs are float32 or bfloat16 (dtype code 0 / 1, as the
// Python wrappers pass it).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pt {

enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch
}

// x rounded to T's precision and back (identity for float32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace pt
