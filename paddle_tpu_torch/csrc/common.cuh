// Shared helpers of the hand-written Hopper kernels: float/bfloat16
// conversion, vector loads and stores, and warp reductions.  Every kernel
// computes in float32; inputs and outputs are float32 or bfloat16 (dtype
// code 0 / 1, as the Python wrappers pass it).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// N consecutive elements as float32, and back (each rounded as from_f):
// 16-byte accesses where N elements fill them (float4, 8 bfloat16), an
// 8-byte one for 4 bfloat16, else one element at a time.  The pointer
// is aligned to the access.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&f)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const float4 v = reinterpret_cast<const float4*>(p)[k];
      f[4 * k] = v.x;
      f[4 * k + 1] = v.y;
      f[4 * k + 2] = v.z;
      f[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) f[k] = p[k];
  }
}

__device__ __forceinline__ void unpack_bf16(uint32_t w, float* f) {
  const float2 x = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&w));
  f[0] = x.x;
  f[1] = x.y;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // as from_f
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&f)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int k = 0; k < N / 8; ++k) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[k];
      unpack_bf16(v.x, f + 8 * k);
      unpack_bf16(v.y, f + 8 * k + 2);
      unpack_bf16(v.z, f + 8 * k + 4);
      unpack_bf16(v.w, f + 8 * k + 6);
    }
  } else if constexpr (N == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    unpack_bf16(v.x, f);
    unpack_bf16(v.y, f + 2);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) f[k] = to_f(p[k]);
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&f)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k)
      reinterpret_cast<float4*>(p)[k] =
          make_float4(f[4 * k], f[4 * k + 1], f[4 * k + 2], f[4 * k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = f[k];
  }
}

template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&f)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int k = 0; k < N / 8; ++k)
      reinterpret_cast<uint4*>(p)[k] = make_uint4(
          pack_bf16(f[8 * k], f[8 * k + 1]),
          pack_bf16(f[8 * k + 2], f[8 * k + 3]),
          pack_bf16(f[8 * k + 4], f[8 * k + 5]),
          pack_bf16(f[8 * k + 6], f[8 * k + 7]));
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = from_f<__nv_bfloat16>(f[k]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace pt
