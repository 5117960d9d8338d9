// Shared helpers for the port's CUDA kernels (plain C interface, ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with the Python wrappers
enum DType : int { DT_FLOAT32 = 0, DT_BFLOAT16 = 1 };

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  // round to nearest even, as torch's .to(torch.bfloat16)
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) { return __float2bfloat16_rn(x); }
};

template <typename T> __device__ __forceinline__ float to_f(T x) { return Cvt<T>::to_f(x); }
template <typename T> __device__ __forceinline__ T from_f(float x) { return Cvt<T>::from_f(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

#define DRIN_EXPORT extern "C" __attribute__((visibility("default")))

DRIN_EXPORT const char* drin_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
