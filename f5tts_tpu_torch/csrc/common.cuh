// Shared helpers for the port's CUDA kernels: float <-> storage-type
// conversion and rounding through the storage type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace f5 {

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// The value an elementwise op in dtype T produces: compute in fp32, round to T.
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f<T>(from_f<T>(x)); }

}  // namespace f5
