// What every library of csrc/ shares: type conversions with the rounding of
// the tensor's type, and the C export that names a launch's error.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tinyedm {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the value a tensor of type T holds after storing x
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

}  // namespace tinyedm

// the message of a cudaError_t that a launch function returned (each
// library includes this header once)
extern "C" const char* tinyedm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
