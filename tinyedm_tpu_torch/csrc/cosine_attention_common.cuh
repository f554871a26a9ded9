// Helpers shared by the attention kernels (cosine_attention_{fwd,bwd}.cu,
// flash_attention_{fwd,bwd}.cu): type conversions with the rounding of the
// tensor's type, plain and pixel-normalized row loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cosine_attention {

constexpr int kThreads = 256;
constexpr float kEps = 1e-4f;

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

// Loads rows [row0, row0 + rows) of an (n, width) slab's channels
// [col, col + hd) as fp32 into dst (row stride `stride`), zeros past n.
template <typename T>
__device__ void load_rows(const T* __restrict__ slab, int n, int row0, int rows, long long width,
                          int col, int hd, float* __restrict__ dst, int stride) {
  for (int idx = threadIdx.x; idx < rows * hd; idx += kThreads) {
    const int r = idx / hd, c = idx % hd;
    const int row = row0 + r;
    dst[r * stride + c] = row < n ? to_float(slab[(size_t)row * width + col + c]) : 0.f;
  }
}

// Loads rows [row0, row0 + rows) of one head's hd channels, starting at
// channel `col` of the (n, c3) slab of one sample, pixel-normalizes each row
// and stores the T-rounded result as fp32 into dst (row stride `stride`).
// Rows at or past n are stored as zeros. One warp per row.
template <typename T>
__device__ void load_normalized(const T* __restrict__ slab, int n, int row0, int rows, int c3,
                                int col, int hd, float inv_sqrt_hd, float* __restrict__ dst,
                                int stride) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kThreads / 32) {
    const int row = row0 + r;
    float* d = dst + r * stride;
    if (row >= n) {
      for (int c = lane; c < hd; c += 32) d[c] = 0.f;
      continue;
    }
    const T* src = slab + (size_t)row * c3 + col;
    float ss = 0.f;
    for (int c = lane; c < hd; c += 32) {
      const float v = to_float(src[c]);
      d[c] = v;
      ss += v * v;
    }
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float denom = round_to<T>(kEps + sqrtf(ss) * inv_sqrt_hd);
    for (int c = lane; c < hd; c += 32) d[c] = round_to<T>(d[c] / denom);
  }
}

}  // namespace cosine_attention

// the message of a cudaError_t that a launch function returned (each
// library that includes this header defines it once)
extern "C" const char* cosine_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
