// Weight normalization and cast of a stored fp32 weight, in one pass, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package recomputes each layer's effective
// weight in every forward too, but XLA fuses those few elementwise ops and
// their reduction into one loop under jit, and their gradient into another.
// The port runs eagerly, so the same composite (ops/mp.py::weight_normalize, a
// scale, the cast to the compute dtype) costs eight launches a layer forward
// and eleven or twelve backward, beside the autograd nodes the host walks.
// These kernels do each direction in one launch: where no gradient is
// wanted ops/mp.py::weight_norm_cast takes the forward, where one is the
// autograd Function ops/mp.py::_WeightNormCast takes both (models/layers.py).
//
// Function, per output row r of w viewed as (rows, k) (an OIHW weight as
// (O, I*kh*kw)), all in fp32 with IEEE rounding at every step, in the
// composite's order:
//   ss    = sum_j w[r][j] * w[r][j]      (products rounded, then summed)
//   denom = eps + sqrt(ss) * c           (c = fp32(1/sqrt(k)), eps = fp32(1e-4))
//   y[r][j] = T((w[r][j] / denom) * s)   (s = fp32(scale); T = bf16 or fp32)
// Only the order of the sum differs from the composite. The mul/add pairs
// are written with __fmul_rn/__fadd_rn so that nvcc contracts none into an
// FMA, which the composite's separate PyTorch ops never do; the quotient is
// a correctly rounded division, not a product with a reciprocal.
//
// The backward gives the fp32 gradient of the stored weight from g, the
// gradient of y (bf16 or fp32), and w, in the order of the composite's three
// backward nodes (the cast's, the scale's, _PixelNorm.backward), each step
// rounded, the divisor recomputed in the kernel's own sweep:
//   ga      = fp32(g[r][j]) * s
//   ss      = sum_j w*w,  norm = sqrt(ss),  denom = eps + norm * c
//   inner   = sum_j ga*w                 (products rounded, then summed)
//   q       = (inner * c) / ((denom * denom) * max(norm, 1e-30))
//   dw[r][j] = ga / denom - w * q
// Only the order of the two sums differs from the composite.
//
// What bounds it on an H100 SXM: bytes. It reads 4 B from device memory
// (and once more from L2) and writes 2 B (bf16) a parameter, against about 34 B in the composite's eight passes; for all
// the weights an ImageNet-512 forward uses, 1.6 GB, 0.49 ms at 3.35 TB/s.
// Most layers are far smaller than the card (16 rows of 257 in CIFAR-10's
// skip gains, 3 rows in its output conv): one launch, latency-bound, is all
// they cost.
//
// Design: one block per row (the rows of both model configurations hold 12
// to 13,824 values). A block of T threads (32 to 256, a warp per 128 values
// up to 256 threads) reads the row in 16-byte vectors where w and y are
// 16-byte aligned (a scalar head up to the row's first aligned value, since k
// may be odd: 257, 769, 45; a scalar tail). Each thread sums its squares in a
// fixed order, a warp by shuffles, the warps through shared memory: the same
// sum on every run. The second pass reads the row again, from L2 where the
// first left it (a row is at most 54 KB), and writes it. Holding the row in
// registers instead (a kernel for each of five row lengths) saved 2-5% of
// this kernel's time over all the weights of a forward on an H100, 0.016 to
// 0.026 ms of a 23 to 39 ms Heun forward: not worth the code. The backward
// takes the same design: it reads 4 B of w and 2 B (bf16) of g and writes 4 B
// a parameter, 2.7 GB for an ImageNet-512 train step's 4 x 197 layers, 0.8 ms
// at 3.35 TB/s. Its first pass takes both sums at once (one block reduction
// of the pair), its second writes dw from the row in L2.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

// each of the N values summed over the block, the same sum in every thread
template <int N>
__device__ __forceinline__ void block_sums(float (&v)[N]) {
  __shared__ float part[N][kMaxThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] = __fadd_rn(v[i], __shfl_xor_sync(0xffffffffu, v[i], o));
    if (lane == 0) part[i][warp] = v[i];
  }
  __syncthreads();
  // every warp sums the warps' parts in the same order
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = lane < (int)(blockDim.x >> 5) ? part[i][lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] = __fadd_rn(v[i], __shfl_xor_sync(0xffffffffu, v[i], o));
  }
}

__device__ __forceinline__ float block_sum(float v) {
  float vs[1] = {v};
  block_sums(vs);
  return vs[0];
}

__device__ __forceinline__ float sq_add(float acc, float x) { return __fadd_rn(acc, __fmul_rn(x, x)); }

template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 v);
template <>
__device__ __forceinline__ void store4<float>(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

template <typename T>
__device__ __forceinline__ float4 load4(const T* src);
template <>
__device__ __forceinline__ float4 load4<float>(const float* src) {
  return __ldg(reinterpret_cast<const float4*>(src));
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* src) {
  const uint2 packed = __ldg(reinterpret_cast<const uint2*>(src));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&packed.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&packed.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// (x / denom) * s, each step rounded
__device__ __forceinline__ float scaled(float x, float denom, float s) {
  return __fmul_rn(__fdiv_rn(x, denom), s);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    weight_norm_cast_kernel(const float* __restrict__ w, T* __restrict__ y, int k, float c, float eps,
                            float s, int vec_ok) {
  const float* src = w + (size_t)blockIdx.x * k;
  T* dst = y + (size_t)blockIdx.x * k;
  const int t = threadIdx.x, nt = blockDim.x;
  // scalar head up to the first 16-byte aligned value, vector body, tail
  int head = k;
  if (vec_ok) {
    head = (int)((4 - ((reinterpret_cast<uintptr_t>(src) >> 2) & 3)) & 3);
    head = head < k ? head : k;
  }
  const int nvec = (k - head) >> 2;
  const int tail0 = head + 4 * nvec;
  const float4* body = reinterpret_cast<const float4*>(src + head);

  float ss = 0.0f;
  for (int j = t; j < nvec; j += nt) {
    const float4 v = __ldg(body + j);
    ss = sq_add(sq_add(sq_add(sq_add(ss, v.x), v.y), v.z), v.w);
  }
  for (int j = t; j < head; j += nt) ss = sq_add(ss, __ldg(src + j));
  for (int j = tail0 + t; j < k; j += nt) ss = sq_add(ss, __ldg(src + j));

  ss = block_sum(ss);
  const float denom = __fadd_rn(eps, __fmul_rn(__fsqrt_rn(ss), c));

  for (int j = t; j < nvec; j += nt) {
    const float4 v = __ldg(body + j);
    store4<T>(dst + head + 4 * j, make_float4(scaled(v.x, denom, s), scaled(v.y, denom, s),
                                              scaled(v.z, denom, s), scaled(v.w, denom, s)));
  }
  for (int j = t; j < head; j += nt) dst[j] = tinyedm::from_float<T>(scaled(__ldg(src + j), denom, s));
  for (int j = tail0 + t; j < k; j += nt)
    dst[j] = tinyedm::from_float<T>(scaled(__ldg(src + j), denom, s));
}

int block_threads(int k) {
  const int vecs = (k + 3) / 4;
  int threads = 32;  // a warp per 128 values, up to kMaxThreads
  while (threads < kMaxThreads && threads < vecs) threads *= 2;
  return threads;
}

template <typename T>
cudaError_t launch(const float* w, void* y, int rows, int k, float c, float eps, float s, int vec_ok,
                   cudaStream_t stream) {
  weight_norm_cast_kernel<T><<<rows, block_threads(k), 0, stream>>>(w, static_cast<T*>(y), k, c, eps, s, vec_ok);
  return cudaGetLastError();
}

// the sums of the backward's first pass: w*w and ga*w, ga = g * s
__device__ __forceinline__ void bwd_add(float (&acc)[2], float w, float g, float s) {
  acc[0] = sq_add(acc[0], w);
  acc[1] = __fadd_rn(acc[1], __fmul_rn(__fmul_rn(g, s), w));
}

// ga / denom - w * q, each step rounded
__device__ __forceinline__ float bwd_value(float w, float g, float s, float denom, float q) {
  return __fsub_rn(__fdiv_rn(__fmul_rn(g, s), denom), __fmul_rn(w, q));
}

template <typename G>
__global__ void __launch_bounds__(kMaxThreads)
    weight_norm_cast_bwd_kernel(const float* __restrict__ w, const G* __restrict__ g, float* __restrict__ dw, int k,
                                float c, float eps, float s, int vec_ok) {
  const size_t row = (size_t)blockIdx.x * k;
  const float* src = w + row;
  const G* gsrc = g + row;
  float* dst = dw + row;
  const int t = threadIdx.x, nt = blockDim.x;
  // the forward's split: w, g and dw share their offset within a row
  int head = k;
  if (vec_ok) {
    head = (int)((4 - ((reinterpret_cast<uintptr_t>(src) >> 2) & 3)) & 3);
    head = head < k ? head : k;
  }
  const int nvec = (k - head) >> 2;
  const int tail0 = head + 4 * nvec;
  const float4* body = reinterpret_cast<const float4*>(src + head);

  float acc[2] = {0.0f, 0.0f};  // sum w*w, sum ga*w
  for (int j = t; j < nvec; j += nt) {
    const float4 v = __ldg(body + j), gv = load4<G>(gsrc + head + 4 * j);
    bwd_add(acc, v.x, gv.x, s);
    bwd_add(acc, v.y, gv.y, s);
    bwd_add(acc, v.z, gv.z, s);
    bwd_add(acc, v.w, gv.w, s);
  }
  for (int j = t; j < head; j += nt) bwd_add(acc, __ldg(src + j), tinyedm::to_float(gsrc[j]), s);
  for (int j = tail0 + t; j < k; j += nt) bwd_add(acc, __ldg(src + j), tinyedm::to_float(gsrc[j]), s);

  block_sums(acc);
  const float norm = __fsqrt_rn(acc[0]);
  const float denom = __fadd_rn(eps, __fmul_rn(norm, c));
  const float clamped = norm < 1e-30f ? 1e-30f : norm;  // torch.clamp: NaN stays NaN
  const float q = __fdiv_rn(__fmul_rn(acc[1], c), __fmul_rn(__fmul_rn(denom, denom), clamped));

  for (int j = t; j < nvec; j += nt) {
    const float4 v = __ldg(body + j), gv = load4<G>(gsrc + head + 4 * j);
    *reinterpret_cast<float4*>(dst + head + 4 * j) =
        make_float4(bwd_value(v.x, gv.x, s, denom, q), bwd_value(v.y, gv.y, s, denom, q),
                    bwd_value(v.z, gv.z, s, denom, q), bwd_value(v.w, gv.w, s, denom, q));
  }
  for (int j = t; j < head; j += nt) dst[j] = bwd_value(__ldg(src + j), tinyedm::to_float(gsrc[j]), s, denom, q);
  for (int j = tail0 + t; j < k; j += nt)
    dst[j] = bwd_value(__ldg(src + j), tinyedm::to_float(gsrc[j]), s, denom, q);
}

}  // namespace

// w: (rows, k) fp32, contiguous; y: (rows, k) contiguous, bf16 when is_bf16,
// else fp32; s = fp32(scale). c and eps are rounded to fp32 from the doubles
// the composite computes (1/sqrt(k) and 1e-4). Launches on `stream` without
// synchronizing; returns the cudaError_t of the launch (0 on success).
extern "C" int weight_norm_cast(const void* w, void* y, int rows, int k, float s, int is_bf16,
                                void* stream) {
  if (rows < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const float c = (float)(1.0 / sqrt((double)k)), eps = (float)1e-4;
  const int vec_ok = ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const float* src = static_cast<const float*>(w);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch<__nv_bfloat16>(src, y, rows, k, c, eps, s, vec_ok, st);
  return (int)launch<float>(src, y, rows, k, c, eps, s, vec_ok, st);
}

// w, dw: (rows, k) fp32, contiguous; g: (rows, k) contiguous, bf16 when
// g_is_bf16, else fp32; s, c and eps as weight_norm_cast's. Launches on
// `stream` without synchronizing; returns the cudaError_t of the launch.
extern "C" int weight_norm_cast_bwd(const void* w, const void* g, void* dw, int rows, int k, float s, int g_is_bf16,
                                    void* stream) {
  if (rows < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const float c = (float)(1.0 / sqrt((double)k)), eps = (float)1e-4;
  const int vec_ok =
      ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dw)) & 15) == 0;
  const float* src = static_cast<const float*>(w);
  float* dst = static_cast<float*>(dw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_is_bf16)
    weight_norm_cast_bwd_kernel<__nv_bfloat16><<<rows, block_threads(k), 0, st>>>(
        src, static_cast<const __nv_bfloat16*>(g), dst, k, c, eps, s, vec_ok);
  else
    weight_norm_cast_bwd_kernel<float><<<rows, block_threads(k), 0, st>>>(src, static_cast<const float*>(g), dst, k,
                                                                          c, eps, s, vec_ok);
  return (int)cudaGetLastError();
}
