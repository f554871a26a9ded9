// Device code of the fused pixel-norm + cosine attention forward, shared by
// cosine_attention_fwd.cu (its notes describe the kernel) and the whole-block
// attention (attention_block_{fwd,bwd}.cu), whose attention core it is.
#pragma once

#include "cosine_attention_common.cuh"

namespace cosine_attention {
namespace fwd_detail {

constexpr int kRowsQ = 32;  // query rows per block
constexpr int kRowsK = 64;  // key/value rows per tile

// HDMAX: the head-dim bucket (32, 64, 128 or 256) that fixes how many output
// channels each thread accumulates in registers; channels hd..HDMAX-1 idle.
template <typename T, int HDMAX>
__global__ void __launch_bounds__(kThreads)
    cosine_attention_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int n, int heads,
                                int hd, float scale) {
  constexpr int kLogitRows = kRowsQ * kRowsK / kThreads;  // logits per thread per tile
  constexpr int kLogitStep = kThreads / kRowsK;           // row step between them
  constexpr int kPer = kRowsQ * HDMAX / kThreads;         // outputs per thread
  constexpr int kRowStep = kThreads / HDMAX;              // row step between them
  static_assert(kLogitRows * kLogitStep == kRowsQ, "logit tiling");
  static_assert(kPer * kRowStep == kRowsQ, "output tiling");

  extern __shared__ float smem[];
  const int ks = hd + 1;  // padded k/v row stride: a warp reading one column hits 32 banks
  float* q_s = smem;                     // kRowsQ x hd
  float* k_s = q_s + kRowsQ * hd;        // kRowsK x ks
  float* v_s = k_s + kRowsK * ks;        // kRowsK x ks
  float* p_s = v_s + kRowsK * ks;        // kRowsQ x kRowsK, T(E)
  float* sum_s = p_s + kRowsQ * kRowsK;  // 2 x kRowsQ partial row sums

  const int n_qt = (n + kRowsQ - 1) / kRowsQ;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int h = bh % heads;
  const int b = bh / heads;
  const int C = heads * hd;
  const int c3 = 3 * C;
  const T* slab = qkv + (size_t)b * n * c3;
  const int q0 = qt * kRowsQ;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int lj = tid % kRowsK;   // logits: this thread's key within the tile
  const int li0 = tid / kRowsK;  //         and its first query row
  const int pd = tid % HDMAX;    // output: this thread's channel
  const int pi0 = tid / HDMAX;   //         and its first query row

  load_normalized<T>(slab, n, q0, kRowsQ, c3, h * hd, hd, scale, q_s, hd);

  float acc[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) acc[r] = 0.f;
  float rsum[kLogitRows];
#pragma unroll
  for (int r = 0; r < kLogitRows; ++r) rsum[r] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kRowsK) {
    __syncthreads();  // the previous tile's k_s, v_s and p_s are consumed
    load_normalized<T>(slab, n, k0, kRowsK, c3, C + h * hd, hd, scale, k_s, ks);
    load_normalized<T>(slab, n, k0, kRowsK, c3, 2 * C + h * hd, hd, scale, v_s, ks);
    __syncthreads();

    float l[kLogitRows];
#pragma unroll
    for (int r = 0; r < kLogitRows; ++r) l[r] = 0.f;
    const float* krow = k_s + lj * ks;
    for (int d = 0; d < hd; ++d) {
      const float kv = krow[d];
#pragma unroll
      for (int r = 0; r < kLogitRows; ++r) l[r] += q_s[(li0 + kLogitStep * r) * hd + d] * kv;
    }
    const bool valid = k0 + lj < n;
#pragma unroll
    for (int r = 0; r < kLogitRows; ++r) {
      const float e = valid ? expf(l[r] * scale) : 0.f;
      rsum[r] += e;
      p_s[(li0 + kLogitStep * r) * kRowsK + lj] = round_to<T>(e);
    }
    __syncthreads();

    if (pd < hd) {
      const int kn = min(kRowsK, n - k0);
      for (int j = 0; j < kn; ++j) {
        const float vv = v_s[j * ks + pd];
#pragma unroll
        for (int r = 0; r < kPer; ++r) acc[r] += p_s[(pi0 + kRowStep * r) * kRowsK + j] * vv;
      }
    }
  }

  // row sums: a warp holds 32 of a tile's keys for its rows; the two warps
  // that share rows (keys 0-31 and 32-63) meet in shared memory
#pragma unroll
  for (int r = 0; r < kLogitRows; ++r) {
    for (int o = 16; o > 0; o >>= 1) rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], o);
  }
  if (lane == 0) {
    const int half = (tid / 32) & 1;
#pragma unroll
    for (int r = 0; r < kLogitRows; ++r) sum_s[half * kRowsQ + li0 + kLogitStep * r] = rsum[r];
  }
  __syncthreads();

  if (pd < hd) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = pi0 + kRowStep * r;
      const int row = q0 + i;
      if (row < n) {
        const float s = sum_s[i] + sum_s[kRowsQ + i];
        out[((size_t)b * n + row) * C + h * hd + pd] = from_float<T>(acc[r] / s);
      }
    }
  }
}

template <typename T, int HDMAX>
cudaError_t launch(const void* qkv, void* out, int b, int n, int heads, int hd, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kRowsQ * hd + 2 * (size_t)kRowsK * (hd + 1) + kRowsQ * kRowsK +
                       2 * kRowsQ);
  auto kernel = cosine_attention_fwd_kernel<T, HDMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)b * heads * ((n + kRowsQ - 1) / kRowsQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(static_cast<const T*>(qkv),
                                                         static_cast<T*>(out), n, heads, hd, scale);
  return cudaGetLastError();
}

}  // namespace fwd_detail

// Launches the forward on `stream` (qkv (b, n, 3C), out (b, n, C), one type T).
template <typename T>
cudaError_t attention_fwd(const void* qkv, void* out, int b, int n, int heads, int hd, float scale,
                          cudaStream_t stream) {
  if (hd <= 32) return fwd_detail::launch<T, 32>(qkv, out, b, n, heads, hd, scale, stream);
  if (hd <= 64) return fwd_detail::launch<T, 64>(qkv, out, b, n, heads, hd, scale, stream);
  if (hd <= 128) return fwd_detail::launch<T, 128>(qkv, out, b, n, heads, hd, scale, stream);
  return fwd_detail::launch<T, 256>(qkv, out, b, n, heads, hd, scale, stream);
}

}  // namespace cosine_attention
