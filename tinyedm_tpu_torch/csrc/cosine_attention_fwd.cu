// Fused pixel-norm + cosine attention, forward, for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package, which compute one function:
//   tinyedm_tpu/ops/fused_attention.py::_attn_fwd_kernel (:102), per head,
//     the CIFAR-10 path's n = 256 (16x16) layers;
//   tinyedm_tpu/ops/fused_attention.py::_attn_fwd_kernel_pair (:253), head
//     pairs laid out block-diagonally to fill the TPU's 128-wide matrix unit,
//     the n = 64 (8x8) layers. The pairing is a TPU layout device only, and
//     its scratch (zeroed at program_id 0, reused across an in-order grid)
//     has no counterpart here: every block starts from its own zeros.
//
// Function, per (sample, head), on qkv (b, n, 3C) with channels ordered
// (3, heads, hd), output (b, n, C) with channels (heads, hd):
//   x^ = x / T(1e-4 + |x|_2 / sqrt(hd))   for q, k, v; fp32 norm, the
//        divisor rounded to the input type T, the quotient rounded to T
//   L  = q^ k^T / sqrt(hd)                 fp32 products and sums
//   E  = exp(L)                            no max subtraction: |L| <= 1/sqrt(hd)
//   s  = rowsum(E)                         fp32
//   o  = T( (T(E) v^, fp32 sums) / s )
//
// What bounds it on an H100 SXM: at the CIFAR-10 path's batch of 128 in bf16
// the function reads qkv once and writes o once, 67 MB at n = 256 against
// 8.6 GFLOP of products, 16.8 MB at n = 64 against 0.5 GFLOP: memory-bound,
// about 20 us and 5.0 us at 3.35 TB/s.
//
// Design: one thread block per (sample, head, tile of 32 query rows). The
// tile's normalized q^ is staged in shared memory; key/value rows stream
// through shared memory 64 at a time and are normalized as they arrive. With
// no max subtraction the unnormalized sums add across key tiles without any
// online-softmax rescaling, so the block keeps acc += T(E) v^ and s += E and
// divides once at the end; one loop handles any n with shared memory bounded
// by the tile sizes. Only qkv and o cross device memory (qkv's k/v rows are
// read once per query tile, mostly from L2). This first version multiplies on
// the CUDA cores in fp32; tensor-core products (mma/wgmma), TMA loads and
// keeping k^/v^ resident across query tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsQ = 32;  // query rows per block
constexpr int kRowsK = 64;  // key/value rows per tile
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

template <typename T>
cudaError_t dispatch(const void* qkv, void* out, int b, int n, int heads, int hd, float scale,
                     cudaStream_t stream) {
  if (hd <= 32) return launch<T, 32>(qkv, out, b, n, heads, hd, scale, stream);
  if (hd <= 64) return launch<T, 64>(qkv, out, b, n, heads, hd, scale, stream);
  if (hd <= 128) return launch<T, 128>(qkv, out, b, n, heads, hd, scale, stream);
  return launch<T, 256>(qkv, out, b, n, heads, hd, scale, stream);
}

}  // namespace

// qkv: (b, n, 3 * heads * hd) contiguous; out: (b, n, heads * hd) contiguous,
// both of one type: bf16 when is_bf16, else fp32. scale = fp32(1/sqrt(hd)).
// Launches on `stream` without synchronizing; returns the cudaError_t of the
// launch (0 on success).
extern "C" int cosine_attention_fwd(const void* qkv, void* out, int b, int n, int heads, int hd,
                                    int is_bf16, float scale, void* stream) {
  if (b < 1 || n < 1 || heads < 1 || hd < 1 || hd > 256) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)dispatch<__nv_bfloat16>(qkv, out, b, n, heads, hd, scale, s);
  return (int)dispatch<float>(qkv, out, b, n, heads, hd, scale, s);
}

extern "C" const char* cosine_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
