// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel tinyedm_tpu/ops/attention.py::_attn_kernel (:38,
// reached through the pallas_call at :99 in _flash_fwd_impl): the
// use_pallas_attention route of CosineAttention at n >= 1024 tokens. The TPU
// kernel pads n and hd to 128 and keeps a head's whole K and V in VMEM; here
// nothing is padded: keys at index >= n in the tail tile are masked, and K/V
// stream through shared memory a tile at a time.
//
// Function, per (sample, head), on q, k, v (b, n, heads, hd) of one type T
// (already pixel-normed by the caller), output (b, n, heads, hd) contiguous:
//   L = (q k^T) * scale                 fp32 products and sums, scale = fp32(1/sqrt(hd))
//   m = rowmax(L),  s = rowsum(exp(L - m))                        (fp32)
//   o = T( T(exp(L - m) / s) v )        weights rounded to T before the PV
//                                       product, PV summed in fp32
// and the row statistics m and s, fp32 (2, b, heads, n), for the backward.
//
// What bounds it on an H100 SXM: the function reads q, k, v and writes o,
// 4 b n heads hd sizeof(T) bytes, against 4 b heads n^2 hd FLOP: at the
// ImageNet-512 widths (b = 32, bf16) 0.052 ms of tensor-core time at
// (n = 1024, 4 heads of 96) and 0.417 ms at (4096, 4 x 48), both far above
// the bytes (25 and 50 MB): bound by operations.
//
// Design: the normalized weights are rounded to T before the PV product (the
// TPU kernel's rounding site), and a one-pass online softmax would round
// weights normalized by a running, not the final, sum. So each block, one
// per (sample, head, tile of 32 query rows), makes two passes over 64-row key
// tiles: (1) the row max and sum, each thread keeping an online (max, sum)
// pair over its own keys, merged across threads at the end; (2) the rounded
// weights into shared memory and acc += w v in registers. Only q, k, v, o and
// the statistics cross device memory; shared memory is bounded by the tiles
// (173.1 KB at hd = 256). Values are kept as fp32 in shared memory, so a
// product of bf16 values is exact and only the order of sums differs from the
// plain version (the scaled logit is rounded before the max is subtracted, as
// there: __fmul_rn keeps nvcc from contracting the two into one FMA). This
// first version multiplies on the CUDA cores and computes
// q k^T twice; tensor cores (mma/wgmma), TMA and keeping the statistics from
// one pass are later work.

#include <math.h>

#include "cosine_attention_common.cuh"

namespace {

using namespace cosine_attention;

constexpr int kRowsQ = 32;  // query rows per block
constexpr int kRowsK = 64;  // key/value rows per tile
constexpr int kLogitRows = kRowsQ * kRowsK / kThreads;  // logits per thread per tile
constexpr int kLogitStep = kThreads / kRowsK;           // row step between them
static_assert(kLogitRows * kLogitStep == kRowsQ, "logit tiling");

// (m, s) <- the merge of two online (max, sum of exp(x - max)) pairs
__device__ __forceinline__ void merge_stats(float& m, float& s, float m2, float s2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;  // both empty
  s = s * expf(m - mm) + s2 * expf(m2 - mm);
  m = mm;
}

// HDMAX: the head-dim bucket (32, 64, 128 or 256) that fixes how many output
// channels each thread accumulates in registers; channels hd..HDMAX-1 idle.
template <typename T, int HDMAX>
__global__ void __launch_bounds__(kThreads)
    flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ out,
                               float* __restrict__ stats, int b_total, int n, int heads, int hd,
                               long long sb, long long sn, float scale) {
  constexpr int kPer = kRowsQ * HDMAX / kThreads;  // outputs per thread
  constexpr int kRowStep = kThreads / HDMAX;       // row step between them
  static_assert(kPer * kRowStep == kRowsQ, "output tiling");

  extern __shared__ float smem[];
  const int ks = hd + 1;  // padded k/v row stride: a warp reading one column hits 32 banks
  float* q_s = smem;                     // kRowsQ x hd
  float* k_s = q_s + kRowsQ * hd;        // kRowsK x ks
  float* v_s = k_s + kRowsK * ks;        // kRowsK x ks
  float* p_s = v_s + kRowsK * ks;        // kRowsQ x kRowsK: T(weights)
  float* m_s = p_s + kRowsQ * kRowsK;    // 2 x kRowsQ partial row maxima
  float* s_s = m_s + 2 * kRowsQ;         // 2 x kRowsQ partial row sums

  const int n_qt = (n + kRowsQ - 1) / kRowsQ;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int h = bh % heads;
  const int b = bh / heads;
  const size_t head0 = (size_t)b * sb + (size_t)h * hd;
  const T* qb = q + head0;
  const T* kb = k + head0;
  const T* vb = v + head0;
  const int q0 = qt * kRowsQ;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int lj = tid % kRowsK;   // logits: this thread's key within the tile
  const int li0 = tid / kRowsK;  //         and its first query row
  const int pd = tid % HDMAX;    // output: this thread's channel
  const int pi0 = tid / HDMAX;   //         and its first query row

  load_rows<T>(qb, n, q0, kRowsQ, sn, 0, hd, q_s, hd);

  // pass 1: row max and sum over this thread's keys
  float m[kLogitRows], s[kLogitRows];
#pragma unroll
  for (int r = 0; r < kLogitRows; ++r) {
    m[r] = -INFINITY;
    s[r] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += kRowsK) {
    __syncthreads();  // the previous tile's k_s is consumed (and q_s is loaded)
    load_rows<T>(kb, n, k0, kRowsK, sn, 0, hd, k_s, ks);
    __syncthreads();
    if (k0 + lj < n) {
      float l[kLogitRows];
#pragma unroll
      for (int r = 0; r < kLogitRows; ++r) l[r] = 0.f;
      const float* krow = k_s + lj * ks;
      for (int d = 0; d < hd; ++d) {
        const float kv = krow[d];
#pragma unroll
        for (int r = 0; r < kLogitRows; ++r) l[r] += q_s[(li0 + kLogitStep * r) * hd + d] * kv;
      }
#pragma unroll
      for (int r = 0; r < kLogitRows; ++r) merge_stats(m[r], s[r], __fmul_rn(l[r], scale), 1.f);
    }
  }
  // a warp holds 32 of a tile's keys for its rows; the two warps that share
  // rows (keys 0-31 and 32-63) meet in shared memory
#pragma unroll
  for (int r = 0; r < kLogitRows; ++r) {
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s[r], o);
      merge_stats(m[r], s[r], m2, s2);
    }
  }
  if (lane == 0) {
    const int half = (tid / 32) & 1;
#pragma unroll
    for (int r = 0; r < kLogitRows; ++r) {
      m_s[half * kRowsQ + li0 + kLogitStep * r] = m[r];
      s_s[half * kRowsQ + li0 + kLogitStep * r] = s[r];
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kLogitRows; ++r) {
    const int i = li0 + kLogitStep * r;
    m[r] = m_s[i];
    s[r] = s_s[i];
    merge_stats(m[r], s[r], m_s[kRowsQ + i], s_s[kRowsQ + i]);
  }
  if (lj == 0) {  // one thread per row writes the row's statistics
#pragma unroll
    for (int r = 0; r < kLogitRows; ++r) {
      const int row = q0 + li0 + kLogitStep * r;
      if (row < n) {
        const size_t at = (size_t)bh * n + row;
        stats[at] = m[r];
        stats[(size_t)b_total * heads * n + at] = s[r];
      }
    }
  }

  // pass 2: o = T(w) v with w = exp(L - m) / s
  float acc[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < n; k0 += kRowsK) {
    __syncthreads();  // the previous tile's k_s, v_s and p_s are consumed
    load_rows<T>(kb, n, k0, kRowsK, sn, 0, hd, k_s, ks);
    load_rows<T>(vb, n, k0, kRowsK, sn, 0, hd, v_s, ks);
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
      const float w = valid ? round_to<T>(expf(__fmul_rn(l[r], scale) - m[r]) / s[r]) : 0.f;
      p_s[(li0 + kLogitStep * r) * kRowsK + lj] = w;
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

  if (pd < hd) {
    const int C = heads * hd;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int row = q0 + pi0 + kRowStep * r;
      if (row < n) out[((size_t)b * n + row) * C + h * hd + pd] = from_float<T>(acc[r]);
    }
  }
}

template <typename T, int HDMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* stats, int b,
                   int n, int heads, int hd, long long sb, long long sn, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kRowsQ * hd + 2 * (size_t)kRowsK * (hd + 1) +
                                       kRowsQ * kRowsK + 4 * kRowsQ);
  auto kernel = flash_attention_fwd_kernel<T, HDMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)b * heads * ((n + kRowsQ - 1) / kRowsQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), stats, b, n, heads, hd, sb, sn, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, float* stats, int b,
                     int n, int heads, int hd, long long sb, long long sn, float scale,
                     cudaStream_t stream) {
  if (hd <= 32) return launch<T, 32>(q, k, v, out, stats, b, n, heads, hd, sb, sn, scale, stream);
  if (hd <= 64) return launch<T, 64>(q, k, v, out, stats, b, n, heads, hd, sb, sn, scale, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, out, stats, b, n, heads, hd, sb, sn, scale, stream);
  return launch<T, 256>(q, k, v, out, stats, b, n, heads, hd, sb, sn, scale, stream);
}

}  // namespace

// q, k, v: (b, n, heads, hd) of one type (bf16 when is_bf16, else fp32), each
// with unit stride over hd, stride hd over heads, and the shared token stride
// sn and sample stride sb (in elements): contiguous tensors, or the q, k, v
// views of one (b, n, 3, heads, hd) tensor. out: (b, n, heads, hd)
// contiguous; stats: fp32 (2, b, heads, n), the row max then the row sum.
// scale = fp32(1/sqrt(hd)). Launches on `stream` without synchronizing;
// returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* stats, int b, int n, int heads, int hd, long long sb,
                                   long long sn, int is_bf16, float scale, void* stream) {
  if (b < 1 || n < 1 || heads < 1 || hd < 1 || hd > 256) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(q, k, v, out, st, b, n, heads, hd, sb, sn, scale, s);
  return (int)dispatch<float>(q, k, v, out, st, b, n, heads, hd, sb, sn, scale, s);
}
