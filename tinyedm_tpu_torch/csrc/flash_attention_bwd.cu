// Flash attention, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel tinyedm_tpu/ops/attention.py::_attn_bwd_kernel
// (:144, reached through the pallas_call at :229 in _flash_bwd_impl). That
// kernel adds each q-block's dk and dv into one output block across a grid
// that runs in order (:197-205), which has no counterpart on CUDA, where
// blocks run in parallel and in no order.
//
// Function, per (sample, head), on q, k, v and the output cotangent g, all
// (b, n, heads, hd) of one type T, and the forward's row statistics m and s
// (fp32 (2, b, heads, n)); scale = fp32(1/sqrt(hd)); everything in fp32 from
// T values, nothing rounded until the end:
//   p  = exp((q k^T) * scale - m) / s
//   dp = g v^T,  delta = rowsum(dp * p)            (= g . (p v), the unrounded output)
//   ds = p (dp - delta) * scale
//   dq = T(ds k),  dk = T(sum over queries of ds^T q),  dv = T(sum of p^T g)
// dq, dk, dv (b, n, heads, hd) contiguous.
//
// What bounds it on an H100 SXM: it reads q, k, v, g and writes dq, dk, dv,
// 7 b n heads hd sizeof(T) bytes, against 10 b heads n^2 hd FLOP: at the
// ImageNet-512 widths (b = 32, bf16) 0.130 ms of tensor-core time at
// (n = 1024, 4 heads of 96) and 1.042 ms at (4096, 4 x 48), far above the
// bytes: bound by operations.
//
// Design: dq sums over every key, dk and dv over every query. Rather than
// fp32 atomics (whose order, and so whose result, changes from run to run),
// two deterministic launches, back to back:
//   (a) one block per (sample, head, tile of 32 query rows) streams 64-row
//       key/value tiles twice: first for delta (it needs the whole row of p),
//       then for ds and dq = ds k; it writes dq and delta, fp32 (b, heads, n);
//   (b) one block per (sample, head, tile of 32 key rows) streams 64-row
//       query tiles, recomputes p and ds from m, s and delta, and sums
//       dk = ds^T q and dv = p^T g over all queries in registers.
// p is recomputed from the forward's statistics rather than stored (n^2
// values per head). Values are kept as fp32 in shared memory, so a product of
// bf16 values is exact and only the order of sums differs from the plain
// version.
// Shared memory is bounded by the tiles: 205.7 KB for (a) and 214.3 KB for
// (b) at hd = 256. This first version multiplies on the CUDA cores and
// recomputes q k^T and g v^T three times in all; tensor cores (mma/wgmma),
// TMA and fewer passes are later work.

#include "cosine_attention_common.cuh"

namespace {

using namespace cosine_attention;

constexpr int kOwn = 32;     // rows a block owns: queries in (a), keys in (b)
constexpr int kStream = 64;  // rows per streamed tile: keys in (a), queries in (b)
constexpr int kPairs = kOwn * kStream / kThreads;  // (own, streamed) pairs per thread per tile
constexpr int kPairStep = kThreads / kStream;      // own-row step between them
static_assert(kPairs * kPairStep == kOwn, "pair tiling");

// Pass (a): dq, and delta for pass (b).
// HDMAX: the head-dim bucket (32, 64, 128 or 256) that fixes how many output
// channels each thread accumulates in registers; channels hd..HDMAX-1 idle.
template <typename T, int HDMAX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ gout,
                        const float* __restrict__ stats, T* __restrict__ dq,
                        float* __restrict__ delta_out, int b_total, int n, int heads, int hd,
                        long long sb, long long sn, float scale) {
  constexpr int kPer = kOwn * HDMAX / kThreads;  // outputs per thread
  constexpr int kRowStep = kThreads / HDMAX;     // row step between them
  static_assert(kPer * kRowStep == kOwn, "output tiling");

  extern __shared__ float smem[];
  const int ks = hd + 1;  // padded streamed-row stride: a warp reading one column hits 32 banks
  float* q_s = smem;                      // kOwn x hd
  float* g_s = q_s + kOwn * hd;           // kOwn x hd
  float* k_s = g_s + kOwn * hd;           // kStream x ks
  float* v_s = k_s + kStream * ks;        // kStream x ks
  float* ds_s = v_s + kStream * ks;       // kOwn x kStream
  float* part_s = ds_s + kOwn * kStream;  // 2 x kOwn partial row sums of dp * p
  float* delta_s = part_s + 2 * kOwn;     // kOwn

  const int n_tiles = (n + kOwn - 1) / kOwn;
  const int tile = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int h = bh % heads;
  const int b = bh / heads;
  const int C = heads * hd;
  const size_t head0 = (size_t)b * sb + (size_t)h * hd;
  const T* kb = k + head0;
  const T* vb = v + head0;
  const T* gb = gout + (size_t)b * n * C + (size_t)h * hd;
  const int q0 = tile * kOwn;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int lj = tid % kStream;   // pairs: this thread's key within the tile
  const int li0 = tid / kStream;  //        and its first query row
  const int pd = tid % HDMAX;     // output: this thread's channel
  const int pi0 = tid / HDMAX;    //         and its first query row

  load_rows<T>(q + head0, n, q0, kOwn, sn, 0, hd, q_s, hd);
  load_rows<T>(gb, n, q0, kOwn, C, 0, hd, g_s, hd);
  float rm[kPairs], rs[kPairs];  // the rows' max and sum
#pragma unroll
  for (int r = 0; r < kPairs; ++r) {
    const int row = q0 + li0 + kPairStep * r;
    const size_t at = (size_t)bh * n + row;
    rm[r] = row < n ? stats[at] : 0.f;
    rs[r] = row < n ? stats[(size_t)b_total * heads * n + at] : 1.f;
  }

  // p and dp of this thread's pairs in the key tile at k0 (k_s, v_s loaded)
  auto pairs = [&](int k0, float* p, float* dp) {
    float l[kPairs];
#pragma unroll
    for (int r = 0; r < kPairs; ++r) l[r] = dp[r] = 0.f;
    const float* krow = k_s + lj * ks;
    const float* vrow = v_s + lj * ks;
    for (int d = 0; d < hd; ++d) {
      const float kv = krow[d], vv = vrow[d];
#pragma unroll
      for (int r = 0; r < kPairs; ++r) {
        const int i = li0 + kPairStep * r;
        l[r] += q_s[i * hd + d] * kv;
        dp[r] += g_s[i * hd + d] * vv;
      }
    }
    const bool valid = k0 + lj < n;
#pragma unroll
    for (int r = 0; r < kPairs; ++r)
      p[r] = valid ? expf(__fmul_rn(l[r], scale) - rm[r]) / rs[r] : 0.f;
  };

  // sweep 1: delta = rowsum(dp * p)
  float dsum[kPairs];
#pragma unroll
  for (int r = 0; r < kPairs; ++r) dsum[r] = 0.f;
  for (int k0 = 0; k0 < n; k0 += kStream) {
    __syncthreads();  // the previous tile's k_s and v_s are consumed
    load_rows<T>(kb, n, k0, kStream, sn, 0, hd, k_s, ks);
    load_rows<T>(vb, n, k0, kStream, sn, 0, hd, v_s, ks);
    __syncthreads();
    float p[kPairs], dp[kPairs];
    pairs(k0, p, dp);
#pragma unroll
    for (int r = 0; r < kPairs; ++r) dsum[r] += dp[r] * p[r];
  }
  // a warp holds 32 of a tile's keys for its rows; the two warps that share
  // rows (keys 0-31 and 32-63) meet in shared memory
#pragma unroll
  for (int r = 0; r < kPairs; ++r) {
    for (int o = 16; o > 0; o >>= 1) dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], o);
  }
  if (lane == 0) {
    const int half = warp & 1;
#pragma unroll
    for (int r = 0; r < kPairs; ++r) part_s[half * kOwn + li0 + kPairStep * r] = dsum[r];
  }
  __syncthreads();
  if (tid < kOwn) {
    delta_s[tid] = part_s[tid] + part_s[kOwn + tid];
    if (q0 + tid < n) delta_out[(size_t)bh * n + q0 + tid] = delta_s[tid];
  }

  // sweep 2: ds = p (dp - delta) * scale, dq = ds k
  float acc[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < n; k0 += kStream) {
    __syncthreads();  // the previous tile's k_s, v_s and ds_s are consumed (delta_s is set)
    load_rows<T>(kb, n, k0, kStream, sn, 0, hd, k_s, ks);
    load_rows<T>(vb, n, k0, kStream, sn, 0, hd, v_s, ks);
    __syncthreads();
    float p[kPairs], dp[kPairs];
    pairs(k0, p, dp);
#pragma unroll
    for (int r = 0; r < kPairs; ++r) {
      const int i = li0 + kPairStep * r;
      ds_s[i * kStream + lj] = p[r] * (dp[r] - delta_s[i]) * scale;
    }
    __syncthreads();
    if (pd < hd) {
      const int kn = min(kStream, n - k0);
      for (int j = 0; j < kn; ++j) {
        const float kv = k_s[j * ks + pd];
#pragma unroll
        for (int r = 0; r < kPer; ++r) acc[r] += ds_s[(pi0 + kRowStep * r) * kStream + j] * kv;
      }
    }
  }
  if (pd < hd) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int row = q0 + pi0 + kRowStep * r;
      if (row < n) dq[((size_t)b * n + row) * C + h * hd + pd] = from_float<T>(acc[r]);
    }
  }
}

// Pass (b): dk and dv from m, s and delta.
template <typename T, int HDMAX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ gout,
                         const float* __restrict__ stats, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int b_total, int n, int heads,
                         int hd, long long sb, long long sn, float scale) {
  constexpr int kPer = kOwn * HDMAX / kThreads;
  constexpr int kRowStep = kThreads / HDMAX;
  static_assert(kPer * kRowStep == kOwn, "output tiling");

  extern __shared__ float smem[];
  const int ks = hd + 1;
  float* k_s = smem;                    // kOwn x hd (read as a broadcast)
  float* v_s = k_s + kOwn * hd;         // kOwn x hd
  float* q_s = v_s + kOwn * hd;         // kStream x ks
  float* g_s = q_s + kStream * ks;      // kStream x ks
  float* p_s = g_s + kStream * ks;      // kOwn x kStream, key-major
  float* ds_s = p_s + kOwn * kStream;   // kOwn x kStream, key-major
  float* m_s = ds_s + kOwn * kStream;   // kStream
  float* s_s = m_s + kStream;           // kStream
  float* delta_s = s_s + kStream;       // kStream

  const int n_tiles = (n + kOwn - 1) / kOwn;
  const int tile = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int h = bh % heads;
  const int b = bh / heads;
  const int C = heads * hd;
  const size_t head0 = (size_t)b * sb + (size_t)h * hd;
  const T* qb = q + head0;
  const T* gb = gout + (size_t)b * n * C + (size_t)h * hd;
  const float* m_g = stats + (size_t)bh * n;
  const float* s_g = stats + (size_t)b_total * heads * n + (size_t)bh * n;
  const float* delta_g = delta + (size_t)bh * n;
  const int k0 = tile * kOwn;

  const int tid = threadIdx.x;
  const int li = tid % kStream;   // pairs: this thread's query within the tile
  const int lj0 = tid / kStream;  //        and its first key row
  const int pd = tid % HDMAX;     // output: this thread's channel
  const int pj0 = tid / HDMAX;    //         and its first key row

  load_rows<T>(k + head0, n, k0, kOwn, sn, 0, hd, k_s, hd);
  load_rows<T>(v + head0, n, k0, kOwn, sn, 0, hd, v_s, hd);

  float acc_k[kPer], acc_v[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) acc_k[r] = acc_v[r] = 0.f;

  for (int q0 = 0; q0 < n; q0 += kStream) {
    __syncthreads();  // the previous tile's q_s, g_s, p_s and ds_s are consumed
    load_rows<T>(qb, n, q0, kStream, sn, 0, hd, q_s, ks);
    load_rows<T>(gb, n, q0, kStream, C, 0, hd, g_s, ks);
    if (tid < kStream) {
      const bool in = q0 + tid < n;
      m_s[tid] = in ? m_g[q0 + tid] : 0.f;
      s_s[tid] = in ? s_g[q0 + tid] : 1.f;
      delta_s[tid] = in ? delta_g[q0 + tid] : 0.f;
    }
    __syncthreads();

    float l[kPairs], dp[kPairs];
#pragma unroll
    for (int r = 0; r < kPairs; ++r) l[r] = dp[r] = 0.f;
    const float* qrow = q_s + li * ks;
    const float* grow = g_s + li * ks;
    for (int d = 0; d < hd; ++d) {
      const float qv = qrow[d], gv = grow[d];
#pragma unroll
      for (int r = 0; r < kPairs; ++r) {
        const int j = lj0 + kPairStep * r;
        l[r] += qv * k_s[j * hd + d];
        dp[r] += gv * v_s[j * hd + d];
      }
    }
    const bool valid = q0 + li < n;
#pragma unroll
    for (int r = 0; r < kPairs; ++r) {
      const int j = lj0 + kPairStep * r;
      const float p = valid ? expf(__fmul_rn(l[r], scale) - m_s[li]) / s_s[li] : 0.f;
      p_s[j * kStream + li] = p;
      ds_s[j * kStream + li] = p * (dp[r] - delta_s[li]) * scale;
    }
    __syncthreads();

    if (pd < hd) {
      const int qn = min(kStream, n - q0);
      for (int i = 0; i < qn; ++i) {
        const float qv = q_s[i * ks + pd], gv = g_s[i * ks + pd];
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          const int j = pj0 + kRowStep * r;
          acc_k[r] += ds_s[j * kStream + i] * qv;
          acc_v[r] += p_s[j * kStream + i] * gv;
        }
      }
    }
  }

  if (pd < hd) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int row = k0 + pj0 + kRowStep * r;
      if (row < n) {
        const size_t at = ((size_t)b * n + row) * C + h * hd + pd;
        dk[at] = from_float<T>(acc_k[r]);
        dv[at] = from_float<T>(acc_v[r]);
      }
    }
  }
}

template <typename T, int HDMAX>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g, const float* stats,
                   float* delta, void* dq, void* dk, void* dv, int b, int n, int heads, int hd,
                   long long sb, long long sn, float scale, cudaStream_t stream) {
  const size_t ks = hd + 1;
  const size_t smem_dq =
      sizeof(float) * (2 * kOwn * (size_t)hd + 2 * kStream * ks + kOwn * kStream + 3 * kOwn);
  const size_t smem_dkv =
      sizeof(float) * (2 * kOwn * (size_t)hd + 2 * kStream * ks + 2 * kOwn * kStream + 3 * kStream);
  auto dq_kernel = flash_bwd_dq_kernel<T, HDMAX>;
  auto dkv_kernel = flash_bwd_dkv_kernel<T, HDMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkv);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)b * heads * ((n + kOwn - 1) / kOwn);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const T* q_t = static_cast<const T*>(q);
  const T* k_t = static_cast<const T*>(k);
  const T* v_t = static_cast<const T*>(v);
  const T* g_t = static_cast<const T*>(g);
  dq_kernel<<<(unsigned)blocks, kThreads, smem_dq, stream>>>(
      q_t, k_t, v_t, g_t, stats, static_cast<T*>(dq), delta, b, n, heads, hd, sb, sn, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<(unsigned)blocks, kThreads, smem_dkv, stream>>>(
      q_t, k_t, v_t, g_t, stats, delta, static_cast<T*>(dk), static_cast<T*>(dv), b, n, heads,
      hd, sb, sn, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* g, const float* stats,
                     float* delta, void* dq, void* dk, void* dv, int b, int n, int heads, int hd,
                     long long sb, long long sn, float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, g, stats, delta, dq, dk, dv, b, n, heads, hd, sb, sn, scale,
                         stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, g, stats, delta, dq, dk, dv, b, n, heads, hd, sb, sn, scale,
                         stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, g, stats, delta, dq, dk, dv, b, n, heads, hd, sb, sn, scale,
                          stream);
  return launch<T, 256>(q, k, v, g, stats, delta, dq, dk, dv, b, n, heads, hd, sb, sn, scale,
                        stream);
}

}  // namespace

// q, k, v: (b, n, heads, hd) with the layout flash_attention_fwd takes (unit
// stride over hd, stride hd over heads, shared token stride sn and sample
// stride sb); g, dq, dk, dv: (b, n, heads, hd) contiguous; all of one type,
// bf16 when is_bf16, else fp32. stats: the forward's fp32 (2, b, heads, n);
// delta: fp32 scratch of b * heads * n. scale = fp32(1/sqrt(hd)). Launches
// both passes on `stream` without synchronizing; returns the cudaError_t of
// the launches (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                   const void* stats, void* delta, void* dq, void* dk, void* dv,
                                   int b, int n, int heads, int hd, long long sb, long long sn,
                                   int is_bf16, float scale, void* stream) {
  if (b < 1 || n < 1 || heads < 1 || hd < 1 || hd > 256) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(stats);
  float* dl = static_cast<float*>(delta);
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(q, k, v, g, st, dl, dq, dk, dv, b, n, heads, hd, sb, sn,
                                        scale, s);
  return (int)dispatch<float>(q, k, v, g, st, dl, dq, dk, dv, b, n, heads, hd, sb, sn, scale, s);
}
