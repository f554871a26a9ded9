// Fused pixel-norm + cosine attention, backward, for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package, which compute one function:
//   tinyedm_tpu/ops/fused_attention.py::_attn_bwd_kernel (:144), per head,
//     the CIFAR-10 path's n = 256 (16x16) layers;
//   tinyedm_tpu/ops/fused_attention.py::_attn_bwd_kernel_pair (:305), head
//     pairs laid out block-diagonally for the TPU's 128-wide matrix unit, the
//     n = 64 (8x8) layers. Its scratch, zeroed at program_id 0 and reused
//     across an in-order grid, has no counterpart: CUDA blocks run in no
//     order, and each block here starts from its own zeros.
//
// Function, per (sample, head), on qkv (b, n, 3C) with channels (3, heads,
// hd), the output cotangent g and the forward's output o, both (b, n, C) with
// channels (heads, hd), all of one type T; c = fp32(1/sqrt(hd)):
//   x^ = T(x / T(D)), D = eps + |x|/sqrt(hd)   for q, k, v (fp32 norm s)
//   E  = exp(c q^ k^T), rc = c / rowsum(E), delta = rowsum(g o)      (fp32)
//   ds = T(E (g v^T - delta))
//   dq^ = (ds k^) rc,  dk^ = ds^T T(q^ rc),  dv^ = T(E)^T T(g rc sqrt(hd))
//   dx = T(dx^/D - x sum(dx^ x) / (D D max(s, 1e-30) / c))   for q, k, v
// with fp32 products of T-rounded operands and fp32 sums throughout, and the
// pixel-norm VJP taken with the UNROUNDED fp32 divisor D, as the JAX kernel.
//
// What bounds it on an H100 SXM: the JAX kernel's cost estimate counts bytes
// 8 b n C * sizeof(T) (read qkv, g, o; write d(qkv)) and 10 b heads n^2 hd
// FLOPs: at the CIFAR-10 training batch of 256 in bf16, 268 MB against
// 42.9 GFLOP at n = 256 (0.080 ms at 3.35 TB/s against 0.043 ms at
// 989 TFLOP/s) and 67 MB at n = 64 (0.020 ms): memory-bound on paper.
//
// Design: dk and dv sum over every query, dq over every key. Rather than
// fp32 atomics (whose order, and so whose result, changes from run to run),
// two deterministic passes, launched back to back:
//   (a) one block per (sample, head, tile of 32 query rows) streams key/value
//       tiles of 64 rows through shared memory: row sums of E, delta, and the
//       unscaled dq^ sum over keys (ds needs delta but not rc, so one pass
//       suffices); it multiplies by rc at the end, applies the pixel-norm VJP
//       to the tile's q rows and writes rc and delta to a small fp32
//       (2, b, heads, n) buffer;
//   (b) one block per (sample, head, tile of 32 key rows) streams query tiles
//       of 64 rows, recomputes E bit for bit as (a) did (same products in the
//       same order), reads rc and delta, and sums dk^ and dv^ over queries;
//       then the pixel-norm VJP of the tile's k and v rows.
// Rounded values are kept as fp32 in shared memory, so every product is
// exact and only the sums' order differs from the plain version. No max is
// subtracted before the exp: |logits| <= c. Shared memory is bounded by the
// tile sizes: 205.7 KB for (a) and 214.0 KB for (b) at hd = 256. This first
// version multiplies on the CUDA cores in fp32 and recomputes E and g v^T in
// both passes; tensor cores (mma/wgmma), TMA and fusing the passes are later
// work.

#include "cosine_attention_common.cuh"

namespace {

using namespace cosine_attention;

constexpr int kOwn = 32;     // rows a block owns: queries in (a), keys in (b)
constexpr int kStream = 64;  // rows per streamed tile: keys in (a), queries in (b)
constexpr int kPairs = kOwn * kStream / kThreads;  // (own, streamed) pairs per thread per tile
constexpr int kPairStep = kThreads / kStream;      // own-row step between them
static_assert(kPairs * kPairStep == kOwn, "pair tiling");

// The pixel-norm VJP of rows [row0, row0 + rows) of one head's channels at
// `col` of the (n, c3) slab: recomputes the fp32 norm s and divisor D of each
// row of x, takes gy (fp32, row stride gy_stride) and writes T(dx) to the same
// place in dslab. One warp per row; sums in load_normalized's order.
template <typename T>
__device__ void pixel_norm_vjp_rows(const T* __restrict__ slab, T* __restrict__ dslab, int n,
                                    int row0, int rows, int c3, int col, int hd,
                                    float inv_sqrt_hd, const float* __restrict__ gy,
                                    int gy_stride) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kThreads / 32) {
    const int row = row0 + r;
    if (row >= n) continue;
    const T* src = slab + (size_t)row * c3 + col;
    const float* g = gy + r * gy_stride;
    float ss = 0.f, inner = 0.f;
    for (int c = lane; c < hd; c += 32) {
      const float x = to_float(src[c]);
      ss += x * x;
      inner += g[c] * x;
    }
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      inner += __shfl_xor_sync(0xffffffffu, inner, o);
    }
    const float s = sqrtf(ss);
    const float d = kEps + s * inv_sqrt_hd;
    const float k = inner / (d * d * fmaxf(s, 1e-30f) / inv_sqrt_hd);
    T* dst = dslab + (size_t)row * c3 + col;
    for (int c = lane; c < hd; c += 32) dst[c] = from_float<T>(g[c] / d - to_float(src[c]) * k);
  }
}

// Pass (a): dq, and the per-row rc and delta that pass (b) reads.
// HDMAX: the head-dim bucket (32, 64, 128 or 256) that fixes how many output
// channels each thread accumulates in registers; channels hd..HDMAX-1 idle.
template <typename T, int HDMAX>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ gout,
                       const T* __restrict__ out, T* __restrict__ dqkv, float* __restrict__ stats,
                       int b_total, int n, int heads, int hd, float scale) {
  constexpr int kPer = kOwn * HDMAX / kThreads;  // outputs per thread
  constexpr int kRowStep = kThreads / HDMAX;     // row step between them
  static_assert(kPer * kRowStep == kOwn, "output tiling");

  extern __shared__ float smem[];
  const int ks = hd + 1;  // padded streamed-row stride: a warp reading one column hits 32 banks
  float* q_s = smem;                      // kOwn x hd: q^, later dq^
  float* g_s = q_s + kOwn * hd;           // kOwn x hd: g
  float* k_s = g_s + kOwn * hd;           // kStream x ks: k^
  float* v_s = k_s + kStream * ks;        // kStream x ks: v^
  float* ds_s = v_s + kStream * ks;       // kOwn x kStream: ds
  float* sum_s = ds_s + kOwn * kStream;   // 2 x kOwn partial row sums
  float* delta_s = sum_s + 2 * kOwn;      // kOwn

  const int n_tiles = (n + kOwn - 1) / kOwn;
  const int tile = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int h = bh % heads;
  const int b = bh / heads;
  const int C = heads * hd;
  const int c3 = 3 * C;
  const T* slab = qkv + (size_t)b * n * c3;
  const T* g_slab = gout + (size_t)b * n * C;
  const T* o_slab = out + (size_t)b * n * C;
  const int q0 = tile * kOwn;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int lj = tid % kStream;   // pairs: this thread's key within the tile
  const int li0 = tid / kStream;  //        and its first query row
  const int pd = tid % HDMAX;     // output: this thread's channel
  const int pi0 = tid / HDMAX;    //         and its first query row

  load_normalized<T>(slab, n, q0, kOwn, c3, h * hd, hd, scale, q_s, hd);
  load_rows<T>(g_slab, n, q0, kOwn, C, h * hd, hd, g_s, hd);
  for (int r = warp; r < kOwn; r += kThreads / 32) {  // delta = rowsum(g o), fp32
    const int row = q0 + r;
    float go = 0.f;
    if (row < n) {
      const T* grow = g_slab + (size_t)row * C + h * hd;
      const T* orow = o_slab + (size_t)row * C + h * hd;
      for (int c = lane; c < hd; c += 32) go += to_float(grow[c]) * to_float(orow[c]);
    }
    for (int o = 16; o > 0; o >>= 1) go += __shfl_xor_sync(0xffffffffu, go, o);
    if (lane == 0) delta_s[r] = go;
  }

  float acc[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) acc[r] = 0.f;
  float rsum[kPairs];
#pragma unroll
  for (int r = 0; r < kPairs; ++r) rsum[r] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kStream) {
    __syncthreads();  // the previous tile's k_s, v_s and ds_s are consumed
    load_normalized<T>(slab, n, k0, kStream, c3, C + h * hd, hd, scale, k_s, ks);
    load_normalized<T>(slab, n, k0, kStream, c3, 2 * C + h * hd, hd, scale, v_s, ks);
    __syncthreads();

    float l[kPairs], dp[kPairs];
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
    for (int r = 0; r < kPairs; ++r) {
      const int i = li0 + kPairStep * r;
      const float e = valid ? expf(l[r] * scale) : 0.f;
      rsum[r] += e;
      ds_s[i * kStream + lj] = round_to<T>(e * (dp[r] - delta_s[i]));
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

  // row sums: a warp holds 32 of a tile's keys for its rows; the two warps
  // that share rows (keys 0-31 and 32-63) meet in shared memory
#pragma unroll
  for (int r = 0; r < kPairs; ++r) {
    for (int o = 16; o > 0; o >>= 1) rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], o);
  }
  if (lane == 0) {
    const int half = warp & 1;
#pragma unroll
    for (int r = 0; r < kPairs; ++r) sum_s[half * kOwn + li0 + kPairStep * r] = rsum[r];
  }
  __syncthreads();  // also: every thread is done reading q_s

  if (pd < hd) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = pi0 + kRowStep * r;
      q_s[i * hd + pd] = acc[r] * (scale / (sum_s[i] + sum_s[kOwn + i]));
    }
  }
  if (tid < kOwn && q0 + tid < n) {
    const size_t at = (size_t)bh * n + q0 + tid;
    stats[at] = scale / (sum_s[tid] + sum_s[kOwn + tid]);
    stats[(size_t)b_total * heads * n + at] = delta_s[tid];
  }
  __syncthreads();
  pixel_norm_vjp_rows<T>(slab, dqkv + (size_t)b * n * c3, n, q0, kOwn, c3, h * hd, hd, scale,
                         q_s, hd);
}

// Pass (b): dk and dv from the rc and delta of pass (a).
template <typename T, int HDMAX>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ gout,
                        const float* __restrict__ stats, T* __restrict__ dqkv, int b_total, int n,
                        int heads, int hd, float scale, float sqrt_hd) {
  constexpr int kPer = kOwn * HDMAX / kThreads;
  constexpr int kRowStep = kThreads / HDMAX;
  static_assert(kPer * kRowStep == kOwn, "output tiling");

  extern __shared__ float smem[];
  const int ks = hd + 1;
  float* k_s = smem;                       // kOwn x hd: k^ (read as a broadcast)
  float* v_s = k_s + kOwn * hd;            // kOwn x hd: v^
  float* a_s = v_s + kOwn * hd;            // kStream x ks: q^, then T(q^ rc); at the end dk^
  float* b_s = a_s + kStream * ks;         // kStream x ks: g, then T(g rc sqrt(hd)); at the end dv^
  float* e_s = b_s + kStream * ks;         // kOwn x kStream: T(E), key-major
  float* ds_s = e_s + kOwn * kStream;      // kOwn x kStream: ds, key-major
  float* rc_s = ds_s + kOwn * kStream;     // kStream
  float* delta_s = rc_s + kStream;         // kStream

  const int n_tiles = (n + kOwn - 1) / kOwn;
  const int tile = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int h = bh % heads;
  const int b = bh / heads;
  const int C = heads * hd;
  const int c3 = 3 * C;
  const T* slab = qkv + (size_t)b * n * c3;
  const T* g_slab = gout + (size_t)b * n * C;
  const float* rc_g = stats + (size_t)bh * n;
  const float* delta_g = stats + (size_t)b_total * heads * n + (size_t)bh * n;
  const int k0 = tile * kOwn;

  const int tid = threadIdx.x;
  const int li = tid % kStream;   // pairs: this thread's query within the tile
  const int lj0 = tid / kStream;  //        and its first key row
  const int pd = tid % HDMAX;     // output: this thread's channel
  const int pj0 = tid / HDMAX;    //         and its first key row

  load_normalized<T>(slab, n, k0, kOwn, c3, C + h * hd, hd, scale, k_s, hd);
  load_normalized<T>(slab, n, k0, kOwn, c3, 2 * C + h * hd, hd, scale, v_s, hd);

  float acc_k[kPer], acc_v[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) acc_k[r] = acc_v[r] = 0.f;

  for (int q0 = 0; q0 < n; q0 += kStream) {
    __syncthreads();  // the previous tile's a_s, b_s, e_s and ds_s are consumed
    load_normalized<T>(slab, n, q0, kStream, c3, h * hd, hd, scale, a_s, ks);
    load_rows<T>(g_slab, n, q0, kStream, C, h * hd, hd, b_s, ks);
    if (tid < kStream) {
      const bool in = q0 + tid < n;
      rc_s[tid] = in ? rc_g[q0 + tid] : 0.f;
      delta_s[tid] = in ? delta_g[q0 + tid] : 0.f;
    }
    __syncthreads();

    // E and g v^T as pass (a) computes them: the same fp32 products summed
    // over d in the same order, so E matches (a)'s bit for bit
    float l[kPairs], dp[kPairs];
#pragma unroll
    for (int r = 0; r < kPairs; ++r) l[r] = dp[r] = 0.f;
    const float* qrow = a_s + li * ks;
    const float* grow = b_s + li * ks;
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
      const float e = valid ? expf(l[r] * scale) : 0.f;
      e_s[j * kStream + li] = round_to<T>(e);
      ds_s[j * kStream + li] = round_to<T>(e * (dp[r] - delta_s[li]));
    }
    __syncthreads();

    // the streamed rows' operands of the two sums, rounded as the JAX kernel
    for (int idx = tid; idx < kStream * hd; idx += kThreads) {
      const int i = idx / hd, c = idx % hd;
      a_s[i * ks + c] = round_to<T>(a_s[i * ks + c] * rc_s[i]);
      b_s[i * ks + c] = round_to<T>(b_s[i * ks + c] * (rc_s[i] * sqrt_hd));
    }
    __syncthreads();

    if (pd < hd) {
      const int qn = min(kStream, n - q0);
      for (int i = 0; i < qn; ++i) {
        const float av = a_s[i * ks + pd], bv = b_s[i * ks + pd];
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          const int j = pj0 + kRowStep * r;
          acc_k[r] += ds_s[j * kStream + i] * av;
          acc_v[r] += e_s[j * kStream + i] * bv;
        }
      }
    }
  }

  __syncthreads();  // every thread is done reading a_s and b_s
  if (pd < hd) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int j = pj0 + kRowStep * r;
      a_s[j * hd + pd] = acc_k[r];
      b_s[j * hd + pd] = acc_v[r];
    }
  }
  __syncthreads();
  T* dslab = dqkv + (size_t)b * n * c3;
  pixel_norm_vjp_rows<T>(slab, dslab, n, k0, kOwn, c3, C + h * hd, hd, scale, a_s, hd);
  pixel_norm_vjp_rows<T>(slab, dslab, n, k0, kOwn, c3, 2 * C + h * hd, hd, scale, b_s, hd);
}

template <typename T, int HDMAX>
cudaError_t launch(const void* qkv, const void* g, const void* o, void* dqkv, float* stats, int b,
                   int n, int heads, int hd, float scale, float sqrt_hd, cudaStream_t stream) {
  const size_t ks = hd + 1;
  const size_t smem_dq =
      sizeof(float) * (2 * kOwn * (size_t)hd + 2 * kStream * ks + kOwn * kStream + 3 * kOwn);
  const size_t smem_dkv =
      sizeof(float) * (2 * kOwn * (size_t)hd + 2 * kStream * ks + 2 * kOwn * kStream + 2 * kStream);
  auto dq_kernel = attn_bwd_dq_kernel<T, HDMAX>;
  auto dkv_kernel = attn_bwd_dkv_kernel<T, HDMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkv);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)b * heads * ((n + kOwn - 1) / kOwn);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const T* qkv_t = static_cast<const T*>(qkv);
  const T* g_t = static_cast<const T*>(g);
  T* dqkv_t = static_cast<T*>(dqkv);
  dq_kernel<<<(unsigned)blocks, kThreads, smem_dq, stream>>>(
      qkv_t, g_t, static_cast<const T*>(o), dqkv_t, stats, b, n, heads, hd, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<(unsigned)blocks, kThreads, smem_dkv, stream>>>(qkv_t, g_t, stats, dqkv_t, b, n,
                                                                 heads, hd, scale, sqrt_hd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* qkv, const void* g, const void* o, void* dqkv, float* stats, int b,
                     int n, int heads, int hd, float scale, float sqrt_hd, cudaStream_t stream) {
  if (hd <= 32) return launch<T, 32>(qkv, g, o, dqkv, stats, b, n, heads, hd, scale, sqrt_hd, stream);
  if (hd <= 64) return launch<T, 64>(qkv, g, o, dqkv, stats, b, n, heads, hd, scale, sqrt_hd, stream);
  if (hd <= 128)
    return launch<T, 128>(qkv, g, o, dqkv, stats, b, n, heads, hd, scale, sqrt_hd, stream);
  return launch<T, 256>(qkv, g, o, dqkv, stats, b, n, heads, hd, scale, sqrt_hd, stream);
}

}  // namespace

// qkv, dqkv: (b, n, 3 * heads * hd) contiguous; g, o: (b, n, heads * hd)
// contiguous; all of one type: bf16 when is_bf16, else fp32. stats: fp32
// scratch of 2 * b * heads * n (rc, then delta). scale = fp32(1/sqrt(hd)),
// sqrt_hd = fp32(sqrt(hd)). Launches both passes on `stream` without
// synchronizing; returns the cudaError_t of the launches (0 on success).
extern "C" int cosine_attention_bwd(const void* qkv, const void* g, const void* o, void* dqkv,
                                    void* stats, int b, int n, int heads, int hd, int is_bf16,
                                    float scale, float sqrt_hd, void* stream) {
  if (b < 1 || n < 1 || heads < 1 || hd < 1 || hd > 256) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(qkv, g, o, dqkv, st, b, n, heads, hd, scale, sqrt_hd, s);
  return (int)dispatch<float>(qkv, g, o, dqkv, st, b, n, heads, hd, scale, sqrt_hd, s);
}
