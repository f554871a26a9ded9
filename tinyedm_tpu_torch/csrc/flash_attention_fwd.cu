// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel tinyedm_tpu/ops/attention.py::_attn_kernel (:38,
// reached through the pallas_call at :99 in _flash_fwd_impl): the
// use_pallas_attention route of CosineAttention at n >= 1024 tokens. The TPU
// kernel pads n and hd to 128 and keeps a head's whole K and V in VMEM; here
// K/V stream through shared memory a tile at a time, keys at index >= n in
// the tail tile are masked, and hd is padded only in shared memory.
//
// Function, per (sample, head), on q, k, v (b, n, heads, hd) of one type T
// (already pixel-normed by the caller), output (b, n, heads, hd) contiguous:
//   L = (q k^T) * scale                 T operands, fp32 sums, scale = fp32(1/sqrt(hd))
//   m = rowmax(L),  s = rowsum(exp(L - m))                        (fp32)
//   o = T( T(exp(L - m) / s) v )        weights rounded to T before the PV
//                                       product, PV summed in fp32
// and the row statistics m and s, fp32 (2, b, heads, n), for the backward.
//
// What bounds it on an H100 SXM: the function reads q, k, v and writes o,
// 4 b n heads hd sizeof(T) bytes, against 4 b heads n^2 hd FLOP: at the
// ImageNet-512 widths (b = 32, bf16) 0.052 ms of tensor-core time at
// (n = 1024, 4 heads of 96) and 0.417 ms at (4096, 4 x 48), both far above
// the bytes (25 and 50 MB): bound by operations. The two passes below add a
// second q k^T (1.5x the products), and each logit costs an exp in both
// passes and a division in the second, on the CUDA cores and the special
// function units beside the tensor cores.
//
// Design: the normalized weights are rounded to T before the PV product (the
// TPU kernel's rounding site), and a one-pass online softmax would round
// weights normalized by a running, not the final, sum. So each block makes
// two passes over 64-key tiles: (1) the row max and sum, (2) the rounded
// weights and o += w v.
//
// bf16 (tensor cores): a block of 4 warps owns 64 query rows, 16 per warp.
// Q and a double-buffered ring of K and V tiles live in bf16 shared memory
// (rows padded to hd rounded up to 16, plus 8 elements so ldmatrix has no
// bank conflicts), filled by 16-byte cp.async copies where hd and the strides
// allow (element loads otherwise: hd = 20, 33), the next tile in flight
// while this one multiplies, one barrier per tile. S = Q K^T runs on
// mma.sync.m16n8k16 (Q fragments held in registers up to hd 128), scaled
// with __fmul_rn (no contraction into the sum) and, in the tail tile only,
// masked to -inf past n; each lane keeps an online (max, sum) for its two
// rows, merged across the quad with shuffles after pass 1. Pass 2 recomputes S
// with the same instructions, so the logits are bit-identical to pass 1's
// and exp(L - m) <= 1; w = T(expf(L - m) / s), the quotient correctly
// rounded from the row's reciprocal and one FMA step (three instructions in
// place of a division), is packed from the S fragments straight into the A
// fragments of the PV product (mma_common.cuh), and V comes in by
// ldmatrix.trans. Products of bf16 values are exact, so only the order of
// the fp32 sums differs from the plain version. The output is rounded and
// staged through shared memory for 16-byte stores. What bounds it now: the
// per-logit exp, division and rounding on the CUDA cores beside mma.sync
// (at hd 48 they outweigh the products).
//
// fp32 (CUDA cores): tensor cores in fp32 would be TF32, about three decimal
// digits, off the 1e-5 gate against the plain version; fp32 keeps the first
// port's kernel: 32 query rows per block, fp32 tiles in shared memory, the
// products on the CUDA cores. So does bf16 at n = 1 (see flash_attention_fwd
// below).

#include <math.h>

#include "cosine_attention_common.cuh"
#include "mma_common.cuh"

namespace {

// (m, s) <- the merge of two online (max, sum of exp(x - max)) pairs
__device__ __forceinline__ void merge_stats(float& m, float& s, float m2, float s2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;  // both empty
  s = s * expf(m - mm) + s2 * expf(m2 - mm);
  m = mm;
}

// ---------------------------------------------------------------------------
// bf16: the products on the tensor cores
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kRowsQ = 64;     // query rows per block, 16 per warp
constexpr int kRowsK = 64;     // key/value rows per tile
constexpr int kThreads = 128;  // 4 warps

// Rows [row0, row0 + rows) of one head's hd channels (token stride sn) into
// dst as bf16 rows of stride HDP + 8, zeros at rows >= n and channels >= hd.
// vec: 16-byte cp.async copies (hd, the strides and the base 16-byte
// aligned); else element loads. The caller commits and waits.
template <int HDP>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src, int n, int row0, int rows,
                                          long long sn, int hd, bf16* __restrict__ dst, bool vec) {
  constexpr int kRow = HDP + 8;
  if (vec) {
    constexpr int kSeg = HDP / 8;
    for (int idx = threadIdx.x; idx < rows * kSeg; idx += kThreads) {
      const int r = idx / kSeg, col = (idx % kSeg) * 8;
      const int row = row0 + r;
      const bool ok = row < n && col < hd;
      mma::cp_async_16(dst + r * kRow + col, ok ? src + (size_t)row * sn + col : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * HDP; idx += kThreads) {
      const int r = idx / HDP, col = idx % HDP;
      const int row = row0 + r;
      dst[r * kRow + col] =
          (row < n && col < hd) ? src[(size_t)row * sn + col] : __float2bfloat16_rn(0.f);
    }
  }
}

// HDP: hd rounded up to a bucket (a multiple of 16) that fixes the k16
// steps of q k^T and the n8 tiles of the output each warp holds.
template <int HDP>
__global__ void __launch_bounds__(kThreads)
    flash_attention_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                    const bf16* __restrict__ v, bf16* __restrict__ out,
                                    float* __restrict__ stats, int b_total, int n, int heads, int hd,
                                    long long sb, long long sn, float scale, int vec) {
  constexpr int kRow = HDP + 8;       // shared-memory row stride
  constexpr int kKSteps = HDP / 16;   // k16 steps of q k^T
  constexpr int kOTiles = HDP / 8;    // n8 tiles of the output
  constexpr int kSTiles = kRowsK / 8; // n8 tiles of a logit tile
  constexpr bool kQRegs = HDP <= 128;  // Q fragments in registers (else from shared memory)
  static_assert(HDP % 16 == 0, "hd bucket");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kRowsQ][kRow], then the output
  bf16* k_s = q_s + kRowsQ * kRow;                // [2 stages][kRowsK][kRow]
  bf16* v_s = k_s + 2 * kRowsK * kRow;            // [2 stages][kRowsK][kRow]

  const int n_qt = (n + kRowsQ - 1) / kRowsQ;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int h = bh % heads;
  const int b = bh / heads;
  const size_t head0 = (size_t)b * sb + (size_t)h * hd;
  const bf16* kb = k + head0;
  const bf16* vb = v + head0;
  const int q0 = qt * kRowsQ;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int t4 = lane % 4;
  const int tiles = (n + kRowsK - 1) / kRowsK;

  load_tile<HDP>(q + head0, n, q0, kRowsQ, sn, hd, q_s, vec);
  load_tile<HDP>(kb, n, 0, kRowsK, sn, hd, k_s, vec);
  mma::cp_async_commit();

  const bf16* qw = q_s + (warp * 16 + mma::a_row(lane)) * kRow + mma::a_col(lane);
  const int kn_off = mma::bn_row(lane) * kRow + mma::bn_col(lane);
  const int vk_off = mma::bk_row(lane) * kRow + mma::bk_col(lane);
  uint32_t qf[kQRegs ? kKSteps : 1][4];
  float m[2] = {-INFINITY, -INFINITY}, s[2] = {0.f, 0.f};  // rows g and g + 8
  float inv_s[2] = {0.f, 0.f};                               // 1 / s, correctly rounded
  // e / s, correctly rounded: the quotient by the reciprocal, refined by one
  // FMA step (Markstein), as the plain version's division rounds it
  auto divide = [&](float e, int r) {
    const float q0 = __fmul_rn(e, inv_s[r]);
    return __fmaf_rn(__fmaf_rn(-q0, s[r], e), inv_s[r], q0);
  };
  float o[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
  }

  // iterations 0 .. tiles - 1: pass 1 over the key tiles; tiles .. 2 tiles - 1: pass 2
  for (int it = 0; it < 2 * tiles; ++it) {
    const bool pass2 = it >= tiles;
    const int k0 = (pass2 ? it - tiles : it) * kRowsK;
    const int stage = it & 1;
    mma::cp_async_wait<0>();
    __syncthreads();  // this tile landed; the other stage's last readers are done
    if (it + 1 < 2 * tiles) {
      const int next0 = (it + 1 < tiles ? it + 1 : it + 1 - tiles) * kRowsK;
      load_tile<HDP>(kb, n, next0, kRowsK, sn, hd, k_s + (stage ^ 1) * kRowsK * kRow, vec);
      if (it + 1 >= tiles)
        load_tile<HDP>(vb, n, next0, kRowsK, sn, hd, v_s + (stage ^ 1) * kRowsK * kRow, vec);
      mma::cp_async_commit();
    }
    if (kQRegs && it == 0) {
#pragma unroll
      for (int kk = 0; kk < (kQRegs ? kKSteps : 1); ++kk) mma::ldmatrix_x4(qf[kk], qw + kk * 16);
    }

    // S = Q K^T over this tile
    float sc[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = 0.f;
    }
    const bf16* ks = k_s + stage * kRowsK * kRow + kn_off;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t a[4];
      if (kQRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kQRegs ? kk : 0][i];
      } else {
        mma::ldmatrix_x4(a, qw + kk * 16);
      }
#pragma unroll
      for (int j2 = 0; j2 < kSTiles / 2; ++j2) {
        uint32_t bf[4];
        mma::ldmatrix_x4(bf, ks + j2 * 16 * kRow + kk * 16);
        mma::mma_bf16(sc[2 * j2], a, bf[0], bf[1]);
        mma::mma_bf16(sc[2 * j2 + 1], a, bf[2], bf[3]);
      }
    }
    // logits: scaled (rounded before the max is subtracted), masked past n
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = __fmul_rn(sc[j][i], scale);
    }
    if (k0 + kRowsK > n) {  // the tail tile
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (k0 + j * 8 + mma::acc_col(lane, i) >= n) sc[j][i] = -INFINITY;
        }
      }
    }

    if (!pass2) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kSTiles; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
        const float mm = fmaxf(m[r], mx);
        if (mm == -INFINITY) continue;  // no key of this lane yet
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kSTiles; ++j) sum += expf(sc[j][2 * r] - mm) + expf(sc[j][2 * r + 1] - mm);
        s[r] = s[r] * expf(m[r] - mm) + sum;
        m[r] = mm;
      }
      if (it == tiles - 1) {  // the quad's four lanes hold one row's keys
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            const float m2 = __shfl_xor_sync(0xffffffffu, m[r], off);
            const float s2 = __shfl_xor_sync(0xffffffffu, s[r], off);
            merge_stats(m[r], s[r], m2, s2);
          }
          const int row = q0 + warp * 16 + mma::acc_row(lane, 2 * r);
          if (t4 == 0 && row < n) {
            const size_t at = (size_t)bh * n + row;
            stats[at] = m[r];
            stats[(size_t)b_total * heads * n + at] = s[r];
          }
          inv_s[r] = 1.f / s[r];
        }
      }
      continue;
    }

    // pass 2: o += T(exp(L - m) / s) v, the weights repacked as A fragments
    const bf16* vs = v_s + stage * kRowsK * kRow + vk_off;
#pragma unroll
    for (int kc = 0; kc < kRowsK / 16; ++kc) {
      uint32_t a[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * kc + half;
        a[2 * half] = mma::pack_bf16(divide(expf(sc[j][0] - m[0]), 0), divide(expf(sc[j][1] - m[0]), 0));
        a[2 * half + 1] =
            mma::pack_bf16(divide(expf(sc[j][2] - m[1]), 1), divide(expf(sc[j][3] - m[1]), 1));
      }
#pragma unroll
      for (int dp = 0; dp < kOTiles / 2; ++dp) {
        uint32_t bf[4];
        mma::ldmatrix_x4_trans(bf, vs + kc * 16 * kRow + dp * 16);
        mma::mma_bf16(o[2 * dp], a, bf[0], bf[1]);
        mma::mma_bf16(o[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
  }

  // the warp's 16 rows, rounded, through its own rows of q_s to 16-byte stores
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = warp * 16 + mma::acc_row(lane, 2 * half);
      *reinterpret_cast<uint32_t*>(q_s + row * kRow + j * 8 + mma::acc_col(lane, 0)) =
          mma::pack_bf16(o[j][2 * half], o[j][2 * half + 1]);
    }
  }
  __syncwarp();
  const int C = heads * hd;
  for (int idx = lane; idx < 16 * (HDP / 8); idx += 32) {
    const int r = idx / (HDP / 8), col = (idx % (HDP / 8)) * 8;
    const int row = q0 + warp * 16 + r;
    if (row >= n || col >= hd) continue;
    bf16* dst = out + ((size_t)b * n + row) * C + h * hd + col;
    const bf16* src = q_s + (warp * 16 + r) * kRow + col;
    if (hd % 8 == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && col + e < hd; ++e) dst[e] = src[e];
    }
  }
}

template <int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* stats, int b,
                   int n, int heads, int hd, long long sb, long long sn, float scale, bool vec,
                   cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (size_t)(kRowsQ + 4 * kRowsK) * (HDP + 8);
  auto kernel = flash_attention_fwd_bf16_kernel<HDP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)b * heads * ((n + kRowsQ - 1) / kRowsQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), stats, b, n, heads, hd, sb, sn, scale, vec ? 1 : 0);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, float* stats, int b,
                     int n, int heads, int hd, long long sb, long long sn, float scale,
                     cudaStream_t stream) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = hd % 8 == 0 && sn % 8 == 0 && sb % 8 == 0 && aligned(q) && aligned(k) &&
                   aligned(v);
#define TINYEDM_FLASH_LAUNCH(HDP) \
  return launch<HDP>(q, k, v, out, stats, b, n, heads, hd, sb, sn, scale, vec, stream)
  if (hd <= 32) TINYEDM_FLASH_LAUNCH(32);
  if (hd <= 48) TINYEDM_FLASH_LAUNCH(48);
  if (hd <= 64) TINYEDM_FLASH_LAUNCH(64);
  if (hd <= 80) TINYEDM_FLASH_LAUNCH(80);  // DiT-XL/2's 72: 5 k16 steps where 96 takes 6
  if (hd <= 96) TINYEDM_FLASH_LAUNCH(96);
  if (hd <= 128) TINYEDM_FLASH_LAUNCH(128);
  if (hd <= 192) TINYEDM_FLASH_LAUNCH(192);
  TINYEDM_FLASH_LAUNCH(256);
#undef TINYEDM_FLASH_LAUNCH
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32: the products on the CUDA cores (the first port's kernel)
namespace simt {

using namespace cosine_attention;

constexpr int kRowsQ = 32;  // query rows per block
constexpr int kRowsK = 64;  // key/value rows per tile
constexpr int kLogitRows = kRowsQ * kRowsK / kThreads;  // logits per thread per tile
constexpr int kLogitStep = kThreads / kRowsK;           // row step between them
static_assert(kLogitRows * kLogitStep == kRowsQ, "logit tiling");

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

}  // namespace simt

}  // namespace

// q, k, v: (b, n, heads, hd) of one type (bf16 when is_bf16: tensor cores;
// else fp32: CUDA cores), each with unit stride over hd, stride hd over
// heads, and the shared token stride sn and sample stride sb (in elements):
// contiguous tensors, or the q, k, v views of one (b, n, 3, heads, hd)
// tensor. out: (b, n, heads, hd) contiguous; stats: fp32 (2, b, heads, n),
// the row max then the row sum. scale = fp32(1/sqrt(hd)). Launches on
// `stream` without synchronizing; returns the cudaError_t of the launch (0
// on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* stats, int b, int n, int heads, int hd, long long sb,
                                   long long sn, int is_bf16, float scale, void* stream) {
  if (b < 1 || n < 1 || heads < 1 || hd < 1 || hd > 256) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  // n = 1 (one key, which no model sends here: the route starts at 1024
  // tokens): the gradients of q and k vanish, which the backward kernel
  // computes exactly only from a row max summed in its own order, the CUDA
  // cores' (tensor-core sums round otherwise); so bf16 too takes that kernel.
  if (is_bf16 && n > 1)
    return (int)tc::dispatch(q, k, v, out, st, b, n, heads, hd, sb, sn, scale, s);
  if (is_bf16)
    return (int)simt::dispatch<__nv_bfloat16>(q, k, v, out, st, b, n, heads, hd, sb, sn, scale, s);
  return (int)simt::dispatch<float>(q, k, v, out, st, b, n, heads, hd, sb, sn, scale, s);
}
