// Variant B of the bf16 whole-block attention forward
// (tinyedm_tpu_torch/csrc/attention_block_fwd.cu), for
// experiments/torch_block_fwd_sweep.py, which splices it into a copy of
// csrc/: qkv stays on chip, as on the TPU (_attn_block_fwd_kernel keeps it
// in VMEM).
//
// One block per (sample, head), 16 query rows per warp, all n rows of the
// head's q, k and v in shared memory (bf16 rows of hd rounded up to 16, plus
// 8): 3 x 256 x 72 x 2 = 110.6 KB at n 256, hd 64. The block
//   1. computes q, k and v (Wqkv's columns h hd, C + h hd and 2C + h hd:
//      the layout is (3, heads, hd)) on mma.sync.m16n8k16, one pass each,
//      over k tiles of 32 of x's sample rows and Wqkv's columns staged by
//      cp.async in a ring of three; each k16 step's products summed from
//      zero and added to the fp32 sums with one rounded add, the order of
//      sums of gemm_tc.cuh; each warp rounds its 16 rows to bf16 into
//      shared memory;
//   2. pixel-normalizes the rows in place, then runs the core of rows 1-2
//      (cosine_attention_fwd.cuh, fwd_tc) over every key at once;
//   3. writes y (b, n, C).
// The out GEMM with its residual stays on gemm_tc.cuh: 2 launches in place
// of 3, and qkv never goes through device memory. It takes hd <= 64, n <=
// 256, C and hd multiples of 8 and 16-byte aligned x, Wqkv and y; the
// caller runs the three launches elsewhere.
#pragma once

#include "cosine_attention_tc.cuh"

namespace block_fwd_onchip {

using bf16 = __nv_bfloat16;
using namespace cosine_attention::tc_common;

constexpr int kBK = 32;     // k depth per staged tile
constexpr int kStages = 3;  // ring of k tiles
constexpr int kKeyTile = 64;
constexpr int kMaxRows = 256;

struct Shape {
  int n, heads, hd, rows, n64, ld, xld;
};

// bytes of shared memory: q_s (rows), k_s and v_s (n64 rows each), then the
// ring of x tiles (rows x 32) and Wqkv tiles (32 x hdp)
inline size_t smem_bytes(const Shape& s) {
  return sizeof(bf16) * ((size_t)(s.rows + 2 * s.n64) * s.ld +
                         (size_t)kStages * (s.rows * s.xld + kBK * s.ld));
}

template <int HDB>
__global__ void __launch_bounds__(512)
    block_fwd_onchip_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                            bf16* __restrict__ y, Shape sh, float scale) {
  constexpr int kOMax = HDB / 8;   // n8 tiles of a head's hd columns
  constexpr int kKMax = HDB / 16;  // k16 steps of q k^T
  constexpr int kSTiles = kKeyTile / 8;
  const int n = sh.n, hd = sh.hd, heads = sh.heads, ld = sh.ld, xld = sh.xld;
  const int hdp = padded_hd(hd), ksteps = hdp / 16;
  const int C = heads * hd, c3 = 3 * C;
  const int h = blockIdx.x % heads, b = blockIdx.x / heads;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = warp * 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [rows][ld]
  bf16* k_s = q_s + sh.rows * ld;                 // [n64][ld]
  bf16* v_s = k_s + sh.n64 * ld;                  // [n64][ld]
  bf16* x_ring = v_s + sh.n64 * ld;               // [kStages][rows][xld]
  bf16* w_ring = x_ring + kStages * sh.rows * xld;  // [kStages][kBK][ld]
  auto part_s = [&](int part) { return part == 0 ? q_s : part == 1 ? k_s : v_s; };

  // key and value rows past the GEMM's rows stay zero (they meet masked
  // weights, and 0 * NaN would not be 0)
  for (int idx = threadIdx.x; idx < (sh.n64 - sh.rows) * ld; idx += blockDim.x) {
    k_s[sh.rows * ld + idx] = __float2bfloat16_rn(0.f);
    v_s[sh.rows * ld + idx] = __float2bfloat16_rn(0.f);
  }

  // ---- 1. q, k, v = T(x Wqkv[:, part's columns]) into shared memory
  const bf16* xb = x + (size_t)b * n * C;
  const int kt = (C + kBK - 1) / kBK, steps = 3 * kt;
  auto issue = [&](int s) {
    if (s < steps) {
      const int part = s / kt, k0 = (s % kt) * kBK;
      bf16* xs = x_ring + (s % kStages) * sh.rows * xld;
      bf16* ws = w_ring + (s % kStages) * kBK * ld;
      for (int idx = threadIdx.x; idx < sh.rows * (kBK / 8); idx += blockDim.x) {
        const int r = idx / (kBK / 8), c = (idx % (kBK / 8)) * 8;
        const bool ok = r < n && k0 + c < C;
        mma::cp_async_16(xs + r * xld + c, ok ? xb + (size_t)r * C + k0 + c : xb, ok);
      }
      const int col0 = part * C + h * hd;
      for (int idx = threadIdx.x; idx < kBK * (hdp / 8); idx += blockDim.x) {
        const int r = idx / (hdp / 8), c = (idx % (hdp / 8)) * 8;
        const bool ok = k0 + r < C && c < hd;
        mma::cp_async_16(ws + r * ld + c, ok ? wqkv + (size_t)(k0 + r) * c3 + col0 + c : wqkv, ok);
      }
    }
    mma::cp_async_commit();
  };

  float acc[kOMax][4];
#pragma unroll
  for (int j = 0; j < kOMax; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < steps; ++s) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile s landed; the stage tile s - 1 used is free
    issue(s + kStages - 1);
    const bf16* xs = x_ring + (s % kStages) * sh.rows * xld;
    const bf16* ws = w_ring + (s % kStages) * kBK * ld;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[4];
      mma::ldmatrix_x4(af, xs + (r0 + mma::a_row(lane)) * xld + kk * 16 + mma::a_col(lane));
#pragma unroll
      for (int j2 = 0; j2 < kOMax / 2; ++j2) {
        if (j2 >= ksteps) break;
        uint32_t bf[4];
        mma::ldmatrix_x4_trans(bf, ws + (kk * 16 + mma::bk_row(lane)) * ld + j2 * 16 +
                                       mma::bk_col(lane));
        float t0[4] = {}, t1[4] = {};  // this k16 step's sums, from zero
        mma::mma_bf16(t0, af, bf[0], bf[1]);
        mma::mma_bf16(t1, af, bf[2], bf[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[2 * j2][i] = __fadd_rn(acc[2 * j2][i], t0[i]);
          acc[2 * j2 + 1][i] = __fadd_rn(acc[2 * j2 + 1][i], t1[i]);
        }
      }
    }
    if ((s + 1) % kt == 0) {  // the part is done: its 16 rows of this warp, rounded
      bf16* dst = part_s(s / kt) + r0 * ld;
#pragma unroll
      for (int j = 0; j < kOMax; ++j) {
        if (j >= 2 * ksteps) break;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int at = mma::acc_row(lane, 2 * half) * ld + j * 8 + mma::acc_col(lane, 0);
          *reinterpret_cast<uint32_t*>(dst + at) =
              mma::pack_bf16(acc[j][2 * half], acc[j][2 * half + 1]);
          acc[j][2 * half] = acc[j][2 * half + 1] = 0.f;
        }
      }
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  // ---- 2. pixel norm of every row, then the attention core
  for (int r = threadIdx.x; r < 3 * n; r += blockDim.x) {
    bf16* row = part_s(r / n) + (r % n) * ld;
    normalize_row(row, row, hdp, scale);
  }
  __syncthreads();
  if (r0 >= n) return;

  uint32_t qf[kKMax][4];
#pragma unroll
  for (int kk = 0; kk < kKMax; ++kk) {
    if (kk < ksteps)
      mma::ldmatrix_x4(qf[kk], q_s + (r0 + mma::a_row(lane)) * ld + kk * 16 + mma::a_col(lane));
  }
  const int kn_off = mma::bn_row(lane) * ld + mma::bn_col(lane);
  const int vk_off = mma::bk_row(lane) * ld + mma::bk_col(lane);
  float o[kOMax][4];
#pragma unroll
  for (int j = 0; j < kOMax; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
  }
  float rsum[2] = {0.f, 0.f};
  for (int t0 = 0; t0 < n; t0 += kKeyTile) {
    float sc[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = 0.f;
    }
    const bf16* ks = k_s + t0 * ld + kn_off;
#pragma unroll
    for (int kk = 0; kk < kKMax; ++kk) {
      if (kk >= ksteps) break;
#pragma unroll
      for (int j2 = 0; j2 < kSTiles / 2; ++j2) {
        uint32_t bf[4];
        mma::ldmatrix_x4(bf, ks + j2 * 16 * ld + kk * 16);
        mma::mma_bf16(sc[2 * j2], qf[kk], bf[0], bf[1]);
        mma::mma_bf16(sc[2 * j2 + 1], qf[kk], bf[2], bf[3]);
      }
    }
    const bool tail = t0 + kKeyTile > n;
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float e = expf(__fmul_rn(sc[j][i], scale));
        if (tail && t0 + j * 8 + mma::acc_col(lane, i) >= n) e = 0.f;
        sc[j][i] = e;
        rsum[i / 2] += e;
      }
    }
    const bf16* vs = v_s + t0 * ld + vk_off;
#pragma unroll
    for (int kc = 0; kc < kKeyTile / 16; ++kc) {
      uint32_t a[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * kc + half;
        a[2 * half] = mma::pack_bf16(sc[j][0], sc[j][1]);
        a[2 * half + 1] = mma::pack_bf16(sc[j][2], sc[j][3]);
      }
#pragma unroll
      for (int dp = 0; dp < kKMax; ++dp) {
        if (dp >= ksteps) break;
        uint32_t bf[4];
        mma::ldmatrix_x4_trans(bf, vs + kc * 16 * ld + dp * 16);
        mma::mma_bf16(o[2 * dp], a, bf[0], bf[1]);
        mma::mma_bf16(o[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
  }

  // ---- 3. o / s once, rounded, through the warp's own q_s rows to y
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], off);
    inv[r] = 1.f / rsum[r];
  }
  __syncwarp();
  bf16* ow = q_s + r0 * ld;
#pragma unroll
  for (int j = 0; j < kOMax; ++j) {
    if (j >= 2 * ksteps) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int at = mma::acc_row(lane, 2 * half) * ld + j * 8 + mma::acc_col(lane, 0);
      *reinterpret_cast<uint32_t*>(ow + at) =
          mma::pack_bf16(div_rn(o[j][2 * half], rsum[half], inv[half]),
                         div_rn(o[j][2 * half + 1], rsum[half], inv[half]));
    }
  }
  __syncwarp();
  store_rows16(ow, ld, y + (size_t)b * n * C, n, r0, C, h * hd, hd, true);
}

// Whether the variant takes this shape; the smem it needs in *bytes
inline bool fits(const void* x, const void* wqkv, const void* y, int n, int heads, int hd,
                 Shape* sh, size_t* bytes) {
  auto at16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (n > kMaxRows || hd > 64 || hd % 8 || !at16(x) || !at16(wqkv) || !at16(y)) return false;
  const int rows = (n + 15) / 16 * 16;
  *sh = Shape{n, heads, hd, rows, (n + kKeyTile - 1) / kKeyTile * kKeyTile, padded_hd(hd) + 8,
              kBK + 8};
  *bytes = smem_bytes(*sh);
  return *bytes <= (size_t)kOnePerSm;
}

// y (b, n, C) = the attention core of T(x Wqkv), qkv on chip; returns
// cudaErrorNotSupported where fits() is false
inline cudaError_t launch(const void* x, const void* wqkv, void* y, int b, int n, int heads,
                          int hd, float scale, cudaStream_t stream) {
  Shape sh;
  size_t bytes = 0;
  if (!fits(x, wqkv, y, n, heads, hd, &sh, &bytes)) return cudaErrorNotSupported;
  auto kernel = hd <= 32 ? block_fwd_onchip_kernel<32> : block_fwd_onchip_kernel<64>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(b * heads), sh.rows * 2, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv), static_cast<bf16*>(y), sh,
      scale);
  return cudaGetLastError();
}

}  // namespace block_fwd_onchip
