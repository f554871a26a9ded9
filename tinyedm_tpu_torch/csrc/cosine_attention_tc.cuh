// What the tensor-core (bf16) fused cosine-attention forward and backward
// share (cosine_attention_fwd.cuh, cosine_attention_bwd.cuh; their .cu notes
// describe the kernels): staging raw head rows into padded bf16 shared
// memory, pixel-normalizing staged rows in place, the launch shape, and the
// pixel-norm VJP of a warp's 16 rows straight from mma accumulators.
//
// Tiles in shared memory are rows of hdp = hd rounded up to 16 bf16 values
// plus 8 (row stride ld = hdp + 8: an odd multiple of 16 bytes, so the 8
// rows an ldmatrix reads fall on 8 distinct bank groups, and the 16-byte
// accesses of 8 threads that each own a row do too). Columns hd..hdp-1 and
// rows at or past n are zero, so padded keys, queries and channels add
// nothing to any product.
#pragma once

#include <stdint.h>

#include "cosine_attention_common.cuh"
#include "mma_common.cuh"

namespace cosine_attention {
namespace tc_common {

using bf16 = __nv_bfloat16;

// The most threads a block of the HDB bucket takes: at hd <= 64 16 warps
// (their registers still fit one block on an SM), above 8.
template <int HDB>
constexpr int max_threads() {
  return HDB <= 64 ? 512 : 256;
}
// Shared memory a block may take so that two blocks fit on an SM (of its
// 228 KB, 1 KB per block is reserved): one block's staging then overlaps
// the other's products.
constexpr int kTwoPerSm = 113 * 1024;
constexpr int kOnePerSm = 227 * 1024;

__host__ __device__ inline int padded_hd(int hd) { return (hd + 15) / 16 * 16; }

// x / d correctly rounded, given inv = 1 / d correctly rounded: the
// quotient by the reciprocal, refined by one FMA step (Markstein), three
// instructions in place of a division.
__device__ __forceinline__ float div_rn(float x, float d, float inv) {
  const float q = __fmul_rn(x, inv);
  return __fmaf_rn(__fmaf_rn(-q, d, x), inv, q);
}

// Rows [row0, row0 + rows) of channels [col, col + hd) of an (n, width)
// bf16 slab into dst (row stride ld), with zeros past hd (up to hdp) and at
// rows >= n. vec: 16-byte cp.async copies (hd, width and col multiples of 8,
// the slab 16-byte aligned), which the caller commits and waits for; else
// element copies.
__device__ __forceinline__ void stage_rows(const bf16* __restrict__ slab, int n, int row0,
                                           int rows, long long width, int col, int hd, int hdp,
                                           bf16* __restrict__ dst, int ld, bool vec) {
  if (vec) {
    const int segs = hdp / 8;
    for (int idx = threadIdx.x; idx < rows * segs; idx += blockDim.x) {
      const int r = idx / segs, c = (idx % segs) * 8;
      const int row = row0 + r;
      const bool ok = row < n && c < hd;
      mma::cp_async_16(dst + r * ld + c, ok ? slab + (size_t)row * width + col + c : slab, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * hdp; idx += blockDim.x) {
      const int r = idx / hdp, c = idx % hdp;
      const int row = row0 + r;
      dst[r * ld + c] = (row < n && c < hd) ? slab[(size_t)row * width + col + c]
                                            : __float2bfloat16_rn(0.f);
    }
  }
}

// the 8 bf16 values of a 16-byte word, as floats (exact)
__device__ __forceinline__ void unpack8(const uint4& u, float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = mma::bf16_lo(w[i]);
    x[2 * i + 1] = mma::bf16_hi(w[i]);
  }
}

// Pixel-normalizes one staged row src into dst (src may be dst),
// x^ = T(x / T(eps + |x|/sqrt(hd))) with the fp32 norm, the quotient
// correctly rounded before the rounding to bf16 (the plain version's
// division). One thread owns the row. If scaled is not null, it also gets
// T(x^ mul).
__device__ __forceinline__ void normalize_row(const bf16* src, bf16* dst, int hdp,
                                              float inv_sqrt_hd, bf16* scaled = nullptr,
                                              float mul = 0.f) {
  float part[8] = {};  // eight independent sums: a short dependency chain
  for (int c = 0; c < hdp; c += 8) {
    float x[8];
    unpack8(*reinterpret_cast<const uint4*>(src + c), x);
#pragma unroll
    for (int i = 0; i < 8; ++i) part[i] += x[i] * x[i];
  }
  const float ss =
      ((part[0] + part[1]) + (part[2] + part[3])) + ((part[4] + part[5]) + (part[6] + part[7]));
  const float d = round_to<bf16>(__fadd_rn(kEps, __fmul_rn(sqrtf(ss), inv_sqrt_hd)));
  const float inv = 1.f / d;
  for (int c = 0; c < hdp; c += 8) {
    float x[8];
    unpack8(*reinterpret_cast<const uint4*>(src + c), x);
    uint32_t w[4], m[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = round_to<bf16>(div_rn(x[2 * i], d, inv));
      const float b = round_to<bf16>(div_rn(x[2 * i + 1], d, inv));
      w[i] = mma::pack_bf16(a, b);
      m[i] = mma::pack_bf16(a * mul, b * mul);
    }
    *reinterpret_cast<uint4*>(dst + c) = make_uint4(w[0], w[1], w[2], w[3]);
    if (scaled) *reinterpret_cast<uint4*>(scaled + c) = make_uint4(m[0], m[1], m[2], m[3]);
  }
}

// T(x mul) of one staged row into dst (one thread owns the row)
__device__ __forceinline__ void scale_row(const bf16* row, bf16* dst, int hdp, float mul) {
  for (int c = 0; c < hdp; c += 8) {
    float x[8];
    unpack8(*reinterpret_cast<const uint4*>(row + c), x);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = mma::pack_bf16(x[2 * i] * mul, x[2 * i + 1] * mul);
    *reinterpret_cast<uint4*>(dst + c) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// the rows a block owns: `most`, or n rounded up to 16 if that is less
inline int block_rows(int n, int most) {
  const int n16 = (n + 15) / 16 * 16;
  return n16 < most ? n16 : most;
}

// The key chunk of a kernel whose block stages `fixed` rows plus
// `chunk_per_key` rows for every key of a chunk (a multiple of 64, at most n
// rounded up to 64), and `extra` bytes: the largest chunk with which the
// block fits in `budget` bytes of shared memory (kTwoPerSm: two blocks per
// SM, so that one block's staging overlaps the other's products), else in
// kOnePerSm. Returns the shared-memory bytes; 0 if not even a chunk of 64
// fits.
inline size_t pick_chunk(int n, int hd, int fixed, int chunk_per_key, size_t extra, size_t budget,
                         int* chunk) {
  const size_t row_bytes = sizeof(bf16) * (size_t)(padded_hd(hd) + 8);
  const int most = (n + 63) / 64 * 64;
  auto bytes = [&](int c) { return row_bytes * (size_t)(fixed + chunk_per_key * c) + extra; };
  const size_t budgets[2] = {budget, (size_t)kOnePerSm};
  for (const size_t b : budgets) {
    int best = 0;
    for (int c = 64; c <= most && bytes(c) <= b; c += 64) best = c;
    if (best) {
      *chunk = best;
      return bytes(best);
    }
  }
  return 0;
}

// The pixel-norm VJP of a warp's 16 rows, with the raw rows x in shared
// memory at xs (row stride ld) and the cotangent gy of the normalized rows in
// the m16n8 accumulator layout (gy[j] the n8 tile of columns 8j..8j+7; the
// four lanes of a quad hold one row): recomputes each row's fp32 norm s and
// UNROUNDED divisor D = eps + s c (c = 1/sqrt(hd)) and overwrites x with
// T(gy / D - x sum(gy x) / (D D max(s, 1e-30) / c)). Each lane reads and
// writes only its own elements, so the update is in place.
template <int OMAX>
__device__ __forceinline__ void pixel_norm_vjp_frag(bf16* xs, int ld, int hd, float c,
                                                    const float (&gy)[OMAX][4]) {
  const int lane = threadIdx.x % 32;
  const int otiles = padded_hd(hd) / 8;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    bf16* row = xs + mma::acc_row(lane, 2 * half) * ld + mma::acc_col(lane, 0);
    float ss = 0.f, inner = 0.f;
#pragma unroll
    for (int j = 0; j < OMAX; ++j) {
      if (j < otiles) {  // columns past hd are zero
        const uint32_t w = *reinterpret_cast<const uint32_t*>(row + j * 8);
        const float x0 = mma::bf16_lo(w), x1 = mma::bf16_hi(w);
        ss += x0 * x0 + x1 * x1;
        inner += gy[j][2 * half] * x0 + gy[j][2 * half + 1] * x1;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      inner += __shfl_xor_sync(0xffffffffu, inner, off);
    }
    const float s = sqrtf(ss);
    const float d = __fadd_rn(kEps, __fmul_rn(s, c));
    const float inv = 1.f / d;
    const float k = inner / (__fmul_rn(__fmul_rn(d, d), fmaxf(s, 1e-30f)) / c);
#pragma unroll
    for (int j = 0; j < OMAX; ++j) {
      if (j < otiles) {
        uint32_t* p = reinterpret_cast<uint32_t*>(row + j * 8);
        const float x0 = mma::bf16_lo(*p), x1 = mma::bf16_hi(*p);
        *p = mma::pack_bf16(__fsub_rn(div_rn(gy[j][2 * half], d, inv), __fmul_rn(x0, k)),
                            __fsub_rn(div_rn(gy[j][2 * half + 1], d, inv), __fmul_rn(x1, k)));
      }
    }
  }
}

// The warp's 16 rows [r0, r0 + 16) of a tile in shared memory at src (row
// stride ld) to channels [col, col + hd) of an (n, width) bf16 slab, rows at
// or past n skipped: 16-byte stores where vec (hd, width and col multiples of
// 8, the slab 16-byte aligned), else element stores.
__device__ __forceinline__ void store_rows16(const bf16* src, int ld, bf16* __restrict__ slab,
                                             int n, int r0, long long width, int col, int hd,
                                             bool vec) {
  const int lane = threadIdx.x % 32;
  const int segs = vec ? hd / 8 : hd;
  for (int idx = lane; idx < 16 * segs; idx += 32) {
    const int r = idx / segs, cc = (idx % segs) * (vec ? 8 : 1);
    if (r0 + r >= n) continue;
    bf16* dst = slab + (size_t)(r0 + r) * width + col + cc;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src + r * ld + cc);
    } else {
      *dst = src[r * ld + cc];
    }
  }
}

}  // namespace tc_common
}  // namespace cosine_attention
