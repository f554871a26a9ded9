// A bf16 matrix product on the tensor cores (Hopper, sm_90a), for the bf16
// whole-block attention forward and backward (attention_block_{fwd,bwd}.cu),
// with the contract of gemm_common.cuh (its notes):
//
//   out[m][n] = epilogue( sum_k A[m][k] B[k][n] )   over k in one split's range
//
// A is (M, K) row-major, or with kTransA the transpose of a (K, M) row-major
// matrix (the weight gradients' X^T); B is (K, N) row-major, or with kTransB
// the transpose of an (N, K) row-major matrix (W^T). Each operand is
// multiplied by its scale and rounded to bf16 as it is staged (the backward
// forms gout = T(g ts) this way, without storing it). The epilogues
// (kRound, kResidual, kAddScaled, kPartial), their code and the
// deterministic split reduction (gemm::reduce_partials, a fixed order, no
// atomics) are gemm_common.cuh's. Products of bf16-rounded operands are
// exact in fp32, so only the order of the fp32 sums differs from the
// CUDA-core GEMM and from the plain version.
//
// What bounds it on an H100 SXM: at the block kernels' CIFAR-10 shapes
// (C = 256, N and K of C or 3C; the backward's b n = 65536 rows, the
// forward's 32768 at n 256 and 8192 at n 64) each GEMM does 128 to 192
// FLOP per byte of its operands and output, below the 295 at which bf16
// products outrun 3.35 TB/s: alone, each is bound by bytes (the backward's
// qkv GEMM 134 MB, 0.040 ms, against its 25.8 GFLOP, 0.026 ms; the
// forward's at b 128, n 256 67 MB, 0.020 ms, against 12.9 GFLOP, 0.013 ms).
//
// Design: a block of 8 warps computes a kBM x 128 tile of out, each warp a
// (kBM / 2) x 32 part of it in fp32 registers (kMI x 4 mma.sync.m16n8k16
// tiles), over k tiles of 32. kBM is 64 (kMI 2) where a block's range of k
// is at most 256 (8 k tiles: both forward GEMMs, the backward's qkv and dy),
// else 128 (kMI 4: the backward's dx, K = 3C, and weight gradients, 1024
// rows a split). With few k tiles the ring's fill and the epilogue weigh
// more, and twice the blocks overlap them; over many, the larger tile's
// reuse of each staged operand wins (experiments/torch_block_fwd_sweep.py:
// the forward at n 64 5% faster than on 128-row tiles; the rule "64 rows
// where 128-row tiles give less than a wave" made the backward 2% slower).
// Operands are staged into shared memory in the source's own layout (rows
// of 32, kBM or 128 contiguous values, padded by 8 for ldmatrix without
// bank conflicts) in a ring of kStages k tiles, the next ones in flight
// while one multiplies, one barrier per k tile:
//   - an operand with scale 1, 16-byte aligned rows and a contiguous extent
//     that is a multiple of 8, by 16-byte cp.async;
//   - with another scale, by 16-byte loads into registers issued before the
//     products and scaled, rounded and stored after them;
//   - otherwise (unaligned rows) by scaled element loads.
// Fragments come from ldmatrix for an operand whose k runs along the rows
// in shared memory (A, and B transposed) and ldmatrix.trans for the others
// (A transposed, B): no transpose is ever materialized. Edges past M, N and
// a split's range of k are zero-filled. Each mma step's 16 products are
// summed from zero on the tensor cores and added to the fp32 sums with one
// correctly rounded add (4 registers of scratch, not a second set of sums):
// carried across a whole split in the mma accumulators, the sums lose more
// than the CUDA cores' fp32 FMAs (the tensor cores' additions are not
// correctly rounded), which flips more bf16 roundings of qkv, dy and dx away
// from the plain version's (experiments/torch_block_gemm_sweep.py). Outputs
// leave in pairs of neighbouring columns, one 4-byte (8-byte fp32) store.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "gemm_common.cuh"
#include "mma_common.cuh"

namespace gemm_tc {

using bf16 = __nv_bfloat16;
using gemm::kAddScaled;
using gemm::kPartial;
using gemm::kResidual;
using gemm::kRound;

constexpr int kBN = 128;       // output columns per block
constexpr int kBK = 32;        // k depth per staged tile
constexpr int kStages = 3;     // k tiles in shared memory: two in flight while one multiplies
constexpr int kThreads = 256;  // 8 warps, 2 x 4, each (16 kMI) x 32 of the block tile
// output rows per block: kMI m16 tiles per warp, two warps down
template <int kMI>
constexpr int kBM = 32 * kMI;

enum Mode { kAsync = 0, kScaled = 1, kElements = 2 };

// One operand as it is staged: its rows of stride ld, the scale it is
// multiplied by, and how it is copied.
struct Operand {
  const bf16* p;
  long long ld;
  float scale;
  int mode;
};

// A staged tile: kRows rows of kCols contiguous values, row stride kLd.
template <int kRows, int kCols>
struct Tile {
  static constexpr int kLd = kCols + 8;
  static constexpr int kSize = kRows * kLd;
  static constexpr int kSegs = kCols / 8;                  // 16-byte segments per row
  static constexpr int kPer = kRows * kSegs / kThreads;    // segments per thread
  static_assert(kPer * kThreads == kRows * kSegs, "tile tiling");
};

// the bf16 values of a 16-byte word, each times scale and rounded to bf16
__device__ __forceinline__ uint4 scale8(uint4 w, float scale) {
  uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = mma::pack_bf16(__fmul_rn(mma::bf16_lo(x[i]), scale),
                          __fmul_rn(mma::bf16_hi(x[i]), scale));
  return make_uint4(x[0], x[1], x[2], x[3]);
}

// Rows [row0, row_end) x columns [col0, col_end) of the operand, at most a
// tile, into dst; zeros past the ends. kAsync issues cp.async (the caller
// commits), kScaled loads into regs (finish_scaled stores them),
// kElements stores scaled values now.
template <class TileT>
__device__ __forceinline__ void stage(const Operand& o, int row0, int row_end, int col0,
                                      int col_end, bf16* __restrict__ dst,
                                      uint4 (&regs)[TileT::kPer]) {
#pragma unroll
  for (int i = 0; i < TileT::kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / TileT::kSegs, c = (idx % TileT::kSegs) * 8;
    const int row = row0 + r, col = col0 + c;
    const bf16* src = o.p + (size_t)row * o.ld + col;
    bf16* d = dst + r * TileT::kLd + c;
    if (o.mode == kAsync) {
      const bool ok = row < row_end && col < col_end;
      mma::cp_async_16(d, ok ? src : o.p, ok);
    } else if (o.mode == kScaled) {
      regs[i] = row < row_end && col < col_end ? *reinterpret_cast<const uint4*>(src)
                                               : make_uint4(0u, 0u, 0u, 0u);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool ok = row < row_end && col + e < col_end;
        d[e] = __float2bfloat16_rn(ok ? __fmul_rn(__bfloat162float(src[e]), o.scale) : 0.f);
      }
    }
  }
}

template <class TileT>
__device__ __forceinline__ void finish_scaled(const Operand& o, bf16* __restrict__ dst,
                                              const uint4 (&regs)[TileT::kPer]) {
  if (o.mode != kScaled) return;
#pragma unroll
  for (int i = 0; i < TileT::kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / TileT::kSegs, c = (idx % TileT::kSegs) * 8;
    *reinterpret_cast<uint4*>(dst + r * TileT::kLd + c) = scale8(regs[i], o.scale);
  }
}

// The epilogue of the sums v0, v1 of output elements at and at + 1 (N
// even, so both lie in one row; out and extra aligned to 8 bytes): one
// store
template <int kEpi>
__device__ __forceinline__ void store_pair(void* __restrict__ out, const bf16* __restrict__ extra,
                                           size_t at, size_t plane, float v0, float v1, float e0,
                                           float e1) {
  float x0 = 0.f, x1 = 0.f;
  if (kEpi == kResidual || kEpi == kAddScaled) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(extra + at);
    x0 = mma::bf16_lo(x);
    x1 = mma::bf16_hi(x);
  }
  const float r0 = gemm::epilogue<bf16, kEpi>(v0, x0, e0, e1);
  const float r1 = gemm::epilogue<bf16, kEpi>(v1, x1, e0, e1);
  if (kEpi == kPartial)
    *reinterpret_cast<float2*>(static_cast<float*>(out) + plane + at) = make_float2(r0, r1);
  else
    *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + at) = mma::pack_bf16(r0, r1);
}

// Registers capped at 128 a thread so that two blocks share an SM, one
// block's barrier waits overlapping the other's products: ptxas spills 16
// to 96 bytes a thread, and the block backward still runs 4 to 7% faster
// than with one block of 185 registers (experiments/torch_block_gemm_sweep.py).
template <int kMI, bool kTransA, bool kTransB, int kEpi>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_tc_kernel(Operand a, Operand b, int M, int N, int K, int k_chunk, void* __restrict__ out,
                   const bf16* __restrict__ extra, float e0, float e1, int pairs) {
  constexpr int kRows = kBM<kMI>;
  // A as staged: [m][k], or [k][m] when transposed; B: [k][n], or [n][k]
  using TA = Tile<kTransA ? kBK : kRows, kTransA ? kRows : kBK>;
  using TB = Tile<kTransB ? kBN : kBK, kTransB ? kBK : kBN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* a_s = reinterpret_cast<bf16*>(smem_raw);  // [kStages][TA::kSize]
  bf16* b_s = a_s + kStages * TA::kSize;           // [kStages][TB::kSize]

  const int m0 = blockIdx.x * kRows, n0 = blockIdx.y * kBN;
  const int kb = blockIdx.z * k_chunk;
  const int ke = min(K, kb + k_chunk);
  const int steps = ke > kb ? (ke - kb + kBK - 1) / kBK : 0;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp / 4) * 16 * kMI, wn = (warp % 4) * 32;  // the warp's part of the tile

  uint4 ra[TA::kPer], rb[TB::kPer];
  // k tile s into its stage (s % kStages); every call commits one cp.async group
  auto issue = [&](int s) {
    const int k0 = kb + s * kBK;
    bf16* as = a_s + (s % kStages) * TA::kSize;
    bf16* bs = b_s + (s % kStages) * TB::kSize;
    if (s < steps) {
      if (kTransA)
        stage<TA>(a, k0, ke, m0, M, as, ra);
      else
        stage<TA>(a, m0, M, k0, ke, as, ra);
      if (kTransB)
        stage<TB>(b, n0, N, k0, ke, bs, rb);
      else
        stage<TB>(b, k0, ke, n0, N, bs, rb);
    }
    mma::cp_async_commit();
  };
  auto finish = [&](int s) {
    if (s >= steps) return;
    finish_scaled<TA>(a, a_s + (s % kStages) * TA::kSize, ra);
    finish_scaled<TB>(b, b_s + (s % kStages) * TB::kSize, rb);
  };

  float acc[kMI][4][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][nj][i] = 0.f;
    }
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    issue(s);
    finish(s);
  }
  for (int s = 0; s < steps; ++s) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile s landed; the stage tile s - 1 used is free
    issue(s + kStages - 1);
    const bf16* as = a_s + (s % kStages) * TA::kSize;
    const bf16* bs = b_s + (s % kStages) * TB::kSize;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[kMI][4];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        if (kTransA)
          mma::ldmatrix_x4_trans(af[mi], as + (kk * 16 + mma::bn_row(lane)) * TA::kLd + wm +
                                             mi * 16 + mma::bn_col(lane));
        else
          mma::ldmatrix_x4(af[mi], as + (wm + mi * 16 + mma::a_row(lane)) * TA::kLd + kk * 16 +
                                       mma::a_col(lane));
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t bf[4];
        if (kTransB)
          mma::ldmatrix_x4(bf, bs + (wn + nj * 16 + mma::bn_row(lane)) * TB::kLd + kk * 16 +
                                   mma::bn_col(lane));
        else
          mma::ldmatrix_x4_trans(bf, bs + (kk * 16 + mma::bk_row(lane)) * TB::kLd + wn + nj * 16 +
                                         mma::bk_col(lane));
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
          float t0[4] = {}, t1[4] = {};  // this k16 step's sums, from zero
          mma::mma_bf16(t0, af[mi], bf[0], bf[1]);
          mma::mma_bf16(t1, af[mi], bf[2], bf[3]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[mi][2 * nj][i] = __fadd_rn(acc[mi][2 * nj][i], t0[i]);
            acc[mi][2 * nj + 1][i] = __fadd_rn(acc[mi][2 * nj + 1][i], t1[i]);
          }
        }
      }
    }
    finish(s + kStages - 1);
  }

  const size_t plane = (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // rows g and g + 8, columns 2t and 2t + 1
        const int gm = m0 + wm + mi * 16 + mma::acc_row(lane, 2 * half);
        const int gn = n0 + wn + nj * 8 + mma::acc_col(lane, 0);
        const float v0 = acc[mi][nj][2 * half], v1 = acc[mi][nj][2 * half + 1];
        const size_t at = (size_t)gm * N + gn;
        if (gm >= M || gn >= N) continue;
        if (pairs) {
          store_pair<kEpi>(out, extra, at, plane, v0, v1, e0, e1);
        } else {
          gemm::store_out<bf16, kEpi>(out, extra, at, plane, v0, e0, e1);
          if (gn + 1 < N) gemm::store_out<bf16, kEpi>(out, extra, at + 1, plane, v1, e0, e1);
        }
      }
    }
  }
}

// One launch of gemm_tc_kernel<kMI, ...> on an (m_tiles, n_tiles, splits) grid
template <int kMI, bool kTransA, bool kTransB, int kEpi>
cudaError_t launch_tiles(const Operand& a, const Operand& b, int M, int N, int K, int splits,
                         int k_chunk, void* out, const void* extra, float e0, float e1,
                         bool pairs, cudaStream_t stream) {
  constexpr int kRows = kBM<kMI>;
  const long long m_tiles = (M + kRows - 1) / kRows, n_tiles = (N + kBN - 1) / kBN;
  if (m_tiles > 0x7fffffffLL || n_tiles > 65535 || splits > 65535)
    return cudaErrorInvalidConfiguration;
  using TA = Tile<kTransA ? kBK : kRows, kTransA ? kRows : kBK>;
  using TB = Tile<kTransB ? kBN : kBK, kTransB ? kBK : kBN>;
  const int smem = kStages * (TA::kSize + TB::kSize) * (int)sizeof(bf16);
  auto kernel = gemm_tc_kernel<kMI, kTransA, kTransB, kEpi>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)m_tiles, (unsigned)n_tiles, (unsigned)splits);
  kernel<<<grid, kThreads, smem, stream>>>(a, b, M, N, K, k_chunk, out,
                                           static_cast<const bf16*>(extra), e0, e1,
                                           pairs ? 1 : 0);
  return cudaGetLastError();
}

// out (M, N) contiguous = epilogue(A B) over K, in `splits` ranges of k,
// with gemm::launch's arguments and rules (kPartial writes one (M, N) fp32
// partial per range; the other epilogues take splits = 1). 64-row tiles
// where a range of k is at most 8 k tiles, else 128-row ones.
template <bool kTransA, bool kTransB, int kEpi>
cudaError_t launch(const void* a, long long lda, float scale_a, const void* b, long long ldb,
                   float scale_b, int M, int N, int K, int splits, void* out,
                   const void* extra = nullptr, float e0 = 0.f, float e1 = 0.f,
                   cudaStream_t stream = 0) {
  if (M < 1 || N < 1 || K < 1 || splits < 1 || (kEpi != kPartial && splits != 1))
    return cudaErrorInvalidValue;
  const int k_chunk = ((K + splits - 1) / splits + kBK - 1) / kBK * kBK;
  // 16-byte copies need aligned rows and a contiguous extent (A's K, or M
  // transposed; B's N, or K transposed) in whole 16-byte segments
  auto operand = [](const void* p, long long ld, long long extent, float scale) {
    const bool vec = reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 8 == 0 && extent % 8 == 0;
    return Operand{static_cast<const bf16*>(p), ld, scale,
                   !vec ? kElements : scale == 1.f ? kAsync : kScaled};
  };
  const Operand oa = operand(a, lda, kTransA ? M : K, scale_a);
  const Operand ob = operand(b, ldb, kTransB ? K : N, scale_b);
  // neighbouring outputs in one 4-byte (fp32: 8-byte) store
  auto aligned8 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; };
  const bool pairs = N % 2 == 0 && aligned8(out) && (extra == nullptr || aligned8(extra));
  if (k_chunk <= 8 * kBK)
    return launch_tiles<2, kTransA, kTransB, kEpi>(oa, ob, M, N, K, splits, k_chunk, out, extra,
                                                   e0, e1, pairs, stream);
  return launch_tiles<4, kTransA, kTransB, kEpi>(oa, ob, M, N, K, splits, k_chunk, out, extra, e0,
                                                 e1, pairs, stream);
}

// gemm::launch's product for the block kernels: bf16 on the tensor cores,
// fp32 on the CUDA cores (tensor cores in fp32 would be TF32).
template <typename T, bool kTransA, bool kTransB, int kEpi>
cudaError_t product(const void* a, long long lda, float scale_a, const void* b, long long ldb,
                    float scale_b, int M, int N, int K, int splits, void* out, const void* extra,
                    float e0, float e1, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>)
    return launch<kTransA, kTransB, kEpi>(a, lda, scale_a, b, ldb, scale_b, M, N, K, splits, out,
                                          extra, e0, e1, stream);
  else
    return gemm::launch<T, kTransA, kTransB, kEpi>(a, lda, scale_a, b, ldb, scale_b, M, N, K,
                                                   splits, out, extra, e0, e1, stream);
}

}  // namespace gemm_tc
