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
// 7 b n heads hd sizeof(T) bytes, against 10 b heads n^2 hd FLOP (five
// products of q k^T's size: S, dP, dq, dk, dv): at the ImageNet-512 widths
// (b = 32, bf16) 0.130 ms of tensor-core time at (n = 1024, 4 heads of 96)
// and 1.042 ms at (4096, 4 x 48), far above the bytes: bound by operations.
//
// Design: dq sums over every key, dk and dv over every query. Rather than
// fp32 atomics (whose order, and so whose result, changes from run to run),
// two deterministic launches, back to back:
//   (a) one block per (sample, head, tile of query rows) streams the key and
//       value tiles twice: sweep 1 for delta (it needs the whole row of p),
//       sweep 2 for ds and dq = ds k; it writes dq and delta, fp32
//       (b, heads, n);
//   (b) one block per (sample, head, tile of key rows) streams the query
//       tiles, recomputes p and ds from m, s and delta, and sums
//       dk = ds^T q and dv = p^T g over all queries in registers.
// p is recomputed from the forward's statistics rather than stored (n^2
// values per head).
//
// bf16 at n >= 2 (tensor cores): the products run on mma.sync.m16n8k16
// (mma_common.cuh). q, k, v and g are staged as padded bf16 rows (stride
// hd rounded up to 16, plus 8 elements: ldmatrix without bank conflicts) by
// 16-byte cp.async copies where hd and the strides allow (element loads
// otherwise: hd = 20, 33), the next streamed tile in flight while this one
// multiplies, one barrier per tile. p and ds stay fp32 in the accumulator
// fragments and enter the next product as a hi + lo pair of bf16 A
// fragments, hi = bf16(x), lo = bf16(x - hi): one rounding of p and ds to
// bf16 puts the gradients 2.6e-3 (relative L2) off the plain version, past
// the 1e-3 gate; the pair leaves about 1e-4, the rounding of the outputs
// (tests/test_torch_flash_split.py). So dq = ds_hi k + ds_lo k, and so on.
//   (a) 4 warps own 64 query rows, 16 each, and take the 64-key tiles 32
//       keys at a time: S = Q K^T and dP = G V^T (Q and G fragments held in
//       registers up to hd 128), p = exp(S scale - m) / s (the quotient
//       correctly rounded, masked past n), sweep 1 sums dp p per row (the
//       quad's lanes meet by shuffles: delta), sweep 2 forms ds and
//       dq += ds_hi K + ds_lo K (K by ldmatrix.trans). S is computed with
//       the forward's instructions in the forward's order
//       (flash_attention_fwd.cu), so its logits are the forward's bit for bit.
//   (b) 8 warps own 64 key rows: warps 0-3 sum dk of 16 keys each, warps 4-7
//       dv of the same keys, so that each warp's sum stays in registers at
//       hd 256; both kinds compute S^T = K Q^T, whose fragments are already
//       the A operand of the next product (keys as rows); the dk warps also
//       dP^T = V G^T and dS^T = P^T (dP^T - delta) scale, then
//       dk += dS^T_hi Q + dS^T_lo Q; the dv warps dv += P^T_hi G + P^T_lo G.
// Products of q k^T's size: (a) S and dP twice, dq as a pair: 6; (b) S^T
// twice, dP^T, dk and dv as pairs: 7; 13 against the bound's 5. Each logit
// also costs an exp and a division four times (twice in each pass), on the
// CUDA cores and special function units beside the tensor cores: at hd 48
// they weigh as much as the products.
//
// fp32, and bf16 at n = 1 (CUDA cores): fp32 on the tensor cores would be
// TF32, off the 1e-5 gate, so fp32 keeps the first port's kernels: 32 rows
// owned per block, fp32 tiles in shared memory (a product of bf16 values is
// exact there, so only the order of sums differs from the plain version),
// the products on the CUDA cores, q k^T and g v^T computed three times.
// At n = 1, dq = dk = 0 exactly only if the backward's logit equals the
// forward's row max bit for bit; there the bf16 forward runs its CUDA-core
// kernel (flash_attention_fwd.cu), so the backward runs its counterpart,
// whose logits are summed in the same order. Shared memory of those kernels
// is bounded by the tiles: 205.7 KB for (a) and 214.3 KB for (b) at hd 256.

#include <math.h>

#include "cosine_attention_common.cuh"
#include "cosine_attention_tc.cuh"
#include "mma_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: the products on the tensor cores
namespace tc {

using bf16 = __nv_bfloat16;
using cosine_attention::tc_common::div_rn;
using cosine_attention::tc_common::stage_rows;

constexpr int kTile = 64;       // streamed rows per tile: keys in (a), queries in (b)
constexpr int kSub = 32;        // logit columns per step: 4 n8 tiles
constexpr int kSTiles = kSub / 8;
constexpr int kRowsQ = 64;      // (a): query rows per block, 16 per warp
constexpr int kThreadsA = 128;  // (a): 4 warps
constexpr int kRowsK = 64;      // (b): key rows per block
constexpr int kThreadsB = 256;  // (b): 4 warps sum dk and 4 dv, of 16 keys each
constexpr int kKeyWarps = kRowsK / 16;

// x0, x1 as a hi + lo pair of bf16x2 registers (the first value in the
// lower half): hi = bf16(x), lo = bf16(x - hi), the difference exact in fp32
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = mma::pack_bf16(x0, x1);
  lo = mma::pack_bf16(__fsub_rn(x0, mma::bf16_lo(hi)), __fsub_rn(x1, mma::bf16_hi(hi)));
}

// hi and lo: the A fragments of columns 16 kc .. 16 kc + 15 of a warp's
// 16 x kSub fp32 tile t (the D-to-A repack of mma_common.cuh), each value
// split as above
__device__ __forceinline__ void split_a(const float (&t)[kSTiles][4], int kc, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = 2 * kc + half;
    split_bf16(t[j][0], t[j][1], hi[2 * half], lo[2 * half]);
    split_bf16(t[j][2], t[j][3], hi[2 * half + 1], lo[2 * half + 1]);
  }
}

// acc (16 x HDP) += (hi + lo) B, B the 16 x HDP [k][n] tile whose lane
// address (bk_row, bk_col applied) is b, by ldmatrix.trans. The sums are
// carried across the whole sweep in the mma accumulators, unlike
// gemm_tc.cuh's, whose sums past 1e-3 at C 768 forced a correctly rounded
// add per k16 step. Here that add halves the drift from the plain version
// (relative L2 2.25e-4 to 1.0e-4 at n 4096, hd 48; 1.27e-4 to 1.0e-4 at
// n 1024, hd 96), which is already within a quarter of the 1e-3 gate, for
// 8 to 10% more time, 255 registers and spills from hd 128 up, and half the
// blocks per SM of pass (b) at hd 64 (experiments/torch_flash_bwd_sweep.py,
// variant step_add).
template <int HDP>
__device__ __forceinline__ void mma_pair(float (&acc)[HDP / 8][4], const uint32_t (&hi)[4],
                                         const uint32_t (&lo)[4], const bf16* b) {
#pragma unroll
  for (int d2 = 0; d2 < HDP / 16; ++d2) {
    uint32_t bf[4];
    mma::ldmatrix_x4_trans(bf, b + d2 * 16);
    mma::mma_bf16(acc[2 * d2], hi, bf[0], bf[1]);
    mma::mma_bf16(acc[2 * d2 + 1], hi, bf[2], bf[3]);
    mma::mma_bf16(acc[2 * d2], lo, bf[0], bf[1]);
    mma::mma_bf16(acc[2 * d2 + 1], lo, bf[2], bf[3]);
  }
}

// A warp's 16 rows of fp32 accumulators (acc, HDP columns), rounded to
// bf16, through its rows at xw of a padded shared-memory tile (which no
// other warp reads any more) to 16-byte stores at rows r0.. of dst
// (row stride C), channels < hd, rows < n.
template <int HDP>
__device__ __forceinline__ void store_rows16(const float (&acc)[HDP / 8][4], bf16* xw,
                                             bf16* __restrict__ dst, int r0, int n, int C,
                                             int hd) {
  constexpr int kRow = HDP + 8;
  const int lane = threadIdx.x % 32;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = mma::acc_row(lane, 2 * half);
      *reinterpret_cast<uint32_t*>(xw + row * kRow + j * 8 + mma::acc_col(lane, 0)) =
          mma::pack_bf16(acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * (HDP / 8); idx += 32) {
    const int r = idx / (HDP / 8), c = (idx % (HDP / 8)) * 8;
    if (r0 + r >= n || c >= hd) continue;
    bf16* out = dst + (size_t)(r0 + r) * C + c;
    const bf16* src = xw + r * kRow + c;
    if (hd % 8 == 0) {
      *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && c + e < hd; ++e) out[e] = src[e];
    }
  }
}

// Pass (a): dq, and delta for pass (b). HDP: hd rounded up to a bucket (a
// multiple of 16) that fixes the k16 steps and the n8 tiles of dq.
template <int HDP>
__global__ void __launch_bounds__(kThreadsA)
    flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ gout,
                           const float* __restrict__ stats, bf16* __restrict__ dq,
                           float* __restrict__ delta_out, int b_total, int n, int heads, int hd,
                           long long sb, long long sn, float scale, int vec) {
  constexpr int kRow = HDP + 8;        // shared-memory row stride
  constexpr int kKSteps = HDP / 16;    // k16 steps of S and dP
  constexpr int kOTiles = HDP / 8;     // n8 tiles of dq
  constexpr bool kRegs = HDP <= 128;   // Q and G fragments in registers (else from shared memory)
  static_assert(HDP % 16 == 0, "hd bucket");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kRowsQ][kRow], then dq
  bf16* g_s = q_s + kRowsQ * kRow;                // [kRowsQ][kRow]
  bf16* k_s = g_s + kRowsQ * kRow;                // [2 stages][kTile][kRow]
  bf16* v_s = k_s + 2 * kTile * kRow;             // [2 stages][kTile][kRow]

  const int n_qt = (n + kRowsQ - 1) / kRowsQ;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int h = bh % heads;
  const int b = bh / heads;
  const int C = heads * hd;
  const int col = h * hd;  // the head's first channel in a row
  const bf16* qb = q + (size_t)b * sb;
  const bf16* kb = k + (size_t)b * sb;
  const bf16* vb = v + (size_t)b * sb;
  const bf16* gb = gout + (size_t)b * n * C;
  const int q0 = qt * kRowsQ;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tiles = (n + kTile - 1) / kTile;

  stage_rows(qb, n, q0, kRowsQ, sn, col, hd, HDP, q_s, kRow, vec);
  stage_rows(gb, n, q0, kRowsQ, C, col, hd, HDP, g_s, kRow, vec);
  stage_rows(kb, n, 0, kTile, sn, col, hd, HDP, k_s, kRow, vec);
  stage_rows(vb, n, 0, kTile, sn, col, hd, HDP, v_s, kRow, vec);
  mma::cp_async_commit();

  // the forward's statistics of this lane's rows g and g + 8; past n, m is
  // +inf so that p = 0
  float m[2], s[2], inv_s[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + mma::acc_row(lane, 2 * r);
    const bool in = row < n;
    m[r] = in ? stats[(size_t)bh * n + row] : INFINITY;
    s[r] = in ? stats[(size_t)b_total * heads * n + (size_t)bh * n + row] : 1.f;
    inv_s[r] = 1.f / s[r];
  }

  const int a_off = (warp * 16 + mma::a_row(lane)) * kRow + mma::a_col(lane);
  const int bn_off = mma::bn_row(lane) * kRow + mma::bn_col(lane);
  const int bk_off = mma::bk_row(lane) * kRow + mma::bk_col(lane);
  uint32_t qf[kRegs ? kKSteps : 1][4], gf[kRegs ? kKSteps : 1][4];
  float dsum[2] = {0.f, 0.f};   // sweep 1: this lane's part of rowsum(dp * p)
  float delta[2] = {0.f, 0.f};  // sweep 2: the rows' delta
  float acc[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  }

  // iterations 0 .. tiles - 1: sweep 1 over the key tiles; tiles .. 2 tiles - 1: sweep 2
  for (int it = 0; it < 2 * tiles; ++it) {
    const bool sweep2 = it >= tiles;
    const int k0 = (sweep2 ? it - tiles : it) * kTile;
    const int stage = it & 1;
    mma::cp_async_wait<0>();
    __syncthreads();  // this tile landed; the other stage's last readers are done
    if (it + 1 < 2 * tiles) {
      const int next0 = (it + 1 < tiles ? it + 1 : it + 1 - tiles) * kTile;
      stage_rows(kb, n, next0, kTile, sn, col, hd, HDP, k_s + (stage ^ 1) * kTile * kRow, kRow,
                 vec);
      stage_rows(vb, n, next0, kTile, sn, col, hd, HDP, v_s + (stage ^ 1) * kTile * kRow, kRow,
                 vec);
      mma::cp_async_commit();
    }
    if (kRegs && it == 0) {
#pragma unroll
      for (int kk = 0; kk < (kRegs ? kKSteps : 1); ++kk) {
        mma::ldmatrix_x4(qf[kk], q_s + a_off + kk * 16);
        mma::ldmatrix_x4(gf[kk], g_s + a_off + kk * 16);
      }
    }
    if (it == tiles) {  // sweep 1 is done: the quad's four lanes hold a row's keys
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], off);
        delta[r] = dsum[r];
        const int row = q0 + warp * 16 + mma::acc_row(lane, 2 * r);
        if (lane % 4 == 0 && row < n) delta_out[(size_t)bh * n + row] = delta[r];
      }
    }
    const bf16* ks = k_s + stage * kTile * kRow;
    const bf16* vs = v_s + stage * kTile * kRow;
#pragma unroll
    for (int s0 = 0; s0 < kTile; s0 += kSub) {
      if (k0 + s0 >= n) break;
      // S = Q K^T (the forward's instructions, in its order) and dP = G V^T
      float sc[kSTiles][4], dp[kSTiles][4];
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[j][i] = dp[j][i] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t aq[4], ag[4];
        if (kRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            aq[i] = qf[kRegs ? kk : 0][i];
            ag[i] = gf[kRegs ? kk : 0][i];
          }
        } else {
          mma::ldmatrix_x4(aq, q_s + a_off + kk * 16);
          mma::ldmatrix_x4(ag, g_s + a_off + kk * 16);
        }
#pragma unroll
        for (int j2 = 0; j2 < kSTiles / 2; ++j2) {
          uint32_t bk[4], bv[4];
          mma::ldmatrix_x4(bk, ks + (s0 + j2 * 16) * kRow + bn_off + kk * 16);
          mma::mma_bf16(sc[2 * j2], aq, bk[0], bk[1]);
          mma::mma_bf16(sc[2 * j2 + 1], aq, bk[2], bk[3]);
          mma::ldmatrix_x4(bv, vs + (s0 + j2 * 16) * kRow + bn_off + kk * 16);
          mma::mma_bf16(dp[2 * j2], ag, bv[0], bv[1]);
          mma::mma_bf16(dp[2 * j2 + 1], ag, bv[2], bv[3]);
        }
      }
      // p = exp(S scale - m) / s, zero past n; sweep 1 sums dp p, sweep 2
      // makes ds = (dp - delta) p scale in place of S
      const bool tail = k0 + s0 + kSub > n;
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i / 2;
          float p = div_rn(expf(__fmul_rn(sc[j][i], scale) - m[r]), s[r], inv_s[r]);
          if (tail && k0 + s0 + j * 8 + mma::acc_col(lane, i) >= n) p = 0.f;
          if (sweep2)
            sc[j][i] = __fmul_rn(__fmul_rn(__fsub_rn(dp[j][i], delta[r]), p), scale);
          else
            dsum[r] += dp[j][i] * p;
        }
      }
      if (!sweep2) continue;
      // dq += ds_hi K + ds_lo K
#pragma unroll
      for (int kc = 0; kc < kSub / 16; ++kc) {
        uint32_t hi[4], lo[4];
        split_a(sc, kc, hi, lo);
        mma_pair<HDP>(acc, hi, lo, ks + (s0 + kc * 16) * kRow + bk_off);
      }
    }
  }

  // dq through the warp's own rows of q_s (no other warp reads them)
  store_rows16<HDP>(acc, q_s + warp * 16 * kRow, dq + (size_t)b * n * C + col,
                    q0 + warp * 16, n, C, hd);
}

// Pass (b): dk and dv from m, s and delta.
template <int HDP>
__global__ void __launch_bounds__(kThreadsB)
    flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ gout,
                            const float* __restrict__ stats, const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, int b_total, int n,
                            int heads, int hd, long long sb, long long sn, float scale, int vec) {
  constexpr int kRow = HDP + 8;
  constexpr int kKSteps = HDP / 16;
  constexpr int kOTiles = HDP / 8;
  constexpr bool kRegs = HDP <= 128;  // K and V fragments in registers
  static_assert(HDP % 16 == 0, "hd bucket");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kRowsK][kRow]: k, then dk
  bf16* v_s = k_s + kRowsK * kRow;                // [kRowsK][kRow]: v, then dv
  bf16* q_s = v_s + kRowsK * kRow;                // [2 stages][kTile][kRow]
  bf16* g_s = q_s + 2 * kTile * kRow;             // [2 stages][kTile][kRow]
  // [2 stages][4][kTile]: the queries' m, s, 1 / s and delta
  float* st_s = reinterpret_cast<float*>(g_s + 2 * kTile * kRow);

  const int n_kt = (n + kRowsK - 1) / kRowsK;
  const int kt = blockIdx.x % n_kt;
  const int bh = blockIdx.x / n_kt;
  const int h = bh % heads;
  const int b = bh / heads;
  const int C = heads * hd;
  const int col = h * hd;
  const bf16* qb = q + (size_t)b * sb;
  const bf16* gb = gout + (size_t)b * n * C;
  const float* m_g = stats + (size_t)bh * n;
  const float* s_g = stats + (size_t)b_total * heads * n + (size_t)bh * n;
  const float* dl_g = delta + (size_t)bh * n;
  const int k0 = kt * kRowsK;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool is_dk = warp < kKeyWarps;  // warp-uniform
  const int kw = warp % kKeyWarps;      // the warp's 16 keys
  const int tiles = (n + kTile - 1) / kTile;

  // the statistics of query rows q0.. into dst; past n, m is +inf (p = 0)
  auto stage_stats = [&](int q0, float* dst) {
    for (int r = threadIdx.x; r < kTile; r += blockDim.x) {
      const int row = q0 + r;
      const bool in = row < n;
      const float s = in ? s_g[row] : 1.f;
      dst[r] = in ? m_g[row] : INFINITY;
      dst[kTile + r] = s;
      dst[2 * kTile + r] = 1.f / s;
      dst[3 * kTile + r] = in ? dl_g[row] : 0.f;
    }
  };
  stage_rows(k + (size_t)b * sb, n, k0, kRowsK, sn, col, hd, HDP, k_s, kRow, vec);
  stage_rows(v + (size_t)b * sb, n, k0, kRowsK, sn, col, hd, HDP, v_s, kRow, vec);
  stage_rows(qb, n, 0, kTile, sn, col, hd, HDP, q_s, kRow, vec);
  stage_rows(gb, n, 0, kTile, C, col, hd, HDP, g_s, kRow, vec);
  stage_stats(0, st_s);
  mma::cp_async_commit();

  const int a_off = (kw * 16 + mma::a_row(lane)) * kRow + mma::a_col(lane);
  const int bn_off = mma::bn_row(lane) * kRow + mma::bn_col(lane);
  const int bk_off = mma::bk_row(lane) * kRow + mma::bk_col(lane);
  uint32_t kf[kRegs ? kKSteps : 1][4], vf[kRegs ? kKSteps : 1][4];
  float acc[kOTiles][4];  // dk (warps 0-3) or dv (4-7) of the warp's keys
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  }

  for (int it = 0; it < tiles; ++it) {
    const int q0 = it * kTile;
    const int stage = it & 1;
    mma::cp_async_wait<0>();
    __syncthreads();  // this tile landed; the other stage's last readers are done
    if (it + 1 < tiles) {
      const int next0 = q0 + kTile;
      stage_rows(qb, n, next0, kTile, sn, col, hd, HDP, q_s + (stage ^ 1) * kTile * kRow, kRow,
                 vec);
      stage_rows(gb, n, next0, kTile, C, col, hd, HDP, g_s + (stage ^ 1) * kTile * kRow, kRow,
                 vec);
      stage_stats(next0, st_s + (stage ^ 1) * 4 * kTile);
      mma::cp_async_commit();
    }
    if (kRegs && it == 0) {
#pragma unroll
      for (int kk = 0; kk < (kRegs ? kKSteps : 1); ++kk) {
        mma::ldmatrix_x4(kf[kk], k_s + a_off + kk * 16);
        if (is_dk) mma::ldmatrix_x4(vf[kk], v_s + a_off + kk * 16);
      }
    }
    const bf16* qs = q_s + stage * kTile * kRow;
    const bf16* gs = g_s + stage * kTile * kRow;
    const float* sts = st_s + stage * 4 * kTile;
    const bf16* rhs = is_dk ? qs : gs;  // the B operand of the warp's sum
#pragma unroll
    for (int s0 = 0; s0 < kTile; s0 += kSub) {
      if (q0 + s0 >= n) break;
      // S^T = K Q^T (both kinds of warp) and dP^T = V G^T (dk warps)
      float st[kSTiles][4], dpt[kSTiles][4];
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t ak[4];
        if (kRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) ak[i] = kf[kRegs ? kk : 0][i];
        } else {
          mma::ldmatrix_x4(ak, k_s + a_off + kk * 16);
        }
#pragma unroll
        for (int j2 = 0; j2 < kSTiles / 2; ++j2) {
          uint32_t bq[4];
          mma::ldmatrix_x4(bq, qs + (s0 + j2 * 16) * kRow + bn_off + kk * 16);
          mma::mma_bf16(st[2 * j2], ak, bq[0], bq[1]);
          mma::mma_bf16(st[2 * j2 + 1], ak, bq[2], bq[3]);
        }
        if (is_dk) {
          uint32_t av[4];
          if (kRegs) {
#pragma unroll
            for (int i = 0; i < 4; ++i) av[i] = vf[kRegs ? kk : 0][i];
          } else {
            mma::ldmatrix_x4(av, v_s + a_off + kk * 16);
          }
#pragma unroll
          for (int j2 = 0; j2 < kSTiles / 2; ++j2) {
            uint32_t bg[4];
            mma::ldmatrix_x4(bg, gs + (s0 + j2 * 16) * kRow + bn_off + kk * 16);
            mma::mma_bf16(dpt[2 * j2], av, bg[0], bg[1]);
            mma::mma_bf16(dpt[2 * j2 + 1], av, bg[2], bg[3]);
          }
        }
      }
      // P^T, then in the dk warps dS^T = (dP^T - delta) P^T scale, in place
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = s0 + j * 8 + mma::acc_col(lane, i);
          const float p = div_rn(expf(__fmul_rn(st[j][i], scale) - sts[qi]), sts[kTile + qi],
                                 sts[2 * kTile + qi]);
          st[j][i] = is_dk
                         ? __fmul_rn(__fmul_rn(__fsub_rn(dpt[j][i], sts[3 * kTile + qi]), p), scale)
                         : p;
        }
      }
      // dk += dS^T_hi Q + dS^T_lo Q, or dv += P^T_hi G + P^T_lo G
#pragma unroll
      for (int kc = 0; kc < kSub / 16; ++kc) {
        uint32_t hi[4], lo[4];
        split_a(st, kc, hi, lo);
        mma_pair<HDP>(acc, hi, lo, rhs + (s0 + kc * 16) * kRow + bk_off);
      }
    }
  }

  __syncthreads();  // every warp is done with k_s and v_s
  store_rows16<HDP>(acc, (is_dk ? k_s : v_s) + kw * 16 * kRow,
                    (is_dk ? dk : dv) + (size_t)b * n * C + col, k0 + kw * 16, n, C, hd);
}

template <int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g, const float* stats,
                   float* delta, void* dq, void* dk, void* dv, int b, int n, int heads, int hd,
                   long long sb, long long sn, float scale, bool vec, cudaStream_t stream) {
  const size_t row = sizeof(bf16) * (HDP + 8);
  const size_t smem_a = row * (2 * kRowsQ + 4 * kTile);
  const size_t smem_b = row * (2 * kRowsK + 4 * kTile) + sizeof(float) * 8 * kTile;
  auto dq_kernel = flash_bwd_dq_tc_kernel<HDP>;
  auto dkv_kernel = flash_bwd_dkv_tc_kernel<HDP>;
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return err;
  const long long blocks_a = (long long)b * heads * ((n + kRowsQ - 1) / kRowsQ);
  const long long blocks_b = (long long)b * heads * ((n + kRowsK - 1) / kRowsK);
  if (blocks_a > 0x7fffffffLL || blocks_b > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const bf16* q_t = static_cast<const bf16*>(q);
  const bf16* k_t = static_cast<const bf16*>(k);
  const bf16* v_t = static_cast<const bf16*>(v);
  const bf16* g_t = static_cast<const bf16*>(g);
  dq_kernel<<<(unsigned)blocks_a, kThreadsA, smem_a, stream>>>(
      q_t, k_t, v_t, g_t, stats, static_cast<bf16*>(dq), delta, b, n, heads, hd, sb, sn, scale,
      vec ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<(unsigned)blocks_b, kThreadsB, smem_b, stream>>>(
      q_t, k_t, v_t, g_t, stats, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), b, n,
      heads, hd, sb, sn, scale, vec ? 1 : 0);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, const void* g, const float* stats,
                     float* delta, void* dq, void* dk, void* dv, int b, int n, int heads, int hd,
                     long long sb, long long sn, float scale, cudaStream_t stream) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = hd % 8 == 0 && sn % 8 == 0 && sb % 8 == 0 && aligned(q) && aligned(k) &&
                   aligned(v) && aligned(g);
#define TINYEDM_FLASH_BWD_LAUNCH(HDP)                                                        \
  return launch<HDP>(q, k, v, g, stats, delta, dq, dk, dv, b, n, heads, hd, sb, sn, scale, vec, \
                     stream)
  if (hd <= 32) TINYEDM_FLASH_BWD_LAUNCH(32);
  if (hd <= 48) TINYEDM_FLASH_BWD_LAUNCH(48);
  if (hd <= 64) TINYEDM_FLASH_BWD_LAUNCH(64);
  if (hd <= 80) TINYEDM_FLASH_BWD_LAUNCH(80);  // DiT-XL/2's 72, as in the forward
  if (hd <= 96) TINYEDM_FLASH_BWD_LAUNCH(96);
  if (hd <= 128) TINYEDM_FLASH_BWD_LAUNCH(128);
  if (hd <= 192) TINYEDM_FLASH_BWD_LAUNCH(192);
  TINYEDM_FLASH_BWD_LAUNCH(256);
#undef TINYEDM_FLASH_BWD_LAUNCH
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32, and bf16 at n = 1: the products on the CUDA cores (the first port's kernels)
namespace simt {

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

}  // namespace simt

}  // namespace

// q, k, v: (b, n, heads, hd) with the layout flash_attention_fwd takes (unit
// stride over hd, stride hd over heads, shared token stride sn and sample
// stride sb); g, dq, dk, dv: (b, n, heads, hd) contiguous; all of one type,
// bf16 when is_bf16 (tensor cores at n >= 2), else fp32 (CUDA cores).
// stats: the forward's fp32 (2, b, heads, n); delta: fp32 scratch of
// b * heads * n. scale = fp32(1/sqrt(hd)). cuda_cores runs bf16 on the
// CUDA-core kernels, the ones the tensor-core kernels replaced, for a
// same-run comparison of the two. Launches both passes on `stream` without
// synchronizing; returns the cudaError_t of the launches (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                   const void* stats, void* delta, void* dq, void* dk, void* dv,
                                   int b, int n, int heads, int hd, long long sb, long long sn,
                                   int is_bf16, int cuda_cores, float scale, void* stream) {
  if (b < 1 || n < 1 || heads < 1 || hd < 1 || hd > 256) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(stats);
  float* dl = static_cast<float*>(delta);
  if (is_bf16 && n > 1 && !cuda_cores)
    return (int)tc::dispatch(q, k, v, g, st, dl, dq, dk, dv, b, n, heads, hd, sb, sn, scale, s);
  if (is_bf16)
    return (int)simt::dispatch<__nv_bfloat16>(q, k, v, g, st, dl, dq, dk, dv, b, n, heads, hd, sb,
                                              sn, scale, s);
  return (int)simt::dispatch<float>(q, k, v, g, st, dl, dq, dk, dv, b, n, heads, hd, sb, sn, scale,
                                    s);
}
