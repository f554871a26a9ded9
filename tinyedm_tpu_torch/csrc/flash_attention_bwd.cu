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
// products of q k^T's size: S, dP, dq, dk, dv): 0.391 ms of tensor-core time
// at DiT-XL/2's attention (b = 32, n = 1024, 16 heads of 72, bf16), 0.130 ms
// at (1024, 4 heads of 96) and 1.042 ms at (4096, 4 x 48), far above the
// bytes: bound by operations.
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
// values per head). In bf16, p and ds stay fp32 and enter each product as a
// hi + lo pair of bf16 operands, hi = bf16(x), lo = bf16(x - hi): one
// rounding of p and ds to bf16 puts the gradients 2.6e-3 (relative L2) off
// the plain version, past the 1e-3 gate; the pair leaves about 1e-4, the
// rounding of the outputs (tests/test_torch_flash_split.py). So
// dq = ds_hi k + ds_lo k, and so on.
//
// bf16 at n >= 2 and hd <= 128 (the buckets 32, 48, 64, 80, 96, 128):
// warpgroup products, wgmma (wgmma_common.cuh). A block is three
// warpgroups: two consumers, 64 owned rows each, and a producer. The
// producers stage the block's 128 own rows once and stream the other
// side's rows, 64 a tile, into a ring of 4 or 5 stages under mbarriers, by
// 16-byte cp.async copies (element copies where hd or the strides forbid
// them: hd 20, 33), with zeros past hd (up to the bucket) and past n; each
// waits for its copies of a stage, fences them to the async proxy that the
// products read through and arrives at the stage's barrier; each consumer
// warp releases a stage when its last product that reads it is done. The
// producers keep 56 registers a thread and hand the rest to the consumers
// (setmaxnreg: 224 each, of the 168 a thread that 384 threads launch with).
// Tiles are stored as blocks of 8 columns of 16-byte rows, so that one tile
// is the K-major operand of S and dP and the MN-major operand of the sums.
// The logits' fp32 sums (S, dP) stay in the accumulator registers and enter
// the next products as the A operand, split into the pair there: p and ds
// never pass through shared or device memory. A streamed tile is taken in
// two halves of 32 columns, so that one half's products run while the other
// half's exps and splits do. The owned rows' operand of S and dP is held in
// registers too (halving those products' shared-memory reads): by pass (a)
// up to the 96 bucket, by pass (b) up to the 80 bucket, which there also
// has both halves' logits in flight at once.
//   (a) S = Q K^T and dP = G V^T (m64n32k16), p = 2^(S scale log2(e) -
//       (m log2(e) + log2(s))): one FMA and one ex2 a logit, exp(S scale -
//       m) / s up to fp32 rounding, zero past n; sweep 1 sums dp p per row
//       (the quad's lanes meet by shuffles), sweep 2 forms ds and dq +=
//       ds_hi K + ds_lo K.
//   (b) S^T = K Q^T, dP^T = V G^T, then P^T and dS^T once a streamed half,
//       feeding both dv += P^T_hi G + P^T_lo G and dk += dS^T_hi Q +
//       dS^T_lo Q (m64nHDk16, hd / 2 + hd / 2 fp32 sums a thread). The
//       producers stage each query's m log2(e) + log2(s) and delta.
// Products of q k^T's size: (a) S and dP twice, dq as a pair: 6; (b) S^T
// and dP^T once, dk and dv as pairs: 6; 12 against the bound's 5 (the
// pairs' lo halves add 3, delta's sweep 2, the recomputed S^T 2). Each logit
// costs three exps (two in (a), one in (b)) and no division. The loads
// could be TMA copies for the model's layouts, but not at hd 20 or 33 (rows
// of 40 and 66 bytes), and the 8-column tiles need a tensor map whose
// strides are out of order: one producer warpgroup of cp.async serves every
// layout on one path.
//
// bf16 at n >= 2 and hd 129 to 256 (the buckets 192, 256): warp-level
// products, mma.sync.m16n8k16 (mma_common.cuh), because m64n192 and m64n256
// sums of both dk and dv do not fit a thread's registers beside S^T and
// dP^T. q, k, v and g are staged as padded bf16 rows (stride hd rounded up
// to 16, plus 8 elements: ldmatrix without bank conflicts) by cp.async, the
// next streamed tile in flight while this one multiplies.
//   (a) 4 warps own 64 query rows, 16 each, and take the 64-key tiles 32
//       keys at a time: S and dP, p = exp(S scale - m) / s (the quotient
//       correctly rounded), sweep 1 delta, sweep 2 dq += ds_hi K + ds_lo K
//       (K by ldmatrix.trans).
//   (b) 8 warps own 64 key rows: warps 0-3 sum dk of 16 keys each, warps 4-7
//       dv of the same keys, so that each warp's sum stays in registers;
//       both kinds compute S^T, the dk warps also dP^T and dS^T.
// Products: 13 against the bound's 5; the exp and division four times a
// logit.
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
#include "wgmma_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 up to hd 128: warpgroup products
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kGroups = 2;              // consumer warpgroups a block
constexpr int kOwn = 64 * kGroups;      // rows a block owns: queries in (a), keys in (b)
constexpr int kTile = 64;               // streamed rows a stage: keys in (a), queries in (b)
constexpr int kConsumers = 128 * kGroups;
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
// registers a thread: the launch gives each of the 384 threads 168; the
// producers give back 112 each, which lifts the consumers to 224
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
constexpr float kLog2e = 1.4426950408889634f;

// stages of the ring: as many as shared memory holds beside the owned rows
template <int HDP>
constexpr int kStages = HDP <= 96 ? 5 : 4;
// logit columns a product step: half a streamed tile, so that one half's
// products run while the other half's p is taken
constexpr int kHalf = kTile / 2;
// The owned rows' A fragments held in registers for S and dP (S^T and
// dP^T), halving their shared-memory reads: pass (a) up to the 96 bucket,
// pass (b) up to the 80 bucket, which there also has both halves' logits in
// flight at once (at 96, ptxas serializes its products for registers)
template <int HDP>
constexpr bool kRegsA = HDP <= 96;
template <int HDP>
constexpr bool kRegsB = HDP <= 80;

// The producer warpgroup's copy of rows [row0, row0 + R) of channels [col,
// col + hd) of an (n, width) slab into a tile of R rows of HDP columns
// (wgmma_common.cuh's layout), zeros past hd and at rows >= n. vec: 16-byte
// cp.async copies (hd, width and col multiples of 8, the slab 16-byte
// aligned), which the caller commits and waits for; the 8 lanes of a
// quarter warp take 8 rows of one column block (no bank conflicts); else
// element copies.
template <int R, int HDP>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ slab, int n, int row0,
                                          long long width, int col, int hd, bf16* dst, bool vec) {
  const int t = threadIdx.x % 128;
  const bf16* base = slab + (size_t)row0 * width + col;
  const int rows = n - row0;  // of the tile's rows, those that exist
  if (vec) {
    constexpr int kSegs = HDP / 8;
    for (int idx = t; idx < R * kSegs; idx += 128) {
      const int rest = idx / 8, c = rest % kSegs;
      const int r = (rest / kSegs) * 8 + idx % 8;
      const bool ok = r < rows && c * 8 < hd;
      mma::cp_async_16(dst + (c * R + r) * 8, ok ? base + (size_t)r * width + c * 8 : slab, ok);
    }
  } else {
    for (int idx = t; idx < R * HDP; idx += 128) {
      const int r = idx / HDP, c = idx % HDP;
      dst[((c / 8) * R + r) * 8 + c % 8] =
          (r < rows && c < hd) ? base[(size_t)r * width + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// A producer's signal that everything it copied before its last commit but
// InFlight has landed: wait, fence to the async proxy, arrive (a barrier
// counts the 128 producers)
template <int InFlight>
__device__ __forceinline__ void publish(uint64_t* bar) {
  mma::cp_async_wait<InFlight>();
  wgmma::fence_proxy_async();
  wgmma::mbar_arrive(bar);
}

// a consumer warp done with a stage (a barrier counts the 8 consumer warps)
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) wgmma::mbar_arrive(bar);
}

template <int Stages>
__device__ __forceinline__ void init_barriers(uint64_t* own, uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    wgmma::mbar_init(own, 128);
#pragma unroll
    for (int s = 0; s < Stages; ++s) {
      wgmma::mbar_init(full + s, 128);
      wgmma::mbar_init(empty + s, kConsumers / 32);
    }
    wgmma::mbar_init_fence();
  }
  __syncthreads();
}

// hi and lo A fragments (k16 step kc) of a warpgroup's 64 x C fp32 sums
// in the accumulator layout, each value split into its bf16 pair
template <int K>
__device__ __forceinline__ void split_a(const float (&t)[K], int kc, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x0 = t[8 * kc + 2 * i], x1 = t[8 * kc + 2 * i + 1];
    hi[i] = mma::pack_bf16(x0, x1);
    lo[i] = mma::pack_bf16(__fsub_rn(x0, mma::bf16_lo(hi[i])), __fsub_rn(x1, mma::bf16_hi(hi[i])));
  }
}

// The logits' products: d = A B^T over the bucket's k16 steps, A the 64
// owned rows (fragments a in registers, or the tile at ad K-major), B the
// step's rows of a streamed tile (bd, K-major)
template <int N, int HDP, int RA, bool InRegs>
__device__ __forceinline__ void logits(float (&d)[N / 2], const uint32_t (&a)[HDP / 16][4],
                                       uint64_t ad, uint64_t bd) {
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint64_t b = wgmma::advance(bd, kk * 2 * kTile * 16);
    if constexpr (InRegs)
      wgmma::Mma<N>::template rs<0>(d, a[kk], b, kk > 0);
    else
      wgmma::Mma<N>::ss(d, wgmma::advance(ad, kk * 2 * RA * 16), b, kk > 0);
  }
}

// A thread's m64nHDP sums, rounded to bf16, to rows row0 and row0 + 8 of a
// head's slab out (row stride C), channels < hd, rows < n
template <int HDP>
__device__ __forceinline__ void store_acc(const float (&acc)[HDP / 2], bf16* __restrict__ out,
                                          int row0, int n, int C, int hd) {
  const int c0 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half, c = 8 * j + c0;
      if (row >= n || c >= hd) continue;
      const float x0 = acc[4 * j + 2 * half], x1 = acc[4 * j + 2 * half + 1];
      bf16* o = out + (size_t)row * C + c;
      if (hd % 2 == 0) {
        *reinterpret_cast<uint32_t*>(o) = mma::pack_bf16(x0, x1);
      } else {
        o[0] = __float2bfloat16_rn(x0);
        if (c + 1 < hd) o[1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int HDP, bool WithStats>
constexpr size_t smem_bytes() {
  constexpr int kRing = kStages<HDP>;
  return sizeof(bf16) * (size_t)HDP * (2 * kOwn + 2 * kRing * kTile) +
         (WithStats ? sizeof(float) * 2 * kRing * kTile : 0) + sizeof(uint64_t) * (1 + 2 * kRing);
}

// Pass (a): dq, and delta for pass (b). HDP: hd rounded up to a bucket (a
// multiple of 16) that fixes the k16 steps and the width of dq's product.
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ gout,
                           const float* __restrict__ stats, bf16* __restrict__ dq,
                           float* __restrict__ delta_out, int b_total, int n, int heads, int hd,
                           long long sb, long long sn, float scale, int vec) {
  constexpr int kRing = kStages<HDP>;
  constexpr bool kRegs = kRegsA<HDP>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kOwn rows]
  bf16* g_s = q_s + kOwn * HDP;                   // [kOwn rows]
  bf16* k_s = g_s + kOwn * HDP;                   // [kRing][kTile rows]
  bf16* v_s = k_s + kRing * kTile * HDP;          // [kRing][kTile rows]
  uint64_t* own = reinterpret_cast<uint64_t*>(v_s + kRing * kTile * HDP);
  uint64_t* full = own + 1;
  uint64_t* empty = full + kRing;

  const int n_qt = (n + kOwn - 1) / kOwn;
  const int bh = blockIdx.x / n_qt;
  const int h = bh % heads;
  const int b = bh / heads;
  const int C = heads * hd;
  const int col = h * hd;  // the head's first channel in a row
  const int q0 = (blockIdx.x % n_qt) * kOwn;
  const int tiles = (n + kTile - 1) / kTile;
  init_barriers<kRing>(own, full, empty);

  if (threadIdx.x >= kConsumers) {
    // the producers: the block's query and cotangent rows, then the key and
    // value tiles of both sweeps through the ring
    wgmma::regs_dec<kProducerRegs>();
    const bf16* kb = k + (size_t)b * sb;
    const bf16* vb = v + (size_t)b * sb;
    load_tile<kOwn, HDP>(q + (size_t)b * sb, n, q0, sn, col, hd, q_s, vec);
    load_tile<kOwn, HDP>(gout + (size_t)b * n * C, n, q0, C, col, hd, g_s, vec);
    mma::cp_async_commit();
    for (int it = 0; it < 2 * tiles; ++it) {
      const int s = it % kRing;
      if (it >= kRing) wgmma::mbar_wait(empty + s, (it / kRing - 1) & 1);
      const int k0 = (it % tiles) * kTile;
      load_tile<kTile, HDP>(kb, n, k0, sn, col, hd, k_s + s * kTile * HDP, vec);
      load_tile<kTile, HDP>(vb, n, k0, sn, col, hd, v_s + s * kTile * HDP, vec);
      mma::cp_async_commit();
      publish<1>(it == 0 ? own : full + (it - 1) % kRing);  // the stage before this one
    }
    publish<0>(full + (2 * tiles - 1) % kRing);
  } else {
    // the consumers: warpgroup w owns query rows q0 + 64 w ..; this thread's
    // accumulator rows are r0 and r0 + 8
    wgmma::regs_inc<kConsumerRegs>();
    const int w = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;
    const int wr = w * 64 + (threadIdx.x % 128) / 32 * 16;  // the warp's first row in the block
    const int r0 = q0 + wr + lane / 4;
    const float c1 = __fmul_rn(scale, kLog2e);
    float bias[2];  // m log2(e) + log2(s); +inf past n, so that p = 0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      const size_t at = (size_t)bh * n + row;  // m at stats[at], s a (b, heads, n) block further
      bias[r] = row < n ? __fmaf_rn(stats[at], kLog2e, log2f(stats[at + (size_t)b_total * heads * n]))
                        : INFINITY;
    }
    const uint64_t qd = wgmma::tile_desc<kOwn>(q_s + w * 64 * 8);
    const uint64_t gd = wgmma::tile_desc<kOwn>(g_s + w * 64 * 8);
    float acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
    float dsum[2] = {0.f, 0.f};  // sweep 1: this lane's part of rowsum(dp * p)
    float delta[2];              // sweep 2: the rows' delta
    wgmma::mbar_wait(own, 0);
    uint32_t qa[HDP / 16][4], ga[HDP / 16][4];  // the rows of Q and G as A fragments
    if constexpr (kRegs) {
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        wgmma::load_a<kOwn>(qa[kk], q_s, wr, kk);
        wgmma::load_a<kOwn>(ga[kk], g_s, wr, kk);
      }
    }

    // the key tile's S = Q K^T and dP = G V^T, in two halves of 32 keys, both
    // in flight (one commit group each); the second half's products run while
    // the first half's p is taken
    auto start_logits = [&](const bf16* ks, const bf16* vs, float (&sc)[2][kHalf / 2],
                            float (&dp)[2][kHalf / 2]) {
      wgmma::fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        logits<kHalf, HDP, kOwn, kRegs>(sc[h], qa, qd, wgmma::tile_desc<kTile>(ks + h * kHalf * 8));
        logits<kHalf, HDP, kOwn, kRegs>(dp[h], ga, gd, wgmma::tile_desc<kTile>(vs + h * kHalf * 8));
        wgmma::commit();
      }
    };
    // p of logit i of a half; prob_masked also zeroes the keys past n, of
    // which only the last tile has any (`left`: the half's keys before n)
    auto prob = [&](float l, int i) {
      return wgmma::exp2_approx(__fmaf_rn(l, c1, -bias[(i / 2) % 2]));
    };
    auto prob_masked = [&](float l, int i, int left) {
      return 8 * (i / 4) + 2 * (lane % 4) + i % 2 < left ? prob(l, i) : 0.f;
    };

    // sweep 1 over the key tiles: delta = rowsum(dp p)
    for (int it = 0; it < tiles; ++it) {
      const int s = it % kRing;
      wgmma::mbar_wait(full + s, (it / kRing) & 1);
      float sc[2][kHalf / 2], dp[2][kHalf / 2];
      start_logits(k_s + s * kTile * HDP, v_s + s * kTile * HDP, sc, dp);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 0)
          wgmma::wait<1>();
        else
          wgmma::wait<0>();
        wgmma::fence_operand(sc[h]);
        wgmma::fence_operand(dp[h]);
        const int left = n - (it * kTile + h * kHalf);
        if (left >= kHalf) {
#pragma unroll
          for (int i = 0; i < kHalf / 2; ++i) dsum[(i / 2) % 2] += dp[h][i] * prob(sc[h][i], i);
        } else {
#pragma unroll
          for (int i = 0; i < kHalf / 2; ++i)
            dsum[(i / 2) % 2] += dp[h][i] * prob_masked(sc[h][i], i, left);
        }
      }
      release(empty + s);
    }
    // the quad's four lanes hold a row's keys
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], off);
      delta[r] = dsum[r];
      const int row = r0 + 8 * r;
      if (lane % 4 == 0 && row < n) delta_out[(size_t)bh * n + row] = delta[r];
    }

    // sweep 2: ds = (dp - delta) p scale, dq += ds_hi K + ds_lo K (K read
    // MN-major); the first half's dq products run while the second half's ds
    // is taken
    for (int it = tiles; it < 2 * tiles; ++it) {
      const int s = it % kRing;
      wgmma::mbar_wait(full + s, (it / kRing) & 1);
      const bf16* ks = k_s + s * kTile * HDP;
      float sc[2][kHalf / 2], dp[2][kHalf / 2];
      start_logits(ks, v_s + s * kTile * HDP, sc, dp);
      uint32_t hi[2][kHalf / 16][4], lo[2][kHalf / 16][4];  // ds of each half, A fragments
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // this half's logits; the other half's logits or the first half's dq may run
        wgmma::wait<1>();
        wgmma::fence_operand(sc[h]);
        wgmma::fence_operand(dp[h]);
        const int left = n - ((it - tiles) * kTile + h * kHalf);
        auto ds = [&](int i, float p) {
          return __fmul_rn(__fmul_rn(__fsub_rn(dp[h][i], delta[(i / 2) % 2]), p), scale);
        };
        if (left >= kHalf) {
#pragma unroll
          for (int i = 0; i < kHalf / 2; ++i) sc[h][i] = ds(i, prob(sc[h][i], i));
        } else {
#pragma unroll
          for (int i = 0; i < kHalf / 2; ++i) sc[h][i] = ds(i, prob_masked(sc[h][i], i, left));
        }
#pragma unroll
        for (int kc = 0; kc < kHalf / 16; ++kc) split_a(sc[h], kc, hi[h][kc], lo[h][kc]);
        const uint64_t kt = wgmma::tile_desc_t<kTile>(ks + h * kHalf * 8);
        wgmma::fence();
#pragma unroll
        for (int kc = 0; kc < kHalf / 16; ++kc) {
          wgmma::Mma<HDP>::template rs<1>(acc, hi[h][kc], wgmma::advance(kt, kc * 256), 1);
          wgmma::Mma<HDP>::template rs<1>(acc, lo[h][kc], wgmma::advance(kt, kc * 256), 1);
        }
        wgmma::commit();
      }
      wgmma::wait<0>();
      wgmma::fence_operand(acc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int kc = 0; kc < kHalf / 16; ++kc) {
          wgmma::fence_operand(hi[h][kc]);
          wgmma::fence_operand(lo[h][kc]);
        }
      }
      release(empty + s);
    }
    store_acc<HDP>(acc, dq + (size_t)b * n * C + col, r0, n, C, hd);
  }
}

// Pass (b): dk and dv from m, s and delta.
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ gout,
                            const float* __restrict__ stats, const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, int b_total, int n,
                            int heads, int hd, long long sb, long long sn, float scale, int vec) {
  constexpr int kRing = kStages<HDP>;
  constexpr bool kRegs = kRegsB<HDP>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kOwn rows]
  bf16* v_s = k_s + kOwn * HDP;                   // [kOwn rows]
  bf16* q_s = v_s + kOwn * HDP;                   // [kRing][kTile rows]
  bf16* g_s = q_s + kRing * kTile * HDP;          // [kRing][kTile rows]
  // [kRing][2][kTile]: each query's m log2(e) + log2(s), then its delta
  float* st_s = reinterpret_cast<float*>(g_s + kRing * kTile * HDP);
  uint64_t* own = reinterpret_cast<uint64_t*>(st_s + kRing * 2 * kTile);
  uint64_t* full = own + 1;
  uint64_t* empty = full + kRing;

  const int n_kt = (n + kOwn - 1) / kOwn;
  const int bh = blockIdx.x / n_kt;
  const int h = bh % heads;
  const int b = bh / heads;
  const int C = heads * hd;
  const int col = h * hd;
  const int k0 = (blockIdx.x % n_kt) * kOwn;
  const int tiles = (n + kTile - 1) / kTile;
  init_barriers<kRing>(own, full, empty);

  if (threadIdx.x >= kConsumers) {
    // the producers: the block's key and value rows, then the query tiles
    // with their cotangent rows and statistics through the ring
    wgmma::regs_dec<kProducerRegs>();
    const bf16* qb = q + (size_t)b * sb;
    const bf16* gb = gout + (size_t)b * n * C;
    const float* m_g = stats + (size_t)bh * n;
    const float* s_g = stats + (size_t)b_total * heads * n + (size_t)bh * n;
    const float* dl_g = delta + (size_t)bh * n;
    load_tile<kOwn, HDP>(k + (size_t)b * sb, n, k0, sn, col, hd, k_s, vec);
    load_tile<kOwn, HDP>(v + (size_t)b * sb, n, k0, sn, col, hd, v_s, vec);
    mma::cp_async_commit();
    for (int it = 0; it < tiles; ++it) {
      const int s = it % kRing;
      if (it >= kRing) wgmma::mbar_wait(empty + s, (it / kRing - 1) & 1);
      const int q0 = it * kTile;
      load_tile<kTile, HDP>(qb, n, q0, sn, col, hd, q_s + s * kTile * HDP, vec);
      load_tile<kTile, HDP>(gb, n, q0, C, col, hd, g_s + s * kTile * HDP, vec);
      mma::cp_async_commit();
      const int r = threadIdx.x % 128;
      if (r < kTile) {
        const int row = q0 + r;
        const bool in = row < n;  // past n: p = 0
        st_s[s * 2 * kTile + r] = in ? __fmaf_rn(m_g[row], kLog2e, log2f(s_g[row])) : INFINITY;
        st_s[s * 2 * kTile + kTile + r] = in ? dl_g[row] : 0.f;
      }
      publish<1>(it == 0 ? own : full + (it - 1) % kRing);
    }
    publish<0>(full + (tiles - 1) % kRing);
  } else {
    // the consumers: warpgroup w owns key rows k0 + 64 w ..; this thread's
    // accumulator rows are r0 and r0 + 8
    wgmma::regs_inc<kConsumerRegs>();
    const int w = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;
    const int wr = w * 64 + (threadIdx.x % 128) / 32 * 16;
    const int r0 = k0 + wr + lane / 4;
    const float c1 = __fmul_rn(scale, kLog2e);
    const uint64_t kd = wgmma::tile_desc<kOwn>(k_s + w * 64 * 8);
    const uint64_t vd = wgmma::tile_desc<kOwn>(v_s + w * 64 * 8);
    float dk_acc[HDP / 2], dv_acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    wgmma::mbar_wait(own, 0);
    uint32_t ka[HDP / 16][4], va[HDP / 16][4];  // the rows of K and V as A fragments
    if constexpr (kRegs) {
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        wgmma::load_a<kOwn>(ka[kk], k_s, wr, kk);
        wgmma::load_a<kOwn>(va[kk], v_s, wr, kk);
      }
    }

    for (int it = 0; it < tiles; ++it) {
      const int s = it % kRing;
      wgmma::mbar_wait(full + s, (it / kRing) & 1);
      const bf16* qs = q_s + s * kTile * HDP;
      const bf16* gs = g_s + s * kTile * HDP;
      const float* sts = st_s + s * 2 * kTile;
      // the tile in two halves of 32 queries: S^T = K Q^T and dP^T = V G^T of
      // a half (of both at once where the registers hold them), then P^T and
      // dS^T once, then dv += P^T_hi G + P^T_lo G and dk += dS^T_hi Q +
      // dS^T_lo Q, while the next half's logits are taken
      float st[2][kHalf / 2], dpt[2][kHalf / 2];
      uint32_t ph[2][kHalf / 16][4], pl[2][kHalf / 16][4], dh[2][kHalf / 16][4],
          dl[2][kHalf / 16][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 0 || !kRegs) {
          wgmma::fence();
#pragma unroll
          for (int g = h; g < (kRegs ? 2 : h + 1); ++g) {
            const uint64_t qd = wgmma::tile_desc<kTile>(qs + g * kHalf * 8);
            const uint64_t gd = wgmma::tile_desc<kTile>(gs + g * kHalf * 8);
            logits<kHalf, HDP, kOwn, kRegs>(st[g], ka, kd, qd);
            logits<kHalf, HDP, kOwn, kRegs>(dpt[g], va, vd, gd);
            wgmma::commit();
          }
        }
        if constexpr (kRegs) {
          wgmma::wait<1>();  // this half's logits; the other's, or the first half's sums, may run
        } else {
          wgmma::wait<0>();
          if (h == 1) {  // the first half's sums are done
#pragma unroll
            for (int kc = 0; kc < kHalf / 16; ++kc) {
              wgmma::fence_operand(ph[0][kc]);
              wgmma::fence_operand(pl[0][kc]);
              wgmma::fence_operand(dh[0][kc]);
              wgmma::fence_operand(dl[0][kc]);
            }
          }
        }
        wgmma::fence_operand(st[h]);
        wgmma::fence_operand(dpt[h]);
        // P^T and dS^T = (dP^T - delta) P^T scale, once for both sums; this
        // thread's columns come in pairs, 8 j + 2 (lane % 4) and one more
        float2 qbias[kHalf / 8], qdelta[kHalf / 8];
#pragma unroll
        for (int j = 0; j < kHalf / 8; ++j) {
          const int qi = h * kHalf + 8 * j + 2 * (lane % 4);
          qbias[j] = *reinterpret_cast<const float2*>(sts + qi);
          qdelta[j] = *reinterpret_cast<const float2*>(sts + kTile + qi);
        }
#pragma unroll
        for (int i = 0; i < kHalf / 2; ++i) {
          const float2 bq = qbias[i / 4], dd = qdelta[i / 4];
          const float p = wgmma::exp2_approx(__fmaf_rn(st[h][i], c1, -(i % 2 ? bq.y : bq.x)));
          st[h][i] = p;
          dpt[h][i] = __fmul_rn(__fmul_rn(__fsub_rn(dpt[h][i], i % 2 ? dd.y : dd.x), p), scale);
        }
#pragma unroll
        for (int kc = 0; kc < kHalf / 16; ++kc) {
          split_a(st[h], kc, ph[h][kc], pl[h][kc]);
          split_a(dpt[h], kc, dh[h][kc], dl[h][kc]);
        }
        // G and Q read MN-major
        const uint64_t gt = wgmma::tile_desc_t<kTile>(gs + h * kHalf * 8);
        const uint64_t qt = wgmma::tile_desc_t<kTile>(qs + h * kHalf * 8);
        wgmma::fence();
#pragma unroll
        for (int kc = 0; kc < kHalf / 16; ++kc) {
          wgmma::Mma<HDP>::template rs<1>(dv_acc, ph[h][kc], wgmma::advance(gt, kc * 256), 1);
          wgmma::Mma<HDP>::template rs<1>(dv_acc, pl[h][kc], wgmma::advance(gt, kc * 256), 1);
          wgmma::Mma<HDP>::template rs<1>(dk_acc, dh[h][kc], wgmma::advance(qt, kc * 256), 1);
          wgmma::Mma<HDP>::template rs<1>(dk_acc, dl[h][kc], wgmma::advance(qt, kc * 256), 1);
        }
        wgmma::commit();
      }
      wgmma::wait<0>();
      wgmma::fence_operand(dk_acc);
      wgmma::fence_operand(dv_acc);
#pragma unroll
      for (int h = kRegs ? 0 : 1; h < 2; ++h) {
#pragma unroll
        for (int kc = 0; kc < kHalf / 16; ++kc) {
          wgmma::fence_operand(ph[h][kc]);
          wgmma::fence_operand(pl[h][kc]);
          wgmma::fence_operand(dh[h][kc]);
          wgmma::fence_operand(dl[h][kc]);
        }
      }
      release(empty + s);
    }
    const size_t out0 = (size_t)b * n * C + col;
    store_acc<HDP>(dk_acc, dk + out0, r0, n, C, hd);
    store_acc<HDP>(dv_acc, dv + out0, r0, n, C, hd);
  }
}

template <int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g, const float* stats,
                   float* delta, void* dq, void* dk, void* dv, int b, int n, int heads, int hd,
                   long long sb, long long sn, float scale, bool vec, cudaStream_t stream) {
  constexpr size_t smem_a = smem_bytes<HDP, false>();
  constexpr size_t smem_b = smem_bytes<HDP, true>();
  auto dq_kernel = flash_bwd_dq_wg_kernel<HDP>;
  auto dkv_kernel = flash_bwd_dkv_wg_kernel<HDP>;
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)b * heads * ((n + kOwn - 1) / kOwn);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const bf16* q_t = static_cast<const bf16*>(q);
  const bf16* k_t = static_cast<const bf16*>(k);
  const bf16* v_t = static_cast<const bf16*>(v);
  const bf16* g_t = static_cast<const bf16*>(g);
  dq_kernel<<<(unsigned)blocks, kThreads, smem_a, stream>>>(
      q_t, k_t, v_t, g_t, stats, static_cast<bf16*>(dq), delta, b, n, heads, hd, sb, sn, scale,
      vec ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<(unsigned)blocks, kThreads, smem_b, stream>>>(
      q_t, k_t, v_t, g_t, stats, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), b, n,
      heads, hd, sb, sn, scale, vec ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// bf16 from hd 129 to 256: warp-level products
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
// carried across the whole sweep in the mma accumulators.
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
// multiple of 16) that fixes the k16 steps and the n8 tiles of dq. S is
// computed with the forward's instructions in the forward's order
// (flash_attention_fwd.cu).
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
        mma::ldmatrix_x4(aq, q_s + a_off + kk * 16);
        mma::ldmatrix_x4(ag, g_s + a_off + kk * 16);
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
        mma::ldmatrix_x4(ak, k_s + a_off + kk * 16);
#pragma unroll
        for (int j2 = 0; j2 < kSTiles / 2; ++j2) {
          uint32_t bq[4];
          mma::ldmatrix_x4(bq, qs + (s0 + j2 * 16) * kRow + bn_off + kk * 16);
          mma::mma_bf16(st[2 * j2], ak, bq[0], bq[1]);
          mma::mma_bf16(st[2 * j2 + 1], ak, bq[2], bq[3]);
        }
        if (is_dk) {
          uint32_t av[4];
          mma::ldmatrix_x4(av, v_s + a_off + kk * 16);
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

// bf16 at n >= 2: the bucket of hd picks the kernels; vec: 16-byte copies
cudaError_t dispatch_tensor_cores(const void* q, const void* k, const void* v, const void* g,
                                  const float* stats, float* delta, void* dq, void* dk, void* dv,
                                  int b, int n, int heads, int hd, long long sb, long long sn,
                                  float scale, cudaStream_t stream) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = hd % 8 == 0 && sn % 8 == 0 && sb % 8 == 0 && aligned(q) && aligned(k) &&
                   aligned(v) && aligned(g);
#define TINYEDM_FLASH_BWD_LAUNCH(KERNELS, HDP)                                               \
  return KERNELS::launch<HDP>(q, k, v, g, stats, delta, dq, dk, dv, b, n, heads, hd, sb, sn, \
                              scale, vec, stream)
  if (hd <= 32) TINYEDM_FLASH_BWD_LAUNCH(wg, 32);
  if (hd <= 48) TINYEDM_FLASH_BWD_LAUNCH(wg, 48);
  if (hd <= 64) TINYEDM_FLASH_BWD_LAUNCH(wg, 64);
  if (hd <= 80) TINYEDM_FLASH_BWD_LAUNCH(wg, 80);  // DiT-XL/2's 72, as in the forward
  if (hd <= 96) TINYEDM_FLASH_BWD_LAUNCH(wg, 96);
  if (hd <= 128) TINYEDM_FLASH_BWD_LAUNCH(wg, 128);
  if (hd <= 192) TINYEDM_FLASH_BWD_LAUNCH(tc, 192);
  TINYEDM_FLASH_BWD_LAUNCH(tc, 256);
#undef TINYEDM_FLASH_BWD_LAUNCH
}

}  // namespace

// q, k, v: (b, n, heads, hd) with the layout flash_attention_fwd takes (unit
// stride over hd, stride hd over heads, shared token stride sn and sample
// stride sb); g, dq, dk, dv: (b, n, heads, hd) contiguous; all of one type,
// bf16 when is_bf16 (tensor cores at n >= 2), else fp32 (CUDA cores).
// stats: the forward's fp32 (2, b, heads, n); delta: fp32 scratch of
// b * heads * n. scale = fp32(1/sqrt(hd)). Launches both passes on `stream`
// without synchronizing; returns the cudaError_t of the launches (0 on
// success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                   const void* stats, void* delta, void* dq, void* dk, void* dv,
                                   int b, int n, int heads, int hd, long long sb, long long sn,
                                   int is_bf16, float scale, void* stream) {
  if (b < 1 || n < 1 || heads < 1 || hd < 1 || hd > 256) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(stats);
  float* dl = static_cast<float*>(delta);
  if (is_bf16 && n > 1)
    return (int)dispatch_tensor_cores(q, k, v, g, st, dl, dq, dk, dv, b, n, heads, hd, sb, sn,
                                      scale, s);
  if (is_bf16)
    return (int)simt::dispatch<__nv_bfloat16>(q, k, v, g, st, dl, dq, dk, dv, b, n, heads, hd, sb,
                                              sn, scale, s);
  return (int)simt::dispatch<float>(q, k, v, g, st, dl, dq, dk, dv, b, n, heads, hd, sb, sn, scale,
                                    s);
}
