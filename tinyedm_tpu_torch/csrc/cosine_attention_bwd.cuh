// Device code of the fused pixel-norm + cosine attention backward, shared by
// cosine_attention_bwd.cu (its notes describe the two passes) and the
// whole-block attention backward (attention_block_bwd.cu), whose attention
// core it is: bwd_tc, bf16 on the tensor cores; bwd_detail, the CUDA-core
// kernels for fp32.
#pragma once

#include <type_traits>

#include "cosine_attention_common.cuh"
#include "cosine_attention_tc.cuh"

namespace cosine_attention {

// ---------------------------------------------------------------------------
// bf16: the products on the tensor cores
namespace bwd_tc {

using namespace tc_common;

constexpr int kSub = 32;  // keys per S/dP tile of a pass (a) warp, queries per pass (b) warp

// Pass (a): dq, and the per-row rc and delta that pass (b) reads. HDB: the
// head-dim bucket that sizes the register arrays (the loops run over hd
// rounded up to 16). A block of rows_q / 16 warps owns rows_q query rows of
// one (sample, head), 16 per warp; keys come in chunks of `chunk` rows.
template <int HDB>
__global__ void __launch_bounds__(max_threads<HDB>())
    attn_bwd_dq_tc_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ gout,
                          const bf16* __restrict__ out, bf16* __restrict__ dqkv,
                          float* __restrict__ stats, int b_total, int n, int heads, int hd,
                          float scale, int rows_q, int chunk, int vec) {
  constexpr int kKMax = HDB / 16;
  constexpr int kOMax = HDB / 8;
  constexpr int kSTiles = kSub / 8;
  const int hdp = padded_hd(hd), ld = hdp + 8, ksteps = hdp / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);  // [rows_q][ld]: q, then dq
  bf16* q_s = x_s + rows_q * ld;                  // [rows_q][ld]: q^
  bf16* g_s = q_s + rows_q * ld;                  // [rows_q][ld]: g
  bf16* k_s = g_s + rows_q * ld;                  // [chunk][ld]: k^
  bf16* v_s = k_s + chunk * ld;                   // [chunk][ld]: v^
  float* delta_s = reinterpret_cast<float*>(v_s + chunk * ld);  // [rows_q]

  const int n_qt = (n + rows_q - 1) / rows_q;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int h = bh % heads;
  const int b = bh / heads;
  const int C = heads * hd;
  const int c3 = 3 * C;
  const bf16* slab = qkv + (size_t)b * n * c3;
  const bf16* g_slab = gout + (size_t)b * n * C;
  const bf16* o_slab = out + (size_t)b * n * C;
  const int q0 = qt * rows_q;
  const int nq = min(rows_q, n - q0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = q0 + warp * 16;
  const bool active = r0 < n;

  const int a_off = (warp * 16 + mma::a_row(lane)) * ld + mma::a_col(lane);
  const int kn_off = mma::bn_row(lane) * ld + mma::bn_col(lane);
  const int vk_off = mma::bk_row(lane) * ld + mma::bk_col(lane);
  float acc[kOMax][4];  // the unscaled dq^ sum over keys
#pragma unroll
  for (int j = 0; j < kOMax; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  }
  float rsum[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};  // rows g and g + 8

  stage_rows(slab, n, q0, rows_q, c3, h * hd, hd, hdp, x_s, ld, vec);
  stage_rows(g_slab, n, q0, rows_q, C, h * hd, hd, hdp, g_s, ld, vec);
  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int kn = min(chunk, n - c0);
    if (c0 > 0) __syncthreads();  // every warp is done with the previous chunk
    stage_rows(slab, n, c0, chunk, c3, C + h * hd, hd, hdp, k_s, ld, vec);
    stage_rows(slab, n, c0, chunk, c3, 2 * C + h * hd, hd, hdp, v_s, ld, vec);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
    // the chunk's k and v rows, in place; with the first chunk also q^ from
    // the raw q rows (kept for the VJP) and delta = rowsum(g o) in fp32
    // (zero past n)
    const int nqn = c0 == 0 ? rows_q : 0;
    for (int r = threadIdx.x; r < 2 * nqn + 2 * kn; r += blockDim.x) {
      if (r < nqn) {
        normalize_row(x_s + r * ld, q_s + r * ld, hdp, scale);
      } else if (r < 2 * nqn) {
        const int i = r - nqn;
        float go = 0.f;
        if (i < nq) {
          const bf16* grow = g_s + i * ld;
          const bf16* orow = o_slab + (size_t)(q0 + i) * C + h * hd;
          if (vec) {
            for (int c = 0; c < hd; c += 8) {
              float gv[8], ov[8];
              unpack8(*reinterpret_cast<const uint4*>(grow + c), gv);
              unpack8(*reinterpret_cast<const uint4*>(orow + c), ov);
#pragma unroll
              for (int e = 0; e < 8; ++e) go += gv[e] * ov[e];
            }
          } else {
            for (int c = 0; c < hd; ++c)
              go += __bfloat162float(grow[c]) * __bfloat162float(orow[c]);
          }
        }
        delta_s[i] = go;
      } else {
        const int i = r - 2 * nqn;
        bf16* row = i < kn ? k_s + i * ld : v_s + (i - kn) * ld;
        normalize_row(row, row, hdp, scale);
      }
    }
    __syncthreads();
    if (!active) continue;
    if (c0 == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        dl[half] = delta_s[warp * 16 + mma::acc_row(lane, 2 * half)];
    }

    for (int t0 = 0; t0 < kn; t0 += kSub) {
      // S = Q^ K^T and dP = g V^T over this tile's 32 keys
      float sc[kSTiles][4], dp[kSTiles][4];
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[j][i] = dp[j][i] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kKMax; ++kk) {
        if (kk >= ksteps) break;
        uint32_t aq[4], ag[4];
        mma::ldmatrix_x4(aq, q_s + a_off + kk * 16);
        mma::ldmatrix_x4(ag, g_s + a_off + kk * 16);
#pragma unroll
        for (int j2 = 0; j2 < kSTiles / 2; ++j2) {
          const int at = (t0 + j2 * 16) * ld + kn_off + kk * 16;
          uint32_t bk[4], bv[4];
          mma::ldmatrix_x4(bk, k_s + at);
          mma::ldmatrix_x4(bv, v_s + at);
          mma::mma_bf16(sc[2 * j2], aq, bk[0], bk[1]);
          mma::mma_bf16(sc[2 * j2 + 1], aq, bk[2], bk[3]);
          mma::mma_bf16(dp[2 * j2], ag, bv[0], bv[1]);
          mma::mma_bf16(dp[2 * j2 + 1], ag, bv[2], bv[3]);
        }
      }
      // E (masked past n in the tail tile), its row sums, ds = E (dP - delta)
      const bool tail = c0 + t0 + kSub > n;
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float e = expf(__fmul_rn(sc[j][i], scale));
          if (tail && c0 + t0 + j * 8 + mma::acc_col(lane, i) >= n) e = 0.f;
          rsum[i / 2] += e;
          sc[j][i] = e * (dp[j][i] - dl[i / 2]);
        }
      }
      // dq^ += T(ds) K^, T(ds) repacked from the fragments as A fragments
#pragma unroll
      for (int kc = 0; kc < kSub / 16; ++kc) {
        uint32_t a[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * kc + half;
          a[2 * half] = mma::pack_bf16(sc[j][0], sc[j][1]);
          a[2 * half + 1] = mma::pack_bf16(sc[j][2], sc[j][3]);
        }
        const bf16* ks = k_s + (t0 + kc * 16) * ld + vk_off;
#pragma unroll
        for (int d2 = 0; d2 < kKMax; ++d2) {
          if (d2 >= ksteps) break;
          uint32_t bf[4];
          mma::ldmatrix_x4_trans(bf, ks + d2 * 16);
          mma::mma_bf16(acc[2 * d2], a, bf[0], bf[1]);
          mma::mma_bf16(acc[2 * d2 + 1], a, bf[2], bf[3]);
        }
      }
    }
  }
  if (!active) return;

  // rc = c / rowsum(E) over the quad; dq^ = (ds k^) rc; rc and delta to stats
  float rc[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      rsum[half] += __shfl_xor_sync(0xffffffffu, rsum[half], off);
    rc[half] = scale / rsum[half];
    const int row = r0 + mma::acc_row(lane, 2 * half);
    if (lane % 4 == 0 && row < n) {
      const size_t at = (size_t)bh * n + row;
      stats[at] = rc[half];
      stats[(size_t)b_total * heads * n + at] = dl[half];
    }
  }
#pragma unroll
  for (int j = 0; j < kOMax; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] *= rc[i / 2];
  }
  // the pixel-norm VJP of the warp's q rows, in place in x_s, then stored
  bf16* xw = x_s + warp * 16 * ld;
  pixel_norm_vjp_frag<kOMax>(xw, ld, hd, scale, acc);
  __syncwarp();
  store_rows16(xw, ld, dqkv + (size_t)b * n * c3, n, r0, c3, h * hd, hd, vec);
}

// Pass (b): dk and dv from the rc and delta of pass (a). A block owns rows_k
// keys of one (sample, head) and streams the queries in tiles of qtile (32
// or 64) rows. Its first rows_k / 16 warps each sum dk^ of 16 keys, the
// other rows_k / 16 dv^ of the same keys: each warp's sums stay in
// registers, and both recompute S^T = K^ Q^T.
template <int HDB>
__global__ void __launch_bounds__(max_threads<HDB>())
    attn_bwd_dkv_tc_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ gout,
                           const float* __restrict__ stats, bf16* __restrict__ dqkv, int b_total,
                           int n, int heads, int hd, float scale, float sqrt_hd, int rows_k,
                           int qtile, int vec) {
  constexpr int kKMax = HDB / 16;
  constexpr int kOMax = HDB / 8;
  constexpr int kSTiles = kSub / 8;
  const int hdp = padded_hd(hd), ld = hdp + 8, ksteps = hdp / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xk_s = reinterpret_cast<bf16*>(smem_raw);  // [rows_k][ld]: k, then dk
  bf16* xv_s = xk_s + rows_k * ld;                 // [rows_k][ld]: v, then dv
  bf16* k_s = xv_s + rows_k * ld;                  // [rows_k][ld]: k^
  bf16* v_s = k_s + rows_k * ld;                   // [rows_k][ld]: v^
  bf16* qn_s = v_s + rows_k * ld;                  // [qtile][ld]: q^
  bf16* qr_s = qn_s + qtile * ld;                  // [qtile][ld]: T(q^ rc)
  bf16* g_s = qr_s + qtile * ld;                   // [qtile][ld]: g
  bf16* gr_s = g_s + qtile * ld;                   // [qtile][ld]: T(g rc sqrt(hd))
  float* rc_s = reinterpret_cast<float*>(gr_s + qtile * ld);  // [qtile]
  float* delta_s = rc_s + qtile;                              // [qtile]

  const int n_kt = (n + rows_k - 1) / rows_k;
  const int kt = blockIdx.x % n_kt;
  const int bh = blockIdx.x / n_kt;
  const int h = bh % heads;
  const int b = bh / heads;
  const int C = heads * hd;
  const int c3 = 3 * C;
  const bf16* slab = qkv + (size_t)b * n * c3;
  const bf16* g_slab = gout + (size_t)b * n * C;
  const float* rc_g = stats + (size_t)bh * n;
  const float* delta_g = stats + (size_t)b_total * heads * n + (size_t)bh * n;
  const int k0 = kt * rows_k;
  const int nk = min(rows_k, n - k0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nw = rows_k / 16;
  const bool is_dk = warp < nw;     // warp-uniform
  const int kw = is_dk ? warp : warp - nw;
  const int r0 = k0 + kw * 16;      // the warp's first key row
  const bool active = r0 < n;

  const int a_off = (kw * 16 + mma::a_row(lane)) * ld + mma::a_col(lane);
  const int bn_off = mma::bn_row(lane) * ld + mma::bn_col(lane);
  const int bk_off = mma::bk_row(lane) * ld + mma::bk_col(lane);
  const bf16* rhs = is_dk ? qr_s : gr_s;  // the B operand of the warp's sum
  float acc[kOMax][4];
#pragma unroll
  for (int j = 0; j < kOMax; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  }

  stage_rows(slab, n, k0, rows_k, c3, C + h * hd, hd, hdp, xk_s, ld, vec);
  stage_rows(slab, n, k0, rows_k, c3, 2 * C + h * hd, hd, hdp, xv_s, ld, vec);
  for (int q0 = 0; q0 < n; q0 += qtile) {
    const int nqt = min(qtile, n - q0);
    if (q0 > 0) __syncthreads();  // every warp is done with the previous tile
    stage_rows(slab, n, q0, qtile, c3, h * hd, hd, hdp, qn_s, ld, vec);
    stage_rows(g_slab, n, q0, qtile, C, h * hd, hd, hdp, g_s, ld, vec);
    for (int r = threadIdx.x; r < qtile; r += blockDim.x) {
      rc_s[r] = r < nqt ? rc_g[q0 + r] : 0.f;
      delta_s[r] = r < nqt ? delta_g[q0 + r] : 0.f;
    }
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
    // with the first tile k^ and v^ from the raw rows (kept for the VJPs);
    // every tile's q rows (q^ and T(q^ rc)) and g rows (T(g rc sqrt(hd)));
    // rows past n are zero
    const int nkv = q0 == 0 ? 2 * nk : 0;
    for (int r = threadIdx.x; r < nkv + 2 * qtile; r += blockDim.x) {
      if (r < nkv) {
        const int i = r < nk ? r : r - nk;
        normalize_row((r < nk ? xk_s : xv_s) + i * ld, (r < nk ? k_s : v_s) + i * ld, hdp, scale);
      } else if (r < nkv + qtile) {
        const int i = r - nkv;
        normalize_row(qn_s + i * ld, qn_s + i * ld, hdp, scale, qr_s + i * ld, rc_s[i]);
      } else {
        const int i = r - nkv - qtile;
        scale_row(g_s + i * ld, gr_s + i * ld, hdp, rc_s[i] * sqrt_hd);
      }
    }
    __syncthreads();
    if (!active) continue;

    for (int s0 = 0; s0 < nqt; s0 += kSub) {
      // S^T = K^ Q^T (both kinds of warp) and dP^T = V^ g^T (dk warps)
      float st[kSTiles][4], dpt[kSTiles][4];
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kKMax; ++kk) {
        if (kk >= ksteps) break;
        uint32_t ak[4];
        mma::ldmatrix_x4(ak, k_s + a_off + kk * 16);
#pragma unroll
        for (int j2 = 0; j2 < kSTiles / 2; ++j2) {
          uint32_t bq[4];
          mma::ldmatrix_x4(bq, qn_s + (s0 + j2 * 16) * ld + bn_off + kk * 16);
          mma::mma_bf16(st[2 * j2], ak, bq[0], bq[1]);
          mma::mma_bf16(st[2 * j2 + 1], ak, bq[2], bq[3]);
        }
        if (is_dk) {
          uint32_t av[4];
          mma::ldmatrix_x4(av, v_s + a_off + kk * 16);
#pragma unroll
          for (int j2 = 0; j2 < kSTiles / 2; ++j2) {
            uint32_t bg[4];
            mma::ldmatrix_x4(bg, g_s + (s0 + j2 * 16) * ld + bn_off + kk * 16);
            mma::mma_bf16(dpt[2 * j2], av, bg[0], bg[1]);
            mma::mma_bf16(dpt[2 * j2 + 1], av, bg[2], bg[3]);
          }
        }
      }
      // E^T masked past n; dk warps: ds^T = E^T (dP^T - delta); dv warps: E^T
      const bool tail = q0 + s0 + kSub > n;
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = s0 + j * 8 + mma::acc_col(lane, i);
          float e = expf(__fmul_rn(st[j][i], scale));
          if (tail && q0 + qi >= n) e = 0.f;
          st[j][i] = is_dk ? e * (dpt[j][i] - delta_s[qi]) : e;
        }
      }
      // dk^ += T(ds^T) T(q^ rc), or dv^ += T(E^T) T(g rc sqrt(hd))
#pragma unroll
      for (int kc = 0; kc < kSub / 16; ++kc) {
        uint32_t a[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * kc + half;
          a[2 * half] = mma::pack_bf16(st[j][0], st[j][1]);
          a[2 * half + 1] = mma::pack_bf16(st[j][2], st[j][3]);
        }
        const bf16* bs = rhs + (s0 + kc * 16) * ld + bk_off;
#pragma unroll
        for (int d2 = 0; d2 < kKMax; ++d2) {
          if (d2 >= ksteps) break;
          uint32_t bf[4];
          mma::ldmatrix_x4_trans(bf, bs + d2 * 16);
          mma::mma_bf16(acc[2 * d2], a, bf[0], bf[1]);
          mma::mma_bf16(acc[2 * d2 + 1], a, bf[2], bf[3]);
        }
      }
    }
  }
  if (!active) return;
  // the pixel-norm VJP of the warp's k or v rows, in place in their raw
  // rows (which no other warp reads), then stored
  bf16* xw = (is_dk ? xk_s : xv_s) + kw * 16 * ld;
  pixel_norm_vjp_frag<kOMax>(xw, ld, hd, scale, acc);
  __syncwarp();
  store_rows16(xw, ld, dqkv + (size_t)b * n * c3, n, r0, c3, (is_dk ? C : 2 * C) + h * hd, hd,
               vec);
}

template <int HDB>
cudaError_t launch(const void* qkv, const void* g, const void* o, void* dqkv, float* stats, int b,
                   int n, int heads, int hd, float scale, float sqrt_hd, bool vec,
                   cudaStream_t stream) {
  const size_t row_bytes = sizeof(bf16) * (size_t)(padded_hd(hd) + 8);
  // pass (a): as many query rows as max_threads allows (16 per warp), so
  // that each staged key serves as many queries, or 64 where 128 do not fit
  // (hd > 192). Above hd 64 the registers already hold an SM to one block:
  // the largest chunk.
  const size_t budget = HDB <= 64 ? kTwoPerSm : kOnePerSm;
  int rows_q = block_rows(n, max_threads<HDB>() / 2), chunk = 0;
  size_t smem_dq = pick_chunk(n, hd, 3 * rows_q, 2, sizeof(float) * rows_q, budget, &chunk);
  if (smem_dq == 0 && rows_q > 64) {
    rows_q = 64;
    smem_dq = pick_chunk(n, hd, 3 * rows_q, 2, sizeof(float) * rows_q, budget, &chunk);
  }
  // pass (b): 64 keys (4 + 4 warps) at small head dims, 32 (2 + 2) above;
  // query tiles of 64 rows where two blocks then fit on an SM, else of 32
  const int rows_k = block_rows(n, HDB <= 64 ? 64 : 32);
  auto dkv_bytes = [&](int qt) {
    return row_bytes * (4 * rows_k + 4 * qt) + 2 * sizeof(float) * qt;
  };
  const int qtile = dkv_bytes(64) <= (size_t)kTwoPerSm ? 64 : 32;
  const size_t smem_dkv = dkv_bytes(qtile);
  if (smem_dq == 0 || smem_dkv > (size_t)kOnePerSm) return cudaErrorInvalidConfiguration;
  auto dq = attn_bwd_dq_tc_kernel<HDB>;
  auto dkv = attn_bwd_dkv_tc_kernel<HDB>;
  cudaError_t err =
      cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  if (err != cudaSuccess) return err;
  const long long blocks_q = (long long)b * heads * ((n + rows_q - 1) / rows_q);
  const long long blocks_k = (long long)b * heads * ((n + rows_k - 1) / rows_k);
  if (blocks_q > 0x7fffffffLL || blocks_k > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const bf16* qkv_t = static_cast<const bf16*>(qkv);
  const bf16* g_t = static_cast<const bf16*>(g);
  bf16* dqkv_t = static_cast<bf16*>(dqkv);
  dq<<<(unsigned)blocks_q, 2 * rows_q, smem_dq, stream>>>(
      qkv_t, g_t, static_cast<const bf16*>(o), dqkv_t, stats, b, n, heads, hd, scale, rows_q, chunk,
      vec ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv<<<(unsigned)blocks_k, 4 * rows_k, smem_dkv, stream>>>(
      qkv_t, g_t, stats, dqkv_t, b, n, heads, hd, scale, sqrt_hd, rows_k, qtile, vec ? 1 : 0);
  return cudaGetLastError();
}

inline cudaError_t dispatch(const void* qkv, const void* g, const void* o, void* dqkv, float* stats,
                            int b, int n, int heads, int hd, float scale, float sqrt_hd,
                            cudaStream_t stream) {
  auto at16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = hd % 8 == 0 && at16(qkv) && at16(g) && at16(o) && at16(dqkv);
#define TINYEDM_BWD_TC(HDB) \
  return launch<HDB>(qkv, g, o, dqkv, stats, b, n, heads, hd, scale, sqrt_hd, vec, stream)
  if (hd <= 32) TINYEDM_BWD_TC(32);
  if (hd <= 64) TINYEDM_BWD_TC(64);
  if (hd <= 128) TINYEDM_BWD_TC(128);
  if (hd <= 192) TINYEDM_BWD_TC(192);
  TINYEDM_BWD_TC(256);
#undef TINYEDM_BWD_TC
}

}  // namespace bwd_tc

// ---------------------------------------------------------------------------
// fp32: the products on the CUDA cores
namespace bwd_detail {

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

}  // namespace bwd_detail

// Launches both passes of the backward on `stream` (qkv, dqkv (b, n, 3C); g, o
// (b, n, C); one type T; stats: fp32 scratch of 2 * b * heads * n): bf16 on
// the tensor cores, fp32 on the CUDA cores.
template <typename T>
cudaError_t attention_bwd(const void* qkv, const void* g, const void* o, void* dqkv, float* stats,
                          int b, int n, int heads, int hd, float scale, float sqrt_hd,
                          cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return bwd_tc::dispatch(qkv, g, o, dqkv, stats, b, n, heads, hd, scale, sqrt_hd, stream);
  } else {
    using bwd_detail::launch;
    if (hd <= 32)
      return launch<T, 32>(qkv, g, o, dqkv, stats, b, n, heads, hd, scale, sqrt_hd, stream);
    if (hd <= 64)
      return launch<T, 64>(qkv, g, o, dqkv, stats, b, n, heads, hd, scale, sqrt_hd, stream);
    if (hd <= 128)
      return launch<T, 128>(qkv, g, o, dqkv, stats, b, n, heads, hd, scale, sqrt_hd, stream);
    return launch<T, 256>(qkv, g, o, dqkv, stats, b, n, heads, hd, scale, sqrt_hd, stream);
  }
}

}  // namespace cosine_attention
