// Device code of the fused pixel-norm + cosine attention forward, shared by
// cosine_attention_fwd.cu (its notes describe the kernels) and the
// whole-block attention (attention_block_{fwd,bwd}.cu), whose attention core
// it is: fwd_tc, bf16 on the tensor cores; fwd_detail, the CUDA-core kernel
// for fp32.
#pragma once

#include <type_traits>

#include "cosine_attention_common.cuh"
#include "cosine_attention_tc.cuh"

namespace cosine_attention {

// ---------------------------------------------------------------------------
// bf16: the products on the tensor cores
namespace fwd_tc {

using namespace tc_common;

constexpr int kKeyTile = 64;  // keys per S tile of a warp

// HDB: the head-dim bucket (a multiple of 16) that sizes the register arrays;
// the loops run over hd rounded up to 16 only (hdp), never the bucket.
// A block of rows_q / 16 warps owns rows_q query rows of one (sample, head),
// 16 per warp; keys come in chunks of `chunk` rows (a multiple of 64).
template <int HDB>
__global__ void __launch_bounds__(max_threads<HDB>())
    cosine_attention_fwd_tc_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int n,
                                   int heads, int hd, float scale, int rows_q, int chunk,
                                   int vec) {
  constexpr int kKMax = HDB / 16;  // k16 steps of q k^T (and 16-column pieces of o)
  constexpr int kOMax = HDB / 8;   // n8 tiles of the output
  constexpr int kSTiles = kKeyTile / 8;
  constexpr bool kQRegs = HDB <= 128;  // Q fragments in registers (else from shared memory)
  const int hdp = padded_hd(hd), ld = hdp + 8, ksteps = hdp / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [rows_q][ld]
  bf16* k_s = q_s + rows_q * ld;                  // [chunk][ld]
  bf16* v_s = k_s + chunk * ld;                   // [chunk][ld]

  const int n_qt = (n + rows_q - 1) / rows_q;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int h = bh % heads;
  const int b = bh / heads;
  const int C = heads * hd;
  const int c3 = 3 * C;
  const bf16* slab = qkv + (size_t)b * n * c3;
  const int q0 = qt * rows_q;
  const int nq = min(rows_q, n - q0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = q0 + warp * 16;  // the warp's first query row
  const bool active = r0 < n;

  const bf16* qw = q_s + (warp * 16 + mma::a_row(lane)) * ld + mma::a_col(lane);
  const int kn_off = mma::bn_row(lane) * ld + mma::bn_col(lane);
  const int vk_off = mma::bk_row(lane) * ld + mma::bk_col(lane);
  uint32_t qf[kQRegs ? kKMax : 1][4];
  float o[kOMax][4];
#pragma unroll
  for (int j = 0; j < kOMax; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
  }
  float rsum[2] = {0.f, 0.f};  // rows g and g + 8: sums of the unrounded E

  stage_rows(slab, n, q0, rows_q, c3, h * hd, hd, hdp, q_s, ld, vec);
  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int kn = min(chunk, n - c0);
    if (c0 > 0) __syncthreads();  // every warp is done with the previous chunk
    stage_rows(slab, n, c0, chunk, c3, C + h * hd, hd, hdp, k_s, ld, vec);
    stage_rows(slab, n, c0, chunk, c3, 2 * C + h * hd, hd, hdp, v_s, ld, vec);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
    // normalize the chunk's k and v rows (and, with the first, the q rows)
    const int nqn = c0 == 0 ? nq : 0;
    for (int r = threadIdx.x; r < nqn + 2 * kn; r += blockDim.x) {
      bf16* row = r < nqn ? q_s + r * ld
                          : (r < nqn + kn ? k_s + (r - nqn) * ld : v_s + (r - nqn - kn) * ld);
      normalize_row(row, row, hdp, scale);
    }
    __syncthreads();
    if (!active) continue;
    if (kQRegs && c0 == 0) {
#pragma unroll
      for (int kk = 0; kk < (kQRegs ? kKMax : 1); ++kk) {
        if (kk < ksteps) mma::ldmatrix_x4(qf[kk], qw + kk * 16);
      }
    }

    for (int t0 = 0; t0 < kn; t0 += kKeyTile) {
      // S = Q^ K^T over this tile's 64 keys
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
          mma::ldmatrix_x4(bf, ks + j2 * 16 * ld + kk * 16);
          mma::mma_bf16(sc[2 * j2], a, bf[0], bf[1]);
          mma::mma_bf16(sc[2 * j2 + 1], a, bf[2], bf[3]);
        }
      }
      // E = exp(L), masked past n in the tail tile only; row sums of E
      const bool tail = c0 + t0 + kKeyTile > n;
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float e = expf(__fmul_rn(sc[j][i], scale));
          if (tail && c0 + t0 + j * 8 + mma::acc_col(lane, i) >= n) e = 0.f;
          sc[j][i] = e;
          rsum[i / 2] += e;
        }
      }
      // O += T(E) V^, T(E) repacked from the S fragments as A fragments
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
  }
  if (!active) return;

  // the quad's four lanes hold one row's keys: the row sums, then o / s once,
  // rounded, through the warp's own rows of q_s to 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], off);
    inv[r] = 1.f / rsum[r];
  }
  __syncwarp();  // the warp is done reading its q_s rows
  bf16* ow = q_s + warp * 16 * ld;
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
  store_rows16(ow, ld, out + (size_t)b * n * C, n, r0, C, h * hd, hd, vec);
}

template <int HDB>
cudaError_t launch(const void* qkv, void* out, int b, int n, int heads, int hd, float scale,
                   bool vec, cudaStream_t stream) {
  // as many query rows as max_threads allows (16 per warp), so that each
  // staged key serves as many queries. Above hd 64 the registers already
  // hold an SM to one block: the largest chunk.
  const int rows_q = block_rows(n, max_threads<HDB>() / 2);
  int chunk = 0;
  const size_t smem =
      pick_chunk(n, hd, rows_q, 2, 0, HDB <= 64 ? kTwoPerSm : kOnePerSm, &chunk);
  if (smem == 0) return cudaErrorInvalidConfiguration;
  auto kernel = cosine_attention_fwd_tc_kernel<HDB>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)b * heads * ((n + rows_q - 1) / rows_q);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, 2 * rows_q, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), n, heads, hd, scale, rows_q, chunk,
      vec ? 1 : 0);
  return cudaGetLastError();
}

inline cudaError_t dispatch(const void* qkv, void* out, int b, int n, int heads, int hd,
                            float scale, cudaStream_t stream) {
  auto at16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = hd % 8 == 0 && at16(qkv) && at16(out);
#define TINYEDM_FWD_TC(HDB) return launch<HDB>(qkv, out, b, n, heads, hd, scale, vec, stream)
  if (hd <= 32) TINYEDM_FWD_TC(32);
  if (hd <= 64) TINYEDM_FWD_TC(64);
  if (hd <= 128) TINYEDM_FWD_TC(128);
  if (hd <= 192) TINYEDM_FWD_TC(192);
  TINYEDM_FWD_TC(256);
#undef TINYEDM_FWD_TC
}

}  // namespace fwd_tc

// ---------------------------------------------------------------------------
// fp32: the products on the CUDA cores
namespace fwd_detail {

constexpr int kRowsQ = 32;  // query rows per block
constexpr int kRowsK = 64;  // key/value rows per tile

// HDMAX: the head-dim bucket (32, 64, 128 or 256) that fixes how many output
// channels each thread accumulates in registers; channels hd..HDMAX-1 idle.
template <typename T, int HDMAX>
__global__ void __launch_bounds__(kThreads)
    cosine_attention_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int n, int heads,
                                int hd, float scale) {
  constexpr int kLogitRows = kRowsQ * kRowsK / kThreads;  // logits per thread per tile
  constexpr int kLogitStep = kThreads / kRowsK;           // row step between them
  constexpr int kPer = kRowsQ * HDMAX / kThreads;         // outputs per thread
  constexpr int kRowStep = kThreads / HDMAX;              // row step between them
  static_assert(kLogitRows * kLogitStep == kRowsQ, "logit tiling");
  static_assert(kPer * kRowStep == kRowsQ, "output tiling");

  extern __shared__ float smem[];
  const int ks = hd + 1;  // padded k/v row stride: a warp reading one column hits 32 banks
  float* q_s = smem;                     // kRowsQ x hd
  float* k_s = q_s + kRowsQ * hd;        // kRowsK x ks
  float* v_s = k_s + kRowsK * ks;        // kRowsK x ks
  float* p_s = v_s + kRowsK * ks;        // kRowsQ x kRowsK, T(E)
  float* sum_s = p_s + kRowsQ * kRowsK;  // 2 x kRowsQ partial row sums

  const int n_qt = (n + kRowsQ - 1) / kRowsQ;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int h = bh % heads;
  const int b = bh / heads;
  const int C = heads * hd;
  const int c3 = 3 * C;
  const T* slab = qkv + (size_t)b * n * c3;
  const int q0 = qt * kRowsQ;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int lj = tid % kRowsK;   // logits: this thread's key within the tile
  const int li0 = tid / kRowsK;  //         and its first query row
  const int pd = tid % HDMAX;    // output: this thread's channel
  const int pi0 = tid / HDMAX;   //         and its first query row

  load_normalized<T>(slab, n, q0, kRowsQ, c3, h * hd, hd, scale, q_s, hd);

  float acc[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) acc[r] = 0.f;
  float rsum[kLogitRows];
#pragma unroll
  for (int r = 0; r < kLogitRows; ++r) rsum[r] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kRowsK) {
    __syncthreads();  // the previous tile's k_s, v_s and p_s are consumed
    load_normalized<T>(slab, n, k0, kRowsK, c3, C + h * hd, hd, scale, k_s, ks);
    load_normalized<T>(slab, n, k0, kRowsK, c3, 2 * C + h * hd, hd, scale, v_s, ks);
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
      const float e = valid ? expf(l[r] * scale) : 0.f;
      rsum[r] += e;
      p_s[(li0 + kLogitStep * r) * kRowsK + lj] = round_to<T>(e);
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

  // row sums: a warp holds 32 of a tile's keys for its rows; the two warps
  // that share rows (keys 0-31 and 32-63) meet in shared memory
#pragma unroll
  for (int r = 0; r < kLogitRows; ++r) {
    for (int o = 16; o > 0; o >>= 1) rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], o);
  }
  if (lane == 0) {
    const int half = (tid / 32) & 1;
#pragma unroll
    for (int r = 0; r < kLogitRows; ++r) sum_s[half * kRowsQ + li0 + kLogitStep * r] = rsum[r];
  }
  __syncthreads();

  if (pd < hd) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = pi0 + kRowStep * r;
      const int row = q0 + i;
      if (row < n) {
        const float s = sum_s[i] + sum_s[kRowsQ + i];
        out[((size_t)b * n + row) * C + h * hd + pd] = from_float<T>(acc[r] / s);
      }
    }
  }
}

template <typename T, int HDMAX>
cudaError_t launch(const void* qkv, void* out, int b, int n, int heads, int hd, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kRowsQ * hd + 2 * (size_t)kRowsK * (hd + 1) + kRowsQ * kRowsK +
                       2 * kRowsQ);
  auto kernel = cosine_attention_fwd_kernel<T, HDMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)b * heads * ((n + kRowsQ - 1) / kRowsQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(static_cast<const T*>(qkv),
                                                         static_cast<T*>(out), n, heads, hd, scale);
  return cudaGetLastError();
}

}  // namespace fwd_detail

// Launches the forward on `stream` (qkv (b, n, 3C), out (b, n, C), one type
// T): bf16 on the tensor cores, fp32 on the CUDA cores.
template <typename T>
cudaError_t attention_fwd(const void* qkv, void* out, int b, int n, int heads, int hd, float scale,
                          cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return fwd_tc::dispatch(qkv, out, b, n, heads, hd, scale, stream);
  } else {
    if (hd <= 32) return fwd_detail::launch<T, 32>(qkv, out, b, n, heads, hd, scale, stream);
    if (hd <= 64) return fwd_detail::launch<T, 64>(qkv, out, b, n, heads, hd, scale, stream);
    if (hd <= 128) return fwd_detail::launch<T, 128>(qkv, out, b, n, heads, hd, scale, stream);
    return fwd_detail::launch<T, 256>(qkv, out, b, n, heads, hd, scale, stream);
  }
}

}  // namespace cosine_attention
