// Winograd F(2x2, 3x3) convolution, forward, for Hopper (sm_90a).
//
// Replaces tinyedm_tpu/ops/winograd.py::_winograd_fwd_kernel (:73), reached
// through the pallas_call at :188 (winograd_conv3x3): a stride-1 SAME 3x3
// convolution, NHWC in and out, H and W even.
//
// Function, per 2x2 output tile (r, s) and output channel o, with x padded by
// one pixel of zeros, P[i][j] = x[2r + i - 1][2s + j - 1] (a 4x4 patch of
// each input channel), U = T(G w G^T) of shape (16, Ci, Co) from the wrapper:
//   t[a][j] = (B^T P)[a][j]                  fp32, rows first
//   V[a][b] = T((t B)[a][b])                 fp32 combos, rounded to T
//   M[a][b] = sum_ci V[a][b][ci] U[a b][ci][o]   fp32 sums (16 products)
//   Y[p][q] = sum over (a, b) in order of A^T[p][a] A^T[q][b] M[a][b]
//             (each coefficient +-1 or 0), fp32 planes, then T(Y)
// with B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]] and
// A^T = [[1,1,1,0],[0,1,-1,-1]], the rounding sites and order of winograd.py.
//
// What bounds it on an H100 SXM: its own work, the 16 component products,
// 2 * 16 Ci Co per 2x2 tile, 16/36 of the direct conv's 2 B H W 9 Ci Co that
// the JAX cost estimate declares (winograd.py:184). At the CIFAR-10 widths
// (B 128, 32x32, 256 -> 256) in bf16: 68.7 GFLOP, 0.069 ms at 989 TFLOP/s
// (the direct count: 155 GFLOP, 0.156 ms), against 136 MB of x, U and y
// (0.041 ms) and 0.5 G fp32 transform adds (0.007 ms at 67 TFLOP/s):
// operations. With warp-level mma.sync and the 16 sums of every output in
// registers (128 a thread), one block of 8 warps fills an SM: latency, not
// the tensor cores, bounds the kernel: the staging of x and U, the V
// transform (fp32, CUDA cores, repeated for each 64-channel slice of Co) and
// a barrier per chunk of 16 input channels.
//
// bf16 (tensor cores): V and U are bf16 values that the plain version
// rounds too, so their products on mma.sync.m16n8k16 are exact and only the
// order of the fp32 sums differs. One block of 8 warps owns 32 output tiles
// and 64 output channels; each warp a 16-tile x 16-channel tile of all 16
// components, so M is summed over all of Ci before it is folded, as the
// plain version does. Per chunk of 16 input channels, in bf16 shared memory:
//   - the 4x4 patches of x (masked SAME padding, no padded copy) and
//     U[16][chunk][64 channels] are staged by 16-byte cp.async copies,
//     zero-filled past Ci and Co, two chunks ahead in rings;
//   - V is made one chunk ahead from the staged patches: fp32 B^T
//     combinations, two channels a thread, rounded to bf16 (the plain
//     version's site), stored in the rows ldmatrix reads;
//   - each warp runs 16 components x (ldmatrix of V, ldmatrix.trans of U,
//     two m16n8k16 products); one barrier per chunk.
// Then each thread folds its 16 sums with A^T into the four planes in the
// order of winograd.py:102-128 and the outputs go, rounded, through shared
// memory to 16-byte NHWC stores. The blocks of one tile strip are numbered
// together, so x's patches are read from device memory once and the other
// channel slices find them in L2. Ci or Co off a multiple of 8 takes
// element loads and stores in place of the 16-byte copies.
//
// fp32 (CUDA cores): tensor cores in fp32 would be TF32, about three decimal
// digits, off the 2e-5 gate against the plain version and the direct conv;
// fp32 keeps the first port's kernel: blocks of 16 tiles x 64 channels, V
// and U staged as fp32 in shared memory, the products on gemm::mac_tile.

#include "gemm_common.cuh"
#include "mma_common.cuh"

namespace {

using tinyedm::from_float;
using tinyedm::round_to;
using tinyedm::to_float;

// A^T[p][a]
__device__ __forceinline__ float at(int p, int a) {
  return p == 0 ? (a < 3 ? 1.f : 0.f) : (a == 0 ? 0.f : (a == 1 ? 1.f : -1.f));
}

__device__ __forceinline__ void bt_combos(const float (&p)[4], float (&out)[4]) {
  out[0] = p[0] - p[2];
  out[1] = p[1] + p[2];
  out[2] = p[2] - p[1];
  out[3] = p[1] - p[3];
}

// V[a][b] = (B^T P B)[a][b] in fp32, rows first
__device__ __forceinline__ void transform(const float (&p)[4][4], float (&v)[4][4]) {
  float t[4][4];  // t[a][j] = sum_i B^T[a][i] P[i][j]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float col[4] = {p[0][j], p[1][j], p[2][j], p[3][j]};
    float comb[4];
    bt_combos(col, comb);
#pragma unroll
    for (int a = 0; a < 4; ++a) t[a][j] = comb[a];
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) bt_combos(t[a], v[a]);
}

// planes[p * 2 + q] = sum over (a, b) in order of A^T[p][a] A^T[q][b] m[a * 4 + b]
__device__ __forceinline__ void fold(const float (&m)[16], float (&planes)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) planes[i] = 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float coef = at(p, a) * at(q, b);
          if (coef == 1.f) planes[p * 2 + q] += m[a * 4 + b];
          else if (coef == -1.f) planes[p * 2 + q] -= m[a * 4 + b];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the component products on the tensor cores
namespace tc {

constexpr int kTM = 32;        // output tiles per block
constexpr int kTN = 64;        // output channels per block
constexpr int kCi = 16;        // input channels per chunk: one k16 step
constexpr int kThreads = 256;  // 8 warps: 2 (tiles) x 4 (channels), 16 x 16 each
constexpr int kUStages = 3;    // U ring: staged two chunks ahead
constexpr int kPStages = 2;    // patch ring: staged two chunks ahead, read one ahead
constexpr int kVRow = kCi + 8;  // V row (one tile) stride: 48 bytes
constexpr int kURow = kTN + 8;  // U row (one input channel) stride: 144 bytes
constexpr int kPTile = 16 * kCi + 16;  // one tile's 16 staged pixels: 544 bytes
constexpr int kYRow = kTN + 8;  // output staging row (one tile pixel) stride
constexpr int kVStage = 16 * kTM * kVRow;  // elements: V[16 components][kTM][kVRow]
constexpr int kUStage = 16 * kCi * kURow;  // U[16 components][kCi][kURow]
constexpr int kPStage = kTM * kPTile;      // P[kTM][16 pixels][kCi]
constexpr int kPCopies = kTM * 16 * kCi / 8 / kThreads;  // 8-channel patch runs per thread
constexpr size_t kSmemBytes =
    sizeof(__nv_bfloat16) * (2 * kVStage + kUStages * kUStage + kPStages * kPStage);
static_assert(kTM * kCi / 2 == kThreads, "one (tile, channel pair) per thread in the transform");
static_assert(kTM * 4 * kYRow <= 2 * kVStage, "the output staging fits");
static_assert(kSmemBytes <= 232448, "shared memory");

using bf16 = __nv_bfloat16;

__global__ void __launch_bounds__(kThreads, 1)
    winograd_fwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ u,
                             bf16* __restrict__ y, int batch, int h, int w, int ci, int co,
                             int co_blocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* v_s = reinterpret_cast<bf16*>(smem_raw);  // [2][kVStage]
  bf16* u_s = v_s + 2 * kVStage;                  // [kUStages][kUStage]
  bf16* p_s = u_s + kUStages * kUStage;           // [kPStages][kPStage]
  const int th = h / 2, tw = w / 2;
  const long long tiles = (long long)batch * th * tw;
  // the channel slices of one tile strip are neighbouring blocks
  const long long tile0 = (long long)(blockIdx.x / co_blocks) * kTM;
  const int co0 = (blockIdx.x % co_blocks) * kTN;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;  // the warp's tiles wm*16.. and channels wn*16..
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  // 16-byte copies of x's channel runs (x may be a view at any element offset)
  const bool x_vec = ci % 8 == 0 && aligned(x);
  // 16-byte copies of U rows, 16-byte stores of y
  const bool u_vec = co % 8 == 0 && aligned(u) && aligned(y);

  // the element offset in x of pixel pos (4 i + j: P[i][j]) of tile t, or
  // -1 where it is SAME padding or the tile is past the last
  auto pixel = [&](int t, int pos) -> long long {
    const long long gt = tile0 + t;
    if (gt >= tiles) return -1;
    const int pb = (int)(gt / ((long long)th * tw));
    const int rem = (int)(gt % ((long long)th * tw));
    const int xr = 2 * (rem / tw) + pos / 4 - 1, xc = 2 * (rem % tw) + pos % 4 - 1;
    if (xr < 0 || xr >= h || xc < 0 || xc >= w) return -1;
    return (((long long)pb * h + xr) * w + xc) * ci;
  };
  // This thread's patch runs, the same for every chunk: run i holds channels
  // c0 + 8 seg .. + 8 of pixel tp % 16 of tile tp / 16, for idx = tid + i
  // kThreads, seg = idx % 2, tp = idx / 2; px[i] is the pixel's offset.
  long long px[kPCopies];
#pragma unroll
  for (int i = 0; i < kPCopies; ++i) {
    const int tp = (tid + i * kThreads) / (kCi / 8);
    px[i] = pixel(tp / 16, tp % 16);
  }
  // stage chunk c's 4x4 patches (zeros at the padding and past Ci) into
  // p_s[c % kPStages] as [tile][pixel][channel]
  auto stage_patches = [&](int c) {
    const int c0 = c * kCi;
#pragma unroll
    for (int i = 0; i < kPCopies; ++i) {
      const int idx = tid + i * kThreads;
      const int seg = idx % (kCi / 8), tp = idx / (kCi / 8);
      const int cc = c0 + seg * 8;
      bf16* dst = p_s + (c % kPStages) * kPStage + (tp / 16) * kPTile + (tp % 16) * kCi + seg * 8;
      if (x_vec) {
        const bool ok = px[i] >= 0 && cc < ci;
        mma::cp_async_16(dst, ok ? x + px[i] + cc : x, ok);
      } else {
#pragma unroll 1
        for (int e = 0; e < 8; ++e)
          dst[e] = px[i] >= 0 && cc + e < ci ? x[px[i] + cc + e] : __float2bfloat16_rn(0.f);
      }
    }
  };
  // stage U[16][c0 .. c0 + kCi)[co0 .. co0 + kTN) into u_s[c % kUStages]
  auto stage_u = [&](int c) {
    const int c0 = c * kCi;
    bf16* dst = u_s + (c % kUStages) * kUStage;
    if (u_vec) {
      for (int idx = tid; idx < 16 * kCi * (kTN / 8); idx += kThreads) {
        const int seg = idx % (kTN / 8), k = (idx / (kTN / 8)) % kCi, comp = idx / (kTN / 8 * kCi);
        const int gc = c0 + k, go = co0 + seg * 8;
        const bool ok = gc < ci && go < co;
        mma::cp_async_16(dst + (comp * kCi + k) * kURow + seg * 8,
                         ok ? u + ((size_t)comp * ci + gc) * co + go : u, ok);
      }
    } else {
      for (int idx = tid; idx < 16 * kCi * kTN; idx += kThreads) {
        const int o = idx % kTN, k = (idx / kTN) % kCi, comp = idx / (kTN * kCi);
        const int gc = c0 + k, go = co0 + o;
        dst[(comp * kCi + k) * kURow + o] =
            (gc < ci && go < co) ? u[((size_t)comp * ci + gc) * co + go] : __float2bfloat16_rn(0.f);
      }
    }
  };
  // V of chunk c from its staged patches into v_s[c % 2]: this thread's
  // tile and pair of channels
  const int t_tile = tid / (kCi / 2), t_pair = tid % (kCi / 2);
  auto make_v = [&](int c) {
    const bf16* src = p_s + (c % kPStages) * kPStage + t_tile * kPTile + 2 * t_pair;
    float p0[4][4], p1[4][4], v0[4][4], v1[4][4];
#pragma unroll
    for (int pos = 0; pos < 16; ++pos) {
      const uint32_t pair = *reinterpret_cast<const uint32_t*>(src + pos * kCi);
      p0[pos / 4][pos % 4] = mma::bf16_lo(pair);
      p1[pos / 4][pos % 4] = mma::bf16_hi(pair);
    }
    transform(p0, v0);
    transform(p1, v1);
    bf16* dst = v_s + (c % 2) * kVStage + t_tile * kVRow + 2 * t_pair;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        *reinterpret_cast<uint32_t*>(dst + (a * 4 + b) * kTM * kVRow) =
            mma::pack_bf16(v0[a][b], v1[a][b]);
    }
  };

  float acc[16][2][4];  // per component: two n8 tiles of the warp's 16 x 16
#pragma unroll
  for (int c = 0; c < 16; ++c) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c][nt][i] = 0.f;
    }
  }

  // The pipeline. Iteration c multiplies V(c) by U(c) and makes V(c + 1);
  // it stages patches(c + 2) and U(c + 2) as two cp.async groups, in that
  // order, so that waiting for all but the newest group at the top of
  // iteration c + 1 finds patches(c + 2) and U(c + 1) landed and leaves
  // U(c + 2) in flight. The prologue's groups: {patches(0)}, {patches(1)},
  // {U(0)}, {U(1)}. (Staging the patches a chunk further ahead measured
  // slower: more registers, spills.)
  const int chunks = (ci + kCi - 1) / kCi;
  auto stage = [&](bool patches, int c) {
    if (c < chunks) {
      if (patches) stage_patches(c);
      else stage_u(c);
    }
    mma::cp_async_commit();
  };
  stage(true, 0);
  stage(true, 1);
  stage(false, 0);
  stage(false, 1);
  mma::cp_async_wait<3>();
  __syncthreads();
  make_v(0);
  const int a_off = (wm * 16 + mma::a_row(lane)) * kVRow + mma::a_col(lane);
  const int b_off = mma::bk_row(lane) * kURow + wn * 16 + mma::bk_col(lane);
  for (int c = 0; c < chunks; ++c) {
    mma::cp_async_wait<1>();
    __syncthreads();  // V(c) made, U(c) and patches(c + 1) landed, chunk c - 1's buffers free
    stage(true, c + 2);
    stage(false, c + 2);
    const bf16* vs = v_s + (c % 2) * kVStage + a_off;
    const bf16* us = u_s + (c % kUStages) * kUStage + b_off;
#pragma unroll
    for (int comp = 0; comp < 16; ++comp) {
      uint32_t a[4], b[4];
      mma::ldmatrix_x4(a, vs + comp * kTM * kVRow);
      mma::ldmatrix_x4_trans(b, us + comp * kCi * kURow);
      mma::mma_bf16(acc[comp][0], a, b[0], b[1]);
      mma::mma_bf16(acc[comp][1], a, b[2], b[3]);
    }
    if (c + 1 < chunks) make_v(c + 1);
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // every product has read its operands: v_s is free

  // fold into the four planes, round, and stage as [tile][pixel][channel]
  bf16* y_s = v_s;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float m0[16], m1[16], pl0[4], pl1[4];
#pragma unroll
      for (int comp = 0; comp < 16; ++comp) {
        m0[comp] = acc[comp][nt][half * 2];
        m1[comp] = acc[comp][nt][half * 2 + 1];
      }
      fold(m0, pl0);
      fold(m1, pl1);
      const int tl = wm * 16 + mma::acc_row(lane, half * 2);
      const int col = wn * 16 + nt * 8 + mma::acc_col(lane, 0);
#pragma unroll
      for (int pq = 0; pq < 4; ++pq)
        *reinterpret_cast<uint32_t*>(y_s + (tl * 4 + pq) * kYRow + col) = mma::pack_bf16(pl0[pq], pl1[pq]);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kTM * 4 * (kTN / 8); idx += kThreads) {
    const int seg = idx % (kTN / 8), row = idx / (kTN / 8);
    const long long gt = tile0 + row / 4;
    const int go = co0 + seg * 8;
    if (gt >= tiles || go >= co) continue;
    const int pq = row % 4;
    const int sb = (int)(gt / ((long long)th * tw));
    const int rem = (int)(gt % ((long long)th * tw));
    const int r = rem / tw, s = rem % tw;
    bf16* dst = y + (((size_t)sb * h + 2 * r + pq / 2) * w + 2 * s + pq % 2) * co + go;
    const bf16* src = y_s + row * kYRow + seg * 8;
    if (u_vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && go + e < co; ++e) dst[e] = src[e];
    }
  }
}

cudaError_t launch(const void* x, const void* u, void* y, int batch, int h, int w, int ci, int co,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(winograd_fwd_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)batch * (h / 2) * (w / 2);
  const int co_blocks = (co + kTN - 1) / kTN;
  const long long blocks = (tiles + kTM - 1) / kTM * co_blocks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  winograd_fwd_bf16_kernel<<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(u), static_cast<bf16*>(y), batch, h, w,
      ci, co, co_blocks);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32: the component products on the CUDA cores (the first port's kernel)
namespace simt {

constexpr int kTiles = 16;  // output tiles per block
constexpr int kCo = 64;     // output channels per block
constexpr int kCi = 16;     // input channels per staged chunk
constexpr int kThreads = 256;
constexpr int kTilesPerThread = kTiles * kCo / kThreads;  // 4
constexpr int kVStride = kTiles + 1;                       // V row (one channel) stride
static_assert(kTiles * kCi == kThreads, "one (tile, channel) pair per thread in the transform");
constexpr size_t kSmemBytes = sizeof(float) * (16 * kCi * kVStride + 16 * kCi * kCo);

template <typename T>
__global__ void __launch_bounds__(kThreads)
    winograd_fwd_kernel(const T* __restrict__ x, const T* __restrict__ u, T* __restrict__ y,
                        int batch, int h, int w, int ci, int co) {
  extern __shared__ float smem[];
  float* v_s = smem;                      // [16 components][kCi][kVStride]: V, rounded
  float* u_s = v_s + 16 * kCi * kVStride;  // [16 components][kCi][kCo]: U
  const int th = h / 2, tw = w / 2;
  const long long tiles = (long long)batch * th * tw;
  const long long tile0 = (long long)blockIdx.x * kTiles;
  const int co0 = blockIdx.y * kCo;
  const int tid = threadIdx.x;
  // transform: this thread's (tile, input channel)
  const int t_tile = tid / kCi, t_ci = tid % kCi;
  // products: this thread's output channel and first tile
  const int p_co = tid % kCo, p_tile0 = (tid / kCo) * kTilesPerThread;

  int pb = 0, pr = 0, ps = 0;  // the transform tile's sample, tile row and column
  const bool t_valid = tile0 + t_tile < tiles;
  if (t_valid) {
    const long long gt = tile0 + t_tile;
    pb = (int)(gt / ((long long)th * tw));
    const int rem = (int)(gt % ((long long)th * tw));
    pr = rem / tw;
    ps = rem % tw;
  }

  float acc[16][1][kTilesPerThread];  // per component: mac_tile's 1 x 4 tile
#pragma unroll
  for (int c = 0; c < 16; ++c) {
#pragma unroll
    for (int i = 0; i < kTilesPerThread; ++i) acc[c][0][i] = 0.f;
  }

  for (int c0 = 0; c0 < ci; c0 += kCi) {
    __syncthreads();  // the previous chunk's v_s and u_s are consumed
    // 1-2. V for (t_tile, c0 + t_ci)
    const int c = c0 + t_ci;
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int xr = 2 * pr + i - 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int xc = 2 * ps + j - 1;
        p[i][j] = (t_valid && c < ci && xr >= 0 && xr < h && xc >= 0 && xc < w)
                      ? to_float(x[(((size_t)pb * h + xr) * w + xc) * ci + c])
                      : 0.f;
      }
    }
    float v[4][4];
    transform(p, v);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        v_s[((a * 4 + b) * kCi + t_ci) * kVStride + t_tile] = round_to<T>(v[a][b]);
    }
    // 3. U[component][c0 .. c0 + kCi)[co0 .. co0 + kCo)
    for (int idx = tid; idx < 16 * kCi * kCo; idx += kThreads) {
      const int o = idx % kCo, k = (idx / kCo) % kCi, comp = idx / (kCo * kCi);
      const int gc = c0 + k, go = co0 + o;
      u_s[idx] = (gc < ci && go < co) ? to_float(u[((size_t)comp * ci + gc) * co + go]) : 0.f;
    }
    __syncthreads();
    // 4. the 16 component products over this chunk
    const int depth = min(kCi, ci - c0);
#pragma unroll
    for (int comp = 0; comp < 16; ++comp) {
      gemm::mac_tile<1, kTilesPerThread>(acc[comp], u_s + comp * kCi * kCo, kCo, p_co, 0,
                                         v_s + comp * kCi * kVStride, kVStride, p_tile0, 1, depth);
    }
  }

  // fold with A^T into the four planes, in winograd.py's order, and write
  const int o = co0 + p_co;
  if (o >= co) return;
#pragma unroll
  for (int i = 0; i < kTilesPerThread; ++i) {
    const long long gt = tile0 + p_tile0 + i;
    if (gt >= tiles) break;
    float m[16], planes[4];
#pragma unroll
    for (int comp = 0; comp < 16; ++comp) m[comp] = acc[comp][0][i];
    fold(m, planes);
    const int sb = (int)(gt / ((long long)th * tw));
    const int rem = (int)(gt % ((long long)th * tw));
    const int r = rem / tw, s = rem % tw;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int q = 0; q < 2; ++q)
        y[(((size_t)sb * h + 2 * r + p) * w + 2 * s + q) * co + o] = from_float<T>(planes[p * 2 + q]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* u, void* y, int batch, int h, int w, int ci, int co,
                   cudaStream_t stream) {
  auto kernel = winograd_fwd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)batch * (h / 2) * (w / 2);
  const long long blocks = (tiles + kTiles - 1) / kTiles;
  const int co_blocks = (co + kCo - 1) / kCo;
  if (blocks > 0x7fffffffLL || co_blocks > 65535) return cudaErrorInvalidConfiguration;
  kernel<<<dim3((unsigned)blocks, (unsigned)co_blocks), kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(u), static_cast<T*>(y), batch, h, w, ci, co);
  return cudaGetLastError();
}

}  // namespace simt

}  // namespace

// x: (batch, h, w, ci) contiguous, h and w even; u: (16, ci, co) contiguous,
// the transformed weights G w G^T rounded to the type; y: (batch, h, w, co)
// contiguous; all of one type: bf16 when is_bf16 (tensor cores), else fp32
// (CUDA cores). Launches on `stream` without synchronizing; returns the
// launch's cudaError_t (0 on success).
extern "C" int winograd_fwd(const void* x, const void* u, void* y, int batch, int h, int w, int ci,
                            int co, int is_bf16, void* stream) {
  if (batch < 1 || h < 2 || w < 2 || h % 2 || w % 2 || ci < 1 || co < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)tc::launch(x, u, y, batch, h, w, ci, co, s);
  return (int)simt::launch<float>(x, u, y, batch, h, w, ci, co, s);
}
