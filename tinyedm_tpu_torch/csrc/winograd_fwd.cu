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
// operations.
//
// Design: one block per strip of 16 output tiles and slice of 64 output
// channels, 256 threads. For each chunk of 16 input channels it
//   1. builds the B^T combinations of its tiles' 4x4 patches in fp32, one
//      (tile, channel) per thread, masking the SAME padding (no padded copy);
//   2. stores V rounded to T in shared memory, component-major;
//   3. stages the chunk of U for its 64 channels;
//   4. runs the 16 component products on gemm::mac_tile, each thread holding
//      the 16 fp32 sums of 4 tiles for one output channel in registers.
// After the last chunk each thread folds its sums with A^T into the four
// planes in the order of winograd.py:102-128 and writes the 2x2 outputs of
// its tiles, NHWC. Every transform stays on chip; device memory sees x (each
// patch element read by up to four tiles and by every channel slice, mostly
// from L2), U and y. CUDA-core fp32 products; tensor cores are later work.

#include "gemm_common.cuh"

namespace {

using tinyedm::from_float;
using tinyedm::round_to;
using tinyedm::to_float;

constexpr int kTiles = 16;  // output tiles per block
constexpr int kCo = 64;     // output channels per block
constexpr int kCi = 16;     // input channels per staged chunk
constexpr int kThreads = 256;
constexpr int kTilesPerThread = kTiles * kCo / kThreads;  // 4
constexpr int kVStride = kTiles + 1;                       // V row (one channel) stride
static_assert(kTiles * kCi == kThreads, "one (tile, channel) pair per thread in the transform");
constexpr size_t kSmemBytes = sizeof(float) * (16 * kCi * kVStride + 16 * kCi * kCo);

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
    float v[4][4];
    if (t_valid && c < ci) {
      float t[4][4];  // t[a][j] = sum_i B^T[a][i] P[i][j]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float col[4];
        const int xc = 2 * ps + j - 1;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int xr = 2 * pr + i - 1;
          col[i] = (xr >= 0 && xr < h && xc >= 0 && xc < w)
                       ? to_float(x[(((size_t)pb * h + xr) * w + xc) * ci + c])
                       : 0.f;
        }
        float comb[4];
        bt_combos(col, comb);
#pragma unroll
        for (int a = 0; a < 4; ++a) t[a][j] = comb[a];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) bt_combos(t[a], v[a]);
    } else {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) v[a][b] = 0.f;
      }
    }
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
    float planes[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float m = acc[a * 4 + b][0][i];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float coef = at(p, a) * at(q, b);
            if (coef == 1.f) planes[p * 2 + q] += m;
            else if (coef == -1.f) planes[p * 2 + q] -= m;
          }
        }
      }
    }
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

}  // namespace

// x: (batch, h, w, ci) contiguous, h and w even; u: (16, ci, co) contiguous,
// the transformed weights G w G^T rounded to the type; y: (batch, h, w, co)
// contiguous; all of one type: bf16 when is_bf16, else fp32. Launches on
// `stream` without synchronizing; returns the launch's cudaError_t (0 on
// success).
extern "C" int winograd_fwd(const void* x, const void* u, void* y, int batch, int h, int w, int ci,
                            int co, int is_bf16, void* stream) {
  if (batch < 1 || h < 2 || w < 2 || h % 2 || w % 2 || ci < 1 || co < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch<__nv_bfloat16>(x, u, y, batch, h, w, ci, co, s);
  return (int)launch<float>(x, u, y, batch, h, w, ci, co, s);
}
