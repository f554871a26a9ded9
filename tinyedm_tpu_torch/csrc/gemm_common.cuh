// A tiled matrix product with fp32 sums, written for the whole-block cosine
// attention (attention_block_{fwd,bwd}.cu) and shared with the Winograd conv
// (winograd_fwd.cu), which runs its 16 component products on mac_tile.
//
//   out[m][n] = epilogue( sum_k A[m][k] B[k][n] )   over k in one split's range
//
// A is (M, K) row-major, or with kTransA the transpose of a (K, M) row-major
// matrix (the weight gradients' X^T); B is (K, N) row-major, or with kTransB
// the transpose of an (N, K) row-major matrix (W^T). Every operand is read in
// its type T, multiplied by a scale and rounded to T as it is staged (a
// scale of 1 leaves it as it is; the backward forms g * T(t s) this way, the
// "gout" of the TPU kernel, without storing it). Products of T-rounded
// operands are exact in fp32 for bf16; sums are fp32. Epilogues:
//   kRound      out = T(acc)
//   kResidual   out = T((x + T(T(acc) - x) * t) * s), each op rounded to T:
//               the mp_add(x, ., t) residual of the block forward
//   kAddScaled  out = T(T(acc) + T(g * scale)): the block backward's dx
//   kPartial    fp32 partial sums of split z at out + z * M * N, for a
//               deterministic split reduction (reduce_partials sums them in
//               a fixed order; no atomics)
//
// What bounds it on an H100: the CUDA cores (67 TFLOP/s fp32 FMA) and shared
// memory reads: each k step of a 64x64 tile reads 8 values per thread for
// 16 FMAs. fp32 runs here (tensor cores in fp32 would be TF32). In bf16
// both block kernels run their GEMMs on the tensor cores, gemm_tc.cuh,
// which shares the epilogues and the split reduction below.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace gemm {

using tinyedm::from_float;
using tinyedm::round_to;
using tinyedm::to_float;

constexpr int kBM = 64;       // output rows per block
constexpr int kBN = 64;       // output columns per block
constexpr int kBK = 16;       // k depth per staged tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPad = 1;       // shared-memory row padding

enum Epilogue { kRound = 0, kResidual = 1, kAddScaled = 2, kPartial = 3 };

// acc[i][j] += sum_{k < depth} a_s[k * a_stride + row0 + i * row_step]
//                             * b_s[k * b_stride + col0 + j * col_step]
// on operands staged in shared memory as fp32, k-major.
template <int R, int CC>
__device__ __forceinline__ void mac_tile(float (&acc)[R][CC], const float* __restrict__ a_s,
                                         int a_stride, int row0, int row_step,
                                         const float* __restrict__ b_s, int b_stride, int col0,
                                         int col_step, int depth) {
  for (int k = 0; k < depth; ++k) {
    float a[R], b[CC];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = a_s[k * a_stride + row0 + i * row_step];
#pragma unroll
    for (int j = 0; j < CC; ++j) b[j] = b_s[k * b_stride + col0 + j * col_step];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < CC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// staged operand value: T(v * scale), as fp32
template <typename T>
__device__ __forceinline__ float stage(const T* p, float scale) {
  return round_to<T>(__fmul_rn(to_float(*p), scale));
}

// The value the epilogue stores (rounded to T, or fp32 for kPartial) for
// the sum v of an output element, x the element of `extra` there
template <typename T, int kEpi>
__device__ __forceinline__ float epilogue(float v, float x, float e0, float e1) {
  if (kEpi == kResidual) {
    const float d = round_to<T>(__fmul_rn(round_to<T>(__fsub_rn(round_to<T>(v), x)), e0));
    return __fmul_rn(round_to<T>(__fadd_rn(x, d)), e1);
  }
  if (kEpi == kAddScaled) return __fadd_rn(round_to<T>(v), round_to<T>(__fmul_rn(x, e0)));
  return v;  // kRound, kPartial
}

// The epilogue of the sum v of output element `at` of the (M, N) output;
// plane: the offset of this split's fp32 partial (kPartial)
template <typename T, int kEpi>
__device__ __forceinline__ void store_out(void* __restrict__ out, const T* __restrict__ extra,
                                          size_t at, size_t plane, float v, float e0, float e1) {
  const bool has_extra = kEpi == kResidual || kEpi == kAddScaled;
  const float r = epilogue<T, kEpi>(v, has_extra ? to_float(extra[at]) : 0.f, e0, e1);
  if (kEpi == kPartial)
    static_cast<float*>(out)[plane + at] = r;
  else
    static_cast<T*>(out)[at] = from_float<T>(r);
}

template <typename T, bool kTransA, bool kTransB, int kEpi>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const T* __restrict__ a, long long lda, float scale_a, const T* __restrict__ b,
                long long ldb, float scale_b, int M, int N, int K, int k_chunk,
                void* __restrict__ out, const T* __restrict__ extra, float e0, float e1) {
  __shared__ float a_s[kBK * (kBM + kPad)];
  __shared__ float b_s[kBK * (kBN + kPad)];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int kb = blockIdx.z * k_chunk;
  const int ke = min(K, kb + k_chunk);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = kb; k0 < ke; k0 += kBK) {
    for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
      // neighbouring threads on neighbouring addresses of the source
      const int m = kTransA ? idx % kBM : idx / kBK;
      const int k = kTransA ? idx / kBM : idx % kBK;
      const int gm = m0 + m, gk = k0 + k;
      float v = 0.f;
      if (gm < M && gk < ke)
        v = stage(kTransA ? a + (size_t)gk * lda + gm : a + (size_t)gm * lda + gk, scale_a);
      a_s[k * (kBM + kPad) + m] = v;
    }
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int n = kTransB ? idx / kBK : idx % kBN;
      const int k = kTransB ? idx % kBK : idx / kBN;
      const int gn = n0 + n, gk = k0 + k;
      float v = 0.f;
      if (gn < N && gk < ke)
        v = stage(kTransB ? b + (size_t)gn * ldb + gk : b + (size_t)gk * ldb + gn, scale_b);
      b_s[k * (kBN + kPad) + n] = v;
    }
    __syncthreads();
    mac_tile<4, 4>(acc, a_s, kBM + kPad, ty, 16, b_s, kBN + kPad, tx, 16, kBK);
    __syncthreads();
  }

  const size_t plane = (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) store_out<T, kEpi>(out, extra, (size_t)gm * N + gn, plane, acc[i][j], e0, e1);
    }
  }
}

// out[i] = sum over z = 0, 1, ..., splits - 1 of partials[z * count + i], in
// that order: the second pass of the split reduction.
__global__ void reduce_partials(const float* __restrict__ partials, float* __restrict__ out,
                                int splits, long long count) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += partials[z * count + i];
    out[i] = s;
  }
}

// out (M, N) contiguous = epilogue(A B) over K, in `splits` ranges of k
// (kPartial writes one (M, N) fp32 partial per range; the other epilogues
// take splits = 1). `extra` is x (kResidual) or g (kAddScaled), (M, N)
// contiguous; e0, e1 are t and s (kResidual) or g's scale (kAddScaled).
template <typename T, bool kTransA, bool kTransB, int kEpi>
cudaError_t launch(const void* a, long long lda, float scale_a, const void* b, long long ldb,
                   float scale_b, int M, int N, int K, int splits, void* out,
                   const void* extra = nullptr, float e0 = 0.f, float e1 = 0.f,
                   cudaStream_t stream = 0) {
  if (M < 1 || N < 1 || K < 1 || splits < 1 || (kEpi != kPartial && splits != 1))
    return cudaErrorInvalidValue;
  const int k_chunk = ((K + splits - 1) / splits + kBK - 1) / kBK * kBK;
  const long long m_tiles = (M + kBM - 1) / kBM, n_tiles = (N + kBN - 1) / kBN;
  if (m_tiles > 0x7fffffffLL || n_tiles > 65535 || splits > 65535)
    return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)m_tiles, (unsigned)n_tiles, (unsigned)splits);
  gemm_kernel<T, kTransA, kTransB, kEpi><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), lda, scale_a, static_cast<const T*>(b), ldb, scale_b, M, N, K,
      k_chunk, out, static_cast<const T*>(extra), e0, e1);
  return cudaGetLastError();
}

inline cudaError_t launch_reduce(const float* partials, float* out, int splits, long long count,
                                 cudaStream_t stream) {
  const long long blocks = std::min<long long>((count + 255) / 256, 4096);
  reduce_partials<<<(unsigned)blocks, 256, 0, stream>>>(partials, out, splits, count);
  return cudaGetLastError();
}

}  // namespace gemm
