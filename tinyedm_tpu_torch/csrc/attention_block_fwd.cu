// Whole-block cosine attention, forward, for Hopper (sm_90a).
//
// Replaces tinyedm_tpu/ops/fused_attention.py::_attn_block_fwd_kernel (:429),
// reached through the pallas_call at :602 (_block_fwd_impl) behind
// attention_block, the route of CosineAttention(fused="block") where
// block_kernel_fits says the TPU kernels fit VMEM.
//
// Function, on x (b, n, C) and the effective weights Wqkv (C, 3C), Wout
// (C, C), all of one type T:
//   qkv = T(x Wqkv)                          fp32 sums
//   y   = cosine_attention(qkv)              the fused forward of rows 1-2
//   out = T(y Wout)                          fp32 sums
//   o   = T((x + T(T(out - x) * t)) * s)     mp_add(x, out, t): t = 0.5,
//                                            s = T(1/sqrt(0.5)), ops in T
//
// What bounds it on an H100 SXM: at the CIFAR-10 widths (b 128, n 256, C 256,
// 4 heads) in bf16 the function reads x and the weights once and writes o
// once, 34 MB, against 2 b n C 4C + 4 b n^2 C = 25.8 GFLOP of products:
// operations, 0.026 ms at 989 TFLOP/s (bytes 0.010 ms at 3.35 TB/s).
//
// Design: on the TPU the batch chunk's qkv stays in VMEM between the three
// steps. Here one sample's qkv at CIFAR-10 width is (256, 768) bf16 = 384 KB,
// more than a block's 227 KB of shared memory, so qkv and y pass through
// device memory (a b = 128 batch's qkv is 50 MB, the size of the L2) in
// three launches on one stream:
//   1. the qkv GEMM (kRound);
//   2. the attention core, the device code of cosine_attention_fwd.cu
//      (cosine_attention_fwd.cuh), not a call into another library;
//   3. the out GEMM with the mp_add residual as its epilogue (kResidual).
// Scratch, allocated by the wrapper: qkv (b, n, 3C) and y (b, n, C) in T.
// In bf16 all three run on the tensor cores: the GEMMs on gemm_tc.cuh
// (mma.sync.m16n8k16, 128 or 64-row tiles by grid size), each k16 step's
// products summed from zero and added to the fp32 sums with one rounded
// add; the core on rows 1-2's kernel. fp32 keeps gemm_common.cuh (tensor
// cores in fp32 would be TF32, which misses the 1e-5 gate).

#include "cosine_attention_fwd.cuh"
#include "gemm_tc.cuh"

namespace {

template <typename T>
cudaError_t run(const void* x, const void* wqkv, const void* wout, void* qkv, void* y, void* out,
                int b, int n, int heads, int hd, float scale, float t, float s,
                cudaStream_t stream) {
  const int c = heads * hd, m = b * n;
  cudaError_t err = gemm_tc::product<T, false, false, gemm::kRound>(
      x, c, 1.f, wqkv, 3 * c, 1.f, m, 3 * c, c, 1, qkv, nullptr, 0.f, 0.f, stream);
  if (err != cudaSuccess) return err;
  err = cosine_attention::attention_fwd<T>(qkv, y, b, n, heads, hd, scale, stream);
  if (err != cudaSuccess) return err;
  return gemm_tc::product<T, false, false, gemm::kResidual>(y, c, 1.f, wout, c, 1.f, m, c, c, 1,
                                                           out, x, t, s, stream);
}

}  // namespace

// x, out: (b, n, C) contiguous; wqkv (C, 3C), wout (C, C) contiguous; qkv
// (b, n, 3C) and y (b, n, C) contiguous scratch; all of one type: bf16 when
// is_bf16, else fp32. C = heads * hd. scale = fp32(1/sqrt(hd)); t and s the
// residual's factors rounded to the type. Launches three kernels on
// `stream` without synchronizing; returns the first cudaError_t that is not
// 0, or 0.
extern "C" int attention_block_fwd(const void* x, const void* wqkv, const void* wout, void* qkv,
                                   void* y, void* out, int b, int n, int heads, int hd,
                                   int is_bf16, float scale, float t, float s, void* stream) {
  if (b < 1 || n < 1 || heads < 1 || hd < 1 || hd > 256 || (long long)b * n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)run<__nv_bfloat16>(x, wqkv, wout, qkv, y, out, b, n, heads, hd, scale, t, s, st);
  return (int)run<float>(x, wqkv, wout, qkv, y, out, b, n, heads, hd, scale, t, s, st);
}
