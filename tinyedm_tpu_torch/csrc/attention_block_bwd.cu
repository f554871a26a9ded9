// Whole-block cosine attention, backward, for Hopper (sm_90a).
//
// Replaces tinyedm_tpu/ops/fused_attention.py::_attn_block_bwd_kernel (:461),
// reached through the pallas_call at :637 (_block_bwd_impl), the VJP of
// attention_block (CosineAttention(fused="block")).
//
// Function, on x (b, n, C), Wqkv (C, 3C), Wout (C, C) and the output
// cotangent g (b, n, C), all of one type T; ts = T(t s) = T(0.5/sqrt(0.5)):
//   qkv, y   recomputed as the forward does (attention_block_fwd.cu)
//   gout   = T(g ts)
//   dWout  = y^T gout                        fp32, summed over all b n rows
//   dy     = T(gout Wout^T)
//   dqkv   = cosine_attention_bwd(qkv, dy, y) the fused backward of rows 3-4,
//                                            given the rounded y as its o
//   dWqkv  = x^T dqkv                        fp32, summed over all b n rows
//   dx     = T(T(dqkv Wqkv^T) + gout)
//
// What bounds it on an H100 SXM: at the CIFAR-10 training widths (b 256,
// n 256, C 256, 4 heads) in bf16 the function reads x and g and writes dx,
// 101 MB, plus 1.5 MB of weights and fp32 weight gradients, against
// 3 x 2 b n C 4C + 10 b n^2 C = 146 GFLOP of products: operations, 0.148 ms
// at 989 TFLOP/s (bytes 0.030 ms at 3.35 TB/s).
//
// Design: the TPU kernel keeps the chunk's qkv, y, dy and dqkv in VMEM and
// adds the weight gradients into one fp32 VMEM block along its in-order grid
// (:468-471, :496, :515). CUDA blocks run in no order, so:
//   - qkv, y, dy and dqkv pass through device memory, as in the forward;
//   - the two weight gradients are deterministic split reductions, not fp32
//     atomics (as the fused and flash backward kernels chose): a GEMM writes
//     one fp32 (C, N) partial per range of rows into `partials`, then
//     gemm::reduce_partials sums the `splits` partials in a fixed order.
// Launches on one stream: the qkv GEMM, the attention forward core, the dy
// GEMM (g scaled by ts and rounded as it is staged), the attention backward
// core (two passes), the dx GEMM (+ gout in its epilogue), then per weight a
// partial GEMM and its reduction. Scratch, allocated by the wrapper: qkv and
// dqkv (b, n, 3C), y and dy (b, n, C) in T; stats 2 b heads n fp32; partials
// splits x C x 3C fp32, one split per 1024 rows up to 64 (50.3 MB at C = 256
// and b n = 65536).
//
// In bf16 the attention core runs on the tensor cores (rows 3-4's kernels,
// cosine_attention_bwd.cuh) and so do the five GEMMs (gemm_tc.cuh:
// mma.sync.m16n8k16, operands staged by cp.async and read by ldmatrix,
// tiles of 128 columns and 128 or 64 rows). fp32 keeps gemm_common.cuh
// (tensor cores in fp32 would be TF32).

#include "cosine_attention_bwd.cuh"
#include "cosine_attention_fwd.cuh"
#include "gemm_tc.cuh"

namespace {

struct Scratch {
  void* qkv;
  void* y;
  void* dy;
  void* dqkv;
  float* stats;
  float* partials;
};

template <typename T>
cudaError_t run(const void* x, const void* wqkv, const void* wout, const void* g, void* dx,
                float* dwqkv, float* dwout, const Scratch& s, int splits, int b, int n, int heads,
                int hd, float scale, float sqrt_hd, float ts, cudaStream_t stream) {
  const int c = heads * hd, m = b * n;
#define CHECK(call)                          \
  do {                                       \
    const cudaError_t e_ = (call);           \
    if (e_ != cudaSuccess) return e_;        \
  } while (0)
  // recompute the forward's qkv and y
  CHECK((gemm_tc::product<T, false, false, gemm::kRound>(x, c, 1.f, wqkv, 3 * c, 1.f, m, 3 * c, c,
                                                         1, s.qkv, nullptr, 0.f, 0.f, stream)));
  CHECK(cosine_attention::attention_fwd<T>(s.qkv, s.y, b, n, heads, hd, scale, stream));
  // dy = T(gout Wout^T), gout = T(g ts) staged from g
  CHECK((gemm_tc::product<T, false, true, gemm::kRound>(g, c, ts, wout, c, 1.f, m, c, c, 1, s.dy,
                                                        nullptr, 0.f, 0.f, stream)));
  CHECK(cosine_attention::attention_bwd<T>(s.qkv, s.dy, s.y, s.dqkv, s.stats, b, n, heads, hd,
                                           scale, sqrt_hd, stream));
  // dx = T(T(dqkv Wqkv^T) + gout)
  CHECK((gemm_tc::product<T, false, true, gemm::kAddScaled>(s.dqkv, 3 * c, 1.f, wqkv, 3 * c, 1.f,
                                                            m, c, 3 * c, 1, dx, g, ts, 0.f,
                                                            stream)));
  // dWout = y^T gout and dWqkv = x^T dqkv, each over all m rows in `splits`
  // fp32 partials summed in order
  CHECK((gemm_tc::product<T, true, false, gemm::kPartial>(s.y, c, 1.f, g, c, ts, c, c, m, splits,
                                                          s.partials, nullptr, 0.f, 0.f, stream)));
  CHECK(gemm::launch_reduce(s.partials, dwout, splits, (long long)c * c, stream));
  CHECK((gemm_tc::product<T, true, false, gemm::kPartial>(x, c, 1.f, s.dqkv, 3 * c, 1.f, c, 3 * c,
                                                          m, splits, s.partials, nullptr, 0.f,
                                                          0.f, stream)));
  CHECK(gemm::launch_reduce(s.partials, dwqkv, splits, 3LL * c * c, stream));
#undef CHECK
  return cudaSuccess;
}

}  // namespace

// x, g, dx: (b, n, C) contiguous; wqkv (C, 3C), wout (C, C) contiguous; all
// of one type: bf16 when is_bf16, else fp32. dwqkv (C, 3C) and dwout (C, C):
// fp32 outputs. Scratch as the note above says: qkv, dqkv (b, n, 3C) and y,
// dy (b, n, C) in the type; stats fp32 2 * b * heads * n; partials fp32
// splits * 3 * C * C. scale = fp32(1/sqrt(hd)), sqrt_hd = fp32(sqrt(hd)),
// ts = the residual's t * s rounded to the type. Launches on `stream`
// without synchronizing; returns the first cudaError_t that is not 0, or 0.
extern "C" int attention_block_bwd(const void* x, const void* wqkv, const void* wout,
                                   const void* g, void* dx, void* dwqkv, void* dwout, void* qkv,
                                   void* y, void* dy, void* dqkv, void* stats, void* partials,
                                   int splits, int b, int n, int heads, int hd, int is_bf16,
                                   float scale, float sqrt_hd, float ts, void* stream) {
  if (b < 1 || n < 1 || heads < 1 || hd < 1 || hd > 256 || splits < 1 ||
      (long long)b * n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s{qkv, y, dy, dqkv, static_cast<float*>(stats), static_cast<float*>(partials)};
  float* dwq = static_cast<float*>(dwqkv);
  float* dwo = static_cast<float*>(dwout);
  if (is_bf16)
    return (int)run<__nv_bfloat16>(x, wqkv, wout, g, dx, dwq, dwo, s, splits, b, n, heads, hd,
                                   scale, sqrt_hd, ts, st);
  return (int)run<float>(x, wqkv, wout, g, dx, dwq, dwo, s, splits, b, n, heads, hd, scale,
                         sqrt_hd, ts, st);
}
