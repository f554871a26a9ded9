// Fused pixel-norm + cosine attention, forward, for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package, which compute one function:
//   tinyedm_tpu/ops/fused_attention.py::_attn_fwd_kernel (:102), per head,
//     the CIFAR-10 path's n = 256 (16x16) layers;
//   tinyedm_tpu/ops/fused_attention.py::_attn_fwd_kernel_pair (:253), head
//     pairs laid out block-diagonally to fill the TPU's 128-wide matrix unit,
//     the n = 64 (8x8) layers. The pairing is a TPU layout device only, and
//     its scratch (zeroed at program_id 0, reused across an in-order grid)
//     has no counterpart here: every block starts from its own zeros.
//
// Function, per (sample, head), on qkv (b, n, 3C) with channels ordered
// (3, heads, hd), output (b, n, C) with channels (heads, hd):
//   x^ = x / T(1e-4 + |x|_2 / sqrt(hd))   for q, k, v; fp32 norm, the
//        divisor rounded to the input type T, the quotient rounded to T
//   L  = q^ k^T / sqrt(hd)                 fp32 products and sums
//   E  = exp(L)                            no max subtraction: |L| <= 1/sqrt(hd)
//   s  = rowsum(E)                         fp32
//   o  = T( (T(E) v^, fp32 sums) / s )
//
// What bounds it on an H100 SXM: at the CIFAR-10 path's batch of 128 in bf16
// the function reads qkv once and writes o once, 67 MB at n = 256 against
// 8.6 GFLOP of products, 16.8 MB at n = 64 against 0.5 GFLOP: memory-bound,
// about 20 us and 5.0 us at 3.35 TB/s.
//
// Design: one thread block per (sample, head, tile of 32 query rows). The
// tile's normalized q^ is staged in shared memory; key/value rows stream
// through shared memory 64 at a time and are normalized as they arrive. With
// no max subtraction the unnormalized sums add across key tiles without any
// online-softmax rescaling, so the block keeps acc += T(E) v^ and s += E and
// divides once at the end; one loop handles any n with shared memory bounded
// by the tile sizes. Only qkv and o cross device memory (qkv's k/v rows are
// read once per query tile, mostly from L2). This first version multiplies on
// the CUDA cores in fp32; tensor-core products (mma/wgmma), TMA loads and
// keeping k^/v^ resident across query tiles are later work.

#include "cosine_attention_fwd.cuh"

// qkv: (b, n, 3 * heads * hd) contiguous; out: (b, n, heads * hd) contiguous,
// both of one type: bf16 when is_bf16, else fp32. scale = fp32(1/sqrt(hd)).
// Launches on `stream` without synchronizing; returns the cudaError_t of the
// launch (0 on success).
extern "C" int cosine_attention_fwd(const void* qkv, void* out, int b, int n, int heads, int hd,
                                    int is_bf16, float scale, void* stream) {
  if (b < 1 || n < 1 || heads < 1 || hd < 1 || hd > 256) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using cosine_attention::attention_fwd;
  if (is_bf16) return (int)attention_fwd<__nv_bfloat16>(qkv, out, b, n, heads, hd, scale, s);
  return (int)attention_fwd<float>(qkv, out, b, n, heads, hd, scale, s);
}
