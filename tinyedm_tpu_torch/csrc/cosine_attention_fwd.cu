// Fused pixel-norm + cosine attention, forward, for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package, which compute one function:
//   tinyedm_tpu/ops/fused_attention.py::_attn_fwd_kernel (:102), per head,
//     the n = 256 (16x16) layers;
//   tinyedm_tpu/ops/fused_attention.py::_attn_fwd_kernel_pair (:253), head
//     pairs laid out block-diagonally to fill the TPU's 128-wide matrix unit,
//     the n = 64 (8x8) layers. The pairing is a TPU layout device only, and
//     its scratch (zeroed at program_id 0, reused across an in-order grid)
//     has no counterpart here: every block starts from its own zeros.
// Both are reached through _fwd_impl (:734, pallas_call :774).
//
// Function, per (sample, head), on qkv (b, n, 3C) with channels ordered
// (3, heads, hd), output (b, n, C) with channels (heads, hd):
//   x^ = x / T(1e-4 + |x|_2 / sqrt(hd))   for q, k, v; fp32 norm, the
//        divisor rounded to the input type T, the quotient rounded to T
//   L  = q^ k^T / sqrt(hd)                 T operands, fp32 sums
//   E  = exp(L)                            no max subtraction: |L| <= 1/sqrt(hd)
//   s  = rowsum(E)                         fp32, over the unrounded E
//   o  = T( (T(E) v^, fp32 sums) / s )
//
// What bounds it on an H100 SXM: the function reads qkv once and writes o
// once, 8 b n C bytes in bf16, against 4 b heads n^2 hd FLOP of products:
// at the CIFAR-10 sampling batch (128, n 256, C 256) 67 MB against 8.6
// GFLOP, 0.020 ms of memory time against 0.009 ms of tensor-core time; at
// ImageNet-512's (32, n 256, C 576) 0.011 ms against 0.005. Memory-bound on
// paper. What costs time beside the products is on the CUDA cores: the
// per-element pixel norm of every staged row (a correctly rounded division)
// and the exp of every logit.
//
// bf16 (tensor cores, fwd_tc in the .cuh): a block of 16 warps owns 256
// query rows of one (sample, head) at hd <= 64, 8 warps 128 rows above
// (their registers allow one block per SM either way), 16 rows per warp,
// fewer warps where n is smaller. Raw q, k and v rows come into bf16 shared memory by 16-byte
// cp.async copies (element copies where hd is not a multiple of 8: hd 20,
// 33), rows padded to hd rounded up to 16 (never to a power of two) plus 8
// elements, so ldmatrix reads without bank conflicts. One thread per row
// then pixel-normalizes it in place: fp32 norm, divisor rounded to bf16, the
// quotient correctly rounded from the divisor's reciprocal and one FMA step.
// Keys come in chunks as large as shared memory allows (two blocks per SM
// at hd <= 64; above, the registers allow one, and the chunk takes the
// rest), each chunk staged and normalized once per block. Each warp computes
// S = Q^ K^T on mma.sync.m16n8k16 (Q fragments held in registers up to hd
// 128), E = expf(S c) with the mask applied in the tail tile only, the row
// sums of E per lane, and packs T(E) from the S fragments straight into the
// A fragments of O += T(E) V^ (mma_common.cuh), V^ read by ldmatrix.trans.
// With no max to subtract, one pass over the keys is exact: no online
// rescaling. At the end the quad's lanes sum their row sums by shuffles,
// divide once (correctly rounded, as above), and the rounded rows go
// through the warp's own rows of shared memory to 16-byte stores. Products
// of bf16 values are exact, so only the order of the fp32 sums differs from
// the plain version.
//
// fp32 (CUDA cores, fwd_detail): tensor cores in fp32 would be TF32, about
// three decimal digits, off the 1e-5 gate against the plain version; fp32
// keeps the first port's kernel: 32 query rows per block, key/value tiles
// of 64 rows normalized as they arrive, products in fp32.

#include "cosine_attention_fwd.cuh"

// qkv: (b, n, 3 * heads * hd) contiguous; out: (b, n, heads * hd) contiguous,
// both of one type: bf16 when is_bf16 (tensor cores), else fp32 (CUDA
// cores). scale = fp32(1/sqrt(hd)). Launches on `stream` without synchronizing; returns the
// cudaError_t of the launch (0 on success).
extern "C" int cosine_attention_fwd(const void* qkv, void* out, int b, int n, int heads, int hd,
                                    int is_bf16, float scale, void* stream) {
  if (b < 1 || n < 1 || heads < 1 || hd < 1 || hd > 256) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using cosine_attention::attention_fwd;
  if (is_bf16)
    return (int)attention_fwd<__nv_bfloat16>(qkv, out, b, n, heads, hd, scale, s);
  return (int)attention_fwd<float>(qkv, out, b, n, heads, hd, scale, s);
}
