// Fused pixel-norm + cosine attention, backward, for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package, which compute one function:
//   tinyedm_tpu/ops/fused_attention.py::_attn_bwd_kernel (:144), per head,
//     the n = 256 (16x16) layers;
//   tinyedm_tpu/ops/fused_attention.py::_attn_bwd_kernel_pair (:305), head
//     pairs laid out block-diagonally for the TPU's 128-wide matrix unit, the
//     n = 64 (8x8) layers. Its scratch, zeroed at program_id 0 and reused
//     across an in-order grid, has no counterpart: CUDA blocks run in no
//     order, and each block here starts from its own zeros.
// Both are reached through _bwd_impl (:790, pallas_call :833).
//
// Function, per (sample, head), on qkv (b, n, 3C) with channels (3, heads,
// hd), the output cotangent g and the forward's output o, both (b, n, C) with
// channels (heads, hd), all of one type T; c = fp32(1/sqrt(hd)):
//   x^ = T(x / T(D)), D = eps + |x|/sqrt(hd)   for q, k, v (fp32 norm s)
//   E  = exp(c q^ k^T), rc = c / rowsum(E), delta = rowsum(g o)      (fp32)
//   ds = T(E (g v^T - delta))
//   dq^ = (ds k^) rc,  dk^ = ds^T T(q^ rc),  dv^ = T(E)^T T(g rc sqrt(hd))
//   dx = T(dx^/D - x sum(dx^ x) / (D D max(s, 1e-30) / c))   for q, k, v
// with fp32 products of T-rounded operands and fp32 sums throughout, and the
// pixel-norm VJP taken with the UNROUNDED fp32 divisor D, as the JAX kernel.
//
// What bounds it on an H100 SXM: the JAX kernel's cost estimate counts bytes
// 8 b n C sizeof(T) (read qkv, g, o; write d(qkv)) and 10 b heads n^2 hd
// FLOPs: at the CIFAR-10 training batch of 256 in bf16, 268 MB against
// 42.9 GFLOP at n = 256 (0.080 ms at 3.35 TB/s against 0.043 ms at
// 989 TFLOP/s) and 67 MB at n = 64 (0.020 ms): memory-bound on paper. What
// costs time beside the products: every block stages and pixel-normalizes
// the rows it reads (the CUDA cores), and E is computed in both passes.
//
// Design: dk and dv sum over every query, dq over every key. Rather than
// fp32 atomics (whose order, and so whose result, changes from run to run),
// two deterministic passes, launched back to back, each sum in a fixed
// order (the FlashAttention-2 form).
//
// bf16 (tensor cores, bwd_tc in the .cuh; staging and normalization as the
// forward's notes say: raw rows by cp.async into padded bf16 shared memory,
// normalized by one thread per row, hd padded to a multiple of 16 only):
//   (a) a block of 16 warps owns 256 query rows at hd <= 64, 8 warps 128
//       above (64 above hd 192, where 128 do not fit in shared memory), 16
//       per warp, and streams the keys in chunks: delta = rowsum(g o); per
//       32 keys S = Q^ K^T and dP = g V^T on mma.sync, E = expf(S c) with
//       the row sums that give rc, and ds = T(E (dP - delta)) packed from
//       the fragments into the A fragments of dq^ += ds K^ (K^ by
//       ldmatrix.trans). ds needs delta but not rc, so one pass suffices. At
//       the end rc, the scaling of dq^, and rc and delta written to a small
//       fp32 (2, b, heads, n) buffer.
//   (b) a block owns 64 keys (hd <= 64) or 32 and streams the queries in
//       tiles of 64 rows (32 where two blocks would not fit on an SM),
//       staged as q^, T(q^ rc), g and T(g rc sqrt(hd)) with rc and delta
//       read from (a). Half its warps sum dk^ of 16 keys each: S^T = K^ Q^T
//       and dP^T = V^ g^T, ds^T, then dk^ += ds^T T(q^ rc); the other half
//       dv^ of the same keys: S^T again, then dv^ += T(E^T) T(g rc sqrt(hd)).
//       Splitting the two sums between warps keeps each warp's accumulators
//       in registers at every head dim (no spills up to hd 256) for one more
//       q k^T product.
// Each pass ends with the pixel-norm VJP of its rows straight from the
// accumulators, the quad's lanes summing each row's norm and inner product
// by shuffles, against the raw rows kept in shared memory since staging,
// and the result goes through those rows to 16-byte stores. Rounded values
// are exact bf16 products on the tensor cores, so only the order of the
// fp32 sums differs from the plain version.
//
// bf16 keeps no small-n route on the CUDA cores: at n = 1 the true dq and
// dk are 0 and both versions return rounding noise there, but the gate is
// the relative L2 of the whole d(qkv), which dv carries (unlike the flash
// backward's separate dq, dk and dv checks).
//
// fp32 (CUDA cores, bwd_detail): the first port's two passes, 32 own rows
// and 64 streamed rows per block, fp32 tiles in shared memory, E and g v^T
// recomputed in (b) in (a)'s order. TF32 would miss the 1e-5 gate.

#include "cosine_attention_bwd.cuh"

// qkv, dqkv: (b, n, 3 * heads * hd) contiguous; g, o: (b, n, heads * hd)
// contiguous; all of one type: bf16 when is_bf16 (tensor cores), else fp32
// (CUDA cores). stats: fp32
// scratch of 2 * b * heads * n (rc, then delta). scale = fp32(1/sqrt(hd)),
// sqrt_hd = fp32(sqrt(hd)). Launches both passes on `stream` without
// synchronizing; returns the cudaError_t of the launches (0 on success).
extern "C" int cosine_attention_bwd(const void* qkv, const void* g, const void* o, void* dqkv,
                                    void* stats, int b, int n, int heads, int hd, int is_bf16,
                                    float scale, float sqrt_hd, void* stream) {
  if (b < 1 || n < 1 || heads < 1 || hd < 1 || hd > 256) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  using cosine_attention::attention_bwd;
  if (is_bf16)
    return (int)attention_bwd<__nv_bfloat16>(qkv, g, o, dqkv, st, b, n, heads, hd, scale, sqrt_hd,
                                             s);
  return (int)attention_bwd<float>(qkv, g, o, dqkv, st, b, n, heads, hd, scale, sqrt_hd, s);
}
