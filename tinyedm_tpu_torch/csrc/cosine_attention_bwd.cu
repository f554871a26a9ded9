// Fused pixel-norm + cosine attention, backward, for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package, which compute one function:
//   tinyedm_tpu/ops/fused_attention.py::_attn_bwd_kernel (:144), per head,
//     the CIFAR-10 path's n = 256 (16x16) layers;
//   tinyedm_tpu/ops/fused_attention.py::_attn_bwd_kernel_pair (:305), head
//     pairs laid out block-diagonally for the TPU's 128-wide matrix unit, the
//     n = 64 (8x8) layers. Its scratch, zeroed at program_id 0 and reused
//     across an in-order grid, has no counterpart: CUDA blocks run in no
//     order, and each block here starts from its own zeros.
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
// 8 b n C * sizeof(T) (read qkv, g, o; write d(qkv)) and 10 b heads n^2 hd
// FLOPs: at the CIFAR-10 training batch of 256 in bf16, 268 MB against
// 42.9 GFLOP at n = 256 (0.080 ms at 3.35 TB/s against 0.043 ms at
// 989 TFLOP/s) and 67 MB at n = 64 (0.020 ms): memory-bound on paper.
//
// Design: dk and dv sum over every query, dq over every key. Rather than
// fp32 atomics (whose order, and so whose result, changes from run to run),
// two deterministic passes, launched back to back:
//   (a) one block per (sample, head, tile of 32 query rows) streams key/value
//       tiles of 64 rows through shared memory: row sums of E, delta, and the
//       unscaled dq^ sum over keys (ds needs delta but not rc, so one pass
//       suffices); it multiplies by rc at the end, applies the pixel-norm VJP
//       to the tile's q rows and writes rc and delta to a small fp32
//       (2, b, heads, n) buffer;
//   (b) one block per (sample, head, tile of 32 key rows) streams query tiles
//       of 64 rows, recomputes E bit for bit as (a) did (same products in the
//       same order), reads rc and delta, and sums dk^ and dv^ over queries;
//       then the pixel-norm VJP of the tile's k and v rows.
// Rounded values are kept as fp32 in shared memory, so every product is
// exact and only the sums' order differs from the plain version. No max is
// subtracted before the exp: |logits| <= c. Shared memory is bounded by the
// tile sizes: 205.7 KB for (a) and 214.0 KB for (b) at hd = 256. This first
// version multiplies on the CUDA cores in fp32 and recomputes E and g v^T in
// both passes; tensor cores (mma/wgmma), TMA and fusing the passes are later
// work.

#include "cosine_attention_bwd.cuh"

// qkv, dqkv: (b, n, 3 * heads * hd) contiguous; g, o: (b, n, heads * hd)
// contiguous; all of one type: bf16 when is_bf16, else fp32. stats: fp32
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
    return (int)attention_bwd<__nv_bfloat16>(qkv, g, o, dqkv, st, b, n, heads, hd, scale, sqrt_hd, s);
  return (int)attention_bwd<float>(qkv, g, o, dqkv, st, b, n, heads, hd, scale, sqrt_hd, s);
}
