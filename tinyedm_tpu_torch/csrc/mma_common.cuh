// Tensor-core building blocks for the bf16 kernels of csrc/ (Hopper, sm_90a):
// the warp-level bf16 product mma.sync.m16n8k16 with fp32 sums, ldmatrix
// loaders of its operand fragments from bf16 shared memory, and 16-byte
// cp.async staging from device memory. Used by winograd_fwd.cu,
// flash_attention_fwd.cu and the bf16 fused cosine attention
// (cosine_attention_{fwd,bwd}.cuh).
//
// Fragments of one m16n8k16 product D (16 x 8) += A (16 x 16) B (16 x 8),
// for lane l of the warp, g = l / 4, t = l % 4 (PTX ISA, "mma.m16n8k16"):
//   A, 4 registers of two bf16 each (the lower half holds the lower column):
//     a0 = A[g][2t..2t+1]      a1 = A[g + 8][2t..2t+1]
//     a2 = A[g][2t+8..2t+9]    a3 = A[g + 8][2t+8..2t+9]
//   B, 2 registers:  b0 = B[2t..2t+1][g]   b1 = B[2t+8..2t+9][g]
//   D, 4 fp32:       d0, d1 = D[g][2t..2t+1]   d2, d3 = D[g + 8][2t..2t+1]
//                    (acc_row, acc_col below)
//
// Repacking a product's result as the A operand of the next one (flash
// attention's weights w, then w V): the D fragments of two neighbouring n8
// tiles j and j + 1 cover rows g, g + 8 and columns 2t..2t+1 of each, which
// is exactly an A fragment over k = 16 columns:
//   a0 = pack(Dj[0], Dj[1])   a1 = pack(Dj[2], Dj[3])
//   a2 = pack(Dj+1[0], Dj+1[1])   a3 = pack(Dj+1[2], Dj+1[3])
// so the weights go from the first product into the second in registers,
// rounded to bf16 by pack_bf16, with no trip through shared memory.
//
// Shared-memory layout: operands are stored as rows of bf16 with a row
// stride of (a multiple of 16 bytes) + 16 bytes, for example 16 + 8 or
// HD + 8 elements. The 8 rows of 16 bytes that one ldmatrix matrix reads
// then fall on 8 distinct 16-byte bank groups: no bank conflicts.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace mma {

// the shared-memory address of a generic pointer into shared memory
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a b on the tensor cores: bf16 operands, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices; lanes 8i .. 8i + 7 give the addresses of matrix
// i's rows, and register i receives row l / 4, columns 2 (l % 4) .. + 1 of
// matrix i.
//   A fragment of a row-major 16 x 16 tile at p (row stride ld elements):
//     lane address p + (l % 16) * ld + (l / 16) * 8              -> a0..a3
//   B fragments of two n8 tiles from an [n][k] row-major 16 x 16 tile:
//     lane address p + ((l % 8) + (l / 16) * 8) * ld + ((l / 8) % 2) * 8
//                                     -> b0, b1 of tile 0, b0, b1 of tile 1
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// The same, transposed: register i receives rows 2 (l % 4) .. + 1, column
// l / 4 of matrix i.
//   B fragments of two n8 tiles from a [k][n] row-major 16 x 16 tile:
//     lane address p + ((l % 8) + ((l / 8) % 2) * 8) * ld + (l / 16) * 8
//                                     -> b0, b1 of tile 0, b0, b1 of tile 1
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// the lane offsets of the three ldmatrix patterns above, (row, column)
__device__ __forceinline__ int a_row(int lane) { return lane % 16; }
__device__ __forceinline__ int a_col(int lane) { return (lane / 16) * 8; }
__device__ __forceinline__ int bn_row(int lane) { return lane % 8 + (lane / 16) * 8; }
__device__ __forceinline__ int bn_col(int lane) { return ((lane / 8) % 2) * 8; }
__device__ __forceinline__ int bk_row(int lane) { return lane % 8 + ((lane / 8) % 2) * 8; }
__device__ __forceinline__ int bk_col(int lane) { return (lane / 16) * 8; }

// the (row, column) of accumulator register i (0..3) of lane l in its m16n8 tile
__device__ __forceinline__ int acc_row(int lane, int i) { return lane / 4 + (i / 2) * 8; }
__device__ __forceinline__ int acc_col(int lane, int i) { return (lane % 4) * 2 + (i % 2); }

// two floats rounded to bf16 (nearest even), lo in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the two bf16 halves of a register, as floats (exact)
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// 16 bytes from device memory to shared memory, asynchronously, bypassing
// L1; with ok false nothing is read and the 16 bytes are zero-filled (src
// must still be a valid address). Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace mma
