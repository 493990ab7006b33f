// float32 products on the tensor cores, shared by the port's kernels that
// take them (tcgnn_spmm.cu, block_diag_spmm_dual.cu).
//
// mma.sync m16n8k8 with TF32 operands keeps 10 of float32's 23 mantissa
// bits, which alone misses the float32 gates (1e-4).  Split as a = a_hi +
// a_lo, both rounded to TF32, a product is a_hi b_hi + a_hi b_lo + a_lo b_hi
// to within about 2^-21 of |a b| (the dropped a_lo b_lo is 2^-22 of it),
// summed in float32 by the tensor cores: three MMAs for one product, still
// well above the CUDA cores' float32 FMA rate.  A bfloat16 operand is exact
// in TF32 and needs no split.
//
// Fragments (PTX ISA, mma.m16n8k8 .tf32): with g = lane / 4, t = lane % 4,
// A (16 x 8, row-major) is a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4],
// a3 = A[g + 8][t + 4]; B (8 x 8) is b0 = B[t][g], b1 = B[t + 4][g]; the
// accumulator C (16 x 8) is c0 = C[g][2t], c1 = C[g][2t + 1], c2 =
// C[g + 8][2t], c3 = C[g + 8][2t + 1].
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// c += A B for one m16n8k8 TF32 tile
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A B in float32 from split operands: the two cross terms, then the
// leading one
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           uint32_t b0_hi, uint32_t b1_hi,
                                           uint32_t b0_lo, uint32_t b1_lo) {
  mma_tf32(c, a_lo, b0_hi, b1_hi);
  mma_tf32(c, a_hi, b0_lo, b1_lo);
  mma_tf32(c, a_hi, b0_hi, b1_hi);
}

}  // namespace repro_torch
