// The three-way TF32 split on the tensor cores through `mma.sync`, shared
// by flash attention (flash_attention.cuh, B4) and the SSD scan
// (ssd_scan.cu, B11).  A float32 value x is big + small, big = tf32(x),
// small = tf32(x - big), and a b ~ big_a big_b + big_a small_b + small_a
// big_b: three exact TF32 products into one float32 sum
// (kernels/split_float.py is the plain form and its measurement).
#pragma once

#include <stdint.h>

namespace repro_tf32 {

// big and small TF32 halves of x, each rounded as cvt.rna.tf32.f32
// rounds (to nearest, ties away from zero), in two integer operations
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d (+)= a b, m16n8k8, TF32 in, float32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The three products of a split into d: the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0,
                                     uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

}  // namespace repro_tf32
