// Native bfloat16 products on the tensor cores through `mma.sync`, shared
// by flash attention's bfloat16 instances (flash_attention.cuh, B4, and
// flash_attention_wide.cuh above head dim 256).  A product of two
// bfloat16 values is exact in float32 and `mma.sync.m16n8k16...bf16`
// sums into float32, so where both operands are bfloat16 one product
// forms what the TF32 split formed.  A float32 operand (attention's p) is
// split into hi = bf16(p) and lo = bf16(p - hi), two products: about 16
// significant bits of p (kernels/split_float.py::bf16_pair is the plain
// form).  Fragments come from shared memory by `ldmatrix`.
#pragma once

#include <stdint.h>

namespace repro_bf16 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 matrices of 16-bit values: lane l gives the address of row
// l % 8 of matrix l / 8 (16 bytes); register i holds matrix i, a thread
// (g, t) = (lane / 4, lane % 4) its row g, columns 2t and 2t + 1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
// The same, each matrix transposed: a thread holds column g, rows 2t and
// 2t + 1 (a row-major [k][n] tile read as the column operand of mma).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a b, m16n8k16, bfloat16 in, float32 accumulator.  a: rows g and
// g + 8, k 2t, 2t + 1 (a0, a1) and k 2t + 8, 2t + 9 (a2, a3); b: k 2t,
// 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of column g; d as m16n8k8's.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 values rounded to the nearest bfloat16 (ties to even),
// packed: `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// x0 and x1 as hi + lo, each a packed pair of bfloat16 values: hi the
// rounded values, lo the rounded remainders.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16),
                 x1 - __uint_as_float(hi & 0xffff0000u));
}

}  // namespace repro_bf16
