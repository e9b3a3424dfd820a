// Scalar helpers of the generated element chains (core/codegen_cuda.py).
//
// The chains that compute-anchored stitching folds into the fused matmul
// (matmul_fused.cuh) and into flash attention's score functor
// (flash_attention.cuh), and the stitched groups of the streaming kernel
// (streaming.cuh), are generated as C++ functions of one element.
// They compile for the card with nvcc and, for the CPU tests, for the
// host with g++: there __host__ and __device__ are empty macros, and
// every helper here has a host form.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_fp16.h>
#endif

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace repro_chain {

__host__ __device__ __forceinline__ float rsqrt_(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}

__host__ __device__ __forceinline__ float logistic(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__host__ __device__ __forceinline__ float sign(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

__host__ __device__ __forceinline__ bool finite(float x) {
  return fabsf(x) < INFINITY;
}

// Row reductions: one slot a reduce node, accumulated in float32.
// 0 sum, 1 max, 2 min, 3 prod, 4 and (min of x != 0), 5 or (max of x != 0).
__host__ __device__ __forceinline__ float ident(int op) {
  switch (op) {
    case 1: return -INFINITY;
    case 2: return INFINITY;
    case 3: return 1.f;
    case 4: return 1.f;
    case 5: return 0.f;
    default: return 0.f;
  }
}

__host__ __device__ __forceinline__ float combine(int op, float a, float b) {
  switch (op) {
    case 1: return fmaxf(a, b);
    case 2: return fminf(a, b);
    case 3: return a * b;
    case 4: return fminf(a, b);
    case 5: return fmaxf(a, b);
    default: return a + b;
  }
}

// bfloat16 and float16 values compute in float32 and are rounded to
// their type at every node that has it, as PyTorch computes them; in
// memory they are the 16-bit patterns.  Rounding is to nearest even.
__host__ __device__ __forceinline__ uint32_t f32_bits(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(x);
#else
  uint32_t u;
  memcpy(&u, &x, 4);
  return u;
#endif
}

__host__ __device__ __forceinline__ float bits_f32(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float x;
  memcpy(&x, &u, 4);
  return x;
#endif
}

__host__ __device__ __forceinline__ uint16_t to_bf16(float x) {
  uint32_t u = f32_bits(x);
  if ((u & 0x7fffffffu) > 0x7f800000u)  // NaN stays a quiet NaN
    return static_cast<uint16_t>((u >> 16) | 0x40u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return static_cast<uint16_t>(u >> 16);
}

__host__ __device__ __forceinline__ float from_bf16(uint16_t b) {
  return bits_f32(static_cast<uint32_t>(b) << 16);
}

__host__ __device__ __forceinline__ float round_bf16(float x) {
  return from_bf16(to_bf16(x));
}

__host__ __device__ __forceinline__ uint16_t to_f16(float x) {
#ifdef __CUDA_ARCH__
  return __half_as_ushort(__float2half_rn(x));
#else
  const uint32_t u = f32_bits(x);
  const uint32_t sign = (u >> 16) & 0x8000u;
  const uint32_t mag = u & 0x7fffffffu;
  if (mag > 0x7f800000u) return static_cast<uint16_t>(sign | 0x7e00u);
  if (mag >= 0x477ff000u)  // 65520 and above round to infinity
    return static_cast<uint16_t>(sign | 0x7c00u);
  if (mag < 0x38800000u)  // below 2^-14: a subnormal (or zero) half
    return static_cast<uint16_t>(
        sign | static_cast<uint32_t>(rintf(bits_f32(mag) * 16777216.0f)));
  uint32_t r = mag - 0x38000000u;  // rebias the exponent 127 -> 15
  r += 0xfffu + ((r >> 13) & 1u);
  return static_cast<uint16_t>(sign | (r >> 13));
#endif
}

__host__ __device__ __forceinline__ float from_f16(uint16_t h) {
#ifdef __CUDA_ARCH__
  return __half2float(__ushort_as_half(h));
#else
  const uint32_t sign = static_cast<uint32_t>(h & 0x8000u) << 16;
  const uint32_t e = (h >> 10) & 0x1fu, m = h & 0x3ffu;
  if (e == 0) {
    const float f = static_cast<float>(m) * 5.9604644775390625e-8f;
    return sign ? -f : f;
  }
  if (e == 31) return bits_f32(sign | 0x7f800000u | (m << 13));
  return bits_f32(sign | ((e + 112u) << 23) | (m << 13));
#endif
}

__host__ __device__ __forceinline__ float round_f16(float x) {
  return from_f16(to_f16(x));
}

}  // namespace repro_chain
