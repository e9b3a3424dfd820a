// Scalar helpers of the generated element chains (core/codegen_cuda.py).
//
// The chains that compute-anchored stitching folds into the fused matmul
// (matmul_fused.cuh) and into flash attention's score functor
// (flash_attention.cuh) are generated as C++ functions of one element.
// They compile for the card with nvcc and, for the CPU tests, for the
// host with g++: there __host__ and __device__ are empty macros, and
// every helper here has a host form.
#pragma once

#include <math.h>

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

}  // namespace repro_chain
