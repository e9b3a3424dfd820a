// RMSNorm forward for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel `_rms_kernel` / `rmsnorm_fwd`
// (src/repro/kernels/rmsnorm.py:12,20):
//     y    = x * rsqrt(mean(x^2) + eps) * g        x, y [R, C]
//     rstd = rsqrt(mean(x^2) + eps)                 [R, 1] float32
//
// Bound: bytes.  Each row is read once and written once (the gain is
// read once per block), 8 R C bytes in all; the 3 R C operations are
// nothing beside them.  The TPU kernel stages a block of rows in VMEM;
// here one block of 256 threads owns one row and holds it in registers
// as float4 (VPT of them a thread, up to 256 * 4 * VPT columns), sums
// the squares with warp shuffles and one shared-memory step, and writes
// y and rstd.  Rows whose width is not a multiple of 4, or wider than
// the register path holds, take a scalar loop that reads the row twice.
//
// C interface (bound with ctypes): every entry returns cudaGetLastError()
// after its launch.  Pointers are device pointers of contiguous tensors;
// `stream` is the caller's cudaStream_t.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of `v` over the block; every thread gets the result.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[kThreads / 32];
  __shared__ float total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kThreads / 32 ? part[lane] : 0.f;
    w = warp_sum(w);
    if (lane == 0) total = w;
  }
  __syncthreads();
  return total;
}

template <int VPT>
__global__ void __launch_bounds__(kThreads)
rms_vec_kernel(const float4* __restrict__ x, const float4* __restrict__ g,
               float4* __restrict__ y, float* __restrict__ rstd, int C,
               float eps) {
  const int C4 = C / 4;
  const size_t row = blockIdx.x;
  const float4* xr = x + row * C4;
  float4 v[VPT];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * kThreads;
    v[i] = c < C4 ? xr[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    ss += v[i].x * v[i].x + v[i].y * v[i].y + v[i].z * v[i].z + v[i].w * v[i].w;
  }
  const float r = rsqrtf(block_sum(ss) / C + eps);
  float4* yr = y + row * C4;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < C4) {
      const float4 gv = g[c];
      yr[c] = make_float4(v[i].x * r * gv.x, v[i].y * r * gv.y,
                          v[i].z * r * gv.z, v[i].w * r * gv.w);
    }
  }
  if (threadIdx.x == 0) rstd[row] = r;
}

__global__ void __launch_bounds__(kThreads)
rms_scalar_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  float* __restrict__ y, float* __restrict__ rstd, int C,
                  float eps) {
  const size_t row = blockIdx.x;
  const float* xr = x + row * C;
  float ss = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) ss += xr[c] * xr[c];
  const float r = rsqrtf(block_sum(ss) / C + eps);
  float* yr = y + row * C;
  for (int c = threadIdx.x; c < C; c += kThreads) yr[c] = xr[c] * r * g[c];
  if (threadIdx.x == 0) rstd[row] = r;
}

}  // namespace

extern "C" int repro_rmsnorm_f32(const void* x, const void* g, void* y,
                                 void* rstd, int R, int C, float eps,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(R), block(kThreads);
  const bool vec = C % 4 == 0 &&
                   reinterpret_cast<size_t>(x) % 16 == 0 &&
                   reinterpret_cast<size_t>(g) % 16 == 0 &&
                   reinterpret_cast<size_t>(y) % 16 == 0;
  const int per_thread = (C / 4 + kThreads - 1) / kThreads;  // float4s
  auto xv = static_cast<const float4*>(x);
  auto gv = static_cast<const float4*>(g);
  auto yv = static_cast<float4*>(y);
  auto rs = static_cast<float*>(rstd);
  if (R > 0 && vec && per_thread <= 1) {
    rms_vec_kernel<1><<<grid, block, 0, s>>>(xv, gv, yv, rs, C, eps);
  } else if (R > 0 && vec && per_thread <= 2) {
    rms_vec_kernel<2><<<grid, block, 0, s>>>(xv, gv, yv, rs, C, eps);
  } else if (R > 0 && vec && per_thread <= 4) {
    rms_vec_kernel<4><<<grid, block, 0, s>>>(xv, gv, yv, rs, C, eps);
  } else if (R > 0 && vec && per_thread <= 8) {
    rms_vec_kernel<8><<<grid, block, 0, s>>>(xv, gv, yv, rs, C, eps);
  } else if (R > 0) {
    rms_scalar_kernel<<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<float*>(y), rs, C, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
