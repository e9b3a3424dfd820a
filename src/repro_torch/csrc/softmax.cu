// Row softmax forward and backward for Hopper (sm_90a), float32.
//
// Replaces the TPU kernels `_softmax_kernel` / `softmax_fwd` and
// `_softmax_bwd_kernel` / `softmax_bwd` (src/repro/kernels/softmax.py:14,22
// and :43,52):
//     forward   m = max(x),  e = exp(x - m),  s = sum(e),  y = e / s
//     backward  t = sum(dy * y),  dx = y * (dy - t)            [R, C] each
// The arithmetic is the TPU kernels' in their order, float32 throughout.
//
// Bound: bytes, and at the router's shapes the launch.  The forward reads
// x and writes y (8 R C bytes), the backward reads y and dy and writes dx
// (12 R C bytes); their 3-4 operations an element are nothing beside
// that.  The TPU kernels stage 64 rows in VMEM per grid step.  Here the
// width picks the shape of the work:
//   * C <= 256 (the router: 32 or 40 experts): one warp per row, the row
//     in registers (VPT values a lane, lane l holding columns l + 32 i, so
//     each load instruction of a warp reads 128 consecutive bytes), the
//     two reductions as warp shuffles; four rows per 128-thread block.  A
//     ragged last block's surplus warps return before any load.
//   * wider rows: one 256-thread block per row that loops over the
//     columns -- the max, the sum of exp (recomputed, not stored), then
//     the write, each reduction a warp shuffle and one shared-memory
//     step.  The row is re-read from L1/L2, not from device memory.
//
// C interface (bound with ctypes): every entry returns cudaGetLastError()
// after its launch.  Pointers are device pointers of contiguous float32
// tensors; `stream` is the caller's cudaStream_t.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarpRowsPerBlock = 4;            // warp path: 128 threads
constexpr int kBlockThreads = 256;              // block path: one row a block
constexpr int kMaxWarpVPT = 8;                  // warp path up to 256 columns

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Max (kMax) or sum of `v` over a kBlockThreads block; every thread gets
// the result.  Each instantiation has its own shared memory.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v) {
  __shared__ float part[kBlockThreads / 32];
  __shared__ float total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kBlockThreads / 32 ? part[lane]
                                        : (kMax ? -CUDART_INF_F : 0.f);
    w = kMax ? warp_max(w) : warp_sum(w);
    if (lane == 0) total = w;
  }
  __syncthreads();
  return total;
}

template <int VPT>
__global__ void __launch_bounds__(32 * kWarpRowsPerBlock)
softmax_fwd_warp_kernel(const float* __restrict__ x, float* __restrict__ y,
                        int R, int C) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;  // the whole warp: no shuffle is left waiting
  const float* xr = x + row * C;
  float v[VPT];
  float m = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < C ? xr[c] : -CUDART_INF_F;
    m = fmaxf(m, v[i]);
  }
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < C ? expf(v[i] - m) : 0.f;
    s += v[i];
  }
  s = warp_sum(s);
  float* yr = y + row * C;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    if (c < C) yr[c] = v[i] / s;
  }
}

__global__ void __launch_bounds__(kBlockThreads)
softmax_fwd_block_kernel(const float* __restrict__ x, float* __restrict__ y,
                         int C) {
  const long long row = blockIdx.x;
  const float* xr = x + row * C;
  float m = -CUDART_INF_F;
  for (int c = threadIdx.x; c < C; c += kBlockThreads) m = fmaxf(m, xr[c]);
  m = block_reduce<true>(m);
  float s = 0.f;
  for (int c = threadIdx.x; c < C; c += kBlockThreads) s += expf(xr[c] - m);
  s = block_reduce<false>(s);
  float* yr = y + row * C;
  for (int c = threadIdx.x; c < C; c += kBlockThreads) yr[c] = expf(xr[c] - m) / s;
}

template <int VPT>
__global__ void __launch_bounds__(32 * kWarpRowsPerBlock)
softmax_bwd_warp_kernel(const float* __restrict__ y, const float* __restrict__ dy,
                        float* __restrict__ dx, int R, int C) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;
  const float* yr = y + row * C;
  const float* dyr = dy + row * C;
  float yv[VPT], dv[VPT];
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    yv[i] = c < C ? yr[c] : 0.f;
    dv[i] = c < C ? dyr[c] : 0.f;
    t += dv[i] * yv[i];
  }
  t = warp_sum(t);
  float* dxr = dx + row * C;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    if (c < C) dxr[c] = yv[i] * (dv[i] - t);
  }
}

__global__ void __launch_bounds__(kBlockThreads)
softmax_bwd_block_kernel(const float* __restrict__ y, const float* __restrict__ dy,
                         float* __restrict__ dx, int C) {
  const long long row = blockIdx.x;
  const float* yr = y + row * C;
  const float* dyr = dy + row * C;
  float t = 0.f;
  for (int c = threadIdx.x; c < C; c += kBlockThreads) t += dyr[c] * yr[c];
  t = block_reduce<false>(t);
  float* dxr = dx + row * C;
  for (int c = threadIdx.x; c < C; c += kBlockThreads)
    dxr[c] = yr[c] * (dyr[c] - t);
}

// The warp path's values a lane for C columns (1, 2, 4 or 8), or 0 when
// the row takes the block path.
int warp_vpt(int C) {
  const int need = (C + 31) / 32;
  if (need > kMaxWarpVPT) return 0;
  int vpt = 1;
  while (vpt < need) vpt *= 2;
  return vpt;
}

unsigned warp_blocks(int R) {
  return static_cast<unsigned>((R + kWarpRowsPerBlock - 1) / kWarpRowsPerBlock);
}

}  // namespace

extern "C" int repro_softmax_fwd_f32(const void* x, void* y, int R, int C,
                                     void* stream) {
  if (R <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float*>(x);
  auto yp = static_cast<float*>(y);
  const dim3 wblock(32 * kWarpRowsPerBlock), wgrid(warp_blocks(R));
  switch (warp_vpt(C)) {
    case 1: softmax_fwd_warp_kernel<1><<<wgrid, wblock, 0, s>>>(xp, yp, R, C); break;
    case 2: softmax_fwd_warp_kernel<2><<<wgrid, wblock, 0, s>>>(xp, yp, R, C); break;
    case 4: softmax_fwd_warp_kernel<4><<<wgrid, wblock, 0, s>>>(xp, yp, R, C); break;
    case 8: softmax_fwd_warp_kernel<8><<<wgrid, wblock, 0, s>>>(xp, yp, R, C); break;
    default:
      softmax_fwd_block_kernel<<<R, kBlockThreads, 0, s>>>(xp, yp, C);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_softmax_bwd_f32(const void* y, const void* dy, void* dx,
                                     int R, int C, void* stream) {
  if (R <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto yp = static_cast<const float*>(y);
  auto dyp = static_cast<const float*>(dy);
  auto dxp = static_cast<float*>(dx);
  const dim3 wblock(32 * kWarpRowsPerBlock), wgrid(warp_blocks(R));
  switch (warp_vpt(C)) {
    case 1: softmax_bwd_warp_kernel<1><<<wgrid, wblock, 0, s>>>(yp, dyp, dxp, R, C); break;
    case 2: softmax_bwd_warp_kernel<2><<<wgrid, wblock, 0, s>>>(yp, dyp, dxp, R, C); break;
    case 4: softmax_bwd_warp_kernel<4><<<wgrid, wblock, 0, s>>>(yp, dyp, dxp, R, C); break;
    case 8: softmax_bwd_warp_kernel<8><<<wgrid, wblock, 0, s>>>(yp, dyp, dxp, R, C); break;
    default:
      softmax_bwd_block_kernel<<<R, kBlockThreads, 0, s>>>(yp, dyp, dxp, C);
  }
  return static_cast<int>(cudaGetLastError());
}
