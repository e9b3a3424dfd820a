// LayerNorm forward and backward for Hopper (sm_90a), float32.
//
// Replaces the TPU kernels `_ln_kernel` / `layernorm_fwd` and
// `_ln_bwd_kernel` / `_ln_bwd` (src/repro/kernels/layernorm.py:22,34 and
// :69,92):
//     forward   mean = mean(x),  var = mean((x - mean)^2),
//               rstd = rsqrt(var + eps),
//               y = (x - mean) * rstd * g + b          x, y [R, C]
//               mean, rstd [R, 1] float32
//     backward  xhat = (x - mean) * rstd,  gdy = dy * g,
//               m1 = mean(gdy),  m2 = mean(gdy * xhat),
//               dx = rstd * (gdy - m1 - xhat * m2)
//               dgamma partial [nb, C] = sum over a block's rows of dy * xhat
//               dbeta  partial [nb, C] = sum over a block's rows of dy
// The variance is taken of the centred values, in the reference's order,
// not as E[x^2] - mean^2 (which differs in float32).
//
// Bound: bytes.  The forward reads x and writes y (8 R C bytes), the
// backward reads x and dy and writes dx (12 R C bytes); their 8-10
// operations an element are nothing beside that.  The TPU kernels stage a
// block of 128 rows in VMEM.  Here one block of 256 threads owns a row
// and holds it in registers as float4 (VPT of them a thread, up to
// 256 * 4 * 8 = 8192 columns), so each element is read once: the two
// reductions of a row (the mean, then the centred variance; m1 and m2)
// are warp shuffles and one shared-memory step.  The TPU backward sums
// dgamma and dbeta over its sequential grid steps; CUDA blocks run in no
// order, so each backward block walks `rows_per_block` consecutive rows,
// keeps its columns' dgamma and dbeta sums in registers, and writes one
// [C] partial row of each.  The caller sums the [nb, C] partials (one
// `sum(0)`, as the reference sums outside its kernel): deterministic, no
// atomics.  A ragged last row block is bounded by R.  Rows whose width is
// not a multiple of 4, or wider than the register path holds, take a
// scalar path that reads the row more than once.
//
// C interface (bound with ctypes): every entry returns cudaGetLastError()
// after its launch.  Pointers are device pointers of contiguous float32
// tensors; `stream` is the caller's cudaStream_t.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float2 warp_sum2(float2 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
  }
  return v;
}

// Sums of both components of `v` over the block; every thread gets them.
// Safe to call again at once: a thread reads `total` before it can reach
// the next call's first barrier, and `total` is written only after it.
__device__ __forceinline__ float2 block_sum2(float2 v) {
  __shared__ float2 part[kThreads / 32];
  __shared__ float2 total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum2(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float2 w = lane < kThreads / 32 ? part[lane] : make_float2(0.f, 0.f);
    w = warp_sum2(w);
    if (lane == 0) total = w;
  }
  __syncthreads();
  return total;
}

__device__ __forceinline__ float block_sum(float v) {
  return block_sum2(make_float2(v, 0.f)).x;
}

__device__ __forceinline__ float sum4(float4 v) {
  return v.x + v.y + v.z + v.w;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
template <int VPT>
__global__ void __launch_bounds__(kThreads)
ln_fwd_vec_kernel(const float4* __restrict__ x, const float4* __restrict__ g,
                  const float4* __restrict__ b, float4* __restrict__ y,
                  float* __restrict__ mean, float* __restrict__ rstd, int C,
                  float eps) {
  const int C4 = C / 4;
  const size_t row = blockIdx.x;
  const float4* xr = x + row * C4;
  float4 v[VPT];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * kThreads;
    v[i] = c < C4 ? xr[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    s += sum4(v[i]);
  }
  const float mu = block_sum(s) / C;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < C4) {
      v[i] = make_float4(v[i].x - mu, v[i].y - mu, v[i].z - mu, v[i].w - mu);
      ss += v[i].x * v[i].x + v[i].y * v[i].y + v[i].z * v[i].z +
            v[i].w * v[i].w;
    }
  }
  const float r = rsqrtf(block_sum(ss) / C + eps);
  float4* yr = y + row * C4;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < C4) {
      const float4 gv = g[c], bv = b[c];
      yr[c] = make_float4(v[i].x * r * gv.x + bv.x, v[i].y * r * gv.y + bv.y,
                          v[i].z * r * gv.z + bv.z, v[i].w * r * gv.w + bv.w);
    }
  }
  if (threadIdx.x == 0) {
    mean[row] = mu;
    rstd[row] = r;
  }
}

__global__ void __launch_bounds__(kThreads)
ln_fwd_scalar_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ b, float* __restrict__ y,
                     float* __restrict__ mean, float* __restrict__ rstd,
                     int C, float eps) {
  const size_t row = blockIdx.x;
  const float* xr = x + row * C;
  float s = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) s += xr[c];
  const float mu = block_sum(s) / C;
  float ss = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float d = xr[c] - mu;
    ss += d * d;
  }
  const float r = rsqrtf(block_sum(ss) / C + eps);
  float* yr = y + row * C;
  for (int c = threadIdx.x; c < C; c += kThreads)
    yr[c] = (xr[c] - mu) * r * g[c] + b[c];
  if (threadIdx.x == 0) {
    mean[row] = mu;
    rstd[row] = r;
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
template <int VPT>
__global__ void __launch_bounds__(kThreads)
ln_bwd_vec_kernel(const float4* __restrict__ x, const float4* __restrict__ g,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd,
                  const float4* __restrict__ dy, float4* __restrict__ dx,
                  float4* __restrict__ dgp, float4* __restrict__ dbp, int R,
                  int C, int rows_per_block) {
  const int C4 = C / 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 gv[VPT], dg[VPT], db[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * kThreads;
    gv[i] = c < C4 ? g[c] : zero;  // zero past the row: gdy is 0 there
    dg[i] = db[i] = zero;
  }
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, R);
  for (int row = r0; row < r1; ++row) {
    const float mu = mean[row], rs = rstd[row];
    const float4* xr = x + (size_t)row * C4;
    const float4* dyr = dy + (size_t)row * C4;
    float4 xh[VPT], gd[VPT];
    float2 s = make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const float4 xv = c < C4 ? xr[c] : zero;
      const float4 dv = c < C4 ? dyr[c] : zero;
      xh[i] = make_float4((xv.x - mu) * rs, (xv.y - mu) * rs,
                          (xv.z - mu) * rs, (xv.w - mu) * rs);
      gd[i] = make_float4(dv.x * gv[i].x, dv.y * gv[i].y, dv.z * gv[i].z,
                          dv.w * gv[i].w);
      s.x += sum4(gd[i]);
      s.y += gd[i].x * xh[i].x + gd[i].y * xh[i].y + gd[i].z * xh[i].z +
             gd[i].w * xh[i].w;
      dg[i].x += dv.x * xh[i].x;
      dg[i].y += dv.y * xh[i].y;
      dg[i].z += dv.z * xh[i].z;
      dg[i].w += dv.w * xh[i].w;
      db[i].x += dv.x;
      db[i].y += dv.y;
      db[i].z += dv.z;
      db[i].w += dv.w;
    }
    s = block_sum2(s);
    const float m1 = s.x / C, m2 = s.y / C;
    float4* dxr = dx + (size_t)row * C4;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c < C4)
        dxr[c] = make_float4(rs * (gd[i].x - m1 - xh[i].x * m2),
                             rs * (gd[i].y - m1 - xh[i].y * m2),
                             rs * (gd[i].z - m1 - xh[i].z * m2),
                             rs * (gd[i].w - m1 - xh[i].w * m2));
    }
  }
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < C4) {
      dgp[(size_t)blockIdx.x * C4 + c] = dg[i];
      dbp[(size_t)blockIdx.x * C4 + c] = db[i];
    }
  }
}

// Each thread owns the columns threadIdx.x + k * kThreads and accumulates
// their partials in place in its block's partial rows (no other thread
// touches them, so there is no race).
__global__ void __launch_bounds__(kThreads)
ln_bwd_scalar_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     const float* __restrict__ dy, float* __restrict__ dx,
                     float* __restrict__ dgp, float* __restrict__ dbp, int R,
                     int C, int rows_per_block) {
  float* dgr = dgp + (size_t)blockIdx.x * C;
  float* dbr = dbp + (size_t)blockIdx.x * C;
  for (int c = threadIdx.x; c < C; c += kThreads) dgr[c] = dbr[c] = 0.f;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, R);
  for (int row = r0; row < r1; ++row) {
    const float mu = mean[row], rs = rstd[row];
    const float* xr = x + (size_t)row * C;
    const float* dyr = dy + (size_t)row * C;
    float2 s = make_float2(0.f, 0.f);
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const float xh = (xr[c] - mu) * rs, gd = dyr[c] * g[c];
      s.x += gd;
      s.y += gd * xh;
    }
    s = block_sum2(s);
    const float m1 = s.x / C, m2 = s.y / C;
    float* dxr = dx + (size_t)row * C;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const float xh = (xr[c] - mu) * rs, dv = dyr[c], gd = dv * g[c];
      dxr[c] = rs * (gd - m1 - xh * m2);
      dgr[c] += dv * xh;
      dbr[c] += dv;
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int repro_layernorm_fwd_f32(const void* x, const void* g,
                                       const void* b, void* y, void* mean,
                                       void* rstd, int R, int C, float eps,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(R), block(kThreads);
  const bool vec = C % 4 == 0 && aligned16(x) && aligned16(g) &&
                   aligned16(b) && aligned16(y);
  const int per_thread = (C / 4 + kThreads - 1) / kThreads;  // float4s
  auto xv = static_cast<const float4*>(x);
  auto gv = static_cast<const float4*>(g);
  auto bv = static_cast<const float4*>(b);
  auto yv = static_cast<float4*>(y);
  auto mu = static_cast<float*>(mean);
  auto rs = static_cast<float*>(rstd);
  if (vec && per_thread <= 1) {
    ln_fwd_vec_kernel<1><<<grid, block, 0, s>>>(xv, gv, bv, yv, mu, rs, C, eps);
  } else if (vec && per_thread <= 2) {
    ln_fwd_vec_kernel<2><<<grid, block, 0, s>>>(xv, gv, bv, yv, mu, rs, C, eps);
  } else if (vec && per_thread <= 4) {
    ln_fwd_vec_kernel<4><<<grid, block, 0, s>>>(xv, gv, bv, yv, mu, rs, C, eps);
  } else if (vec && per_thread <= 8) {
    ln_fwd_vec_kernel<8><<<grid, block, 0, s>>>(xv, gv, bv, yv, mu, rs, C, eps);
  } else {
    ln_fwd_scalar_kernel<<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(b), static_cast<float*>(y), mu, rs, C, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// dgp and dbp are [ceil(R / rows_per_block), C].
extern "C" int repro_layernorm_bwd_f32(const void* x, const void* g,
                                       const void* mean, const void* rstd,
                                       const void* dy, void* dx, void* dgp,
                                       void* dbp, int R, int C,
                                       int rows_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || rows_per_block <= 0)
    return static_cast<int>(cudaGetLastError());
  const dim3 grid((R + rows_per_block - 1) / rows_per_block), block(kThreads);
  const bool vec = C % 4 == 0 && aligned16(x) && aligned16(g) &&
                   aligned16(dy) && aligned16(dx) && aligned16(dgp) &&
                   aligned16(dbp);
  const int per_thread = (C / 4 + kThreads - 1) / kThreads;
  auto xv = static_cast<const float4*>(x);
  auto gv = static_cast<const float4*>(g);
  auto mu = static_cast<const float*>(mean);
  auto rs = static_cast<const float*>(rstd);
  auto dyv = static_cast<const float4*>(dy);
  auto dxv = static_cast<float4*>(dx);
  auto dgv = static_cast<float4*>(dgp);
  auto dbv = static_cast<float4*>(dbp);
  if (vec && per_thread <= 1) {
    ln_bwd_vec_kernel<1><<<grid, block, 0, s>>>(xv, gv, mu, rs, dyv, dxv, dgv,
                                               dbv, R, C, rows_per_block);
  } else if (vec && per_thread <= 2) {
    ln_bwd_vec_kernel<2><<<grid, block, 0, s>>>(xv, gv, mu, rs, dyv, dxv, dgv,
                                               dbv, R, C, rows_per_block);
  } else if (vec && per_thread <= 4) {
    ln_bwd_vec_kernel<4><<<grid, block, 0, s>>>(xv, gv, mu, rs, dyv, dxv, dgv,
                                               dbv, R, C, rows_per_block);
  } else if (vec && per_thread <= 8) {
    ln_bwd_vec_kernel<8><<<grid, block, 0, s>>>(xv, gv, mu, rs, dyv, dxv, dgv,
                                               dbv, R, C, rows_per_block);
  } else {
    ln_bwd_scalar_kernel<<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), mu, rs,
        static_cast<const float*>(dy), static_cast<float*>(dx),
        static_cast<float*>(dgp), static_cast<float*>(dbp), R, C,
        rows_per_block);
  }
  return static_cast<int>(cudaGetLastError());
}
