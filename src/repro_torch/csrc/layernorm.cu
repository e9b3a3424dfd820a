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
// block of 128 rows in VMEM.
//
// Forward: one block of 256 threads owns a row and holds it in registers
// as float4 (VPT of them a thread, up to 256 * 4 * 8 = 8192 columns), so
// each element is read once: the two reductions of a row (the mean, then
// the centred variance) are warp shuffles and one shared-memory step.
//
// Backward, one call of two launches, the dgamma and dbeta partials kept
// on chip.  `ln_bwd_rows_kernel`: a persistent grid of at most two CTAs an
// SM walks the rows, strided by the grid.  A group of W warps owns a row
// at a time (one warp up to 2,048 columns: at HuBERT's 1,280 every lane
// carries 10 float4 of a row, none idle), so m1 and m2 reduce by warp
// shuffles (and across a group's warps through shared memory and a named
// barrier of that group: no block barrier in the row loop).  Each group
// has a two-stage ring in shared memory that the Tensor Memory
// Accelerator fills (`cp.async.bulk`, x's and dy's rows on one mbarrier a
// stage): the next row is in flight while the current row reduces.  dx
// is written over x in the stage and leaves by one bulk store, which the
// stage's refill waits for.  dgamma and dbeta accumulate in registers, a
// lane's columns; at the end the CTA's groups add theirs in shared memory
// in group order and the CTA writes one partial row of each.
// `ln_bwd_finish_kernel` sums the partial rows in row order; it is
// launched as a programmatic dependent of the rows' kernel, which signals
// it as each CTA leaves its row loop, so its blocks are resident and
// waiting while the CTAs write their partial rows, not launched after.
// Every sum is in a fixed order and there are no atomics, so dgamma and
// dbeta are the same bit for bit from run to run.  The TPU backward sums
// them over its sequential grid steps; CUDA blocks run in no order, hence
// the partials.  Rows whose width is not a multiple of 4, or wider than
// the register path holds (8,192 columns), take a scalar path that reads
// the row more than once, a block walking consecutive rows, then the same
// finishing kernel.

// C interface (bound with ctypes): every entry returns cudaGetLastError()
// after its launch.  Pointers are device pointers of contiguous float32
// tensors; `stream` is the caller's cudaStream_t.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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
constexpr int kBwdWarps = 8;      // warps a CTA of the register path
constexpr int kBwdMaxVPL = 16;    // float4 a lane a row
constexpr int kBwdCtasPerSM = 2;  // partial rows: at most two an SM
// dynamic shared memory a block may use: the card's 232,448 bytes less
// the static barriers and a margin
constexpr int kSmemDynamic = 232448 - 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void group_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_wait(unsigned long long* b,
                                         uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "bra.uni WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}
// global -> shared, `bytes` a multiple of 16, both 16-byte aligned,
// completing on the barrier
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes,
                                          unsigned long long* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

// x and dy of `row` into a ring stage, one barrier arrival for both
__device__ __forceinline__ void fetch_row(float* xs, float* ds,
                                          const float* x, const float* dy,
                                          int row, int C,
                                          unsigned long long* b) {
  const uint32_t bytes = static_cast<uint32_t>(C) * 4u;
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(b)),
      "r"(2 * bytes)
      : "memory");
  bulk_load(xs, x + static_cast<size_t>(row) * C, bytes, b);
  bulk_load(ds, dy + static_cast<size_t>(row) * C, bytes, b);
}

// Shared memory of one CTA: the gain [C] and the groups' rings
// [groups][2 stages][x (then dx), dy][C] (reused for the dgamma / dbeta
// sums), then the group sums of m1 and m2 [2][groups][wpr][2].
__host__ __device__ inline size_t bwd_smem(int C, int groups, int wpr) {
  return sizeof(float) * (static_cast<size_t>(C) * (1 + 4 * groups) +
                          4 * groups * wpr);
}

template <int VPL>
__global__ void __launch_bounds__(32 * kBwdWarps)
ln_bwd_rows_kernel(const float* __restrict__ x, const float4* __restrict__ g,
                   const float* __restrict__ mean,
                   const float* __restrict__ rstd,
                   const float* __restrict__ dy, float* __restrict__ dx,
                   float4* __restrict__ dgp, float4* __restrict__ dbp, int R,
                   int C, int wpr) {
  extern __shared__ __align__(16) float4 smem4[];
  __shared__ unsigned long long bars[kBwdWarps][2];
  const int C4 = C / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = blockDim.x / (32 * wpr);
  const int grp = warp / wpr, wig = warp % wpr;
  const int gthreads = 32 * wpr, t = wig * 32 + lane;
  const int stride = gridDim.x * groups;
  const float inv_c = 1.f / static_cast<float>(C);
  const uint32_t bytes = static_cast<uint32_t>(C) * 4u;
  float4* gs = smem4;                       // [C4]
  float4* ring = smem4 + C4 + grp * 4 * C4;  // [2][x, dy][C4]
  float2* part = reinterpret_cast<float2*>(smem4 + C4 * (1 + 4 * groups));
  unsigned long long* bar = bars[grp];

  int row = blockIdx.x * groups + grp;
  if (t == 0) {  // the group's issuing thread
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
        smem_u32(&bar[0])));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
        smem_u32(&bar[1])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int q = 0; q < 2; ++q)
      if (row + q * stride < R)
        fetch_row(reinterpret_cast<float*>(ring + 2 * q * C4),
                  reinterpret_cast<float*>(ring + (2 * q + 1) * C4), x, dy,
                  row + q * stride, C, &bar[q]);
  }
  for (int c = threadIdx.x; c < C4; c += blockDim.x) gs[c] = g[c];
  __syncthreads();  // the gain, and the barriers' initialisation

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 dg[VPL], db[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) dg[i] = db[i] = zero;
  float mu = row < R ? mean[row] : 0.f, rs = row < R ? rstd[row] : 0.f;
  for (int it = 0; row < R; row += stride, ++it) {
    const int next = row + stride;
    // the next row's statistics, in flight while this row runs
    const float mu_n = next < R ? mean[next] : 0.f;
    const float rs_n = next < R ? rstd[next] : 0.f;
    float4* xs = ring + (it & 1) * 2 * C4;
    float4* ds = xs + C4;
    bar_wait(&bar[it & 1], (it >> 1) & 1);
    float2 s = make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = t + i * gthreads;
      if (c < C4) {
        const float4 xv = xs[c], dv = ds[c], gv = gs[c];
        const float4 xh = make_float4((xv.x - mu) * rs, (xv.y - mu) * rs,
                                      (xv.z - mu) * rs, (xv.w - mu) * rs);
        const float4 gd = make_float4(dv.x * gv.x, dv.y * gv.y, dv.z * gv.z,
                                      dv.w * gv.w);
        s.x += sum4(gd);
        s.y += gd.x * xh.x + gd.y * xh.y + gd.z * xh.z + gd.w * xh.w;
        dg[i].x += dv.x * xh.x;
        dg[i].y += dv.y * xh.y;
        dg[i].z += dv.z * xh.z;
        dg[i].w += dv.w * xh.w;
        db[i].x += dv.x;
        db[i].y += dv.y;
        db[i].z += dv.z;
        db[i].w += dv.w;
      }
    }
    s = warp_sum2(s);
    if (wpr > 1) {
      // two slots in turn, as a warp rewrites its slot only after every
      // warp of its group has passed the previous iteration's barrier
      float2* slot = part + ((it & 1) * groups + grp) * wpr;
      if (lane == 0) slot[wig] = s;
      group_barrier(1 + grp, gthreads);
      s = make_float2(0.f, 0.f);
      for (int w = 0; w < wpr; ++w) {
        s.x += slot[w].x;
        s.y += slot[w].y;
      }
    }
    const float m1 = s.x * inv_c, m2 = s.y * inv_c;
    // dx over x in the stage, then one bulk store of the row
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = t + i * gthreads;
      if (c < C4) {
        const float4 xv = xs[c], dv = ds[c], gv = gs[c];
        const float4 xh = make_float4((xv.x - mu) * rs, (xv.y - mu) * rs,
                                      (xv.z - mu) * rs, (xv.w - mu) * rs);
        xs[c] = make_float4(rs * (dv.x * gv.x - m1 - xh.x * m2),
                            rs * (dv.y * gv.y - m1 - xh.y * m2),
                            rs * (dv.z * gv.z - m1 - xh.z * m2),
                            rs * (dv.w * gv.w - m1 - xh.w * m2));
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (wpr > 1)
      group_barrier(1 + groups + grp, gthreads);
    else
      __syncwarp();
    if (t == 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
              dx + static_cast<size_t>(row) * C),
          "r"(smem_u32(xs)), "r"(bytes)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      if (row + 2 * stride < R) {
        // the store has read the stage: refill it with the row after next
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        fetch_row(reinterpret_cast<float*>(xs), reinterpret_cast<float*>(ds),
                  x, dy, row + 2 * stride, C, &bar[it & 1]);
      }
    }
    mu = mu_n;
    rs = rs_n;
  }
  // the rows are done: the finishing kernel may be scheduled (it waits
  // for this grid's partial rows)
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  __syncthreads();  // every ring is read and stored: reuse it for the sums
  float4* red = smem4 + C4;  // [groups][dg, db][C4]
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = t + i * gthreads;
    if (c < C4) {
      red[grp * 2 * C4 + c] = dg[i];
      red[grp * 2 * C4 + C4 + c] = db[i];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C4; c += blockDim.x) {
    float4 a = red[c], b = red[C4 + c];
    for (int q = 1; q < groups; ++q) {
      const float4 u = red[q * 2 * C4 + c], v = red[q * 2 * C4 + C4 + c];
      a = make_float4(a.x + u.x, a.y + u.y, a.z + u.z, a.w + u.w);
      b = make_float4(b.x + v.x, b.y + v.y, b.z + v.z, b.w + v.w);
    }
    dgp[static_cast<size_t>(blockIdx.x) * C4 + c] = a;
    dbp[static_cast<size_t>(blockIdx.x) * C4 + c] = b;
  }
}

// dgamma, dbeta [C] = the sums of the [nb, C] partial rows: a block of
// 32 columns x 8 row slices of one of the two, each slice summed in row
// order, then the 8 in slice order.  Launched as a dependent of the rows'
// kernel (programmatic dependent launch): its blocks may start early and
// wait here for that grid to complete.
__global__ void __launch_bounds__(256)
ln_bwd_finish_kernel(const float* __restrict__ dgp,
                     const float* __restrict__ dbp, float* __restrict__ dg,
                     float* __restrict__ db, int nb, int C) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __shared__ float acc[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  const float* src = blockIdx.y ? dbp : dgp;
  float a = 0.f;
  if (c < C)
    for (int r = ty; r < nb; r += 8) a += src[static_cast<size_t>(r) * C + c];
  acc[ty][tx] = a;
  __syncthreads();
  if (ty == 0 && c < C) {
    float total = acc[0][tx];
#pragma unroll
    for (int q = 1; q < 8; ++q) total += acc[q][tx];
    (blockIdx.y ? db : dg)[c] = total;
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

// The rows kernel's launch shape at row width C on the current device:
// groups of `wpr` warps, as many a CTA as its shared memory allows (at
// most kBwdWarps warps), and its CTAs an SM (at most kBwdCtasPerSM).  The
// first call for a (device, C) sets the kernel's shared-memory limit and
// asks the occupancy; later calls read a small set-once cache.
struct BwdShape {
  int dev, C, groups, ctas;
  size_t bytes;
};

template <int VPL>
cudaError_t bwd_shape(int C, int wpr, BwdShape* out) {
  static BwdShape cache[16];
  static int filled = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < filled; ++i)
    if (cache[i].dev == dev && cache[i].C == C) {
      *out = cache[i];
      return cudaSuccess;
    }
  int groups = kBwdWarps / wpr;
  while (groups > 1 && bwd_smem(C, groups, wpr) > kSmemDynamic) --groups;
  const size_t bytes = bwd_smem(C, groups, wpr);
  int sms = 0, per_sm = 0;
  // the limit any width may need, so that no width lowers it for another
  if ((err = cudaFuncSetAttribute(ln_bwd_rows_kernel<VPL>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSmemDynamic)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, ln_bwd_rows_kernel<VPL>, 32 * wpr * groups, bytes)) !=
          cudaSuccess)
    return err;
  *out = BwdShape{dev, C, groups,
                  std::max(1, std::min(per_sm, kBwdCtasPerSM)) * sms, bytes};
  if (filled < 16) cache[filled++] = *out;
  return cudaSuccess;
}

// The register path's launch: at most `max_parts` CTAs; returns the
// CTAs, i.e. the partial rows written, through `nb`.
template <int VPL>
cudaError_t launch_bwd_rows(const void* x, const float4* g, const float* mu,
                            const float* rs, const void* dy, void* dx,
                            float4* dgp, float4* dbp, int R, int C, int wpr,
                            int max_parts, int* nb, cudaStream_t s) {
  BwdShape sh;
  cudaError_t err = bwd_shape<VPL>(C, wpr, &sh);
  if (err != cudaSuccess) return err;
  *nb = std::min(std::min((R + sh.groups - 1) / sh.groups, sh.ctas),
                 max_parts);
  ln_bwd_rows_kernel<VPL><<<*nb, 32 * wpr * sh.groups, sh.bytes, s>>>(
      static_cast<const float*>(x), g, mu, rs, static_cast<const float*>(dy),
      static_cast<float*>(dx), dgp, dbp, R, C, wpr);
  return cudaGetLastError();
}

// Two launches: the rows (writing nb <= max_parts partial rows of dgp and
// dbp, each [max_parts, C]), then the sums into dg and db [C].
extern "C" int repro_layernorm_bwd_f32(const void* x, const void* g,
                                       const void* mean, const void* rstd,
                                       const void* dy, void* dx, void* dgp,
                                       void* dbp, void* dg, void* db, int R,
                                       int C, int max_parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || C <= 0 || max_parts <= 0)
    return static_cast<int>(cudaGetLastError());
  const bool vec = C % 4 == 0 && aligned16(x) && aligned16(g) &&
                   aligned16(dy) && aligned16(dx) && aligned16(dgp) &&
                   aligned16(dbp);
  const int C4 = C / 4;
  // warps a row: one up to 2,048 columns, then each lane at most
  // kBwdMaxVPL float4
  const int wpr = (C4 + 32 * kBwdMaxVPL - 1) / (32 * kBwdMaxVPL);
  const int vpl = wpr > 0 ? (C4 + 32 * wpr - 1) / (32 * wpr) : 0;
  auto gv = static_cast<const float4*>(g);
  auto mu = static_cast<const float*>(mean);
  auto rs = static_cast<const float*>(rstd);
  auto dgv = static_cast<float4*>(dgp);
  auto dbv = static_cast<float4*>(dbp);
  int nb = 0;
  cudaError_t err = cudaSuccess;
#define REPRO_BWD_ROWS(V)                                                   \
  case V:                                                                   \
    err = launch_bwd_rows<V>(x, gv, mu, rs, dy, dx, dgv, dbv, R, C, wpr,     \
                             max_parts, &nb, s);                            \
    break;
  if (vec && C4 > 0 && wpr <= 4) {
    switch (vpl) {
      REPRO_BWD_ROWS(1) REPRO_BWD_ROWS(2) REPRO_BWD_ROWS(3)
      REPRO_BWD_ROWS(4) REPRO_BWD_ROWS(5) REPRO_BWD_ROWS(6)
      REPRO_BWD_ROWS(7) REPRO_BWD_ROWS(8) REPRO_BWD_ROWS(9)
      REPRO_BWD_ROWS(10) REPRO_BWD_ROWS(11) REPRO_BWD_ROWS(12)
      REPRO_BWD_ROWS(13) REPRO_BWD_ROWS(14) REPRO_BWD_ROWS(15)
      default:
        err = launch_bwd_rows<16>(x, gv, mu, rs, dy, dx, dgv, dbv, R, C,
                                  wpr, max_parts, &nb, s);
    }
  } else {
    nb = std::min(R, max_parts);
    const int rows_per_block = (R + nb - 1) / nb;
    nb = (R + rows_per_block - 1) / rows_per_block;
    ln_bwd_scalar_kernel<<<nb, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), mu, rs,
        static_cast<const float*>(dy), static_cast<float*>(dx),
        static_cast<float*>(dgp), static_cast<float*>(dbp), R, C,
        rows_per_block);
    err = cudaGetLastError();
  }
#undef REPRO_BWD_ROWS
  if (err != cudaSuccess) return static_cast<int>(err);
  // the sums, a programmatic dependent of the rows' launch
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((C + 31) / 32, 2);
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, ln_bwd_finish_kernel, static_cast<const float*>(dgp),
      static_cast<const float*>(dbp), static_cast<float*>(dg),
      static_cast<float*>(db), nb, C));
}
