// RMSNorm forward for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel `_rms_kernel` / `rmsnorm_fwd`
// (src/repro/kernels/rmsnorm.py:12,20):
//     y    = x * rsqrt(mean(x^2) + eps) * g        x, y [R, C]
//     rstd = rsqrt(mean(x^2) + eps)                 [R, 1] float32
//
// Bound: bytes.  Each row is read once and written once (the gain is
// read once per warp or block), 8 R C bytes in all; the 3 R C operations
// are nothing beside them.  The TPU kernel stages a block of rows in
// VMEM.  On the card the gain is in keeping enough bytes in flight and
// moving no extra ones, and the best way to do that depends on the shape,
// so the entry point takes one of two paths (chosen from the H100's
// timings of both, PERF.md):
//
// * The ring path, where the rows fill every warp the card holds at once
//   (R at least the resident warps), a row is at most 3,072 columns, and
//   at 2,048 columns or fewer each SM finds at least 16 rows: a
//   persistent grid, one warp a row at a time, rows strided by the
//   grid.  Each warp has a two-stage ring in shared memory that the
//   Tensor Memory Accelerator fills (`cp.async.bulk`, one mbarrier a
//   stage): the next row is in flight while the warp reduces the current
//   one by shuffles alone (no block barrier), writes y over it in shared
//   memory and hands it to a bulk store (`cp.async.bulk` shared to
//   global), which the stage's refill waits for.  The gain is read once
//   a warp into registers.  At Llama's prefill, [2048, 3072], the 1,056
//   resident warps take about two rows each.  The bounds are where the
//   H100 measured the ring faster (PERF.md): [2048, 3072], [4096, 1024]
//   and [4096, 2048] take it, while at [2000, 2048] (Zamba2's prefill),
//   where the ring also has one CTA an SM, it was 3% slower than the
//   block path.
// * The block path otherwise (decode rows, rows that leave the ring's
//   warps idle, rows up to 8,192 columns): one block of 256 threads a
//   row, the row in registers as float4 (VPT of them a thread), the sum
//   of squares reduced by shuffles and one shared-memory step.  Launch
//   latency bounds the decode row [4, 3072], where this path is the
//   fastest.
//
// Rows whose width is not a multiple of 4, or wider than the block path
// holds (8,192 columns), take a scalar loop that reads the row twice.
//
// C interface (bound with ctypes): every entry returns cudaGetLastError()
// after its launch.  Pointers are device pointers of contiguous tensors;
// `stream` is the caller's cudaStream_t.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // the block path's and scalar path's block
constexpr int kRingWarps = 8;     // warps a CTA of the ring path
constexpr int kRingMaxC = 3072;   // the ring path's widest row
constexpr int kRingNarrowC = 2048;  // at most this wide, the ring path
constexpr int kRingNarrowRowsPerSm = 16;  // ... needs these rows an SM
constexpr int kRingStages = 2;

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

// ---------------------------------------------------------------------------
// the ring path
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(b)));
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

// global -> shared, `bytes` a multiple of 16, both 16-byte aligned;
// completes `bytes` on the barrier, whose arrival it also makes
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes,
                                          unsigned long long* b) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

// shared -> global, one bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Warp `w` of CTA `b` takes rows b * warps + w, then strided by the
// grid's warps; VPL float4 of a row a lane (C <= 128 VPL).
template <int VPL>
__global__ void __launch_bounds__(32 * kRingWarps)
rms_ring_kernel(const float* __restrict__ x, const float4* __restrict__ g,
                float* __restrict__ y, float* __restrict__ rstd, int R,
                int C, float eps) {
  extern __shared__ __align__(16) float4 ring4[];  // [warps][stages][C4]
  __shared__ unsigned long long bars[kRingWarps][kRingStages];
  const int C4 = C / 4;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4* ring = ring4 + warp * kRingStages * C4;
  const int stride = gridDim.x * warps;
  const uint32_t bytes = static_cast<uint32_t>(C) * 4u;
  const float inv_c = 1.f / static_cast<float>(C);
  int row = blockIdx.x * warps + warp;
  if (lane == 0) {
    for (int s = 0; s < kRingStages; ++s) bar_init(&bars[warp][s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < kRingStages; ++s) {
      const int r = row + s * stride;
      if (r < R)
        bulk_load(ring + s * C4, x + static_cast<size_t>(r) * C, bytes,
                  &bars[warp][s]);
    }
  }
  __syncwarp();
  float4 gv[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    gv[i] = c < C4 ? __ldg(g + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int it = 0; row < R; row += stride, ++it) {
    const int s = it % kRingStages;
    float4* buf = ring + s * C4;
    bar_wait(&bars[warp][s], (it / kRingStages) & 1);
    float4 v[VPL];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < C4 ? buf[c] : make_float4(0.f, 0.f, 0.f, 0.f);
      ss += v[i].x * v[i].x + v[i].y * v[i].y + v[i].z * v[i].z +
            v[i].w * v[i].w;
    }
    const float r = rsqrtf(warp_sum(ss) * inv_c + eps);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      if (c < C4)
        buf[c] = make_float4(v[i].x * r * gv[i].x, v[i].y * r * gv[i].y,
                             v[i].z * r * gv[i].z, v[i].w * r * gv[i].w);
    }
    if (lane == 0) rstd[row] = r;
    // y is in the stage: make the writes visible to the bulk copy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      bulk_store(y + static_cast<size_t>(row) * C, buf, bytes);
      const int next = row + kRingStages * stride;
      if (next < R) {
        // the store has read the stage before it is refilled
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        bulk_load(buf, x + static_cast<size_t>(next) * C, bytes,
                  &bars[warp][s]);
      }
    }
    __syncwarp();
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// CTAs of the ring path at row width C on the current device (kRingWarps
// warps each, as many as fit the SMs at once), 0 where they cannot run,
// and the device's SMs in `sms`.  The first call for a (device, C) sets
// the kernel's shared-memory limit and asks the occupancy; later calls
// read a small set-once cache, so a decode step's launches pay no CUDA
// runtime queries.
template <int VPL>
int ring_ctas(int C, size_t bytes, int* sms_out) {
  struct Entry {
    int dev, C, ctas, sms;
  };
  static Entry cache[16];
  static int filled = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  for (int i = 0; i < filled; ++i)
    if (cache[i].dev == dev && cache[i].C == C) {
      *sms_out = cache[i].sms;
      return cache[i].ctas;
    }
  int sms = 0, per_sm = 0;
  // the limit for the widest row, so that no width lowers it for another
  constexpr int most =
      static_cast<int>(sizeof(float)) * kRingWarps * kRingStages * kRingMaxC;
  if (cudaFuncSetAttribute(rms_ring_kernel<VPL>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           most) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rms_ring_kernel<VPL>, 32 * kRingWarps, bytes) !=
          cudaSuccess)
    return 0;
  if (filled < 16) cache[filled++] = Entry{dev, C, per_sm * sms, sms};
  *sms_out = sms;
  return per_sm * sms;
}

// Launch the ring path if it takes the shape: its CTAs must all find
// rows, and at kRingNarrowC columns or fewer each SM must find
// kRingNarrowRowsPerSm; else the block path is the faster.  Returns
// whether it launched.
template <int VPL>
bool launch_ring(const void* x, const void* g, void* y, float* rstd, int R,
                 int C, float eps, cudaStream_t s) {
  const size_t bytes =
      sizeof(float) * static_cast<size_t>(kRingWarps) * kRingStages * C;
  int sms = 0;
  const int ctas = ring_ctas<VPL>(C, bytes, &sms);
  if (ctas == 0 || R < ctas * kRingWarps ||
      (C <= kRingNarrowC && R < kRingNarrowRowsPerSm * sms))
    return false;
  rms_ring_kernel<VPL><<<ctas, 32 * kRingWarps, bytes, s>>>(
      static_cast<const float*>(x), static_cast<const float4*>(g),
      static_cast<float*>(y), rstd, R, C, eps);
  return true;
}

// ---------------------------------------------------------------------------
// the block path and the scalar path
// ---------------------------------------------------------------------------
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
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec = C % 4 == 0 &&
                   reinterpret_cast<size_t>(x) % 16 == 0 &&
                   reinterpret_cast<size_t>(g) % 16 == 0 &&
                   reinterpret_cast<size_t>(y) % 16 == 0;
  auto rs = static_cast<float*>(rstd);
  // the ring path: a lane's float4 of a row, in steps of 8
  const int vpl = (C / 4 + 31) / 32;
  if (vec && C > 0 && C <= kRingMaxC &&
      (vpl <= 8    ? launch_ring<8>(x, g, y, rs, R, C, eps, s)
       : vpl <= 16 ? launch_ring<16>(x, g, y, rs, R, C, eps, s)
                   : launch_ring<24>(x, g, y, rs, R, C, eps, s)))
    return static_cast<int>(cudaGetLastError());
  const dim3 grid(R), block(kThreads);
  const int per_thread = (C / 4 + kThreads - 1) / kThreads;  // float4s
  auto xv = static_cast<const float4*>(x);
  auto gv = static_cast<const float4*>(g);
  auto yv = static_cast<float4*>(y);
  if (vec && per_thread <= 1) {
    rms_vec_kernel<1><<<grid, block, 0, s>>>(xv, gv, yv, rs, C, eps);
  } else if (vec && per_thread <= 2) {
    rms_vec_kernel<2><<<grid, block, 0, s>>>(xv, gv, yv, rs, C, eps);
  } else if (vec && per_thread <= 4) {
    rms_vec_kernel<4><<<grid, block, 0, s>>>(xv, gv, yv, rs, C, eps);
  } else if (vec && per_thread <= 8) {
    rms_vec_kernel<8><<<grid, block, 0, s>>>(xv, gv, yv, rs, C, eps);
  } else {
    rms_scalar_kernel<<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<float*>(y), rs, C, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
