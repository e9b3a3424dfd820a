// RMSNorm forward for Hopper (sm_90a): x and the gain each float32 or
// bfloat16, y in x's type, rstd and every sum in float32.
//
// Replaces the TPU kernel `_rms_kernel` / `rmsnorm_fwd`
// (src/repro/kernels/rmsnorm.py:12,20):
//     y    = x * rsqrt(mean(x^2) + eps) * g        x, y [R, C]
//     rstd = rsqrt(mean(x^2) + eps)                 [R, 1] float32
// with x, y and g float32 or bfloat16 (y rounded to x's type once, at
// the store, as the reference's `.astype(x.dtype)`).
//
// Bound: bytes.  Each row is read once and written once (the gain is
// read once per warp or block), 8 R C bytes in all in float32, 4 R C in
// bfloat16; the 3 R C operations are nothing beside them.  The TPU
// kernel stages a block of rows in VMEM.  On the card the gain is in
// keeping enough bytes in flight and moving no extra ones, and the best
// way to do that depends on the shape, so the entry point takes one of
// three paths (chosen from the H100's timings of each, PERF.md):
//
// * The ring path, for float32 rows, where the rows fill every warp the
//   card holds at once (R at least the resident warps), a row is at most
//   3,072 columns, and at 2,048 columns or fewer each SM finds at least
//   16 rows: a persistent grid, one warp a row at a time, rows strided by
//   the grid.  Each warp has a two-stage ring in shared memory that the
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
//   block path.  No bfloat16 row takes it (its bfloat16 instances are not
//   built): the warp or the block path was faster at every bfloat16 shape
//   the H100 timed (PERF.md).
// * The warp path, for bfloat16 rows of at most 4,096 columns, a multiple
//   of 8, where the rows outnumber one wave of the block path (8 blocks an
//   SM) and are at most twice the warps it holds at once: a persistent
//   grid of 8-warp blocks, one warp a row at a time, so Llama's prefill
//   [2048, 3072] is 256 blocks, all resident at once, where the block path
//   took two waves of 256-thread blocks.  A lane holds its share of the
//   row in registers as 16-byte loads of 8 values (12 at 3,072 columns),
//   all issued before the reduction, and the next row's loads are issued
//   before the current row is reduced and stored; the gain is staged once
//   a block in shared memory while the first rows load; the sum of squares
//   is reduced by shuffles alone (no block barrier), and y leaves in
//   16-byte stores, rounded once.  Beyond twice its resident warps (at
//   [8192, 3072]) the block path was faster.
// * The block path otherwise (decode rows, rows that leave the other
//   paths' warps idle, rows up to 8,192 columns): one block of 256 threads
//   a row, the row in registers as float4 (VPT of them a thread), the sum
//   of squares reduced by shuffles and one shared-memory step.  Launch
//   latency bounds the decode row [4, 3072], where this path is the
//   fastest.
//
// Rows whose width is not a multiple of 4, or wider than the block path
// holds (8,192 columns), take a scalar loop that reads the row twice.
//
// The ring and block paths read and write four values at a time
// (`load4`, `store4`): a float4 in float32, 8 bytes of four bfloat16
// values otherwise, which widen to float32 exactly; the warp path 8
// bfloat16 values, 16 bytes.
//
// C interface (bound with ctypes): every entry returns cudaGetLastError()
// after its launch.  Pointers are device pointers of contiguous tensors;
// `stream` is the caller's cudaStream_t.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"

namespace {

using bf16 = uint16_t;  // a bfloat16 value's bits

// Four consecutive values at p (16-byte aligned in float32, 8-byte in
// bfloat16) as float32, and four float32 values stored at p in T.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  uint2 u;
  u.x = repro_chain::to_bf16(v.x) | (uint32_t(repro_chain::to_bf16(v.y)) << 16);
  u.y = repro_chain::to_bf16(v.z) | (uint32_t(repro_chain::to_bf16(v.w)) << 16);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const bf16* p) {
  return repro_chain::from_bf16(*p);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) {
  *p = repro_chain::to_bf16(v);
}

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
// grid's warps; VPL groups of four values of a row a lane (C <= 128 VPL).
// TX is x's and y's type (float32: `rmsnorm` launches no other), TG the
// gain's.
template <int VPL, class TX, class TG>
__global__ void __launch_bounds__(32 * kRingWarps)
rms_ring_kernel(const TX* __restrict__ x, const TG* __restrict__ g,
                TX* __restrict__ y, float* __restrict__ rstd, int R,
                int C, float eps) {
  // [warps][stages][C] values of TX
  extern __shared__ __align__(16) unsigned char ring_raw[];
  __shared__ unsigned long long bars[kRingWarps][kRingStages];
  const int C4 = C / 4;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  TX* ring = reinterpret_cast<TX*>(ring_raw) + warp * kRingStages * C;
  const int stride = gridDim.x * warps;
  const uint32_t bytes = static_cast<uint32_t>(C) * sizeof(TX);
  const float inv_c = 1.f / static_cast<float>(C);
  int row = blockIdx.x * warps + warp;
  if (lane == 0) {
    for (int s = 0; s < kRingStages; ++s) bar_init(&bars[warp][s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < kRingStages; ++s) {
      const int r = row + s * stride;
      if (r < R)
        bulk_load(ring + s * C, x + static_cast<size_t>(r) * C, bytes,
                  &bars[warp][s]);
    }
  }
  __syncwarp();
  float4 gv[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    gv[i] = c < C4 ? load4(g + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int it = 0; row < R; row += stride, ++it) {
    const int s = it % kRingStages;
    TX* buf = ring + s * C;
    bar_wait(&bars[warp][s], (it / kRingStages) & 1);
    float4 v[VPL];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < C4 ? load4(buf + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
      ss += v[i].x * v[i].x + v[i].y * v[i].y + v[i].z * v[i].z +
            v[i].w * v[i].w;
    }
    const float r = rsqrtf(warp_sum(ss) * inv_c + eps);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      if (c < C4)
        store4(buf + 4 * c,
               make_float4(v[i].x * r * gv[i].x, v[i].y * r * gv[i].y,
                           v[i].z * r * gv[i].z, v[i].w * r * gv[i].w));
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
template <int VPL, class TX, class TG>
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
      static_cast<int>(sizeof(TX)) * kRingWarps * kRingStages * kRingMaxC;
  if (cudaFuncSetAttribute(rms_ring_kernel<VPL, TX, TG>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           most) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rms_ring_kernel<VPL, TX, TG>, 32 * kRingWarps, bytes) !=
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
template <int VPL, class TX, class TG>
bool launch_ring(const void* x, const void* g, void* y, float* rstd, int R,
                 int C, float eps, cudaStream_t s) {
  const size_t bytes =
      sizeof(TX) * static_cast<size_t>(kRingWarps) * kRingStages * C;
  int sms = 0;
  const int ctas = ring_ctas<VPL, TX, TG>(C, bytes, &sms);
  if (ctas == 0 || R < ctas * kRingWarps ||
      (C <= kRingNarrowC && R < kRingNarrowRowsPerSm * sms))
    return false;
  rms_ring_kernel<VPL, TX, TG><<<ctas, 32 * kRingWarps, bytes, s>>>(
      static_cast<const TX*>(x), static_cast<const TG*>(g),
      static_cast<TX*>(y), rstd, R, C, eps);
  return true;
}

// ---------------------------------------------------------------------------
// the block path and the scalar path
// ---------------------------------------------------------------------------
template <int VPT, class TX, class TG>
__global__ void __launch_bounds__(kThreads)
rms_vec_kernel(const TX* __restrict__ x, const TG* __restrict__ g,
               TX* __restrict__ y, float* __restrict__ rstd, int C,
               float eps) {
  const int C4 = C / 4;
  const size_t row = blockIdx.x;
  const TX* xr = x + row * C;
  float4 v[VPT];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * kThreads;
    v[i] = c < C4 ? load4(xr + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
    ss += v[i].x * v[i].x + v[i].y * v[i].y + v[i].z * v[i].z + v[i].w * v[i].w;
  }
  const float r = rsqrtf(block_sum(ss) / C + eps);
  TX* yr = y + row * C;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < C4) {
      const float4 gv = load4(g + 4 * c);
      store4(yr + 4 * c, make_float4(v[i].x * r * gv.x, v[i].y * r * gv.y,
                                     v[i].z * r * gv.z, v[i].w * r * gv.w));
    }
  }
  if (threadIdx.x == 0) rstd[row] = r;
}

template <class TX, class TG>
__global__ void __launch_bounds__(kThreads)
rms_scalar_kernel(const TX* __restrict__ x, const TG* __restrict__ g,
                  TX* __restrict__ y, float* __restrict__ rstd, int C,
                  float eps) {
  const size_t row = blockIdx.x;
  const TX* xr = x + row * C;
  float ss = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float v = load1(xr + c);
    ss += v * v;
  }
  const float r = rsqrtf(block_sum(ss) / C + eps);
  TX* yr = y + row * C;
  for (int c = threadIdx.x; c < C; c += kThreads)
    store1(yr + c, load1(xr + c) * r * load1(g + c));
  if (threadIdx.x == 0) rstd[row] = r;
}

// ---------------------------------------------------------------------------
// the warp path (bfloat16 rows)
// ---------------------------------------------------------------------------
constexpr int kWarpRows = 8;        // rows (warps) a block of the warp path
constexpr int kWarpMaxC = 4096;     // its widest row

// 8 gain values at column c (16-byte aligned) as float32
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// One warp a bfloat16 row at a time, NV 16-byte units of 8 values a lane
// (C <= 256 NV), TG the gain's type.  A persistent grid: warp w of block b
// takes rows b kWarpRows + w, then strided by the grid's warps, the next
// row's loads issued before the current row is reduced and stored.  The
// gain is staged once a block in shared memory while the first rows load.
// The row stays packed (16-byte units) in registers until y is formed.
template <int NV, class TG>
__global__ void __launch_bounds__(32 * kWarpRows, NV <= 12 ? 2 : 1)
rms_warp_kernel(const bf16* __restrict__ x, const TG* __restrict__ g,
                bf16* __restrict__ y, float* __restrict__ rstd, int R,
                int C, float eps) {
  __shared__ __align__(16) TG s_g[kWarpMaxC];
  constexpr int GU = 16 / sizeof(TG);  // gain values a 16-byte unit
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarpRows;
  const int C8 = C / 8;
  int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  uint4 cur[NV], nxt[NV];
  auto load_row = [&](int r, uint4 (&v)[NV]) {
    const bf16* xr = x + static_cast<size_t>(r) * C;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < C8 ? *reinterpret_cast<const uint4*>(xr + 8 * c)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  if (row < R) load_row(row, cur);
  for (int i = threadIdx.x; i < C / GU; i += blockDim.x)
    reinterpret_cast<uint4*>(s_g)[i] = reinterpret_cast<const uint4*>(g)[i];
  __syncthreads();
  for (; row < R; row += stride) {
    const int next = row + stride;
    if (next < R) load_row(next, nxt);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const uint32_t w[4] = {cur[i].x, cur[i].y, cur[i].z, cur[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = __uint_as_float(w[j] << 16);
        const float b = __uint_as_float(w[j] & 0xffff0000u);
        ss = fmaf(a, a, fmaf(b, b, ss));
      }
    }
    const float r = rsqrtf(warp_sum(ss) / static_cast<float>(C) + eps);
    bf16* yr = y + static_cast<size_t>(row) * C;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c < C8) {
        float gv[8];
        load8(s_g + 8 * c, gv);
        const uint32_t w[4] = {cur[i].x, cur[i].y, cur[i].z, cur[i].w};
        uint32_t o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float a = __uint_as_float(w[j] << 16) * r * gv[2 * j];
          const float b =
              __uint_as_float(w[j] & 0xffff0000u) * r * gv[2 * j + 1];
          o[j] = repro_chain::to_bf16(a) |
                 (static_cast<uint32_t>(repro_chain::to_bf16(b)) << 16);
        }
        *reinterpret_cast<uint4*>(yr + 8 * c) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
    if (lane == 0) rstd[row] = r;
#pragma unroll
    for (int i = 0; i < NV; ++i) cur[i] = nxt[i];
  }
}

// The device's SMs, asked once a device
int device_sms() {
  static int sms[16] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 16) return 0;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    sms[dev] = 0;
  return sms[dev];
}

// Blocks of rms_warp_kernel<NV, TG> resident on the device at once, asked
// once a device
template <int NV, class TG>
int warp_blocks() {
  static int blocks[16] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 16) return 0;
  int per_sm = 0;
  if (blocks[dev] == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rms_warp_kernel<NV, TG>, 32 * kWarpRows, 0) ==
          cudaSuccess)
    blocks[dev] = per_sm * device_sms();
  return blocks[dev];
}

template <int NV, class TG>
cudaError_t launch_warp_grid(const bf16* x, const TG* g, bf16* y,
                             float* rstd, int R, int C, float eps,
                             cudaStream_t s, bool* taken) {
  const int most = warp_blocks<NV, TG>();
  // more rows than twice the resident warps: the block path was faster
  *taken = R <= 2 * kWarpRows * most;
  if (!*taken) return cudaSuccess;
  const int rows = (R + kWarpRows - 1) / kWarpRows;
  rms_warp_kernel<NV, TG>
      <<<most > 0 && most < rows ? most : rows, 32 * kWarpRows, 0, s>>>(
          x, g, y, rstd, R, C, eps);
  return cudaGetLastError();
}

// Launch the warp path if it takes the shape: bfloat16 x, C a multiple of
// 8 up to kWarpMaxC, 16-byte aligned rows and gain, more rows than one
// wave of the block path's 256-thread blocks and at most twice the warp
// path's resident warps (where the H100 measured it the fastest of the
// three paths, PERF.md).  Returns whether it launched, its error in *err.
template <class TG>
bool launch_warp(const void* x, const void* g, void* y, float* rstd, int R,
                 int C, float eps, cudaStream_t s, cudaError_t* err) {
  const bool fits = C > 0 && C % 8 == 0 && C <= kWarpMaxC &&
                    reinterpret_cast<size_t>(x) % 16 == 0 &&
                    reinterpret_cast<size_t>(y) % 16 == 0 &&
                    reinterpret_cast<size_t>(g) % 16 == 0;
  if (!fits || R <= (2048 / kThreads) * device_sms()) return false;
  auto xv = static_cast<const bf16*>(x);
  auto gv = static_cast<const TG*>(g);
  auto yv = static_cast<bf16*>(y);
  const int nv = (C / 8 + 31) / 32;
  bool taken = false;
  auto grid = nv <= 4    ? launch_warp_grid<4, TG>
               : nv <= 8  ? launch_warp_grid<8, TG>
               : nv <= 12 ? launch_warp_grid<12, TG>
                          : launch_warp_grid<16, TG>;
  *err = grid(xv, gv, yv, rstd, R, C, eps, s, &taken);
  return taken;
}

template <class TX, class TG>
int rmsnorm(const void* x, const void* g, void* y, void* rstd, int R, int C,
            float eps, cudaStream_t s) {
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  // four values a load: 16 bytes in float32, 8 in bfloat16
  constexpr size_t ax = 4 * sizeof(TX), ag = 4 * sizeof(TG);
  const bool vec = C % 4 == 0 &&
                   reinterpret_cast<size_t>(x) % ax == 0 &&
                   reinterpret_cast<size_t>(g) % ag == 0 &&
                   reinterpret_cast<size_t>(y) % ax == 0;
  auto rs = static_cast<float*>(rstd);
  if constexpr (sizeof(TX) == 2) {
    cudaError_t err = cudaSuccess;
    if (launch_warp<TG>(x, g, y, rs, R, C, eps, s, &err))
      return static_cast<int>(err);
  } else {
    // the ring path, float32 rows only (the warp or the block path was
    // faster for bfloat16 rows wherever the H100 timed the three,
    // PERF.md): a lane's four-value groups of a row, in steps of 8; `vec`
    // is what a bulk copy needs, 16-byte rows at 16-byte addresses
    const int vpl = (C / 4 + 31) / 32;
    if (vec && C > 0 && C <= kRingMaxC &&
        (vpl <= 8    ? launch_ring<8, TX, TG>(x, g, y, rs, R, C, eps, s)
         : vpl <= 16 ? launch_ring<16, TX, TG>(x, g, y, rs, R, C, eps, s)
                     : launch_ring<24, TX, TG>(x, g, y, rs, R, C, eps, s)))
      return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(R), block(kThreads);
  const int per_thread = (C / 4 + kThreads - 1) / kThreads;  // groups of 4
  auto xv = static_cast<const TX*>(x);
  auto gv = static_cast<const TG*>(g);
  auto yv = static_cast<TX*>(y);
  if (vec && per_thread <= 1) {
    rms_vec_kernel<1><<<grid, block, 0, s>>>(xv, gv, yv, rs, C, eps);
  } else if (vec && per_thread <= 2) {
    rms_vec_kernel<2><<<grid, block, 0, s>>>(xv, gv, yv, rs, C, eps);
  } else if (vec && per_thread <= 4) {
    rms_vec_kernel<4><<<grid, block, 0, s>>>(xv, gv, yv, rs, C, eps);
  } else if (vec && per_thread <= 8) {
    rms_vec_kernel<8><<<grid, block, 0, s>>>(xv, gv, yv, rs, C, eps);
  } else {
    rms_scalar_kernel<<<grid, block, 0, s>>>(xv, gv, yv, rs, C, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y [R, C] of x's type and g [C] of its own: float32 (0) or bfloat16
// (1) each; rstd [R] float32.
extern "C" int repro_rmsnorm(const void* x, const void* g, void* y,
                             void* rstd, int R, int C, float eps, int x_bf16,
                             int g_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return g_bf16 ? rmsnorm<bf16, bf16>(x, g, y, rstd, R, C, eps, s)
                  : rmsnorm<bf16, float>(x, g, y, rstd, R, C, eps, s);
  return g_bf16 ? rmsnorm<float, bf16>(x, g, y, rstd, R, C, eps, s)
                : rmsnorm<float, float>(x, g, y, rstd, R, C, eps, s);
}
