// LayerNorm forward and backward for Hopper (sm_90a): x (and dy, dx) and
// the gain (and bias) each float32 or bfloat16, y and dx in x's type, the
// statistics, the partial rows and every sum in float32.
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
// not as E[x^2] - mean^2 (which differs in float32).  As the reference's
// kernels, the bfloat16 instances widen every input to float32 and round
// y and dx once, at the store (`.astype(y_ref.dtype)`).
//
// Bound: bytes.  The forward reads x and writes y (8 R C bytes in
// float32, 4 R C in bfloat16), the backward reads x and dy and writes dx
// (12 R C, 6 R C); their 8-10 operations an element are nothing beside
// that.  The TPU kernels stage a block of 128 rows in VMEM.
//
// Every vector path moves a row in 16-byte units: 4 float32 or 8
// bfloat16 values a load or store (`load_vals`, `store_vals`), widened to
// float32 in registers; a float32 gain beside a bfloat16 row is read as
// two float4 a unit, a bfloat16 gain beside a float32 row as 8 bytes.
// x's type is a template parameter, the gain's a flag (a branch uniform
// over the grid), which halves the instances to build.
//
// Forward: one block of 256 threads owns a row and holds it in registers
// as units (VPT of them a thread, up to 256 * 8 units: 8,192 columns), so
// each element is read once: the two reductions of a row (the mean, then
// the centred variance) are warp shuffles and one shared-memory step.
//
// Backward, one call of two launches, the dgamma and dbeta partials kept on
// chip.  `ln_bwd_rows_kernel`: a persistent grid of at most two CTAs an SM
// walks the rows, strided by the grid.  A group of W warps owns a row at a
// time (one warp up to 512 units: at HuBERT's 1,280 every lane carries 10
// float32 units or 5 bfloat16 units of a row, none idle), so m1 and m2 reduce
// by warp shuffles (and across a group's warps through shared memory and a
// named barrier of that group: no block barrier in the row loop).  Each group
// has a two-stage ring in shared memory that the Tensor Memory Accelerator
// fills (`cp.async.bulk`, x's and dy's rows on one mbarrier a stage), in x's
// type: a bfloat16 row takes half the bytes.  The next row is in flight while
// the current row reduces.  dx is written over x in the stage and leaves by
// one bulk store, which the stage's refill waits for.  dgamma and dbeta
// accumulate in registers (float32), a lane's columns; at the end the CTA's
// groups add theirs in shared memory in group order and the CTA writes one
// partial row of each.  A CTA's shared memory is the gain (float32) and its
// groups' rings: at HuBERT's [R, 1280], eight groups, 169 KB in float32 (one
// CTA an SM) and 87 KB in bfloat16, where shared memory lets a second CTA onto
// the SM (the cap kBwdCtasPerSM; the occupancy query decides, with the
// registers): twice the rows in flight an SM and twice the partial rows, which
// kernels/layernorm.py::BWD_PARTS_PER_SM already sizes the workspace for.
// `ln_bwd_finish_kernel` sums the partial rows in row order; it is launched
// as a programmatic dependent of the rows' kernel, which signals it as each
// CTA leaves its row loop, so its blocks are resident and waiting while the
// CTAs write their partial rows, not launched after.  Every sum is in a fixed
// order and there are no atomics, so dgamma and dbeta are the same bit for bit
// from run to run.  The TPU backward sums them over its sequential grid steps;
// CUDA blocks run in no order, hence the partials.  Rows whose width is not a
// multiple of a unit, or wider than the register path holds (8,192 columns),
// or not 16-byte aligned, take a scalar path that reads the row more than
// once, a block walking consecutive rows, then the same finishing kernel.

// C interface (bound with ctypes): every entry returns cudaGetLastError()
// after its launch.  Pointers are device pointers of contiguous tensors;
// `stream` is the caller's cudaStream_t.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "chain.cuh"

namespace {

constexpr int kThreads = 256;

using bf16 = uint16_t;  // a bfloat16 value's bits

// The values a 16-byte lane unit of T holds: 4 float32, 8 bfloat16.
template <class T>
constexpr int kUnit = 16 / static_cast<int>(sizeof(T));

// K consecutive values at p as float32 (exact), and K float32 values
// stored at p as T (rounded once, to nearest even).  A float32 run is
// read as float4 (16-byte aligned), a bfloat16 run of 8 as one 16-byte
// load, of 4 as one 8-byte load.
template <int K>
__device__ __forceinline__ void load_vals(const float* p, float (&v)[K]) {
#pragma unroll
  for (int q = 0; q < K / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}
__device__ __forceinline__ void unpack2(uint32_t u, float* v) {
  v[0] = __uint_as_float(u << 16);
  v[1] = __uint_as_float(u & 0xffff0000u);
}
template <int K>
__device__ __forceinline__ void load_vals(const bf16* p, float (&v)[K]) {
  static_assert(K == 4 || K == 8, "four or eight bfloat16 a load");
  if constexpr (K == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    unpack2(u.x, v);
    unpack2(u.y, v + 2);
    unpack2(u.z, v + 4);
    unpack2(u.w, v + 6);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    unpack2(u.x, v);
    unpack2(u.y, v + 2);
  }
}
template <int K>
__device__ __forceinline__ void store_vals(float* p, const float (&v)[K]) {
#pragma unroll
  for (int q = 0; q < K / 4; ++q)
    reinterpret_cast<float4*>(p)[q] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return repro_chain::to_bf16(a) |
         (static_cast<uint32_t>(repro_chain::to_bf16(b)) << 16);
}
template <int K>
__device__ __forceinline__ void store_vals(bf16* p, const float (&v)[K]) {
  static_assert(K == 8, "eight bfloat16 a store");
  *reinterpret_cast<uint4*>(p) = make_uint4(
      pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
      pack2(v[6], v[7]));
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const bf16* p) {
  return repro_chain::from_bf16(*p);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) {
  *p = repro_chain::to_bf16(v);
}

// The gain's (or bias's) values, float32 or bfloat16 by a flag uniform
// over the grid: K of them from index i, or one.
template <int K>
__device__ __forceinline__ void load_gain(const void* g, bool bf, int i,
                                          float (&v)[K]) {
  if (bf)
    load_vals(static_cast<const bf16*>(g) + i, v);
  else
    load_vals(static_cast<const float*>(g) + i, v);
}
__device__ __forceinline__ float gain1(const void* g, bool bf, int i) {
  return bf ? load1(static_cast<const bf16*>(g) + i)
            : load1(static_cast<const float*>(g) + i);
}

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

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
// TX is x's and y's type; the gain and the bias are bfloat16 where g_bf16
// is set, else float32.  A thread's unit is 16 bytes of x (K values).
template <int VPT, class TX>
__global__ void __launch_bounds__(kThreads)
ln_fwd_vec_kernel(const TX* __restrict__ x, const void* __restrict__ g,
                  const void* __restrict__ b, bool g_bf16,
                  TX* __restrict__ y, float* __restrict__ mean,
                  float* __restrict__ rstd, int C, float eps) {
  constexpr int K = kUnit<TX>;
  const int CK = C / K;
  const size_t row = blockIdx.x;
  const TX* xr = x + row * C;
  float v[VPT][K];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < CK) {
      load_vals(xr + c * K, v[i]);
    } else {
#pragma unroll
      for (int e = 0; e < K; ++e) v[i][e] = 0.f;
    }
    float u = 0.f;  // the unit's sum first, then the thread's
#pragma unroll
    for (int e = 0; e < K; ++e) u += v[i][e];
    s += u;
  }
  const float mu = block_sum(s) / C;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < CK) {
      float u = 0.f;
#pragma unroll
      for (int e = 0; e < K; ++e) {
        v[i][e] -= mu;
        u += v[i][e] * v[i][e];
      }
      ss += u;
    }
  }
  const float r = rsqrtf(block_sum(ss) / C + eps);
  TX* yr = y + row * C;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < CK) {
      float gv[K], bv[K];
      load_gain(g, g_bf16, c * K, gv);
      load_gain(b, g_bf16, c * K, bv);
#pragma unroll
      for (int e = 0; e < K; ++e) v[i][e] = v[i][e] * r * gv[e] + bv[e];
      store_vals(yr + c * K, v[i]);
    }
  }
  if (threadIdx.x == 0) {
    mean[row] = mu;
    rstd[row] = r;
  }
}

template <class TX>
__global__ void __launch_bounds__(kThreads)
ln_fwd_scalar_kernel(const TX* __restrict__ x, const void* __restrict__ g,
                     const void* __restrict__ b, bool g_bf16,
                     TX* __restrict__ y, float* __restrict__ mean,
                     float* __restrict__ rstd, int C, float eps) {
  const size_t row = blockIdx.x;
  const TX* xr = x + row * C;
  float s = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) s += load1(xr + c);
  const float mu = block_sum(s) / C;
  float ss = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float d = load1(xr + c) - mu;
    ss += d * d;
  }
  const float r = rsqrtf(block_sum(ss) / C + eps);
  TX* yr = y + row * C;
  for (int c = threadIdx.x; c < C; c += kThreads)
    store1(yr + c, (load1(xr + c) - mu) * r * gain1(g, g_bf16, c) +
                       gain1(b, g_bf16, c));
  if (threadIdx.x == 0) {
    mean[row] = mu;
    rstd[row] = r;
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
constexpr int kBwdWarps = 8;      // warps a CTA of the register path
constexpr int kBwdMaxVPL = 16;    // 16-byte units a lane a row
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
template <class TX>
__device__ __forceinline__ void fetch_row(TX* xs, TX* ds, const TX* x,
                                          const TX* dy, int row, int C,
                                          unsigned long long* b) {
  const uint32_t bytes = static_cast<uint32_t>(C) * sizeof(TX);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(b)),
      "r"(2 * bytes)
      : "memory");
  bulk_load(xs, x + static_cast<size_t>(row) * C, bytes, b);
  bulk_load(ds, dy + static_cast<size_t>(row) * C, bytes, b);
}

// Shared memory of one CTA: the gain [C] float32; the groups' rings
// [groups][2 stages][x (then dx), dy][C] of x's type (`xb` bytes a value;
// reused for the dgamma / dbeta sums [groups][2][C] float32, which fit:
// 8 C groups bytes, the ring's size in bfloat16, half of it in float32);
// then the group sums of m1 and m2 [2][groups][wpr][2].
__host__ __device__ inline size_t bwd_smem(int C, int groups, int wpr,
                                           int xb) {
  return 4 * static_cast<size_t>(C) +
         static_cast<size_t>(xb) * 4 * groups * C +
         sizeof(float) * 4 * groups * wpr;
}

// TX is x's, dy's and dx's type; the gain bfloat16 where g_bf16 is set,
// else float32.  A lane's unit is 16 bytes of a row (K values), VPL units
// a lane.
template <int VPL, class TX>
__global__ void __launch_bounds__(32 * kBwdWarps)
ln_bwd_rows_kernel(const TX* __restrict__ x, const void* __restrict__ g,
                   bool g_bf16, const float* __restrict__ mean,
                   const float* __restrict__ rstd,
                   const TX* __restrict__ dy, TX* __restrict__ dx,
                   float4* __restrict__ dgp, float4* __restrict__ dbp, int R,
                   int C, int wpr) {
  constexpr int K = kUnit<TX>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long bars[kBwdWarps][2];
  const int CK = C / K, C4 = C / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = blockDim.x / (32 * wpr);
  const int grp = warp / wpr, wig = warp % wpr;
  const int gthreads = 32 * wpr, t = wig * 32 + lane;
  const int stride = gridDim.x * groups;
  const float inv_c = 1.f / static_cast<float>(C);
  const uint32_t bytes = static_cast<uint32_t>(C) * sizeof(TX);
  float* gs = reinterpret_cast<float*>(smem);                   // [C]
  TX* rings = reinterpret_cast<TX*>(smem + 4 * static_cast<size_t>(C));
  TX* ring = rings + static_cast<size_t>(grp) * 4 * C;  // [2][x, dy][C]
  float2* part = reinterpret_cast<float2*>(rings + 4 * groups *
                                           static_cast<size_t>(C));
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
        fetch_row(ring + 2 * q * C, ring + (2 * q + 1) * C, x, dy,
                  row + q * stride, C, &bar[q]);
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    gs[c] = gain1(g, g_bf16, c);
  __syncthreads();  // the gain, and the barriers' initialisation

  float dg[VPL][K], db[VPL][K];
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int e = 0; e < K; ++e) dg[i][e] = db[i][e] = 0.f;
  float mu = row < R ? mean[row] : 0.f, rs = row < R ? rstd[row] : 0.f;
  for (int it = 0; row < R; row += stride, ++it) {
    const int next = row + stride;
    // the next row's statistics, in flight while this row runs
    const float mu_n = next < R ? mean[next] : 0.f;
    const float rs_n = next < R ? rstd[next] : 0.f;
    TX* xs = ring + (it & 1) * 2 * C;
    TX* ds = xs + C;
    bar_wait(&bar[it & 1], (it >> 1) & 1);
    float2 s = make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = t + i * gthreads;
      if (c < CK) {
        float xv[K], dv[K], gv[K];
        load_vals(xs + c * K, xv);
        load_vals(ds + c * K, dv);
        load_vals(gs + c * K, gv);
        // the unit's sums first, in fours as the float32 layout had them
#pragma unroll
        for (int q = 0; q < K / 4; ++q) {
          float u1 = 0.f, u2 = 0.f;
#pragma unroll
          for (int e = 4 * q; e < 4 * q + 4; ++e) {
            const float xh = (xv[e] - mu) * rs, gd = dv[e] * gv[e];
            u1 += gd;
            u2 += gd * xh;
            dg[i][e] += dv[e] * xh;
            db[i][e] += dv[e];
          }
          s.x += u1;
          s.y += u2;
        }
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
    // dx over x in the stage (rounded once to x's type), then one bulk
    // store of the row
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = t + i * gthreads;
      if (c < CK) {
        float xv[K], dv[K], gv[K];
        load_vals(xs + c * K, xv);
        load_vals(ds + c * K, dv);
        load_vals(gs + c * K, gv);
#pragma unroll
        for (int e = 0; e < K; ++e) {
          const float xh = (xv[e] - mu) * rs;
          xv[e] = rs * (dv[e] * gv[e] - m1 - xh * m2);
        }
        store_vals(xs + c * K, xv);
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
        fetch_row(xs, ds, x, dy, row + 2 * stride, C, &bar[it & 1]);
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
  float* red = reinterpret_cast<float*>(rings);  // [groups][dg, db][C]
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = t + i * gthreads;
    if (c < CK) {
      store_vals(red + grp * 2 * C + c * K, dg[i]);
      store_vals(red + grp * 2 * C + C + c * K, db[i]);
    }
  }
  __syncthreads();
  const float4* red4 = reinterpret_cast<const float4*>(red);
  for (int c = threadIdx.x; c < C4; c += blockDim.x) {
    float4 a = red4[c], b = red4[C4 + c];
    for (int q = 1; q < groups; ++q) {
      const float4 u = red4[q * 2 * C4 + c], v = red4[q * 2 * C4 + C4 + c];
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
template <class TX>
__global__ void __launch_bounds__(kThreads)
ln_bwd_scalar_kernel(const TX* __restrict__ x, const void* __restrict__ g,
                     bool g_bf16, const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     const TX* __restrict__ dy, TX* __restrict__ dx,
                     float* __restrict__ dgp, float* __restrict__ dbp, int R,
                     int C, int rows_per_block) {
  float* dgr = dgp + (size_t)blockIdx.x * C;
  float* dbr = dbp + (size_t)blockIdx.x * C;
  for (int c = threadIdx.x; c < C; c += kThreads) dgr[c] = dbr[c] = 0.f;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, R);
  for (int row = r0; row < r1; ++row) {
    const float mu = mean[row], rs = rstd[row];
    const TX* xr = x + (size_t)row * C;
    const TX* dyr = dy + (size_t)row * C;
    float2 s = make_float2(0.f, 0.f);
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const float xh = (load1(xr + c) - mu) * rs,
                  gd = load1(dyr + c) * gain1(g, g_bf16, c);
      s.x += gd;
      s.y += gd * xh;
    }
    s = block_sum2(s);
    const float m1 = s.x / C, m2 = s.y / C;
    TX* dxr = dx + (size_t)row * C;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const float xh = (load1(xr + c) - mu) * rs, dv = load1(dyr + c),
                  gd = dv * gain1(g, g_bf16, c);
      store1(dxr + c, rs * (gd - m1 - xh * m2));
      dgr[c] += dv * xh;
      dbr[c] += dv;
    }
  }
}

bool aligned(const void* p, size_t n) {
  return reinterpret_cast<size_t>(p) % n == 0;
}

// Whether the vector paths take these pointers at row width C: C a
// multiple of x's unit, every pointer of x's type 16-byte aligned, the
// gain's (and bias's) aligned for a unit's load of its type (`gb` bytes a
// value).
template <class TX>
bool vector_ok(int C, const void* const* xs, int nx, const void* const* gs,
               int ng, size_t gb) {
  const size_t kg = std::min<size_t>(kUnit<TX> * gb, 16);
  if (C % kUnit<TX> != 0) return false;
  for (int i = 0; i < nx; ++i)
    if (!aligned(xs[i], 16)) return false;
  for (int i = 0; i < ng; ++i)
    if (!aligned(gs[i], kg)) return false;
  return true;
}

template <class TX>
int layernorm_fwd(const void* x, const void* g, const void* b, bool g_bf16,
                  void* y, void* mean, void* rstd, int R, int C, float eps,
                  cudaStream_t s) {
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(R), block(kThreads);
  const void* xs[2] = {x, y};
  const void* gs[2] = {g, b};
  const bool vec = vector_ok<TX>(C, xs, 2, gs, 2, g_bf16 ? 2 : 4);
  const int per_thread = (C / kUnit<TX> + kThreads - 1) / kThreads;  // units
  auto xv = static_cast<const TX*>(x);
  auto yv = static_cast<TX*>(y);
  auto mu = static_cast<float*>(mean);
  auto rs = static_cast<float*>(rstd);
  if (vec && per_thread <= 1) {
    ln_fwd_vec_kernel<1><<<grid, block, 0, s>>>(xv, g, b, g_bf16, yv, mu, rs,
                                                C, eps);
  } else if (vec && per_thread <= 2) {
    ln_fwd_vec_kernel<2><<<grid, block, 0, s>>>(xv, g, b, g_bf16, yv, mu, rs,
                                                C, eps);
  } else if (vec && per_thread <= 4) {
    ln_fwd_vec_kernel<4><<<grid, block, 0, s>>>(xv, g, b, g_bf16, yv, mu, rs,
                                                C, eps);
  } else if (vec && per_thread <= 8) {
    ln_fwd_vec_kernel<8><<<grid, block, 0, s>>>(xv, g, b, g_bf16, yv, mu, rs,
                                                C, eps);
  } else {
    ln_fwd_scalar_kernel<<<grid, block, 0, s>>>(xv, g, b, g_bf16, yv, mu, rs,
                                                C, eps);
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

template <int VPL, class TX>
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
  constexpr int xb = sizeof(TX);
  int groups = kBwdWarps / wpr;
  while (groups > 1 && bwd_smem(C, groups, wpr, xb) > kSmemDynamic) --groups;
  const size_t bytes = bwd_smem(C, groups, wpr, xb);
  int sms = 0, per_sm = 0;
  // the limit any width may need, so that no width lowers it for another
  if ((err = cudaFuncSetAttribute(ln_bwd_rows_kernel<VPL, TX>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSmemDynamic)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, ln_bwd_rows_kernel<VPL, TX>, 32 * wpr * groups,
           bytes)) != cudaSuccess)
    return err;
  *out = BwdShape{dev, C, groups,
                  std::max(1, std::min(per_sm, kBwdCtasPerSM)) * sms, bytes};
  if (filled < 16) cache[filled++] = *out;
  return cudaSuccess;
}

// The register path's launch: at most `max_parts` CTAs; returns the
// CTAs, i.e. the partial rows written, through `nb`.
template <int VPL, class TX>
cudaError_t launch_bwd_rows(const void* x, const void* g, bool g_bf16,
                            const float* mu, const float* rs, const void* dy,
                            void* dx, float4* dgp, float4* dbp, int R, int C,
                            int wpr, int max_parts, int* nb,
                            cudaStream_t s) {
  BwdShape sh;
  cudaError_t err = bwd_shape<VPL, TX>(C, wpr, &sh);
  if (err != cudaSuccess) return err;
  *nb = std::min(std::min((R + sh.groups - 1) / sh.groups, sh.ctas),
                 max_parts);
  ln_bwd_rows_kernel<VPL, TX><<<*nb, 32 * wpr * sh.groups, sh.bytes, s>>>(
      static_cast<const TX*>(x), g, g_bf16, mu, rs,
      static_cast<const TX*>(dy), static_cast<TX*>(dx), dgp, dbp, R, C, wpr);
  return cudaGetLastError();
}

// Two launches: the rows (writing nb <= max_parts partial rows of dgp and
// dbp, each [max_parts, C]), then the sums into dg and db [C].
template <class TX>
int layernorm_bwd(const void* x, const void* g, bool g_bf16, const void* mean,
                  const void* rstd, const void* dy, void* dx, void* dgp,
                  void* dbp, void* dg, void* db, int R, int C, int max_parts,
                  cudaStream_t s) {
  if (R <= 0 || C <= 0 || max_parts <= 0)
    return static_cast<int>(cudaGetLastError());
  constexpr int K = kUnit<TX>;
  const void* xs[5] = {x, dy, dx, dgp, dbp};
  // the gain is staged in shared memory as float32: any alignment
  const bool vec = vector_ok<TX>(C, xs, 5, &g, 0, g_bf16 ? 2 : 4);
  const int CK = C / K;
  // warps a row: one up to 32 kBwdMaxVPL units (2,048 float32 or 4,096
  // bfloat16 columns), then each lane at most kBwdMaxVPL units
  const int wpr = (CK + 32 * kBwdMaxVPL - 1) / (32 * kBwdMaxVPL);
  const int vpl = wpr > 0 ? (CK + 32 * wpr - 1) / (32 * wpr) : 0;
  auto mu = static_cast<const float*>(mean);
  auto rs = static_cast<const float*>(rstd);
  auto dgv = static_cast<float4*>(dgp);
  auto dbv = static_cast<float4*>(dbp);
  int nb = 0;
  cudaError_t err = cudaSuccess;
#define REPRO_BWD_ROWS(V)                                                   \
  case V:                                                                   \
    err = launch_bwd_rows<V, TX>(x, g, g_bf16, mu, rs, dy, dx, dgv, dbv, R, \
                                 C, wpr, max_parts, &nb, s);                \
    break;
  if (vec && CK > 0 && wpr <= 4) {
    switch (vpl) {
      REPRO_BWD_ROWS(1) REPRO_BWD_ROWS(2) REPRO_BWD_ROWS(3)
      REPRO_BWD_ROWS(4) REPRO_BWD_ROWS(5) REPRO_BWD_ROWS(6)
      REPRO_BWD_ROWS(7) REPRO_BWD_ROWS(8) REPRO_BWD_ROWS(9)
      REPRO_BWD_ROWS(10) REPRO_BWD_ROWS(11) REPRO_BWD_ROWS(12)
      REPRO_BWD_ROWS(13) REPRO_BWD_ROWS(14) REPRO_BWD_ROWS(15)
      default:
        err = launch_bwd_rows<16, TX>(x, g, g_bf16, mu, rs, dy, dx, dgv, dbv,
                                      R, C, wpr, max_parts, &nb, s);
    }
  } else {
    nb = std::min(R, max_parts);
    const int rows_per_block = (R + nb - 1) / nb;
    nb = (R + rows_per_block - 1) / rows_per_block;
    ln_bwd_scalar_kernel<<<nb, kThreads, 0, s>>>(
        static_cast<const TX*>(x), g, g_bf16, mu, rs,
        static_cast<const TX*>(dy), static_cast<TX*>(dx),
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

}  // namespace

// x and y [R, C] of x's type, g and b [C] of the gain's: float32 (0) or
// bfloat16 (1) each; mean and rstd [R] float32.
extern "C" int repro_layernorm_fwd(const void* x, const void* g,
                                   const void* b, void* y, void* mean,
                                   void* rstd, int R, int C, float eps,
                                   int x_bf16, int g_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? layernorm_fwd<bf16>(x, g, b, g_bf16, y, mean, rstd, R, C,
                                      eps, s)
                : layernorm_fwd<float>(x, g, b, g_bf16, y, mean, rstd, R, C,
                                       eps, s);
}

// x, dy and dx [R, C] of x's type, g [C] of its own: float32 (0) or
// bfloat16 (1) each; mean, rstd, the partial rows and dg, db float32.
extern "C" int repro_layernorm_bwd(const void* x, const void* g,
                                   const void* mean, const void* rstd,
                                   const void* dy, void* dx, void* dgp,
                                   void* dbp, void* dg, void* db, int R,
                                   int C, int max_parts, int x_bf16,
                                   int g_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? layernorm_bwd<bf16>(x, g, g_bf16, mean, rstd, dy, dx, dgp,
                                      dbp, dg, db, R, C, max_parts, s)
                : layernorm_bwd<float>(x, g, g_bf16, mean, rstd, dy, dx, dgp,
                                       dbp, dg, db, R, C, max_parts, s);
}
