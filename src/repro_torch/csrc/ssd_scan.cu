// Mamba-2 SSD chunked scan for Hopper (sm_90a), float32, chunk-parallel
// on the tensor cores.
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_scan`
// (src/repro/kernels/ssd_scan.py:25,75):
//     x [b, L, H, P], dt [b, L, H], A [H], B and C [b, L, N] (one group,
//     shared by the heads) -> y [b, L, H, P], final state [b, H, P, N]
// For each chunk of c rows, with the state h [P, N] carried across:
//     cum     = cumsum(dt * A)
//     W[i, j] = (C B^T)[i, j] * exp(cum_i - cum_j) * dt_j   for i >= j, else 0
//     y       = W @ x + exp(cum) * (C @ h^T)
//     h       = h * exp(cum_last) + (x * exp(cum_last - cum) * dt)^T @ B
// The decay exponent is taken only where i >= j (the masked pairs, whose
// exponent is positive, never overflow).
//
// Bound: operations (products at the split's float32 rate on the tensor
// cores) at Mamba2's shapes, bytes at Zamba2's.  The TPU kernel's grid is
// (b, H, chunks), the chunk axis sequential with the state in VMEM
// between grid steps, and C B^T recomputed per head.  On the card that
// order leaves b H blocks (128-256 on 132 SMs) each walking its chunks,
// its products in turn.  Here the chunks run in parallel, in three
// launches:
//   (a) ssd_chunk_kernel, a block per (batch, chunk, head): the chunk's
//       own state contribution S = (x * exp(cum_last - cum) * dt)^T B
//       [P, N] and cum_last, to scratch; and C B^T [c, c], once per
//       (batch, chunk): its 32-row strips are computed by the chunk's
//       first heads' blocks, to scratch, for every head of (c) to read.
//   (b) ssd_pass_kernel, a thread per (batch, head, state element): the
//       chain over the chunks in order, h = h exp(cum_last) + S, leaving
//       in place of each S the state entering its chunk (eight chunks'
//       loads in flight at a time), and the final state.
//   (c) ssd_output_kernel, a block per (batch, chunk, group of up to
//       four heads where two such blocks fit an SM, else one head): y = W
//       x + (exp(cum) * C) h^T in one accumulator, h the state entering
//       the chunk, W = C B^T * exp(cum_i - cum_j) * dt_j (i >= j) formed
//       as its fragments are read; C and C B^T are copied once for the
//       group, and the next head's x, h and dt while a head multiplies; y
//       is written once.
// The four products (C B^T, the state's, W x, C h^T) run on the tensor
// cores, `mma.sync.m16n8k8` TF32, through the three-way split of
// mma_tf32.cuh (kernels/split_float.py: its plain form and the step-0
// measurement of these products), one float32 sum over each product's
// contracted extent; each warp owns 32 x 32 of a product's output, so a
// split fragment feeds four or two products.  Operand tiles are copied
// to shared memory by cp.async, rows padded by four floats.  Any head dim
// P and state N, and any chunk up to 64 rows, are zero-padded to the
// tiles (32 rows, 32 columns) in shared memory: zero rows (dt 0) neither
// decay nor contribute.  The chunk states that (a) writes, (b) rewrites
// and (c) reads are the design's own traffic above the function's bound;
// x is read twice, by (a) and (c).
//
// C interface (bound with ctypes): returns the first CUDA error of the
// launches, or 0.  x, dt, B, C are taken with their element strides (x,
// B, C with a contiguous last dimension); y and the state are
// contiguous; S [b, L / c, H, P, N], cum_last [b, L / c, H] and C B^T
// [b, L / c, c', c'] (c' the chunk padded to 32) are scratch the caller
// allocates.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

using repro_tf32::mma_tf32;
using repro_tf32::split_tf32;

constexpr int kThreadsA = 128;  // pass (a): four warps
constexpr int kThreadsC = 256;  // pass (c): eight warps
constexpr int kThreadsB = 128;  // pass (b): a thread a state element
constexpr int kMaxChunk = 64;   // two rows a lane in the cumulative sum
constexpr int kTile = 32;       // padding of the chunk, P and N

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  float* y;
  float* state;
  float* S;
  float* cl;
  float* CB;
  long long x_sb, x_sl, x_sh;
  long long dt_sb, dt_sl, dt_sh;
  long long b_sb, b_sl;
  long long c_sb, c_sl;
  int L, H, P, N, chunk, nc, hg;
};

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Padded extents and the shared-memory row strides, in floats (each a
// multiple of 4; 4 past a multiple of 32, so that a fragment's reads hit
// 32 banks).
struct Dims {
  int c, P, N;
  int ns, ps, cs;
};

__host__ __device__ inline Dims dims(int chunk, int P, int N) {
  Dims d;
  d.c = round_up(chunk, kTile);
  d.P = round_up(P, kTile);
  d.N = round_up(N, kTile);
  d.ns = d.N + 4;
  d.ps = d.P + 4;
  d.cs = d.c + 4;
  return d;
}

// Pass (a): B [c][ns]; x [c][ps]; a strip of C [32][ns]; dt, cum and
// exp(cum_last - cum) dt [c] each.
__host__ __device__ inline size_t smem_a(const Dims& d) {
  return sizeof(float) * static_cast<size_t>(d.c * d.ns + d.c * d.ps +
                                             kTile * d.ns + 3 * d.c);
}
// Pass (c): C [c][ns]; C B^T [c][cs]; cum and exp(cum) [c]; and for
// each of `bufs` heads in flight x [c][ps], h [P][ns] and dt [c].
__host__ __device__ inline int head_floats(const Dims& d) {
  return d.c * d.ps + d.P * d.ns + d.c;
}
__host__ __device__ inline size_t smem_c(const Dims& d, int bufs) {
  return sizeof(float) * static_cast<size_t>(d.c * d.ns + d.c * d.cs +
                                             2 * d.c + bufs * head_floats(d));
}

// f(i0, n0) for each (16 SR) x 32 item of an M x Nc output, the block's
// warps taking them in turn
template <int SR, class F>
__device__ __forceinline__ void for_items(int M, int Nc, F f) {
  const int groups = Nc / kTile;
  for (int item = threadIdx.x >> 5; item < (M / (16 * SR)) * groups;
       item += blockDim.x >> 5)
    f((item / groups) * 16 * SR, (item % groups) * kTile);
}

// acc += A B over K (a multiple of 8) for the item at (i0, n0), on the
// tensor cores: the split's three TF32 products into the float32
// accumulator.  acc[r][q] is the m16n8 fragment of rows i0 + 16 r, columns
// n0 + 8 q; a(i, k) and b(k, j) read shared memory.  Each k8 step splits
// SR A fragments and four B fragments and issues 12 SR products, term by
// term, so that the accumulator chains interleave.
template <int SR, class FA, class FB>
__device__ __forceinline__ void mma_item(float (&acc)[SR][4][4], int i0,
                                         int n0, int K, FA a, FB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ab[SR][4], as[SR][4], bb[4][2], bs[4][2];
#pragma unroll
    for (int r = 0; r < SR; ++r) {
      const int i = i0 + 16 * r + g;
      split_tf32(a(i, k0 + t), ab[r][0], as[r][0]);
      split_tf32(a(i + 8, k0 + t), ab[r][1], as[r][1]);
      split_tf32(a(i, k0 + t + 4), ab[r][2], as[r][2]);
      split_tf32(a(i + 8, k0 + t + 4), ab[r][3], as[r][3]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = n0 + 8 * q + g;
      split_tf32(b(k0 + t, j), bb[q][0], bs[q][0]);
      split_tf32(b(k0 + t + 4, j), bb[q][1], bs[q][1]);
    }
    // the small terms first, as mma_tf32.cuh::mma3 takes them
#pragma unroll
    for (int r = 0; r < SR; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        mma_tf32(acc[r][q], as[r], bb[q][0], bb[q][1]);
#pragma unroll
    for (int r = 0; r < SR; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        mma_tf32(acc[r][q], ab[r], bs[q][0], bs[q][1]);
#pragma unroll
    for (int r = 0; r < SR; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        mma_tf32(acc[r][q], ab[r], bb[q][0], bb[q][1]);
  }
}

// f(i, j, v) for each element of an item's accumulator
template <int SR, class F>
__device__ __forceinline__ void for_acc(float (&acc)[SR][4][4], int i0,
                                        int n0, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < SR; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + 16 * r + g, j = n0 + 8 * q + 2 * t;
      f(i, j, acc[r][q][0]);
      f(i, j + 1, acc[r][q][1]);
      f(i + 8, j, acc[r][q][2]);
      f(i + 8, j + 1, acc[r][q][3]);
    }
}

template <int SR>
__device__ __forceinline__ void zero(float (&acc)[SR][4][4]) {
#pragma unroll
  for (int r = 0; r < SR; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][q][e] = 0.f;
}

// f(r, n) over a rows x cols tile: a warp a row, its lanes along it
template <class F>
__device__ __forceinline__ void for_tile(int rows, int cols, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += blockDim.x >> 5)
    for (int n = lane; n < cols; n += 32) f(r, n);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared without registers; `in` false writes zeros
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}
// all but the last committed group have landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Start copying a [rows][stride] tile of an operand with row stride sl
// and contiguous columns, from row l0, zero past (valid rows, width):
// 16 bytes a copy where the rows allow it.
__device__ __forceinline__ void load_tile(float* dst, int rows, int cols,
                                          int stride, const float* src,
                                          long long sl, int l0, int valid,
                                          int width) {
  const bool vec = reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   sl % 4 == 0 && width % 4 == 0;
  if (vec) {
    for_tile(rows, cols / 4, [&](int r, int n) {
      const bool in = r < valid && 4 * n < width;
      cp_async16(dst + r * stride + 4 * n,
                 in ? src + static_cast<long long>(l0 + r) * sl + 4 * n : src,
                 in);
    });
  } else {
    for_tile(rows, cols, [&](int r, int n) {
      const bool in = r < valid && n < width;
      cp_async4(dst + r * stride + n,
                in ? src + static_cast<long long>(l0 + r) * sl + n : src, in);
    });
  }
}

// Start copying dt of the chunk's rows (zero past it)
__device__ __forceinline__ void load_dt(float* dts, const Params& p, int b,
                                        int h, int l0, int cpad) {
  const float* src = p.dt + b * p.dt_sb + h * p.dt_sh;
  for (int r = threadIdx.x; r < cpad; r += blockDim.x) {
    const bool in = r < p.chunk;
    cp_async4(dts + r, in ? src + static_cast<long long>(l0 + r) * p.dt_sl
                          : src, in);
  }
}

// By warp 0: cums[r] = the inclusive cumulative sum of dts * A over the
// chunk (r < cpad <= 64; the zero rows past it hold the last value); then
// e[r] = exp(cum_last - cums[r]) * dts[r] (decay_to_end) or exp(cums[r]).
// Returns cum_last to every lane.
__device__ __forceinline__ float warp_cumsum(const float* dts, float* cums,
                                             float* e, bool to_end,
                                             int chunk, int cpad, float A) {
  const int lane = threadIdx.x & 31;
  float v[2];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = 2 * lane + k;
    run += (r < cpad ? dts[r] : 0.f) * A;
    v[k] = run;
  }
  float tot = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, tot, o);
    if (lane >= o) tot += t;
  }
  const float excl = tot - run;
  const int src = (chunk - 1) >> 1;
  const float last =
      __shfl_sync(0xffffffffu, ((chunk - 1) & 1 ? v[1] : v[0]) + excl, src);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = 2 * lane + k;
    if (r < cpad) {
      const float cum = v[k] + excl;
      cums[r] = cum;
      e[r] = to_end ? expf(last - cum) * dts[r] : expf(cum);
    }
  }
  return last;
}

__global__ void __launch_bounds__(kThreadsA) ssd_chunk_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const Dims d = dims(p.chunk, p.P, p.N);
  const int z = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int l0 = z * p.chunk;
  float* Bs = smem;                 // [c][ns]
  float* xs = Bs + d.c * d.ns;      // [c][ps]
  float* Cst = xs + d.c * d.ps;     // [32][ns]
  float* dts = Cst + kTile * d.ns;
  float* cums = dts + d.c;
  float* scs = cums + d.c;

  load_tile(Bs, d.c, d.N, d.ns, p.B + b * p.b_sb, p.b_sl, l0, p.chunk, p.N);
  load_tile(xs, d.c, d.P, d.ps, p.x + b * p.x_sb + h * p.x_sh, p.x_sl, l0,
            p.chunk, p.P);
  load_dt(dts, p, b, h, l0, d.c);
  cp_async_wait_all();
  __syncthreads();
  if (threadIdx.x < 32) {
    const float last =
        warp_cumsum(dts, cums, scs, true, p.chunk, d.c, p.A[h]);
    if (threadIdx.x == 0)
      p.cl[(static_cast<long long>(b) * p.nc + z) * p.H + h] = last;
  }
  __syncthreads();

  // S = (x * exp(cum_last - cum) * dt)^T B
  float* Sg = p.S + ((static_cast<long long>(b) * p.nc + z) * p.H + h) *
                        static_cast<long long>(p.P) * p.N;
  for_items<2>(d.P, d.N, [&](int i0, int n0) {
    float acc[2][4][4];
    zero(acc);
    mma_item(
        acc, i0, n0, d.c,
        [&](int i, int k) { return xs[k * d.ps + i] * scs[k]; },
        [&](int k, int j) { return Bs[k * d.ns + j]; });
    for_acc(acc, i0, n0, [&](int i, int j, float v) {
      if (i < p.P && j < p.N) Sg[static_cast<long long>(i) * p.N + j] = v;
    });
  });

  // C B^T of this (batch, chunk), one 32-row strip a head's block
  float* CBg = p.CB + (static_cast<long long>(b) * p.nc + z) * d.c * d.c;
  for (int s = h; s < d.c / kTile; s += p.H) {
    __syncthreads();  // the strip buffer is free
    load_tile(Cst, kTile, d.N, d.ns, p.C + b * p.c_sb, p.c_sl,
              l0 + s * kTile, p.chunk - s * kTile, p.N);
    cp_async_wait_all();
    __syncthreads();
    for_items<2>(kTile, d.c, [&](int i0, int n0) {
      float acc[2][4][4];
      zero(acc);
      mma_item(
          acc, i0, n0, d.N, [&](int i, int k) { return Cst[i * d.ns + k]; },
          [&](int k, int j) { return Bs[j * d.ns + k]; });
      for_acc(acc, i0, n0, [&](int i, int j, float v) {
        CBg[static_cast<long long>(s * kTile + i) * d.c + j] = v;
      });
    });
  }
}

__global__ void __launch_bounds__(kThreadsB) ssd_pass_kernel(Params p) {
  const long long PN = static_cast<long long>(p.P) * p.N;
  const long long e = static_cast<long long>(blockIdx.x) * kThreadsB +
                      threadIdx.x;
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long zs = static_cast<long long>(p.H) * PN;  // chunk stride
  float* s = p.S + (static_cast<long long>(b) * p.nc * p.H + h) * PN + e;
  const float* cl = p.cl + static_cast<long long>(b) * p.nc * p.H + h;
  float acc = 0.f;
  constexpr int kAhead = 8;  // chunks loaded before any is written
  for (int z0 = 0; z0 < p.nc; z0 += kAhead) {
    float own[kAhead], decay[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long z = z0 + u;
      own[u] = z < p.nc ? s[z * zs] : 0.f;
      decay[u] = z < p.nc ? expf(cl[z * p.H]) : 1.f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (z0 + u < p.nc) s[(z0 + u) * zs] = acc;  // the state entering it
      acc = acc * decay[u] + own[u];
    }
  }
  p.state[(static_cast<long long>(b) * p.H + h) * PN + e] = acc;
}

__global__ void __launch_bounds__(kThreadsC) ssd_output_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const Dims d = dims(p.chunk, p.P, p.N);
  const int z = blockIdx.x, h0 = blockIdx.y * p.hg, b = blockIdx.z;
  const int heads = p.H - h0 < p.hg ? p.H - h0 : p.hg;
  const int l0 = z * p.chunk;
  float* Cs = smem;                 // [c][ns]
  float* CBs = Cs + d.c * d.ns;     // [c][cs]
  float* cums = CBs + d.c * d.cs;
  float* ecs = cums + d.c;
  float* buf0 = ecs + d.c;          // a head's x, h, dt; two when pipelined
  const long long PN = static_cast<long long>(p.P) * p.N;

  // start copying a head's x, the state entering the chunk (left in S by
  // the state pass) and dt into buffer k
  auto load_head = [&](int h, int k) {
    float* xs = buf0 + k * head_floats(d);
    load_tile(xs, d.c, d.P, d.ps, p.x + b * p.x_sb + h * p.x_sh, p.x_sl,
              l0, p.chunk, p.P);
    if (z > 0)
      load_tile(xs + d.c * d.ps, d.P, d.N, d.ns,
                p.S + ((static_cast<long long>(b) * p.nc + z) * p.H + h) * PN,
                p.N, 0, p.P, p.N);
    load_dt(xs + d.c * d.ps + d.P * d.ns, p, b, h, l0, d.c);
    cp_async_commit();
  };
  load_tile(CBs, d.c, d.c, d.cs,
            p.CB + (static_cast<long long>(b) * p.nc + z) * d.c * d.c, d.c,
            0, d.c, d.c);
  if (z > 0)
    load_tile(Cs, d.c, d.N, d.ns, p.C + b * p.c_sb, p.c_sl, l0, p.chunk,
              p.N);
  load_head(h0, 0);

  const long long y_sl = static_cast<long long>(p.H) * p.P;
  constexpr int SR = 1;  // 16 x 32 items: eight for eight warps at c, P 64
  const int groups = d.P / kTile, items = (d.c / (16 * SR)) * groups;
  const int warps = blockDim.x >> 5;
  for (int hh = 0; hh < heads; ++hh) {
    const int h = h0 + hh;
    const float* xs = buf0 + (hh & 1) * head_floats(d);
    const float* hs = xs + d.c * d.ps;
    const float* dts = hs + d.P * d.ns;
    if (hh + 1 < heads) {  // the next head arrives while this one works
      load_head(h + 1, (hh + 1) & 1);
      cp_async_wait_prior();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    if (threadIdx.x < 32)
      warp_cumsum(dts, cums, ecs, false, p.chunk, d.c, p.A[h]);
    __syncthreads();

    // y = W x + (exp(cum) * C) h^T in one accumulator, W = C B^T *
    // exp(cum_i - cum_j) * dt_j (i >= j) formed as its fragments are read
    float* yg = p.y + (static_cast<long long>(b) * p.L + l0) * y_sl +
                static_cast<long long>(h) * p.P;
    for (int item = threadIdx.x >> 5; item < items; item += warps) {
      const int i0 = (item / groups) * 16 * SR;
      const int n0 = (item % groups) * kTile;
      float acc[SR][4][4];
      zero(acc);
      mma_item(
          acc, i0, n0, d.c,
          [&](int i, int k) {
            return i >= k ? CBs[i * d.cs + k] * expf(cums[i] - cums[k]) *
                                dts[k]
                          : 0.f;
          },
          [&](int k, int j) { return xs[k * d.ps + j]; });
      if (z > 0)
        mma_item(
            acc, i0, n0, d.N,
            [&](int i, int k) { return Cs[i * d.ns + k] * ecs[i]; },
            [&](int k, int j) { return hs[j * d.ns + k]; });
      for_acc(acc, i0, n0, [&](int i, int j, float v) {
        if (i < p.chunk && j < p.P) yg[i * y_sl + j] = v;
      });
    }
    __syncthreads();  // this head's buffer and the sums are free again
  }
}

}  // namespace

// Shared memory a block of the scan needs at (chunk, P, N), the larger of
// the two passes: the wrapper refuses shapes above the card's limit.
extern "C" long long repro_ssd_scan_smem(int chunk, int P, int N) {
  const Dims d = dims(chunk, P, N);
  const size_t a = smem_a(d), s = smem_c(d, 1);
  return static_cast<long long>(a > s ? a : s);
}

// Heads a block of pass (c) takes in turn: up to kHeadsC, pipelined, where
// two such blocks still fit an SM; else one, unpipelined.
constexpr int kHeadsC = 4;
constexpr size_t kSmemSM = 227 * 1024;
inline int heads_c(const Dims& d, int H) {
  if (H < 2 || 2 * smem_c(d, 2) > kSmemSM) return 1;
  return H < kHeadsC ? H : kHeadsC;
}

// The chunk padded to the tiles: C B^T scratch is [b, L / chunk, c', c'].
extern "C" int repro_ssd_scan_chunk_pad(int chunk) {
  return round_up(chunk, kTile);
}

// Three launches a call.
extern "C" int repro_ssd_scan_f32(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* state, void* S, void* cl, void* CB,
    int batch, int L, int H, int P, int N, int chunk, long long x_sb,
    long long x_sl, long long x_sh, long long dt_sb, long long dt_sl,
    long long dt_sh, long long b_sb, long long b_sl, long long c_sb,
    long long c_sl, void* stream) {
  if (batch == 0 || H == 0 || L == 0) return 0;
  if (chunk < 1 || chunk > kMaxChunk || L % chunk != 0 || P < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(x), static_cast<const float*>(dt),
           static_cast<const float*>(A), static_cast<const float*>(B),
           static_cast<const float*>(C), static_cast<float*>(y),
           static_cast<float*>(state), static_cast<float*>(S),
           static_cast<float*>(cl), static_cast<float*>(CB), x_sb, x_sl,
           x_sh, dt_sb, dt_sl, dt_sh, b_sb, b_sl, c_sb, c_sl, L, H, P, N,
           chunk, L / chunk, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dims d = dims(chunk, P, N);
  p.hg = heads_c(d, H);
  const size_t sa = smem_a(d), sb = smem_c(d, p.hg > 1 ? 2 : 1);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sa));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_output_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sb));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.nc, H, batch);
  ssd_chunk_kernel<<<grid, kThreadsA, sa, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long PN = static_cast<long long>(P) * N;
  ssd_pass_kernel<<<dim3(static_cast<unsigned>((PN + kThreadsB - 1) /
                                               kThreadsB),
                         H, batch),
                    kThreadsB, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_output_kernel<<<dim3(p.nc, (H + p.hg - 1) / p.hg, batch), kThreadsC,
                      sb, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
