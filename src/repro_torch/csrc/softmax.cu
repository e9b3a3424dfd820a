// Row softmax forward and backward for Hopper (sm_90a): x, y, dy and dx
// float32 or bfloat16 (one type a call), float32 inside.
//
// Replaces the TPU kernels `_softmax_kernel` / `softmax_fwd` and
// `_softmax_bwd_kernel` / `softmax_bwd` (src/repro/kernels/softmax.py:14,22
// and :43,52):
//     forward   m = max(x),  e = exp(x - m),  s = sum(e),  y = e / s
//     backward  t = sum(dy * y),  dx = y * (dy - t)            [R, C] each
// The arithmetic is the TPU kernels' in their order, float32 throughout;
// as theirs, the bfloat16 instances widen the inputs and round y and dx
// once, at the store (`.astype(y_ref.dtype)`).
// The division is a product with the row's reciprocal, r = 1 / s rounded
// once, y = e * r rounded once: within 1.5 ulp of e / s.  An IEEE
// division whose dividend is subnormal (e below 2^-126, where logits in a
// row spread by more than 87) takes a slow path, and four of them in a
// lane's float4 cost 1.5 us at [2048, 32] on an H100 (PERF.md).
//
// Bound: bytes, and at the router's shapes the launch.  The forward reads x
// and writes y (8 R C bytes in float32, 4 R C in bfloat16), the backward reads
// y and dy and writes dx (12 R C, 6 R C); their 3-5 operations an element are
// nothing beside that.  At the router's rows ([2048, 32] a prefill, [4096, 32]
// a train step) the bytes take 0.2-0.5 us, a launch several: the kernel's time
// is its launch, the wait for its producer and one round trip to memory.
//
// What held the first design back: one warp a row, four rows a
// 128-thread block, one scalar a lane -- [2048, 32] was 512 blocks of 4
// rows and 16 load instructions a block, each reduction five shuffles;
// and a plain `<<<>>>` launch, which the card starts only after its
// producer's grid (the router's product, the autograd add of the
// gradient) has drained and its writes are flushed.
//
// The layouts, picked by the row's width and the pointers' alignment:
//   * unit lanes (a lane's unit is 16 bytes: a float4, or 8 bfloat16; C a
//     multiple of the unit's values K, C <= 32 K, every pointer 16-byte
//     aligned): L lanes hold a row, L the next power of two of C / K (8 at
//     C 32 in float32, 4 in bfloat16; 16 at C 40 in float32), each lane
//     one unit of it, so a warp holds 32 / L rows and a 256-thread block
//     256 / L ([2048, 32] in float32: 64 blocks of 32 rows).  Each
//     reduction is log2 L `__shfl_xor_sync` steps within the L lanes.  A
//     lane past the row's end holds -inf (forward) or 0
//     (backward); a row past R computes and stores nothing, and a warp
//     whose rows all lie past R leaves at once.
//   * one warp a row (C <= 256 otherwise: misaligned, or not a multiple of
//     K): the row in registers, VPT values a lane, lane l holding columns
//     l + 32 i; four rows a 128-thread block.
//   * wider rows: one 256-thread block a row that loops over the columns
//     -- the max, the sum of exp (recomputed, not stored), then the write,
//     each reduction a warp shuffle and one shared-memory step.
// Every kernel is launched as a programmatic dependent
// (`cudaLaunchAttributeProgrammaticStreamSerialization`): its grid is
// launched and its blocks made resident while its producer drains.  Each
// block executes `griddepcontrol.wait` -- which returns once every grid
// before it in the stream has completed and its writes are visible --
// before its first access to device memory, read or write, so it is
// correct after any producer, dependent-aware or not.  Once a block's
// loads are in registers it executes `griddepcontrol.launch_dependents`,
// letting the next programmatic dependent (a softmax of the next layer,
// the backward after the forward) launch; that one waits in turn.
//
// C interface (bound with ctypes): every entry returns the launch's
// error, or else cudaGetLastError().  Pointers are device pointers of
// contiguous tensors of one type; `stream` is the caller's cudaStream_t.
// `repro_softmax_lanes` names the layout the entries take.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "chain.cuh"

namespace {

constexpr int kVecThreads = 256;                // unit lanes: 256 / L rows
constexpr int kVecMaxLanes = 32;                // ... up to 32 lanes a row
constexpr int kWarpRowsPerBlock = 4;            // warp path: 128 threads
constexpr int kBlockThreads = 256;              // block path: one row a block
constexpr int kMaxWarpVPT = 8;                  // warp path up to 256 columns

// Wait for every grid before this one in the stream (a no-op when the
// launch was not a programmatic dependent).
__device__ __forceinline__ void wait_for_producer() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Let the next programmatic dependent launch; it waits for this grid.
__device__ __forceinline__ void release_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

template <int W>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, W);
  return v;
}

template <int W>
__device__ __forceinline__ float lanes_max(float v) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off, W));
  return v;
}

// Max (kMax) or sum of `v` over a kBlockThreads block; every thread gets
// the result.  Each instantiation has its own shared memory.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v) {
  __shared__ float part[kBlockThreads / 32];
  __shared__ float total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? lanes_max<32>(v) : lanes_sum<32>(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kBlockThreads / 32 ? part[lane]
                                        : (kMax ? -CUDART_INF_F : 0.f);
    w = kMax ? lanes_max<32>(w) : lanes_sum<32>(w);
    if (lane == 0) total = w;
  }
  __syncthreads();
  return total;
}

using bf16_t = uint16_t;  // a bfloat16 value's bits

// The values of T a lane's 16-byte unit holds: 4 float32, 8 bfloat16.
template <class T>
constexpr int kUnit = 16 / static_cast<int>(sizeof(T));

// A unit at p (16-byte aligned) as float32 values (exact), and float32
// values stored there as T (rounded once, to nearest even).
__device__ __forceinline__ void load_unit(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
__device__ __forceinline__ void load_unit(const bf16_t* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[2 * q] = __uint_as_float(w[q] << 16);
    v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store_unit(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return repro_chain::to_bf16(a) |
         (static_cast<uint32_t>(repro_chain::to_bf16(b)) << 16);
}
__device__ __forceinline__ void store_unit(bf16_t* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(
      pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
      pack2(v[6], v[7]));
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const bf16_t* p) {
  return repro_chain::from_bf16(*p);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16_t* p, float v) {
  *p = repro_chain::to_bf16(v);
}

// The sum and the max of a unit's values, pairwise: (v0 + v1) + (v2 + v3)
// for four, as the float32 layout had them, the same again above them for
// eight.
template <int K>
__device__ __forceinline__ float unit_sum(const float (&v)[K]) {
  float s[K];
#pragma unroll
  for (int i = 0; i < K; ++i) s[i] = v[i];
#pragma unroll
  for (int w = 1; w < K; w *= 2)
#pragma unroll
    for (int i = 0; i < K; i += 2 * w) s[i] += s[i + w];
  return s[0];
}
template <int K>
__device__ __forceinline__ float unit_max(const float (&v)[K]) {
  float m = v[0];
#pragma unroll
  for (int i = 1; i < K; ++i) m = fmaxf(m, v[i]);
  return m;
}

// The first row of this thread's warp in the unit layout, and its own.
template <int L>
__device__ __forceinline__ long long vec_row(long long* warp_first) {
  constexpr int kRows = kVecThreads / L;
  const long long base = static_cast<long long>(blockIdx.x) * kRows;
  *warp_first = base + (threadIdx.x & ~31) / L;
  return base + threadIdx.x / L;
}

// T is x's and y's type; CK the row's units.
template <int L, class T>
__global__ void __launch_bounds__(kVecThreads)
softmax_fwd_vec_kernel(const T* __restrict__ x, T* __restrict__ y, int R,
                       int CK) {
  constexpr int K = kUnit<T>;
  long long first;
  const long long row = vec_row<L>(&first);
  if (first >= R) return;  // the whole warp: no shuffle is left waiting
  const int j = threadIdx.x & (L - 1);
  const bool live = row < R && j < CK;
  wait_for_producer();
  float v[K];
  if (live) {
    load_unit(x + (row * CK + j) * K, v);
  } else {
#pragma unroll
    for (int e = 0; e < K; ++e) v[e] = -CUDART_INF_F;
  }
  release_dependents();
  const float m = lanes_max<L>(unit_max(v));
#pragma unroll
  for (int e = 0; e < K; ++e) v[e] = expf(v[e] - m);
  const float r = 1.f / lanes_sum<L>(unit_sum(v));
#pragma unroll
  for (int e = 0; e < K; ++e) v[e] *= r;
  if (live) store_unit(y + (row * CK + j) * K, v);
}

// T is y's, dy's and dx's type.
template <int L, class T>
__global__ void __launch_bounds__(kVecThreads)
softmax_bwd_vec_kernel(const T* __restrict__ y, const T* __restrict__ dy,
                       T* __restrict__ dx, int R, int CK) {
  constexpr int K = kUnit<T>;
  long long first;
  const long long row = vec_row<L>(&first);
  if (first >= R) return;
  const int j = threadIdx.x & (L - 1);
  const bool live = row < R && j < CK;
  wait_for_producer();
  float yv[K], dv[K];
  if (live) {
    load_unit(y + (row * CK + j) * K, yv);
    load_unit(dy + (row * CK + j) * K, dv);
  } else {
#pragma unroll
    for (int e = 0; e < K; ++e) yv[e] = dv[e] = 0.f;
  }
  release_dependents();
  float p[K];
#pragma unroll
  for (int e = 0; e < K; ++e) p[e] = dv[e] * yv[e];
  const float t = lanes_sum<L>(unit_sum(p));
#pragma unroll
  for (int e = 0; e < K; ++e) p[e] = yv[e] * (dv[e] - t);
  if (live) store_unit(dx + (row * CK + j) * K, p);
}

template <int VPT, class T>
__global__ void __launch_bounds__(32 * kWarpRowsPerBlock)
softmax_fwd_warp_kernel(const T* __restrict__ x, T* __restrict__ y, int R,
                        int C) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;  // the whole warp: no shuffle is left waiting
  wait_for_producer();
  const T* xr = x + row * C;
  float v[VPT];
  float m = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < C ? load1(xr + c) : -CUDART_INF_F;
    m = fmaxf(m, v[i]);
  }
  release_dependents();
  m = lanes_max<32>(m);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < C ? expf(v[i] - m) : 0.f;
    s += v[i];
  }
  const float r = 1.f / lanes_sum<32>(s);
  T* yr = y + row * C;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    if (c < C) store1(yr + c, v[i] * r);
  }
}

template <class T>
__global__ void __launch_bounds__(kBlockThreads)
softmax_fwd_block_kernel(const T* __restrict__ x, T* __restrict__ y, int C) {
  const long long row = blockIdx.x;
  const T* xr = x + row * C;
  wait_for_producer();
  float m = -CUDART_INF_F;
  for (int c = threadIdx.x; c < C; c += kBlockThreads)
    m = fmaxf(m, load1(xr + c));
  release_dependents();
  m = block_reduce<true>(m);
  float s = 0.f;
  for (int c = threadIdx.x; c < C; c += kBlockThreads)
    s += expf(load1(xr + c) - m);
  const float r = 1.f / block_reduce<false>(s);
  T* yr = y + row * C;
  for (int c = threadIdx.x; c < C; c += kBlockThreads)
    store1(yr + c, expf(load1(xr + c) - m) * r);
}

template <int VPT, class T>
__global__ void __launch_bounds__(32 * kWarpRowsPerBlock)
softmax_bwd_warp_kernel(const T* __restrict__ y, const T* __restrict__ dy,
                        T* __restrict__ dx, int R, int C) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;
  wait_for_producer();
  const T* yr = y + row * C;
  const T* dyr = dy + row * C;
  float yv[VPT], dv[VPT];
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    yv[i] = c < C ? load1(yr + c) : 0.f;
    dv[i] = c < C ? load1(dyr + c) : 0.f;
    t += dv[i] * yv[i];
  }
  release_dependents();
  t = lanes_sum<32>(t);
  T* dxr = dx + row * C;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    if (c < C) store1(dxr + c, yv[i] * (dv[i] - t));
  }
}

template <class T>
__global__ void __launch_bounds__(kBlockThreads)
softmax_bwd_block_kernel(const T* __restrict__ y, const T* __restrict__ dy,
                         T* __restrict__ dx, int C) {
  const long long row = blockIdx.x;
  const T* yr = y + row * C;
  const T* dyr = dy + row * C;
  wait_for_producer();
  float t = 0.f;
  for (int c = threadIdx.x; c < C; c += kBlockThreads)
    t += load1(dyr + c) * load1(yr + c);
  release_dependents();
  t = block_reduce<false>(t);
  T* dxr = dx + row * C;
  for (int c = threadIdx.x; c < C; c += kBlockThreads)
    store1(dxr + c, load1(yr + c) * (load1(dyr + c) - t));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The layout for C columns of K-value units: the unit layout's lanes a
// row (1 to 32) where C is a multiple of K, at most 32 K (128 float32, 256
// bfloat16 columns), and every pointer given is 16-byte aligned; else 0
// for a warp a row (C <= 256), -1 for a block.
int lanes_for(int C, int K, const void* a, const void* b, const void* c) {
  if (C % K == 0 && C <= kVecMaxLanes * K && aligned16(a) && aligned16(b) &&
      aligned16(c)) {
    int lanes = 1;
    while (lanes < C / K) lanes *= 2;
    return lanes;
  }
  return (C + 31) / 32 <= kMaxWarpVPT ? 0 : -1;
}

// The warp path's values a lane for C columns: 1, 2, 4 or 8.
int warp_vpt(int C) {
  const int need = (C + 31) / 32;
  int vpt = 1;
  while (vpt < need) vpt *= 2;
  return vpt;
}

unsigned blocks_for(int R, int rows_per_block) {
  return static_cast<unsigned>((R + rows_per_block - 1) / rows_per_block);
}

// Launch `kernel` as a programmatic dependent of the stream's last work.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), unsigned grid, unsigned block,
           cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();  // cleared either way
  return static_cast<int>(err != cudaSuccess ? err : last);
}

#define REPRO_VEC_CASE(L, KERNEL, ...)                                      \
  case L:                                                                   \
    return launch(KERNEL<L, T>, blocks_for(R, kVecThreads / L),             \
                  kVecThreads, s, __VA_ARGS__, R, C / kUnit<T>);

#define REPRO_WARP_CASE(V, KERNEL, ...)                                     \
  case V:                                                                   \
    return launch(KERNEL<V, T>, blocks_for(R, kWarpRowsPerBlock),          \
                  32 * kWarpRowsPerBlock, s, __VA_ARGS__, R, C);

template <class T>
int softmax_fwd(const void* x, void* y, int R, int C, cudaStream_t s) {
  if (R <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  const int lanes = lanes_for(C, kUnit<T>, x, y, nullptr);
  auto xp = static_cast<const T*>(x);
  auto yp = static_cast<T*>(y);
  if (lanes > 0) {
    switch (lanes) {
      REPRO_VEC_CASE(1, softmax_fwd_vec_kernel, xp, yp)
      REPRO_VEC_CASE(2, softmax_fwd_vec_kernel, xp, yp)
      REPRO_VEC_CASE(4, softmax_fwd_vec_kernel, xp, yp)
      REPRO_VEC_CASE(8, softmax_fwd_vec_kernel, xp, yp)
      REPRO_VEC_CASE(16, softmax_fwd_vec_kernel, xp, yp)
      REPRO_VEC_CASE(32, softmax_fwd_vec_kernel, xp, yp)
    }
  }
  if (lanes < 0)
    return launch(softmax_fwd_block_kernel<T>, static_cast<unsigned>(R),
                  kBlockThreads, s, xp, yp, C);
  switch (warp_vpt(C)) {
    REPRO_WARP_CASE(1, softmax_fwd_warp_kernel, xp, yp)
    REPRO_WARP_CASE(2, softmax_fwd_warp_kernel, xp, yp)
    REPRO_WARP_CASE(4, softmax_fwd_warp_kernel, xp, yp)
    default:
      return launch(softmax_fwd_warp_kernel<8, T>,
                    blocks_for(R, kWarpRowsPerBlock), 32 * kWarpRowsPerBlock,
                    s, xp, yp, R, C);
  }
}

template <class T>
int softmax_bwd(const void* y, const void* dy, void* dx, int R, int C,
                cudaStream_t s) {
  if (R <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  const int lanes = lanes_for(C, kUnit<T>, y, dy, dx);
  auto yp = static_cast<const T*>(y);
  auto dyp = static_cast<const T*>(dy);
  auto dxp = static_cast<T*>(dx);
  if (lanes > 0) {
    switch (lanes) {
      REPRO_VEC_CASE(1, softmax_bwd_vec_kernel, yp, dyp, dxp)
      REPRO_VEC_CASE(2, softmax_bwd_vec_kernel, yp, dyp, dxp)
      REPRO_VEC_CASE(4, softmax_bwd_vec_kernel, yp, dyp, dxp)
      REPRO_VEC_CASE(8, softmax_bwd_vec_kernel, yp, dyp, dxp)
      REPRO_VEC_CASE(16, softmax_bwd_vec_kernel, yp, dyp, dxp)
      REPRO_VEC_CASE(32, softmax_bwd_vec_kernel, yp, dyp, dxp)
    }
  }
  if (lanes < 0)
    return launch(softmax_bwd_block_kernel<T>, static_cast<unsigned>(R),
                  kBlockThreads, s, yp, dyp, dxp, C);
  switch (warp_vpt(C)) {
    REPRO_WARP_CASE(1, softmax_bwd_warp_kernel, yp, dyp, dxp)
    REPRO_WARP_CASE(2, softmax_bwd_warp_kernel, yp, dyp, dxp)
    REPRO_WARP_CASE(4, softmax_bwd_warp_kernel, yp, dyp, dxp)
    default:
      return launch(softmax_bwd_warp_kernel<8, T>,
                    blocks_for(R, kWarpRowsPerBlock), 32 * kWarpRowsPerBlock,
                    s, yp, dyp, dxp, R, C);
  }
}

#undef REPRO_VEC_CASE
#undef REPRO_WARP_CASE

}  // namespace

// The layout the entries take for these operands of float32 (bf16 0) or
// bfloat16 (1): lanes a row of the unit layout, 0 a warp a row, -1 a block.
extern "C" int repro_softmax_lanes(const void* a, const void* b,
                                   const void* c, int C, int bf16) {
  return lanes_for(C, bf16 ? kUnit<bf16_t> : kUnit<float>, a, b, c);
}

// x and y [R, C], float32 (bf16 0) or bfloat16 (1).
extern "C" int repro_softmax_fwd(const void* x, void* y, int R, int C,
                                 int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? softmax_fwd<bf16_t>(x, y, R, C, s)
              : softmax_fwd<float>(x, y, R, C, s);
}

// y, dy and dx [R, C], float32 (bf16 0) or bfloat16 (1).
extern "C" int repro_softmax_bwd(const void* y, const void* dy, void* dx,
                                 int R, int C, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? softmax_bwd<bf16_t>(y, dy, dx, R, C, s)
              : softmax_bwd<float>(y, dy, dx, R, C, s);
}
