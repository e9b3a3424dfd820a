// Row softmax forward and backward for Hopper (sm_90a), float32.
//
// Replaces the TPU kernels `_softmax_kernel` / `softmax_fwd` and
// `_softmax_bwd_kernel` / `softmax_bwd` (src/repro/kernels/softmax.py:14,22
// and :43,52):
//     forward   m = max(x),  e = exp(x - m),  s = sum(e),  y = e / s
//     backward  t = sum(dy * y),  dx = y * (dy - t)            [R, C] each
// The arithmetic is the TPU kernels' in their order, float32 throughout.
// The division is a product with the row's reciprocal, r = 1 / s rounded
// once, y = e * r rounded once: within 1.5 ulp of e / s.  An IEEE
// division whose dividend is subnormal (e below 2^-126, where logits in a
// row spread by more than 87) takes a slow path, and four of them in a
// lane's float4 cost 1.5 us at [2048, 32] on an H100 (PERF.md).
//
// Bound: bytes, and at the router's shapes the launch.  The forward reads
// x and writes y (8 R C bytes), the backward reads y and dy and writes dx
// (12 R C bytes); their 3-5 operations an element are nothing beside
// that.  At the router's rows ([2048, 32] a prefill, [4096, 32] a train
// step) the bytes take 0.2-0.5 us, a launch several: the kernel's time is
// its launch, the wait for its producer and one round trip to memory.
//
// What held the first design back: one warp a row, four rows a
// 128-thread block, one scalar a lane -- [2048, 32] was 512 blocks of 4
// rows and 16 load instructions a block, each reduction five shuffles;
// and a plain `<<<>>>` launch, which the card starts only after its
// producer's grid (the router's product, the autograd add of the
// gradient) has drained and its writes are flushed.
//
// The layouts, picked by the row's width and the pointers' alignment:
//   * float4 lanes (C a multiple of 4, C <= 128, every pointer 16-byte
//     aligned): L lanes hold a row, L the next power of two of C / 4 (8 at
//     C 32, 16 at C 40), each lane one float4 of it, so a warp holds 32 / L
//     rows and a 256-thread block 256 / L ([2048, 32]: 64 blocks of 32
//     rows).  Each reduction is log2 L `__shfl_xor_sync` steps within the L
//     lanes.  A lane past the row's end holds -inf (forward) or 0
//     (backward); a row past R computes and stores nothing, and a warp
//     whose rows all lie past R leaves at once.
//   * one warp a row (C <= 256 otherwise: misaligned, or not a multiple of
//     4): the row in registers, VPT values a lane, lane l holding columns
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
// contiguous float32 tensors; `stream` is the caller's cudaStream_t.
// `repro_softmax_lanes` names the layout the entries take.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kVecThreads = 256;                // float4 lanes: 256 / L rows
constexpr int kVecMaxC = 128;                   // ... up to 32 lanes a row
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

// The first row of this thread's warp in the float4 layout, and its own.
template <int L>
__device__ __forceinline__ long long vec_row(long long* warp_first) {
  constexpr int kRows = kVecThreads / L;
  const long long base = static_cast<long long>(blockIdx.x) * kRows;
  *warp_first = base + (threadIdx.x & ~31) / L;
  return base + threadIdx.x / L;
}

template <int L>
__global__ void __launch_bounds__(kVecThreads)
softmax_fwd_vec_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                       int R, int C4) {
  long long first;
  const long long row = vec_row<L>(&first);
  if (first >= R) return;  // the whole warp: no shuffle is left waiting
  const int j = threadIdx.x & (L - 1);
  const bool live = row < R && j < C4;
  wait_for_producer();
  const float4 v = live ? x[row * C4 + j]
                        : make_float4(-CUDART_INF_F, -CUDART_INF_F,
                                      -CUDART_INF_F, -CUDART_INF_F);
  release_dependents();
  const float m = lanes_max<L>(fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
  const float4 e = make_float4(expf(v.x - m), expf(v.y - m), expf(v.z - m),
                               expf(v.w - m));
  const float r = 1.f / lanes_sum<L>((e.x + e.y) + (e.z + e.w));
  if (live) y[row * C4 + j] = make_float4(e.x * r, e.y * r, e.z * r, e.w * r);
}

template <int L>
__global__ void __launch_bounds__(kVecThreads)
softmax_bwd_vec_kernel(const float4* __restrict__ y,
                       const float4* __restrict__ dy, float4* __restrict__ dx,
                       int R, int C4) {
  long long first;
  const long long row = vec_row<L>(&first);
  if (first >= R) return;
  const int j = threadIdx.x & (L - 1);
  const bool live = row < R && j < C4;
  wait_for_producer();
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 yv = live ? y[row * C4 + j] : zero;
  const float4 dv = live ? dy[row * C4 + j] : zero;
  release_dependents();
  const float t = lanes_sum<L>((dv.x * yv.x + dv.y * yv.y) +
                               (dv.z * yv.z + dv.w * yv.w));
  if (live)
    dx[row * C4 + j] = make_float4(yv.x * (dv.x - t), yv.y * (dv.y - t),
                                   yv.z * (dv.z - t), yv.w * (dv.w - t));
}

template <int VPT>
__global__ void __launch_bounds__(32 * kWarpRowsPerBlock)
softmax_fwd_warp_kernel(const float* __restrict__ x, float* __restrict__ y,
                        int R, int C) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;  // the whole warp: no shuffle is left waiting
  wait_for_producer();
  const float* xr = x + row * C;
  float v[VPT];
  float m = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < C ? xr[c] : -CUDART_INF_F;
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
  float* yr = y + row * C;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    if (c < C) yr[c] = v[i] * r;
  }
}

__global__ void __launch_bounds__(kBlockThreads)
softmax_fwd_block_kernel(const float* __restrict__ x, float* __restrict__ y,
                         int C) {
  const long long row = blockIdx.x;
  const float* xr = x + row * C;
  wait_for_producer();
  float m = -CUDART_INF_F;
  for (int c = threadIdx.x; c < C; c += kBlockThreads) m = fmaxf(m, xr[c]);
  release_dependents();
  m = block_reduce<true>(m);
  float s = 0.f;
  for (int c = threadIdx.x; c < C; c += kBlockThreads) s += expf(xr[c] - m);
  const float r = 1.f / block_reduce<false>(s);
  float* yr = y + row * C;
  for (int c = threadIdx.x; c < C; c += kBlockThreads) yr[c] = expf(xr[c] - m) * r;
}

template <int VPT>
__global__ void __launch_bounds__(32 * kWarpRowsPerBlock)
softmax_bwd_warp_kernel(const float* __restrict__ y, const float* __restrict__ dy,
                        float* __restrict__ dx, int R, int C) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;
  wait_for_producer();
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
  release_dependents();
  t = lanes_sum<32>(t);
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
  wait_for_producer();
  float t = 0.f;
  for (int c = threadIdx.x; c < C; c += kBlockThreads) t += dyr[c] * yr[c];
  release_dependents();
  t = block_reduce<false>(t);
  float* dxr = dx + row * C;
  for (int c = threadIdx.x; c < C; c += kBlockThreads)
    dxr[c] = yr[c] * (dyr[c] - t);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The layout for C columns: the float4 layout's lanes a row (1 to 32)
// where C is a multiple of 4, at most kVecMaxC, and every pointer given
// is 16-byte aligned; else 0 for a warp a row (C <= 256), -1 for a block.
int lanes_for(int C, const void* a, const void* b, const void* c) {
  if (C % 4 == 0 && C <= kVecMaxC && aligned16(a) && aligned16(b) &&
      aligned16(c)) {
    int lanes = 1;
    while (lanes < C / 4) lanes *= 2;
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

}  // namespace

extern "C" int repro_softmax_lanes(const void* a, const void* b,
                                   const void* c, int C) {
  return lanes_for(C, a, b, c);
}

#define REPRO_VEC_CASE(L, KERNEL, ...)                                      \
  case L:                                                                   \
    return launch(KERNEL<L>, blocks_for(R, kVecThreads / L), kVecThreads,  \
                  s, __VA_ARGS__, R, C / 4);

#define REPRO_WARP_CASE(V, KERNEL, ...)                                     \
  case V:                                                                   \
    return launch(KERNEL<V>, blocks_for(R, kWarpRowsPerBlock),             \
                  32 * kWarpRowsPerBlock, s, __VA_ARGS__, R, C);

extern "C" int repro_softmax_fwd_f32(const void* x, void* y, int R, int C,
                                     void* stream) {
  if (R <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lanes = lanes_for(C, x, y, nullptr);
  if (lanes > 0) {
    auto xp = static_cast<const float4*>(x);
    auto yp = static_cast<float4*>(y);
    switch (lanes) {
      REPRO_VEC_CASE(1, softmax_fwd_vec_kernel, xp, yp)
      REPRO_VEC_CASE(2, softmax_fwd_vec_kernel, xp, yp)
      REPRO_VEC_CASE(4, softmax_fwd_vec_kernel, xp, yp)
      REPRO_VEC_CASE(8, softmax_fwd_vec_kernel, xp, yp)
      REPRO_VEC_CASE(16, softmax_fwd_vec_kernel, xp, yp)
      REPRO_VEC_CASE(32, softmax_fwd_vec_kernel, xp, yp)
    }
  }
  auto xp = static_cast<const float*>(x);
  auto yp = static_cast<float*>(y);
  if (lanes < 0)
    return launch(softmax_fwd_block_kernel, static_cast<unsigned>(R),
                  kBlockThreads, s, xp, yp, C);
  switch (warp_vpt(C)) {
    REPRO_WARP_CASE(1, softmax_fwd_warp_kernel, xp, yp)
    REPRO_WARP_CASE(2, softmax_fwd_warp_kernel, xp, yp)
    REPRO_WARP_CASE(4, softmax_fwd_warp_kernel, xp, yp)
    default:
      return launch(softmax_fwd_warp_kernel<8>, blocks_for(R, kWarpRowsPerBlock),
                    32 * kWarpRowsPerBlock, s, xp, yp, R, C);
  }
}

extern "C" int repro_softmax_bwd_f32(const void* y, const void* dy, void* dx,
                                     int R, int C, void* stream) {
  if (R <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lanes = lanes_for(C, y, dy, dx);
  if (lanes > 0) {
    auto yp = static_cast<const float4*>(y);
    auto dyp = static_cast<const float4*>(dy);
    auto dxp = static_cast<float4*>(dx);
    switch (lanes) {
      REPRO_VEC_CASE(1, softmax_bwd_vec_kernel, yp, dyp, dxp)
      REPRO_VEC_CASE(2, softmax_bwd_vec_kernel, yp, dyp, dxp)
      REPRO_VEC_CASE(4, softmax_bwd_vec_kernel, yp, dyp, dxp)
      REPRO_VEC_CASE(8, softmax_bwd_vec_kernel, yp, dyp, dxp)
      REPRO_VEC_CASE(16, softmax_bwd_vec_kernel, yp, dyp, dxp)
      REPRO_VEC_CASE(32, softmax_bwd_vec_kernel, yp, dyp, dxp)
    }
  }
  auto yp = static_cast<const float*>(y);
  auto dyp = static_cast<const float*>(dy);
  auto dxp = static_cast<float*>(dx);
  if (lanes < 0)
    return launch(softmax_bwd_block_kernel, static_cast<unsigned>(R),
                  kBlockThreads, s, yp, dyp, dxp, C);
  switch (warp_vpt(C)) {
    REPRO_WARP_CASE(1, softmax_bwd_warp_kernel, yp, dyp, dxp)
    REPRO_WARP_CASE(2, softmax_bwd_warp_kernel, yp, dyp, dxp)
    REPRO_WARP_CASE(4, softmax_bwd_warp_kernel, yp, dyp, dxp)
    default:
      return launch(softmax_bwd_warp_kernel<8>, blocks_for(R, kWarpRowsPerBlock),
                    32 * kWarpRowsPerBlock, s, yp, dyp, dxp, R, C);
  }
}
