// Mamba-2 SSD chunked scan for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_scan`
// (src/repro/kernels/ssd_scan.py:25,75):
//     x [b, L, H, P], dt [b, L, H], A [H], B and C [b, L, N] (one group,
//     shared by the heads) -> y [b, L, H, P], final state [b, H, P, N]
// For each chunk of c rows, with the state h [P, N] carried across:
//     cum     = cumsum(dt * A)
//     W[i, j] = (C B^T)[i, j] * exp(cum_i - cum_j) * dt_j   for i >= j, else 0
//     y       = W @ x + exp(cum) * (C @ h^T)
//     h       = h * exp(cum_last) + x^T @ (B * exp(cum_last - cum) * dt)
// The decay exponent is taken only where i >= j (the masked pairs, whose
// exponent is positive, never overflow); the kept values are the
// reference's.
//
// Bound: operations.  At Mamba2's prefill (b 4, L 512, H 32, P 64, N 128)
// the function needs about 2.8 GFLOP against 40 MB moved (C B^T once per
// batch and chunk: the heads share B and C); this kernel does about 3.8,
// since it recomputes C B^T per head, as the TPU kernel does.  The TPU
// kernel's grid is (b, H, chunks) with the chunk axis sequential and the
// state in VMEM scratch between grid steps.  CUDA blocks run in no
// order, so here one block of 256 threads owns one (batch, head) and
// walks the chunks itself, the state [P, N] in shared memory across
// them.  Each chunk's x, B, C tiles, its [c, c] weight tile and its
// cumulative decay are staged in shared memory (133 KB at P 64, N 128,
// above the 48 KB default: the launch raises the limit first).  The four
// small products run as FMA on the CUDA cores, each thread owning a
// register tile (rows ty + 16 i, columns tx + 16 j of a 16 x 16 thread
// grid) and padded shared rows keeping the column reads free of bank
// conflicts.  C B^T is recomputed per head, as the TPU kernel does.  No
// tensor cores and no chunk-parallel split yet.
//
// A chunk shorter than the instance's CM rows is staged with zero rows
// past its end (dt 0: no decay, no contribution), so any chunk <= CM
// computes exactly the chunk-c scan.  The instances are kInstances below.
//
// C interface (bound with ctypes): returns the first CUDA error of the
// launch, or 0.  x, dt, B, C are taken with their element strides (x, B,
// C with a contiguous last dimension); y and the state are contiguous.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  float* y;
  float* state;
  long long x_sb, x_sl, x_sh;
  long long dt_sb, dt_sl, dt_sh;
  long long b_sb, b_sl;
  long long c_sb, c_sl;
  int L, H, chunk;
};

// Shared-memory layout in floats; rows padded by one float so that a
// warp reading one column of 16 rows hits 16 banks.
template <int CM, int P, int N>
struct Layout {
  static constexpr int XS = P + 1;
  static constexpr int NS = N + 1;
  static constexpr int WS = CM + 1;
  static constexpr int x_off = 0;                   // x    [CM][XS]
  static constexpr int b_off = x_off + CM * XS;     // B    [CM][NS]
  static constexpr int c_off = b_off + CM * NS;     // C    [CM][NS]
  static constexpr int w_off = c_off + CM * NS;     // W    [CM][WS]
  static constexpr int h_off = w_off + CM * WS;     // h    [P][NS]
  static constexpr int cum_off = h_off + P * NS;    // cum  [CM]
  static constexpr int dt_off = cum_off + CM;       // dt   [CM]
  static constexpr int sc_off = dt_off + CM;        // exp(cum_last - cum) dt
  static constexpr int floats = sc_off + CM;
};

template <int CM, int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Params p) {
  using S = Layout<CM, P, N>;
  constexpr int RI = CM / 16;  // chunk rows of a thread
  constexpr int PJ = P / 16;   // P columns of a thread (y), P rows (state)
  constexpr int NJ = N / 16;   // N columns of a thread (state)
  constexpr int R = (CM + 31) / 32;  // rows of a lane in the cumsum
  extern __shared__ float smem[];
  float* Xs = smem + S::x_off;
  float* Bs = smem + S::b_off;
  float* Cs = smem + S::c_off;
  float* Ws = smem + S::w_off;
  float* Hs = smem + S::h_off;
  float* CUMs = smem + S::cum_off;
  float* DTs = smem + S::dt_off;
  float* SCs = smem + S::sc_off;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int c = p.chunk;
  const float A = p.A[h];
  const float* xg = p.x + b * p.x_sb + h * p.x_sh;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const float* bg = p.B + b * p.b_sb;
  const float* cg = p.C + b * p.c_sb;
  const long long y_sl = static_cast<long long>(p.H) * P;
  float* yg = p.y + (static_cast<long long>(b) * p.L * p.H + h) * P;

  for (int i = tid; i < P * S::NS; i += kThreads) Hs[i] = 0.f;

  for (int l0 = 0; l0 < p.L; l0 += c) {
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = tid; idx < CM * P; idx += kThreads) {
      const int r = idx / P, d = idx % P;
      Xs[r * S::XS + d] =
          r < c ? xg[static_cast<long long>(l0 + r) * p.x_sl + d] : 0.f;
    }
    for (int idx = tid; idx < CM * N; idx += kThreads) {
      const int r = idx / N, n = idx % N;
      const bool in = r < c;
      const long long row = l0 + r;
      Bs[r * S::NS + n] = in ? bg[row * p.b_sl + n] : 0.f;
      Cs[r * S::NS + n] = in ? cg[row * p.c_sl + n] : 0.f;
    }
    if (tid < 32) {  // inclusive cumsum of dt * A by one warp
      float v[R];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int r = tid * R + k;
        const float d =
            r < c ? dtg[static_cast<long long>(l0 + r) * p.dt_sl] : 0.f;
        if (r < CM) DTs[r] = d;
        run += d * A;
        v[k] = run;
      }
      float tot = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, tot, o);
        if (tid >= o) tot += t;
      }
      const float excl = tot - run;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int r = tid * R + k;
        if (r < CM) CUMs[r] = v[k] + excl;
      }
    }
    __syncthreads();
    const float cum_last = CUMs[c - 1];
    if (tid < CM) SCs[tid] = expf(cum_last - CUMs[tid]) * DTs[tid];

    // W = (C B^T) * exp(cum_i - cum_j) * dt_j on and below the diagonal
    {
      float s[RI][RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        float cv[RI], bv[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) cv[i] = Cs[(ty + 16 * i) * S::NS + n];
#pragma unroll
        for (int j = 0; j < RI; ++j) bv[j] = Bs[(tx + 16 * j) * S::NS + n];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < RI; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          const int q = tx + 16 * j;
          float w = 0.f;
          if (r >= q) w = s[i][j] * expf(CUMs[r] - CUMs[q]) * DTs[q];
          Ws[r * S::WS + q] = w;
        }
      }
    }
    __syncthreads();

    // y = W @ x + exp(cum) * (C @ h^T), the state as the previous chunk
    // left it
    {
      float yi[RI][PJ], ye[RI][PJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int jj = 0; jj < PJ; ++jj) yi[i][jj] = ye[i][jj] = 0.f;
#pragma unroll 4
      for (int s = 0; s < CM; ++s) {
        float xv[PJ];
#pragma unroll
        for (int jj = 0; jj < PJ; ++jj) xv[jj] = Xs[s * S::XS + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float wv = Ws[(ty + 16 * i) * S::WS + s];
#pragma unroll
          for (int jj = 0; jj < PJ; ++jj) yi[i][jj] = fmaf(wv, xv[jj], yi[i][jj]);
        }
      }
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        float hv[PJ];
#pragma unroll
        for (int jj = 0; jj < PJ; ++jj) hv[jj] = Hs[(tx + 16 * jj) * S::NS + n];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float cv = Cs[(ty + 16 * i) * S::NS + n];
#pragma unroll
          for (int jj = 0; jj < PJ; ++jj) ye[i][jj] = fmaf(cv, hv[jj], ye[i][jj]);
        }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = ty + 16 * i;
        if (r >= c) continue;
        const float e = expf(CUMs[r]);
        float* yrow = yg + static_cast<long long>(l0 + r) * y_sl;
#pragma unroll
        for (int jj = 0; jj < PJ; ++jj)
          yrow[tx + 16 * jj] = fmaf(e, ye[i][jj], yi[i][jj]);
      }
    }
    __syncthreads();  // every reader of h is done before the update

    // h = h * exp(cum_last) + x^T @ (B * exp(cum_last - cum) * dt): each
    // thread updates its own [PJ, NJ] tile of h
    {
      const float dec = expf(cum_last);
      float acc[PJ][NJ];
#pragma unroll
      for (int i = 0; i < PJ; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          acc[i][j] = Hs[(ty + 16 * i) * S::NS + tx + 16 * j] * dec;
#pragma unroll 4
      for (int s = 0; s < CM; ++s) {
        const float sc = SCs[s];
        float xv[PJ], bv[NJ];
#pragma unroll
        for (int i = 0; i < PJ; ++i) xv[i] = Xs[s * S::XS + ty + 16 * i] * sc;
#pragma unroll
        for (int j = 0; j < NJ; ++j) bv[j] = Bs[s * S::NS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < PJ; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
      const bool last = l0 + c >= p.L;
      float* sg = p.state + (static_cast<long long>(b) * p.H + h) * P * N;
#pragma unroll
      for (int i = 0; i < PJ; ++i) {
        const int pr = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = tx + 16 * j;
          Hs[pr * S::NS + n] = acc[i][j];
          if (last) sg[pr * N + n] = acc[i][j];
        }
      }
    }
  }
}

template <int CM, int P, int N>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int bytes =
      Layout<CM, P, N>::floats * static_cast<int>(sizeof(float));
  // allow this kernel more than 48 KB of shared memory on the current
  // device; the attribute is per device, so it is set on every launch
  const cudaError_t attr = cudaFuncSetAttribute(
      ssd_scan_kernel<CM, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.H, batch);
  ssd_scan_kernel<CM, P, N><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// The kernel's instances, (P, N, longest chunk): Mamba2, Zamba2, the
// reduced configs.  The one list: the entry point dispatches on it and
// the wrapper reads it through repro_ssd_scan_instances.
struct Instance {
  int P, N, CM;
  cudaError_t (*run)(const Params&, int, cudaStream_t);
};
const Instance kInstances[] = {
    {64, 128, 64, launch<64, 64, 128>},
    {64, 64, 64, launch<64, 64, 64>},
    {16, 16, 16, launch<16, 16, 16>},
};
constexpr int kNumInstances = sizeof(kInstances) / sizeof(kInstances[0]);

}  // namespace

// Writes up to `cap` triples (P, N, longest chunk) to `out`; returns how
// many instances there are.
extern "C" int repro_ssd_scan_instances(int* out, int cap) {
  for (int i = 0; i < kNumInstances && i < cap; ++i) {
    out[3 * i] = kInstances[i].P;
    out[3 * i + 1] = kInstances[i].N;
    out[3 * i + 2] = kInstances[i].CM;
  }
  return kNumInstances;
}

extern "C" int repro_ssd_scan_f32(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* state, int batch, int L, int H, int P,
    int N, int chunk, long long x_sb, long long x_sl, long long x_sh,
    long long dt_sb, long long dt_sl, long long dt_sh, long long b_sb,
    long long b_sl, long long c_sb, long long c_sl, void* stream) {
  Params p{static_cast<const float*>(x), static_cast<const float*>(dt),
           static_cast<const float*>(A), static_cast<const float*>(B),
           static_cast<const float*>(C), static_cast<float*>(y),
           static_cast<float*>(state), x_sb, x_sl, x_sh, dt_sb, dt_sl,
           dt_sh, b_sb, b_sl, c_sb, c_sl, L, H, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || H == 0 || L == 0) return 0;
  if (chunk < 1 || L % chunk != 0) return cudaErrorInvalidValue;
  for (const Instance& in : kInstances) {
    if (in.P == P && in.N == N && chunk <= in.CM) {
      return static_cast<int>(in.run(p, batch, s));
    }
  }
  return cudaErrorInvalidValue;
}
