// Fused matmul B3 for Hopper (sm_90a), float32: the template that each
// compute-anchored matmul group instantiates.
//
// Replaces the TPU kernel `matmul_fused` (src/repro/kernels/matmul.py:53,
// pallas_call at :105): out = epilogue(prologue(lhs) @ rhs, operands).
// core/codegen_cuda.py generates, per stitched chain, a .cu file that
// includes this header and defines
//   Pro  -- float operator()(long long m, long long k, long long K):
//           the lhs element (m, k), computed from the prologue operands
//           as the k-tile is staged (no reduction: the cost model's gate
//           refuses a prologue that reduces over K);
//   Epi  -- kPhases, kSlots, slot_op(s), slot_phase(s) and
//           template <int P> elem(acc, m, n, N, red, part): phase P of
//           the epilogue on one accumulator element; in the last phase it
//           stores the outputs.  A reduction over N accumulates into
//           part[s] in its phase, is combined across the row's threads by
//           shuffles, and is read as red[s] in the phases after.
// and a C entry that picks one of the instances below by an index into
// kernels/matmul.py::TILES (the tile constants live there, shared with
// the cost model's feasibility gate).
//
// Design.  The TPU kernel tiles M by 128 and keeps the whole (K, N)
// panel in VMEM; an H100 block has 227 KB of shared memory, so here the
// grid runs over (N tiles, M tiles) and each block loops over K through
// shared memory: a (BM, BN) output tile a block, a (TM, TN) register tile
// a thread (rows ty*TM + i, columns tx*TN + j), float32 FMA on the CUDA
// cores, the sum over K in one order (no split, no TF32).  The next
// k-tile is loaded into registers while the current one is multiplied.
// M, K and N are runtime arguments, so a prefill and a decode call of
// one chain share one instance.  Bound: operations at prefill sizes
// (2 M N K FLOP against float32's 67 TFLOP/s), bytes at decode sizes
// (the K x N panel over 3.35 TB/s), where the small tile gives N / 32
// blocks to stream the panel.  An epilogue that reduces over N runs on
// the row tile, whose block holds the whole row (N <= 256) and whose 32
// threads along N are one warp.
#pragma once

#include "chain.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace repro_mm {

constexpr int kAPad = 4;  // floats of padding on each k-row of the lhs tile

#ifdef __CUDACC__

template <int P, int TM, int TN, int NT, class Epi>
__device__ __forceinline__ void epi_phase(
    const Epi& e, const float (&acc)[TM][TN], float (&red)[TM][Epi::kSlotsArr],
    long long mb, long long nb, long long M, long long N) {
  if constexpr (P < Epi::kPhases) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float part[Epi::kSlotsArr];
#pragma unroll
      for (int s = 0; s < Epi::kSlotsArr; ++s)
        part[s] = repro_chain::ident(Epi::slot_op(s));
      const long long m = mb + i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const long long n = nb + j;
        if (m < M && n < N)
          e.template elem<P>(acc[i][j], m, n, N, red[i], part);
      }
#pragma unroll
      for (int s = 0; s < Epi::kSlots; ++s) {
        if (Epi::slot_phase(s) != P) continue;
        float v = part[s];
#pragma unroll
        for (int w = NT / 2; w > 0; w >>= 1)
          v = repro_chain::combine(Epi::slot_op(s), v,
                                   __shfl_xor_sync(0xffffffffu, v, w));
        red[i][s] = v;
      }
    }
    epi_phase<P + 1, TM, TN, NT>(e, acc, red, mb, nb, M, N);
  }
}

template <int BM, int BN, int BK, int TM, int TN, class Pro, class Epi>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    mm_fused_kernel(const Pro pro, const float* __restrict__ rhs,
                    const Epi epi, int M, int K, int N) {
  constexpr int NT = BN / TN;  // threads along N
  constexpr int T = (BM / TM) * NT;
  constexpr int LA = BM * BK / T;
  constexpr int LB = BK * BN / T;
  static_assert(LA * T == BM * BK && LB * T == BK * BN, "tile split");
  static_assert(NT <= 32 && (NT & (NT - 1)) == 0, "row threads in a warp");
  __shared__ float As[BK][BM + kAPad];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x, tx = tid % NT, ty = tid / NT;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;
  float ra[LA], rb[LB];

  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int idx = tid + l * T, r = idx / BK, c = idx % BK;
      const long long m = m0 + r;
      const int k = k0 + c;
      ra[l] = (m < M && k < K) ? pro(m, k, K) : 0.f;
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int idx = tid + l * T, r = idx / BN, c = idx % BN;
      const int k = k0 + r, n = n0 + c;
      rb[l] = (k < K && n < N) ? rhs[static_cast<long long>(k) * N + n] : 0.f;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int idx = tid + l * T;
      As[idx % BK][idx / BK] = ra[l];
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int idx = tid + l * T;
      Bs[idx / BN][idx % BN] = rb[l];
    }
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);  // in flight while this tile multiplies
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float red[TM][Epi::kSlotsArr];
  epi_phase<0, TM, TN, NT>(epi, acc, red, m0 + ty * TM, n0 + tx * TN, M, N);
}

template <int BM, int BN, int BK, int TM, int TN, class Pro, class Epi>
cudaError_t launch(const Pro& pro, const float* rhs, const Epi& epi, int M,
                   int K, int N, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  mm_fused_kernel<BM, BN, BK, TM, TN, Pro, Epi>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(pro, rhs, epi, M, K, N);
  return cudaGetLastError();
}

#else  // host compile: the epilogue's phases row by row, for the CPU tests

template <int P, class Epi>
void epi_host_phase(const Epi& e, const float* acc, long long m, long long N,
                    float* red) {
  if constexpr (P < Epi::kPhases) {
    float part[Epi::kSlotsArr];
    for (int s = 0; s < Epi::kSlotsArr; ++s)
      part[s] = repro_chain::ident(Epi::slot_op(s));
    for (long long n = 0; n < N; ++n)
      e.template elem<P>(acc[m * N + n], m, n, N, red, part);
    for (int s = 0; s < Epi::kSlots; ++s)
      if (Epi::slot_phase(s) == P) red[s] = part[s];
    epi_host_phase<P + 1>(e, acc, m, N, red);
  }
}

template <class Epi>
void epilogue_host(const Epi& e, const float* acc, long long M, long long N) {
  for (long long m = 0; m < M; ++m) {
    float red[Epi::kSlotsArr];
    epi_host_phase<0>(e, acc, m, N, red);
  }
}

#endif

}  // namespace repro_mm
