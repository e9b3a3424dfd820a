// The streaming kernel of stitched groups whose rows are too long for
// one pass in registers (B2), for Hopper (sm_90a): the kernel body, a
// template on a generated group.
//
// Replaces the TPU kernel `_emit_pallas_streaming`
// (src/repro/core/codegen.py:763, pallas_call :903), which walks a
// sequential grid (rows, phases, column tiles) with float32 accumulators
// in VMEM and reads every full-row input once per phase.  A group has
// phases: phase p evaluates the nodes of reduce level <= p and
// accumulates the reductions of level p + 1 over the whole row; the
// last phase writes the outputs.
//
// Bound: bytes.  A softmax over [2048, 128256] reads 1.05 GB and writes
// 1.05 GB (0.63 ms at 3.35 TB/s); a design that reads its input once
// per phase moves twice that again.  So the row is held on chip: it is
// split across a thread-block cluster of K CTAs (K <= 8, the portable
// cluster size; chosen by the caller from the row's length) and each CTA
// stages its slice of every full-row input in shared memory once, by
// bulk copies of the Tensor Memory Accelerator (`cp.async.bulk`, one
// mbarrier a piece, so that phase 0 starts on the first piece while the
// rest arrive).  Every phase then runs over shared memory.  A phase's
// reductions are combined across the cluster through distributed shared
// memory: each CTA writes its partial, and after `barrier.cluster` each
// reads the K partials in rank order (the same order in every CTA, so
// the result is deterministic and equal in all of them).  The last phase
// writes the outputs once.  A slice longer than the stage holds (a row
// longer than the cluster holds) stages what fits and reads the rest
// from device memory in each phase.  Where a row's bytes are not 16-byte
// aligned the CTA stages with plain loads instead of bulk copies.
//
// A generated group G (core/codegen_cuda.py::stream_struct) provides:
//   kPhases, kSlots (reductions), slot_op(s), slot_phase(s);
//   kStaged full-row inputs that the kernel stages (float32, bfloat16,
//   float16, bool, 8- and 16-bit integers), staged_bytes(j) and
//   staged_src(j);
//   stage(st, lc, g): copy element g of each staged input to column lc
//   of its stage;
//   fetch(st, lc, g, fv): the staged inputs' values as float32, from the
//   stages at column lc (st non-null) or from device memory at g;
//   load(r, c, C, fv, v): every operand's value at element (r, c) into
//   Vals v, the unstaged ones from device memory;
//   elem<P>(r, c, C, v, red, part): phase P at element (r, c).
// In the last phase a thread loads kBatch elements before it computes
// and stores any of them: a load placed after a store to memory the
// compiler cannot prove apart waits for it, and an unstaged operand (a
// LayerNorm's gamma and beta) would cost a device-memory round trip an
// element.
// Rows, columns and the roles of the other inputs and outputs are the
// row view's (core/rowspec.py): the kernel sees a group as an [R, C]
// grid.  A cluster owns one row.
#pragma once

#include "chain.cuh"

#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#endif

#include <utility>

namespace repro_stream {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// bulk copies a slice is staged in, each completing its own barrier
constexpr int kPieces = 4;
// elements a thread loads in the last phase before it computes any
constexpr int kBatch = 8;

// The launch geometry: columns a CTA owns (slice) and stages (cap), both
// multiples of 16 elements; bulk: stage by bulk copies (every staged row
// 16-byte aligned).
struct Geometry {
  long long R, C, slice, cap;
  int bulk;
};

template <class G>
__host__ __device__ constexpr bool phase_reduces(int p) {
  for (int s = 0; s < G::kSlots; ++s)
    if (G::slot_phase(s) == p) return true;
  return false;
}

#ifdef __CUDACC__
namespace cg = cooperative_groups;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(b)));
}

__device__ __forceinline__ void bar_expect(unsigned long long* b,
                                           uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
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

// global -> this CTA's shared memory, `bytes` a multiple of 16, both
// addresses 16-byte aligned; completes `bytes` on the barrier
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes,
                                          unsigned long long* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

template <class G>
struct Shared {
  float cta_part[G::kSlotsArr];             // read by the whole cluster
  float warp_part[kWarps][G::kSlotsArr];
  unsigned long long bar[kPieces];
};

// Columns [p0, p1) of piece i of a staged slice of n columns.
__device__ __forceinline__ void piece_range(long long n, int i, long long& p0,
                                            long long& p1) {
  const long long step = ((n + kPieces - 1) / kPieces + 15) / 16 * 16;
  p0 = i * step;
  p1 = p0 + step < n ? p0 + step : n;
}

// Phase P over columns cbase + l, l in [n0, n1), a thread every kThreads
// (fetch(l, fv): the staged values).  The last phase, the one that
// stores, loads kBatch elements before it computes any of them.
template <class G, int P, class Fetch>
__device__ __forceinline__ void walk(const G& g, long long r, long long C,
                                     long long cbase, long long n0,
                                     long long n1, Fetch fetch,
                                     const float* red, float* part) {
  if constexpr (P + 1 < G::kPhases) {
#pragma unroll 4
    for (long long l = n0 + threadIdx.x; l < n1; l += kThreads) {
      float fv[G::kStagedArr];
      typename G::Vals v;
      fetch(l, fv);
      g.load(r, cbase + l, C, fv, v);
      g.template elem<P>(r, cbase + l, C, v, red, part);
    }
  } else {
    for (long long l = n0 + threadIdx.x; l < n1; l += kBatch * kThreads) {
      typename G::Vals v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long lu = l + u * kThreads;
        if (lu < n1) {
          float fv[G::kStagedArr];
          fetch(lu, fv);
          g.load(r, cbase + lu, C, fv, v[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long lu = l + u * kThreads;
        if (lu < n1) g.template elem<P>(r, cbase + lu, C, v[u], red, part);
      }
    }
  }
}

template <class G, int P>
__device__ __forceinline__ void run_phase(const G& g, const Geometry& a,
                                          Shared<G>& sm, void* const* st,
                                          long long r, long long c0,
                                          long long cs, long long c1,
                                          float* red,
                                          cg::cluster_group& cluster) {
  float part[G::kSlotsArr];
#pragma unroll
  for (int s = 0; s < G::kSlotsArr; ++s)
    part[s] = repro_chain::ident(G::slot_op(s));
  const long long ns = cs - c0;
  const long long row = r * a.C;
  const void* const* cst = st;
  auto staged = [&](long long l, float* fv) { g.fetch(cst, l, 0, fv); };
  if (P == 0 && a.bulk) {
    for (int i = 0; i < kPieces; ++i) {
      long long p0, p1;
      piece_range(ns, i, p0, p1);
      if (p0 >= p1) break;
      bar_wait(&sm.bar[i], 0);
      walk<G, P>(g, r, a.C, c0, p0, p1, staged, red, part);
    }
  } else if (P == 0) {
    walk<G, P>(g, r, a.C, c0, 0, ns,
               [&](long long l, float* fv) {
                 g.stage(st, l, row + c0 + l);
                 g.fetch(cst, l, 0, fv);
               },
               red, part);
  } else {
    walk<G, P>(g, r, a.C, c0, 0, ns, staged, red, part);
  }
  // the columns past the stage, from device memory in every phase
  walk<G, P>(g, r, a.C, cs, 0, c1 - cs,
             [&](long long l, float* fv) {
               g.fetch(nullptr, 0, row + cs + l, fv);
             },
             red, part);

  if constexpr (phase_reduces<G>(P)) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int s = 0; s < G::kSlotsArr; ++s) {
      if (s >= G::kSlots || G::slot_phase(s) != P) continue;
      float v = part[s];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v = repro_chain::combine(G::slot_op(s), v,
                                 __shfl_xor_sync(0xffffffffu, v, o));
      if (lane == 0) sm.warp_part[warp][s] = v;
    }
    __syncthreads();
    if (threadIdx.x < G::kSlots && G::slot_phase(threadIdx.x) == P) {
      const int s = threadIdx.x;
      float v = repro_chain::ident(G::slot_op(s));
      for (int w = 0; w < kWarps; ++w)
        v = repro_chain::combine(G::slot_op(s), v, sm.warp_part[w][s]);
      sm.cta_part[s] = v;
    }
    cluster.sync();  // every CTA's partial is written
    const int K = static_cast<int>(cluster.num_blocks());
#pragma unroll
    for (int s = 0; s < G::kSlotsArr; ++s) {
      if (s >= G::kSlots || G::slot_phase(s) != P) continue;
      float v = repro_chain::ident(G::slot_op(s));
      for (int q = 0; q < K; ++q)
        v = repro_chain::combine(G::slot_op(s), v,
                                 *cluster.map_shared_rank(&sm.cta_part[s], q));
      red[s] = v;
    }
  }
}

template <class G, int... P>
__device__ __forceinline__ void run_phases(std::integer_sequence<int, P...>,
                                           const G& g, const Geometry& a,
                                           Shared<G>& sm, void* const* st,
                                           long long r, long long c0,
                                           long long cs, long long c1,
                                           float* red,
                                           cg::cluster_group& cluster) {
  (run_phase<G, P>(g, a, sm, st, r, c0, cs, c1, red, cluster), ...);
}

template <class G>
__global__ void __launch_bounds__(kThreads) stream_kernel(G g, Geometry a) {
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ Shared<G> sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks());
  const long long rank = cluster.block_rank();
  const long long r = blockIdx.x / K;

  void* st[G::kStagedArr];
  {
    size_t off = 0;
    for (int j = 0; j < G::kStagedArr; ++j) {
      st[j] = dyn + off;
      off += (static_cast<size_t>(a.cap) * G::staged_bytes(j) + 15) / 16 * 16;
    }
  }
  const long long c0 = rank * a.slice < a.C ? rank * a.slice : a.C;
  const long long c1 = c0 + a.slice < a.C ? c0 + a.slice : a.C;
  const long long cs = c0 + a.cap < c1 ? c0 + a.cap : c1;
  const bool bulk = a.bulk && G::kStaged > 0 && cs > c0;
  if (threadIdx.x == 0 && bulk) {
    for (int i = 0; i < kPieces; ++i) bar_init(&sm.bar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < kPieces; ++i) {
      long long p0, p1;
      piece_range(cs - c0, i, p0, p1);
      if (p0 >= p1) break;
      uint32_t bytes = 0;
      for (int j = 0; j < G::kStaged; ++j)
        bytes += static_cast<uint32_t>((p1 - p0) * G::staged_bytes(j));
      bar_expect(&sm.bar[i], bytes);
      for (int j = 0; j < G::kStaged; ++j) {
        const int eb = G::staged_bytes(j);
        bulk_copy(static_cast<unsigned char*>(st[j]) + p0 * eb,
                  static_cast<const unsigned char*>(g.staged_src(j)) +
                      (r * a.C + c0 + p0) * eb,
                  static_cast<uint32_t>((p1 - p0) * eb), &sm.bar[i]);
      }
    }
  }
  __syncthreads();
  Geometry ga = a;
  ga.bulk = bulk;

  float red[G::kSlotsArr];
#pragma unroll
  for (int s = 0; s < G::kSlotsArr; ++s)
    red[s] = repro_chain::ident(G::slot_op(s));
  run_phases(std::make_integer_sequence<int, G::kPhases>{}, g, ga, sm, st, r,
             c0, cs, c1, red, cluster);
  // the cluster's reads of this CTA's partials are done before it exits
  cluster.sync();
}

// Dynamic shared memory of a launch: the stages of the staged inputs.
template <class G>
size_t stage_bytes(long long cap) {
  size_t off = 0;
  for (int j = 0; j < G::kStaged; ++j)
    off += (static_cast<size_t>(cap) * G::staged_bytes(j) + 15) / 16 * 16;
  return off;
}

template <class G>
cudaError_t launch(const G& g, long long R, long long C, int K,
                   long long slice, long long cap, int bulk,
                   cudaStream_t stream) {
  if (R <= 0 || C <= 0) return cudaSuccess;
  if (K < 1 || K > 8 || slice < 1 || cap < 0 ||
      static_cast<long long>(K) * slice < C)
    return cudaErrorInvalidValue;
  const size_t smem = stage_bytes<G>(cap);
  cudaError_t err = cudaFuncSetAttribute(
      stream_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(R * K), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(K);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  Geometry a{R, C, slice, cap, bulk};
  err = cudaLaunchKernelEx(&cfg, stream_kernel<G>, g, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

#else  // the host form, for the CPU tests: every row, phase by phase

template <class G, int P>
void host_phase(const G& g, long long r, long long C, float* red) {
  float part[G::kSlotsArr];
  for (int s = 0; s < G::kSlotsArr; ++s)
    part[s] = repro_chain::ident(G::slot_op(s));
  float fv[G::kStagedArr];
  for (long long c = 0; c < C; ++c) {
    typename G::Vals v;
    g.fetch(nullptr, 0, r * C + c, fv);
    g.load(r, c, C, fv, v);
    g.template elem<P>(r, c, C, v, red, part);
  }
  for (int s = 0; s < G::kSlots; ++s)
    if (G::slot_phase(s) == P) red[s] = part[s];
}

template <class G, int... P>
void host_phases(std::integer_sequence<int, P...>, const G& g, long long r,
                 long long C, float* red) {
  (host_phase<G, P>(g, r, C, red), ...);
}

template <class G>
void run_host(const G& g, long long R, long long C) {
  for (long long r = 0; r < R; ++r) {
    float red[G::kSlotsArr];
    for (int s = 0; s < G::kSlotsArr; ++s)
      red[s] = repro_chain::ident(G::slot_op(s));
    host_phases(std::make_integer_sequence<int, G::kPhases>{}, g, r, C, red);
  }
}

#endif

}  // namespace repro_stream
