// Fused matmul B3 for Hopper (sm_90a), float32 on the tensor cores: the
// template that each compute-anchored matmul group instantiates.
//
// Replaces the TPU kernel `matmul_fused` (src/repro/kernels/matmul.py:53,
// pallas_call at :105): out = epilogue(prologue(lhs) @ rhs, operands).
// core/codegen_cuda.py generates, per stitched chain, a .cu file that
// includes this header and defines
//   Pro  -- kIdentity (the lhs is operand 0, unchanged), kStaged and
//           kStagedBf16 (the operand staged by cp.async, and whether it is
//           bfloat16), kExact (the lhs values are bfloat16: exact in
//           TF32), kRhsBf16 (the rhs is bfloat16), kPhases, kSlots,
//           slot_op(s), slot_phase(s) and
//           template <int P> elem(m, k, K, red, part): phase P of the
//           prologue on one lhs element.  A reduction over K accumulates
//           into part[s] in its phase and is read as red[s] in the phases
//           after; the last phase returns the lhs element (m, k).
//   Epi  -- kPhases, kSlots, slot_op(s), slot_phase(s) and
//           template <int P> elem(acc, m, n, N, red, part): phase P of
//           the epilogue on one accumulator element; in the last phase it
//           stores the outputs.  A reduction over N accumulates into
//           part[s] in its phase, is combined across the row's threads,
//           and is read as red[s] in the phases after.
// and a C entry that picks one of the instances below by an index into
// kernels/matmul.py::TILES (the tile constants live there, shared with
// the cost model's feasibility gate; the generated source asserts that
// the shared memory the gate prices is smem_bytes() here).
//
// Design.  The TPU kernel tiles M by 128 and keeps the whole (K, N) panel
// in VMEM; here the grid runs over (N tiles, M tiles) and each block
// loops over K.  The products run on the tensor cores (`wgmma`, m64nNk8,
// TF32) through a three-way split: each float32 value x is big = tf32(x)
// plus small = tf32(x - big), both rounded as cvt.rna.tf32.f32 rounds,
// and a b is taken as big_a big_b + big_a small_b + small_a big_b, each
// product of two TF32 values exact, summed in float32 (what PyTorch's
// float32 attention does with CUTLASS's OpMultiplyAddFastF32).  The
// tensor cores' float32 sum does not round to nearest, so the products
// of PROMO k-tiles are summed from zero and then added to the block's
// accumulator on the CUDA cores: measured on the card
// (kernels/split_float.py), one tensor-core sum over all of K is 3.1
// times B3's limit off the plain product at K 8192, a sum each 32 of K
// 0.3 times.
//
// A prologue's float32 operand of the whole (M, K) view (Pro::kStaged;
// the lhs itself for the identity) is staged by cp.async as the identity
// lhs is, and the producers evaluate the prologue on the staged values
// (elem_at) as they split them; a prologue without one reads its
// operands through `pro`.  A prologue that reduces over K (an RMSNorm
// feeding a projection) needs each lhs row's statistics before its first
// k-tile is split, and the block stages K a tile at a time: so every warp
// of the block first streams the block's lhs rows over all of K, once a
// reduce level (a row a warp, lanes along K four values at a time, the
// partials combined by shuffles), and keeps the rows' statistics in
// shared memory; the split then evaluates the prologue's last phase from
// them.  That reads the lhs rows once more a level for each N tile (M K
// (N / BN) floats a level, mostly from L2); one launch, as in the
// reference.  (Blocks of a cluster along N sharing the statistics
// through distributed shared memory, each computing a quarter of the
// rows, measured slower on the card: the pass is bound by each block's
// latency through its rows, not by the bytes.)
//
// A block is warp-specialized.  Its last PW warpgroups are producers,
// each taking every PW-th k-tile: cp.async copies the float32 k-tiles of
// the lhs (or the prologue's staged operand) and of the rhs into a ring of RS raw stages, RS / PW - 1
// of a producer's tiles in flight; the producer then splits a landed
// tile into the operand ring (ST stages): big and small as K-major
// operand tiles in the canonical no-swizzle layout of `wgmma` (8 x
// 16-byte core matrices; TF32 operands of `wgmma` have no transpose, so
// the rhs, an N-contiguous [K, N] panel, is transposed by this pass), and
// arrives on the stage's `full` barrier.  The other warpgroups are
// consumers, each a 64 x (BN / WN) tile of the output: they wait on
// `full`, issue the 3 BK / 8 products, and every PROMO k-tiles drain
// them, free the stages on their `empty` barriers and add the partial
// sum; the consumers' partial sums start out of step, so one drains
// while the other's products run.  With two producers and two consumers
// the producers give registers to the consumers (setmaxnreg).  The
// epilogue runs on the `wgmma` accumulator fragment: a thread holds rows
// r and r + 8 of its warp's 16 rows and two adjacent columns of each 8,
// so a row's reduction over the block's N is a per-thread partial, then
// shuffles within the quad (xor 1, 2), then, where WN warpgroups split
// N, one exchange through shared memory in a fixed order.  An epilogue
// that reduces over N runs on the row tile, whose blocks along N form a
// thread-block cluster (N / BN blocks, at most 8, the portable size):
// after each reducing phase every block writes its rows' partials to its
// own shared memory, and after `barrier.cluster` each reads all the
// cluster's partials through distributed shared memory in rank order, so
// every block combines the same values in the same order.  The slot
// exchanges are sized from the chain's own count of reductions.  M, K
// and N are runtime arguments, so a prefill and a decode call of one
// chain share one instance.  Bound: operations at prefill sizes (2 M N K
// FLOP against the split's 165 TFLOP/s), bytes at decode sizes (the K x
// N panel over 3.35 TB/s), where the small tile streams the panel with
// two blocks an SM.
//
// bfloat16.  The rhs, the staged prologue operand and any chain operand
// may be bfloat16 (their bits; every chain value computes in float32 and
// rounds to its type at its node, codegen_cuda's `_typed`), and the
// accumulator is rounded to the product's type before the epilogue, as
// the reference's `anchor_dtype` cast.  A bfloat16 k-tile is staged as it
// is, 8 values a 16-byte copy, in the raw stages' room, and widened at
// the split.  A bfloat16 value is exact in TF32, so its split has no
// small half and its products with it are dropped: with the lhs
// (Pro::kExact: the prologue's lhs node is bfloat16) or the rhs in
// bfloat16 a k-step is two TF32 products, with neither three.  At most
// one side is bfloat16 here: a chain with both takes the native bfloat16
// products of matmul_bf16.cuh.
#pragma once

#include "chain.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#include <stdint.h>
#endif

namespace repro_mm {

// Shared memory of one block: ST operand stages of big and small TF32
// tiles of the lhs (AM x BK: AM = BM rows, or 8 where M <= 8) and the rhs
// (BN x BK), RS raw stages of the float32 k-tiles (the lhs rows padded to
// BK + 4 floats), the epilogue's es row reductions (exchanged across the
// WN consumer warpgroups, WN x BM rows, and across the cluster, BM rows),
// the prologue's ps row statistics (AM rows), the 2 ST barriers.
__host__ __device__ constexpr int smem_bytes(int bm, int bn, int bk, int st,
                                             int rs, int wn, int am, int es,
                                             int ps) {
  return 4 * (st * 2 * (am + bn) * bk + rs * (am * (bk + 4) + bk * bn)
              + (wn > 1 ? wn * bm * es : 0) + (es > 0 ? bm * es : 0)
              + am * ps)
         + 2 * st * 8;
}
// blocks a cluster of the row tile may hold (the portable size)
constexpr int kMaxCluster = 8;

#ifdef __CUDACC__

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// float, or uint16_t (bfloat16 bits) where B
template <bool B>
struct elem_type {
  using type = float;
};
template <>
struct elem_type<true> {
  using type = uint16_t;
};

// one value, and four consecutive values (16-byte aligned in float32,
// 8-byte in bfloat16), as float32
__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(*p) << 16);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const uint16_t* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// big and small TF32 halves of x, each rounded as cvt.rna.tf32.f32
// rounds (to nearest, ties away from zero: half of the last kept bit
// added to the magnitude, the 13 dropped bits cleared), in two integer
// operations each
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split_tf32(float x, float& big, float& small) {
  const uint32_t b = tf32_rna(x);
  big = __uint_as_float(b);
  small = __uint_as_float(tf32_rna(x - big));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// generic-proxy stores to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma's descriptor of a K-major operand tile in the no-swizzle layout:
// core matrices of 8 rows x 16 bytes, the two of a k8 step LBO apart,
// the next 8 rows SBO apart
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (+)= A B, m64nNk8, TF32 from shared memory, float32 in registers:
// N / 2 floats a thread; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int NW>
__device__ __forceinline__ void wgmma_tf32(float (&d)[NW / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  static_assert(NW == 32 || NW == 128, "wgmma width");
  if constexpr (NW == 32) wgmma_n32(d, da, db, scale_d);
  if constexpr (NW == 128) wgmma_n128(d, da, db, scale_d);
}

// Offset in floats of element (r, k) of an R x BK operand tile, K-major,
// no swizzle: [R / 8][BK / 4] core matrices of [8 rows][4 floats].
template <int BK>
__device__ __forceinline__ int tile_off(int r, int c) {  // c: k / 4
  return ((r >> 3) * (BK / 4) + c) * 32 + (r & 7) * 4;
}

// The thread-block cluster: its size, a barrier of every thread of every
// block (release / acquire: the shared-memory writes before it are
// visible to the reads after it, in any block), and a float of block
// `rank`'s shared memory at the address of `p` in this block's.
__device__ __forceinline__ int cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return static_cast<int>(n);
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ float ld_cluster(const float* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// Phase P of the epilogue on a consumer's fragment: rows m and m + 8,
// columns n + 8 j and n + 8 j + 1.  Reductions over N: per thread, then
// across the quad, then (WN > 1) across the WN warpgroups of the row
// through `xch` in a fixed order, then across the cluster's blocks
// through `cx` (each block's row partials, read by every block in rank
// order).  A slot is written in its own phase only, so one barrier a
// phase orders the writes before the reads.
template <int P, int BM, int NW, int WN, class Epi>
__device__ __forceinline__ void epi_phase(
    const Epi& e, const float (&acc)[NW / 2],
    float (&red)[2][Epi::kSlotsArr], long long m, long long n, long long M,
    long long N, float* xch, float* cx, int row, int wn, int consumers) {
  constexpr int S = Epi::kSlots;
  if constexpr (P < Epi::kPhases) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float part[Epi::kSlotsArr];
#pragma unroll
      for (int s = 0; s < Epi::kSlotsArr; ++s)
        part[s] = repro_chain::ident(Epi::slot_op(s));
      const long long mm = m + 8 * h;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const long long nn = n + 8 * j + c;
          if (mm < M && nn < N)
            e.template elem<P>(acc[4 * j + 2 * h + c], mm, nn, N, red[h],
                               part);
        }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (Epi::slot_phase(s) != P) continue;
        float v = part[s];
        v = repro_chain::combine(Epi::slot_op(s), v,
                                 __shfl_xor_sync(0xffffffffu, v, 1));
        v = repro_chain::combine(Epi::slot_op(s), v,
                                 __shfl_xor_sync(0xffffffffu, v, 2));
        red[h][s] = v;
      }
    }
    if constexpr (S > 0 && P < Epi::kPhases - 1) {
      if constexpr (WN > 1) {
        // xch[wn][row][s] (BM rows): each quad's first thread writes its
        // two rows' partials; every thread combines the WN of its rows in
        // order
        if ((threadIdx.x & 3) == 0)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int s = 0; s < S; ++s)
              if (Epi::slot_phase(s) == P)
                xch[(wn * BM + row + 8 * h) * S + s] = red[h][s];
        asm volatile("bar.sync 1, %0;" :: "r"(consumers * 128) : "memory");
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int s = 0; s < S; ++s) {
            if (Epi::slot_phase(s) != P) continue;
            float v = xch[(row + 8 * h) * S + s];
#pragma unroll
            for (int w = 1; w < WN; ++w)
              v = repro_chain::combine(Epi::slot_op(s), v,
                                       xch[(w * BM + row + 8 * h) * S + s]);
            red[h][s] = v;
          }
      }
      // cx[row][s]: the block's row partials, then the cluster's in rank
      // order (the producers meet the same barriers)
      if ((threadIdx.x & 3) == 0 && wn == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int s = 0; s < S; ++s)
            if (Epi::slot_phase(s) == P) cx[(row + 8 * h) * S + s] = red[h][s];
      cluster_sync();
      const int blocks = cluster_blocks();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (Epi::slot_phase(s) != P) continue;
          const float* src = cx + (row + 8 * h) * S + s;
          float v = ld_cluster(src, 0);
          for (int q = 1; q < blocks; ++q)
            v = repro_chain::combine(Epi::slot_op(s), v, ld_cluster(src, q));
          red[h][s] = v;
        }
    }
    epi_phase<P + 1, BM, NW, WN>(e, acc, red, m, n, M, N, xch, cx, row, wn,
                                 consumers);
  }
}

// The prologue's statistics of one lhs row: phase P < kPhases - 1 over
// all of K, the warp's lanes along K, each slot of phase P combined
// across the warp (every lane ends with the row's value).  With `xrow`
// (the staged operand's row, 16-byte aligned, K a multiple of 4) a lane
// reads 4 consecutive values at once and gives them to elem_at.
template <int P, class Pro, class T>
__device__ __forceinline__ void pro_stats(const Pro& pro, long long m, int K,
                                          const T* xrow,
                                          float (&red)[Pro::kSlotsArr],
                                          int lane) {
  if constexpr (P < Pro::kPhases - 1) {
    float part[Pro::kSlotsArr];
#pragma unroll
    for (int s = 0; s < Pro::kSlotsArr; ++s)
      part[s] = repro_chain::ident(Pro::slot_op(s));
    if (xrow != nullptr) {
      // U loads of 16 bytes in flight a lane before any is used: the pass
      // is bound by the latency of L2, not by its rate
      constexpr int U = 8;
      for (int k0 = 4 * lane; k0 < K; k0 += 128 * U) {
        float4 x[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          x[u] = k0 + 128 * u < K ? ld4(xrow + k0 + 128 * u)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int k = k0 + 128 * u;
          if (k >= K) break;
          pro.template elem_at<P>(x[u].x, m, k, K, red, part);
          pro.template elem_at<P>(x[u].y, m, k + 1, K, red, part);
          pro.template elem_at<P>(x[u].z, m, k + 2, K, red, part);
          pro.template elem_at<P>(x[u].w, m, k + 3, K, red, part);
        }
      }
    } else {
#pragma unroll 4
      for (int k = lane; k < K; k += 32)
        pro.template elem<P>(m, k, K, red, part);
    }
#pragma unroll
    for (int s = 0; s < Pro::kSlots; ++s) {
      if (Pro::slot_phase(s) != P) continue;
      float v = part[s];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v = repro_chain::combine(Pro::slot_op(s), v,
                                 __shfl_xor_sync(0xffffffffu, v, o));
      red[s] = v;
    }
    pro_stats<P + 1>(pro, m, K, xrow, red, lane);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

template <int BM, int BN, int BK, int ST, int RS, int WN, int PROMO, int PW,
          int AM, class Pro, class Epi>
__global__ void __launch_bounds__(128 * (BM / 64 * WN + PW), 1)
    mm_fused_kernel(const Pro pro, const void* __restrict__ rhs_v,
                    const Epi epi, int M, int K, int N) {
  // the staged lhs operand's and the rhs's types, and the values a
  // 16-byte copy of each carries
  using LhsT = typename elem_type<Pro::kStagedBf16>::type;
  using RhsT = typename elem_type<Pro::kRhsBf16>::type;
  constexpr int VA = 16 / sizeof(LhsT), VB = 16 / sizeof(RhsT);
  const RhsT* rhs = static_cast<const RhsT*>(rhs_v);
  constexpr int WM = BM / 64;          // consumer warpgroups along M
  constexpr int CW = WM * WN;          // consumer warpgroups
  constexpr int NW = BN / WN;          // columns of a consumer
  // AM < BM (8 rows, M <= 8): the lhs tile holds 8 rows, and its
  // descriptor repeats them over the 64 rows of `wgmma` (a row-group
  // stride of 0): rows 8-63 of the product copy rows 0-7 and are dropped
  constexpr int A_F = AM * BK, B_F = BN * BK;
  constexpr int STAGE_F = 2 * (A_F + B_F);
  constexpr int AS = BK + 4;           // raw lhs row stride (floats)
  constexpr int ASE = AS * 4 / sizeof(LhsT);  // ... in LhsT values
  constexpr int RAW_A = AM * AS, RAW_F = RAW_A + BK * BN;
  constexpr int A_TASKS = AM * BK / 4;
  constexpr int A_COPIES = AM * BK / VA;
  constexpr int TA = (A_TASKS + 127) / 128, TB = BN * BK / 4 / 128;
  constexpr uint32_t LBO = 128, SBO = BK / 4 * 128, SBO_A = AM < BM ? 0 : SBO;
  static_assert(BM % 64 == 0 && BN % (8 * WN) == 0 && BN % 32 == 0
                && BK % 8 == 0, "tile");
  static_assert(TB * 512 == B_F, "producer tasks");
  static_assert(AM == BM || (AM == 8 && BM == 64), "lhs rows");
  static_assert(ST >= PROMO && RS % PW == 0 && RS / PW >= 2, "ring depths");
  static_assert(PW == 1 || PW == 2, "producer warpgroups");
  static_assert(!(Pro::kExact && Pro::kRhsBf16),
                "bfloat16 x bfloat16 takes matmul_bf16.cuh");
  // registers moved from the producers to the consumers where four
  // warpgroups share the register file: 2 x 104 + 2 x 152 (x 128)
  constexpr bool kRealloc = CW == 2 && PW == 2;
  constexpr int ES = Epi::kSlots, PS = Pro::kSlots;
  extern __shared__ __align__(128) float smem[];
  float* raw = smem + ST * STAGE_F;
  float* xch = raw + RS * RAW_F;                  // [WN][BM][ES], WN > 1
  float* cx = xch + (WN > 1 ? WN * BM * ES : 0);  // [BM][ES]
  float* stats = cx + (ES > 0 ? BM * ES : 0);     // [AM][PS]
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + AM * PS);
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x, wg = tid / 128;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;

  // operand rows past M and columns past N are never stored: zero once
  {
    float4* z = reinterpret_cast<float4*>(smem);
    for (int i = tid; i < ST * STAGE_F / 4; i += blockDim.x)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 128 * CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the operand staged by 16-byte copies: the raw float32 lhs of the
  // identity prologue, else the prologue's own float32 (M, K) operand
  // (kStaged), from which the split evaluates the prologue
  const LhsT* lhs =
      static_cast<const LhsT*>(pro.in[Pro::kStaged >= 0 ? Pro::kStaged : 0]);
  const bool a_raw = Pro::kStaged >= 0 && K % VA == 0
                     && (reinterpret_cast<uintptr_t>(lhs) & 15) == 0;
  if constexpr (PS > 0) {
    // the prologue's row statistics: a row a warp, every warp of the block
    const int lane = tid & 31;
    for (int r = tid >> 5; r < AM; r += blockDim.x >> 5) {
      if (m0 + r >= M) break;
      float red[Pro::kSlotsArr];
#pragma unroll
      for (int s = 0; s < Pro::kSlotsArr; ++s)
        red[s] = repro_chain::ident(Pro::slot_op(s));
      pro_stats<0>(pro, m0 + r, K, a_raw ? lhs + (m0 + r) * K : nullptr,
                   red, lane);
      if (lane == 0)
#pragma unroll
        for (int s = 0; s < PS; ++s) stats[r * PS + s] = red[s];
    }
  }
  __syncthreads();

  if (wg >= CW) {
    if constexpr (kRealloc)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 104;" ::: "memory");
    // ---- producer: raw k-tiles by cp.async RS / PW - 1 ahead; split each into
    // the operand ring ------------------------------------------------------
    // producer p takes the k-tiles kt = p mod PW, each from its own raw
    // slots (kt mod RS), RR of them, RR - 1 in flight
    const int pw = wg - CW, pt = tid - 128 * wg;
    constexpr int RR = RS / PW;
    // 16-byte copies need K (N) a multiple of 4 (8 in bfloat16) and
    // aligned bases; any other lhs (a prologue without a float32 or
    // bfloat16 (M, K) operand, an odd K) is read through `pro` by the split
    const bool b_raw = N % VB == 0
                       && (reinterpret_cast<uintptr_t>(rhs) & 15) == 0;
    // This thread's tasks, the same in every k-tile.  Copies: lhs chunk
    // (row r, VA k) and rhs chunk (k row kr, VB n), into the raw stage as
    // LhsT and RhsT values.  Split: lhs task (row, chunk of 4) with 8 rows of
    // one chunk a phase (conflict-free reads of the padded raw rows,
    // 128-byte stores of a core matrix); rhs task (col, chunk) with a warp
    // on 32 consecutive columns of one chunk, so the raw [BK][BN] tile is
    // read along its rows and written K-major.
    constexpr int CA = (A_COPIES + 127) / 128, CB = BK * BN / VB / 128;
    static_assert(CB * 128 * VB == BK * BN, "copies");
    int ca_dst[CA], cb_dst[CB];
    const LhsT* ca_src[CA];
    const RhsT* cb_src[CB];
    bool ca_ok[CA], cb_ok[CB];
    int cb_k[CB];
#pragma unroll
    for (int i = 0; i < CA; ++i) {
      const int j = pt + 128 * i, r = j / (BK / VA), c = j % (BK / VA);
      ca_dst[i] = r * ASE + VA * c;
      ca_ok[i] = j < A_COPIES && m0 + r < M;
      ca_src[i] = lhs + (ca_ok[i] ? (m0 + r) * K : 0) + VA * c;
    }
#pragma unroll
    for (int i = 0; i < CB; ++i) {
      const int j = pt + 128 * i, kr = j / (BN / VB), c = j % (BN / VB);
      cb_dst[i] = kr * BN + VB * c;
      cb_ok[i] = n0 + VB * c < N;
      cb_k[i] = kr;
      cb_src[i] = rhs + static_cast<long long>(kr) * N
                  + (cb_ok[i] ? n0 + VB * c : 0);
    }
    int a_src[TA], a_dst[TA], b_src[TB], b_dst[TB];
    bool a_ok[TA], b_ok[TB];
#pragma unroll
    for (int i = 0; i < TA; ++i) {
      const int t = pt + 128 * i;
      const int row = (t / (8 * (BK / 4))) * 8 + (t & 7);
      const int c = (t >> 3) % (BK / 4);
      a_src[i] = row * ASE + 4 * c;
      a_dst[i] = tile_off<BK>(row, c);
      a_ok[i] = t < A_TASKS && m0 + row < M;
    }
#pragma unroll
    for (int i = 0; i < TB; ++i) {
      const int t = pt + 128 * i;
      const int col = (t / (32 * (BK / 4))) * 32 + (t & 31);
      const int c = (t >> 5) % (BK / 4);
      b_src[i] = 4 * c * BN + col;
      b_dst[i] = tile_off<BK>(col, c);
      b_ok[i] = n0 + col < N;
    }

    auto issue = [&](int kt) {
      if (kt < ktiles) {
        float* raw_s = raw + (kt % RS) * RAW_F;
        LhsT* raw_a = reinterpret_cast<LhsT*>(raw_s);
        RhsT* raw_b = reinterpret_cast<RhsT*>(raw_s + RAW_A);
        const int k0 = kt * BK;
        if (a_raw)
#pragma unroll
          for (int i = 0; i < CA; ++i) {
            const int k = k0 + VA * ((pt + 128 * i) % (BK / VA));
            if (ca_ok[i])
              cp_async16(raw_a + ca_dst[i], ca_src[i] + (k < K ? k0 : 0),
                         k < K ? 16 : 0);
          }
        if (b_raw)
#pragma unroll
          for (int i = 0; i < CB; ++i) {
            const bool in = cb_ok[i] && k0 + cb_k[i] < K;
            cp_async16(raw_b + cb_dst[i],
                       in ? cb_src[i] + static_cast<long long>(k0) * N
                          : rhs, in ? 16 : 0);
          }
      }
      cp_async_commit();  // empty past the last tile: the count holds
    };
    auto store4 = [](float* big, float* small, float x0, float x1, float x2,
                     float x3) {
      float4 b4, s4;
      split_tf32(x0, b4.x, s4.x);
      split_tf32(x1, b4.y, s4.y);
      split_tf32(x2, b4.z, s4.z);
      split_tf32(x3, b4.w, s4.w);
      *reinterpret_cast<float4*>(big) = b4;
      *reinterpret_cast<float4*>(small) = s4;
    };
    auto split = [&](int kt) {
      const int s = kt % ST, k0 = kt * BK;
      if (kt >= ST) mbar_wait(&empty[s], (kt / ST - 1) & 1);
      float* a_big = smem + s * STAGE_F;
      float* b_big = a_big + 2 * A_F;
      const float* raw_s = raw + (kt % RS) * RAW_F;
      const LhsT* ra = reinterpret_cast<const LhsT*>(raw_s);
      const RhsT* rb = reinterpret_cast<const RhsT*>(raw_s + RAW_A);
      if (a_raw) {
#pragma unroll
        for (int i = 0; i < TA; ++i) {
          if (!a_ok[i]) continue;
          const float4 x = ld4(ra + a_src[i]);
          if constexpr (Pro::kIdentity) {
            store4(a_big + a_dst[i], a_big + A_F + a_dst[i], x.x, x.y, x.z,
                   x.w);
          } else {
            // the prologue's last phase on the staged values (columns
            // past K stay zero, whatever the prologue makes of 0)
            const int t = pt + 128 * i;
            const long long m = m0 + (t / (8 * (BK / 4))) * 8 + (t & 7);
            const int k = k0 + 4 * ((t >> 3) % (BK / 4));
            const float* red = stats + (m - m0) * PS;
            const float xv[4] = {x.x, x.y, x.z, x.w};
            float v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              v[j] = k + j < K ? pro.template elem_at<Pro::kPhases - 1>(
                                     xv[j], m, k + j, K, red, nullptr)
                               : 0.f;
            store4(a_big + a_dst[i], a_big + A_F + a_dst[i], v[0], v[1],
                   v[2], v[3]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < TA; ++i) {
          if (!a_ok[i]) continue;
          const int t = pt + 128 * i;
          const long long m = m0 + (t / (8 * (BK / 4))) * 8 + (t & 7);
          const int k = k0 + 4 * ((t >> 3) % (BK / 4));
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j] = k + j < K ? pro(m, k + j, K, stats + (m - m0) * PS)
                             : 0.f;
          store4(a_big + a_dst[i], a_big + A_F + a_dst[i], v[0], v[1], v[2],
                 v[3]);
        }
      }
      if (b_raw) {
#pragma unroll
        for (int i = 0; i < TB; ++i) {
          if (!b_ok[i]) continue;
          const RhsT* x = rb + b_src[i];
          store4(b_big + b_dst[i], b_big + B_F + b_dst[i], ld1(x),
                 ld1(x + BN), ld1(x + 2 * BN), ld1(x + 3 * BN));
        }
      } else {
#pragma unroll
        for (int i = 0; i < TB; ++i) {
          if (!b_ok[i]) continue;
          const int t = pt + 128 * i;
          const int n = n0 + (t / (32 * (BK / 4))) * 32 + (t & 31);
          const int k = k0 + 4 * ((t >> 5) % (BK / 4));
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j] = k + j < K
                       ? ld1(rhs + static_cast<long long>(k + j) * N + n)
                       : 0.f;
          store4(b_big + b_dst[i], b_big + B_F + b_dst[i], v[0], v[1], v[2],
                 v[3]);
        }
      }
      fence_proxy_async();
      mbar_arrive(&full[s]);
    };
    for (int i = 0; i < RR - 1; ++i) issue(pw + PW * i);
    for (int kt = pw; kt < ktiles; kt += PW) {
      cp_async_wait<RR - 2>();
      // every thread of this producer has its copies of tile kt, and all
      // have split its tile kt - PW, whose raw slot the next issue refills
      asm volatile("bar.sync %0, 128;" :: "r"(2 + pw) : "memory");
      issue(kt + PW * (RR - 1));
      split(kt);
    }
    // the consumers' cluster barriers, one a reducing phase of the
    // epilogue and one before the exit, are every thread's
    if constexpr (ES > 0)
      for (int p = 0; p < Epi::kPhases; ++p) cluster_sync();
  } else {
    // ---- consumers: wgmma on PROMO stages into a partial sum from zero,
    // then added on the CUDA cores ----------------------------------------
    if constexpr (kRealloc)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 152;" ::: "memory");
    const int wm = wg / WN, wn = wg % WN;
    float acc[NW / 2], part[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = part[i] = 0.f;
    // consumer w's partial sums start at k-tiles w mod PROMO: the
    // warpgroups drain and add out of step, each while the other's
    // products keep the tensor cores busy
    const int shift = wg % PROMO;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % ST;
      const int pos = (kt + PROMO - shift) % PROMO;
      const bool first = pos == 0 || kt == 0;
      const bool last = pos == PROMO - 1 || kt == ktiles - 1;
      mbar_wait(&full[s], (kt / ST) & 1);
      const uint32_t a_big = smem_u32(smem + s * STAGE_F) + wm * 64 * BK * 4;
      const uint32_t a_small = a_big + A_F * 4;
      const uint32_t b_big = smem_u32(smem + s * STAGE_F + 2 * A_F)
                             + wn * NW * BK * 4;
      const uint32_t b_small = b_big + B_F * 4;
      if (first) fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int k8 = 0; k8 < BK / 8; ++k8) {
        const uint32_t o = k8 * 256;  // two core matrices a k8 step
        // a bfloat16 side's small half is zero: its product is dropped
        int acc_d = !(first && k8 == 0);
        if constexpr (!Pro::kExact) {
          wgmma_tf32<NW>(part, gmma_desc(a_small + o, LBO, SBO_A),
                         gmma_desc(b_big + o, LBO, SBO), acc_d);
          acc_d = 1;
        }
        if constexpr (!Pro::kRhsBf16) {
          wgmma_tf32<NW>(part, gmma_desc(a_big + o, LBO, SBO_A),
                         gmma_desc(b_small + o, LBO, SBO), acc_d);
          acc_d = 1;
        }
        wgmma_tf32<NW>(part, gmma_desc(a_big + o, LBO, SBO_A),
                       gmma_desc(b_big + o, LBO, SBO), acc_d);
      }
      wgmma_commit();
      if (last) {
        wgmma_wait_all();
        fence_regs(part);
        for (int j = kt - pos; j <= kt; ++j)
          if (j >= 0) mbar_arrive(&empty[j % ST]);
#pragma unroll
        for (int i = 0; i < NW / 2; ++i) acc[i] += part[i];
      }
    }

    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int row = wm * 64 + warp * 16 + (lane >> 2);
    float red[2][Epi::kSlotsArr];
    epi_phase<0, BM, NW, WN>(epi, acc, red, m0 + row,
                             n0 + wn * NW + 2 * (lane & 3), M, N, xch, cx,
                             row, wn, CW);
    // the cluster's reads of this block's partials are done before it
    // exits
    if constexpr (ES > 0) cluster_sync();
  }
}

template <int BM, int BN, int BK, int ST, int RS, int WN, int PROMO, int PW,
          int AM, class Pro, class Epi>
cudaError_t launch(const Pro& pro, const void* rhs, const Epi& epi, int M,
                   int K, int N, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (AM < BM && M > AM) return cudaErrorInvalidValue;
  constexpr int bytes = smem_bytes(BM, BN, BK, ST, RS, WN, AM, Epi::kSlots,
                                   Pro::kSlots);
  auto kernel =
      mm_fused_kernel<BM, BN, BK, ST, RS, WN, PROMO, PW, AM, Pro, Epi>;
  // above 48 KB only as dynamic shared memory, allowed per device: set on
  // every launch
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  const int threads = 128 * (BM / 64 * WN + PW);
  if constexpr (Epi::kSlots == 0) {
    kernel<<<grid, threads, bytes, stream>>>(pro, rhs, epi, M, K, N);
    return cudaGetLastError();
  }
  // an epilogue that reduces over N: the blocks of a row form one cluster
  const unsigned cluster = grid.x;
  if (cluster > kMaxCluster) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, pro, rhs, epi, M, K, N);
  if (err != cudaSuccess) return err;
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

template <int P, class Pro>
void pro_host_phase(const Pro& pro, long long m, long long K, float* red) {
  if constexpr (P < Pro::kPhases - 1) {
    float part[Pro::kSlotsArr];
    for (int s = 0; s < Pro::kSlotsArr; ++s)
      part[s] = repro_chain::ident(Pro::slot_op(s));
    for (long long k = 0; k < K; ++k) pro.template elem<P>(m, k, K, red, part);
    for (int s = 0; s < Pro::kSlots; ++s)
      if (Pro::slot_phase(s) == P) red[s] = part[s];
    pro_host_phase<P + 1>(pro, m, K, red);
  }
}

// the staged operand's value i, as float32
template <class Pro>
float staged_host(const Pro& pro, long long i) {
  if constexpr (Pro::kStagedBf16)
    return repro_chain::from_bf16(
        static_cast<const uint16_t*>(pro.in[Pro::kStaged])[i]);
  else
    return static_cast<const float*>(pro.in[Pro::kStaged])[i];
}

template <int P, class Pro>
void pro_host_phase_at(const Pro& pro, long long m, long long K, float* red) {
  if constexpr (P < Pro::kPhases - 1) {
    float part[Pro::kSlotsArr];
    for (int s = 0; s < Pro::kSlotsArr; ++s)
      part[s] = repro_chain::ident(Pro::slot_op(s));
    for (long long k = 0; k < K; ++k)
      pro.template elem_at<P>(staged_host(pro, m * K + k), m, k, K, red,
                              part);
    for (int s = 0; s < Pro::kSlots; ++s)
      if (Pro::slot_phase(s) == P) red[s] = part[s];
    pro_host_phase_at<P + 1>(pro, m, K, red);
  }
}

// the lhs the prologue makes, row by row: its statistics, then its
// elements; with `staged` as the kernel makes it from a staged operand
// (elem_at given the operand's value)
template <class Pro>
void prologue_host(const Pro& pro, float* lhs, long long M, long long K,
                   bool staged) {
  for (long long m = 0; m < M; ++m) {
    float red[Pro::kSlotsArr];
    for (int s = 0; s < Pro::kSlotsArr; ++s)
      red[s] = repro_chain::ident(Pro::slot_op(s));
    if (staged && Pro::kStaged >= 0) {
      pro_host_phase_at<0>(pro, m, K, red);
      for (long long k = 0; k < K; ++k)
        lhs[m * K + k] = pro.template elem_at<Pro::kPhases - 1>(
            staged_host(pro, m * K + k), m, k, K, red, nullptr);
    } else {
      pro_host_phase<0>(pro, m, K, red);
      for (long long k = 0; k < K; ++k) lhs[m * K + k] = pro(m, k, K, red);
    }
  }
}

#endif

}  // namespace repro_mm
