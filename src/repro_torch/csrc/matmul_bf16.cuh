// Fused matmul B3 for Hopper (sm_90a), bfloat16 x bfloat16 on the tensor
// cores at their native rate: the template an anchored matmul group
// instantiates where the prologue's lhs node and the rhs are both
// bfloat16 (core/codegen_cuda.py picks it; every other type pair takes the
// TF32 split of matmul_fused.cuh, whose Pro / Epi structs, statistics
// pass and epilogue phases this kernel shares).
//
// Replaces the TPU kernel `matmul_fused` (src/repro/kernels/matmul.py:53,
// pallas_call at :105) for those types: out = epilogue(prologue(lhs) @
// rhs, operands).
//
// Bound: operations at prefill sizes (2 M N K FLOP against the tensor
// cores' 989 TFLOP/s of bfloat16), bytes at decode sizes (the K x N
// panel, 2 bytes a value, over 3.35 TB/s).
//
// Design.  The operands cross shared memory once, as they are: no
// widening, no transpose, no split.  A k-tile is 64 of K, one 128-byte
// row of bfloat16 values a lhs row or rhs K row, in the 128-byte swizzle
// `wgmma` reads: the lhs as a K-major [AM, 64] box, the N-contiguous rhs
// as BN / 64 N-major [64 of K, 64 of N] boxes, read with B transposed
// (`wgmma`'s imm-trans-b 1, which bfloat16 allows and TF32 did not).  The
// Tensor Memory Accelerator copies them (`cp.async.bulk.tensor.2d`, a
// CUtensorMap per operand built at launch by cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint so that nothing links libcuda;
// out-of-range rows and columns are filled with zeros), completion
// counted in bytes on the stage's `full` mbarrier.  Where a map cannot be
// made (a row stride that is not a multiple of 16 bytes, a misaligned
// base) and where the lhs is a prologue's value, the producer warpgroup
// writes the same swizzled tile itself: a non-identity prologue (its lhs
// node bfloat16, so exact in bfloat16) is evaluated on its staged
// operand, read 16 bytes at a time where it is aligned, else through
// `pro`, and stored 8 values a 16-byte store; a reducing prologue has its
// statistics pass first, as in matmul_fused.cuh.  A ring of ST stages;
// the last warpgroup is the producer (one thread issues the copies), the
// others consume, each a 64 x (BN / WN) tile of the output:
// `wgmma.mma_async.m64nNk16.f32.bf16.bf16`, four a k-tile, accumulated
// over all of K (no partial sums: the product's bfloat16 rounding is far
// above the float32 sum's, PERF.md), one k-tile's products kept in
// flight (`wgmma.wait_group 1`) while the stage before is freed.  The
// float32 accumulator fragment is the TF32 instances' (rows r and r + 8,
// columns 2t and 2t + 1 of each 8), so the epilogue's phases, the cluster epilogue of the row
// tile and the rounding to the product's type are theirs.  An epilogue
// without row reductions runs from shared memory instead: the fragment is
// written to the freed ring, and each warp walks 32 consecutive columns,
// reading the operands of 32 elements (Epi::load) before it runs their
// chains and stores (Epi::elem_ops): coalesced, and the reads in flight
// together (in the fragment's order, with its 128 accumulators live, the
// Llama gate's epilogue took longer than the products).  The decode
// tile (AM 8) keeps 8 lhs rows and repeats them over the 64 rows of
// `wgmma` (a row-group stride of 0).  Without a cluster the grid is 1D
// and walks the output in groups of kGroupRows row tiles (`tile_of`), so
// that the blocks in flight share the lhs rows in L2 and the rhs is read
// once a group.
#pragma once

#include "matmul_fused.cuh"

#ifdef __CUDACC__
#include <cuda.h>  // CUtensorMap and its enums (types only)
#endif

namespace repro_mm {

// Shared memory of one native block: 1,024 bytes to align the ring to the
// swizzle's 1,024-byte atoms, ST stages of a lhs tile (AM rows) and a rhs
// tile (BN columns) of 64 bfloat16 values of K (128 bytes a row), two
// barriers a stage, the epilogue's es row reductions (exchanged across the
// WN consumer warpgroups, WN x BM rows, and across the cluster, BM rows)
// and the prologue's ps row statistics (AM rows).
__host__ __device__ constexpr int native_smem_bytes(int bm, int bn, int st,
                                                    int wn, int am, int es,
                                                    int ps) {
  return 1024 + st * 128 * (am + bn) + 16 * st
         + 4 * ((wn > 1 ? wn * bm * es : 0) + (es > 0 ? bm * es : 0)
                + am * ps);
}

#ifdef __CUDACC__

// ---- TMA and mbarrier transactions -------------------------------------
// an arrival on `bar` that also expects `bytes` of copies to complete
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// a 2D box at (c0 inner, c1 outer) of `map` into shared memory at dst,
// its bytes counted on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma's descriptor of a tile in the 128-byte swizzle: K-major (the lhs:
// 8-row groups SBO apart, LBO unused) or N-major (the rhs: 8-row groups
// of K SBO apart, 64-column boxes of N LBO apart)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// D (+)= A B, m64nNk16, bfloat16 from shared memory (A K-major, B
// N-major), float32 in registers: N / 2 floats a thread; scale_d 0
// overwrites D
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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

__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}


template <int NW>
__device__ __forceinline__ void wgmma_bf16(float (&d)[NW / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  static_assert(NW == 64 || NW == 128 || NW == 256, "wgmma width");
  if constexpr (NW == 64) wgmma_bf16_n64(d, da, db, scale_d);
  if constexpr (NW == 128) wgmma_bf16_n128(d, da, db, scale_d);
  if constexpr (NW == 256) wgmma_bf16_n256(d, da, db, scale_d);
}

// byte offset of the 16-byte chunk c (values 8c..8c+7) of row r of a tile
// of 128-byte rows in the 128-byte swizzle
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// eight float32 values rounded to bfloat16, as one 16-byte chunk
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;"
        : "=r"(w[i]) : "f"(v[2 * i + 1]), "f"(v[2 * i]));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// eight consecutive values (16-byte aligned) as float32
__device__ __forceinline__ void ld8(const uint16_t* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void ld8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Rows of output tiles a group of the 1D grid walks together: the
// blocks in flight share a panel of GM row tiles of the lhs (at Llama's
// M 2048 all of it, 12.6 MB at K 3072, held in L2) and stream the rhs
// once a group, where an N-fastest grid would read the whole rhs (50 MB,
// the L2's size) once a wave.
constexpr int kGroupRows = 16;

// The (row, column) output tile of block blockIdx.x of the 1D grid: the
// blocks of a group run down its GM row tiles, then along N.
__device__ __forceinline__ void tile_of(int M, int N, int BM, int BN,
                                        int& mt, int& nt) {
  const int nm = (M + BM - 1) / BM, nn = (N + BN - 1) / BN;
  const int id = blockIdx.x, group = id / (kGroupRows * nn);
  const int r = id - group * kGroupRows * nn;
  const int rows = min(kGroupRows, nm - group * kGroupRows);
  mt = group * kGroupRows + r % rows;
  nt = r / rows;
}

template <int BM, int BN, int ST, int WN, int AM, class Pro, class Epi>
__global__ void __launch_bounds__(128 * (BM / 64 * WN + 1),
                                  BM / 64 * WN == 1 ? 2 : 1)
    mm_bf16_kernel(const __grid_constant__ CUtensorMap tma_a,
                   const __grid_constant__ CUtensorMap tma_b, const Pro pro,
                   const uint16_t* __restrict__ rhs, const Epi epi, int M,
                   int K, int N, int a_tma, int b_tma) {
  using LhsT = typename elem_type<Pro::kStagedBf16>::type;
  constexpr int WM = BM / 64;          // consumer warpgroups along M
  constexpr int CW = WM * WN;          // consumer warpgroups
  constexpr int NW = BN / WN;          // columns of a consumer
  constexpr int A_BYTES = AM * 128, B_BYTES = BN * 128;
  constexpr int STAGE = A_BYTES + B_BYTES;
  constexpr uint32_t SBO_A = AM < BM ? 0 : 1024;
  static_assert(BM % 64 == 0 && BN % 64 == 0 && NW % 64 == 0, "tile");
  static_assert(AM == BM || (AM == 8 && BM == 64), "lhs rows");
  // registers moved from the producer to the consumers where two
  // consumer warpgroups share the register file: 40 + 2 x 232 (x 128)
  constexpr bool kRealloc = CW == 2;
  constexpr int ES = Epi::kSlots, PS = Pro::kSlots;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * STAGE);
  uint64_t* empty = full + ST;
  float* xch = reinterpret_cast<float*>(empty + ST);  // [WN][BM][ES]
  float* cx = xch + (WN > 1 ? WN * BM * ES : 0);      // [BM][ES]
  float* stats = cx + (ES > 0 ? BM * ES : 0);         // [AM][PS]

  const int tid = threadIdx.x, wg = tid / 128;
  // the output tile: the row tile's clusters along N (blockIdx.x), else
  // a 1D grid walked GM row tiles at a time (`tile_of`)
  int mt = blockIdx.y, nt = blockIdx.x;
  if constexpr (Epi::kSlots == 0) tile_of(M, N, BM, BN, mt, nt);
  const long long m0 = static_cast<long long>(mt) * BM;
  const int n0 = nt * BN;
  const int ktiles = (K + 63) / 64;

  // a stage is full when the TMA's bytes have landed and, where the
  // producer warpgroup writes a tile itself, each of its threads has
  // arrived; it is empty when each consumer warpgroup has arrived once
  const bool tma_only = a_tma && b_tma;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], tma_only ? 1 : 128);
      mbar_init(&empty[s], CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the staged operand: the lhs of the identity prologue, else the
  // prologue's own (M, K) operand, read 16 bytes at a time where aligned
  const LhsT* lhs =
      static_cast<const LhsT*>(pro.in[Pro::kStaged >= 0 ? Pro::kStaged : 0]);
  const bool a_vec = Pro::kStaged >= 0
                     && K % (16 / static_cast<int>(sizeof(LhsT))) == 0
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
      pro_stats<0>(pro, m0 + r, K, a_vec ? lhs + (m0 + r) * K : nullptr,
                   red, lane);
      if (lane == 0)
#pragma unroll
        for (int s = 0; s < PS; ++s) stats[r * PS + s] = red[s];
    }
  }
  __syncthreads();

  if (wg == CW) {
    if constexpr (kRealloc)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    // ---- producer: TMA, or the warpgroup's own stores, into the ring ---
    const int pt = tid - 128 * CW;
    const bool b_vec =
        N % 8 == 0 && (reinterpret_cast<uintptr_t>(rhs) & 15) == 0;
    const uint32_t tx = (a_tma ? A_BYTES : 0) + (b_tma ? B_BYTES : 0);
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % ST, k0 = kt * 64;
      if (kt >= ST) mbar_wait(&empty[s], (kt / ST - 1) & 1);
      unsigned char* sa = ring + s * STAGE;
      unsigned char* sb = sa + A_BYTES;
      if (!a_tma) {
        // lhs chunk (row r, values 8c..8c+7 of the k-tile), evaluated
        for (int i = pt; i < AM * 8; i += 128) {
          const int r = i >> 3, c = i & 7, k = k0 + 8 * c;
          const long long m = m0 + r;
          float v[8];
          if (m < M && a_vec && k + 8 <= K) {
            float x[8];
            ld8(lhs + m * K + k, x);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              v[j] = Pro::kIdentity
                         ? x[j]
                         : pro.template elem_at<Pro::kPhases - 1>(
                               x[j], m, k + j, K, stats + r * PS, nullptr);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              v[j] = m < M && k + j < K ? pro(m, k + j, K, stats + r * PS)
                                        : 0.f;
          }
          *reinterpret_cast<uint4*>(sa + sw128(r, c)) = pack8(v);
        }
      }
      if (!b_tma) {
        // rhs chunk (K row kr, values 8c..8c+7 of the block's N)
        for (int i = pt; i < 64 * (BN / 8); i += 128) {
          const int kr = i / (BN / 8), c = i % (BN / 8);
          const int k = k0 + kr, n = n0 + 8 * c;
          uint4 u = make_uint4(0u, 0u, 0u, 0u);
          if (k < K) {
            const uint16_t* src = rhs + static_cast<long long>(k) * N + n;
            if (b_vec && n + 8 <= N) {
              u = *reinterpret_cast<const uint4*>(src);
            } else {
              uint16_t h[8];
#pragma unroll
              for (int j = 0; j < 8; ++j) h[j] = n + j < N ? src[j] : 0;
              u = make_uint4(h[0] | (uint32_t(h[1]) << 16),
                             h[2] | (uint32_t(h[3]) << 16),
                             h[4] | (uint32_t(h[5]) << 16),
                             h[6] | (uint32_t(h[7]) << 16));
            }
          }
          *reinterpret_cast<uint4*>(sb + (c >> 3) * 8192
                                    + sw128(kr, c & 7)) = u;
        }
      }
      // every thread's stores, then its arrival; the copies' bytes
      // complete the stage
      if (!a_tma || !b_tma) fence_proxy_async();
      if (pt == 0 && tx) {
        mbar_arrive_tx(&full[s], tx);
        if (a_tma)
          tma_load_2d(sa, &tma_a, &full[s], k0, static_cast<int>(m0));
        if (b_tma)
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(sb + j * 8192, &tma_b, &full[s], n0 + 64 * j, k0);
      } else if (!tma_only) {
        mbar_arrive(&full[s]);
      }
    }
    // the consumers' cluster barriers, one a reducing phase of the
    // epilogue and one before the exit, are every thread's
    if constexpr (ES > 0)
      for (int p = 0; p < Epi::kPhases; ++p) cluster_sync();
  } else {
    if constexpr (kRealloc)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int wm = wg / WN, wn = wg % WN;
    float acc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    // one thread a warpgroup frees a stage, once the warpgroup's products
    // that read it are done
    const bool signal = (tid & 127) == 0;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % ST;
      mbar_wait(&full[s], (kt / ST) & 1);
      const uint32_t a0 = smem_u32(ring + s * STAGE) + wm * 64 * 128;
      const uint32_t b0 = smem_u32(ring + s * STAGE + A_BYTES)
                          + wn * (NW / 64) * 8192;
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < 4; ++k16)
        wgmma_bf16<NW>(acc, desc_sw128(a0 + 32 * k16, 16, SBO_A),
                       desc_sw128(b0 + 2048 * k16, 8192, 1024), 1);
      wgmma_commit();
      // the k-tile before is done: free its stage
      wgmma_wait<1>();
      if (kt > 0 && signal) mbar_arrive(&empty[(kt - 1) % ST]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int row = wm * 64 + warp * 16 + (lane >> 2);
    if constexpr (ES == 0) {
      // an epilogue without row reductions runs from shared memory: the
      // accumulator fragment is written to the free ring (rows padded by
      // 8 floats: two wavefronts a store), then the warpgroup walks its
      // tile row by row, a warp on 32 consecutive columns, so that the
      // chain's operand loads and output stores are coalesced and few
      // registers stay live
      constexpr int LD = NW + 8, ROWS = AM < BM ? AM : 64;
      static_assert(CW * 64 * LD * 4 <= ST * STAGE, "staged epilogue");
      float* tile = reinterpret_cast<float*>(ring) + wg * 64 * LD;
      asm volatile("bar.sync 3, %0;" :: "r"(CW * 128) : "memory");
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              tile + (row - wm * 64 + 8 * h) * LD + 8 * j + 2 * (lane & 3)) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      asm volatile("bar.sync %0, 128;" :: "r"(4 + wg) : "memory");
      const long long mb = m0 + wm * 64;
      const int nb = n0 + wn * NW, lt = tid & 127;
      // CH elements a thread at a time: their operands all read, then
      // their chains run and store (Epi::load, Epi::elem_ops)
      constexpr int IT = ROWS * NW / 128, CH = IT % 32 == 0 ? 32 : IT;
      static_assert(ROWS * NW % 128 == 0, "a warpgroup's walk");
      const bool inside = mb + ROWS <= M && nb + NW <= N;
#pragma unroll 1
      for (int c0 = 0; c0 < IT; c0 += CH) {
        typename Epi::Ops ops[CH];
        float a[CH];
        bool in[CH];
#pragma unroll
        for (int q = 0; q < CH; ++q) {
          const int i = (c0 + q) * 128 + lt, r = i / NW, c = i % NW;
          in[q] = inside || (mb + r < M && nb + c < N);
          if (in[q]) ops[q] = epi.load(mb + r, nb + c, N);
          a[q] = tile[r * LD + c];
        }
#pragma unroll
        for (int q = 0; q < CH; ++q) {
          const int i = (c0 + q) * 128 + lt, r = i / NW, c = i % NW;
          if (in[q])
            epi.template elem_ops<0>(a[q], ops[q], mb + r, nb + c, N);
        }
      }
    } else {
      float red[2][Epi::kSlotsArr];
      epi_phase<0, BM, NW, WN>(epi, acc, red, m0 + row,
                               n0 + wn * NW + 2 * (lane & 3), M, N, xch, cx,
                               row, wn, CW);
    }
    // the cluster's reads of this block's partials are done before it
    // exits
    if constexpr (ES > 0) cluster_sync();
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no libcuda link)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map of the row-major bfloat16 [rows, cols] array at p in boxes of
// [box_rows, 64 columns], 128-byte swizzle, zeros out of range; false
// where the TMA cannot read it (a misaligned base or row stride).
inline bool tensor_map(CUtensorMap* map, const void* p, long long rows,
                       long long cols, int box_rows) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) || (cols * 2) % 16) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols * 2)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                   const_cast<void*>(p), dims, strides, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int BN, int ST, int WN, int AM, class Pro, class Epi>
cudaError_t launch_bf16(const Pro& pro, const void* rhs, const Epi& epi,
                        int M, int K, int N, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (AM < BM && M > AM) return cudaErrorInvalidValue;
  if (encoder() == nullptr) return cudaErrorNotSupported;
  constexpr int bytes = native_smem_bytes(BM, BN, ST, WN, AM, Epi::kSlots,
                                          Pro::kSlots);
  static_assert(bytes <= 232448, "shared memory of one block");
  CUtensorMap ta{}, tb{};
  const int a_tma = Pro::kIdentity && K > 0
                    && tensor_map(&ta, pro.in[0], M, K, AM);
  const int b_tma = K > 0 && tensor_map(&tb, rhs, K, N, 64);
  auto kernel = mm_bf16_kernel<BM, BN, ST, WN, AM, Pro, Epi>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const int threads = 128 * (BM / 64 * WN + 1);
  const uint16_t* r = static_cast<const uint16_t*>(rhs);
  if constexpr (Epi::kSlots == 0) {
    const long long blocks = static_cast<long long>(grid.x) * grid.y;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    kernel<<<static_cast<unsigned>(blocks), threads, bytes, stream>>>(
        ta, tb, pro, r, epi, M, K, N, a_tma, b_tma);
    return cudaGetLastError();
  }
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
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
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, ta, tb, pro, r,
                                             epi, M, K, N, a_tma, b_tma);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace repro_mm
