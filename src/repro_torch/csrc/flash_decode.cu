// Flash decode for Hopper (sm_90a), any head dim that is a multiple of 4:
// instances for 64, 128, 256, 384 and 512, each masking its columns at
// the true head dim, and above 512 a tiled kernel.  q (and o) float32 or
// bfloat16, the caches float32 or bfloat16 on their own, float32 inside.
//
// Replaces the TPU kernel `flash_decode` (src/repro/kernels/flash_attention.py:161),
// which runs `_attn_kernel` (:31, `pallas_call` at :135) with one query
// row per block over the live prefix of a KV cache:
//     o[b, h] = softmax(q[b, h] . k[b, h / g, :kv_len]^T * scale)
//               @ v[b, h / g, :kv_len]
// with q [B, Hq, D], caches [B, Hkv, S, D], g = Hq / Hkv grouped query
// heads (K/V never repeated), float32 accumulation, the -1e30 fill and the
// final division by max(l, 1e-30).
//
// Bound: bytes.  A decode step reads the whole live cache once, 2 * kv_len
// * D values a (batch, kv head), and does 4 D operations a key and query
// head: at Llama-3.2-3B's [4, 24/8, 32768, 128] 268 MB in float32 (134 MB
// in bfloat16) against 0.4 GFLOP, 0.32 ms (0.16 ms) at 3.35 TB/s; at
// [1, 8/2, 4000, 320] 20.5 MB, 0.0061 ms.
//
// Types: the cache type is a template parameter of every kernel that
// reads the cache (`TC`, float or bfloat16 bits); q's and o's, read once
// a block and written once a column, are a runtime flag.  A bfloat16
// cache is read 16 bytes a load, 8 values (`RowLayout`: a row takes half
// the lanes of a float32 row of the same D, so a warp has twice the row
// slots), each value widened to float32 exactly; the wrapper pads a
// bfloat16 cache's D to a multiple of 8.  At D 384 and in the tiled
// kernel a bfloat16 load carries 4 values (8 bytes).
//
// The TPU kernel walks the K blocks as a sequential grid axis, one grid
// row per (batch, query head), carrying (m, l, acc) in VMEM.  That would
// give B * Hq blocks (96 at Llama's batch 4) on 132 SMs, and every K/V
// tile read once per query head of its group.  Here the KV axis is split:
//
// 1. `flash_decode_split_kernel`, grid (splits, Hkv, B), 4 warps: a block
//    owns one (batch, kv head) and one range of `rows_per_split` cache
//    rows, and reads each K/V row once for all g query heads that share
//    it.  A warp reads 8 rows at a time (4 at D 256, 2 above) for each of
//    its row slots (D / 4 lanes a row, a float4 each: one slot at D 128,
//    two at D 64; from D 256 up a whole warp a row, D / 128 float4 a
//    lane), keeps an online-softmax state (m, l, the lane's columns of
//    acc) a query head in registers, and the block merges its 4 or 8
//    states in shared memory into one partial (m, l, acc[D]) a query
//    head, written to a float32 workspace.
// 2. `flash_decode_combine_kernel`, grid (Hq, B), D threads: merges the
//    splits' partials by log-sum-exp and divides by max(l, 1e-30).  Above
//    256 `flash_decode_merge_kernel` does it instead, grid (Hq, B, D /
//    128), 4 x 128 threads: each of the four thread rows merges every
//    fourth split of 128 columns in one pass, then the four merge in
//    shared memory: a column's merge walks a quarter of the splits once,
//    where the combine's thread walks all of them twice.
//
// The split count is chosen by the wrapper so that B * Hkv * splits fills
// the SMs several times over.  A launch takes g <= max_group(D) query
// heads a KV head (8 up to 256, where G 8 at D 256 takes 248 registers;
// 4 above, where a lane holds q and acc of each head in 3 or 4 float4);
// the wrapper runs a larger group as sub-groups, one launch
// each, through strided views of q and o (q's and o's strides between KV
// heads and between the heads of a sub-group are separate arguments).  A
// head dim D below its instance's (80 in the 128 instance, 320 in the
// 384) is read in place, by the instance's masked twin (MASK): a lane
// whose float4 lies at or past D holds zeros of q and reads K and V at D
// - 4 (in bounds, so the key loop has no column test; its q . k share is
// 0 and its acc columns are never stored), and o is stored only below D,
// so no operand is copied; the partials keep the instance's width.  At D
// equal to its instance the kernel is compiled without the mask, its
// column offsets constants: a column offset held in a register slowed
// those instances on the H100.  Above 512, `flash_decode_tiled_kernel`
// runs the split pass instead, grid (splits, Hkv x tiles, B): the
// sub-group's q sits in shared memory, a warp scores a row over all of D
// in steps of 128 columns and accumulates one 512-column tile of the
// output (the tiles of a split each read K for the scores, V for their
// own columns).  Rows past kv_len in a split's last tile are not read and
// get probability 0 (not exp(-1e30 - m), which is 1 when a state has
// seen no row yet).  The products run as FMA on the CUDA cores: the
// kernel is bound by bytes, not by operations.
//
// bfloat16 q against bfloat16 caches at D 64, 128 or 256 (Llama's,
// Granite's, Zamba2's and Gemma-7B's heads) take `flash_decode_bf16_kernel`
// instead (FlashDecoding with grouped query heads on the tensor cores).
// Widening a bfloat16 value on the CUDA cores costs as many instructions as
// a float32 value does, for half the bytes, so the split kernel above spends
// twice the issue a byte on such a cache and reaches only about half its
// bound (PERF.md, B8 bfloat16).  The native kernel keeps the values in
// bfloat16 up to the products:
//   * grid (splits, Hkv, B), 4 warps; the wrapper picks the splits so that
//     B Hkv splits fills whole resident waves of this kernel (its own
//     occupancy, `repro_flash_decode_bf16_blocks`);
//   * K and V tiles of kKT = 64 rows go through a ring of shared memory
//     (4 stages at D 64, 3 at 128, 2 at 256) by 16-byte `cp.async` copies
//     that every thread issues, the next tiles in flight while the warps
//     compute; a row's 16-byte chunks are XOR-swizzled by the row's low
//     three bits, so that `ldmatrix` reads eight rows without a bank
//     conflict; rows past the split's end are zero-filled, not read;
//   * a warp takes 16 keys of each tile.  The g <= 8 query heads sit on the
//     n8 side of `mma.sync.m16n8k16` bf16 (float32 accumulator): S^T[16 keys
//     x 8] = K[16 x D] q^T, K by `ldmatrix`; q . k is one product (a product
//     of two bfloat16 values is exact in float32, as the widened FMA was);
//   * the online softmax keeps m and l of the lane's two heads in registers,
//     in units of log2 e (one shuffle reduction of the max across the 16
//     keys, l summed across lanes only at the end); rows past kv_len get
//     probability 0;
//   * p is float32, as in the reference; it is split into bfloat16 hi and
//     lo (`repro_bf16::split_bf16`), moved from the score fragment's layout
//     (key rows) to the B operand's (head columns) by `movmatrix.trans`,
//     and o^T[D x 8] += V^T P^T takes two products, V by `ldmatrix.trans`;
//   * the block's four warp states merge in shared memory (the ring, freed)
//     into the float32 partials that `flash_decode_combine_kernel` merges
//     over the splits, as the split kernel's do (m stored in natural units).
//
// C interface (bound with ctypes): returns the first CUDA error of the two
// launches.  q, k, v are taken with their element strides (the last
// dimension contiguous, every other stride and the base 16-byte aligned:
// the wrapper checks); q head i of KV head j lies at b q_sb + j q_sk + i
// q_sh, and o likewise; part_acc [B, Hkv g, splits, W] (W: D's instance,
// above 512 D rounded up to a multiple of 512) and part_ml [B, Hkv g,
// splits, 2] are contiguous.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "chain.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = uint16_t;  // a bfloat16 value's bits

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 8;  // rows a row slot reads at once
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  float* part_acc;
  float* part_ml;
  void* o;
  long long q_sb, q_sk, q_sh;
  long long o_sb, o_sk, o_sh;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int Hq, G, dlen, kv_len, rows_per_split, splits;  // Hq = Hkv G; dlen = D
  float scale;
  int q_bf16;  // q and o bfloat16, else float32
};

// A row's layout in a warp for cache values of type TC: a 16-byte load
// carries E of them (4 float32, or 8 bfloat16 -- 4 at D 384, which 8 a
// load cannot cut into whole lanes), NU loads a lane, LPR lanes a row,
// RPW row slots a warp, TILE rows a slot reads at once (fewer where a
// lane holds more columns, W = E NU).  From D 256 up (float32) a whole
// warp reads a row; a bfloat16 row of D is read as a float32 row of D /
// 2, its lane holding twice the columns.
template <int D, class TC>
struct RowLayout {
  static constexpr int E =
      sizeof(TC) == 2 && (D <= 256 || D % 256 == 0) ? 8 : 4;
  static constexpr int NU = D > 32 * E ? D / (32 * E) : 1;
  static constexpr int LPR = D / (E * NU);
  static constexpr int RPW = 32 / LPR;
  static constexpr int W = E * NU;   // a lane's columns of a row
  static constexpr int NG = W / 4;   // ... in float4 groups
  static constexpr int TILE = W > 8 ? kTile / 4 : W > 4 ? kTile / 2 : kTile;
  static_assert(LPR * E * NU == D && LPR <= 32 && 32 % LPR == 0,
                "a head dim of 64, 128, 256, 384 or 512");
};

// The most query heads a KV head one launch takes at the instance of head
// dim d (registers: a lane holds q and acc of every head), and above the
// largest instance (d > kMaxD) in the tiled kernel, whose q sits in
// shared memory.
constexpr int kMaxD = 512;   // the largest instance
constexpr int kDT = 512;     // output columns of the tiled kernel's tile
__host__ __device__ constexpr int max_group(int d) {
  return d <= 256 ? 8 : 4;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// E cache values at p (16-byte aligned for 8 bfloat16) as E / 4 float4
template <int E>
__device__ __forceinline__ void ld_unit(const float* p, float4* dst) {
  static_assert(E == 4, "float32: four values a load");
  dst[0] = ld4(p);
}
template <int E>
__device__ __forceinline__ void ld_unit(const bf16* p, float4* dst) {
  if constexpr (E == 4) {
    dst[0] = ld4(p);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    dst[0] = make_float4(__uint_as_float(u.x << 16),
                         __uint_as_float(u.x & 0xffff0000u),
                         __uint_as_float(u.y << 16),
                         __uint_as_float(u.y & 0xffff0000u));
    dst[1] = make_float4(__uint_as_float(u.z << 16),
                         __uint_as_float(u.z & 0xffff0000u),
                         __uint_as_float(u.w << 16),
                         __uint_as_float(u.w & 0xffff0000u));
  }
}

// q's four values at element offset i, and o's value at i, in q's type
__device__ __forceinline__ float4 ldq4(const Params& p, long long i) {
  return p.q_bf16 ? ld4(static_cast<const bf16*>(p.q) + i)
                  : ld4(static_cast<const float*>(p.q) + i);
}
__device__ __forceinline__ float ldq(const Params& p, long long i) {
  return p.q_bf16 ? repro_chain::from_bf16(static_cast<const bf16*>(p.q)[i])
                  : static_cast<const float*>(p.q)[i];
}
__device__ __forceinline__ void sto(const Params& p, long long i, float x) {
  if (p.q_bf16)
    static_cast<bf16*>(p.o)[i] = repro_chain::to_bf16(x);
  else
    static_cast<float*>(p.o)[i] = x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

template <int D, int G, bool MASK, class TC>
__global__ void __launch_bounds__(kThreads) flash_decode_split_kernel(Params p) {
  using RL = RowLayout<D, TC>;
  constexpr int E = RL::E, NU = RL::NU, NG = RL::NG, LPR = RL::LPR;
  constexpr int RPW = RL::RPW, TILE = RL::TILE, Q = E / 4;
  constexpr int NSUB = kWarps * RPW;  // online-softmax states of a block
  constexpr int STEP = kWarps * RPW * TILE;  // rows a block reads at once
  __shared__ float s_m[NSUB][G];
  __shared__ float s_l[NSUB][G];
  __shared__ float s_acc[NSUB][G][D];
  static_assert(sizeof(float) * NSUB * G * (D + 2) <= 48 * 1024,
                "static shared memory of one block");

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = lane / LPR, c = E * (lane % LPR);
  const int row0 = split * p.rows_per_split;
  const int row1 = min(p.kv_len, row0 + p.rows_per_split);

  // lane columns c + E LPR u .. + E of each row, u < NU (float4 group
  // j = Q u + i the 4 from c + E LPR u + 4 i), read at kg + off[u]; with
  // MASK a load at or past the true head dim (a multiple of E) holds
  // zeros of q and reads K and V at dlen - E
  bool col[NU];
  int off[NU];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    col[u] = !MASK || c + E * LPR * u < p.dlen;
    off[u] = MASK ? (col[u] ? c + E * LPR * u : p.dlen - E) : E * LPR * u;
  }
  const int cb = MASK ? 0 : c;
  const TC* kg = static_cast<const TC*>(p.k) + b * p.k_sb + hk * p.k_sh + cb;
  const TC* vg = static_cast<const TC*>(p.v) + b * p.v_sb + hk * p.v_sh + cb;
  const long long qg = b * p.q_sb + hk * p.q_sk + c;
  float4 qv[G][NG], acc[G][NG];
  float m[G], l[G];
#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int u = j / Q, i = j % Q;
      qv[h][j] = col[u] ? ldq4(p, qg + h * p.q_sh + E * LPR * u + 4 * i)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[h][j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    m[h] = kNegInf;
    l[h] = 0.f;
  }

  for (int base = row0 + warp * RPW * TILE; base < row1; base += STEP) {
    float4 kk[TILE][NG], vv[TILE][NG];
    bool in[TILE];
#pragma unroll
    for (int t = 0; t < TILE; ++t) {
      const int r = base + t * RPW + slot;
      in[t] = r < row1;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        if (in[t]) {
          ld_unit<E>(kg + r * p.k_ss + off[u], &kk[t][Q * u]);
          ld_unit<E>(vg + r * p.v_ss + off[u], &vv[t][Q * u]);
        } else {
#pragma unroll
          for (int i = 0; i < Q; ++i)
            kk[t][Q * u + i] = vv[t][Q * u + i] =
                make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float s[TILE];
      float mx = m[h];
#pragma unroll
      for (int t = 0; t < TILE; ++t) {
        float d = dot4(qv[h][0], kk[t][0]);
#pragma unroll
        for (int j = 1; j < NG; ++j) d += dot4(qv[h][j], kk[t][j]);
#pragma unroll
        for (int w = LPR / 2; w > 0; w >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, w);
        s[t] = in[t] ? d * p.scale : kNegInf;
        mx = fmaxf(mx, s[t]);
      }
      const float alpha = expf(m[h] - mx);
      float ps = 0.f;
      float4 pv[NG];
#pragma unroll
      for (int j = 0; j < NG; ++j) pv[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int t = 0; t < TILE; ++t) {
        const float e = in[t] ? expf(s[t] - mx) : 0.f;
        ps += e;
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          pv[j].x = fmaf(e, vv[t][j].x, pv[j].x);
          pv[j].y = fmaf(e, vv[t][j].y, pv[j].y);
          pv[j].z = fmaf(e, vv[t][j].z, pv[j].z);
          pv[j].w = fmaf(e, vv[t][j].w, pv[j].w);
        }
      }
      l[h] = l[h] * alpha + ps;
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        acc[h][j].x = fmaf(acc[h][j].x, alpha, pv[j].x);
        acc[h][j].y = fmaf(acc[h][j].y, alpha, pv[j].y);
        acc[h][j].z = fmaf(acc[h][j].z, alpha, pv[j].z);
        acc[h][j].w = fmaf(acc[h][j].w, alpha, pv[j].w);
      }
      m[h] = mx;
    }
  }

  const int sub = warp * RPW + slot;
#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (lane % LPR == 0) {
      s_m[sub][h] = m[h];
      s_l[sub][h] = l[h];
    }
#pragma unroll
    for (int j = 0; j < NG; ++j)
      *reinterpret_cast<float4*>(
          &s_acc[sub][h][c + E * LPR * (j / Q) + 4 * (j % Q)]) = acc[h][j];
  }
  __syncthreads();

  // merge the block's states: one (query head, column) a thread
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int h = idx / D, d = idx % D;
    float mm = kNegInf;
#pragma unroll
    for (int i = 0; i < NSUB; ++i) mm = fmaxf(mm, s_m[i][h]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int i = 0; i < NSUB; ++i) {
      const float w = expf(s_m[i][h] - mm);
      ll = fmaf(s_l[i][h], w, ll);
      aa = fmaf(s_acc[i][h][d], w, aa);
    }
    const long long row =
        ((long long)b * p.Hq + hk * G + h) * p.splits + split;
    p.part_acc[row * D + d] = aa;
    if (d == 0) {
      p.part_ml[2 * row] = mm;
      p.part_ml[2 * row + 1] = ll;
    }
  }
}

// D above kMaxD: one kDT-column tile of the output a block (a grid axis,
// blockIdx.y = kv head x tiles + tile).  The sub-group's q sits in shared
// memory, zero past D; a warp reads a row: the scores over all of D in
// steps of 128 columns (a float4 a lane), each step's K loads for TILE
// rows in flight together, and V's tile columns (four float4 a lane),
// whose loads start before the scores.  Every tile of a split
// computes the same (m, l); tile 0 writes them.
template <int G, class TC>
__global__ void __launch_bounds__(kThreads) flash_decode_tiled_kernel(
    Params p) {
  constexpr int VPL = kDT / 128, TILE = 2;
  extern __shared__ __align__(16) float sm[];
  const int dq = (p.dlen + 127) / 128 * 128;  // q's staged width
  float* s_q = sm;                  // [G][dq]
  float* s_m = s_q + G * dq;        // [kWarps][G]
  float* s_l = s_m + kWarps * G;    // [kWarps][G]
  float* s_acc = s_l + kWarps * G;  // [kWarps][G][kDT]

  const int tiles = (p.dlen + kDT - 1) / kDT;
  const int split = blockIdx.x, b = blockIdx.z;
  const int hk = blockIdx.y / tiles, tile = blockIdx.y % tiles;
  const int c0 = tile * kDT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = split * p.rows_per_split;
  const int row1 = min(p.kv_len, row0 + p.rows_per_split);
  const TC* kg = static_cast<const TC*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const TC* vg = static_cast<const TC*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const long long qg = b * p.q_sb + hk * p.q_sk;
  for (int i = threadIdx.x; i < G * dq; i += kThreads) {
    const int h = i / dq, d = i % dq;
    s_q[i] = d < p.dlen ? ldq(p, qg + h * p.q_sh + d) : 0.f;
  }
  __syncthreads();

  float4 acc[G][VPL];
  float m[G], l[G];
#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int u = 0; u < VPL; ++u) acc[h][u] = make_float4(0.f, 0.f, 0.f, 0.f);
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  for (int base = row0 + warp * TILE; base < row1;
       base += kWarps * TILE) {
    bool in[TILE];
    float4 vv[TILE][VPL];
#pragma unroll
    for (int t = 0; t < TILE; ++t) {
      const int r = base + t;
      in[t] = r < row1;
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        const int col = c0 + 4 * lane + 128 * u;
        vv[t][u] = in[t] && col < p.dlen ? ld4(vg + r * p.v_ss + col)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    float s[G][TILE];
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int t = 0; t < TILE; ++t) s[h][t] = 0.f;
    for (int ch = 4 * lane; ch < dq; ch += 128) {
      float4 kk[TILE];
#pragma unroll
      for (int t = 0; t < TILE; ++t)
        kk[t] = in[t] && ch < p.dlen ? ld4(kg + (base + t) * p.k_ss + ch)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float4 qv = *reinterpret_cast<const float4*>(s_q + h * dq + ch);
#pragma unroll
        for (int t = 0; t < TILE; ++t) s[h][t] += dot4(qv, kk[t]);
      }
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float mx = m[h];
#pragma unroll
      for (int t = 0; t < TILE; ++t) {
        float d = s[h][t];
#pragma unroll
        for (int w = 16; w > 0; w >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, w);
        s[h][t] = in[t] ? d * p.scale : kNegInf;
        mx = fmaxf(mx, s[h][t]);
      }
      const float alpha = expf(m[h] - mx);
      float ps = 0.f;
      float4 pv[VPL];
#pragma unroll
      for (int u = 0; u < VPL; ++u) pv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int t = 0; t < TILE; ++t) {
        const float e = in[t] ? expf(s[h][t] - mx) : 0.f;
        ps += e;
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          pv[u].x = fmaf(e, vv[t][u].x, pv[u].x);
          pv[u].y = fmaf(e, vv[t][u].y, pv[u].y);
          pv[u].z = fmaf(e, vv[t][u].z, pv[u].z);
          pv[u].w = fmaf(e, vv[t][u].w, pv[u].w);
        }
      }
      l[h] = l[h] * alpha + ps;
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        acc[h][u].x = fmaf(acc[h][u].x, alpha, pv[u].x);
        acc[h][u].y = fmaf(acc[h][u].y, alpha, pv[u].y);
        acc[h][u].z = fmaf(acc[h][u].z, alpha, pv[u].z);
        acc[h][u].w = fmaf(acc[h][u].w, alpha, pv[u].w);
      }
      m[h] = mx;
    }
  }

#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (lane == 0) {
      s_m[warp * G + h] = m[h];
      s_l[warp * G + h] = l[h];
    }
#pragma unroll
    for (int u = 0; u < VPL; ++u)
      *reinterpret_cast<float4*>(
          s_acc + (warp * G + h) * kDT + 4 * lane + 128 * u) = acc[h][u];
  }
  __syncthreads();

  // merge the block's states: one (query head, column) a thread
  const int width = tiles * kDT;  // the partials' row
  for (int idx = threadIdx.x; idx < G * kDT; idx += kThreads) {
    const int h = idx / kDT, d = idx % kDT;
    float mm = kNegInf;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) mm = fmaxf(mm, s_m[i * G + h]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const float w = expf(s_m[i * G + h] - mm);
      ll = fmaf(s_l[i * G + h], w, ll);
      aa = fmaf(s_acc[(i * G + h) * kDT + d], w, aa);
    }
    const long long row =
        ((long long)b * p.Hq + hk * G + h) * p.splits + split;
    p.part_acc[row * width + c0 + d] = aa;
    if (d == 0 && tile == 0) {
      p.part_ml[2 * row] = mm;
      p.part_ml[2 * row + 1] = ll;
    }
  }
}

// Shared memory of the tiled kernel's block at head dim d and g heads.
__host__ __device__ constexpr int tiled_smem_bytes(int d, int g) {
  return 4 * g * ((d + 127) / 128 * 128 + 2 * kWarps + kWarps * kDT);
}

template <int D>
__global__ void __launch_bounds__(D) flash_decode_combine_kernel(Params p) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const long long row = ((long long)b * p.Hq + h) * p.splits;
  const float* ml = p.part_ml + 2 * row;
  const float* acc = p.part_acc + row * D + d;
  float mm = kNegInf;
  for (int i = 0; i < p.splits; ++i) mm = fmaxf(mm, ml[2 * i]);
  float ll = 0.f, aa = 0.f;
  for (int i = 0; i < p.splits; ++i) {
    const float w = expf(ml[2 * i] - mm);
    ll = fmaf(ml[2 * i + 1], w, ll);
    aa = fmaf(acc[(long long)i * D], w, aa);
  }
  if (d < p.dlen)
    sto(p, b * p.o_sb + (h / p.G) * p.o_sk + (h % p.G) * p.o_sh + d,
        aa / fmaxf(ll, 1e-30f));
}

// Above 256: grid (Hq, B, width / kMergeCols), blockDim (kMergeCols,
// kMergeGroups): a thread merges the splits i = y mod kMergeGroups of one
// column in one pass (a running max, sum and accumulator), then the
// groups merge in shared memory and divide by max(l, 1e-30).
constexpr int kMergeCols = 128, kMergeGroups = 4;
__global__ void __launch_bounds__(kMergeCols * kMergeGroups)
    flash_decode_merge_kernel(Params p, int width) {
  __shared__ float s_m[kMergeGroups][kMergeCols];
  __shared__ float s_l[kMergeGroups][kMergeCols];
  __shared__ float s_a[kMergeGroups][kMergeCols];
  const int h = blockIdx.x, b = blockIdx.y;
  const int x = threadIdx.x, y = threadIdx.y;
  const int d = blockIdx.z * kMergeCols + x;
  const long long row = ((long long)b * p.Hq + h) * p.splits;
  const float* ml = p.part_ml + 2 * row;
  const float* acc = p.part_acc + row * width + d;
  float m = kNegInf, l = 0.f, a = 0.f;
#pragma unroll 4
  for (int i = y; i < p.splits; i += kMergeGroups) {
    const float mi = ml[2 * i], li = ml[2 * i + 1];
    const float ai = acc[(long long)i * width];
    const float mn = fmaxf(m, mi);
    const float wo = expf(m - mn), wi = expf(mi - mn);
    l = fmaf(l, wo, li * wi);
    a = fmaf(a, wo, ai * wi);
    m = mn;
  }
  s_m[y][x] = m;
  s_l[y][x] = l;
  s_a[y][x] = a;
  __syncthreads();
  if (y != 0 || d >= p.dlen) return;
  float mm = s_m[0][x];
#pragma unroll
  for (int j = 1; j < kMergeGroups; ++j) mm = fmaxf(mm, s_m[j][x]);
  float ll = 0.f, aa = 0.f;
#pragma unroll
  for (int j = 0; j < kMergeGroups; ++j) {
    const float w = expf(s_m[j][x] - mm);
    ll = fmaf(s_l[j][x], w, ll);
    aa = fmaf(s_a[j][x], w, aa);
  }
  sto(p, b * p.o_sb + (h / p.G) * p.o_sk + (h % p.G) * p.o_sh + d,
      aa / fmaxf(ll, 1e-30f));
}

template <int D, int G, class TC>
cudaError_t launch(const Params& p, int B, int Hkv, cudaStream_t stream) {
  const dim3 grid(p.splits, Hkv, B);
  if (p.dlen == D)
    flash_decode_split_kernel<D, G, false, TC>
        <<<grid, kThreads, 0, stream>>>(p);
  else
    flash_decode_split_kernel<D, G, true, TC>
        <<<grid, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (D > 256)
    flash_decode_merge_kernel<<<dim3(p.Hq, B, D / kMergeCols),
                                dim3(kMergeCols, kMergeGroups), 0, stream>>>(
        p, D);
  else
    flash_decode_combine_kernel<D><<<dim3(p.Hq, B), D, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int G, class TC>
cudaError_t launch_tiled(const Params& p, int B, int Hkv,
                         cudaStream_t stream) {
  const int bytes = tiled_smem_bytes(p.dlen, G);
  if (bytes > 232448) return cudaErrorInvalidValue;
  // the attribute is per device, so it is set on every launch
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_tiled_kernel<G, TC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (p.dlen + kDT - 1) / kDT;
  flash_decode_tiled_kernel<G, TC>
      <<<dim3(p.splits, Hkv * tiles, B), kThreads, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_merge_kernel<<<dim3(p.Hq, B, tiles * kDT / kMergeCols),
                              dim3(kMergeCols, kMergeGroups), 0, stream>>>(
      p, tiles * kDT);
  return cudaGetLastError();
}

// G within the cap of head dim D (kMaxD + 4 stands for the tiled kernel)
template <int D, int G, class TC>
cudaError_t launch_capped(const Params& p, int B, int Hkv, cudaStream_t s) {
  if constexpr (G > max_group(D)) {
    return cudaErrorInvalidValue;
  } else if constexpr (D > kMaxD) {
    return launch_tiled<G, TC>(p, B, Hkv, s);
  } else {
    return launch<D, G, TC>(p, B, Hkv, s);
  }
}

template <int D, class TC>
cudaError_t launch_group(const Params& p, int B, int Hkv, int G,
                         cudaStream_t s) {
  switch (G) {
    case 1: return launch_capped<D, 1, TC>(p, B, Hkv, s);
    case 2: return launch_capped<D, 2, TC>(p, B, Hkv, s);
    case 3: return launch_capped<D, 3, TC>(p, B, Hkv, s);
    case 4: return launch_capped<D, 4, TC>(p, B, Hkv, s);
    case 5: return launch_capped<D, 5, TC>(p, B, Hkv, s);
    case 6: return launch_capped<D, 6, TC>(p, B, Hkv, s);
    case 7: return launch_capped<D, 7, TC>(p, B, Hkv, s);
    case 8: return launch_capped<D, 8, TC>(p, B, Hkv, s);
    default: return cudaErrorInvalidValue;
  }
}

template <class TC>
cudaError_t launch_dim(const Params& p, int B, int Hkv, int G, int D,
                       cudaStream_t s) {
  if (D <= 64) return launch_group<64, TC>(p, B, Hkv, G, s);
  if (D <= 128) return launch_group<128, TC>(p, B, Hkv, G, s);
  if (D <= 256) return launch_group<256, TC>(p, B, Hkv, G, s);
  if (D <= 384) return launch_group<384, TC>(p, B, Hkv, G, s);
  if (D <= kMaxD) return launch_group<512, TC>(p, B, Hkv, G, s);
  return launch_group<kMaxD + 4, TC>(p, B, Hkv, G, s);
}

// ---------------------------------------------------------------------------
// bfloat16 q and caches on the tensor cores (D 64, 128, 256)
// ---------------------------------------------------------------------------
constexpr int kNWarps = 4;              // warps of the native kernel's block
constexpr int kNThreads = 32 * kNWarps;
constexpr int kKT = 16 * kNWarps;       // keys a tile: 16 a warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Stages of the K/V ring at head dim d, and the block's shared memory
__host__ __device__ constexpr int native_stages(int d) {
  return d <= 64 ? 4 : d <= 128 ? 3 : 2;
}
__host__ __device__ constexpr int native_smem_bytes(int d) {
  return native_stages(d) * 2 * kKT * d * 2;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// An 8 x 8 matrix of 16-bit values, transposed across the warp: lane (g, t)
// holds row g, columns 2t and 2t + 1, before and after.
__device__ __forceinline__ uint32_t trans8x8(uint32_t x) {
  uint32_t r;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;"
               : "=r"(r)
               : "r"(x));
  return r;
}

template <int D, int G>
__global__ void __launch_bounds__(kNThreads) flash_decode_bf16_kernel(
    Params p) {
  using repro_bf16::ldsm_x4;
  using repro_bf16::ldsm_x4_t;
  using repro_bf16::mma_bf16;
  constexpr int NST = native_stages(D);
  constexpr int CPR = D / 8;    // 16-byte chunks a row
  constexpr int KS = D / 16;    // k16 steps of q . k, m16 tiles of o^T
  constexpr int CPT = kKT * CPR / kNThreads;  // chunks a thread a tile
  static_assert(CPR >= 8 && kKT * CPR % kNThreads == 0 && G <= 8,
                "D 64, 128 or 256; at most 8 query heads");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [NST][K, V][kKT][D]

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = split * p.rows_per_split;
  const int row1 = min(p.kv_len, row0 + p.rows_per_split);
  const int n_tiles = (row1 - row0 + kKT - 1) / kKT;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // tile `tile`'s K and V rows into stage `stage`: chunk c of row r at
  // chunk c ^ (r & 7); a row past the split's end is zero-filled
  auto load = [&](int tile, int stage) {
    const uint32_t ks = repro_bf16::smem_addr(ring + stage * 2 * kKT * D);
    const uint32_t vs = ks + kKT * D * 2;
    const int base = row0 + tile * kKT;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int i = threadIdx.x + j * kNThreads;
      const int r = i / CPR, c = i % CPR;
      const bool in = base + r < row1;
      const long long row = in ? base + r : row0;
      const uint32_t off = 2 * (r * D + 8 * (c ^ (r & 7)));
      cp_async16(ks + off, kg + row * p.k_ss + 8 * c, in ? 16 : 0);
      cp_async16(vs + off, vg + row * p.v_ss + 8 * c, in ? 16 : 0);
    }
  };

  // q^T as the B operand of the score products: head g (zero past G),
  // columns 16 kk + 2t, + 1 and 16 kk + 2t + 8, + 9
  uint32_t qb[KS][2];
  const bf16* qh = static_cast<const bf16*>(p.q) + b * p.q_sb +
                   hk * p.q_sk + static_cast<long long>(g) * p.q_sh;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    qb[kk][0] = g < G ? *reinterpret_cast<const uint32_t*>(
                            qh + 16 * kk + 2 * t) : 0u;
    qb[kk][1] = g < G ? *reinterpret_cast<const uint32_t*>(
                            qh + 16 * kk + 2 * t + 8) : 0u;
  }

  // o^T fragments: rows d = 16 mt + g (+ 8), columns heads 2t, 2t + 1;
  // m and l of heads 2t and 2t + 1 (m in units of log2 e; l this lane's
  // share until the end)
  float acc[KS][4];
#pragma unroll
  for (int mt = 0; mt < KS; ++mt)
    acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const float sl2 = p.scale * kLog2e;

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < n_tiles) load(s, s);
    cp_async_commit();
  }
  // ldmatrix rows: K's (a row of 16 keys x 16 columns a k-step) and V's
  // (transposed: 16 columns x 16 keys an m-tile)
  const int rk = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int rv = 16 * warp + (lane & 7) + ((lane >> 4) & 1) * 8;
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // the tile landed; the stage refilled next is free
    if (it + NST - 1 < n_tiles) load(it + NST - 1, (it + NST - 1) % NST);
    cp_async_commit();
    const bf16* ks = ring + (it % NST) * 2 * kKT * D;
    const bf16* vs = ks + kKT * D;

    float sc[4] = {0.f, 0.f, 0.f, 0.f};  // S^T: keys g, g + 8 x heads 2t, +1
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      const int c = 2 * kk + (lane >> 4);
      ldsm_x4(a, ks + rk * D + 8 * (c ^ (rk & 7)));
      mma_bf16(sc, a, qb[kk][0], qb[kk][1]);
    }
    const int key = row0 + it * kKT + 16 * warp + g;
    const bool in0 = key < row1, in1 = key + 8 < row1;
    const float s00 = in0 ? sc[0] * sl2 : kNegInf;
    const float s01 = in0 ? sc[1] * sl2 : kNegInf;
    const float s10 = in1 ? sc[2] * sl2 : kNegInf;
    const float s11 = in1 ? sc[3] * sl2 : kNegInf;
    float mx0 = fmaxf(s00, s10), mx1 = fmaxf(s01, s11);
#pragma unroll
    for (int w = 4; w < 32; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    const float p00 = in0 ? exp2f(s00 - mn0) : 0.f;
    const float p01 = in0 ? exp2f(s01 - mn1) : 0.f;
    const float p10 = in1 ? exp2f(s10 - mn0) : 0.f;
    const float p11 = in1 ? exp2f(s11 - mn1) : 0.f;
    l0 = fmaf(l0, al0, p00 + p10);
    l1 = fmaf(l1, al1, p01 + p11);
    m0 = mn0;
    m1 = mn1;
    // P^T as the B operand: the score fragment holds key rows, the
    // operand head columns -- one 8 x 8 transpose a half and a part
    uint32_t h0, lo0, h1, lo1;
    repro_bf16::split_bf16(p00, p01, h0, lo0);
    repro_bf16::split_bf16(p10, p11, h1, lo1);
    const uint32_t bh0 = trans8x8(h0), bh1 = trans8x8(h1);
    const uint32_t bl0 = trans8x8(lo0), bl1 = trans8x8(lo1);
#pragma unroll
    for (int mt = 0; mt < KS; ++mt) {
      acc[mt][0] *= al0;
      acc[mt][1] *= al1;
      acc[mt][2] *= al0;
      acc[mt][3] *= al1;
      uint32_t a[4];
      const int c = 2 * mt + ((lane >> 3) & 1);
      ldsm_x4_t(a, vs + rv * D + 8 * (c ^ (rv & 7)));
      mma_bf16(acc[mt], a, bh0, bh1);
      mma_bf16(acc[mt], a, bl0, bl1);
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' states now
#pragma unroll
  for (int w = 4; w < 32; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  float* s_acc = reinterpret_cast<float*>(smem_raw);  // [kNWarps][8][D]
  float* s_m = s_acc + kNWarps * 8 * D;               // [kNWarps][8]
  float* s_l = s_m + kNWarps * 8;
  if (g == 0) {
    s_m[warp * 8 + 2 * t] = m0;
    s_m[warp * 8 + 2 * t + 1] = m1;
    s_l[warp * 8 + 2 * t] = l0;
    s_l[warp * 8 + 2 * t + 1] = l1;
  }
#pragma unroll
  for (int mt = 0; mt < KS; ++mt) {
    float* a0 = s_acc + (warp * 8 + 2 * t) * D + 16 * mt + g;
    a0[0] = acc[mt][0];
    a0[8] = acc[mt][2];
    a0[D] = acc[mt][1];
    a0[D + 8] = acc[mt][3];
  }
  __syncthreads();

  // merge the block's states: one (query head, column) a thread
  for (int idx = threadIdx.x; idx < G * D; idx += kNThreads) {
    const int h = idx / D, d = idx % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kNWarps; ++w) mm = fmaxf(mm, s_m[w * 8 + h]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kNWarps; ++w) {
      const float wt = exp2f(s_m[w * 8 + h] - mm);
      ll = fmaf(s_l[w * 8 + h], wt, ll);
      aa = fmaf(s_acc[(w * 8 + h) * D + d], wt, aa);
    }
    const long long row =
        ((long long)b * p.Hq + hk * G + h) * p.splits + split;
    p.part_acc[row * D + d] = aa;
    if (d == 0) {
      p.part_ml[2 * row] = mm * kLn2;
      p.part_ml[2 * row + 1] = ll;
    }
  }
}

template <int D, int G>
cudaError_t launch_bf16(const Params& p, int B, int Hkv, cudaStream_t s) {
  constexpr int bytes = native_smem_bytes(D);
  // the attribute is per device, so it is set on every launch
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_bf16_kernel<D, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_decode_bf16_kernel<D, G>
      <<<dim3(p.splits, Hkv, B), kNThreads, bytes, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_combine_kernel<D><<<dim3(p.Hq, B), D, 0, s>>>(p);
  return cudaGetLastError();
}

// Blocks of the native kernel at (D, G) resident on the whole device
template <int D, int G>
cudaError_t resident_bf16(int* blocks) {
  constexpr int bytes = native_smem_bytes(D);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_decode_bf16_kernel<D, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, flash_decode_bf16_kernel<D, G>, kNThreads, bytes);
  *blocks = per_sm * sms;
  return err;
}

// F(D, G) for a head dim of 64, 128 or 256 and 1 <= G <= 8
template <int D, class F>
cudaError_t by_group(int G, F f) {
  switch (G) {
    case 1: return f(std::integral_constant<int, D>{}, std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, D>{}, std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, D>{}, std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, D>{}, std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, D>{}, std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, D>{}, std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, D>{}, std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, D>{}, std::integral_constant<int, 8>{});
    default: return cudaErrorInvalidValue;
  }
}
template <class F>
cudaError_t by_native(int D, int G, F f) {
  if (D == 64) return by_group<64>(G, f);
  if (D == 128) return by_group<128>(G, f);
  if (D == 256) return by_group<256>(G, f);
  return cudaErrorInvalidValue;
}

}  // namespace

// One launch pair of the native bfloat16 kernel (q, o and both caches
// bfloat16; D 64, 128 or 256; G <= 8), the arguments as
// repro_flash_decode's; part_acc at width D.
extern "C" int repro_flash_decode_bf16(
    const void* q, const void* k, const void* v, void* part_acc,
    void* part_ml, void* o, int B, int G, int Hkv, int D, int kv_len,
    int rows_per_split, int splits, long long q_sb, long long q_sk,
    long long q_sh, long long o_sb, long long o_sk, long long o_sh,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, float scale, void* stream) {
  Params p{q, k, v, static_cast<float*>(part_acc),
           static_cast<float*>(part_ml), o,
           q_sb, q_sk, q_sh, o_sb, o_sk, o_sh, k_sb, k_sh, k_ss,
           v_sb, v_sh, v_ss, Hkv * G, G, D, kv_len, rows_per_split, splits,
           scale, 1};
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_native(D, G, [&](auto d, auto g) {
    return launch_bf16<decltype(d)::value, decltype(g)::value>(p, B, Hkv, s);
  }));
}

// The native kernel's resident blocks on the current device at (D, G), in
// *blocks: the wrapper's split target.
extern "C" int repro_flash_decode_bf16_blocks(int D, int G, int* blocks) {
  *blocks = 0;
  return static_cast<int>(by_native(D, G, [&](auto d, auto g) {
    return resident_bf16<decltype(d)::value, decltype(g)::value>(blocks);
  }));
}

// One launch pair for G query heads of each of the Hkv KV heads (at most
// max_group(D)), at head dim D (a multiple of 4); part_acc and part_ml at
// the width of D's instance (64, 128, 256, 384 or 512), or above 512 of
// the tiled kernel's tiles (D rounded up to a multiple of 512).  q and o
// are float32 (q_bf16 0) or bfloat16 (1), the caches float32 (c_bf16 0)
// or bfloat16 (1).
extern "C" int repro_flash_decode(
    const void* q, const void* k, const void* v, void* part_acc,
    void* part_ml, void* o, int B, int G, int Hkv, int D, int kv_len,
    int rows_per_split, int splits, long long q_sb, long long q_sk,
    long long q_sh, long long o_sb, long long o_sk, long long o_sh,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, float scale, int q_bf16, int c_bf16,
    void* stream) {
  Params p{q, k, v, static_cast<float*>(part_acc),
           static_cast<float*>(part_ml), o,
           q_sb, q_sk, q_sh, o_sb, o_sk, o_sh, k_sb, k_sh, k_ss,
           v_sb, v_sh, v_ss, Hkv * G, G, D, kv_len, rows_per_split, splits,
           scale, q_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (B == 0) {
    err = cudaSuccess;
  } else if (D <= 0 || D % 4) {
    err = cudaErrorInvalidValue;
  } else if (c_bf16) {
    err = launch_dim<bf16>(p, B, Hkv, G, D, s);
  } else {
    err = launch_dim<float>(p, B, Hkv, G, D, s);
  }
  return static_cast<int>(err);
}
