// Flash attention forward for Hopper (sm_90a) on the tensor cores, head
// dims above 256, beside the instances of flash_attention.cuh (D 64, 80,
// 128, 256), which it leaves alone: the kernel body, a template on the
// operands' type (float32 or bfloat16) and a score functor.
// flash_attention_wide.cu instantiates it with the identity functor;
// core/codegen_cuda.py generates one instance a stitched score chain
// (the reference's `score_mod`, src/repro/kernels/flash_attention.py:44-51,
// which it takes at any D).
//
// Replaces the TPU kernel `_attn_kernel` / `flash_attention`
// (src/repro/kernels/flash_attention.py:31,87; `pallas_call` at :135) at
// the head dims the tuned instances do not take -- the reference's kernel
// has no ceiling on D:
//     o = softmax(mask(score_mod(q k^T * scale))) v   q [B, Hq, Sq, D]
//                                                     k, v [B, Hkv, Skv, D]
// with grouped-query heads (kv head = h / (Hq / Hkv), K/V never
// repeated), the causal offset q_idx + (Skv - Sq) >= k_idx, keys past Skv
// masked, and the final division by max(l, 1e-30).
//
// Bound: operations.  At B 4, H 16, S 512, D 320, causal the two products
// are 10.8 GFLOP against 84 MB moved: 0.065 ms at the split's 165
// TFLOP/s, 0.025 ms of bytes.
//
// Design.  Both products run on the tensor cores (`mma.sync.m16n8k8`,
// TF32 into float32) through the three-way split of float32 values that
// B4 uses (mma_tf32.cuh: x = big + small, a b ~ big_a big_b + big_a
// small_b + small_a big_b), q k^T summed from zero over each 16 of D and
// added into the scores on the CUDA cores, p v summed over each K/V tile
// and added into the output as o alpha + pv (B4's limits, measured by
// kernels/split_float.py).  A block of 8 warps owns one (batch, head,
// kBQ = 64-row query tile) and, above kDT = 512 columns, one kDT-column
// tile of the output (a grid axis).  The warps form kRows = 4 row groups
// of 16 query rows by kCols = 2: in q k^T the two warps of a row group
// take one half each of the kBK = 64 keys of a tile, so the scores are
// computed once for every output column; the row's max is exchanged
// through shared memory, p is written there, and in p v the two warps
// take one half each of every 64 output columns, all keys.  A thread so
// holds a quarter of a 64-row tile's output at most: 128 floats at D 512.
//
// Q is read from device memory once: the block's Q tile sits in shared
// memory at D <= 512 (its row padded to D + 8 floats).  K and V arrive in
// chunks of kBK rows by kDC = 64 columns through a ring of kStages
// shared-memory stages filled by cp.async, kStages - 1 chunks ahead of
// the one computed: a K/V tile is the D / kDC chunks of K (each a step of
// q k^T), then the output tile's chunks of V (each a step of p v), so the
// copies of one tile overlap the products of the tile before.  Above
// kDT the Q tile does not fit beside the ring; there each K chunk's stage
// also holds the matching columns of the Q tile (read again per K tile,
// from L2), and the scores are computed once per output tile.  Rows of
// a chunk are padded to kLD = 72 floats, so the 8-byte K fragment loads
// and the 4-byte V fragment loads are free of bank conflicts, and p's
// rows to kPS = 68, so its 4-byte A fragment loads are.  Keys past Skv
// and above the causal diagonal get probability 0; K/V tiles wholly
// above the diagonal are not read, and the query tiles with the most
// keys are launched first.
//
// The score functor runs on each scaled score of the fragment, at its
// (b, h, q_idx, k_idx), before the causal mask and the mask of keys past
// Skv, as in the reference; above kDT it runs once an output tile, on
// the scores that tile computes.
//
// Instances: D up to 320, 384, 448 and 512 with the Q tile resident, and
// above 512 the 512-column output tiles with Q staged beside K.  A D
// below its instance is read in place: the copies zero-fill the columns
// at and past D (zeros add nothing to q k^T), o is stored only below D,
// and the steps of V chunks wholly past D are not taken.
//
// bfloat16 operands (T = uint16_t, the bits; q, k, v and o all of it;
// `flash_wide_bf16_kernel`) keep this structure with Hopper's native
// products (mma_bf16.cuh): the Q tile and the K/V chunks are staged as
// they are, 8 values a 16-byte copy (half the bytes), fragments come by
// `ldmatrix` (`.trans` for V), q k^T is one `mma.sync.m16n8k16` bf16
// product a k16 step (exact products, a float32 sum over all of D: a
// bfloat16 result is far coarser than that sum's rounding), and p, which
// is float32, is written to shared memory as two bfloat16 planes, hi =
// bf16(p) and lo = bf16(p - hi), so p v is two products a k16 step.  The
// scores, the online softmax and the output's division stay float32; o
// rounds to bfloat16 once, at the store.  (Shared memory, bfloat16: 320:
// 89,088 bytes; 384: 97,280; 448: 105,472; 512: 113,664; above 512:
// 74,752.)
//
// `run` returns the first CUDA error of the launch.  q, k, v are taken
// with their element strides (the last dimension contiguous, every other
// stride and the base 16-byte aligned); D is any multiple of 4 (8 in
// bfloat16; the wrapper zero-pads another D up to one); o is a contiguous
// [B, Hq, Sq, D].
#pragma once

#include "chain.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace repro_flash_wide {

// the functor of attention without a score chain
struct NoScoreMod {
  static constexpr bool kIdentity = true;
  __host__ __device__ float operator()(float s, int, int, int, int) const {
    return s;
  }
};

constexpr int kRows = 4;                // row groups of 16 query rows
constexpr int kCols = 2;                // warps a row group
constexpr int kWarps = kRows * kCols;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kRows;         // query rows a block
constexpr int kBK = 64;                 // keys a K/V tile
constexpr int kDC = 64;                 // head-dim columns a staged chunk
constexpr int kDT = 512;                // output columns a block, at most
constexpr int kStages = 3;              // chunks of the ring
constexpr int kLD = kDC + 8;            // row stride of a staged chunk
constexpr int kPS = kBK + 4;            // row stride of p
constexpr float kNegInf = -1e30f;

// Shared memory of one block, in floats: the Q tile (at D <= kDT), the
// ring (a stage: a K or V chunk, and above kDT a Q chunk beside it), p,
// and the exchange of the rows' max and sum.  (320: 157,696 bytes; 384:
// 174,080; 448: 190,464; 512: 206,848; above 512: 129,024.)
__host__ __device__ constexpr int smem_floats(int dt, bool qres) {
  return (qres ? kBQ * (dt + 8) : 0)
         + kStages * (kBK + (qres ? 0 : kBQ)) * kLD + kBQ * kPS
         + 2 * kCols * kBQ;
}
// ... of a bfloat16 block, in bytes: the Q tile and the ring in bfloat16
// (the same row strides in values), p's two bfloat16 planes (rows of kLD
// values: conflict-free `ldmatrix`), the float32 exchange.
__host__ __device__ constexpr int smem_bytes_bf16(int dt, bool qres) {
  return 2 * ((qres ? kBQ * (dt + 8) : 0)
              + kStages * (kBK + (qres ? 0 : kBQ)) * kLD + 2 * kBQ * kLD)
         + 4 * 2 * kCols * kBQ;
}

template <class T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int Hq, group, Sq, Skv, D;
  float scale;
  int causal;
};

using repro_tf32::mma3;
using repro_tf32::split_tf32;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Copy rows [r0, r0 + ROWS) and columns [c0, c0 + COLS) of a row-major
// operand (row stride `ss` values, `cols` columns) into a tile of row
// stride `ld`; rows at or past `rows` and columns at or past `cols` are
// zero-filled.
template <int ROWS, int COLS, class T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          long long ss, int r0, int rows,
                                          int c0, int cols, int tid) {
  constexpr int E = 16 / sizeof(T);  // values a 16-byte piece
  constexpr int CH = COLS / E;       // 16-byte pieces a row
  for (int i = tid; i < ROWS * CH; i += kThreads) {
    const int r = i / CH, c = E * (i % CH);
    const bool in = r0 + r < rows && c0 + c < cols;
    cp_async16(dst + r * ld + c,
               src + (in ? static_cast<long long>(r0 + r) * ss + c0 + c : 0),
               in);
  }
}

// The kernel body on operands of type T: float (the TF32 split) or
// uint16_t (bfloat16 bits, native products).
template <int DT, bool QRES, class T, class ScoreMod>
__device__ __forceinline__ void wide_body(const Params<T>& p,
                                          const ScoreMod& mod) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int NCV = DT / kDC;          // V chunks (output chunks) a tile
  constexpr int NJ = kBK / kCols / 8;    // key columns of 8 a warp scores
  constexpr int NN = kDC / kCols / 8;    // output columns of 8 a chunk
  constexpr int QLD = QRES ? DT + 8 : kLD;
  constexpr int STAGE = (kBK + (QRES ? 0 : kBQ)) * kLD;
  static_assert(DT % kDC == 0 && kBK % (8 * kCols) == 0, "tiles");
  static_assert(NJ % 2 == 0 && NN % 2 == 0, "ldmatrix pairs of n8 tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);             // [kBQ][QLD] (QRES)
  T* ring = Qs + (QRES ? kBQ * QLD : 0);              // [kStages][STAGE]
  // p: [kBQ][kPS] floats, or in bfloat16 two planes (hi, lo) [kBQ][kLD]
  T* Pb = ring + kStages * STAGE;
  float* Ps = reinterpret_cast<float*>(Pb);
  float* red_m = BF ? reinterpret_cast<float*>(Pb + 2 * kBQ * kLD)
                    : Ps + kBQ * kPS;                 // [kCols][kBQ]
  float* red_l = red_m + kCols * kBQ;                 // [kCols][kBQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % kRows, cg = warp / kRows;
  const int dtiles = (p.D + DT - 1) / DT;  // 1 where Q is resident
  const int qtiles = gridDim.x / dtiles;
  // the query tiles with the most keys first
  const int q0 = (qtiles - 1 - static_cast<int>(blockIdx.x) / dtiles) * kBQ;
  const int c0 = static_cast<int>(blockIdx.x) % dtiles * DT;
  // V chunks (output chunks) of this block's columns [c0, c0 + DT) ∩ D
  const int ncv = (min(DT, p.D - c0) + kDC - 1) / kDC;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const T* qg = p.q + b * p.q_sb + h * p.q_sh;
  const T* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const T* vg = p.v + b * p.v_sb + hk * p.v_sh;

  const int off = p.Skv - p.Sq;  // causal offset
  int k_end = p.Skv;
  if (p.causal) k_end = min(p.Skv, min(q0 + kBQ, p.Sq) - 1 + off + 1);
  const int ntiles = (k_end + kBK - 1) / kBK;
  const int ncq = (p.D + kDC - 1) / kDC;  // K chunks (q k^T steps) a tile
  const int nsteps = ncq + ncv;           // ring steps a tile
  const int total = ntiles * nsteps;

  // step s of the ring: K chunk w (and Q's, above kDT) or V chunk w - ncq
  // of tile s / nsteps; one commit group a step, empty past the end
  auto fetch = [&](int s) {
    if (s < total) {
      const int i = s / nsteps, w = s % nsteps;
      T* st = ring + (s % kStages) * STAGE;
      if (w < ncq) {
        load_tile<kBK, kDC>(st, kLD, kg, p.k_ss, i * kBK, p.Skv, w * kDC,
                            p.D, tid);
        if constexpr (!QRES)
          load_tile<kBQ, kDC>(st + kBK * kLD, kLD, qg, p.q_ss, q0, p.Sq,
                              w * kDC, p.D, tid);
      } else {
        load_tile<kBK, kDC>(st, kLD, vg, p.v_ss, i * kBK, p.Skv,
                            c0 + (w - ncq) * kDC, p.D, tid);
      }
    }
    cp_async_commit();
  };
  // wait for step s's chunk; then every warp is done with step s - 1, so
  // its stage takes step s + kStages - 1
  auto step = [&](int s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    fetch(s + kStages - 1);
  };

  if constexpr (QRES)  // with the first step's group
    load_tile<kBQ, DT>(Qs, QLD, qg, p.q_ss, q0, p.Sq, 0, p.D, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  const int r0 = 16 * rg + g;  // this thread's rows: r0 and r0 + 8
  float o[NCV][NN][4];
#pragma unroll
  for (int c = 0; c < NCV; ++c)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[c][n][i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  int s = 0;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBK;
    // ---- s = q k^T over the warp's NJ x 8 keys, all of D --------------
    float sc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = 0.f;
    for (int w = 0; w < ncq; ++w, ++s) {
      step(s);
      const T* Kt = ring + (s % kStages) * STAGE;
      const T* Qt = QRES ? Qs + w * kDC : Kt + kBK * kLD;
      if constexpr (BF) {
        // one bf16 product a k16 step: Q rows 16 rg.. by `ldmatrix`, K
        // rows of two key tiles a `ldmatrix.x4`
#pragma unroll
        for (int kk = 0; kk < kDC / 16; ++kk) {
          uint32_t a[4];
          repro_bf16::ldsm_x4(
              a, Qt + (16 * rg + (lane & 15)) * QLD + 16 * kk
                     + (lane >> 4) * 8);
#pragma unroll
          for (int jp = 0; jp < NJ / 2; ++jp) {
            uint32_t bk[4];
            repro_bf16::ldsm_x4(
                bk, Kt + (cg * NJ * 8 + 16 * jp + (lane & 7)
                          + ((lane >> 4) << 3)) * kLD
                        + 16 * kk + ((lane >> 3) & 1) * 8);
            repro_bf16::mma_bf16(sc[2 * jp], a, bk[0], bk[1]);
            repro_bf16::mma_bf16(sc[2 * jp + 1], a, bk[2], bk[3]);
          }
        }
      } else {
#pragma unroll
        for (int kc = 0; kc < kDC / 8; kc += 2) {  // a partial sum each 16
          float part[NJ][4];
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) part[j][i] = 0.f;
#pragma unroll
          for (int kk = kc; kk < kc + 2; ++kk) {
            const int d = 8 * kk + 2 * t;
            const float2 x0 =
                *reinterpret_cast<const float2*>(Qt + r0 * QLD + d);
            const float2 x1 =
                *reinterpret_cast<const float2*>(Qt + (r0 + 8) * QLD + d);
            uint32_t ab[4], as[4];
            split_tf32(x0.x, ab[0], as[0]);
            split_tf32(x1.x, ab[1], as[1]);
            split_tf32(x0.y, ab[2], as[2]);
            split_tf32(x1.y, ab[3], as[3]);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              const float2 kv = *reinterpret_cast<const float2*>(
                  Kt + (cg * NJ * 8 + 8 * j + g) * kLD + d);
              uint32_t bb0, bs0, bb1, bs1;
              split_tf32(kv.x, bb0, bs0);
              split_tf32(kv.y, bb1, bs1);
              mma3(part[j], ab, as, bb0, bb1, bs0, bs1);
            }
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) sc[j][i] += part[j][i];
        }
      }
    }

    // ---- scale, score_mod, masks; the rows' max over both warps of the
    // row group --------------------------------------------------------
    float mx[2] = {kNegInf, kNegInf};
    bool ok[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + r0 + 8 * (i >> 1);
        const int kj = k0 + cg * NJ * 8 + 8 * j + 2 * t + (i & 1);
        ok[j][i] = kj < p.Skv && (!p.causal || qi + off >= kj);
        float sv = sc[j][i] * p.scale;
        if constexpr (!ScoreMod::kIdentity) {
          if (kj < p.Skv && qi < p.Sq) sv = mod(sv, b, h, qi, kj);
        }
        sc[j][i] = ok[j][i] ? sv : kNegInf;
        mx[i >> 1] = fmaxf(mx[i >> 1], sc[j][i]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    if (t == 0) {
      red_m[cg * kBQ + r0] = mx[0];
      red_m[cg * kBQ + r0 + 8] = mx[1];
    }
    __syncthreads();
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m_tile = red_m[r0 + 8 * r];
#pragma unroll
      for (int c = 1; c < kCols; ++c)
        m_tile = fmaxf(m_tile, red_m[c * kBQ + r0 + 8 * r]);
      const float m_new = fmaxf(m_run[r], m_tile);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
    // p into shared memory (read by the next step, after its barrier)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        e[i] = ok[j][i] ? expf(sc[j][i] - m_run[i >> 1]) : 0.f;
        l_run[i >> 1] += e[i];
      }
      const int col = cg * NJ * 8 + 8 * j + 2 * t;
      if constexpr (BF) {
        uint32_t hi, lo;
        repro_bf16::split_bf16(e[0], e[1], hi, lo);
        *reinterpret_cast<uint32_t*>(Pb + r0 * kLD + col) = hi;
        *reinterpret_cast<uint32_t*>(Pb + (kBQ + r0) * kLD + col) = lo;
        repro_bf16::split_bf16(e[2], e[3], hi, lo);
        *reinterpret_cast<uint32_t*>(Pb + (r0 + 8) * kLD + col) = hi;
        *reinterpret_cast<uint32_t*>(Pb + (kBQ + r0 + 8) * kLD + col) = lo;
      } else {
        float* pr = Ps + r0 * kPS + col;
        *reinterpret_cast<float2*>(pr) = make_float2(e[0], e[1]);
        *reinterpret_cast<float2*>(pr + 8 * kPS) = make_float2(e[2], e[3]);
      }
    }

    // ---- o = o alpha + p v: the warp's half of each 64 output columns --
#pragma unroll
    for (int c = 0; c < NCV; ++c, ++s) {
      if (c == ncv) break;
      step(s);
      const T* Vt = ring + (s % kStages) * STAGE;
      float pv[NN][4];
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[n][i] = 0.f;
      if constexpr (BF) {
        // two bf16 products a k16 step (p's lo, then hi), V by
        // `ldmatrix.trans`, two output tiles a load
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          uint32_t ah[4], al[4];
          const T* pr = Pb + (16 * rg + (lane & 15)) * kLD + 16 * kk
                        + (lane >> 4) * 8;
          repro_bf16::ldsm_x4(ah, pr);
          repro_bf16::ldsm_x4(al, pr + kBQ * kLD);
          uint32_t bv[NN / 2][4];
#pragma unroll
          for (int np = 0; np < NN / 2; ++np)
            repro_bf16::ldsm_x4_t(
                bv[np], Vt + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8)
                                 * kLD
                            + cg * NN * 8 + 16 * np + (lane >> 4) * 8);
          // lo over the warp's output tiles, then hi: no two products
          // back to back on one accumulator
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int np = 0; np < NN / 2; ++np) {
              repro_bf16::mma_bf16(pv[2 * np], half ? ah : al, bv[np][0],
                                   bv[np][1]);
              repro_bf16::mma_bf16(pv[2 * np + 1], half ? ah : al,
                                   bv[np][2], bv[np][3]);
            }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kBK / 8; ++kk) {
          const float* pr = Ps + r0 * kPS + 8 * kk + t;
          uint32_t ab[4], as[4];
          split_tf32(pr[0], ab[0], as[0]);
          split_tf32(pr[8 * kPS], ab[1], as[1]);
          split_tf32(pr[4], ab[2], as[2]);
          split_tf32(pr[8 * kPS + 4], ab[3], as[3]);
#pragma unroll
          for (int n = 0; n < NN; ++n) {
            const float* vr =
                Vt + (8 * kk + t) * kLD + cg * NN * 8 + 8 * n + g;
            uint32_t bb0, bs0, bb1, bs1;
            split_tf32(vr[0], bb0, bs0);
            split_tf32(vr[4 * kLD], bb1, bs1);
            mma3(pv[n], ab, as, bb0, bb1, bs0, bs1);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        o[c][n][0] = fmaf(o[c][n][0], alpha[0], pv[n][0]);
        o[c][n][1] = fmaf(o[c][n][1], alpha[0], pv[n][1]);
        o[c][n][2] = fmaf(o[c][n][2], alpha[1], pv[n][2]);
        o[c][n][3] = fmaf(o[c][n][3], alpha[1], pv[n][3]);
      }
    }
  }

  // the rows' sums: over the quad, then over both warps of the row group
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  if (t == 0) {
    red_l[cg * kBQ + r0] = l_run[0];
    red_l[cg * kBQ + r0 + 8] = l_run[1];
  }
  __syncthreads();
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) l += red_l[c * kBQ + r0 + 8 * r];
    inv[r] = 1.f / fmaxf(l, 1e-30f);
  }
  T* ob = p.o + (static_cast<long long>(b) * p.Hq + h) * p.Sq * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + 8 * r;
    if (qi >= p.Sq) continue;
    T* orow = ob + static_cast<long long>(qi) * p.D;
#pragma unroll
    for (int c = 0; c < NCV; ++c)
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const int col = c0 + c * kDC + cg * NN * 8 + 8 * n + 2 * t;
        // D is a multiple of 4 (8 in bfloat16): col + 1 < D too
        if (col >= p.D) continue;
        const float a = o[c][n][2 * r] * inv[r];
        const float a1 = o[c][n][2 * r + 1] * inv[r];
        if constexpr (BF)
          *reinterpret_cast<uint32_t*>(orow + col) =
              repro_bf16::pack_bf16(a, a1);
        else
          *reinterpret_cast<float2*>(orow + col) = make_float2(a, a1);
      }
  }
}

template <int DT, bool QRES, class ScoreMod>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wide_kernel(Params<float> p, const ScoreMod mod) {
  wide_body<DT, QRES>(p, mod);
}

template <int DT, bool QRES, class ScoreMod>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wide_bf16_kernel(Params<uint16_t> p, const ScoreMod mod) {
  wide_body<DT, QRES>(p, mod);
}

template <int DT, bool QRES, class T, class ScoreMod>
cudaError_t launch(const Params<T>& p, const ScoreMod& mod, int B,
                   cudaStream_t stream) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int bytes =
      BF ? smem_bytes_bf16(DT, QRES)
         : smem_floats(DT, QRES) * static_cast<int>(sizeof(float));
  static_assert(bytes <= 232448, "shared memory of one block");
  auto kernel = [] {
    if constexpr (BF)
      return flash_wide_bf16_kernel<DT, QRES, ScoreMod>;
    else
      return flash_wide_kernel<DT, QRES, ScoreMod>;
  }();
  // the attribute is per device, so it is set on every launch
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ * ((p.D + DT - 1) / DT), p.Hq, B);
  kernel<<<grid, kThreads, bytes, stream>>>(p, mod);
  return cudaGetLastError();
}

// The instance for D (a multiple of 4, 8 in bfloat16, above 256) on
// operands of type T (float, or uint16_t for bfloat16), launched: 0 or
// the first CUDA error.
template <class T, class ScoreMod>
int run(const Params<T>& p, const ScoreMod& mod, int B, cudaStream_t s) {
  if (B == 0 || p.Sq == 0 || p.Hq == 0) return 0;
  if (p.group < 1 || p.Skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (p.D < 1 || p.D % (16 / static_cast<int>(sizeof(T))))
    err = cudaErrorInvalidValue;
  else if (p.D <= 320)
    err = launch<320, true>(p, mod, B, s);
  else if (p.D <= 384)
    err = launch<384, true>(p, mod, B, s);
  else if (p.D <= 448)
    err = launch<448, true>(p, mod, B, s);
  else if (p.D <= kDT)
    err = launch<512, true>(p, mod, B, s);
  else
    err = launch<kDT, false>(p, mod, B, s);
  return static_cast<int>(err);
}

}  // namespace repro_flash_wide

#endif  // __CUDACC__
