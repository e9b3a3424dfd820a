// Flash attention forward for Hopper (sm_90a) on the tensor cores, head
// dims 64, 80, 128 and 256: the kernel bodies (float32 and bfloat16
// operands), templates on a score functor.
//
// Replaces the TPU kernel `_attn_kernel` / `flash_attention`
// (src/repro/kernels/flash_attention.py:31,87):
//     o = softmax(mask(score_mod(q k^T * scale))) v   q [B, Hq, Sq, D]
//                                                     k, v [B, Hkv, Skv, D]
// flash_attention.cu instantiates it with the identity functor (B4);
// compute-anchored stitching instantiates it with a functor that
// core/codegen_cuda.py generates from the graph's own scale / bias / mask
// chain (the reference's `score_mod`,
// src/repro/kernels/flash_attention.py:44-51).  A functor is
//     float operator()(float s, int b, int h, int qi, int ki) const
// over the scaled score of query row qi and key row ki of (batch b, query
// head h), reading its operands through 4D strides (stride 0 on a dim of
// extent 1).  It is applied where the reference applies it: after
// q k^T * scale, before the padding and causal masks, and only inside
// the valid (Sq, Skv) range, so a folded mask never reads past its
// operand nor resurrects a padded key.
//
// float32 (`flash_fwd_kernel`; the structure of PyTorch's own float32
// attention, CUTLASS's OpMultiplyAddFastF32 on mma.sync).  A block of
// kWarps warps owns one (batch, head, kBQ-row query tile), 16 query rows
// a warp, and loops over K/V tiles of KBK rows that cp.async copies into
// a double-buffered ring.  Both products run on the tensor cores,
// `mma.sync.m16n8k8` TF32 into float32, through the three-way split: x =
// big + small, big = tf32(x), small = tf32(x - big) (cvt.rna.tf32.f32),
// a b ~ big_a big_b + big_a small_b + small_a big_b.  Q is split once
// (into registers at D <= 80, else as it is read from its tile in shared
// memory), K and V as they are read from shared memory.  The tensor
// cores' float32 sum does not round to nearest, so q k^T is summed from
// zero over each 16 of D and added into the scores on the CUDA cores,
// and p v over each K/V tile is added into the output as o alpha + pv
// (the online softmax's rescale): measured on the card
// (kernels/split_float.py), one tensor-core sum over all of D would sit
// at 1.0-1.8 times B4's limit off the plain version.  Masks, functor and
// online softmax run on the score fragment in registers; a row's max is
// reduced over its quad by shuffles, its sum per thread until the end.
// The fragment of p is the A operand of p v without a shuffle: in each
// k8 step the keys are taken in the order (2t, 2t + 1) the score fragment
// holds them, and V's rows are read in the same order.  Dims of D are
// paired the same way for q k^T, so Q and K fragments are 8-byte loads.
// K tiles wholly above the causal diagonal are skipped (each would leave
// (m, l, o) unchanged), and the query tiles with the most keys are
// launched first.
//
// bfloat16 (`flash_fwd_bf16_kernel`; q, k, v and o all bfloat16, T =
// uint16_t, their bits): Hopper's native products, FlashAttention-2's
// structure.  Q, K and V tiles are staged as they are by cp.async, rows
// padded to D + 8 values so that `ldmatrix` reads them without bank
// conflicts.  Q's fragments are loaded once into registers at D <= 128
// (at 256 from its tile in each K/V tile), K's by `ldmatrix`, V's by
// `ldmatrix.trans`.  q k^T is one `mma.sync.m16n8k16` bf16 product a k16
// step, its products exact, summed in float32 over all of D (a bfloat16
// output is far coarser than that sum's rounding).  The score fragments
// of two key tiles are, packed to bf16x2, the A fragment of one k16 step
// of p v, with no shuffle; p is float32, so it is split into hi =
// bf16(p) and lo = bf16(p - hi), two products a step (about 16 bits of
// p, mma_bf16.cuh).  The output is rescaled by alpha and p v summed into
// it on the tensor cores.  Masks, functor, online softmax and the final
// division are as in float32; o is rounded to bfloat16 once, at the
// store.  Query tiles of 16 `kBf16Warps` rows, K/V tiles of `bf16_kbk`
// keys.
#pragma once

#include "chain.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace repro_flash {

constexpr int kBQ = 64;  // query rows of a block: 16 a warp
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Q split once into registers at D <= 80, else read from shared memory
__host__ __device__ constexpr bool qreg(int d) { return d <= 80; }
// K/V rows a tile: 64, or 32 where the Q tile takes shared memory (two
// blocks an SM at D 128)
__host__ __device__ constexpr int kbk(int d) { return qreg(d) ? 64 : 32; }
// Row strides in floats: conflict-free 8-byte fragment loads of Q and K,
// 4-byte loads of V
__host__ __device__ constexpr int kstride(int d) { return d + 8; }
__host__ __device__ constexpr int vstride(int d) { return d + 4; }

// Shared memory of one float32 block of the D instance: the K and V ring
// (two stages) and, at D > 80, the Q tile.  (64: 71,680 bytes; 80:
// 88,064; 128: 103,424; 256: 201,728.)
__host__ __device__ constexpr int smem_bytes(int d) {
  return 4 * (2 * kbk(d) * (kstride(d) + vstride(d))
              + (qreg(d) ? 0 : kBQ * kstride(d)));
}

// bfloat16 instances: warps a block (16 query rows each), K/V rows a
// tile by head dim, the row stride in values of every tile (Q, K, V: 16-byte aligned
// rows an odd number of 16 bytes apart, so the 8 rows an `ldmatrix`
// phase reads fall in distinct banks), and the shared memory of one
// block: the Q tile and the double-buffered K and V tiles.  (64: 46,080
// bytes; 80: 56,320; 128: 52,224; 256: 101,376.)  The tiles were the
// fastest on the card of 4 or 8 warps by 32, 64 or 128 keys at the
// carried shapes.
constexpr int kBf16Warps = 4;
__host__ __device__ constexpr int bf16_kbk(int d) { return d <= 80 ? 64 : 32; }
__host__ __device__ constexpr int bf16_ld(int d) { return d + 8; }
__host__ __device__ constexpr int smem_bytes_bf16(int d) {
  return 2 * bf16_ld(d) * (16 * kBf16Warps + 4 * bf16_kbk(d));
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int Hq, group, Sq, Skv, D;
  float scale;
  int causal;
};

// The identity score functor: B4 without a score chain.
struct NoScoreMod {
  static constexpr bool kIdentity = true;
  __host__ __device__ float operator()(float s, int, int, int, int) const {
    return s;
  }
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

// Copy rows [r0, r0 + ROWS) of a [*, D] operand (row stride `ss`
// elements) into a tile of row stride `ld` with NT threads; rows past
// `rows` are zero-filled.
template <int D, int ROWS, int LD, class T, int NT = kThreads>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long ss, int r0, int rows,
                                          int tid) {
  constexpr int E = 16 / sizeof(T);  // elements a 16-byte chunk
  constexpr int CH = D / E;          // chunks a row
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool in = r0 + r < rows;
    cp_async16(dst + r * LD + E * c,
               src + (in ? static_cast<long long>(r0 + r) * ss : 0) + E * c,
               in);
  }
}

// k8 steps of D a partial sum of q k^T holds
constexpr int kQChunk = 2;

template <int D, class ScoreMod>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(Params p, const ScoreMod mod) {
  constexpr int KBK = kbk(D), KS = kstride(D), VS = vstride(D);
  constexpr bool QREG = qreg(D);
  constexpr int NJ = KBK / 8;  // key columns of 8 a tile
  constexpr int ND = D / 8;    // head-dim columns (and k8 steps) of 8
  static_assert(D % 16 == 0, "head dim: 16-wide partial sums of q k^T");
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                 // [2][KBK][KS]
  float* Vs = Ks + 2 * KBK * KS;    // [2][KBK][VS]
  float* Qs = Vs + 2 * KBK * VS;    // [kBQ][KS] (D > 80)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the query tiles with the most keys first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  const int off = p.Skv - p.Sq;  // causal offset
  int k_end = p.Skv;
  if (p.causal) {
    const int q_last = min(q0 + kBQ, p.Sq) - 1;
    k_end = min(p.Skv, q_last + off + 1);
  }
  const int ntiles = (k_end + KBK - 1) / KBK;

  if constexpr (!QREG)
    load_tile<D, kBQ, KS>(Qs, qg, p.q_ss, q0, p.Sq, tid);
  load_tile<D, KBK, KS>(Ks, kg, p.k_ss, 0, p.Skv, tid);
  load_tile<D, KBK, VS>(Vs, vg, p.v_ss, 0, p.Skv, tid);
  cp_async_commit();

  // rows of this thread: r0 = q0 + 16 warp + g and r0 + 8
  const int qr0 = q0 + 16 * warp + g, qr1 = qr0 + 8;
  uint32_t qb[QREG ? ND : 1][4], qs[QREG ? ND : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      const int d = 8 * kk + 2 * t;
      float2 x0 = make_float2(0.f, 0.f), x1 = x0;
      if (qr0 < p.Sq)
        x0 = *reinterpret_cast<const float2*>(qg + qr0 * p.q_ss + d);
      if (qr1 < p.Sq)
        x1 = *reinterpret_cast<const float2*>(qg + qr1 * p.q_ss + d);
      split_tf32(x0.x, qb[kk][0], qs[kk][0]);
      split_tf32(x1.x, qb[kk][1], qs[kk][1]);
      split_tf32(x0.y, qb[kk][2], qs[kk][2]);
      split_tf32(x1.y, qb[kk][3], qs[kk][3]);
    }
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * KBK, buf = it & 1;
    if (it + 1 < ntiles) {
      load_tile<D, KBK, KS>(Ks + (buf ^ 1) * KBK * KS, kg, p.k_ss, k0 + KBK,
                            p.Skv, tid);
      load_tile<D, KBK, VS>(Vs + (buf ^ 1) * KBK * VS, vg, p.v_ss, k0 + KBK,
                            p.Skv, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + buf * KBK * KS;
    const float* Vt = Vs + buf * KBK * VS;

    // ---- s = q k^T: a partial sum from zero each 16 of D, then added ---
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < ND; kc += kQChunk) {
      float part[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[j][i] = 0.f;
#pragma unroll
      for (int kk = kc; kk < kc + kQChunk && kk < ND; ++kk) {
        uint32_t ab[4], as[4];
        if constexpr (QREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ab[i] = qb[kk][i];
            as[i] = qs[kk][i];
          }
        } else {
          const int d = 8 * kk + 2 * t;
          const float2 x0 = *reinterpret_cast<const float2*>(
              Qs + (16 * warp + g) * KS + d);
          const float2 x1 = *reinterpret_cast<const float2*>(
              Qs + (16 * warp + g + 8) * KS + d);
          split_tf32(x0.x, ab[0], as[0]);
          split_tf32(x1.x, ab[1], as[1]);
          split_tf32(x0.y, ab[2], as[2]);
          split_tf32(x1.y, ab[3], as[3]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 kv = *reinterpret_cast<const float2*>(
              Kt + (8 * j + g) * KS + 8 * kk + 2 * t);
          uint32_t bb0, bs0, bb1, bs1;
          split_tf32(kv.x, bb0, bs0);
          split_tf32(kv.y, bb1, bs1);
          mma3(part[j], ab, as, bb0, bb1, bs0, bs1);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] += part[j][i];
    }

    // ---- scale, functor, masks, online softmax on the fragment ---------
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = (i < 2) ? qr0 : qr1;
        const int kj = k0 + 8 * j + 2 * t + (i & 1);
        const bool ok = kj < p.Skv && (!p.causal || qi + off >= kj);
        float sv = s[j][i] * p.scale;
        if constexpr (!ScoreMod::kIdentity) {
          if (kj < p.Skv && qi < p.Sq) sv = mod(sv, b, h, qi, kj);
        }
        s[j][i] = ok ? sv : kNegInf;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
    // p, split: the A operand of p v (keys 2t and 2t + 1 of each 8)
    uint32_t pb[NJ][4], ps[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        e[i] = expf(s[j][i] - m_run[i >> 1]);
        l_run[i >> 1] += e[i];
      }
      split_tf32(e[0], pb[j][0], ps[j][0]);
      split_tf32(e[2], pb[j][1], ps[j][1]);
      split_tf32(e[1], pb[j][2], ps[j][2]);
      split_tf32(e[3], pb[j][3], ps[j][3]);
    }

    // ---- o = o alpha + p v: each 8 columns of D summed over the tile ---
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* vr = Vt + (8 * j + 2 * t) * VS + 8 * n + g;
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(vr[0], bb0, bs0);
        split_tf32(vr[VS], bb1, bs1);
        mma3(pv, pb[j], ps[j], bb0, bb1, bs0, bs1);
      }
      o[n][0] = fmaf(o[n][0], alpha[0], pv[0]);
      o[n][1] = fmaf(o[n][1], alpha[0], pv[1]);
      o[n][2] = fmaf(o[n][2], alpha[1], pv[2]);
      o[n][3] = fmaf(o[n][3], alpha[1], pv[3]);
    }
    __syncthreads();  // this buffer's readers are done before its refill
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv0 = 1.f / fmaxf(l_run[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l_run[1], 1e-30f);
  float* ob = static_cast<float*>(p.o)
              + (static_cast<long long>(b) * p.Hq + h) * p.Sq * p.D;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = 8 * n + 2 * t;
    if (qr0 < p.Sq)
      *reinterpret_cast<float2*>(ob + static_cast<long long>(qr0) * p.D + d)
          = make_float2(o[n][0] * inv0, o[n][1] * inv0);
    if (qr1 < p.Sq)
      *reinterpret_cast<float2*>(ob + static_cast<long long>(qr1) * p.D + d)
          = make_float2(o[n][2] * inv1, o[n][3] * inv1);
  }
}

// The bfloat16 kernel: W warps, a 16 W-row query tile, K/V tiles of KBK
// keys (the design is at the top of this file).
template <int D, class ScoreMod>
__global__ void __launch_bounds__(32 * kBf16Warps)
    flash_fwd_bf16_kernel(Params p, const ScoreMod mod) {
  using T = uint16_t;
  constexpr int W = kBf16Warps, KBK = bf16_kbk(D);
  constexpr int NT = 32 * W, BQ = 16 * W, LD = bf16_ld(D);
  constexpr bool QREG = D <= 128;  // Q's fragments held in registers
  constexpr int NJ = KBK / 8;      // key tiles of 8
  constexpr int ND = D / 8;        // output tiles of 8
  constexpr int KD = D / 16;       // k16 steps of q k^T
  static_assert(D % 16 == 0 && KBK % 16 == 0, "k16 steps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* Ks = Qs + BQ * LD;                    // [2][KBK][LD]
  T* Vs = Ks + 2 * KBK * LD;               // [2][KBK][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the query tiles with the most keys first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  const int off = p.Skv - p.Sq;  // causal offset
  int k_end = p.Skv;
  if (p.causal) {
    const int q_last = min(q0 + BQ, p.Sq) - 1;
    k_end = min(p.Skv, q_last + off + 1);
  }
  const int ntiles = (k_end + KBK - 1) / KBK;

  load_tile<D, BQ, LD, T, NT>(Qs, qg, p.q_ss, q0, p.Sq, tid);
  load_tile<D, KBK, LD, T, NT>(Ks, kg, p.k_ss, 0, p.Skv, tid);
  load_tile<D, KBK, LD, T, NT>(Vs, vg, p.v_ss, 0, p.Skv, tid);
  cp_async_commit();

  // rows of this thread: r0 = q0 + 16 warp + g and r0 + 8
  const int qr0 = q0 + 16 * warp + g, qr1 = qr0 + 8;
  // Q's rows of this warp, the address of this lane's `ldmatrix` row
  const T* qa = Qs + (16 * warp + (lane & 15)) * LD + (lane >> 4) * 8;
  uint32_t qf[QREG ? KD : 1][4];

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * KBK, buf = it & 1;
    if (it + 1 < ntiles) {
      load_tile<D, KBK, LD, T, NT>(Ks + (buf ^ 1) * KBK * LD, kg, p.k_ss,
                                   k0 + KBK, p.Skv, tid);
      load_tile<D, KBK, LD, T, NT>(Vs + (buf ^ 1) * KBK * LD, vg, p.v_ss,
                                   k0 + KBK, p.Skv, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + buf * KBK * LD;
    const T* Vt = Vs + buf * KBK * LD;
    if constexpr (QREG) {
      if (it == 0)
#pragma unroll
        for (int kd = 0; kd < KD; ++kd)
          repro_bf16::ldsm_x4(qf[kd], qa + 16 * kd);
    }

    // ---- s = q k^T: one bf16 product a k16 step, two key tiles a K load
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kd][i];
      } else {
        repro_bf16::ldsm_x4(a, qa + 16 * kd);
      }
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t bk[4];
        repro_bf16::ldsm_x4(
            bk, Kt + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * LD
                    + 16 * kd + ((lane >> 3) & 1) * 8);
        repro_bf16::mma_bf16(s[2 * jp], a, bk[0], bk[1]);
        repro_bf16::mma_bf16(s[2 * jp + 1], a, bk[2], bk[3]);
      }
    }

    // ---- scale, functor, masks, online softmax on the fragment, the
    // scores in units of log2 e (e^x = 2^(x log2 e): one MUFU.EX2; the
    // float32 rounding it moves is far below the output's bfloat16).  A
    // tile whose every key each row of the block sees takes no mask. ----
    float mx[2] = {kNegInf, kNegInf};
    auto scores = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = (i < 2) ? qr0 : qr1;
          const int kj = k0 + 8 * j + 2 * t + (i & 1);
          float sv = s[j][i] * p.scale;
          if constexpr (!ScoreMod::kIdentity) {
            if (kj < p.Skv && qi < p.Sq) sv = mod(sv, b, h, qi, kj);
          }
          if constexpr (decltype(masked)::value) {
            if (!(kj < p.Skv && (!p.causal || qi + off >= kj))) sv = kNegInf;
          }
          s[j][i] = sv * kLog2e;
          mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
        }
    };
    if (k0 + KBK <= p.Skv && (!p.causal || q0 + off >= k0 + KBK - 1))
      scores(std::false_type{});
    else
      scores(std::true_type{});
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = exp2f(s[j][i] - m_run[i >> 1]);
        l_run[i >> 1] += s[j][i];
      }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // ---- o += p v: p's fragments of key tiles 2kk, 2kk + 1 are the A
    // fragment of k16 step kk, split into hi and lo; V by ldmatrix.trans,
    // two output tiles a load -------------------------------------------
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      uint32_t ah[4], al[4];
      repro_bf16::split_bf16(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
      repro_bf16::split_bf16(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
      repro_bf16::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2],
                             al[2]);
      repro_bf16::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3],
                             al[3]);
      const T* vr =
          Vt + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
          + (lane >> 4) * 8;
      // VC pairs of output tiles at a time: their V fragments loaded once,
      // lo over the pairs, then hi, so that no two products run back to
      // back on one accumulator
      constexpr int VC = (ND / 2) % 4 == 0 ? 4 : ND / 2;
#pragma unroll
      for (int n0 = 0; n0 < ND / 2; n0 += VC) {
        uint32_t bv[VC][4];
#pragma unroll
        for (int c = 0; c < VC; ++c)
          repro_bf16::ldsm_x4_t(bv[c], vr + 16 * (n0 + c));
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int c = 0; c < VC; ++c) {
            const int np = n0 + c;
            repro_bf16::mma_bf16(o[2 * np], half ? ah : al, bv[c][0],
                                 bv[c][1]);
            repro_bf16::mma_bf16(o[2 * np + 1], half ? ah : al, bv[c][2],
                                 bv[c][3]);
          }
      }
    }
    __syncthreads();  // this buffer's readers are done before its refill
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv0 = 1.f / fmaxf(l_run[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l_run[1], 1e-30f);
  T* ob = static_cast<T*>(p.o)
          + (static_cast<long long>(b) * p.Hq + h) * p.Sq * p.D;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = 8 * n + 2 * t;
    if (qr0 < p.Sq)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(qr0) * p.D
                                   + d) =
          repro_bf16::pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (qr1 < p.Sq)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(qr1) * p.D
                                   + d) =
          repro_bf16::pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int D, class T, class ScoreMod>
cudaError_t launch(const Params& p, const ScoreMod& mod, int B,
                   cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    constexpr int bytes = smem_bytes_bf16(D), BQ = 16 * kBf16Warps;
    static_assert(bytes <= 232448, "shared memory of one block");
    auto kernel = flash_fwd_bf16_kernel<D, ScoreMod>;
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, B);
    kernel<<<grid, 32 * kBf16Warps, bytes, stream>>>(p, mod);
    return cudaGetLastError();
  } else {
    constexpr int bytes = smem_bytes(D);
    // allow this kernel more than 48 KB of shared memory on the current
    // device; the attribute is per device, so it is set on every launch
    const cudaError_t attr = cudaFuncSetAttribute(
        flash_fwd_kernel<D, ScoreMod>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.Hq, B);
    flash_fwd_kernel<D, ScoreMod><<<grid, kThreads, bytes, stream>>>(p, mod);
    return cudaGetLastError();
  }
}

// Launch the instance of head dim p.D: 64, 80, 128 or 256, exactly (the
// wrapper, kernels/flash_attention.py, pads any other D up to one), with
// operands of type T (float, or uint16_t for bfloat16).
template <class T, class ScoreMod>
int run(const Params& p, const ScoreMod& mod, int B, cudaStream_t s) {
  cudaError_t err;
  if (B == 0 || p.Sq == 0) {
    err = cudaSuccess;
  } else if (p.D == 64) {
    err = launch<64, T>(p, mod, B, s);
  } else if (p.D == 80) {
    err = launch<80, T>(p, mod, B, s);
  } else if (p.D == 128) {
    err = launch<128, T>(p, mod, B, s);
  } else if (p.D == 256) {
    err = launch<256, T>(p, mod, B, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_flash

#endif  // __CUDACC__
