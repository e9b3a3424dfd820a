// Flash attention forward for Hopper (sm_90a), float32 on the tensor
// cores, head dims 64, 80, 128 and 256: the kernel body, a template on the
// operands' type (float32 or bfloat16) and a score functor.
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
// Design (the structure of PyTorch's own float32 attention, CUTLASS's
// OpMultiplyAddFastF32 on mma.sync).  A block of kWarps warps owns one
// (batch, head, kBQ-row query tile), 16 query rows a warp, and loops over
// K/V tiles of KBK rows that cp.async copies into a double-buffered ring.
// Both products run on the tensor cores, `mma.sync.m16n8k8` TF32 into
// float32, through the three-way split: x = big + small, big = tf32(x),
// small = tf32(x - big) (cvt.rna.tf32.f32), a b ~ big_a big_b + big_a
// small_b + small_a big_b.  Q is split once (into registers at D <= 80,
// else as it is read from its tile in shared memory), K and V as they
// are read from shared memory.  The tensor cores' float32 sum does not
// round to nearest, so q k^T is summed from zero over each 16 of D and
// added into the scores on the CUDA cores, and p v over each K/V tile is
// added into the output as o alpha + pv (the online softmax's rescale):
// measured on the card (kernels/split_float.py), one tensor-core sum over
// all of D would sit at 1.0-1.8 times B4's limit off the plain version.
// Masks, functor and online softmax run on the score fragment in
// registers; a row's max is reduced over its quad by shuffles, its sum
// per thread until the end.  The fragment of p is the A operand of p v
// without a shuffle: in each k8 step the keys are taken in the order
// (2t, 2t + 1) the score fragment holds them, and V's rows are read in
// the same order.  Dims of D are paired the same way for q k^T, so Q and
// K fragments are 8-byte loads.  K tiles wholly above the causal
// diagonal are skipped (each would leave (m, l, o) unchanged), and the
// query tiles with the most keys are launched first.
//
// bfloat16 operands (T = uint16_t, the bits; q, k, v and o all of it) are
// staged in shared memory as they are, half the bytes, and widened to
// float32 at fragment load.  A bfloat16 value is exact in TF32 (8
// significant bits inside 10), so its split has no small half: q k^T is
// one TF32 product a pair, and p v two (p is float32 and split, V exact).
// Every sum, the online softmax and the output's division are float32;
// o is rounded to bfloat16 once, at the store.
#pragma once

#include "chain.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace repro_flash {

constexpr int kBQ = 64;  // query rows of a block: 16 a warp
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

// Q split once into registers at D <= 80, else read from shared memory
__host__ __device__ constexpr bool qreg(int d) { return d <= 80; }
// K/V rows a tile: 64, or 32 where the Q tile takes shared memory (two
// blocks an SM at D 128)
__host__ __device__ constexpr int kbk(int d) { return qreg(d) ? 64 : 32; }
// Row strides in elements: conflict-free fragment loads of Q and K (8
// bytes in float32, 4 in bfloat16), 4-byte loads of V; a row of a tile
// starts 16 bytes aligned (a bfloat16 V row pads by 8 values)
__host__ __device__ constexpr int kstride(int d) { return d + 8; }
__host__ __device__ constexpr int vstride(int d) { return d + 4; }
__host__ __device__ constexpr int vstride_t(int d, int bytes) {
  return bytes == 4 ? vstride(d) : kstride(d);
}

// Shared memory of one block of the D instance with `bytes`-byte values:
// the K and V ring (two stages) and, at D > 80, the Q tile.  (float32 64:
// 71,680 bytes; 80: 88,064; 128: 103,424; 256: 201,728; bfloat16 64:
// 36,864; 80: 45,056; 128: 53,248; 256: 102,400.)
__host__ __device__ constexpr int smem_bytes(int d, int bytes = 4) {
  return bytes * (2 * kbk(d) * (kstride(d) + vstride_t(d, bytes))
                  + (qreg(d) ? 0 : kBQ * kstride(d)));
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
using repro_tf32::mma_tf32;
using repro_tf32::split_tf32;

// Two consecutive values at p (8-byte aligned in float32, 4-byte in
// bfloat16) and one, as float32; two float32 values stored at p in T.
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const uint16_t* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(*p) << 16);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(uint16_t* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) =
      repro_chain::to_bf16(a)
      | (static_cast<uint32_t>(repro_chain::to_bf16(b)) << 16);
}
// The TF32 halves of a float32 value; a bfloat16 one (EXACT) is its own
// big half and has no small one.
template <bool EXACT>
__device__ __forceinline__ void halves(float x, uint32_t& big,
                                       uint32_t& small) {
  if constexpr (EXACT) {
    big = __float_as_uint(x);
    small = 0u;
  } else {
    split_tf32(x, big, small);
  }
}

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
// elements) into a tile of row stride `ld`; rows past `rows` are
// zero-filled.
template <int D, int ROWS, int LD, class T>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long ss, int r0, int rows,
                                          int tid) {
  constexpr int E = 16 / sizeof(T);  // elements a 16-byte chunk
  constexpr int CH = D / E;          // chunks a row
  for (int i = tid; i < ROWS * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const bool in = r0 + r < rows;
    cp_async16(dst + r * LD + E * c,
               src + (in ? static_cast<long long>(r0 + r) * ss : 0) + E * c,
               in);
  }
}

// k8 steps of D a partial sum of q k^T holds
constexpr int kQChunk = 2;

template <int D, class T, class ScoreMod>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(Params p, const ScoreMod mod) {
  constexpr bool EXACT = sizeof(T) == 2;  // bfloat16: exact in TF32
  constexpr int KBK = kbk(D), KS = kstride(D);
  constexpr int VS = vstride_t(D, sizeof(T));
  constexpr bool QREG = qreg(D);
  constexpr int NJ = KBK / 8;  // key columns of 8 a tile
  constexpr int ND = D / 8;    // head-dim columns (and k8 steps) of 8
  static_assert(D % 16 == 0, "head dim: 16-wide partial sums of q k^T");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [2][KBK][KS]
  T* Vs = Ks + 2 * KBK * KS;               // [2][KBK][VS]
  T* Qs = Vs + 2 * KBK * VS;               // [kBQ][KS] (D > 80)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the query tiles with the most keys first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

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
      if (qr0 < p.Sq) x0 = ld2(qg + qr0 * p.q_ss + d);
      if (qr1 < p.Sq) x1 = ld2(qg + qr1 * p.q_ss + d);
      halves<EXACT>(x0.x, qb[kk][0], qs[kk][0]);
      halves<EXACT>(x1.x, qb[kk][1], qs[kk][1]);
      halves<EXACT>(x0.y, qb[kk][2], qs[kk][2]);
      halves<EXACT>(x1.y, qb[kk][3], qs[kk][3]);
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
    const T* Kt = Ks + buf * KBK * KS;
    const T* Vt = Vs + buf * KBK * VS;

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
          const float2 x0 = ld2(Qs + (16 * warp + g) * KS + d);
          const float2 x1 = ld2(Qs + (16 * warp + g + 8) * KS + d);
          halves<EXACT>(x0.x, ab[0], as[0]);
          halves<EXACT>(x1.x, ab[1], as[1]);
          halves<EXACT>(x0.y, ab[2], as[2]);
          halves<EXACT>(x1.y, ab[3], as[3]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 kv = ld2(Kt + (8 * j + g) * KS + 8 * kk + 2 * t);
          uint32_t bb0, bs0, bb1, bs1;
          halves<EXACT>(kv.x, bb0, bs0);
          halves<EXACT>(kv.y, bb1, bs1);
          if constexpr (EXACT)
            mma_tf32(part[j], ab, bb0, bb1);
          else
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
        const T* vr = Vt + (8 * j + 2 * t) * VS + 8 * n + g;
        uint32_t bb0, bs0, bb1, bs1;
        halves<EXACT>(ld1(vr), bb0, bs0);
        halves<EXACT>(ld1(vr + VS), bb1, bs1);
        if constexpr (EXACT) {
          mma_tf32(pv, ps[j], bb0, bb1);
          mma_tf32(pv, pb[j], bb0, bb1);
        } else {
          mma3(pv, pb[j], ps[j], bb0, bb1, bs0, bs1);
        }
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
  T* ob = static_cast<T*>(p.o)
          + (static_cast<long long>(b) * p.Hq + h) * p.Sq * p.D;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = 8 * n + 2 * t;
    if (qr0 < p.Sq)
      st2(ob + static_cast<long long>(qr0) * p.D + d, o[n][0] * inv0,
          o[n][1] * inv0);
    if (qr1 < p.Sq)
      st2(ob + static_cast<long long>(qr1) * p.D + d, o[n][2] * inv1,
          o[n][3] * inv1);
  }
}

template <int D, class T, class ScoreMod>
cudaError_t launch(const Params& p, const ScoreMod& mod, int B,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes(D, sizeof(T));
  // allow this kernel more than 48 KB of shared memory on the current
  // device; the attribute is per device, so it is set on every launch
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D, T, ScoreMod>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.Hq, B);
  flash_fwd_kernel<D, T, ScoreMod><<<grid, kThreads, bytes, stream>>>(p, mod);
  return cudaGetLastError();
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
