// Flash attention forward for Hopper (sm_90a), float32, head_dim <= 128:
// the kernel body, a template on a score functor.
//
// Replaces the TPU kernel `_attn_kernel` / `flash_attention`
// (src/repro/kernels/flash_attention.py:31,87):
//     o = softmax(mask(score_mod(q k^T * scale))) v   q [B, Hq, Sq, D]
//                                                     k, v [B, Hkv, Skv, D]
// flash_attention.cu instantiates it with the identity functor (B4 as
// PR 12 ported it); compute-anchored stitching instantiates it with a
// functor that core/codegen_cuda.py generates from the graph's own
// scale / bias / mask chain (the reference's `score_mod`,
// src/repro/kernels/flash_attention.py:44-51).  A functor is
//     float operator()(float s, int b, int h, int qi, int ki) const
// over the scaled score of query row qi and key row ki of (batch b, query
// head h), reading its operands through 4D strides (stride 0 on a dim of
// extent 1).  It is applied where the reference applies it: after
// q k^T * scale, before the padding and causal masks, and only inside
// the valid (Sq, Skv) range, so a folded mask never reads past its
// operand nor resurrects a padded key.
//
// Design and bound: see flash_attention.cu.
#pragma once

#include "chain.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace repro_flash {

constexpr int kBQ = 64;       // query rows of a block
constexpr int kBK = 64;       // key rows of a tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int Hq, group, Sq, Skv, D;
  float scale;
  int causal;
};

template <int DMAX>
constexpr int smem_floats() {
  return kBQ * (DMAX + 1) + kBK * (DMAX + 1) + kBK * DMAX + kBQ * (kBK + 1);
}

// The identity score functor: B4 without a score chain.
struct NoScoreMod {
  static constexpr bool kIdentity = true;
  __host__ __device__ float operator()(float s, int, int, int, int) const {
    return s;
  }
};

template <int DMAX, class ScoreMod>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(Params p, const ScoreMod mod) {
  constexpr int QS = DMAX + 1;  // padded row stride: conflict-free columns
  constexpr int PS = kBK + 1;
  constexpr int DJ = DMAX / 16;  // output columns of a thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [kBQ][QS]
  float* Ks = Qs + kBQ * QS;     // [kBK][QS]
  float* Vs = Ks + kBK * QS;     // [kBK][DMAX]
  float* Ps = Vs + kBK * DMAX;   // [kBQ][PS]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const float* qg = p.q + b * p.q_sb + h * p.q_sh;
  const float* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const float* vg = p.v + b * p.v_sb + hk * p.v_sh;

  for (int idx = tid; idx < kBQ * DMAX; idx += kThreads) {
    const int r = idx / DMAX, d = idx % DMAX;
    Qs[r * QS + d] = (q0 + r < p.Sq && d < p.D)
                         ? qg[(long long)(q0 + r) * p.q_ss + d] : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  const int off = p.Skv - p.Sq;  // causal offset
  int k_end = p.Skv;
  if (p.causal) {
    const int q_last = min(q0 + kBQ, p.Sq) - 1;
    k_end = min(p.Skv, q_last + off + 1);
  }

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * DMAX; idx += kThreads) {
      const int r = idx / DMAX, d = idx % DMAX;
      const bool in = k0 + r < p.Skv && d < p.D;
      Ks[r * QS + d] = in ? kg[(long long)(k0 + r) * p.k_ss + d] : 0.f;
      Vs[r * DMAX + d] = in ? vg[(long long)(k0 + r) * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DMAX; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < p.Skv && (!p.causal || qi + off >= kj);
        float sv = s[i][j] * p.scale;
        if constexpr (!ScoreMod::kIdentity) {
          if (kj < p.Skv && qi < p.Sq) sv = mod(sv, b, h, qi, kj);
        }
        s[i][j] = ok ? sv : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pij = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = pij;
        ps += pij;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, w);
      l[i] = l[i] * alpha + ps;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float vv[DJ];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) vv[jj] = Vs[c * DMAX + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = Ps[(ty + 16 * i) * PS + c];
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = fmaf(pv, vv[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = p.o + (((long long)blockIdx.z * p.Hq + h) * p.Sq + qi) * p.D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < p.D) orow[d] = acc[i][jj] / denom;
    }
  }
}

template <int DMAX, class ScoreMod>
cudaError_t launch(const Params& p, const ScoreMod& mod, int B,
                   cudaStream_t stream) {
  constexpr int bytes = smem_floats<DMAX>() * static_cast<int>(sizeof(float));
  // allow this kernel more than 48 KB of shared memory on the current
  // device; the attribute is per device, so it is set on every launch
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<DMAX, ScoreMod>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.Hq, B);
  flash_fwd_kernel<DMAX, ScoreMod><<<grid, kThreads, bytes, stream>>>(p, mod);
  return cudaGetLastError();
}

// Launch the instance that runs head dim p.D (32, 64 or 128, padded up).
template <class ScoreMod>
int run(const Params& p, const ScoreMod& mod, int B, cudaStream_t s) {
  cudaError_t err;
  if (B == 0 || p.Sq == 0) {
    err = cudaSuccess;
  } else if (p.D <= 32) {
    err = launch<32>(p, mod, B, s);
  } else if (p.D <= 64) {
    err = launch<64>(p, mod, B, s);
  } else {
    err = launch<128>(p, mod, B, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_flash

#endif  // __CUDACC__
