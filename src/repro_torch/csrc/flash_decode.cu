// Flash decode for Hopper (sm_90a), float32, head_dim 64 or 128.
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
// * D floats a (batch, kv head), and does 4 D operations a key and query
// head: at Llama-3.2-3B's [4, 24/8, 32768, 128] 268 MB against 0.4 GFLOP,
// 0.32 ms at 3.35 TB/s.
//
// The TPU kernel walks the K blocks as a sequential grid axis, one grid
// row per (batch, query head), carrying (m, l, acc) in VMEM.  That would
// give B * Hq blocks (96 at Llama's batch 4) on 132 SMs, and every K/V
// tile read once per query head of its group.  Here the KV axis is split:
//
// 1. `flash_decode_split_kernel`, grid (splits, Hkv, B), 4 warps: a block
//    owns one (batch, kv head) and one range of `rows_per_split` cache
//    rows, and reads each K/V row once for all g query heads that share
//    it.  A warp reads 8 rows at a time for each of its row slots (D / 4
//    lanes a row, a float4 each: one slot at D 128, two at D 64), keeps an
//    online-softmax state (m, l, 4 columns of acc) a query head in
//    registers, and the block merges its 4 or 8 states in shared memory
//    into one partial (m, l, acc[D]) a query head, written to a float32
//    workspace.
// 2. `flash_decode_combine_kernel`, grid (Hq, B), D threads: merges the
//    splits' partials by log-sum-exp and divides by max(l, 1e-30).
//
// The split count is chosen by the wrapper so that B * Hkv * splits fills
// the SMs several times over.  Rows past kv_len in a split's last tile
// are not read and get probability 0 (not exp(-1e30 - m), which is 1 when
// a state has seen no row yet).  The products run as FMA on the CUDA
// cores: the kernel is bound by bytes, not by operations.
//
// C interface (bound with ctypes): returns the first CUDA error of the two
// launches.  q, k, v are taken with their element strides (the last
// dimension contiguous, every other stride and the base 16-byte aligned:
// the wrapper checks); part_acc [B, Hq, splits, D], part_ml [B, Hq,
// splits, 2] and o [B, Hq, D] are contiguous.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 8;  // rows a row slot reads at once
constexpr float kNegInf = -1e30f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* part_acc;
  float* part_ml;
  float* o;
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int Hq, kv_len, rows_per_split, splits;
  float scale;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

template <int D, int G>
__global__ void __launch_bounds__(kThreads) flash_decode_split_kernel(Params p) {
  constexpr int LPR = D / 4;         // lanes a row (one float4 each)
  constexpr int RPW = 32 / LPR;      // row slots of a warp
  constexpr int NSUB = kWarps * RPW;  // online-softmax states of a block
  constexpr int STEP = kWarps * RPW * kTile;  // rows a block reads at once
  __shared__ float s_m[NSUB][G];
  __shared__ float s_l[NSUB][G];
  __shared__ float s_acc[NSUB][G][D];

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = lane / LPR, c = 4 * (lane % LPR);
  const int row0 = split * p.rows_per_split;
  const int row1 = min(p.kv_len, row0 + p.rows_per_split);
  const float* kg = p.k + b * p.k_sb + hk * p.k_sh + c;
  const float* vg = p.v + b * p.v_sb + hk * p.v_sh + c;

  float4 qv[G], acc[G];
  float m[G], l[G];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    qv[h] = ld4(p.q + b * p.q_sb + (long long)(hk * G + h) * p.q_sh + c);
    acc[h] = make_float4(0.f, 0.f, 0.f, 0.f);
    m[h] = kNegInf;
    l[h] = 0.f;
  }

  for (int base = row0 + warp * RPW * kTile; base < row1; base += STEP) {
    float4 kk[kTile], vv[kTile];
    bool in[kTile];
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const int r = base + t * RPW + slot;
      in[t] = r < row1;
      kk[t] = in[t] ? ld4(kg + r * p.k_ss) : make_float4(0.f, 0.f, 0.f, 0.f);
      vv[t] = in[t] ? ld4(vg + r * p.v_ss) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float s[kTile];
      float mx = m[h];
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        float d = dot4(qv[h], kk[t]);
#pragma unroll
        for (int w = LPR / 2; w > 0; w >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, w);
        s[t] = in[t] ? d * p.scale : kNegInf;
        mx = fmaxf(mx, s[t]);
      }
      const float alpha = expf(m[h] - mx);
      float ps = 0.f;
      float4 pv = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const float e = in[t] ? expf(s[t] - mx) : 0.f;
        ps += e;
        pv.x = fmaf(e, vv[t].x, pv.x);
        pv.y = fmaf(e, vv[t].y, pv.y);
        pv.z = fmaf(e, vv[t].z, pv.z);
        pv.w = fmaf(e, vv[t].w, pv.w);
      }
      l[h] = l[h] * alpha + ps;
      acc[h].x = fmaf(acc[h].x, alpha, pv.x);
      acc[h].y = fmaf(acc[h].y, alpha, pv.y);
      acc[h].z = fmaf(acc[h].z, alpha, pv.z);
      acc[h].w = fmaf(acc[h].w, alpha, pv.w);
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
    *reinterpret_cast<float4*>(&s_acc[sub][h][c]) = acc[h];
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
  p.o[((long long)b * p.Hq + h) * D + d] = aa / fmaxf(ll, 1e-30f);
}

template <int D, int G>
cudaError_t launch(const Params& p, int B, int Hkv, cudaStream_t stream) {
  flash_decode_split_kernel<D, G>
      <<<dim3(p.splits, Hkv, B), kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_combine_kernel<D><<<dim3(p.Hq, B), D, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_group(const Params& p, int B, int Hkv, int G,
                         cudaStream_t s) {
  switch (G) {
    case 1: return launch<D, 1>(p, B, Hkv, s);
    case 2: return launch<D, 2>(p, B, Hkv, s);
    case 3: return launch<D, 3>(p, B, Hkv, s);
    case 4: return launch<D, 4>(p, B, Hkv, s);
    case 5: return launch<D, 5>(p, B, Hkv, s);
    case 6: return launch<D, 6>(p, B, Hkv, s);
    case 7: return launch<D, 7>(p, B, Hkv, s);
    case 8: return launch<D, 8>(p, B, Hkv, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int repro_flash_decode_f32(
    const void* q, const void* k, const void* v, void* part_acc,
    void* part_ml, void* o, int B, int Hq, int Hkv, int D, int kv_len,
    int rows_per_split, int splits, long long q_sb, long long q_sh,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, float scale, void* stream) {
  Params p{static_cast<const float*>(q), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<float*>(part_acc),
           static_cast<float*>(part_ml), static_cast<float*>(o),
           q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           Hq, kv_len, rows_per_split, splits, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = Hq / Hkv;
  cudaError_t err;
  if (B == 0) {
    err = cudaSuccess;
  } else if (D == 64) {
    err = launch_group<64>(p, B, Hkv, G, s);
  } else if (D == 128) {
    err = launch_group<128>(p, B, Hkv, G, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
