// Flash decode for Hopper (sm_90a), float32, any head dim up to 256 that
// is a multiple of 4 (instances for 64, 128 and 256, each masking its
// columns at the true head dim).
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
//    it.  A warp reads 8 rows at a time (4 at D 256) for each of its row
//    slots (D / 4 lanes a row, a float4 each: one slot at D 128, two at D
//    64; at D 256 a whole warp a row, two float4 a lane), keeps an
//    online-softmax state (m, l, the lane's columns of acc) a query head
//    in registers, and the block merges its 4 or 8 states in shared
//    memory into one partial (m, l, acc[D]) a query head, written to a
//    float32 workspace.
// 2. `flash_decode_combine_kernel`, grid (Hq, B), D threads: merges the
//    splits' partials by log-sum-exp and divides by max(l, 1e-30).
//
// The split count is chosen by the wrapper so that B * Hkv * splits fills
// the SMs several times over.  A launch takes g <= 8 query heads a KV
// head; the wrapper runs a larger group as sub-groups of at most 8, one
// launch each, through strided views of q and o (q's and o's strides
// between KV heads and between the heads of a sub-group are separate
// arguments).  A head dim D below its instance's (80 in the 128
// instance) is read in place, by the instance's masked twin (MASK): a
// lane whose float4 lies at or past D holds zeros of q and reads K and V
// at D - 4 (in bounds, so the key loop has no column test; its q . k
// share is 0 and its acc columns are never stored), and o is stored only
// below D, so no operand is copied; the partials keep the instance's
// width.  At D equal to its instance the kernel is compiled without the
// mask, its column offsets constants: a column offset held in a register
// slowed those instances on the H100.  Rows past kv_len in a split's
// last tile are not read and get probability 0 (not exp(-1e30 - m),
// which is 1 when a state has seen no row yet).  The products run as FMA
// on the CUDA cores: the kernel is bound by bytes, not by operations.
//
// C interface (bound with ctypes): returns the first CUDA error of the two
// launches.  q, k, v are taken with their element strides (the last
// dimension contiguous, every other stride and the base 16-byte aligned:
// the wrapper checks); q head i of KV head j lies at b q_sb + j q_sk + i
// q_sh, and o likewise; part_acc [B, Hkv g, splits, D] and part_ml [B,
// Hkv g, splits, 2] are contiguous.
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
  long long q_sb, q_sk, q_sh;
  long long o_sb, o_sk, o_sh;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int Hq, G, dlen, kv_len, rows_per_split, splits;  // Hq = Hkv G; dlen = D
  float scale;
};

// A row's layout in a warp: VPL float4 a lane, LPR lanes a row, RPW row
// slots a warp, TILE rows a slot reads at once (fewer at D 256, whose
// lane holds twice the columns).
template <int D>
struct RowLayout {
  static constexpr int VPL = D > 128 ? D / 128 : 1;
  static constexpr int LPR = D / (4 * VPL);
  static constexpr int RPW = 32 / LPR;
  static constexpr int TILE = D > 128 ? kTile / 2 : kTile;
  static_assert(LPR * 4 * VPL == D && LPR <= 32 && 32 % LPR == 0,
                "a head dim of 64, 128 or 256");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

template <int D, int G, bool MASK>
__global__ void __launch_bounds__(kThreads) flash_decode_split_kernel(Params p) {
  using RL = RowLayout<D>;
  constexpr int VPL = RL::VPL, LPR = RL::LPR, RPW = RL::RPW, TILE = RL::TILE;
  constexpr int NSUB = kWarps * RPW;  // online-softmax states of a block
  constexpr int STEP = kWarps * RPW * TILE;  // rows a block reads at once
  __shared__ float s_m[NSUB][G];
  __shared__ float s_l[NSUB][G];
  __shared__ float s_acc[NSUB][G][D];
  static_assert(sizeof(float) * NSUB * G * (D + 2) <= 48 * 1024,
                "static shared memory of one block");

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = lane / LPR, c = 4 * (lane % LPR);
  const int row0 = split * p.rows_per_split;
  const int row1 = min(p.kv_len, row0 + p.rows_per_split);

  // lane columns c + 4 LPR u of each row, u < VPL, read at kg + off[u];
  // with MASK one at or past the true head dim holds zeros of q and
  // reads K and V at dlen - 4
  bool col[VPL];
  int off[VPL];
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
    col[u] = !MASK || c + 4 * LPR * u < p.dlen;
    off[u] = MASK ? (col[u] ? c + 4 * LPR * u : p.dlen - 4) : 4 * LPR * u;
  }
  const int cb = MASK ? 0 : c;
  const float* kg = p.k + b * p.k_sb + hk * p.k_sh + cb;
  const float* vg = p.v + b * p.v_sb + hk * p.v_sh + cb;
  const float* qg = p.q + b * p.q_sb + hk * p.q_sk + c;
  float4 qv[G][VPL], acc[G][VPL];
  float m[G], l[G];
#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
      qv[h][u] = col[u] ? ld4(qg + h * p.q_sh + 4 * LPR * u)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[h][u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    m[h] = kNegInf;
    l[h] = 0.f;
  }

  for (int base = row0 + warp * RPW * TILE; base < row1; base += STEP) {
    float4 kk[TILE][VPL], vv[TILE][VPL];
    bool in[TILE];
#pragma unroll
    for (int t = 0; t < TILE; ++t) {
      const int r = base + t * RPW + slot;
      in[t] = r < row1;
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        kk[t][u] = in[t] ? ld4(kg + r * p.k_ss + off[u])
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        vv[t][u] = in[t] ? ld4(vg + r * p.v_ss + off[u])
                         : make_float4(0.f, 0.f, 0.f, 0.f);
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
        for (int u = 1; u < VPL; ++u) d += dot4(qv[h][u], kk[t][u]);
#pragma unroll
        for (int w = LPR / 2; w > 0; w >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, w);
        s[t] = in[t] ? d * p.scale : kNegInf;
        mx = fmaxf(mx, s[t]);
      }
      const float alpha = expf(m[h] - mx);
      float ps = 0.f;
      float4 pv[VPL];
#pragma unroll
      for (int u = 0; u < VPL; ++u) pv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int t = 0; t < TILE; ++t) {
        const float e = in[t] ? expf(s[t] - mx) : 0.f;
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

  const int sub = warp * RPW + slot;
#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (lane % LPR == 0) {
      s_m[sub][h] = m[h];
      s_l[sub][h] = l[h];
    }
#pragma unroll
    for (int u = 0; u < VPL; ++u)
      *reinterpret_cast<float4*>(&s_acc[sub][h][c + 4 * LPR * u]) = acc[h][u];
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
  if (d < p.dlen)
    p.o[b * p.o_sb + (h / p.G) * p.o_sk + (h % p.G) * p.o_sh + d] =
        aa / fmaxf(ll, 1e-30f);
}

template <int D, int G>
cudaError_t launch(const Params& p, int B, int Hkv, cudaStream_t stream) {
  const dim3 grid(p.splits, Hkv, B);
  if (p.dlen == D)
    flash_decode_split_kernel<D, G, false><<<grid, kThreads, 0, stream>>>(p);
  else
    flash_decode_split_kernel<D, G, true><<<grid, kThreads, 0, stream>>>(p);
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

// One launch pair for G <= 8 query heads of each of the Hkv KV heads, at
// head dim D (a multiple of 4, at most 256); part_acc and part_ml at the
// width of D's instance (64, 128 or 256).
extern "C" int repro_flash_decode_f32(
    const void* q, const void* k, const void* v, void* part_acc,
    void* part_ml, void* o, int B, int G, int Hkv, int D, int kv_len,
    int rows_per_split, int splits, long long q_sb, long long q_sk,
    long long q_sh, long long o_sb, long long o_sk, long long o_sh,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, float scale, void* stream) {
  Params p{static_cast<const float*>(q), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<float*>(part_acc),
           static_cast<float*>(part_ml), static_cast<float*>(o),
           q_sb, q_sk, q_sh, o_sb, o_sk, o_sh, k_sb, k_sh, k_ss,
           v_sb, v_sh, v_ss, Hkv * G, G, D, kv_len, rows_per_split, splits,
           scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (B == 0) {
    err = cudaSuccess;
  } else if (D <= 0 || D % 4) {
    err = cudaErrorInvalidValue;
  } else if (D <= 64) {
    err = launch_group<64>(p, B, Hkv, G, s);
  } else if (D <= 128) {
    err = launch_group<128>(p, B, Hkv, G, s);
  } else if (D <= 256) {
    err = launch_group<256>(p, B, Hkv, G, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
