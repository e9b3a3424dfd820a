// Flash decode for Hopper (sm_90a), float32, any head dim that is a
// multiple of 4: instances for 64, 128, 256, 384 and 512, each masking
// its columns at the true head dim, and above 512 a tiled kernel.
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
// 0.32 ms at 3.35 TB/s; at [1, 8/2, 4000, 320] 20.5 MB, 0.0061 ms.
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
// C interface (bound with ctypes): returns the first CUDA error of the two
// launches.  q, k, v are taken with their element strides (the last
// dimension contiguous, every other stride and the base 16-byte aligned:
// the wrapper checks); q head i of KV head j lies at b q_sb + j q_sk + i
// q_sh, and o likewise; part_acc [B, Hkv g, splits, W] (W: D's instance,
// above 512 D rounded up to a multiple of 512) and part_ml [B, Hkv g,
// splits, 2] are contiguous.
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
// slots a warp, TILE rows a slot reads at once (fewer where a lane holds
// more columns).  From D 256 up a whole warp reads a row.
template <int D>
struct RowLayout {
  static constexpr int VPL = D > 128 ? D / 128 : 1;
  static constexpr int LPR = D / (4 * VPL);
  static constexpr int RPW = 32 / LPR;
  static constexpr int TILE =
      D > 256 ? kTile / 4 : D > 128 ? kTile / 2 : kTile;
  static_assert(LPR * 4 * VPL == D && LPR <= 32 && 32 % LPR == 0,
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

// D above kMaxD: one kDT-column tile of the output a block (a grid axis,
// blockIdx.y = kv head x tiles + tile).  The sub-group's q sits in shared
// memory, zero past D; a warp reads a row: the scores over all of D in
// steps of 128 columns (a float4 a lane), each step's K loads for TILE
// rows in flight together, and V's tile columns (four float4 a lane),
// whose loads start before the scores.  Every tile of a split
// computes the same (m, l); tile 0 writes them.
template <int G>
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
  const float* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const float* vg = p.v + b * p.v_sb + hk * p.v_sh;
  const float* qg = p.q + b * p.q_sb + hk * p.q_sk;
  for (int i = threadIdx.x; i < G * dq; i += kThreads) {
    const int h = i / dq, d = i % dq;
    s_q[i] = d < p.dlen ? qg[h * p.q_sh + d] : 0.f;
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
    p.o[b * p.o_sb + (h / p.G) * p.o_sk + (h % p.G) * p.o_sh + d] =
        aa / fmaxf(ll, 1e-30f);
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
  if constexpr (D > 256)
    flash_decode_merge_kernel<<<dim3(p.Hq, B, D / kMergeCols),
                                dim3(kMergeCols, kMergeGroups), 0, stream>>>(
        p, D);
  else
    flash_decode_combine_kernel<D><<<dim3(p.Hq, B), D, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_tiled(const Params& p, int B, int Hkv,
                         cudaStream_t stream) {
  const int bytes = tiled_smem_bytes(p.dlen, G);
  if (bytes > 232448) return cudaErrorInvalidValue;
  // the attribute is per device, so it is set on every launch
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_tiled_kernel<G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (p.dlen + kDT - 1) / kDT;
  flash_decode_tiled_kernel<G>
      <<<dim3(p.splits, Hkv * tiles, B), kThreads, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_merge_kernel<<<dim3(p.Hq, B, tiles * kDT / kMergeCols),
                              dim3(kMergeCols, kMergeGroups), 0, stream>>>(
      p, tiles * kDT);
  return cudaGetLastError();
}

// G within the cap of head dim D (kMaxD + 4 stands for the tiled kernel)
template <int D, int G>
cudaError_t launch_capped(const Params& p, int B, int Hkv, cudaStream_t s) {
  if constexpr (G > max_group(D)) {
    return cudaErrorInvalidValue;
  } else if constexpr (D > kMaxD) {
    return launch_tiled<G>(p, B, Hkv, s);
  } else {
    return launch<D, G>(p, B, Hkv, s);
  }
}

template <int D>
cudaError_t launch_group(const Params& p, int B, int Hkv, int G,
                         cudaStream_t s) {
  switch (G) {
    case 1: return launch_capped<D, 1>(p, B, Hkv, s);
    case 2: return launch_capped<D, 2>(p, B, Hkv, s);
    case 3: return launch_capped<D, 3>(p, B, Hkv, s);
    case 4: return launch_capped<D, 4>(p, B, Hkv, s);
    case 5: return launch_capped<D, 5>(p, B, Hkv, s);
    case 6: return launch_capped<D, 6>(p, B, Hkv, s);
    case 7: return launch_capped<D, 7>(p, B, Hkv, s);
    case 8: return launch_capped<D, 8>(p, B, Hkv, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch pair for G query heads of each of the Hkv KV heads (at most
// max_group(D)), at head dim D (a multiple of 4); part_acc and part_ml at
// the width of D's instance (64, 128, 256, 384 or 512), or above 512 of
// the tiled kernel's tiles (D rounded up to a multiple of 512).
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
  } else if (D <= 384) {
    err = launch_group<384>(p, B, Hkv, G, s);
  } else if (D <= kMaxD) {
    err = launch_group<512>(p, B, Hkv, G, s);
  } else {
    err = launch_group<kMaxD + 4>(p, B, Hkv, G, s);
  }
  return static_cast<int>(err);
}
