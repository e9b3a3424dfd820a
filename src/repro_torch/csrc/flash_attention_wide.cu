// Flash attention forward for Hopper (sm_90a), float32, head dims above
// 256: a simple kernel on the CUDA cores, beside the tuned instances of
// flash_attention.cuh (D 64, 80, 128, 256), which it leaves alone.
//
// Replaces the TPU kernel `_attn_kernel` / `flash_attention`
// (src/repro/kernels/flash_attention.py:31,87) at the head dims the tuned
// instances do not take -- the reference's kernel has no ceiling on D:
//     o = softmax(mask(q k^T * scale)) v      q [B, Hq, Sq, D]
//                                             k, v [B, Hkv, Skv, D]
// with grouped-query heads (kv head = h / (Hq / Hkv)), the causal offset
// q_idx + (Skv - Sq) >= k_idx, keys past Skv masked, and the final
// division by max(l, 1e-30).  It also runs flash decode above D 256
// (kernels/flash_attention.py::flash_decode_cuda): one query row over the
// live prefix, non-causal, as the reference builds `flash_decode` from
// `flash_attention` (:161-180).
//
// Bound: operations at long sequences, as B4.  No config of the repo
// carries a head dim above 256, so this kernel is right and simple, not
// tuned.  The output's head dim is cut into D-tiles of at most kDT = 256
// columns, a grid axis: a block of 128 threads owns one (batch, head,
// kBQ-row query tile, D-tile).  For each K/V tile of kBK rows it sums
// q k^T over the whole of D in chunks of kDC columns staged in shared
// memory, a partial sum each kSum columns added into the score (each
// D-tile's block recomputes the scores), runs the online
// softmax on them in registers, and accumulates p v into its own output
// columns only.  Thread t owns query row t / 4, 8 of the tile's keys and
// 64 of the D-tile's columns; a row's max and sum are reduced over its
// four threads by shuffles.  Products are float32 FMA on the CUDA cores.
// Keys past Skv and above the causal diagonal get probability 0; K/V
// tiles wholly above the diagonal are not read.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch.  q, k, v are taken with their element strides (the last
// dimension contiguous); o is a contiguous [B, Hq, Sq, D].
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 32;        // query rows a block
constexpr int kBK = 32;        // key rows a tile
constexpr int kDC = 32;        // head-dim columns a step of q k^T
constexpr int kSum = 16;       // columns of q k^T a partial sum
constexpr int kDT = 256;       // output columns a block, at most
constexpr int kThreads = 128;  // 4 threads a query row
constexpr int kKeys = kBK / 4;    // keys a thread scores
constexpr int kCols = kDT / 16;   // float4 output groups a thread
constexpr float kNegInf = -1e30f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int Hq, group, Sq, Skv, D, dt;  // dt: columns a D-tile
  float scale;
  int causal;
};

__global__ void __launch_bounds__(kThreads) flash_wide_kernel(Params p) {
  __shared__ float qs[kBQ][kDC + 1];
  __shared__ float ks[kBK][kDC + 1];
  __shared__ float ps[kBQ][kBK + 1];
  __shared__ __align__(16) float vs[kBK][kDT];

  const int tid = threadIdx.x;
  const int r = tid / 4, quad = tid % 4;
  const int tiles = (p.D + p.dt - 1) / p.dt;  // D-tiles
  const int q0 = blockIdx.x / tiles * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int c0 = blockIdx.x % tiles * p.dt, c1 = min(p.D, c0 + p.dt);
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const float* vb = p.v + b * p.v_sb + hk * p.v_sh;
  const int qi = q0 + r;        // this thread's query row
  const int off = p.Skv - p.Sq;  // causal offset
  // keys past this one are above the diagonal for every row of the block
  const int kend = p.causal ? min(p.Skv, q0 + kBQ - 1 + off + 1) : p.Skv;

  float acc[kCols][4];
#pragma unroll
  for (int i = 0; i < kCols; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    // scores of this thread's keys k0 + quad * kKeys + j over all of D
    float s[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) s[j] = 0.f;
    for (int d0 = 0; d0 < p.D; d0 += kDC) {
      __syncthreads();  // the previous chunk's (or tile's) reads are done
      for (int i = tid; i < kBQ * kDC; i += kThreads) {
        const int rr = i / kDC, cc = i % kDC, d = d0 + cc;
        qs[rr][cc] = (q0 + rr < p.Sq && d < p.D)
                         ? qb[(long long)(q0 + rr) * p.q_ss + d] : 0.f;
        ks[rr][cc] = (k0 + rr < p.Skv && d < p.D)
                         ? kb[(long long)(k0 + rr) * p.k_ss + d] : 0.f;
      }
      __syncthreads();
      // a partial sum each kSum columns, added into the scores: one
      // float32 chain over all of D sits above B4's limit off float64
#pragma unroll
      for (int c0 = 0; c0 < kDC; c0 += kSum) {
        float sp[kKeys];
#pragma unroll
        for (int j = 0; j < kKeys; ++j) sp[j] = 0.f;
#pragma unroll 8
        for (int cc = c0; cc < c0 + kSum; ++cc) {
          const float qv = qs[r][cc];
#pragma unroll
          for (int j = 0; j < kKeys; ++j)
            sp[j] = fmaf(qv, ks[quad * kKeys + j][cc], sp[j]);
        }
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[j] += sp[j];
      }
    }
    // V's D-tile columns of this key tile (zero past Skv and past c1)
    for (int i = tid; i < kBK * kDT; i += kThreads) {
      const int rr = i / kDT, cc = i % kDT, c = c0 + cc;
      vs[rr][cc] = (k0 + rr < p.Skv && c < c1)
                       ? vb[(long long)(k0 + rr) * p.v_ss + c] : 0.f;
    }
    // online softmax of the row, over its four threads
    bool in[kKeys];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int ki = k0 + quad * kKeys + j;
      in[j] = ki < p.Skv && (!p.causal || qi + off >= ki);
      s[j] = in[j] ? s[j] * p.scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = expf(m - mx);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float e = in[j] ? expf(s[j] - mx) : 0.f;
      psum += e;
      ps[r][quad * kKeys + j] = e;
    }
    l = l * alpha + psum;
    m = mx;
    __syncthreads();  // p and the V tile are in shared memory
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      acc[i][0] *= alpha;
      acc[i][1] *= alpha;
      acc[i][2] *= alpha;
      acc[i][3] *= alpha;
    }
    for (int j = 0; j < kBK; ++j) {
      const float e = ps[r][j];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&vs[j][16 * i + 4 * quad]);
        acc[i][0] = fmaf(e, vv.x, acc[i][0]);
        acc[i][1] = fmaf(e, vv.y, acc[i][1]);
        acc[i][2] = fmaf(e, vv.z, acc[i][2]);
        acc[i][3] = fmaf(e, vv.w, acc[i][3]);
      }
    }
  }
  // the row's sum over its four threads
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (qi >= p.Sq) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  float* ob = p.o + (((long long)b * p.Hq + h) * p.Sq + qi) * p.D;
#pragma unroll
  for (int i = 0; i < kCols; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + 16 * i + 4 * quad + e;
      if (c < c1) ob[c] = acc[i][e] * inv;
    }
}

// Columns a D-tile: D cut into the fewest tiles of at most kDT columns,
// each a multiple of 16.
int dtile_columns(int D) {
  const int tiles = (D + kDT - 1) / kDT;
  const int per = (D + tiles - 1) / tiles;
  return (per + 15) / 16 * 16;
}

}  // namespace

extern "C" int repro_flash_wide_f32(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, float scale, int causal,
    void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  if (Hkv < 1 || Hq % Hkv != 0 || Skv < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dt = dtile_columns(D);
  Params p{static_cast<const float*>(q), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<float*>(o),
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           Hq, Hq / Hkv, Sq, Skv, D, dt, scale, causal};
  const dim3 grid((Sq + kBQ - 1) / kBQ * ((D + dt - 1) / dt), Hq, B);
  flash_wide_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
