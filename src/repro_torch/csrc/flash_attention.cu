// Flash attention forward for Hopper (sm_90a), float32, head_dim <= 128.
//
// Replaces the TPU kernel `_attn_kernel` / `flash_attention`
// (src/repro/kernels/flash_attention.py:31,87); this file is its
// instance without `score_mod` (the kernel body is the template in
// flash_attention.cuh, instantiated here with the identity functor):
//     o = softmax(mask(q k^T * scale)) v      q [B, Hq, Sq, D]
//                                             k, v [B, Hkv, Skv, D]
// with grouped-query heads (kv head = h / (Hq / Hkv), K/V never
// repeated), the causal offset q_idx + (Skv - Sq) >= k_idx, the padding
// mask k_idx < Skv of a ragged last tile, the -1e30 fill and the final
// division by max(l, 1e-30) -- the reference's semantics step by step.
//
// Bound: operations.  At the prefill shape (B 4, Hq 24, S 512, D 128,
// causal) the two products are about 6.4 GFLOP against 50 MB moved.
// The TPU kernel walks the K tiles as a sequential grid axis and carries
// the running max, sum and accumulator in VMEM between grid steps.  CUDA
// blocks run in no order, so here one block of 256 threads owns one
// (batch, head, 64-row query tile) and loops over the 64-row K/V tiles
// itself, with the running max, sum and accumulator in registers, in
// float32.  Each thread owns 4 query rows (ty + 16 i) and, of the score
// tile, 4 key columns (tx + 16 j), of the output 4 rows by D/16 columns
// (tx + 16 j); a row's max and sum are shuffles over its 16 threads.
// Q, K, V and the probabilities of one tile sit in shared memory
// (115 KB at D 128, above the 48 KB default: the launch raises the
// limit first).  K tiles wholly above the causal diagonal are skipped:
// the reference computes them, but each leaves (m, l, acc) unchanged.
// The products run as FMA on the CUDA cores: no tensor-core path in
// float32 yet.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch.  q, k, v are taken with their element strides (the last
// dimension must be contiguous); o is a contiguous [B, Hq, Sq, D].
#include "flash_attention.cuh"

extern "C" int repro_flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, float scale, int causal,
    void* stream) {
  repro_flash::Params p{static_cast<const float*>(q),
                        static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<float*>(o),
                        q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                        Hq, Hq / Hkv, Sq, Skv, D, scale, causal};
  return repro_flash::run(p, repro_flash::NoScoreMod{}, B,
                          static_cast<cudaStream_t>(stream));
}
