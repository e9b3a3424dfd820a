// Flash attention forward for Hopper (sm_90a), float32 on the tensor
// cores, head dims 64, 80, 128 and 256, float32 or bfloat16 operands.
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
// causal) the two products are about 6.5 GFLOP against 67 MB moved.
// The TPU kernel walks the K tiles as a sequential grid axis and carries
// the running max, sum and accumulator in VMEM between grid steps; CUDA
// blocks run in no order, so here one block of 4 warps owns one (batch,
// head, 64-row query tile) and loops over the K/V tiles itself, with the
// running max, sum and accumulator in registers.  Both products run on
// the tensor cores (mma.sync m16n8k8, TF32) through the three-way split
// of float32 values; the design is in flash_attention.cuh.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch.  q, k, v are taken with their element strides (the last
// dimension contiguous, rows 16-byte aligned); o is a contiguous
// [B, Hq, Sq, D]; D is one of the instances' head dims; q, k, v and o
// are all float32 (bf16 0) or all bfloat16 (bf16 1).
#include "flash_attention.cuh"

extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, float scale, int causal,
    int bf16, void* stream) {
  repro_flash::Params p{q, k, v, o, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                        v_sb, v_sh, v_ss, Hq, Hq / Hkv, Sq, Skv, D, scale,
                        causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return repro_flash::run<uint16_t>(p, repro_flash::NoScoreMod{}, B, s);
  return repro_flash::run<float>(p, repro_flash::NoScoreMod{}, B, s);
}
