// Flash attention forward for Hopper (sm_90a) above head dim 256: the
// instances without `score_mod` of the kernel in flash_attention_wide.cuh
// (its design is there), float32 and bfloat16.
//
// Replaces the TPU kernel `_attn_kernel` / `flash_attention`
// (src/repro/kernels/flash_attention.py:31,87; `pallas_call` at :135) at
// the head dims the tuned instances of flash_attention.cu do not take:
//     o = softmax(mask(q k^T * scale)) v      q [B, Hq, Sq, D]
//                                             k, v [B, Hkv, Skv, D]
//
// C interface (bound with ctypes): returns the first CUDA error of the
// launch.  q, k, v are taken with their element strides (the last
// dimension contiguous, every other stride and the base 16-byte
// aligned); D is any multiple of 4 (8 in bfloat16; the wrapper zero-pads
// another D up to one); o is a contiguous [B, Hq, Sq, D]; q, k, v and o
// are all float32 (bf16 0) or all bfloat16 (bf16 1).
#include "flash_attention_wide.cuh"

namespace {

template <class T>
int wide(const void* q, const void* k, const void* v, void* o, int B, int Hq,
         int Hkv, int Sq, int Skv, int D, long long q_sb, long long q_sh,
         long long q_ss, long long k_sb, long long k_sh, long long k_ss,
         long long v_sb, long long v_sh, long long v_ss, float scale,
         int causal, void* stream) {
  repro_flash_wide::Params<T> p{
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), q_sb, q_sh, q_ss,
      k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, Hq, Hq / Hkv, Sq, Skv, D, scale,
      causal};
  return repro_flash_wide::run(p, repro_flash_wide::NoScoreMod{}, B,
                               static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int repro_flash_wide_attention(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, float scale, int causal,
    int bf16, void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return wide<uint16_t>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, q_sb, q_sh,
                          q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale,
                          causal, stream);
  return wide<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, q_sb, q_sh, q_ss,
                     k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale, causal,
                     stream);
}
