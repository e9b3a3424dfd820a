"""Flash attention forward: the hand-written CUDA kernel
(``csrc/flash_attention.cu``), its plain PyTorch version, and the
``repro_torch::flash_attention`` operator.

The counterpart of ``flash_attention`` (the TPU kernel ``_attn_kernel``,
``src/repro/kernels/flash_attention.py:31,87``): q [B, Hq, Sq, D] and
k, v [B, Hkv, Skv, D] -> o [B, Hq, Sq, D], with grouped-query heads
(``kv_head = h // (Hq // Hkv)``, no repeated K/V), ``scale`` (1/sqrt(D)
by default), the causal offset ``q_idx + (Skv - Sq) >= k_idx``, the
padding of a ragged ``Skv``, the ``-1e30`` fill and the final
``max(l, 1e-30)``.  ``score_mod`` and ``flash_decode`` are not ported yet.

Its autograd formula recomputes ``ref.attention`` and takes its VJP, as
the reference's ``_attention_bwd`` does (``src/repro/kernels/ops.py:56-70``):
the JAX package has no attention backward kernel, so the backward is
plain ops on the card by the reference's own design.

``flash_attention(q, k, v, causal, scale)`` is the operator: on CPU
tensors it runs ``flash_attention_plain``, on CUDA tensors
``flash_attention_cuda`` (the kernel, or an error), on fake and meta
tensors its shape function.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build, ref

MAX_HEAD_DIM = 128


def _check_shapes(q, k, v, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; want q "
                         "[B, Hq, Sq, D] and k, v [B, Hkv, Skv, D]")
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Skv, Dk = k.shape
    if Bk != B or Dk != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} against k "
                         f"{tuple(k.shape)} (need Hq % Hkv == 0)")
    if Skv == 0 or (causal and Sq > Skv):
        raise ValueError(f"flash_attention: Sq {Sq}, Skv {Skv}: causal "
                         "attention needs 1 <= Sq <= Skv (every query row "
                         "sees a key)")


def flash_attention_plain(q, k, v, causal: bool = True,
                          scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``ref.attention`` (all keys
    at once, the same -1e30 causal fill) on the shapes the kernel takes.
    Every query row sees a key, so the kernel's ``max(l, 1e-30)`` never
    binds and the two agree to rounding."""
    _check_shapes(q, k, v, causal)
    return ref.attention(q, k, v, causal=causal, scale=scale)


def flash_attention_cuda(q, k, v, causal: bool = True,
                         scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel (float32, D <= 128, on the current stream).
    q, k, v are taken with their strides; only a last dimension that is
    not contiguous is copied (device time)."""
    _check_shapes(q, k, v, causal)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention_cuda: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}; all must lie on one "
                         "CUDA device")
    if {q.dtype, k.dtype, v.dtype} != {torch.float32}:
        raise TypeError(f"flash_attention_cuda takes float32, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_cuda: head dim {D} > "
                         f"{MAX_HEAD_DIM}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    o = torch.empty(B, Hq, Sq, D, dtype=torch.float32, device=dev)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    _build.check(_entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, Hq, Hkv, Sq, Skv, D, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], float(scale), int(causal),
        torch.cuda.current_stream(dev).cuda_stream),
        "repro_flash_attention_f32")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0  # kernel launches (plain runs excluded)


@functools.cache
def _entry():
    fn = _build.library("flash_attention").repro_flash_attention_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """o [B, Hq, Sq, D] = softmax(mask(q k^T scale)) v."""
    return flash_attention_plain(q, k, v, causal, scale)


@flash_attention.register_kernel("cuda")
def _(q, k, v, causal=True, scale=None):
    return flash_attention_cuda(q, k, v, causal, scale)


@flash_attention.register_fake
def _(q, k, v, causal=True, scale=None):
    _check_shapes(q, k, v, causal)
    return q.new_empty(q.shape)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    ctx.save_for_backward(q, k, v)
    ctx.causal, ctx.scale = causal, scale


def _backward(ctx, do):
    q, k, v = ctx.saved_tensors
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        o = ref.attention(*qkv, causal=ctx.causal, scale=ctx.scale)
        dq, dk, dv = torch.autograd.grad(o, qkv, do)
    return dq, dk, dv, None, None


flash_attention.register_autograd(_backward, setup_context=_setup_context)
