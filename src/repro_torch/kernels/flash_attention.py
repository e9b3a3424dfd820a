"""Flash attention forward: the hand-written CUDA kernel
(``csrc/flash_attention.cu``), its plain PyTorch version, and the
``repro_torch::flash_attention`` operator.

The counterpart of ``flash_attention`` (the TPU kernel ``_attn_kernel``,
``src/repro/kernels/flash_attention.py:31,87``): q [B, Hq, Sq, D] and
k, v [B, Hkv, Skv, D] -> o [B, Hq, Sq, D], with grouped-query heads
(``kv_head = h // (Hq // Hkv)``, no repeated K/V), ``scale`` (1/sqrt(D)
by default), the causal offset ``q_idx + (Skv - Sq) >= k_idx``, the
padding of a ragged ``Skv``, the ``-1e30`` fill and the final
``max(l, 1e-30)``.  ``score_mod`` is not ported yet.

Its autograd formula recomputes ``ref.attention`` and takes its VJP, as
the reference's ``_attention_bwd`` does (``src/repro/kernels/ops.py:56-70``):
the JAX package has no attention backward kernel, so the backward is
plain ops on the card by the reference's own design.

``flash_attention(q, k, v, causal, scale)`` is the operator: on CPU
tensors it runs ``flash_attention_plain``, on CUDA tensors
``flash_attention_cuda`` (the kernel, or an error), on fake and meta
tensors its shape function.

``flash_decode(q, k_cache, v_cache, kv_len, scale)`` is the counterpart
of the TPU kernel ``flash_decode`` (``src/repro/kernels/flash_attention.py:161``):
one query row a (batch, head), q [B, Hq, D], against the first
``kv_len`` rows of caches [B, Hkv, S, D] (the whole cache when
``kv_len`` is None or at least S), the hand-written CUDA kernel
``csrc/flash_decode.cu`` on CUDA tensors, ``flash_decode_plain`` on CPU
tensors.  It has no autograd formula: the reference has none for the
decode path.
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


# --------------------------------------------------------------------------
# flash decode: one query row against a KV cache
# --------------------------------------------------------------------------
#: Head dims the decode kernel has instances for (Llama's 128; Granite's
#: and Zamba2's 64), and the most query heads that may share a KV head.
DECODE_HEAD_DIMS = (64, 128)
DECODE_MAX_GROUP = 8
#: Blocks the decode kernel's split pass aims for: about eight for each of
#: the H100's 132 SMs, so that B * Hkv * splits fills the card even at one
#: sequence; a split holds a multiple of ``DECODE_ROW_QUANTUM`` rows.
DECODE_TARGET_BLOCKS = 8 * 132
DECODE_ROW_QUANTUM = 64


def _check_decode_shapes(q, k_cache, v_cache) -> None:
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}; "
                         "want q [B, Hq, D] and caches [B, Hkv, S, D]")
    B, Hq, D = q.shape
    Bk, Hkv, S, Dk = k_cache.shape
    if Bk != B or Dk != D or Hkv == 0 or Hq % Hkv or S == 0:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} against caches "
                         f"{tuple(k_cache.shape)} (need Hq % Hkv == 0, S >= 1)")


def live_len(kv_len, S: int) -> int:
    """The rows attended: S for None, else ``kv_len`` capped at S (the
    reference's ``eff``); a ``kv_len`` below 1 is an error."""
    if kv_len is None:
        return S
    if int(kv_len) < 1:
        raise ValueError(f"flash_decode: kv_len {kv_len} < 1 attends no key")
    return min(int(kv_len), S)


def flash_decode_plain(q, k_cache, v_cache, kv_len: int | None = None,
                       scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the caches sliced to their
    live prefix, then ``ref.decode_attention``.  Rows inside ``kv_len``
    that were never written are attended as they stand (a zero key adds
    exp(-m) to the denominator), as in the reference."""
    _check_decode_shapes(q, k_cache, v_cache)
    eff = live_len(kv_len, k_cache.shape[2])
    return ref.decode_attention(q, k_cache[:, :, :eff], v_cache[:, :, :eff],
                                scale=scale)


def decode_splits(pairs: int, eff: int) -> tuple[int, int]:
    """(splits, rows a split) of ``eff`` cache rows for ``pairs`` (batch,
    KV head) pairs: about ``DECODE_TARGET_BLOCKS`` blocks in all, none
    empty."""
    want = max(1, -(-DECODE_TARGET_BLOCKS // pairs))
    per = -(-eff // want)
    rows = -(-per // DECODE_ROW_QUANTUM) * DECODE_ROW_QUANTUM
    return -(-eff // rows), rows


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernel can read it with float4 loads (last dimension
    contiguous, the base and every other stride 16-byte aligned), else a
    contiguous copy in storage of its own (aligned by the allocator)."""
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 4 == 0 for s in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_decode_cuda(q, k_cache, v_cache, kv_len: int | None = None,
                      scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA decode kernel (float32, D 64 or 128, at most 8
    query heads a KV head, on the current stream): the split pass, then
    the combine.  The caches are taken with their strides (a layer's view
    of the model's [n_layers, B, Hkv, S, D] buffer is not copied)."""
    _check_decode_shapes(q, k_cache, v_cache)
    dev = q.device
    if (dev.type != "cuda" or k_cache.device != dev
            or v_cache.device != dev):
        raise ValueError(f"flash_decode_cuda: q on {q.device}, caches on "
                         f"{k_cache.device}, {v_cache.device}; all must lie "
                         "on one CUDA device")
    if {q.dtype, k_cache.dtype, v_cache.dtype} != {torch.float32}:
        raise TypeError(f"flash_decode_cuda takes float32, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    B, Hq, D = q.shape
    Hkv = k_cache.shape[1]
    if D not in DECODE_HEAD_DIMS:
        raise ValueError(f"flash_decode_cuda: head dim {D}; the kernel has "
                         f"instances for {DECODE_HEAD_DIMS}")
    if Hq // Hkv > DECODE_MAX_GROUP:
        raise ValueError(f"flash_decode_cuda: {Hq // Hkv} query heads a KV "
                         f"head; the kernel takes at most {DECODE_MAX_GROUP}")
    eff = live_len(kv_len, k_cache.shape[2])
    q, k_cache, v_cache = (_aligned(t) for t in (q, k_cache, v_cache))
    splits, rows = decode_splits(B * Hkv, eff)
    part_acc = torch.empty(B, Hq, splits, D, dtype=torch.float32, device=dev)
    part_ml = torch.empty(B, Hq, splits, 2, dtype=torch.float32, device=dev)
    o = torch.empty(B, Hq, D, dtype=torch.float32, device=dev)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    _build.check(_decode_entry()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), o.data_ptr(),
        B, Hq, Hkv, D, eff, rows, splits, *q.stride()[:2],
        *k_cache.stride()[:3], *v_cache.stride()[:3], float(scale),
        torch.cuda.current_stream(dev).cuda_stream),
        "repro_flash_decode_f32")
    flash_decode_cuda.launches += 1
    return o


flash_decode_cuda.launches = 0  # kernel launches (plain runs excluded)


@functools.cache
def _decode_entry():
    fn = _build.library("flash_decode").repro_flash_decode_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@torch.library.custom_op("repro_torch::flash_decode", mutates_args=(),
                         device_types="cpu")
def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, kv_len: int | None = None,
                 scale: float | None = None) -> torch.Tensor:
    """o [B, Hq, D] = softmax(q k[:, :, :kv_len]^T scale) v[:, :, :kv_len]."""
    return flash_decode_plain(q, k_cache, v_cache, kv_len, scale)


@flash_decode.register_kernel("cuda")
def _(q, k_cache, v_cache, kv_len=None, scale=None):
    return flash_decode_cuda(q, k_cache, v_cache, kv_len, scale)


@flash_decode.register_fake
def _(q, k_cache, v_cache, kv_len=None, scale=None):
    _check_decode_shapes(q, k_cache, v_cache)
    live_len(kv_len, k_cache.shape[2])
    return q.new_empty(q.shape)
