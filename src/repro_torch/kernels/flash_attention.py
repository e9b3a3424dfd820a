"""Flash attention forward: the hand-written CUDA kernel
(``csrc/flash_attention.cu``), its plain PyTorch version, and the
``repro_torch::flash_attention`` operator.

The counterpart of ``flash_attention`` (the TPU kernel ``_attn_kernel``,
``src/repro/kernels/flash_attention.py:31,87``): q [B, Hq, Sq, D] and
k, v [B, Hkv, Skv, D] -> o [B, Hq, Sq, D], with grouped-query heads
(``kv_head = h // (Hq // Hkv)``, no repeated K/V), ``scale`` (1/sqrt(D)
by default), the causal offset ``q_idx + (Skv - Sq) >= k_idx``, the
padding of a ragged ``Skv``, the ``-1e30`` fill and the final
``max(l, 1e-30)``.  ``score_mod`` (the reference's, :44-51): a
``ScoreMod`` rewrites the scaled scores before the masks -- the graph's
own scale / bias / mask chain that compute-anchored stitching folds into
the kernel -- with a plain callable on the whole [B, H, Sq, Skv] score
tensor for CPU tensors and a generated instance of
``csrc/flash_attention.cuh`` for CUDA tensors.

Its autograd formula recomputes ``ref.attention`` and takes its VJP, as
the reference's ``_attention_bwd`` does (``src/repro/kernels/ops.py:56-70``):
the JAX package has no attention backward kernel, so the backward is
plain ops on the card by the reference's own design.

The kernel runs both products on the tensor cores through the
three-way TF32 split (``kernels/split_float.py``), in instances for
head dims 64, 80, 128 and 256 (``FLASH_HEAD_DIMS``; a D between two is
zero-padded up to the next, one above 256 raises).

``flash_attention(q, k, v, causal, scale)`` runs the operator
``repro_torch::flash_attention``: on CPU tensors ``flash_attention_plain``,
on CUDA tensors ``flash_attention_cuda`` (the kernel, or an error), on
fake and meta tensors its shape function.  With ``score_mod=`` it runs
the plain version or the generated kernel by device itself (forward
only, as stitched functions are; a custom operator takes no callable).

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

MAX_HEAD_DIM = 256
#: The kernel's constants, mirrored from ``csrc/flash_attention.cuh`` (a
#: test holds the two equal): query rows a block (``kBQ``), the head-dim
#: instances (a D between them is zero-padded up to the next), K/V rows a
#: tile (``kbk``), the largest D whose Q is split into registers
#: (``qreg``; above it Q sits in shared memory), and the row strides of
#: the K (and Q) and V tiles (``kstride``, ``vstride``).
FLASH_BQ = 64
FLASH_HEAD_DIMS = (64, 80, 128, 256)
FLASH_QREG_MAX_D = 80


def flash_instance(D: int) -> int:
    """The head-dim instance that runs a head dim of ``D``."""
    for dmax in FLASH_HEAD_DIMS:
        if D <= dmax:
            return dmax
    raise ValueError(f"flash attention: head dim {D} > {MAX_HEAD_DIM}")


def flash_kbk(D: int) -> int:
    """K/V rows a tile of the instance that runs ``D``: 32 where its Q
    tile takes shared memory, else 64."""
    return 64 if flash_instance(D) <= FLASH_QREG_MAX_D else 32


def flash_smem_bytes(D: int) -> int:
    """Shared memory of one block of the instance that runs ``D``: the K
    and V tiles of the two-stage ring (rows padded to D + 8 and D + 4
    floats) and, above ``FLASH_QREG_MAX_D``, the Q tile (``smem_floats``
    in ``csrc/flash_attention.cuh``)."""
    d = flash_instance(D)
    q = 0 if d <= FLASH_QREG_MAX_D else FLASH_BQ * (d + 8)
    return 4 * (2 * flash_kbk(D) * ((d + 8) + (d + 4)) + q)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernel can read it with float4 loads (last dimension
    contiguous, the base and every other stride 16-byte aligned), else a
    contiguous copy in storage of its own (aligned by the allocator)."""
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 4 == 0 for s in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


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


class ScoreMod:
    """A score chain for the kernel: ``plain(s, *score_args)`` maps the
    scaled [B, H, Sq, Skv] scores to the pre-softmax ones on whole
    tensors; ``entry`` is the C entry of its generated CUDA instance
    (``core.codegen_cuda.attention_source``).  ``launches`` counts the
    kernel launches of every scored instance."""

    launches = 0

    def __init__(self, plain, entry):
        self.plain = plain
        self.entry = entry


def _check_score_args(q, k, score_args) -> None:
    B, Hq, Sq, _ = q.shape
    extent = (B, Hq, Sq, k.shape[2])
    if k.shape[1] != Hq:
        raise ValueError("flash attention with a score_mod takes no "
                         "grouped-query heads (Hq == Hkv), as the "
                         "reference's anchored form")
    for a in score_args:
        if a.dim() != 4 or any(d not in (1, e)
                               for d, e in zip(a.shape, extent)):
            raise ValueError(f"score operand {tuple(a.shape)}: each dim 1 "
                             f"or the full extent {extent}")


def flash_attention_plain(q, k, v, causal: bool = True,
                          scale: float | None = None, *, score_mod=None,
                          score_args=()) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``ref.attention`` (all keys
    at once, the same -1e30 causal fill) on the shapes the kernel takes.
    Every query row sees a key, so the kernel's ``max(l, 1e-30)`` never
    binds and the two agree to rounding.  With ``score_mod`` the scaled
    scores pass through ``score_mod.plain`` before the causal mask, as in
    the kernel."""
    _check_shapes(q, k, v, causal)
    if score_mod is None:
        return ref.attention(q, k, v, causal=causal, scale=scale)
    _check_score_args(q, k, score_args)
    Sq, Skv, D = q.shape[2], k.shape[2], q.shape[3]
    sc = 1.0 / math.sqrt(D) if scale is None else scale
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32)
                     .transpose(-1, -2)) * sc
    s = score_mod.plain(s, *score_args).to(torch.float32)
    if causal:
        row = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        col = torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(row >= col, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.to(torch.float32)).to(q.dtype)


def flash_attention_cuda(q, k, v, causal: bool = True,
                         scale: float | None = None, *, score_mod=None,
                         score_args=()) -> torch.Tensor:
    """Launch the CUDA kernel (float32, D <= 256, on the current stream):
    the identity instance of ``csrc/flash_attention.cu``, or with
    ``score_mod`` its generated instance, whose score operands are read
    through 4D strides (0 on each dim of extent 1).  q, k, v are taken
    with their strides; a tensor the kernel cannot read with 16-byte
    copies (a last dimension that is not contiguous, an unaligned stride
    or base) is copied, and a head dim between two instances is
    zero-padded up to the next (device time)."""
    _check_shapes(q, k, v, causal)
    if score_mod is not None:
        _check_score_args(q, k, score_args)
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
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    Dp = flash_instance(D)
    if Dp != D:  # zero dims add nothing to q k^T; o's are cut off below
        q, k, v = (torch.nn.functional.pad(t, (0, Dp - D))
                   for t in (q, k, v))
    q, k, v = (_aligned(t) for t in (q, k, v))
    o = torch.empty(B, Hq, Sq, Dp, dtype=torch.float32, device=dev)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, Hq, Hkv, Sq, Skv, Dp, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], float(scale), int(causal))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if score_mod is None:
        _build.check(_entry()(*args, stream), "repro_flash_attention_f32")
        flash_attention_cuda.launches += 1
        return o if Dp == D else o[..., :D]
    if any(a.device != dev or a.dtype not in (torch.float32, torch.bool)
           for a in score_args):
        raise TypeError("flash_attention_cuda: score operands must be "
                        f"float32 or bool on {dev}")
    ins = (ctypes.c_void_p * max(1, len(score_args)))(
        *[a.data_ptr() for a in score_args])
    st = (ctypes.c_longlong * max(4, 4 * len(score_args)))(
        *[s if d != 1 else 0 for a in score_args
          for s, d in zip(a.stride(), a.shape)])
    _build.check(score_mod.entry(*args, ins, st, stream),
                 "repro_flash_scored")
    ScoreMod.launches += 1
    return o if Dp == D else o[..., :D]


flash_attention_cuda.launches = 0  # identity-instance launches


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
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """o [B, Hq, Sq, D] = softmax(mask(q k^T scale)) v."""
    return flash_attention_plain(q, k, v, causal, scale)


@_flash_attention_op.register_kernel("cuda")
def _(q, k, v, causal=True, scale=None):
    return flash_attention_cuda(q, k, v, causal, scale)


def flash_attention(q, k, v, causal: bool = True, scale: float | None = None,
                    *, score_mod: ScoreMod | None = None,
                    score_args=()) -> torch.Tensor:
    """o [B, Hq, Sq, D] = softmax(mask(score_mod(q k^T scale))) v: the
    operator (differentiable) without ``score_mod``; with it (forward
    only) the plain version on CPU tensors, the generated kernel on CUDA
    tensors."""
    if score_mod is None:
        return _flash_attention_op(q, k, v, causal, scale)
    devs = {t.device.type for t in (q, k, v, *score_args)}
    if devs == {"cpu"}:
        return flash_attention_plain(q, k, v, causal, scale,
                                     score_mod=score_mod,
                                     score_args=score_args)
    if devs != {"cuda"}:
        raise ValueError(f"flash_attention: tensors on {sorted(devs)}; all "
                         "must lie on the CPU or on CUDA")
    return flash_attention_cuda(q, k, v, causal, scale, score_mod=score_mod,
                                score_args=score_args)


@_flash_attention_op.register_fake
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


_flash_attention_op.register_autograd(_backward,
                                      setup_context=_setup_context)


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
