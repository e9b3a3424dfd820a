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

The kernel runs both products on the tensor cores, in instances for
head dims 64, 80, 128 and 256 (``FLASH_HEAD_DIMS``; a D between two is
zero-padded up to the next): float32 operands through the three-way
TF32 split (``kernels/split_float.py``), bfloat16 ones as Hopper's
native bfloat16 products (``mma.sync.m16n8k16``; q k^T one product, p v
two, p split into bfloat16 hi and lo: ``split_float.bf16_pair``).  A
head dim above 256 runs on a kernel of its own,
``csrc/flash_attention_wide.cuh`` (``flash_attention_wide_cuda``: the
same products on the tensor cores, 8 warps a 64-row query tile that
compute the scores once for every output column, K and V streamed in
64-column chunks by cp.async; instances 320, 384, 448 and 512, a D below
one read in place, above 512 output tiles of 512 columns; float32 or
bfloat16), as the reference's kernel has no ceiling on D.  Its identity
instance is ``csrc/flash_attention_wide.cu``; a score chain above 256 gets a
generated instance of the wide template, as one up to 256 gets one of
``csrc/flash_attention.cuh`` (``ScoreMod.wide``; its launches count in
``WIDE_SCORE_MOD``).

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
tensors.  The kernel has instances for head dims 64, 128, 256, 384 and
512 and takes at most 8 query heads a KV head a launch (4 above 256,
``decode_max_group``): a D between two instances runs on the next, its
columns masked at D (``decode_padded`` zero-pads only a D that is not a
multiple of 4; the scale stays that of the true D), ``decode_by_subgroups``
runs a larger group as sub-groups, one launch each (``decode_subgroups``
is the plan), and a D above 512 runs on its tiled kernel, which stages q
in shared memory and cuts the output into tiles of 512 columns.  Every D
splits the cache over blocks and reads each K/V row once a sub-group.
Where q and both caches are bfloat16 at a head dim of 64, 128 or 256 it
runs a native bfloat16 kernel instead (``flash_decode_bf16_kernel``:
FlashDecoding on the tensor cores, the query heads of a KV head on the
n8 side of ``mma.sync`` bf16, K/V tiles through a ``cp.async`` ring, one
resident wave of blocks, ``native_decode_splits``).  It has no autograd
formula: the reference has none for the decode path.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build, ref, widen

#: The largest head dim of the tuned instances; above it the wide kernel.
MAX_HEAD_DIM = 256
#: The types every attention kernel takes (float32 inside: scores,
#: softmax, sums); float16 and mixes of q, k and v are widened to float32
#: first (``widen``), as the reference's kernel widens its blocks.
CUDA_DTYPES = widen.KERNEL_DTYPES
#: The kernel's constants, mirrored from ``csrc/flash_attention.cuh`` (a
#: test holds the two equal): query rows a block (``kBQ``), the head-dim
#: instances (a D between them is zero-padded up to the next), K/V rows a
#: tile (``kbk``), the largest D whose Q is split into registers
#: (``qreg``; above it Q sits in shared memory), and the row strides of
#: the K (and Q) and V tiles (``kstride``, ``vstride``).
FLASH_BQ = 64
FLASH_HEAD_DIMS = (64, 80, 128, 256)
FLASH_QREG_MAX_D = 80
#: The bfloat16 instances' own tiles (``kBf16Warps``, ``bf16_kbk`` in the
#: source): query rows a block (16 a warp), K/V rows a tile by head dim
#: (64 up to ``FLASH_BF16_KBK_MAX_D``, else 32), every row padded by 8
#: values.
FLASH_BF16_BQ = 64
FLASH_BF16_KBK_MAX_D = 80
#: The wide kernel's constants (``csrc/flash_attention_wide.cu``; a test
#: holds the two equal): query rows a block (``kBQ``), keys a K/V tile
#: (``kBK``), head-dim columns a staged chunk (``kDC``), the largest
#: output tile (``kDT``; above it the output's head dim is cut into tiles
#: of ``kDT`` columns), the ring's stages (``kStages``), and its head-dim
#: instances (a D runs on the first at or above it, its columns past D
#: zero-filled as they are copied).
WIDE_BQ, WIDE_BK, WIDE_DC, WIDE_DT, WIDE_STAGES = 64, 64, 64, 512, 3
WIDE_HEAD_DIMS = (320, 384, 448, 512)


def flash_instance(D: int) -> int | None:
    """The tuned head-dim instance that runs a head dim of ``D``, or None
    above ``MAX_HEAD_DIM``: the wide kernel runs that D
    (``wide_instance``)."""
    for dmax in FLASH_HEAD_DIMS:
        if D <= dmax:
            return dmax
    return None


def wide_instance(D: int) -> tuple[int, int]:
    """(output columns a block, output tiles) of the wide kernel at a head
    dim ``D`` above ``MAX_HEAD_DIM``: up to ``WIDE_DT`` the first instance
    at or above D and one tile (the Q tile resident), above it
    ``WIDE_DT``-column tiles."""
    for dmax in WIDE_HEAD_DIMS:
        if D <= dmax:
            return dmax, 1
    return WIDE_DT, -(-D // WIDE_DT)


def flash_kbk(D: int, itemsize: int = 4) -> int:
    """K/V rows a tile of the kernel that runs ``D`` on operands of
    ``itemsize`` bytes: in float32 32 where the tuned instance's Q tile
    takes shared memory, else 64; in bfloat16 64 up to
    ``FLASH_BF16_KBK_MAX_D``, else 32; the wide kernel's 64."""
    d = flash_instance(D)
    if d is None:
        return WIDE_BK
    if itemsize == 2:
        return 64 if d <= FLASH_BF16_KBK_MAX_D else 32
    return 64 if d <= FLASH_QREG_MAX_D else 32


def flash_smem_bytes(D: int, itemsize: int = 4) -> int:
    """Shared memory of one block of the kernel that runs ``D`` on
    operands of ``itemsize`` bytes (4, float32; 2, bfloat16).  A tuned
    float32 instance: the K and V tiles of the two-stage ring (rows padded
    to D + 8 and D + 4 floats) and, above ``FLASH_QREG_MAX_D``, the Q tile
    (``smem_bytes`` in ``csrc/flash_attention.cuh``); a bfloat16 one
    (``smem_bytes_bf16``): the Q tile and the two-stage K and V tiles, rows
    of D + 8 values.  Above ``MAX_HEAD_DIM`` the wide kernel's
    (``smem_floats``, ``smem_bytes_bf16`` in its source): up to
    ``WIDE_DT`` its Q tile (rows of D + 8 values), the ring of K/V chunks
    (rows of ``WIDE_DC`` + 8), p (float32 rows of ``WIDE_BK`` + 4, or two
    bfloat16 planes of rows of ``WIDE_DC`` + 8) and the float32 exchange
    of the rows' max and sum; above it no Q tile, and each stage also
    holds a chunk of Q."""
    d = flash_instance(D)
    if d is None:
        (dt, tiles), ld = wide_instance(D), WIDE_DC + 8
        qres = tiles == 1
        tiles_vals = ((WIDE_BQ * (dt + 8) if qres else 0)
                      + WIDE_STAGES * (WIDE_BK + (0 if qres else WIDE_BQ))
                      * ld)
        if itemsize == 2:
            return 2 * (tiles_vals + 2 * WIDE_BQ * ld) + 4 * 2 * 2 * WIDE_BQ
        return 4 * (tiles_vals + WIDE_BQ * (WIDE_BK + 4) + 2 * 2 * WIDE_BQ)
    if itemsize == 2:
        return 2 * (d + 8) * (FLASH_BF16_BQ + 4 * flash_kbk(D, itemsize))
    q = 0 if d <= FLASH_QREG_MAX_D else FLASH_BQ * (d + 8)
    return 4 * (2 * flash_kbk(D) * ((d + 8) + (d + 4)) + q)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernel can read it with 16-byte loads (last dimension
    contiguous, the base and every other stride 16-byte aligned), else a
    contiguous copy in storage of its own (aligned by the allocator)."""
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * t.element_size() % 16 == 0
                    for s in t.stride()[:-1])):
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
    (``core.codegen_cuda.attention_source``): of the tuned template
    (``csrc/flash_attention.cuh``), or with ``wide`` of the wide one, for
    head dims above ``MAX_HEAD_DIM``.  ``launches`` counts the kernel
    launches of every scored instance of the tuned template,
    ``WIDE_SCORE_MOD.launches`` those of the wide one."""

    launches = 0

    def __init__(self, plain, entry, wide: bool = False):
        self.plain = plain
        self.entry = entry
        self.wide = wide


#: launches of the wide kernel's scored instances
WIDE_SCORE_MOD = _build.LaunchCount("flash_wide_score_mod")
#: launches of the wide kernel's bfloat16 instances (identity and scored)
WIDE_BF16 = _build.LaunchCount("flash_wide_bf16")
#: launches of the bfloat16 instances (counted in ``flash_attention_cuda``,
#: ``ScoreMod`` and ``flash_decode_cuda`` too): the identity instance, the
#: scored ones, and the split decode kernel with a bfloat16 q or cache
#: (the native bfloat16 decode kernel has ``DECODE_NATIVE_BF16``)
BF16 = _build.LaunchCount("flash_attention_bf16")
SCORE_MOD_BF16 = _build.LaunchCount("flash_score_mod_bf16")
DECODE_BF16 = _build.LaunchCount("flash_decode_bf16")


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
    the kernel.  bfloat16 operands compute in float32 and the output
    rounds to q's type, as in the kernel (the reference's widens its
    blocks to float32, ``o_ref.dtype`` q's); float64 ones (a check's
    reference) stay float64."""
    _check_shapes(q, k, v, causal)
    if score_mod is None:
        wide = torch.promote_types(q.dtype, torch.float32)
        return ref.attention(q.to(wide), k.to(wide), v.to(wide),
                             causal=causal, scale=scale).to(q.dtype)
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
    """Launch the CUDA kernel (on the current stream; q, k, v all float32
    or all bfloat16, else -- float16, a mix -- each widened to float32
    first; float32 inside, the output in q's type): the
    identity instance of ``csrc/flash_attention.cu``, or with
    ``score_mod`` its generated instance, whose score operands are read
    through 4D strides (0 on each dim of extent 1).  q, k, v are taken
    with their strides; a tensor the kernel cannot read with 16-byte
    copies (a last dimension that is not contiguous, an unaligned stride
    or base) is copied, and a head dim between two instances is
    zero-padded up to the next (device time).  A head dim above
    ``MAX_HEAD_DIM`` runs on the wide kernel (``flash_attention_wide_cuda``),
    with ``score_mod`` on its generated wide instance."""
    _check_shapes(q, k, v, causal)
    if score_mod is not None:
        _check_score_args(q, k, score_args)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention_cuda: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}; all must lie on one "
                         "CUDA device")
    widen.check("flash_attention_cuda", {"q": q, "k": k, "v": v})
    if len({q.dtype, k.dtype, v.dtype}) != 1 or q.dtype not in CUDA_DTYPES:
        # float16, or a mix: the float32 instance, o in q's type
        return widen.to(flash_attention_cuda(
            *widen.one_type(q, k, v), causal, scale, score_mod=score_mod,
            score_args=score_args), q.dtype)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if score_mod is not None and score_mod.wide != (D > MAX_HEAD_DIM):
        raise ValueError(f"flash_attention_cuda: head dim {D} against a "
                         f"score_mod instance of the "
                         f"{'wide' if score_mod.wide else 'tuned'} kernel")
    if D > MAX_HEAD_DIM:
        return flash_attention_wide_cuda(q, k, v, causal, scale,
                                         score_mod=score_mod,
                                         score_args=score_args)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    Dp = flash_instance(D)
    if Dp != D:  # zero dims add nothing to q k^T; o's are cut off below
        q, k, v = (torch.nn.functional.pad(t, (0, Dp - D))
                   for t in (q, k, v))
    q, k, v = (_aligned(t) for t in (q, k, v))
    o = torch.empty(B, Hq, Sq, Dp, dtype=q.dtype, device=dev)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, Hq, Hkv, Sq, Skv, Dp, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], float(scale), int(causal))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if score_mod is None:
        _build.check(_entry()(*args, int(q.dtype == torch.bfloat16), stream),
                     "repro_flash_attention")
        _build.count(flash_attention_cuda)
        if q.dtype == torch.bfloat16:
            _build.count(BF16)
        return o if Dp == D else o[..., :D]
    _build.check(score_mod.entry(*args, *_score_operands(score_args, dev),
                                 stream), "repro_flash_scored")
    _build.count(ScoreMod)
    if q.dtype == torch.bfloat16:
        _build.count(SCORE_MOD_BF16)
    return o if Dp == D else o[..., :D]


def _score_operands(score_args, dev) -> tuple:
    """(pointers, 4D element strides: 0 on each dim of extent 1) of the
    score operands, as a generated instance's C entry takes them."""
    if any(a.device != dev or a.dtype not in (torch.float32, torch.bfloat16,
                                              torch.bool)
           for a in score_args):
        raise TypeError("flash attention: score operands must be float32, "
                        f"bfloat16 or bool on {dev}")
    ins = (ctypes.c_void_p * max(1, len(score_args)))(
        *[a.data_ptr() for a in score_args])
    st = (ctypes.c_longlong * max(4, 4 * len(score_args)))(
        *[s if d != 1 else 0 for a in score_args
          for s, d in zip(a.stride(), a.shape)])
    return ins, st


flash_attention_cuda.launches = 0  # identity-instance launches


def flash_attention_wide_cuda(q, k, v, causal: bool = True,
                              scale: float | None = None, *, score_mod=None,
                              score_args=()) -> torch.Tensor:
    """Launch the wide kernel (``csrc/flash_attention_wide.cuh``: head
    dims above ``MAX_HEAD_DIM`` on the tensor cores, q, k, v all float32
    or all bfloat16, else each widened to float32 first, the output in q's
    type; on the current stream): its
    identity instance (``csrc/flash_attention_wide.cu``), or with
    ``score_mod`` its generated wide instance, whose score operands are
    read through 4D strides.  q, k, v are taken with their strides and
    read in place (the kernel zero-fills the columns past D of its
    instance); only a D that is not a multiple of 4 (8 in bfloat16; no
    config has one) is zero-padded up to one, and a tensor the kernel
    cannot read with 16-byte copies is copied.  Its bfloat16 launches
    also count in ``WIDE_BF16``."""
    _check_shapes(q, k, v, causal)
    if score_mod is not None:
        _check_score_args(q, k, score_args)
        if not score_mod.wide:
            raise ValueError("flash_attention_wide_cuda: a score_mod "
                             "instance of the tuned kernel")
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention_wide_cuda: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}; all must lie on one "
                         "CUDA device")
    widen.check("flash_attention_wide_cuda", {"q": q, "k": k, "v": v})
    if len({q.dtype, k.dtype, v.dtype}) != 1 or q.dtype not in CUDA_DTYPES:
        return widen.to(flash_attention_wide_cuda(
            *widen.one_type(q, k, v), causal, scale, score_mod=score_mod,
            score_args=score_args), q.dtype)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_wide_cuda: head dim {D}; the "
                         f"wide kernel takes those above {MAX_HEAD_DIM}")
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    bf16 = q.dtype == torch.bfloat16
    unit = 8 if bf16 else 4  # values a 16-byte copy
    Dp = -(-D // unit) * unit
    if Dp != D:  # zero dims add nothing to q k^T; o's are cut off below
        q, k, v = (torch.nn.functional.pad(t, (0, Dp - D))
                   for t in (q, k, v))
    q, k, v = (_aligned(t) for t in (q, k, v))
    o = torch.empty(B, Hq, Sq, Dp, dtype=q.dtype, device=dev)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Hq,
            Hkv, Sq, Skv, Dp, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], float(scale), int(causal))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if score_mod is None:
        _build.check(_wide_entry()(*args, int(bf16), stream),
                     "repro_flash_wide_attention")
        _build.count(flash_attention_wide_cuda)
    else:
        _build.check(score_mod.entry(*args, *_score_operands(score_args,
                                                             dev), stream),
                     "repro_flash_scored")
        _build.count(WIDE_SCORE_MOD)
    if bf16:
        _build.count(WIDE_BF16)
    return o if Dp == D else o[..., :D]


flash_attention_wide_cuda.launches = 0  # kernel launches (plain excluded)


def _bind_flagged(fn):
    """``fn`` bound as the attention entries that take a bfloat16 flag
    before the stream."""
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _entry():
    return _bind_flagged(
        _build.library("flash_attention").repro_flash_attention)


@functools.cache
def _wide_entry():
    return _bind_flagged(
        _build.library("flash_attention_wide").repro_flash_wide_attention)


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
#: Head dims the decode kernel has instances for (Granite's and Zamba2's
#: 64, Llama's 128, Gemma-7B's 256, and 384 and 512; a D between two runs
#: on the next, its columns masked at D), the output columns a block of
#: its tiled kernel takes above the largest instance, and the most query
#: heads a KV head one launch takes up to 256 (``decode_max_group`` gives
#: it by D; a larger group runs as sub-groups, one launch each).
DECODE_HEAD_DIMS = (64, 128, 256, 384, 512)
DECODE_TILE = 512
DECODE_MAX_GROUP = 8
#: The most query heads a launch takes above 256 (registers: a lane holds
#: q and acc of every head in 3 or 4 float4 each), and the shared memory
#: one block of the tiled kernel may take (``tiled_smem_bytes`` in
#: ``csrc/flash_decode.cu``).
DECODE_MAX_GROUP_WIDE = 4
DECODE_SMEM_LIMIT = 232_448
#: Blocks the decode kernel's split pass aims for: about eight for each of
#: the H100's 132 SMs, so that B * Hkv * splits fills the card even at one
#: sequence; a split holds a multiple of ``DECODE_ROW_QUANTUM`` rows.
DECODE_TARGET_BLOCKS = 8 * 132
DECODE_ROW_QUANTUM = 64
#: Head dims of the native bfloat16 kernel (``flash_decode_bf16_kernel``:
#: q and both caches bfloat16, products on the tensor cores); every other
#: case keeps the kernels above.
DECODE_NATIVE_HEAD_DIMS = (64, 128, 256)
#: Launches of the native bfloat16 kernel (counted in ``flash_decode_cuda``
#: too)
DECODE_NATIVE_BF16 = _build.LaunchCount("flash_decode_native_bf16")


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
    live prefix, then ``ref.decode_attention``, float32 inside and the
    output in q's type (the reference's kernel: its operands widened to
    float32, ``o_ref.dtype`` q's; float64 stays float64).  Rows inside
    ``kv_len`` that were never written are attended as they stand (a
    zero key adds exp(-m) to the denominator), as in the reference."""
    _check_decode_shapes(q, k_cache, v_cache)
    eff = live_len(kv_len, k_cache.shape[2])
    wide = torch.promote_types(torch.promote_types(q.dtype, k_cache.dtype),
                               torch.float32)
    return ref.decode_attention(q.to(wide), k_cache[:, :, :eff].to(wide),
                                v_cache[:, :, :eff].to(wide),
                                scale=scale).to(q.dtype)


def decode_splits(pairs: int, eff: int) -> tuple[int, int]:
    """(splits, rows a split) of ``eff`` cache rows for ``pairs`` (batch,
    KV head) pairs: about ``DECODE_TARGET_BLOCKS`` blocks in all, none
    empty."""
    want = max(1, -(-DECODE_TARGET_BLOCKS // pairs))
    per = -(-eff // want)
    rows = -(-per // DECODE_ROW_QUANTUM) * DECODE_ROW_QUANTUM
    return -(-eff // rows), rows


def native_decode_splits(pairs: int, eff: int,
                         resident: int) -> tuple[int, int]:
    """(splits, rows a split) of ``eff`` cache rows for ``pairs`` (batch,
    KV head) pairs on the native bfloat16 kernel, ``resident`` of whose
    blocks the card holds at once: B Hkv splits fills whole resident
    waves (the fewest that hold every pair), no tail wave; a split holds a
    multiple of ``DECODE_ROW_QUANTUM`` rows, none empty."""
    waves = max(1, -(-pairs // max(1, resident)))
    want = max(1, waves * resident // pairs)
    per = -(-eff // want)
    rows = -(-per // DECODE_ROW_QUANTUM) * DECODE_ROW_QUANTUM
    return -(-eff // rows), rows


def native_decode(q, k_cache, v_cache) -> bool:
    """Whether the native bfloat16 kernel runs a decode call: q and both
    caches bfloat16 at a head dim of ``DECODE_NATIVE_HEAD_DIMS``."""
    return (q.dtype == k_cache.dtype == v_cache.dtype == torch.bfloat16
            and q.shape[-1] in DECODE_NATIVE_HEAD_DIMS)


def decode_instance(D: int) -> int | None:
    """The decode kernel's head-dim instance that runs ``D`` (its columns
    masked at D), or None above the largest: the tiled kernel runs it, its
    output cut into tiles of ``DECODE_TILE`` columns."""
    for dmax in DECODE_HEAD_DIMS:
        if D <= dmax:
            return dmax
    return None


def decode_width(D: int) -> int:
    """Columns of the decode kernel's partials at head dim ``D``: its
    instance's, or above the largest its tiles'."""
    return decode_instance(D) or -(-D // DECODE_TILE) * DECODE_TILE


def decode_tiled_smem_bytes(D: int, G: int) -> int:
    """Shared memory of one block of the tiled kernel (D above the largest
    instance) at ``G`` query heads: q (D rounded up to 128 floats), the
    four warps' (m, l) and a tile of accumulators a warp and head."""
    return 4 * G * (-(-D // 128) * 128 + 2 * 4 + 4 * DECODE_TILE)


def decode_max_group(D: int) -> int:
    """The most query heads a KV head one launch takes at head dim ``D``:
    ``DECODE_MAX_GROUP`` up to 256, ``DECODE_MAX_GROUP_WIDE`` above, and
    above the largest instance no more than one block's shared memory
    holds (``decode_tiled_smem_bytes``); a head dim whose one head does not
    fit raises."""
    if D <= 256:
        return DECODE_MAX_GROUP
    g = DECODE_MAX_GROUP_WIDE
    if decode_instance(D) is None:
        while g and decode_tiled_smem_bytes(D, g) > DECODE_SMEM_LIMIT:
            g -= 1
        if not g:
            raise ValueError(f"flash_decode: head dim {D}: one query head's "
                             "state exceeds a block's shared memory")
    return g


def decode_subgroups(G: int, D: int) -> list[tuple[int, int]]:
    """The launches of ``G`` query heads a KV head at head dim ``D``: (first
    head, heads) of each sub-group within the group, the fewest of at most
    ``decode_max_group(D)`` heads, as even as they come.  Sub-group (f, n)
    runs query heads ``j G + f .. j G + f + n - 1`` of every KV head j."""
    n = -(-G // decode_max_group(D))
    base, extra = divmod(G, n)
    plan, first = [], 0
    for i in range(n):
        size = base + (i < extra)
        plan.append((first, size))
        first += size
    return plan


def decode_by_subgroups(q, k_cache, v_cache, eff: int, scale: float,
                        run) -> torch.Tensor:
    """o [B, Hq, D]: ``run(qs, k_cache, v_cache, eff, scale, os)`` once a
    sub-group of ``decode_subgroups``, with ``qs`` and ``os`` the
    [B, Hkv, n, D] views of q and o that hold the sub-group's heads of
    every KV head (strided: not copied)."""
    B, Hq, D = q.shape
    Hkv = k_cache.shape[1]
    G = Hq // Hkv
    o = torch.empty(B, Hq, D, dtype=q.dtype, device=q.device)
    q4, o4 = q.unflatten(1, (Hkv, G)), o.view(B, Hkv, G, D)
    for first, n in decode_subgroups(G, D):
        run(q4[:, :, first:first + n], k_cache, v_cache, eff, scale,
            o4[:, :, first:first + n])
    return o


def decode_padded(q, k_cache, v_cache, kv_len, scale, run) -> torch.Tensor:
    """``run(q, k, v, eff, scale)`` at the default scale 1/sqrt(D) of the
    true D.  The decode kernel reads a head dim that is a multiple of 4
    (8 for a bfloat16 cache) in place (its instance masks the columns at
    D; above the largest instance the tiled kernel masks its last tile),
    so the caches pass through as they are; another D (no config has one)
    is zero-padded up to the next multiple, which its 16-byte loads need,
    and the result cut back to D.  Zero columns add nothing to q k^T, so
    the padded call computes the same function; only the live prefix of
    the caches is padded (a copy, device time)."""
    eff = live_len(kv_len, k_cache.shape[2])
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    unit = 8 if k_cache.dtype == torch.bfloat16 else 4
    if D % unit == 0:
        return run(q, k_cache, v_cache, eff, scale)
    pad = (0, -D % unit)
    q, k_cache, v_cache = (torch.nn.functional.pad(t, pad) for t in (
        q, k_cache[:, :, :eff], v_cache[:, :, :eff]))
    return run(q, k_cache, v_cache, eff, scale)[..., :D]


def flash_decode_cuda(q, k_cache, v_cache, kv_len: int | None = None,
                      scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA decode kernel (on the current stream; q float32 or
    bfloat16, the two caches float32 or bfloat16 on their own, float32
    inside, the output in q's type): the split pass, then the combine,
    once a sub-group of at most ``decode_max_group(D)`` query heads a KV
    head, on the head-dim instance that holds D, or above the largest on
    the tiled kernel (``decode_padded``).  q and both caches bfloat16 at a
    head dim of ``DECODE_NATIVE_HEAD_DIMS`` take the native bfloat16
    kernel (``native_decode``).  The caches are taken with their strides
    (a layer's view of the model's [n_layers, B, Hkv, S, D] buffer is not
    copied).  A float16 q, or float16 caches or caches of two types, are
    widened to float32 first (the caches' live prefix only)."""
    _check_decode_shapes(q, k_cache, v_cache)
    dev = q.device
    if (dev.type != "cuda" or k_cache.device != dev
            or v_cache.device != dev):
        raise ValueError(f"flash_decode_cuda: q on {q.device}, caches on "
                         f"{k_cache.device}, {v_cache.device}; all must lie "
                         "on one CUDA device")
    widen.check("flash_decode_cuda", {"q": q, "k_cache": k_cache,
                                      "v_cache": v_cache})
    if (q.dtype not in CUDA_DTYPES or k_cache.dtype not in CUDA_DTYPES
            or v_cache.dtype != k_cache.dtype):
        eff = live_len(kv_len, k_cache.shape[2])
        kc, vc = widen.one_type(k_cache[:, :, :eff], v_cache[:, :, :eff])
        return widen.to(flash_decode_cuda(widen.own(q), kc, vc, None,
                                          scale), q.dtype)
    return decode_padded(q, k_cache, v_cache, kv_len, scale, _decode_run)


def _decode_run(q, k_cache, v_cache, eff: int, scale: float) -> torch.Tensor:
    q, k_cache, v_cache = (_aligned(t) for t in (q, k_cache, v_cache))
    launch = (_decode_native_launch if native_decode(q, k_cache, v_cache)
              else _decode_launch)
    return decode_by_subgroups(q, k_cache, v_cache, eff, scale, launch)


def _decode_args(qs, k_cache, v_cache, eff: int, scale: float, os,
                 splits: int, rows: int) -> tuple:
    """The C entries' arguments up to the scale, and the partials (kept
    alive by the caller until the launch is queued)."""
    B, Hkv, n, D = qs.shape
    part_acc = torch.empty(B, Hkv * n, splits, decode_width(D),
                           dtype=torch.float32, device=qs.device)
    part_ml = torch.empty(B, Hkv * n, splits, 2, dtype=torch.float32,
                          device=qs.device)
    return (part_acc, part_ml), (
        qs.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), os.data_ptr(),
        B, n, Hkv, D, eff, rows, splits, *qs.stride()[:3], *os.stride()[:3],
        *k_cache.stride()[:3], *v_cache.stride()[:3], float(scale))


def _decode_launch(qs, k_cache, v_cache, eff: int, scale: float, os) -> None:
    """One launch pair of the decode kernel for the sub-group views ``qs``
    and ``os`` [B, Hkv, n, D] (their strides passed as they are)."""
    B, Hkv = qs.shape[:2]
    splits, rows = decode_splits(B * Hkv, eff)
    _parts, args = _decode_args(qs, k_cache, v_cache, eff, scale, os,
                                splits, rows)
    _build.check(_decode_entry()(
        *args, int(qs.dtype == torch.bfloat16),
        int(k_cache.dtype == torch.bfloat16),
        torch.cuda.current_stream(qs.device).cuda_stream),
        "repro_flash_decode")
    _build.count(flash_decode_cuda)
    if torch.bfloat16 in (qs.dtype, k_cache.dtype):
        _build.count(DECODE_BF16)


def _decode_native_launch(qs, k_cache, v_cache, eff: int, scale: float,
                          os) -> None:
    """One launch pair of the native bfloat16 kernel for the sub-group
    views ``qs`` and ``os`` [B, Hkv, n, D], split to fill whole resident
    waves (``native_decode_splits``)."""
    B, Hkv, n, D = qs.shape
    splits, rows = native_decode_splits(
        B * Hkv, eff, _native_resident(qs.device.index or 0, D, n))
    _parts, args = _decode_args(qs, k_cache, v_cache, eff, scale, os,
                                splits, rows)
    _build.check(_native_entry()(
        *args, torch.cuda.current_stream(qs.device).cuda_stream),
        "repro_flash_decode_bf16")
    _build.count(flash_decode_cuda)
    _build.count(DECODE_NATIVE_BF16)


flash_decode_cuda.launches = 0  # kernel launches (plain runs excluded)

_DECODE_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                    + [ctypes.c_longlong] * 12 + [ctypes.c_float])


@functools.cache
def _decode_entry():
    fn = _build.library("flash_decode").repro_flash_decode
    fn.argtypes = _DECODE_ARGTYPES + [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _native_entry():
    fn = _build.library("flash_decode").repro_flash_decode_bf16
    fn.argtypes = _DECODE_ARGTYPES + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _native_resident(device: int, D: int, G: int) -> int:
    """Blocks of the native kernel at (D, G) that ``device`` holds at
    once (its occupancy, asked once)."""
    fn = _build.library("flash_decode").repro_flash_decode_bf16_blocks
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(fn(D, G, ctypes.byref(blocks)),
                     "repro_flash_decode_bf16_blocks")
    return blocks.value


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
