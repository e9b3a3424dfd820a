"""Public wrappers over the hand-written kernels, with the reference's
switch (``src/repro/kernels/ops.py:37,43,49,73,80,119``).

``use_kernels=False`` (``fusion_mode="xla"`` at the model level) routes to
the plain oracles in ``ref.py``.  ``use_kernels=True`` calls the
``repro_torch::`` operators: on CUDA tensors they launch the CUDA
kernels, on CPU tensors they run the kernels' plain versions.  Each
operator carries the reference's autograd formula: the LayerNorm and
softmax backwards are kernels of their own (``repro_torch::layernorm_bwd``,
``repro_torch::softmax_bwd``), the RMSNorm, attention and SSD scan
backwards are plain ops, as in the JAX package; ``flash_decode`` has no
backward, as the reference's decode path has none.
"""
from __future__ import annotations

import torch

from . import ref
from .flash_attention import flash_attention, flash_decode
from .layernorm import layernorm as _layernorm
from .rmsnorm import rmsnorm as _rmsnorm
from .softmax import softmax as _softmax
from .ssd_scan import ssd_scan as _ssd_scan


def layernorm(x, gamma, beta, eps: float = 1e-6, *, use_kernels: bool = True):
    if use_kernels:
        return _layernorm(x, gamma, beta, eps)[0]
    return ref.layernorm(x, gamma, beta, eps)


def rmsnorm(x, gamma, eps: float = 1e-6, *, use_kernels: bool = True):
    if use_kernels:
        return _rmsnorm(x, gamma, eps)[0]
    return ref.rmsnorm(x, gamma, eps)


def softmax(x, *, use_kernels: bool = True):
    """The softmax over the last axis (the MoE router's)."""
    if use_kernels:
        return _softmax(x)
    return ref.softmax(x)


def attention(q, k, v, *, causal: bool = True, scale=None,
              use_kernels: bool = True):
    if use_kernels:
        return flash_attention(q, k, v, causal, scale)
    return ref.attention(q, k, v, causal=causal, scale=scale)


def decode_attention(q, k_cache, v_cache, *, kv_len=None, scale=None,
                     use_kernels: bool = True):
    """q [B, Hq, D] against caches [B, Hkv, S, D].

    A tensor ``kv_len`` (the serving loop's position + 1, a value on the
    device) masks the cache through ``ref.decode_attention``'s
    ``lengths``, in either mode, as the reference's dynamic branch does.
    A static ``kv_len`` (an int, or None for the whole cache) with kernels
    is ``flash_decode``; without, the plain slice of the live prefix.
    """
    if isinstance(kv_len, torch.Tensor):
        lengths = torch.broadcast_to(kv_len, (q.shape[0],))
        return ref.decode_attention(q, k_cache, v_cache, lengths=lengths,
                                    scale=scale)
    if use_kernels:
        return flash_decode(q, k_cache, v_cache, kv_len, scale)
    if kv_len is not None and kv_len < k_cache.shape[2]:
        k_cache = k_cache[:, :, :kv_len, :]
        v_cache = v_cache[:, :, :kv_len, :]
    return ref.decode_attention(q, k_cache, v_cache, scale=scale)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 64, use_kernels: bool = True):
    """The Mamba-2 SSD chunked scan -> (y, final state)."""
    if use_kernels:
        return _ssd_scan(x, dt, A, B, C, chunk)
    return ref.ssd_scan(x, dt, A, B, C, chunk=chunk)
