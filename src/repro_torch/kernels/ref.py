"""Plain PyTorch oracles: the port's counterparts of ``repro.kernels.ref``
for the normalizations, the softmax and attention.

They are the numerical ground truth of the tests and the
``fusion_mode="xla"`` path of the model code, which ``stitched_jit``
traces and compiles.  Attention is written with ``bmm`` on reshaped
operands in place of the reference's einsums: the traced graph then
plans as the reference's (ROADMAP C, "The causal mask").
"""
from __future__ import annotations

import math

import torch


def layernorm(x, gamma, beta, eps: float = 1e-6):
    xf = x.to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma + beta).to(x.dtype)


def rmsnorm(x, gamma, eps: float = 1e-6):
    xf = x.to(torch.float32)
    ms = (xf ** 2).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * gamma).to(x.dtype)


def softmax(x, dim: int = -1):
    return torch.softmax(x.to(torch.float32), dim).to(x.dtype)


def attention(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Multi-head attention with repeat-free GQA.

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] (Hq % Hkv == 0).  The query
    heads of one KV head are folded into the row dimension of a batched
    product, so K/V are never repeated.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.reshape(B * Hkv, g * Sq, D)
    kf = k.reshape(B * Hkv, Skv, D)
    vf = v.reshape(B * Hkv, Skv, D)
    logits = torch.bmm(qf, kf.transpose(1, 2)).reshape(B, Hkv, g, Sq, Skv) \
        * scale
    if causal:
        # built as ``jnp.tril(ones, k=Skv-Sq)`` builds it (a select over
        # the causal comparison) and broadcast to the full score shape as
        # ``jnp.where`` does: the masked softmax then has a row view and
        # plans as the reference's one-pass softmax tail
        row = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        col = torch.arange(Skv, device=q.device)[None, :]
        mask = torch.where(row >= col, True, False)
        logits = torch.where(mask.expand(logits.shape), logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.bmm(probs.reshape(B * Hkv, g * Sq, Skv), vf)
    return out.reshape(B, Hq, Sq, D)


def decode_attention(q, k_cache, v_cache, lengths=None, scale=None):
    """Single-token decode: q [B, Hq, D]; caches [B, Hkv, S, D].

    ``lengths`` [B] masks cache rows at or past each sequence's length.
    """
    B, Hq, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    g = Hq // Hkv
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.reshape(B * Hkv, g, D)
    kf = k_cache.reshape(B * Hkv, S, D)
    vf = v_cache.reshape(B * Hkv, S, D)
    logits = torch.bmm(qf, kf.transpose(1, 2)).reshape(B, Hkv, g, S) * sc
    if lengths is not None:
        mask = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
        logits = torch.where(mask[:, None, None, :].expand(logits.shape),
                             logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.bmm(probs.reshape(B * Hkv, g, S), vf)
    return out.reshape(B, Hq, D)
