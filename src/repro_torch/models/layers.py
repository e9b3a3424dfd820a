"""Model layers in plain PyTorch (dense family, no KV cache).

The counterparts of ``repro.models.layers`` run with ``FusionMode("xla")``:
plain tensor code, which ``stitched_jit`` traces, plans and compiles into
generated kernels.  Layouts follow the JAX package (``x @ w`` weights,
attention tensors [B, H, S, D]) so the tests compare like with like.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ref


def dense(gen: torch.Generator, d_in: int, d_out: int, dtype,
          device) -> torch.Tensor:
    w = torch.randn(d_in, d_out, generator=gen, device=device,
                    dtype=torch.float32) / math.sqrt(d_in)
    return w.to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def norm_init(cfg: ArchConfig, dtype, device) -> dict:
    p = {"g": torch.ones(cfg.d_model, dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros(cfg.d_model, dtype=dtype, device=device)
    return p


def norm_apply(cfg: ArchConfig, p: dict, x):
    if cfg.norm == "layernorm":
        return ref.layernorm(x, p["g"], p["b"], cfg.norm_eps)
    return ref.rmsnorm(x, p["g"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------
def rope(q, k, positions, theta: float):
    """q, k: [B, H, S, D]; positions: [S]."""
    D = q.shape[-1]
    half = D // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=q.device)
                      * (math.log(theta) / half))
    angles = positions.to(torch.float32)[..., None] * freqs   # [S, half]
    while angles.dim() < q.dim():                             # [1,1,S,half]
        angles = angles[None]
    cos, sin = torch.cos(angles), torch.sin(angles)

    def rot(x):
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin,
                          x2 * cos + x1 * sin], dim=-1).to(x.dtype)

    return rot(q), rot(k)


# ---------------------------------------------------------------------------
# attention (GQA, written plainly)
# ---------------------------------------------------------------------------
def attention(q, k, v, *, causal: bool = True):
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] (Hq % Hkv == 0).

    Grouped-query attention without repeating K/V: the query heads of one
    KV head are folded into the row dimension of a batched product.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qf = q.reshape(B * Hkv, g * Sq, D)
    kf = k.reshape(B * Hkv, Skv, D)
    vf = v.reshape(B * Hkv, Skv, D)
    logits = torch.bmm(qf, kf.transpose(1, 2)).reshape(B, Hkv, g, Sq, Skv) \
        * (1.0 / math.sqrt(D))
    if causal:
        # built as ``jnp.tril(ones)`` builds it (a select over the causal
        # comparison) and broadcast to the full score shape as
        # ``jnp.where`` does: the masked softmax then has a row view and
        # plans as the reference's one-pass softmax tail
        row = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        col = torch.arange(Skv, device=q.device)[None, :]
        mask = torch.where(row >= col, True, False)
        logits = torch.where(mask.expand(logits.shape), logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.bmm(probs.reshape(B * Hkv, g * Sq, Skv), vf)
    return out.reshape(B, Hq, Sq, D)


def attn_init(cfg: ArchConfig, gen, dtype, device) -> dict:
    d, Dh = cfg.d_model, cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    return {"wq": dense(gen, d, Hq * Dh, dtype, device),
            "wk": dense(gen, d, Hkv * Dh, dtype, device),
            "wv": dense(gen, d, Hkv * Dh, dtype, device),
            "wo": dense(gen, Hq * Dh, d, dtype, device)}


def attn_apply(cfg: ArchConfig, p: dict, x, positions):
    """x: [B, S, d] -> [B, S, d]."""
    B, S, _ = x.shape
    Dh, Hq, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wq"]).reshape(B, S, Hq, Dh).transpose(1, 2)
    k = (x @ p["wk"]).reshape(B, S, Hkv, Dh).transpose(1, 2)
    v = (x @ p["wv"]).reshape(B, S, Hkv, Dh).transpose(1, 2)
    q, k = rope(q, k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=cfg.causal)
    o = o.transpose(1, 2).reshape(B, S, Hq * Dh)
    return o @ p["wo"]


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------
def mlp_init(cfg: ArchConfig, gen, dtype, device) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {"w_gate": dense(gen, d, ff, dtype, device),
            "w_up": dense(gen, d, ff, dtype, device),
            "w_down": dense(gen, ff, d, dtype, device)}


def mlp_apply(cfg: ArchConfig, p: dict, x):
    if cfg.activation != "silu":
        raise NotImplementedError(
            f"activation {cfg.activation!r}: this slice ports SwiGLU only")
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
