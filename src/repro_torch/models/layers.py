"""Model layers in PyTorch (the dense and encoder families, with the
serving KV cache).

The counterparts of ``repro.models.layers``.  Each memory-intensive
pattern routes through ``repro_torch.kernels.ops``, so the execution mode
is chosen per model:

  fusion_mode="stitched" -> the hand-written CUDA kernels (LayerNorm,
                            RMSNorm, flash attention), one opaque node
                            each in a traced graph, differentiable
  fusion_mode="xla"      -> the plain oracles of ``kernels/ref.py``, which
                            ``stitched_jit`` traces, plans and compiles
                            into generated kernels

Matmuls stay ``x @ w``.  Layouts follow the JAX package (``x @ w``
weights, attention tensors [B, H, S, D]) so the tests compare like with
like.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops


@dataclass(frozen=True)
class FusionMode:
    name: str = "stitched"   # "stitched" | "xla"

    def __post_init__(self):
        if self.name not in ("stitched", "xla"):
            raise ValueError(f"fusion mode {self.name!r}: 'stitched' or 'xla'")

    @property
    def use_kernels(self) -> bool:
        return self.name == "stitched"


STITCHED = FusionMode("stitched")
XLA = FusionMode("xla")


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


def norm_apply(cfg: ArchConfig, p: dict, x, fm: FusionMode):
    if cfg.norm == "layernorm":
        return ops.layernorm(x, p["g"], p["b"], cfg.norm_eps,
                             use_kernels=fm.use_kernels)
    return ops.rmsnorm(x, p["g"], cfg.norm_eps, use_kernels=fm.use_kernels)


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
# attention (GQA, optional KV cache)
# ---------------------------------------------------------------------------
def attn_init(cfg: ArchConfig, gen, dtype, device) -> dict:
    d, Dh = cfg.d_model, cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    return {"wq": dense(gen, d, Hq * Dh, dtype, device),
            "wk": dense(gen, d, Hkv * Dh, dtype, device),
            "wv": dense(gen, d, Hkv * Dh, dtype, device),
            "wo": dense(gen, Hq * Dh, d, dtype, device)}


def attn_qkv(cfg: ArchConfig, p: dict, x, positions):
    """x [B, S, d] -> q [B, Hq, S, Dh], k and v [B, Hkv, S, Dh], RoPE at
    ``positions`` [S] applied to q and k."""
    B, S, _ = x.shape
    Dh, Hq, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wq"]).reshape(B, S, Hq, Dh).transpose(1, 2)
    k = (x @ p["wk"]).reshape(B, S, Hkv, Dh).transpose(1, 2)
    v = (x @ p["wv"]).reshape(B, S, Hkv, Dh).transpose(1, 2)
    q, k = rope(q, k, positions, cfg.rope_theta)
    return q, k, v


def cache_write(cache: dict, k, v, positions) -> None:
    """Write k, v [B, Hkv, S, Dh] into the cache rows ``positions`` [S],
    in place.  ``positions`` is a tensor on the cache's device, so the
    write needs no host sync.  Never traced: the port's tracer has no
    mutation, so the cache is written between two stitched functions
    (the reference returns a new cache from ``dynamic_update_slice``)."""
    cache["k"].index_copy_(2, positions, k.to(cache["k"].dtype))
    cache["v"].index_copy_(2, positions, v.to(cache["v"].dtype))


def attn_core(cfg: ArchConfig, p: dict, q, k, v, *, fm: FusionMode,
              kv_len=None):
    """Attention and the output projection -> [B, S, d].

    Without ``kv_len``: causal attention of q over this call's k, v
    (prefill, or no cache).  With ``kv_len`` (a 0-d tensor): one decode
    token, q [B, Hq, 1, Dh] over the cache k, v [B, Hkv, max_len, Dh],
    masked to its first ``kv_len`` rows.
    """
    B, Hq, S, Dh = q.shape
    if kv_len is None:
        o = ops.attention(q, k, v, causal=cfg.causal,
                          use_kernels=fm.use_kernels)
    else:
        # q[:, :, 0] as a reshape (S == 1): no opaque select in the graph
        o = ops.decode_attention(q.reshape(B, Hq, Dh), k, v, kv_len=kv_len,
                                 use_kernels=fm.use_kernels)[:, :, None]
    o = o.transpose(1, 2).reshape(B, S, Hq * Dh)
    return o @ p["wo"]


def attn_apply(cfg: ArchConfig, p: dict, x, *, fm: FusionMode, positions):
    """x [B, S, d] -> [B, S, d], causal over this call's tokens, no cache
    (``src/repro/models/layers.py:102-140`` without one).  With a cache,
    ``models/model.py`` stitches ``attn_qkv`` and ``attn_core`` on either
    side of ``cache_write``."""
    q, k, v = attn_qkv(cfg, p, x, positions)
    return attn_core(cfg, p, q, k, v, fm=fm)


def attn_cache_init(cfg: ArchConfig, batch: int, max_len: int, dtype,
                    device) -> dict:
    Dh, Hkv = cfg.resolved_head_dim, cfg.n_kv_heads
    return {"k": torch.zeros(batch, Hkv, max_len, Dh, dtype=dtype,
                             device=device),
            "v": torch.zeros(batch, Hkv, max_len, Dh, dtype=dtype,
                             device=device)}


# ---------------------------------------------------------------------------
# MLP (SwiGLU, plain GELU)
# ---------------------------------------------------------------------------
def mlp_init(cfg: ArchConfig, gen, dtype, device) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.activation == "gelu_mlp":
        return {"w_up": dense(gen, d, ff, dtype, device),
                "w_down": dense(gen, ff, d, dtype, device)}
    return {"w_gate": dense(gen, d, ff, dtype, device),
            "w_up": dense(gen, d, ff, dtype, device),
            "w_down": dense(gen, ff, d, dtype, device)}


def mlp_apply(cfg: ArchConfig, p: dict, x):
    if cfg.activation == "gelu_mlp":
        # jax.nn.gelu(approximate=True) is the tanh form
        return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]
    if cfg.activation != "silu":
        raise NotImplementedError(
            f"activation {cfg.activation!r}: the port has SwiGLU and "
            "gelu_mlp")
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
