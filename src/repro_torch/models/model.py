"""Dense decoder model: one ``stitched_jit``-compiled block for every layer.

``block_apply`` is the per-layer program of the JAX package's
``models/model.py::block_apply`` with plain ops (``FusionMode("xla")``);
``Model.forward`` applies its compiled form to each layer in a Python loop
(the shapes repeat, so it compiles once), then a compiled head: the final
RMSNorm, ``torch.matmul`` for the LM head, and the softmax over the
vocabulary.  No KV cache: this is the prompt (prefill) pass.
"""
from __future__ import annotations

import functools

import torch

from ..configs.base import ArchConfig
from ..core.cost_model import H100, Hardware
from ..core.stitch import resolve_device, stitched_jit
from ..kernels import ref
from . import layers as L


def block_init(cfg: ArchConfig, gen, dtype, device) -> dict:
    if cfg.family not in ("dense", "vlm", "encoder"):
        raise NotImplementedError(
            f"family {cfg.family!r}: this slice ports the dense family")
    return {"norm1": L.norm_init(cfg, dtype, device),
            "attn": L.attn_init(cfg, gen, dtype, device),
            "norm2": L.norm_init(cfg, dtype, device),
            "mlp": L.mlp_init(cfg, gen, dtype, device)}


def block_apply(cfg: ArchConfig, p: dict, h, positions):
    """One layer: h [B, S, d], positions [S] -> h [B, S, d]."""
    h = h + L.attn_apply(cfg, p["attn"], L.norm_apply(cfg, p["norm1"], h),
                         positions)
    return h + L.mlp_apply(cfg, p["mlp"], L.norm_apply(cfg, p["norm2"], h))


def head_apply(cfg: ArchConfig, p: dict, h):
    """Final norm, LM head and the softmax over the vocabulary."""
    logits = L.norm_apply(cfg, p["final_norm"], h) @ p["lm_head"]
    return logits, ref.softmax(logits)


class Model:
    """A dense model bound to a device, with its compiled block and head.

    ``device`` is CUDA unless the caller passes ``device="cpu"`` (where
    every generated kernel runs its plain version).  Weights are float32.
    """

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 hw: Hardware = H100, dispatch: str = "single"):
        if cfg.padded_vocab != cfg.vocab_size:
            raise NotImplementedError(
                "a vocabulary that is not a multiple of 256 needs the "
                "reference's pad-column mask, which this slice leaves out")
        self.cfg = cfg
        self.device = resolve_device(device)
        kw = dict(hw=hw, dispatch=dispatch, device=self.device)
        self.block = stitched_jit(functools.partial(block_apply, cfg), **kw)
        self.head = stitched_jit(functools.partial(head_apply, cfg), **kw)

    def init(self, seed: int) -> dict:
        """Random weights from ``seed``, made on the model's device."""
        cfg, dt, dev = self.cfg, torch.float32, self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        embed = torch.randn(cfg.padded_vocab, cfg.d_model, generator=gen,
                            device=dev, dtype=torch.float32) * 0.02
        return {"embed": embed.to(dt),
                "blocks": [block_init(cfg, gen, dt, dev)
                           for _ in range(cfg.n_layers)],
                "final_norm": L.norm_init(cfg, dt, dev),
                "lm_head": L.dense(gen, cfg.d_model, cfg.padded_vocab, dt,
                                   dev)}

    def forward(self, params: dict, tokens: torch.Tensor):
        """tokens [B, S] -> (logits, probs), each [B, S, padded_vocab]."""
        h = params["embed"][tokens]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        for p in params["blocks"]:
            h = self.block(p, h, positions)
        return self.head({"final_norm": params["final_norm"],
                          "lm_head": params["lm_head"]}, h)
