"""Dense decoder, encoder and MoE models: prompt pass, training, KV
cache, prefill and decode.

``block_apply`` is the per-layer program of the JAX package's
``models/model.py::block_apply``.  The layer loop is a Python loop over
compiled (``stitched_jit``) functions whose shapes repeat, so each
compiles once:

* ``Model.forward`` (no cache): one compiled block per layer, then a
  compiled head -- the final norm, ``torch.matmul`` for the LM head, and
  the softmax over the vocabulary.
* ``Model.apply`` / ``Model.loss`` (training, no cache): the layers run
  eagerly, differentiable through ``torch.autograd`` -- the reference's
  ``apply`` and ``loss`` under ``jax.value_and_grad``.  Training does not
  go through ``stitched_jit``.
* ``Model.prefill`` / ``Model.decode_step`` (serving, with a cache): each
  layer is two compiled halves around an eager in-place cache write --
  ``block_pre`` (norm, QKV, RoPE), then ``layers.cache_write``, then
  ``block_post`` (attention, ``wo``, residual, norm, MLP) -- and a
  compiled head that returns the logits.  The reference stitches the
  whole prefill with the layers inside one opaque ``lax.scan`` and
  returns a new cache; the port's tracer has no mutation (ROADMAP C).

An MoE layer (``family="moe"``) replaces the MLP with ``layers.moe_apply``,
whose load-balance loss ``loss`` adds, 0.01 times its sum over the
layers, as the reference does; serving and the forward drop it.

``fusion_mode="stitched"`` (the default, as in the reference) runs the
norms, the prompt's attention and the MoE router's softmax through the
hand-written CUDA kernels (and the LayerNorm and softmax backwards
through their own);
``"xla"`` runs plain ops that the compiler plans into generated kernels.
``dispatch="interpret"`` replays each traced graph op by op: with
``"xla"`` no kernel of any kind runs, which makes it the plain reference
on the card.
"""
from __future__ import annotations

import functools

import torch

from ..configs.base import ArchConfig
from ..core.cost_model import H100, Hardware
from ..core.stitch import resolve_device, stitched_jit
from ..kernels import ref
from . import layers as L
from .layers import FusionMode


def block_init(cfg: ArchConfig, gen, dtype, device) -> dict:
    if cfg.family not in ("dense", "vlm", "encoder", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r}: the port has no Mamba2 layer yet "
            "(the ssm and hybrid families)")
    p = {"norm1": L.norm_init(cfg, dtype, device),
         "attn": L.attn_init(cfg, gen, dtype, device),
         "norm2": L.norm_init(cfg, dtype, device)}
    if cfg.family == "moe":
        p["moe"] = L.moe_init(cfg, gen, dtype, device)
    else:
        p["mlp"] = L.mlp_init(cfg, gen, dtype, device)
    return p


def ffn_apply(cfg: ArchConfig, fm: FusionMode, p: dict, x):
    """The layer's feed-forward half -> (y, aux): the MoE's load-balance
    loss, or None after a dense MLP."""
    if "moe" in p:
        return L.moe_apply(cfg, p["moe"], x, fm)
    return L.mlp_apply(cfg, p["mlp"], x), None


def block_apply_aux(cfg: ArchConfig, p: dict, h, positions, *,
                    fm: FusionMode):
    """One layer without a cache: h [B, S, d], positions [S] -> (h, aux)."""
    h = h + L.attn_apply(cfg, p["attn"], L.norm_apply(cfg, p["norm1"], h, fm),
                         fm=fm, positions=positions)
    y, aux = ffn_apply(cfg, fm, p, L.norm_apply(cfg, p["norm2"], h, fm))
    return h + y, aux


def block_apply(cfg: ArchConfig, p: dict, h, positions, *, fm: FusionMode):
    """One layer without a cache: h [B, S, d], positions [S] -> h."""
    return block_apply_aux(cfg, p, h, positions, fm=fm)[0]


def block_pre(cfg: ArchConfig, fm: FusionMode, p: dict, h, positions):
    """The layer up to the cache write: -> q, k, v."""
    return L.attn_qkv(cfg, p["attn"], L.norm_apply(cfg, p["norm1"], h, fm),
                      positions)


def block_post(cfg: ArchConfig, fm: FusionMode, p: dict, h, q, k, v,
               kv_len=None):
    """The layer after the cache write: -> h.  Prefill passes this call's
    k, v; decode passes the cache and ``kv_len``."""
    h = h + L.attn_core(cfg, p["attn"], q, k, v, fm=fm, kv_len=kv_len)
    return h + ffn_apply(cfg, fm, p, L.norm_apply(cfg, p["norm2"], h, fm))[0]


def head_apply(cfg: ArchConfig, fm: FusionMode, p: dict, h):
    """Final norm, LM head and the softmax over the vocabulary."""
    logits = head_logits(cfg, fm, p, h)
    return logits, ref.softmax(logits)


def head_logits(cfg: ArchConfig, fm: FusionMode, p: dict, h):
    """Final norm, LM head and the pad-column mask: the serving and
    training head."""
    return mask_pad_columns(
        cfg, L.norm_apply(cfg, p["final_norm"], h, fm) @ p["lm_head"])


def mask_pad_columns(cfg: ArchConfig, logits):
    """-1e30 on the logit columns at or past ``vocab_size``
    (``src/repro/models/model.py:211-213``)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    col = torch.arange(cfg.padded_vocab, device=logits.device)
    return torch.where(col < cfg.vocab_size, logits, -1e30)


class Model:
    """A dense, encoder or MoE model bound to a device, with its compiled
    functions (the encoder family trains; it has no decode).

    ``device`` is CUDA unless the caller passes ``device="cpu"`` (where
    every kernel runs its plain version).  Weights are float32.  The
    model owns its compiled functions, and each caches one compiled
    instance per input signature: repeated ``generate`` calls on one
    model never re-trace.
    """

    def __init__(self, cfg: ArchConfig, fusion_mode: str = "stitched", *,
                 device="cuda", hw: Hardware = H100,
                 dispatch: str = "single"):
        self.cfg = cfg
        self.fusion_mode = fusion_mode
        self.fm = fm = FusionMode(fusion_mode)
        self.device = resolve_device(device)

        def jit(fn):
            return stitched_jit(functools.partial(fn, cfg, fm), hw=hw,
                                dispatch=dispatch, device=self.device)

        self.block = stitched_jit(
            functools.partial(block_apply, cfg, fm=fm), hw=hw,
            dispatch=dispatch, device=self.device)
        self.head = jit(head_apply)
        self.pre = jit(block_pre)
        self.post = jit(block_post)
        self.logits_head = jit(head_logits)

    def init(self, seed: int) -> dict:
        """Random weights from ``seed``, made on the model's device.  An
        audio model has ``feat_proj`` in place of ``embed``."""
        cfg, dt, dev = self.cfg, torch.float32, self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        if cfg.frontend == "audio":
            first = {"feat_proj": {"w": L.dense(gen, cfg.frontend_dim,
                                                cfg.d_model, dt, dev)}}
        else:
            embed = torch.randn(cfg.padded_vocab, cfg.d_model, generator=gen,
                                device=dev, dtype=torch.float32) * 0.02
            first = {"embed": embed.to(dt)}
        return {**first,
                "blocks": [block_init(cfg, gen, dt, dev)
                           for _ in range(cfg.n_layers)],
                "final_norm": L.norm_init(cfg, dt, dev),
                "lm_head": L.dense(gen, cfg.d_model, cfg.padded_vocab, dt,
                                   dev)}

    # -- training -----------------------------------------------------------
    def apply(self, params: dict, tokens=None, frames=None):
        """Eager and differentiable, no cache: tokens [B, S] (or frames
        [B, S, frontend_dim] for audio) -> logits [B, S, padded_vocab],
        the pad columns at -1e30.  The reference's ``Model.apply``
        without a cache, less its ``aux`` (``apply_aux``)."""
        return self.apply_aux(params, tokens, frames)[0]

    def apply_aux(self, params: dict, tokens=None, frames=None):
        """``apply`` -> (logits, aux): aux is the MoE layers'
        load-balance loss summed over the layers, 0.0 without MoE."""
        cfg, fm = self.cfg, self.fm
        if cfg.frontend == "audio":
            h = frames.to(torch.float32) @ params["feat_proj"]["w"]
        else:
            h = params["embed"][tokens]
        positions = torch.arange(h.shape[1], device=h.device)
        aux = 0.0
        for p in params["blocks"]:
            h, a = block_apply_aux(cfg, p, h, positions, fm=fm)
            if a is not None:
                aux = aux + a
        return head_logits(cfg, fm, self._head_params(params), h), aux

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean next-token (or frame-label) cross entropy, float32, plus
        0.01 times the MoE load-balance loss
        (``src/repro/models/model.py:218-232``)."""
        if self.cfg.frontend == "audio":
            logits, aux = self.apply_aux(params, frames=batch["frames"])
            labels = batch["labels"]
        else:
            tokens = batch["tokens"]
            logits, aux = self.apply_aux(params, tokens=tokens[:, :-1])
            labels = tokens[:, 1:]
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
        return -ll.mean() + 0.01 * aux

    @staticmethod
    def _head_params(params: dict) -> dict:
        return {"final_norm": params["final_norm"],
                "lm_head": params["lm_head"]}

    def forward(self, params: dict, tokens: torch.Tensor):
        """tokens [B, S] -> (logits, probs), each [B, S, padded_vocab]."""
        h = params["embed"][tokens]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        for p in params["blocks"]:
            h = self.block(p, h, positions)
        return self.head(self._head_params(params), h)

    # -- serving ------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   dtype=torch.float32) -> dict:
        """{"k", "v"}: [n_layers, batch, n_kv_heads, max_len, head_dim]
        zeros on the model's device, written in place by ``prefill`` and
        ``decode_step``."""
        one = L.attn_cache_init(self.cfg, batch, max_len, dtype, self.device)
        return {name: torch.zeros((self.cfg.n_layers,) + t.shape,
                                  dtype=dtype, device=self.device)
                for name, t in one.items()}

    def _layers(self, params, h, positions, cache, kv_len):
        for i, p in enumerate(params["blocks"]):
            layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
            q, k, v = self.pre(p, h, positions)
            L.cache_write(layer_cache, k, v, positions)
            if kv_len is None:
                h = self.post(p, h, q, k, v)
            else:
                h = self.post(p, h, q, layer_cache["k"], layer_cache["v"],
                              kv_len)
        return self.logits_head(self._head_params(params), h)

    def prefill(self, params: dict, tokens: torch.Tensor, cache: dict):
        """tokens [B, S] -> (logits [B, S, padded_vocab], cache); fills the
        cache rows 0..S-1."""
        h = params["embed"][tokens]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        return self._layers(params, h, positions, cache, None), cache

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor,
                    pos: torch.Tensor):
        """tokens [B, 1]; ``pos`` a 0-d integer tensor on the device, the
        new token's position -> (logits [B, 1, padded_vocab], cache).
        Attends over the cache rows 0..pos (kv_len = pos + 1)."""
        h = params["embed"][tokens]
        positions = pos.reshape(1)
        return self._layers(params, h, positions, cache, pos + 1), cache
