"""Dense decoder, encoder, MoE, SSM (Mamba2) and hybrid (Zamba2) models:
prompt pass, training, KV and SSM caches, prefill and decode.

``block_apply`` is the per-layer program of the JAX package's
``models/model.py::block_apply``.  The layer loop is a Python loop over
compiled (``stitched_jit``) functions whose shapes repeat, so each
compiles once.  On the card they run their schedules at every call
(``run_directly``), never a graph of their own: the callers capture
whole steps (a decode step or wave, the scheduler's prefill):

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
  compiled head that returns the logits.  A decode step's ``kv_len``
  is device-valued (the serving loop's ``pos + 1``, an input of the
  compiled ``block_post``) or static (an int, or None for the whole
  cache: one compiled ``block_post`` closed over each, which runs
  ``flash_decode`` in the stitched mode).  The reference stitches the
  whole prefill with the layers inside one opaque ``lax.scan`` and
  returns a new cache; the port's tracer has no mutation (ROADMAP C).
* The SSM and hybrid families serve each Mamba layer as one compiled
  ``mamba_block`` that returns the new conv and SSM state as outputs,
  copied into the layer's state tensors in the cache's ``"mamba"`` list
  (the tensors stay, so a captured step reads and writes the same
  memory at every replay).
  Zamba2's shared attention block, applied before layer i when
  ``i % attn_every == 0`` on the RMSNorm of ``concat(h, emb0)`` (the
  hidden state and the initial embedding), keeps the pattern above:
  ``shared_pre``, ``layers.cache_write``, ``block_post``, one KV cache a
  application (``src/repro/models/model.py:125-135, 178-207``).

An MoE layer (``family="moe"``) replaces the MLP with ``layers.moe_apply``,
whose load-balance loss ``loss`` adds, 0.01 times its sum over the
layers, as the reference does; serving and the forward drop it.

``fusion_mode="stitched"`` (the default, as in the reference) runs the
norms, the prompt's attention and the MoE router's softmax through the
hand-written CUDA kernels, the Mamba layers' scan through the SSD kernel
(and the LayerNorm and softmax backwards through their own);
``"xla"`` runs plain ops that the compiler plans into generated kernels.
``dispatch="interpret"`` replays each traced graph op by op: with
``"xla"`` no kernel of any kind runs, which makes it the plain reference
on the card.
"""
from __future__ import annotations

import copy
import functools

import torch

from ..configs.base import ArchConfig
from ..core.cost_model import H100, Hardware
from ..core.stitch import resolve_device, run_directly, stitched_jit
from ..kernels import ops, ref
from . import layers as L
from .layers import FusionMode


RECURRENT = ("ssm", "hybrid")


def block_init(cfg: ArchConfig, gen, dtype, device) -> dict:
    if cfg.family in RECURRENT:
        return {"norm1": L.norm_init(cfg, dtype, device),
                "mamba": L.mamba_init(cfg, gen, dtype, device)}
    if cfg.family not in ("dense", "vlm", "encoder", "moe"):
        raise ValueError(f"family {cfg.family!r}: dense, vlm, encoder, moe, "
                         "ssm or hybrid")
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
    if "mamba" in p:
        y, _ = L.mamba_apply(cfg, p["mamba"],
                             L.norm_apply(cfg, p["norm1"], h, fm), fm=fm)
        return h + y, None
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
               kv_len=None, *, decode: bool = False):
    """The layer after the cache write: -> h.  Prefill passes this call's
    k, v; decode passes the cache and ``kv_len`` (``layers.attn_core``)."""
    h = h + L.attn_core(cfg, p["attn"], q, k, v, fm=fm, kv_len=kv_len,
                        decode=decode)
    return h + ffn_apply(cfg, fm, p, L.norm_apply(cfg, p["norm2"], h, fm))[0]


def mamba_block(cfg: ArchConfig, fm: FusionMode, p: dict, h, conv, ssm):
    """One Mamba layer with its cache -> (h, conv, ssm): the prompt
    (S > 1: the given cache's values are not read) or one decode step
    (S == 1)."""
    y, c = L.mamba_apply(cfg, p["mamba"], L.norm_apply(cfg, p["norm1"], h, fm),
                         fm=fm, cache={"conv": conv, "ssm": ssm})
    return h + y, c["conv"], c["ssm"]


def shared_pre(cfg: ArchConfig, fm: FusionMode, sp: dict, h, emb0,
               positions):
    """Zamba2's shared block up to the cache write: the RMSNorm of
    concat(h, emb0), then q, k, v."""
    u = ops.rmsnorm(torch.cat([h, emb0], dim=-1), sp["norm1"]["g"],
                    cfg.norm_eps, use_kernels=fm.use_kernels)
    return L.attn_qkv(cfg, sp["attn"], u, positions)


def shared_apply(cfg: ArchConfig, fm: FusionMode, sp: dict, h, emb0,
                 positions):
    """Zamba2's shared block without a cache -> h."""
    q, k, v = shared_pre(cfg, fm, sp, h, emb0, positions)
    return block_post(cfg, fm, sp, h, q, k, v)


def shared_layers(cfg: ArchConfig) -> list[int]:
    """The layers before which the hybrid applies its shared block."""
    if cfg.family != "hybrid" or not cfg.attn_every:
        return []
    return list(range(0, cfg.n_layers, cfg.attn_every))


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
    """A dense, encoder, MoE, SSM or hybrid model bound to a device, with
    its compiled functions (the encoder family trains; it has no decode).

    ``device`` is CUDA unless the caller passes ``device="cpu"`` (where
    every kernel runs its plain version).  Weights are float32.  The
    model owns its compiled functions, and each caches one compiled
    instance per input signature: repeated ``generate`` calls on one
    model never re-trace.

    ``plan_cache`` (a directory; default ``$REPRO_PLAN_CACHE``) and
    ``autotune`` are passed to every compiled function
    (``stitched_jit``).  One model keeps one set of compiled functions
    per (``plan_cache``, ``autotune``): ``with_plan`` returns the model
    bound to another set, made at first use and kept -- the counterpart
    of the reference's dispatch table keyed by (model, stitched,
    plan_cache) (``src/repro/launch/serve.py:27-62``).
    """

    def __init__(self, cfg: ArchConfig, fusion_mode: str = "stitched", *,
                 device="cuda", hw: Hardware = H100,
                 dispatch: str = "single", plan_cache: str | None = None,
                 autotune: bool = False):
        self.cfg = cfg
        self.fusion_mode = fusion_mode
        self.fm = FusionMode(fusion_mode)
        self.device = resolve_device(device)
        self._hw, self._dispatch = hw, dispatch
        #: {(plan_cache, autotune): the model bound to that set}, shared
        #: by every view of this model
        self._sets: dict[tuple, Model] = {}
        self._bind(plan_cache, autotune)

    def with_plan(self, plan_cache: str | None = None,
                  autotune: bool = False) -> "Model":
        """This model with the compiled functions of (``plan_cache``,
        ``autotune``): a view sharing the config and device, whose
        compiled functions plan through that cache and measure when
        ``autotune`` is on.  The same key gives the same view."""
        key = (None if plan_cache is None else str(plan_cache),
               bool(autotune))
        view = self._sets.get(key)
        if view is None:
            view = copy.copy(self)
            view._bind(*key)
        return view

    def _bind(self, plan_cache, autotune) -> None:
        """Make this object's compiled functions, for (``plan_cache``,
        ``autotune``), and register it in the shared table."""
        cfg, fm = self.cfg, self.fm
        self.plan_cache = None if plan_cache is None else str(plan_cache)
        self.autotune = bool(autotune)
        self._sets[(self.plan_cache, self.autotune)] = self
        opts = dict(hw=self._hw, dispatch=self._dispatch, device=self.device,
                    plan_cache=self.plan_cache, autotune=self.autotune)

        def jit(fn):
            return run_directly(
                stitched_jit(functools.partial(fn, cfg, fm), **opts))

        self._jit = jit
        self.block = run_directly(stitched_jit(
            functools.partial(block_apply, cfg, fm=fm), **opts))
        self.head = jit(head_apply)
        self.pre = jit(block_pre)
        self.post = jit(block_post)
        #: {static kv_len (an int, or None for the whole cache): the
        #: compiled ``block_post`` closed over it}, made at first use: the
        #: counterpart of ``jax.jit`` closing over ``make_decode_step``'s
        #: ``kv_len`` (a compiled function's inputs are tensors only)
        self.static_posts: dict = {}
        self.logits_head = jit(head_logits)
        self.mamba = jit(mamba_block)
        self.shared_pre = jit(shared_pre)

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
        params = {**first,
                  "blocks": [block_init(cfg, gen, dt, dev)
                             for _ in range(cfg.n_layers)],
                  "final_norm": L.norm_init(cfg, dt, dev),
                  "lm_head": L.dense(gen, cfg.d_model, cfg.padded_vocab, dt,
                                     dev)}
        if cfg.family == "hybrid":
            params["shared_attn"] = {
                "norm1": {"g": torch.ones(2 * cfg.d_model, dtype=dt,
                                          device=dev)},
                "attn": L.attn_init(cfg, gen, dt, dev, d_in=2 * cfg.d_model),
                "norm2": L.norm_init(cfg, dt, dev),
                "mlp": L.mlp_init(cfg, gen, dt, dev)}
        return params

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
        emb0, shared = h, shared_layers(cfg)
        for i, p in enumerate(params["blocks"]):
            if i in shared:
                h = shared_apply(cfg, fm, params["shared_attn"], h, emb0,
                                 positions)
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
        ``decode_step``.  The SSM and hybrid families: {"mamba": one
        {"conv" [batch, W-1, conv_dim], "ssm" [batch, H, P, N] float32} a
        layer}, which ``prefill`` and ``decode_step`` overwrite in place,
        and for the hybrid {"attn": one {"k", "v"} cache a shared-block
        application}."""
        cfg = self.cfg
        if cfg.family in RECURRENT:
            cache = {"mamba": [L.mamba_cache_init(cfg, batch, dtype,
                                                  self.device)
                               for _ in range(cfg.n_layers)]}
            if cfg.family == "hybrid":
                cache["attn"] = [L.attn_cache_init(cfg, batch, max_len,
                                                   dtype, self.device)
                                 for _ in shared_layers(cfg)]
            return cache
        one = L.attn_cache_init(self.cfg, batch, max_len, dtype, self.device)
        return {name: torch.zeros((self.cfg.n_layers,) + t.shape,
                                  dtype=dtype, device=self.device)
                for name, t in one.items()}

    @staticmethod
    def slot_cache(cache: dict, i: int) -> dict:
        """The rows of sequence ``i`` of ``cache``, as views of batch 1:
        a prefill into them fills that sequence in place (a continuous
        batch's slot)."""
        if "mamba" in cache:
            view = {"mamba": [{n: t[i:i + 1] for n, t in c.items()}
                              for c in cache["mamba"]]}
            if "attn" in cache:
                view["attn"] = [{n: t[i:i + 1] for n, t in c.items()}
                                for c in cache["attn"]]
            return view
        return {n: t[:, i:i + 1] for n, t in cache.items()}

    @staticmethod
    def recurrent_state(cache: dict) -> list:
        """The cache tensors a step computes from their own values (the
        Mamba layers' conv and SSM state): running a step twice advances
        them twice.  The KV rows a step writes, a second run writes again
        with the same values."""
        return [t for c in cache.get("mamba", []) for t in c.values()]

    @property
    def compiled_functions(self) -> list:
        """This set's compiled functions (``stitched_jit``)."""
        return [self.block, self.head, self.pre, self.post,
                self.logits_head, self.mamba, self.shared_pre,
                *self.static_posts.values()]

    @property
    def n_compiled(self) -> int:
        """Signatures compiled so far by all of this set's compiled
        functions."""
        return sum(f.n_compiled for f in self.compiled_functions)

    def reports(self) -> list:
        """The ``StitchReport`` of every signature this set compiled."""
        return [r for f in self.compiled_functions for r in f.reports()]

    def _decode_post(self, kv_len):
        """The compiled ``block_post`` of a decode step, as a function of
        (p, h, q, k_cache, v_cache): the shared one fed a device-valued
        ``kv_len``, else the one closed over the static ``kv_len``."""
        if isinstance(kv_len, torch.Tensor):
            return lambda p, h, q, k, v: self.post(p, h, q, k, v, kv_len)
        post = self.static_posts.get(kv_len)
        if post is None:
            post = self._jit(functools.partial(block_post, kv_len=kv_len,
                                               decode=True))
            self.static_posts[kv_len] = post
        return post

    def _layers(self, params, h, positions, cache, post):
        """The layer loop with a cache: ``post`` is None for a prompt
        (attention over this call's k, v), else ``_decode_post``'s."""
        if self.cfg.family in RECURRENT:
            return self._recurrent_layers(params, h, positions, cache, post)
        for i, p in enumerate(params["blocks"]):
            layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
            q, k, v = self.pre(p, h, positions)
            L.cache_write(layer_cache, k, v, positions)
            if post is None:
                h = self.post(p, h, q, k, v)
            else:
                h = post(p, h, q, layer_cache["k"], layer_cache["v"])
        return self.logits_head(self._head_params(params), h)

    def _recurrent_layers(self, params, h, positions, cache, post):
        emb0, shared = h, shared_layers(self.cfg)
        for i, p in enumerate(params["blocks"]):
            if i in shared:
                sp, kv = params["shared_attn"], cache["attn"][shared.index(i)]
                q, k, v = self.shared_pre(sp, h, emb0, positions)
                L.cache_write(kv, k, v, positions)
                if post is None:
                    h = self.post(sp, h, q, k, v)
                else:
                    h = post(sp, h, q, kv["k"], kv["v"])
            mc = cache["mamba"][i]
            h, conv, ssm = self.mamba(p, h, mc["conv"], mc["ssm"])
            mc["conv"].copy_(conv)
            mc["ssm"].copy_(ssm)
        return self.logits_head(self._head_params(params), h)

    def prefill(self, params: dict, tokens: torch.Tensor, cache: dict):
        """tokens [B, S] -> (logits [B, S, padded_vocab], cache); fills the
        cache rows 0..S-1 (and sets each Mamba layer's state after the
        prompt)."""
        h = params["embed"][tokens]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        return self._layers(params, h, positions, cache, None), cache

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor,
                    pos, kv_len=None):
        """tokens [B, 1]; ``pos`` the new token's position -> (logits [B,
        1, padded_vocab], cache).  ``pos`` is an int or a 0-d integer
        tensor on the device, shared by the batch, or a [B] integer tensor
        on the device, one position a sequence (a continuous batch's
        slots: the counterpart of the reference's ``jax.vmap`` of
        ``decode_step`` over slots).  Writes the cache row ``pos`` of each
        sequence, then attends over the rows ``kv_len`` names, as the
        reference's ``decode_step``: None, the whole cache, and an int,
        that many rows (both static: ``flash_decode`` with kernels); a
        tensor (the serving loop's ``pos + 1``, 0-d or [B]) masks the
        cache on the device."""
        h = params["embed"][tokens]
        B = tokens.shape[0]
        pos = torch.as_tensor(pos, device=h.device)
        if pos.dim() == 1 and B > 1 and pos.shape[0] == B:
            positions = pos.long().reshape(B, 1)
        elif pos.numel() == 1:
            positions = pos.reshape(1)
        else:
            raise ValueError(f"decode_step: pos of shape {tuple(pos.shape)} "
                             f"for a batch of {B}: a scalar or [{B}]")
        return self._layers(params, h, positions, cache,
                            self._decode_post(kv_len)), cache
