"""Step-function builders: the counterpart of ``repro.launch.steps``'s
``make_train_step``, ``make_prefill_step``, ``make_encoder_step`` and
``make_decode_step`` (``src/repro/launch/steps.py:26-89``), and of its
``batch_specs`` (:98-116), the model inputs of a shape cell.

``jax.value_and_grad(mdl.loss)`` becomes ``loss_and_grads``: the params'
leaves are taken as leaf tensors that require grad, the loss runs eagerly
and ``torch.autograd.grad`` returns the gradients as a tree like the
params.  The reference jits the whole step; the port runs it eagerly,
its serving steps through the model's compiled functions.  A decode step
built by ``make_decode_step(mdl, kv_len)`` attends over a static cache
length, as the reference's dry-run decode cells do: ``flash_decode`` in
the stitched mode.  On the card it runs as one captured CUDA graph
(``core/capture.py``), the counterpart of the reference's one jitted
dispatch.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from .. import optim
from ..configs.base import ArchConfig, ShapeCell
from ..core.capture import CapturedStep, leaf_signature
from ..models.model import Model


def loss_and_grads(mdl: Model, params, batch: dict):
    """(loss, grads) of ``mdl.loss`` at ``params``; the loss is detached."""
    leaves, spec = tree_flatten(params)
    leaves = [t.detach().requires_grad_() for t in leaves]
    loss = mdl.loss(tree_unflatten(leaves, spec), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(list(grads), spec)


def make_train_step(mdl: Model, opt_cfg: optim.AdamWConfig,
                    microbatches: int = 1, *, donate: bool = False):
    """Train step with optional gradient accumulation: ``microbatches > 1``
    splits the batch along its first dimension and accumulates the grads,
    each scaled by ``1 / microbatches``.  The loss is ``mdl.loss``, with
    the model's remat.  The step returns ``(params, opt_state, {"loss",
    "grad_norm", "lr"})``, tensors on the device.  ``donate`` writes the
    update into the given params and optimizer state (``optim.apply``'s
    ``inplace``), as the reference's trainer donates them to its jitted
    step: one copy of the state lives, not two."""
    def _split(batch, i):
        def sl(x):
            mb = x.shape[0] // microbatches
            return x[i * mb:(i + 1) * mb]
        return tree_map(sl, batch)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = loss_and_grads(mdl, params, batch)
        else:
            loss = 0.0
            grads = None
            for i in range(microbatches):
                li, gi = loss_and_grads(mdl, params, _split(batch, i))
                loss = loss + li / microbatches
                scale = 1.0 / microbatches
                gi = tree_map(lambda g: g * scale, gi)
                grads = gi if grads is None else tree_map(torch.add, grads,
                                                          gi)
        grads, opt_state = optim.compress_grads(opt_cfg, grads, opt_state)
        params, opt_state, metrics = optim.apply(opt_cfg, params, grads,
                                                 opt_state, inplace=donate)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


def make_prefill_step(mdl: Model):
    """``prefill_step(params, batch, cache) -> (logits, cache)`` over the
    batch's ``tokens``, ``vision_embeds`` and ``frames`` (each may be
    absent), as the reference's (``src/repro/launch/steps.py:63-70``)."""
    def prefill_step(params, batch, cache):
        return mdl.prefill(params, batch.get("tokens"), cache,
                           vision_embeds=batch.get("vision_embeds"),
                           frames=batch.get("frames"))

    return prefill_step


def make_encoder_step(mdl: Model):
    """``encoder_step(params, batch) -> logits`` of ``batch["frames"]``."""
    def encoder_step(params, batch):
        return mdl.apply(params, frames=batch["frames"])

    return encoder_step


def make_decode_step(mdl: Model, kv_len: int | None, *,
                     capture: bool = True):
    """``decode_step(params, cache, tokens, pos) -> (logits, cache)``
    attending over the first ``kv_len`` cache rows (None: the whole
    cache), a length fixed when the step is built.

    On a CUDA model the step is captured as one CUDA graph at its first
    call and replayed after (``core/capture.py``); ``tokens`` and ``pos``
    (an int or a device tensor) are copied into the graph's inputs.  A
    call with other weights or another cache -- other tensors, not other
    values -- captures anew.  The logits are a copy, the caller's to
    keep; the cache is written in place.  On the CPU, or with
    ``capture=False``, the step runs eagerly."""
    if mdl.device.type != "cuda" or not capture:
        def decode_step(params, cache, tokens, pos):
            return mdl.decode_step(params, cache, tokens, pos, kv_len=kv_len)

        return decode_step

    captured: dict = {}

    def decode_step(params, cache, tokens, pos):
        key = leaf_signature(params, cache) + (tuple(tokens.shape),)
        step = captured.get(key)
        if step is None:
            captured.clear()  # one graph at a time: its pool is released
            step = CapturedStep(
                lambda t, p: mdl.decode_step(params, cache, t, p,
                                             kv_len=kv_len)[0],
                restore=mdl.recurrent_state(cache))
            captured[key] = step
        decode_step.graph = step
        return step(tokens, pos).clone(), cache

    decode_step.graph = None  # the CapturedStep of the last call
    return decode_step


def batch_specs(cfg: ArchConfig, cell: ShapeCell,
                act_dtype: torch.dtype = torch.bfloat16, *,
                batch: int | None = None) -> dict:
    """The model inputs of one shape cell, as meta tensors: the keys,
    shapes and dtypes of the reference's ``batch_specs``
    (``src/repro/launch/steps.py:98-116``).  An audio model takes ``frames`` (and, to
    train, ``labels``); every other model ``tokens`` -- S + 1 of them to
    train, S to prefill, one to decode against an S-row cache -- and a
    vision model outside decode its ``vision_embeds``.  ``batch``
    replaces the cell's global batch (what one card holds)."""
    B = cell.global_batch if batch is None else batch
    S = cell.seq_len

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cfg.frontend == "audio":
        out = {"frames": meta((B, S, cfg.frontend_dim), act_dtype)}
        if cell.kind == "train":
            out["labels"] = meta((B, S), torch.int32)
        return out
    n_tokens = {"train": S + 1, "prefill": S}.get(cell.kind, 1)
    out = {"tokens": meta((B, n_tokens), torch.int32)}
    if cfg.frontend == "vision" and cell.kind != "decode":
        out["vision_embeds"] = meta((B, cfg.n_vision_tokens, cfg.d_model),
                                    act_dtype)
    return out
