"""Step-function builders: the counterpart of ``repro.launch.steps``'s
``make_train_step`` (``src/repro/launch/steps.py:26-60``).

``jax.value_and_grad(mdl.loss)`` becomes ``loss_and_grads``: the params'
leaves are taken as leaf tensors that require grad, the loss runs eagerly
and ``torch.autograd.grad`` returns the gradients as a tree like the
params.  The reference jits the whole step; the port runs it eagerly.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from .. import optim
from ..models.model import Model


def loss_and_grads(mdl: Model, params, batch: dict):
    """(loss, grads) of ``mdl.loss`` at ``params``; the loss is detached."""
    leaves, spec = tree_flatten(params)
    leaves = [t.detach().requires_grad_() for t in leaves]
    loss = mdl.loss(tree_unflatten(leaves, spec), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(list(grads), spec)


def make_train_step(mdl: Model, opt_cfg: optim.AdamWConfig,
                    microbatches: int = 1):
    """Train step with optional gradient accumulation: ``microbatches > 1``
    splits the batch along its first dimension and accumulates the grads,
    each scaled by ``1 / microbatches``.  The step returns
    ``(params, opt_state, {"loss", "grad_norm", "lr"})``, tensors on the
    device."""
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
                                                 opt_state)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step
