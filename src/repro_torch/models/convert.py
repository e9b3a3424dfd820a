"""Weights of the JAX package's ``Model`` (as numpy arrays) -> the port's.

The JAX model stacks its layers' params along a leading axis (``lax.scan``);
the port keeps one dict per layer.  Both use the ``x @ w`` layout, so no
matrix is transposed: the two packages compute the same function on the
same weights.
"""
from __future__ import annotations

import numpy as np
import torch


def to_tensor(arr) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a CPU tensor of
    its dtype.  A bfloat16 array (numpy's ``ml_dtypes`` type, which
    ``torch.from_numpy`` refuses) is carried as its bits: viewed as
    uint16, then as ``torch.bfloat16``."""
    arr = np.array(np.asarray(arr), copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _to_torch(tree, device, index=None):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, index) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device, index) for v in tree]
    arr = np.asarray(tree)
    if index is not None:
        arr = arr[index]
    return to_tensor(arr).to(device)


def from_jax_params(params: dict, *, device="cuda") -> dict:
    """``params`` is the JAX model's param tree with numpy leaves (e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``): ``embed`` (or
    ``feat_proj`` for audio), the stacked ``blocks`` (norms with ``g`` and,
    for LayerNorm, ``b``; SwiGLU or ``gelu_mlp`` weights, or an MoE's
    ``moe`` subtree: the router [L, d, E] and the expert stacks
    [L, E, d, ff] / [L, E, ff, d]), ``final_norm`` and ``lm_head``.  The
    walk is generic: every key is carried over as it is, each stacked
    leaf cut along its leading (layer) axis, so layer i of the MoE holds
    the router [d, E] and the experts' [E, d, ff] / [E, ff, d], and layer
    i of Mamba2 its ``mamba`` subtree.  The hybrid (Zamba2) keeps its
    layers as a list, one unstacked tree each, which is carried over as
    it is, like its ``shared_attn`` block.  Every leaf keeps its dtype,
    bfloat16 included (``to_tensor``)."""
    blocks = params["blocks"]
    out = {k: _to_torch(v, device) for k, v in params.items()
           if k != "blocks"}
    if isinstance(blocks, (list, tuple)):
        out["blocks"] = _to_torch(blocks, device)
    else:
        n_layers = np.asarray(next(iter(_leaves(blocks)))).shape[0]
        out["blocks"] = [_to_torch(blocks, device, i)
                         for i in range(n_layers)]
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
