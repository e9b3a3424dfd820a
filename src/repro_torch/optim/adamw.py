"""AdamW + cosine schedule + global-norm clipping, plain PyTorch.

The counterpart of ``repro.optim.adamw`` with its order of operations:
clip by the global norm, the moments, the bias corrections, the decoupled
weight decay on every tensor.  States are plain trees of tensors (dicts
and lists), like the params.  ``bf16_grads=True`` casts the gradients to
bfloat16 before the update (the reference's compression ahead of its DP
all-reduce), with an optional error-feedback residual.

The reference's update is XLA-fused jnp, not a Pallas kernel, so the
port's is plain tensor code: ``torch._foreach_*`` over a group of
tensors at a time (``GROUP_ELEMS``: a few dozen multi-tensor launches a
group rather than some ten launches per tensor), so that only one
group's float32 temporaries live at once -- a list of every leaf in
float32 is 13-14 GB at Llama-3.2-3B.  Params keep their dtype (a
bfloat16 model's are bfloat16); m and v are float32, as the reference's
``init``.  ``apply`` is functional, as in the reference: it returns new
params and states and leaves its inputs alone; with ``inplace=True`` it
writes them into the given params' and states' tensors instead, the
counterpart of the reference trainer's donated buffers
(``donate_argnums=(0, 1)``), so that a step holds one copy of the
state.  Step, learning rate and clip factor stay tensors on the params'
device, so an update needs no host sync.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    bf16_grads: bool = False      # gradient compression (see module doc)
    error_feedback: bool = False  # residual accumulation for bf16 grads


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio`` (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1.0) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init(cfg: AdamWConfig, params) -> dict:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None

    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
             "m": tree_map(zeros32, params), "v": tree_map(zeros32, params)}
    if cfg.bf16_grads and cfg.error_feedback:
        state["ef"] = tree_map(zeros32, params)
    return state


#: Elements of a group of leaves the update works on at once (a leaf
#: larger than this is a group of its own).
GROUP_ELEMS = 1 << 27


def groups(leaves, cap: int = GROUP_ELEMS) -> list[slice]:
    """Consecutive runs of ``leaves`` of at most ``cap`` elements each (a
    larger leaf alone)."""
    out, start, n = [], 0, 0
    for i, t in enumerate(leaves):
        if i > start and n + t.numel() > cap:
            out.append(slice(start, i))
            start, n = i, 0
        n += t.numel()
    if start < len(leaves):
        out.append(slice(start, len(leaves)))
    return out


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (each leaf's
    norm of its float32 value, a group of leaves at a time)."""
    leaves = tree_leaves(tree)
    norms = [n for g in groups(leaves) for n in torch._foreach_norm(
        [t.to(torch.float32) for t in leaves[g]])]
    return torch.linalg.vector_norm(torch.stack(norms))


def compress_grads(cfg: AdamWConfig, grads, state: dict):
    """bf16 gradient compression with optional error feedback."""
    if not cfg.bf16_grads:
        return grads, state
    if cfg.error_feedback:
        grads = tree_map(lambda g, e: g.to(torch.float32) + e, grads,
                         state["ef"])
    comp = tree_map(lambda g: g.to(torch.bfloat16), grads)
    if cfg.error_feedback:
        new_ef = tree_map(lambda g, c: g - c.to(torch.float32), grads, comp)
        state = {**state, "ef": new_ef}
    return comp, state


def apply(cfg: AdamWConfig, params, grads, state: dict, *,
          inplace: bool = False):
    """One AdamW update.  Returns (new_params, new_state, metrics); with
    ``inplace`` the new params, m and v are written into ``params``'
    and ``state``'s own tensors, which are returned."""
    step = state["step"]
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
            if cfg.grad_clip > 0 else 1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.betas
    t = (step + 1).to(torch.float32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t

    flat_p, spec = tree_flatten(params)
    flat_g = tree_flatten(grads)[0]
    flat_m = tree_flatten(state["m"])[0]
    flat_v = tree_flatten(state["v"])[0]
    new_p, new_m, new_v = [], [], []
    for grp in groups(flat_p):
        p, m, v = _update(cfg, flat_p[grp], flat_g[grp], flat_m[grp],
                          flat_v[grp], clip, lr, bc1, bc2)
        if inplace:
            for dst, src in ((flat_p[grp], p), (flat_m[grp], m),
                             (flat_v[grp], v)):
                torch._foreach_copy_(dst, src)
            del p, m, v
        else:
            new_p += p
            new_m += m
            new_v += v
    if inplace:
        new_p, new_m, new_v = flat_p, flat_m, flat_v

    new_state = {**state, "step": step + 1, "m": tree_unflatten(new_m, spec),
                 "v": tree_unflatten(new_v, spec)}
    return (tree_unflatten(new_p, spec), new_state,
            {"grad_norm": gnorm, "lr": lr})


def _update(cfg: AdamWConfig, flat_p, flat_g, flat_m, flat_v, clip, lr, bc1,
            bc2):
    """One group's (new params in their dtypes, new m, new v)."""
    b1, b2 = cfg.betas
    p32 = [p.to(torch.float32) for p in flat_p]
    # in-place steps act only on fresh temporaries: each value is the
    # reference's expression, evaluated in its order
    g = torch._foreach_mul([x.to(torch.float32) for x in flat_g], clip)
    m2 = torch._foreach_mul(flat_m, b1)
    torch._foreach_add_(m2, torch._foreach_mul(g, 1 - b1))
    v2 = torch._foreach_mul(flat_v, b2)
    gg = torch._foreach_mul(g, 1 - b2)
    torch._foreach_mul_(gg, g)
    torch._foreach_add_(v2, gg)
    del g, gg
    den = torch._foreach_div(v2, bc2)            # vh
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    delta = torch._foreach_div(m2, bc1)          # mh
    torch._foreach_div_(delta, den)
    del den
    torch._foreach_add_(delta, torch._foreach_mul(p32, cfg.weight_decay))
    torch._foreach_mul_(delta, lr)
    new_p = [n.to(p.dtype) for n, p in
             zip(torch._foreach_sub(p32, delta), flat_p)]
    return new_p, m2, v2
