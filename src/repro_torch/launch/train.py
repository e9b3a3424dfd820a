"""Training driver of the port: AdamW steps on synthetic batches.

  PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge \
      --reduced --device cpu --steps 3          # the plain versions, CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge \
      --batch 8 --seq 512 --steps 5             # full width, on the card
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch granite-moe-1b-a400m --batch 8 --seq 512 --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch mamba2-370m --batch 8 --seq 512 --steps 5

The counterpart of ``repro.launch.train`` (``build_trainer``, ``main``).
``fusion_mode="stitched"`` (the default) runs the norms, attention, the
MoE router's softmax and the Mamba layers' SSD scan through the
hand-written CUDA kernels and the LayerNorm and softmax backwards
through their own; ``"xla"`` runs the
plain oracles, no kernel of any kind.  The backward is eager
``torch.autograd`` (the reference's is ``jax.value_and_grad`` under
``jit``).

Not ported yet: the reference's restartable loop, checkpointing and
straggler monitor (``runtime/fault_tolerance.py``, ``checkpoint/``);
``main`` is a plain loop over ``batch_at(step)``.
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.utils._pytree import tree_leaves

from .. import optim
from ..configs import get_config
from ..configs.base import ARCH_IDS
from ..data import DataConfig, SyntheticTokens
from ..models.model import Model
from . import steps as S


def build_trainer(cfg, *, fusion_mode="stitched", lr=1e-3, total_steps=1000,
                  bf16_grads=False, device="cuda",
                  param_dtype=torch.float32, remat=False):
    """-> (model, init_state(seed), train_step(state, batch)).

    ``train_step`` takes a batch of numpy arrays or tensors, moves it to
    the model's device, and leaves the step's metrics, as Python floats,
    in ``train_step.last_metrics``.  The model is float32 without remat
    by default, as the reference's trainer builds it
    (``src/repro/launch/train.py:33``); ``param_dtype`` and ``remat``
    (its "full" policy) change that.
    """
    mdl = Model(cfg, fusion_mode, param_dtype=param_dtype, remat=remat,
                device=device)
    opt_cfg = optim.AdamWConfig(lr=lr, warmup_steps=min(20, total_steps // 10),
                                total_steps=total_steps,
                                bf16_grads=bf16_grads)
    step_fn = S.make_train_step(mdl, opt_cfg)

    def init_state(seed: int) -> dict:
        params = mdl.init(seed)
        return {"params": params, "opt": optim.init(opt_cfg, params)}

    def train_step(state, batch):
        batch = {k: torch.as_tensor(v).to(mdl.device)
                 for k, v in batch.items()}
        params, opt, metrics = step_fn(state["params"], state["opt"], batch)
        train_step.last_metrics = {k: float(v) for k, v in metrics.items()}
        return {"params": params, "opt": opt}

    train_step.last_metrics = {}
    return mdl, init_state, train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--fusion", default="stitched", choices=["stitched", "xla"])
    ap.add_argument("--bf16-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--param-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--remat", action="store_true",
                    help="recompute each layer in the backward")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    mdl, init_state, train_step = build_trainer(
        cfg, fusion_mode=args.fusion, lr=args.lr, total_steps=args.steps,
        bf16_grads=args.bf16_grads, device=args.device,
        param_dtype=getattr(torch, args.param_dtype), remat=args.remat)
    state = init_state(args.seed)
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    print(f"arch={cfg.name} params={n_params:,} fusion={args.fusion} "
          f"device={mdl.device} {args.param_dtype} remat={args.remat}")

    data = SyntheticTokens(
        DataConfig(seed=args.seed, global_batch=args.batch, seq_len=args.seq),
        cfg)
    t0 = time.perf_counter()
    for step in range(args.steps):
        ts = time.perf_counter()
        state = train_step(state, data.batch_at(step))
        dt = time.perf_counter() - ts  # the metrics' floats synchronize
        m = train_step.last_metrics
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss={m['loss']:.4f} "
                  f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                  f"{dt * 1e3:6.1f}ms", flush=True)
    print(f"done in {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
