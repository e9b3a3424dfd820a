"""Batched serving driver of the port: bucketed prefill and greedy decode
with a KV cache (and the SSM state of the Mamba layers).

  PYTHONPATH=src python -m repro_torch.launch.serve            # the card
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --kv-len 32768

The counterpart of ``repro.launch.serve`` (``generate``, ``main``) for
the dense, MoE, SSM and hybrid families.  Prompt and cache lengths are
canonicalized onto the serving bucket ladder (``serving/buckets.py``), so
a mix of lengths compiles once per bucket -- except the prompts of the
SSM and hybrid families, which run at their exact length, as in the
reference; the model owns its compiled functions, so
repeated ``generate`` calls on one model never re-trace (the reference
keeps a per-process table of jitted pairs for the same purpose).  Logits
are read at the true last prompt position, which the causal mask keeps
from seeing the pad tail.  The decode loop keeps its tokens and positions
on the device: the host waits once, at the end.  Each step passes
``kv_len = pos + 1`` as a device value, as the reference does: the cache
is masked to the rows written so far (a static ``kv_len`` would let the
zero rows of the unwritten tail into the softmax's denominator).  On the
card the decode step, its argmax included, is captured once as a CUDA
graph and replayed at each step (``greedy_step``, ``core/capture.py``):
one dispatch a step, as the reference's jitted step.

``generate_static`` decodes at a static cache length instead, each step
from ``launch.steps.make_decode_step(mdl, kv_len)`` over all ``kv_len``
rows of the cache (``flash_decode`` in the stitched mode), as the
reference's decode cells run (``--kv-len``).

``generate(..., plan_cache=d)`` plans through the plan cache in ``d``:
the model keeps one set of compiled functions a (plan cache, autotune)
(``Model.with_plan``), the counterpart of the reference's dispatch table
keyed by (model, stitched, plan_cache).  Not ported yet: the canary and
the mesh key of that table.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..configs.base import ARCH_IDS
from ..core.capture import graphed
from ..models.model import RECURRENT, Model
from ..serving.buckets import Buckets, pad_tokens
from .steps import make_decode_step


def greedy_step(mdl: Model, params: dict, cache: dict, *,
                capture: bool = True):
    """``generate``'s decode step: ``step(tok, pos) -> next`` for tok
    [B, 1] and ``pos`` a 0-d device tensor; writes the cache row ``pos``
    and attends the rows 0..pos (``kv_len = pos + 1`` on the device).  On
    a CUDA model, with ``capture``, one CUDA graph replayed at each call,
    whose output the next call overwrites; else eager."""
    V = mdl.cfg.vocab_size

    def step(tok, pos):
        logits, _ = mdl.decode_step(params, cache, tok, pos, kv_len=pos + 1)
        return logits[:, -1:, :V].argmax(-1)

    if not capture:
        return step
    return graphed(step, mdl.device, restore=mdl.recurrent_state(cache))


def generate(mdl: Model, params: dict, prompts: np.ndarray, gen_len: int, *,
             buckets: Buckets | None = None, capture: bool = True,
             plan_cache: str | None = None) -> np.ndarray:
    """prompts: [B, S] int -> [B, S + gen_len] (greedy decode).  On the
    card the decode steps replay one captured graph (``greedy_step``);
    ``capture=False`` runs them eagerly.  ``plan_cache`` (a directory)
    selects the model's compiled functions that plan through it
    (``Model.with_plan``; by default the model's own)."""
    if plan_cache is not None:
        mdl = mdl.with_plan(plan_cache, mdl.autotune)
    B, S = prompts.shape
    bk = buckets if buckets is not None else Buckets.from_env()
    # a recurrent prefill (ssm, hybrid) folds pad tokens into its state:
    # exact prompt lengths there, bucketed everywhere else
    Sp = S if mdl.cfg.family in RECURRENT else bk.bucket(S)
    max_len = bk.bucket(max(Sp, S + gen_len))
    dev = mdl.device
    cache = mdl.init_cache(B, max_len)
    toks = torch.from_numpy(
        pad_tokens(np.asarray(prompts, np.int64), Sp)).to(dev)
    logits, cache = mdl.prefill(params, toks, cache)
    V = mdl.cfg.vocab_size
    tok = logits[:, S - 1:S, :V].argmax(-1)
    del logits
    positions = torch.arange(S, S + gen_len, device=dev)
    out = torch.empty(B, gen_len, dtype=torch.int64, device=dev)
    out[:, :1] = tok[:, :gen_len]
    step = greedy_step(mdl, params, cache, capture=capture)
    for i in range(1, gen_len):  # the last token needs no decode step
        tok = step(tok, positions[i - 1])
        out[:, i:i + 1] = tok
    return np.concatenate([np.asarray(prompts, np.int64),
                           out.cpu().numpy()], axis=1)


def generate_static(mdl: Model, params: dict, prompts: np.ndarray,
                    gen_len: int, kv_len: int) -> np.ndarray:
    """prompts: [B, S] int -> [B, S + gen_len] (greedy decode) with a
    cache of ``kv_len`` rows: the prompt prefilled at its length, then
    each step from ``make_decode_step(mdl, kv_len)``, attending all
    ``kv_len`` rows -- those not written yet as the zeros they hold, as
    in the reference's decode cells."""
    B, S = prompts.shape
    if S + gen_len - 1 > kv_len:
        raise ValueError(f"generate_static: {S} prompt tokens and "
                         f"{gen_len - 1} decode steps need more than "
                         f"kv_len {kv_len} cache rows")
    cache = mdl.init_cache(B, kv_len)
    toks = torch.from_numpy(np.asarray(prompts, np.int64)).to(mdl.device)
    logits, cache = mdl.prefill(params, toks, cache)
    V = mdl.cfg.vocab_size
    tok = logits[:, -1:, :V].argmax(-1)
    step = make_decode_step(mdl, kv_len)
    out = [tok]
    for i in range(gen_len - 1):
        logits, cache = step(params, cache, tok, S + i)
        tok = logits[:, -1:, :V].argmax(-1)
        out.append(tok)
    gen = (torch.cat(out, dim=1).cpu().numpy() if gen_len
           else np.zeros((B, 0), np.int64))
    return np.concatenate([np.asarray(prompts, np.int64), gen], axis=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--fusion", default="stitched", choices=["stitched", "xla"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kv-len", type=int, default=None,
                    help="decode at this static cache length "
                         "(generate_static) instead of generate's buckets")
    ap.add_argument("--param-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="the weights' type (the cache stays float32)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.supports_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode path")

    mdl = Model(cfg, args.fusion, device=args.device,
                param_dtype=getattr(torch, args.param_dtype))
    params = mdl.init(args.seed)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int64)

    t0 = time.perf_counter()
    if args.kv_len is None:
        seqs = generate(mdl, params, prompts, args.gen)
    else:
        seqs = generate_static(mdl, params, prompts, args.gen, args.kv_len)
    dt = time.perf_counter() - t0
    tput = args.batch * args.gen / dt
    kv = "" if args.kv_len is None else f" kv_len={args.kv_len}"
    print(f"arch={cfg.name} device={mdl.device} {args.param_dtype} "
          f"batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen}{kv}: {dt:.2f}s  "
          f"({tput:.1f} tok/s incl. compile)")
    print("sample:", seqs[0, args.prompt_len - 4:].tolist())


if __name__ == "__main__":
    main()
