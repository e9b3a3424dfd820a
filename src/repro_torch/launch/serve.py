"""Batched serving driver of the port: bucketed prefill and greedy decode
with a KV cache (and the SSM state of the Mamba layers).

  PYTHONPATH=src python -m repro_torch.launch.serve            # the card
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
      --reduced --device cpu

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
on the device: the host waits once, at the end.

Not ported yet: the canary, the plan cache and the mesh key of the
reference's dispatch table.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..configs.base import ARCH_IDS
from ..models.model import RECURRENT, Model
from ..serving.buckets import Buckets, pad_tokens


def generate(mdl: Model, params: dict, prompts: np.ndarray, gen_len: int, *,
             buckets: Buckets | None = None) -> np.ndarray:
    """prompts: [B, S] int -> [B, S + gen_len] (greedy decode)."""
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
    positions = torch.arange(S, S + gen_len, device=dev)
    out = []
    for i in range(gen_len):
        out.append(tok)
        if i + 1 < gen_len:  # the last token needs no decode step
            logits, cache = mdl.decode_step(params, cache, tok, positions[i])
            tok = logits[:, -1:, :V].argmax(-1)
    gen = (torch.cat(out, dim=1).cpu().numpy() if out
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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.supports_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode path")

    mdl = Model(cfg, args.fusion, device=args.device)
    params = mdl.init(args.seed)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int64)

    t0 = time.perf_counter()
    seqs = generate(mdl, params, prompts, args.gen)
    dt = time.perf_counter() - t0
    tput = args.batch * args.gen / dt
    print(f"arch={cfg.name} device={mdl.device} batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen}: {dt:.2f}s  "
          f"({tput:.1f} tok/s incl. compile)")
    print("sample:", seqs[0, args.prompt_len - 4:].tolist())


if __name__ == "__main__":
    main()
