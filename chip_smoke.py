#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--phase router|tuned|dispatch]

Run from the root of a checkout on a machine with one CUDA card (Triton
compiles the generated one-pass kernels there, nvcc the CUDA sources and
the generated streaming and anchored kernels; nothing is downloaded).
Phases, each of which makes the script exit non-zero when it fails:

1. Device: the card's name and power limit (``nvidia-smi``).
2. Kernels: each generated kernel against its plain PyTorch version on
   the card -- the one-pass kernel on the quickstart LayerNorm at [8192,
   3072]; the streaming kernel (B2: a row held on chip across a cluster
   of up to eight CTAs, its K, slice and staged columns printed on its
   line) on a softmax at [2048, 128256], a three-phase LayerNorm at
   [1024, 65536], a softmax over rows longer than a cluster holds ([64,
   600000]), an RMSNorm of bfloat16 rows at [2048, 32768] with a float32
   and with a bfloat16 output; a one-pass kernel of expm1, log1p and tanh
   (libdevice) at |x| <= 1e-4; and the rest of the reference's vocabulary
   (round, erfc, cbrt, pow, atan2, rem, nextafter; the prod/and/or row
   reductions) as one-pass kernels at [4096, 1024] and [65536, 64] and
   as streaming kernels at [64, 131072] and [256, 131072] (there the
   product's factors powers of two, exact in any order) -- each element
   held to 1e-5 |plain| + 1e-5 mean|plain| (the expm1 and vocabulary
   groups to 1e-5 |plain| alone; a bfloat16 output to one bfloat16 ulp,
   2^-7 |plain|, the rounding of its own last step) --
   with kernel, plain and library-call times (CUDA events, median, the
   call queued behind a device sleep so only device time counts) and
   the least time the card could take (bytes over 3.35 TB/s, element-wise
   operations over 67 TFLOP/s float32, products over 165 TFLOP/s, the
   float32 rate of the tensor cores' 495 TFLOP/s TF32 through a three-way
   split; H100 SXM data sheet).
3. CUDA kernels: ``nvcc`` builds ``src/repro_torch/csrc`` (timed), then
   the RMSNorm kernel at [2048, 3072] and [4, 3072], the LayerNorm
   forward and backward kernels at the train path's [4096, 1280], at a
   ragged [4000, 1280] and at the quickstart's [8192, 3072], the router
   softmax forward and backward kernels at Granite's [2048, 32] (prefill),
   [4, 32] (decode) and [4096, 32] (train), at a ragged [4095, 40], at
   the prefill rows one float past an aligned address and at [256, 4096]
   (wider than the one-warp path), each line naming the layout the call
   took (``kernels/softmax.py::layout``), and the flash attention
   kernel at the prefill shape (causal), at a ragged Sq = Skv = 500, with
   Sq 200 < Skv 500 (causal offset), non-causal, at the HuBERT train
   path's [8, 16, 512, 80] non-causal, at Granite's head dim 64
   ([4, 16 (Hkv 8), 512, 64] and [8, 16 (Hkv 8), 512, 64], causal) and
   at Zamba2's prompt ([4, 32, 500, 64] causal, ragged) and at Gemma-7B's
   heads ([4, 16, 512, 256], causal), each against the same function in
   float64 (the plain version on float64 inputs; the float32 plain
   version's own distance is printed beside it) with the same
   per-element limit and the same times; the
   RMSNorm kernel also at the recurrent paths' prefill (2000), decode (4)
   and train (4096) rows at 1,024 (Mamba2's blocks), 2,048 (its gated
   norm, Zamba2's blocks) and 4,096 columns (Zamba2's concat and gated
   norm; no train rows); and the SSD scan kernel (B11: three launches
   a call, its products on the tensor cores) at Mamba2's
   prefill ([4, 512, 32, 64], N 128), Zamba2's prefill ([4, 512, 64, 64],
   N 64), Mamba2's train batch ([8, 512, 32, 64], N 128), a head dim
   and state that no config carries ([2, 512, 16, 32], N 96), Mamba2's
   prefill at a chunk of 128 (launches at 64) and P = N = 256 ([2, 512,
   8, 256], in P slices that fit a block), x, B and C
   strided slices of one [b, L, conv_dim] activation as the model passes
   them, y and the state each within 1e-4 max(1, max|plain|); and the
   flash decode kernel at Llama's decode_32k ([4, 24 (Hkv 8), 32768,
   128] and batch 1), Granite's [4, 16 (Hkv 8), 32768, 64], Zamba2's
   long_500k ([1, 32, 524288, 64]), a ragged kv_len of 1,000 of 1,024, a
   live prefix (1,500 of 2,048) of a layer's view, Gemma-7B's heads at
   decode_32k ([4, 16, 32768, 256]), head dim 80 (read in place by the
   128 instance, its columns masked at 80) and 16 query heads a KV head
   (two sub-groups), each element within r |plain| + r mean|plain|, r =
   1e-5 max(1, sqrt(kv_len / 32768)), with SDPA as its library call;
   then the rows above head dim 256 (phase 3a); then B8's time at one
   cache against the query heads a KV head (1 to 8, and 16).
   Beside RMSNorm's prefill row and the
   LayerNorm backward's train row it prints the time of one PyTorch
   element-wise op moving the same bytes (``torch.mul``, ``torch.add``).
   Each check of the flash,
   SSD and decode kernels prints the launches it made, by kernel, and
   fails unless the kernel meant for its shape ran.
3a. Above head dim 256 (``phase_wide``): the wide flash kernel
   (``csrc/flash_attention_wide.cu``, on the tensor cores) at [4, 16,
   512, D] causal for D 320, 264 and 512, at [2, 16, 512, 300], at D 320
   with 4 KV heads and with Sq 200 < Skv 500, and at [1, 8, 512, 640]
   non-causal (two output tiles), against float64 as B4; B8 at [1, 8
   (Hkv 2), 4096, 320] over 4,000 rows, [1, 16 (Hkv 2), 4096, 512] over
   3,999 (two sub-groups), D 264 and D 640 (the tiled kernel), against
   its function in float64 at B8's limit; then the device time of each
   kernel of the D 320 decode call.
3b. Anchored kernels (compute-anchored stitching, on by default):
   ``stitched_jit`` folds memory-bound chains into B3 (the fused matmul,
   one generated instance of ``csrc/matmul_fused.cuh`` a chain) and into
   flash attention's score functor (B4's ``score_mod``).  B3 at the Llama
   MLP's gate projection with its SiLU x up epilogue (M 2048 prefill, M 4
   decode, a ragged M 2000; K 3072, N 8192), at bench_anchor_fusion's MLP
   block (its own shapes and M 2048, K 3072, N 8192: the prologue and both
   epilogues) and with a row-reducing epilogue (RMSNorm, softmax, row
   minimum at N 256); B4 + score_mod on the bench's attention block (B 2,
   H 4, S 128, D 64, bias [1, 1, S, S]) and at Llama's heads and prompt.
   Each against its plain version (B3: within 1e-5 max(1, max|plain|)
   plus three times the plain version's own float32 distance from
   float64; score_mod: B4's limit against float64), with kernel, plain
   and library times
   (``torch.matmul`` of the product alone, which computes less than B3;
   SDPA with the bias as its mask) and the bound; then the counted run of
   the bench's two blocks (2 B3 launches, 1 score_mod launch).  Every
   later phase prints its anchored groups and B3 launches per call or
   step, and holds its anchored instances against their plain versions;
   ``describe`` lists each anchored group (its product's operands, the
   folded primitives, the reductions its prologue and epilogue hold).
3c. Router floor (``phase_router_floor``): one empty launch; B7 and B10
   alone at Granite's prefill and train rows, beside ``torch.softmax`` and
   ``torch._softmax_backward_data``; the router pair (the product, then
   B7) at the prefill and decode rows and the backward pair (the
   gradient's add, then B10), each beside its producer alone; the host's
   cost of one B7 call, layer by layer.  ``--phase router`` runs only the
   device line, the build and this phase, and ends with its rows as JSON
   (for comparing trees in one call; no path runs).
3d. Anchor forms (``phase_anchor_forms``): B3 with a prologue that
   reduces over K (an RMSNorm feeding Llama's gate projection, M 2048, K
   3072, N 8192, built directly since the plan leaves it memory-only, and
   feeding Granite's router, K 1024, N 32, which the plan folds; the
   statistics pass's extra lhs reads printed), B3 with
   a softmax epilogue across the N tiles of a cluster (M 2048, K 3072, N
   512 and 2048), and the wide flash kernel with a generated score
   functor (B 4, H 16, S 512, D 320, causal, bias [1, 1, 512, 512];
   against float64, SDPA with the bias and the causal mask as its
   library call), each as 3b; then the counted run of the router-width
   RMSNorm, the N 2048 softmax and a wide attention through
   ``stitched_jit`` (one launch of each form).
3e. Differentiable (``phase_differentiable``): ``stitched_jit(fn,
   differentiable=True)`` forward and backward (loss sum(y ** 2)) on the
   Fig. 1 LayerNorm at [8192, 3072] and on Llama-3.2-3B's MLP input chain
   (RMSNorm, then SiLU(h w_gate) x (h w_up); M 2048, K 3072, N 8192):
   the launches of one counted step, each gradient within 1e-4 max(1,
   max|g|) of plain autograd on the card, forward and backward device
   times against eager autograd (and ``F.layer_norm``'s), the backward's
   kernels and HBM bytes stitched against unfused.
3f. Dispatch (``phase_dispatch``; ``--phase dispatch`` runs it alone):
   ``stitched_jit``'s ``dispatch="single"`` as one replayed CUDA graph a
   call, against the same schedule run eagerly, on the Fig. 1 LayerNorm
   at [8192, 3072] (beside ``F.layer_norm``), ``mini_transformer``
   (``tests/test_plan_dispatch.py``) at 2048 x 3072 with an 8192-wide
   hidden product, and Llama-3.2-3B's ``block_post`` called standalone at
   batch 1 x 128: the first call (eager), the second (a warm-up run,
   the capture), ``exec_count`` unchanged over three more, walls (host clock, each call waited for)
   and device times (CUDA events, queued; profiler busy), the replay's
   kernels against the eager schedule's by name and count, the output
   against ``dispatch="interpret"`` (1e-5 max(1, max|y|); 1e-4 where a
   B3 or B4 group runs) and the eager schedule, an earlier output kept
   intact while the input changes in place (a second graph), every
   generated and anchored instance against its plain version; the
   LayerNorm with ``donate=True`` (its output written over x); calls
   whose addresses do not simply repeat (``traffic_rows``): the
   ``block_post`` looped over 28 per-layer weight sets (no capture
   allowed) and h = f(h) with the LayerNorm, wall a call against the
   eager schedule, and one LayerNorm function at six row counts with the
   device memory reserved before and after and the graphs it keeps; then
   the counted run, one call of each.
4. Forward path (``fusion_mode="xla"``): Llama-3.2-3B at full width, all
   28 layers, batch 4, prompt 512, float32 weights from a seed:
   ``Model.forward`` (a stitched_jit block per layer, then a stitched head
   with the softmax over the vocabulary), its compile and step times, the
   plans, the launch count of each kernel, and the agreement with the same
   graphs replayed op by op in plain PyTorch on the card
   (``dispatch="interpret"``).  Every generated kernel instance of the
   path is then held against its plain version at its shapes.
5. Serving path (``fusion_mode="stitched"``, the default): the same model
   through ``repro_torch.launch.serve.generate`` -- 4 prompts of 500
   tokens (bucket 512), 16 greedy tokens, cache length 1024 -- with its
   compile seconds, time to first token, decode ms per token, tokens/s,
   launches per prefill and per decode step, a profile of each, one
   decode step with the static kv_len = pos + 1 (flash decode) held
   against the device-valued one (Llama only), the
   device's busy share of a decode step, every generated kernel instance
   of the prefill and decode signatures held against its plain version at
   its shapes, and the logits of every step held against the plain path
   (``"xla"`` with ``dispatch="interpret"``: no kernel of any kind, its
   steps eager) fed the same tokens.  ``generate`` decodes through one
   captured CUDA graph a step (``launch/serve.py::greedy_step``); the
   phase times its replays against the same step run eagerly, profiles
   both (``captured_vs_eager``: device busy beside the walls,
   launches a step from the profiler, and a failure unless the replay
   calls no kernel wrapper and runs the eager step's kernels, by name and
   count).
5b. Scheduler (``phase_scheduler``, after the serving phases of Llama,
   Granite and Zamba2, on the same model): ``ContinuousBatcher`` with 4
   slots of 1,024 rows, 12 seeded requests for Llama (4 for the others)
   with prompts of 100-500 tokens cycling through the buckets 128, 256
   and 512, 16 tokens each, every decode wave one replayed CUDA graph:
   a cold run (compiles, the capture), then the counted run of the same
   requests (launches: the wrappers' eager counts and, at each replay,
   the launches recorded into the graph), tokens/s, TTFT and ms a wave
   (p50, p99); the same requests through eager waves (the same tokens
   required); every prefill and wave of the counted run replayed on the
   plain path fed the same tokens (logits within 1e-4 max(1,
   max|logits|), an MoE model row by row as in 7, each greedy token the
   plain path's argmax); one wave profiled captured and eager as above;
   the wave graph's dependency edges (``graph_edges``: a B7 launch keeps
   a programmatic edge) and a replayed wave's device time by kind.  Each
   bucketed prefill (Llama, Granite) is one replayed CUDA graph a bucket
   (its greedy token held to the plain path's argmax, its logits rows
   taken from the eager batcher's same prefill); ms a prefill by bucket,
   captured against eager, graphs and pool bytes, and one bucket's
   prefill profiled captured and eager as above.
5c. Tuned (``phase_tuned``, run after phase 12, the last of the paths;
   ``--phase tuned`` runs it alone): tune once, run many.  Llama-3.2-3B at full
   width and depth through ``ContinuousBatcher`` (4 slots of 1,024 rows,
   4 seeded requests of 257-500 tokens, all in the 512 bucket, 8 tokens
   each: one prompt bucket and the decode wave are tuned) with
   ``autotune=True`` into an emptied plan cache (``build/
   plan_cache_tuned``): every compiled signature planned, its top-k
   partitions raced on the card (each branch one replayed CUDA graph),
   its patterns' and stitched groups' schedules swept, and stored; the
   cold seconds and the seconds measuring; per compiled function the
   candidates and branches raced, the winner's index and time against
   the model pick's, the groups whose measured pin differs from the
   model's (both timed); a race timeout or a disqualified branch fails
   the phase.  Every generated and anchored kernel of the tuned plans is
   held against its plain version.  The cold run's prefills and waves
   are replayed on the plain path (logits within 1e-4 max(1,
   max|logits|), every greedy token the plain argmax).  Then a fresh
   ``Model`` on the same cache (warm): every compile a hit, no
   exploration, no stitching pass, 0 s measuring, its launches counted,
   the same tokens; the tuned plans' wave and TTFT against the cost
   model's plans on the same requests; the head softmax [2048, 128256]:
   the tuner's candidates, the streaming kernel's time beside its
   estimate, and a one-pass kernel of one row a program (built without
   the register cap) beside it.
6. Train path (``fusion_mode="stitched"``): HuBERT-XLarge at full width
   and depth (48 layers, d_model 1280, 16 x 80 heads, float32) through
   ``repro_torch.launch.train.build_trainer``, batch 8 x 512 frames, 5
   AdamW steps: step ms, frames/s, launches per step, a profile of one
   step, peak memory; then the same weights and batches through
   ``fusion_mode="xla"`` (the plain oracles, no kernel of any kind): the
   step-0 loss, the step-0 gradients tensor by tensor, their global norm
   and the loss of every step held against it.
7. MoE serving path: Granite-3.0-1B-A400M at full width and depth (24
   layers, 32 experts top-8, d_ff 512, float32) through ``generate`` as
   in 5, the router softmax kernel once a layer per prefill and per
   decode step; also the full-width MoE layer check (one layer's
   ``moe_apply`` on the kernel and the plain path, same input: routing
   flips counted, the output held on the other tokens), and the
   teacher-forced logits held row by row -- all 2,048 prefill rows and
   every decode row -- since a routing flip moves a row by a gate share.
8. MoE train path: the same model through ``build_trainer`` as in 6, batch
   8 x 512 tokens, with the softmax backward kernel once a layer per step;
   the step-0 routing flips between the two paths are counted, and where
   there are any the step-0 comparison is made with the plain path
   teacher-forced onto the kernel path's routing.
9. SSM serving path: Mamba2-370m at full width and depth (48 layers,
   d_model 1024, 32 heads of 64, state 128, float32) through
   ``generate`` as in 5, with the prompt at its exact 500 tokens (a
   recurrent prefill takes no pad): the SSD kernel once a layer per
   prefill (three launches a call), none per decode step.
10. Hybrid serving path: Zamba2-1.2B the same way (38 Mamba layers, state
   64, the shared attention block before every 6th layer: 7 KV caches),
   flash attention once a shared application per prefill.
11. SSM train path: Mamba2-370m through ``build_trainer`` as in 6, batch
   8 x 512 tokens, the SSD kernel once a layer per step (three launches a
   call; its backward is the VJP of the plain oracle, as in the
   reference).
11b. bfloat16 (``phase_bf16_kernels``, ``phase_bf16_paths``: each model
   with ``param_dtype=torch.bfloat16``, full width and depth, freed before
   the next; ``--phase bf16`` alone, 5e in its help): the kernels'
   bfloat16 instances -- B6 at [2048, 3072] and [4, 3072]; B4 at Llama's
   prefill (B4 Hq24 Hkv8 S512 D128 causal), D 64 and D 256, and with a
   bias score functor at Llama's heads; B8 at decode_32k with a bfloat16
   q against float32 and against bfloat16 caches; B3 at Llama's gate x
   SiLU x up, M 2048 and the decode tile's M 4; B11 at Mamba2's prefill
   and train shapes and Zamba2's prefill (x, B and C strided slices of
   one bfloat16 activation); B5 and B9 at [4096, 1280] and [8192, 3072];
   B7 and B10 at [2048, 32] and [256, 4096] -- each within the
   reference's bfloat16 band of its plain version (rtol = atol 2e-2; 4e-2
   and 1.2e-1 anchored) and no more than 2x the plain version's distance
   from float64 of the same inputs (float32 outputs -- statistics, the
   scan's state, dgamma and dbeta -- by their float32 limits), its bound
   at 989 TFLOP/s (bf16; B11's products at TF32's 495) or 3.35 TB/s, with
   ``F.rms_norm``, ``F.layer_norm``, ``native_layer_norm_backward``,
   ``torch.softmax``, ``_softmax_backward_data``, SDPA or
   ``torch.matmul`` in bfloat16 beside it.  Then the paths
   (``BF16_PATHS``): Llama-3.2-3B's forward at 4 x 512 and ``generate``
   (batch 4, 500 prompt tokens, 16 greedy, the float32 cache of 1,024
   rows, each decode step one replayed graph), its logits (every step's,
   teacher-forced) no further from a float32 plain run of the same
   weights than 1.5 times the bfloat16 plain path's distance plus 1e-3
   max(1, max|logits|); its training with remat ("full"), batch 8 x 512,
   5 AdamW steps through ``make_train_step(donate=True)``: step 0's loss
   and gradients by the same rule, its gradients with remat equal to
   those without within a bfloat16 ulp, B4 and B6 twice a layer a step;
   Mamba2-370m's ``generate`` (B11 in bfloat16 in its prefill) and its
   training with remat (B11 and B6 twice a layer); Zamba2-1.2B's
   ``generate`` (B11 at H 64 N 64, B4 at D 64); HuBERT-XLarge's training
   without remat, 8 x 512 frames (B5 97 and B9 194 launches a step, B4
   at D 80); Granite-3.0-1B-A400M's forward and ``generate`` (the router
   softmax float32 behind its cast) -- each by the same rules and
   launch counts; and Zamba2-1.2B's float32 training through
   ``build_trainer`` as in 6, at batch 4 x 512 (``HYBRID_TRAIN_BATCH``:
   its plain path does not fit at 8 after the earlier phases) (SSD
   three launches a layer, two RMSNorms a layer and a shared application,
   one attention a shared application).
12. Static-decode paths (``make_decode_step(mdl, kv_len)``, the
   reference's decode cells): Llama-3.2-3B at decode_32k (28 layers,
   batch 4, a 30 GB cache of 32,768 rows from the seeded generator) and
   Zamba2-1.2B at long_500k (batch 1, 7 shared-block caches of 524,288
   rows, 60 GB; SSM state from zeros), 4 greedy steps at the last
   positions each: compile seconds, ms per step, launches per step (flash
   decode once an attention layer), a profile of one step, every step's
   logits held against the plain path fed the same tokens.  The step of
   ``make_decode_step`` is one captured graph: timed as replays, against
   the same steps eager (``captured_vs_eager``).
13. Whether each B3, B4 and B11 instance built in the run holds
   tensor-core instructions (``cuobjdump -sass``: ``HGMMA`` in B3, ``HMMA``
   ``.TF32`` in B4, in the wide flash kernel and in B11's chunk and
   output passes), printed once;
   then a ``{"scheduler": {...}}`` line (phase 5b's numbers by model), a
   ``{"tuned": {...}}`` line (phase 5c's), a ``{"differentiable":
   {...}}`` line (phase 3e's), a ``{"dispatch": {...}}`` line (phase
   3f's) and
   a ``{"kernels": [...]}`` summary line (per kernel: the times of
   its main-path instance, else of its checked instance that moves the most
   bytes, the largest error of any instance, ``timing`` saying how the
   times were taken, launches by path), then the last line
   ``{"ok": true, "device": {...}}``.

Imports ``torch`` and the port only.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM data-sheet peaks (dense, at the 700 W limit): element-wise
#: operations at float32's rate on the CUDA cores; products (contractions)
#: at the float32 rate the tensor cores give through the three-way TF32
#: split, a third of 495 TFLOP/s of TF32.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SPLIT_OPS_PER_S = 495e12 / 3

SEED = 0
BATCH, PROMPT = 4, 512
SERVE_PROMPT, SERVE_GEN = 500, 16
TRAIN_BATCH, TRAIN_FRAMES, TRAIN_STEPS = 8, 512, 5
#: Zamba2's train batch, halved: at 8 x 512 its plain path peaked at
#: 81.68 GB alone (run 28C) and ran out of the card's 79.18 GiB after the
#: earlier phases (run 28F)
HYBRID_TRAIN_BATCH = TRAIN_BATCH // 2
#: Llama-3.2-3B's MLP: d_model (B3's K) and d_ff (its N)
ANCHOR_K, ANCHOR_N = 3072, 8192
MOE_ARCH = "granite-moe-1b-a400m"
SSM_ARCH, HYBRID_ARCH = "mamba2-370m", "zamba2-1.2b"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


#: Device cycles the card sleeps before each timed call (about 1 ms at
#: 1.98 GHz): the host enqueues the call meanwhile, so the event pair
#: brackets device time only, not the wrapper's Python and ctypes cost.
QUEUE_CYCLES = 2_000_000
#: How the ``kernels`` line's times were taken: ``ms``, ``plain_ms`` and
#: ``library_ms`` are device time (``time_ms`` queued); ``call_ms`` is the
#: kernel's call with the host's cost (``time_ms`` not queued).
TIMING = "device; call_ms with the host's cost"


def time_ms(fn, reps: int, *, queued: bool = True) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after a warm-up.

    ``queued`` (device time): the card sleeps first, so the call is
    already queued when the first event fires.  Without it the events
    also see the host's cost of the call when the card idles for it.
    """
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_bound(em, graph) -> tuple[float, str, int, int]:
    """(bound ms, "bytes"|"operations", bytes, ops) of one generated
    kernel: its inputs read once and outputs written once over the HBM
    rate, its element operations over the float32 peak."""
    nbytes = (sum(graph.node(i).nbytes for i in em.ext_ids)
              + sum(graph.node(o).nbytes for o in em.out_ids))
    members = frozenset(n for p in em.parts for n in p)
    ops = graph.subgraph_flops(members)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def random_inputs(em, graph, gen):
    import torch
    from repro_torch.core.tracer import TORCH_DTYPES

    vals = []
    for i in em.ext_ids:
        spec = graph.node(i).spec
        dt = TORCH_DTYPES[spec.dtype]
        if dt.is_floating_point:
            vals.append(torch.randn(spec.shape, generator=gen, device="cuda",
                                    dtype=torch.float32).to(dt))
        elif dt == torch.bool:
            vals.append(torch.rand(spec.shape, generator=gen,
                                   device="cuda") > 0.5)
        else:
            vals.append(torch.randint(0, 16, spec.shape, generator=gen,
                                      device="cuda", dtype=dt))
    return vals


#: Per-element limit of a kernel against its plain version, float32 with
#: another summation order: RTOL |want| + FLOOR mean|want|.  The relative
#: term holds each element to a few ulp; the floor, scaled by the
#: output's typical size, covers elements near zero after cancellation
#: (a LayerNorm's bias).  A softmax over 128,256 columns (mean 7.8e-6)
#: gets a floor of 7.8e-11, so a kernel 1% off anywhere fails.
RTOL, FLOOR = 1e-5, 1e-5


def agreement(got, want, rtol: float = RTOL,
              floor: float = FLOOR) -> tuple[float, float]:
    """(max |got - want|, the largest ratio of |got - want| to its limit
    rtol |want| + floor mean|want|) over matching output tensors: the
    check passes while the ratio is at most 1.  Where ``want`` is not
    finite (the function's own value there, as fmod by zero), ``got``
    must be the same NaN or infinity, else both numbers are infinite;
    the finite elements are held to the limit, with the mean taken over
    them."""
    import torch

    err = worst = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        fin = torch.isfinite(w)
        same = torch.where(fin, torch.isfinite(g),
                           (g == w) | (torch.isnan(g) & torch.isnan(w)))
        if not bool(same.all()):
            return math.inf, math.inf
        diff = torch.where(fin, (g - w).abs(), 0.0)
        mean = float(w[fin].abs().mean()) if bool(fin.any()) else 0.0
        limit = (rtol * w.abs() + floor * mean) \
            .clamp_min(torch.finfo(torch.float32).tiny)
        err = max(err, float(diff.max()))
        worst = max(worst, float(torch.where(fin, diff / limit, 0.0).max()))
    return err, worst


def check_kernel(em, graph, gen, *, label: str, reps: int,
                 library=None, inputs=None, rtol: float = RTOL,
                 floor: float = FLOOR, want=None, keep: bool = False) -> dict:
    """Hold one generated kernel against its plain version on the card
    (or against ``want``, where given), on ``inputs`` (else standard
    normal ones); ``keep`` returns its outputs too (``_got``).

    Tolerance: ``agreement`` (per element, relative to the plain value).
    Launches made here are reset before the main path and never counted
    there.
    """
    import torch

    kern = em.fn
    vals = random_inputs(em, graph, gen) if inputs is None else inputs
    got = kern.launch(*vals)
    if want is None:
        want = kern.plain(torch.device("cuda"), *vals)
    torch.cuda.synchronize()
    err, worst = agreement(got, want, rtol, floor)
    per_out = [round(agreement([g], [w], rtol, floor)[1], 4)
               for g, w in zip(got, want)]
    ms = time_ms(lambda: kern.launch(*vals), reps)
    call_ms = time_ms(lambda: kern.launch(*vals), reps, queued=False)
    plain_ms = time_ms(lambda: kern.plain(torch.device("cuda"), *vals),
                       max(3, reps // 4))
    lib_ms = time_ms(lambda: library(*vals), reps) if library else None
    bound, bound_by, nbytes, ops = kernel_bound(em, graph)
    geometry = f"BR={kern.BR}"
    if kern.schedule == "streaming":
        K, width, staged = kern.cluster()
        geometry = f"cluster={K} slice={width} staged={staged}"
    print(f"kernel {kern.schedule:9s} {label}: R={kern.R} C={kern.C} "
          f"{geometry} max_abs_err={err:.3e} (worst err/limit "
          f"{worst:.3f}, limit {rtol:g}|plain| + {floor:g} mean|plain|) "
          f"ms={ms:.4f} (call with the host's cost: {call_ms:.4f}) "
          f"plain_ms={plain_ms:.4f} library_ms="
          f"{'n/a' if lib_ms is None else f'{lib_ms:.4f}'} "
          f"bound_ms={bound:.4f} ({bound_by}: {nbytes} B, {ops} ops)"
          + (f" worst err/limit by output {per_out}" if len(got) > 1
             else ""))
    if not all(bool((torch.isfinite(g.float())
                     | ~torch.isfinite(w.float())).all())
               for g, w in zip(got, want)):
        fail(f"{label}: kernel output not finite where its reference is")
    if not worst <= 1.0:
        fail(f"{label}: kernel disagrees with its plain version "
             f"(worst err/limit {worst:.3f})")
    return {"max_abs_err": err, "worst": worst, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib_ms, "_bytes": nbytes,
            **({"_got": got} if keep else {})}


def only_generated(compiled, schedule: str):
    ems = [e for e in compiled.emitted if e.kind == schedule]
    if len(ems) != 1:
        fail(f"expected one {schedule} kernel, got {compiled.report.schedules}")
    return ems[0]


def phase_kernels(gen) -> None:
    """The two stand-alone kernel checks at the widths users call."""
    import torch
    from repro_torch.core import stitched_jit

    def layer_norm(x, gamma, beta):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + 1e-6) * gamma + beta

    x = torch.randn(8192, 3072, generator=gen, device="cuda")
    g = torch.randn(3072, generator=gen, device="cuda")
    b = torch.randn(3072, generator=gen, device="cuda")
    c = stitched_jit(layer_norm).compiled(x, g, b)
    em = only_generated(c, "onepass")
    check_kernel(em, c.graph, gen, label="layernorm [8192, 3072]", reps=50,
                 library=lambda xv, gv, bv: torch.nn.functional.layer_norm(
                     xv, (3072,), gv, bv, 1e-6))

    def normalize(x):  # layer_norm without gamma and beta
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + 1e-6)

    # the streaming kernel (B2): the head's softmax, a three-phase
    # LayerNorm with and without its column inputs gamma and beta (read
    # from device memory in the last phase), rows longer than a cluster
    # holds, bfloat16 rows
    for (R, C), fn, label, lib in (
            ((2048, 128256), lambda v: torch.softmax(v, -1), "softmax",
             lambda v: torch.softmax(v, -1)),
            ((1024, 65536), layer_norm, "layernorm (three phases)",
             lambda xv, gv, bv: torch.nn.functional.layer_norm(
                 xv, (xv.shape[-1],), gv, bv, 1e-6)),
            ((1024, 65536), normalize,
             "layernorm without gamma and beta (three phases)",
             lambda xv: torch.nn.functional.layer_norm(
                 xv, (xv.shape[-1],), None, None, 1e-6)),
            ((64, 600000), lambda v: torch.softmax(v, -1),
             "softmax longer than a cluster holds",
             lambda v: torch.softmax(v, -1))):
        args = [torch.randn(R, C, generator=gen, device="cuda")]
        if fn is layer_norm:
            args += [torch.randn(C, generator=gen, device="cuda")
                     for _ in range(2)]
        c = stitched_jit(fn).compiled(*args)
        em = only_generated(c, "streaming")
        check_kernel(em, c.graph, gen, label=f"{label} [{R}, {C}]",
                     reps=10, library=lib,
                     inputs=ordered(c, em, args))
        del args, c, em

    def rms_f32(x, g):  # bfloat16 rows in, float32 out
        xf = x.float()
        return xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + 1e-6) * g

    def rms_bf16(x, g):  # bfloat16 rows in and out, float32 inside
        return rms_f32(x, g).to(x.dtype)

    # the float32 output against the plain version; the bfloat16 output
    # (same cluster geometry, same sums) bit for bit against the float32
    # kernel's output rounded to nearest even
    xb = torch.randn(2048, 32768, generator=gen, device="cuda").bfloat16()
    gb = torch.randn(32768, generator=gen, device="cuda")
    want = None
    for fn, out in ((rms_f32, "float32"), (rms_bf16, "bfloat16")):
        c = stitched_jit(fn).compiled(xb, gb)
        em = only_generated(c, "streaming")
        exact = want is not None
        res = check_kernel(
            em, c.graph, gen, label=f"rmsnorm bfloat16 in, {out} out "
            "[2048, 32768]" + (" (bit for bit: the float32 kernel's output "
                               "rounded)" if exact else ""), reps=10,
            inputs=ordered(c, em, [xb, gb]), want=want, keep=not exact,
            rtol=0.0 if exact else RTOL, floor=0.0 if exact else FLOOR,
            library=lambda xv, gv, _f=fn: _f(xv, gv))
        if not exact:
            want = [res["_got"][0].to(torch.bfloat16)]
    del xb, gb, want, res

    # expm1, log1p and tanh (libdevice) near 0, each element held to a
    # relative limit alone: exp(x) - 1 is off by up to 2^-24 / |x| relative
    def near_zero(v):
        return torch.expm1(v), torch.log1p(v), torch.tanh(v)

    xz = (torch.rand(4096, 1024, generator=gen, device="cuda") * 2 - 1) \
        * 1e-4
    c = stitched_jit(near_zero).compiled(xz)
    em = only_generated(c, "onepass")
    check_kernel(em, c.graph, gen, label="expm1+log1p+tanh |x| <= 1e-4 "
                 "[4096, 1024]", reps=20, inputs=[xz], floor=0.0)

    # the rest of the reference's vocabulary (libdevice round, erfc, cbrt,
    # pow, atan2, fmod, nextafter; the prod/and/or row reductions), each
    # element within 1e-5 |plain| alone.  The reductions run over rows of
    # 64: a float32 product's rounding in another order grows with its
    # length (up to ~n 2^-24 relative), past 1e-5 at 1,024 factors.
    from repro_torch.core.codegen import emit_pattern

    # the streaming rows are forced with a planner budget that admits the
    # seven-output group's column tile (the H100 preset runs it packed)
    import dataclasses
    from repro_torch.core import H100

    wide = dataclasses.replace(H100, vmem_bytes=1 << 20)
    elementwise = "round+erfc+cbrt+pow+atan2+rem+nextafter"
    reductions = "reduce_prod+reduce_and+reduce_or"
    for (R, C), reduces, label, kind in (
            ((4096, 1024), False, elementwise, "onepass"),
            ((65536, 64), True, reductions, "onepass"),
            ((64, 131072), False, elementwise, "streaming"),
            ((256, 131072), True, reductions, "streaming")):
        g, pat = vocabulary_group(R, C, reduces,
                                  exact_prod=kind == "streaming")
        em = emit_pattern(g, pat, hw=wide if kind == "streaming" else H100)
        if em.kind != kind:
            fail(f"the vocabulary group at [{R}, {C}] ran {em.kind}, not "
                 f"as a {kind} kernel")
        x = torch.randn(R, C, generator=gen, device="cuda")
        y = torch.randn(R, C, generator=gen, device="cuda")
        check_kernel(em, g, gen, label=f"{label} [{R}, {C}]", reps=20,
                     inputs=[x, y], floor=0.0)


def ordered(comp, em, args) -> list:
    """The call's arguments in the order of the group's inputs."""
    given = dict(zip(comp.graph.inputs, args))
    return [given[i] for i in em.ext_ids]


def vocabulary_group(R: int, C: int, reductions: bool,
                     exact_prod: bool = False):
    """One group over x, y [R, C] with a node of each primitive the
    generator lowers through libdevice: round(4 x), erfc(x), cbrt(x),
    pow(|x| + 0.5, y), atan2(x, y), rem(10 x, y), nextafter(x, y); or
    (``reductions``) of each new row reduction: prod(1 + x / 100) --
    with ``exact_prod``, of 2 where x > 3, 1/2 where x < -3 and 1
    elsewhere (powers of two: exact in any order, however long the row;
    a float32 product of 131,072 factors in another order is not) --
    and(x > -3), or(x > 3), beside x y.  Built in the IR: the tracer
    lowers no aten op to round, erfc, cbrt, rem, nextafter or these
    reductions."""
    from repro_torch.core.classify import classify
    from repro_torch.core.ir import Graph, Node, OpKind, TensorSpec
    from repro_torch.core.tracer import make_fn

    g = Graph()

    def add(prim, ins, shape=(R, C), dtype="float32", value=None, **params):
        kind = (OpKind.INPUT if prim == "input" else
                OpKind.CONST if prim == "const" else classify(prim))
        spec = TensorSpec(shape, dtype)
        if kind not in (OpKind.INPUT, OpKind.CONST):
            params["_fn"] = make_fn(prim, params, spec)
        nid = len(g.nodes)
        g.add(Node(nid, prim, kind, tuple(ins), spec, params, value))
        if kind is OpKind.INPUT:
            g.inputs.append(nid)
        return nid

    def const(v, dtype="float32"):
        return add("const", (), (), dtype, value=v)

    x, y = add("input", ()), add("input", ())
    if not reductions:
        outs = [add("round", (add("mul", (x, const(4.0))),)),
                add("erfc", (x,)), add("cbrt", (x,)),
                add("pow", (add("add", (add("abs", (x,)), const(0.5))), y)),
                add("atan2", (x, y)),
                add("rem", (add("mul", (x, const(10.0))), y)),
                add("nextafter", (x, y))]
    else:
        if exact_prod:
            lo = add("select_n", (add("lt", (x, const(-3.0)), dtype="bool"),
                                  const(1.0), const(0.5)))
            factor = add("select_n", (add("gt", (x, const(3.0)),
                                          dtype="bool"), lo, const(2.0)))
        else:
            factor = add("add", (const(1.0), add("mul", (x, const(0.01)))))
        outs = [add("mul", (x, y)),
                add("reduce_prod", (factor,), (R,), axes=(1,))]
        for prim, thr in (("reduce_and", -3.0), ("reduce_or", 3.0)):
            gt = add("gt", (x, const(thr)), dtype="bool")
            outs.append(add(prim, (gt,), (R,), "bool", axes=(1,)))
    g.outputs = outs
    return g, frozenset(n for n in g.nodes
                        if g.node(n).kind not in (OpKind.INPUT,
                                                  OpKind.CONST))


def describe(name: str, compiled) -> None:
    rep, graph = compiled.report, compiled.graph
    n_dot = sum(1 for n in graph.nodes.values() if n.prim == "dot_general")
    n_ops = sum(1 for n in graph.nodes.values()
                if n.prim.startswith("repro_torch."))
    print(f"{name}: nodes={len(graph)} dot_general={n_dot} "
          f"custom_ops={n_ops} "
          f"groups={rep.n_groups} generated={rep.n_generated} "
          f"onepass={rep.n_onepass} streaming={rep.n_streaming} "
          f"packed={rep.n_packed} stitched={rep.n_stitched} "
          f"anchored={rep.n_anchored} "
          f"reused={rep.emission_reused} plan_s={rep.plan_time_s:.3f} "
          f"schedules={rep.schedules}")
    groups = anchored_groups(compiled)
    if groups:
        print(f"  {name.strip()} anchored groups: {json.dumps(groups)}")


def anchored_groups(compiled) -> list:
    """Each anchored group of a compiled function: its product's operand
    shapes (or attention's q shape), the folded primitives, and the
    reductions its prologue and epilogue hold."""
    graph = compiled.graph
    out = []
    for em in compiled.emitted:
        if em.kind != "anchored":
            continue
        members = [n for p in em.parts for n in p]
        dots = [n for n in members if graph.node(n).prim == "dot_general"]
        entry = getattr(em.fn, "entry", None)
        out.append({
            "operands": [[list(graph.node(i).spec.shape)
                          for i in graph.node(d).inputs] for d in dots],
            "folded": sorted(graph.node(n).prim for n in members
                             if graph.node(n).prim != "dot_general"),
            "prologue_reductions": getattr(entry, "pro_slots", 0),
            "epilogue_reductions": getattr(entry, "epi_slots", 0),
            "wide_score_mod": bool(getattr(getattr(
                em.fn, "score_mod", None), "wide", False))})
    return out


def kernel_kind(name: str) -> str:
    low = name.lower()
    if any(k in low for k in ("rms_vec_kernel", "rms_scalar_kernel",
                              "rms_ring_kernel")):
        return "cuda rmsnorm"
    if "flash_fwd_kernel" in low:
        return "cuda flash"
    if "flash_decode_" in low:
        return "cuda decode"
    if "ln_fwd_" in low:
        return "cuda layernorm"
    if "ln_bwd_" in low:
        return "cuda layernorm bwd"
    if "softmax_fwd_" in low:
        return "cuda softmax"
    if "softmax_bwd_" in low:
        return "cuda softmax bwd"
    if any(k in low for k in ("ssd_chunk_kernel", "ssd_pass_kernel",
                              "ssd_output_kernel")):
        return "cuda ssd"
    if "stream_kernel" in low:
        return "cuda streaming"
    if "mm_fused_kernel" in low:
        return "cuda matmul_fused"
    if low == "kernel":
        return "generated"
    # cuBLAS's Hopper GEMMs include "nvjet" kernels (its bfloat16 ones)
    if any(k in low for k in ("gemm", "sm90", "cutlass", "matmul", "xmma",
                              "gemv", "nvjet")):
        return "matmul"
    return "plain ops"


def where_the_time_goes(label: str, fn) -> dict:
    """Device time of one call of ``fn`` by kind of kernel
    (torch.profiler): the CUDA kernels, generated Triton kernels, matrix
    products, and the plain PyTorch ops of packed subgraphs and leftover
    nodes.  Returns {kind: ms} and the profiled wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kinds: dict[str, float] = {}
    rows = []
    for ev in prof.key_averages():
        # device-side kernels only: CPU ops report their kernels' time too
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        name = ev.key
        if dev_us <= 0 or name == "Command Buffer Full":
            continue
        kind = kernel_kind(name)
        kinds[kind] = kinds.get(kind, 0.0) + dev_us / 1e3
        rows.append((dev_us / 1e3, ev.count, name[:60]))
    busy = sum(kinds.values())
    print(f"profile of {label} (wall {wall_ms:.1f} ms under the "
          f"profiler): device busy {busy:.2f} ms "
          f"({100 * busy / wall_ms:.1f}% of wall)")
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:12s} {ms:9.3f} ms  {100 * ms / max(busy, 1e-9):5.1f}%")
    for ms, n, name in sorted(rows, reverse=True)[:12]:
        print(f"    {ms:9.3f} ms  x{n:<5d} {name}")
    return dict(kinds, wall_ms=wall_ms)


def phase_main_path(gen) -> tuple[dict, list]:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    cfg = get_config("llama3.2-3b")
    model = Model(cfg, "xla")
    t0 = time.perf_counter()
    params = model.init(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=gen, device="cuda")
    torch.cuda.synchronize()
    print(f"main path: {cfg.name} layers={cfg.n_layers} d_model="
          f"{cfg.d_model} batch={BATCH} prompt={PROMPT} float32 seed={SEED} "
          f"init_s={time.perf_counter() - t0:.2f} "
          f"allocated_GB={torch.cuda.memory_allocated() / 1e9:.2f}")

    # compile (trace -> plan -> stitch -> emit) both stitched functions
    h0 = params["embed"][tokens]
    positions = torch.arange(PROMPT, device="cuda")
    head_p = {"final_norm": params["final_norm"],
              "lm_head": params["lm_head"]}
    t0 = time.perf_counter()
    block_c = model.block.compiled(params["blocks"][0], h0, positions)
    head_c = model.head.compiled(head_p, h0)
    print(f"compile_s={time.perf_counter() - t0:.3f} "
          "(trace+plan+emit; Triton builds at first launch)")
    describe("block", block_c)
    describe("head", head_c)
    head_softmax = [e for e in head_c.emitted
                    if any(head_c.graph.node(n).prim == "reduce_max"
                           for p in e.parts for n in p)]
    if not head_softmax or head_softmax[0].kind != "streaming":
        fail("the head's softmax group did not take the streaming schedule: "
             f"{head_c.report.schedules}")

    # the counted run of the forward path
    reset_launch_counts()
    t0 = time.perf_counter()
    logits, probs = model.forward(params, tokens)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = launch_counts()
    print(f"launches in one forward: {json.dumps(launches)} "
          f"first_step_s={first_s:.2f} (includes Triton builds)")
    for k in ("onepass", "streaming"):
        if launches[k] <= 0:
            fail(f"the forward path launched no {k} kernel")
    if launches["matmul_fused"] != cfg.n_layers:
        fail(f"B3 launched {launches['matmul_fused']} times in the forward, "
             f"want {cfg.n_layers} (the gate projection of every layer)")

    where_the_time_goes("one forward",
                        lambda: model.forward(params, tokens))

    steps = []
    for _ in range(3):
        t0 = time.perf_counter()
        model.forward(params, tokens)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    print(f"step_ms={statistics.median(steps):.2f} (median of 3, host clock "
          f"around a synchronized forward; all {cfg.n_layers} layers + head)")

    if tuple(logits.shape) != (BATCH, PROMPT, cfg.padded_vocab):
        fail(f"logits shape {tuple(logits.shape)}")
    if not (torch.isfinite(logits).all() and torch.isfinite(probs).all()):
        fail("non-finite logits or probabilities")
    sums = probs.sum(-1)
    if float((sums - 1).abs().max()) > 1e-4:
        fail("probabilities do not sum to one")

    # the same graphs replayed op by op in plain PyTorch on the card
    plain = Model(cfg, "xla", dispatch="interpret")
    ref_logits, ref_probs = plain.forward(params, tokens)
    torch.cuda.synchronize()
    l_err = float((logits - ref_logits).abs().max())
    l_ref = float(ref_logits.abs().max())
    # logits that differ by at most l_err move log p by at most 2 l_err:
    # each probability is held to that, relative, plus the softmax
    # kernel's own rounding (``agreement``)
    p_err, p_worst = agreement([probs], [ref_probs], rtol=2 * l_err + RTOL)
    nxt = logits[:, -1].argmax(-1)
    ref_nxt = ref_logits[:, -1].argmax(-1)
    agree = float((logits.argmax(-1) == ref_logits.argmax(-1)).float().mean())
    # float32, 28 layers, other summation orders in the generated kernels
    l_tol = 1e-4 * max(1.0, l_ref)
    print(f"next tokens: {nxt.tolist()} (plain replay: {ref_nxt.tolist()})")
    print(f"agreement with dispatch='interpret': max|dlogits|={l_err:.3e} "
          f"(tol {l_tol:.1e}, max|logits|={l_ref:.3f}) max|dprobs|="
          f"{p_err:.3e} (worst err/limit {p_worst:.3f}, limit (2 max|dlogits|"
          f" + {RTOL:g})|p| + {FLOOR:g} mean|p|) argmax agreement="
          f"{agree:.4f} (min 0.99)")
    if l_err > l_tol or not p_worst <= 1.0 or agree < 0.99:
        fail("the stitched forward disagrees with the plain replay")
    del plain, ref_logits, ref_probs, logits, probs

    # every generated kernel instance of the main path, at its shapes
    checks: dict[str, list] = {}
    check_generated({"block": block_c, "head": head_c}, gen, checks)
    return launches, checks


def check_generated(compiled: dict, gen, checks: dict) -> None:
    """Hold every generated kernel instance of the ``{label: compiled}``
    functions against its plain version at the shapes it was compiled for
    (``check_kernel``), each instance once; append each result to
    ``checks[kind]``."""
    import torch

    seen = {id(r["_fn"]) for rs in checks.values() for r in rs if "_fn" in r}
    for name, comp in compiled.items():
        for em in comp.emitted:
            if em.kind == "anchored" and id(em.fn) not in seen:
                seen.add(id(em.fn))
                kind = ("flash_score_mod" if getattr(
                    em.fn, "score_mod", None) is not None else "matmul_fused")
                prims = sorted({comp.graph.node(n).prim
                                for p in em.parts for n in p})
                lib = None
                if kind == "matmul_fused":  # the product alone
                    ch = em.fn.chain
                    lib = product_call(ch["M"], ch["K"], ch["N"], gen)
                res = check_anchored(em, comp.graph, gen, reps=10,
                                     label=f"{name} anchored "
                                           f"{'+'.join(prims)}",
                                     library=lib)
                checks.setdefault(kind, []).append(dict(res, _fn=em.fn))
                continue
            if not em.generated or id(em.fn) in seen:
                continue
            seen.add(id(em.fn))
            is_softmax = any(comp.graph.node(n).prim == "reduce_max"
                             for p in em.parts for n in p)
            lib = ((lambda v: torch.softmax(v, -1))
                   if name == "head" and is_softmax else None)
            prims = sorted({comp.graph.node(n).prim
                            for p in em.parts for n in p})
            res = check_kernel(em, comp.graph, gen,
                               label=f"{name} {'+'.join(prims)}",
                               reps=10 if em.fn.R * em.fn.C > 1e8 else 50,
                               library=lib)
            checks.setdefault(em.kind, []).append(dict(res, _fn=em.fn))


def summarize(results: list) -> dict:
    """One kernel's entry of the summary line from its checked instances:
    the times of its main-path instance (``_main``) where it has one, else
    of the instance that moves the most bytes; the largest error of any
    instance."""
    top = max(results, key=lambda r: (r.get("_main", False),
                                      r.get("_bytes", 0)))
    return dict(top, max_abs_err=max(r["max_abs_err"] for r in results),
                instances_checked=len(results))


def bound_ms(nbytes: float, ops: float,
             mma_ops: float = 0) -> tuple[float, str]:
    """(bound ms, "bytes"|"operations"): the larger of the bytes over the
    HBM rate and the operations -- element-wise ``ops`` at float32's rate,
    the products' ``mma_ops`` at the split's -- over their peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / FP32_OPS_PER_S + mma_ops / SPLIT_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def agreement_max(got, want, rtol: float) -> tuple[float, float]:
    """(max |got - want|, the largest ratio of it to rtol max(1,
    max|want|)) over matching output tensors, each held to its own
    limit."""
    err = worst = 0.0
    for g, w in zip(got, want):
        e = float((g.float() - w.float()).abs().max())
        err = max(err, e)
        worst = max(worst, e / (rtol * max(1.0, float(w.abs().max()))))
    return err, worst


def check_cuda_kernel(label: str, launch, plain, inputs, *, nbytes: float,
                      ops: float, reps: int, library=None,
                      max_rtol: float | None = None,
                      rtol: float = RTOL, mma_ops: float = 0,
                      reference=None) -> dict:
    """Hold one hand-written CUDA kernel against its plain version on the
    card, on the same inputs, with ``agreement``'s per-element limit (at
    ``rtol`` |plain| + ``rtol`` mean|plain|), or with ``max_rtol`` max(1,
    max|plain|) for each output where it is given; against
    ``reference(*inputs)`` instead of the plain version where it is given
    (a float64 evaluation of the same function).  ``ops`` are element-wise
    operations, ``mma_ops`` those of products (``bound_ms``).  Launches
    made here are reset before the main paths."""
    import torch

    def outs(r):
        return list(r) if isinstance(r, (tuple, list)) else [r]

    got = outs(launch(*inputs))
    want = outs((plain if reference is None else reference)(*inputs))
    torch.cuda.synchronize()
    err, worst = (agreement(got, want, rtol, rtol) if max_rtol is None
                  else agreement_max(got, want, max_rtol))
    vs_plain = ""
    if reference is not None:  # the float32 plain version, for the record
        del want
        _, w32 = agreement(got, outs(plain(*inputs)), rtol, rtol)
        vs_plain = f"; against the float32 plain version {w32:.3f}"
    ms = time_ms(lambda: launch(*inputs), reps)
    call_ms = time_ms(lambda: launch(*inputs), reps, queued=False)
    plain_ms = time_ms(lambda: plain(*inputs), max(3, reps // 4))
    lib_ms = time_ms(lambda: library(*inputs), reps) if library else None
    bound, bound_by = bound_ms(nbytes, ops, mma_ops)
    print(f"cuda kernel {label}: max_abs_err={err:.3e} (worst err/limit "
          f"{worst:.3f}{'' if reference is None else ' against float64'}"
          f"{vs_plain}) "
          f"ms={ms:.4f} (call with the host's cost: "
          f"{call_ms:.4f}) plain_ms={plain_ms:.4f} library_ms="
          f"{'n/a' if lib_ms is None else f'{lib_ms:.4f}'} "
          f"bound_ms={bound:.4f} ({bound_by}: {nbytes:.0f} B, {ops:.0f} "
          f"element-wise ops, {mma_ops:.0f} product ops)")
    if not all(torch.isfinite(g).all() for g in got):
        fail(f"{label}: kernel output not finite")
    if not worst <= 1.0:
        fail(f"{label}: kernel disagrees with its plain version "
             f"(worst err/limit {worst:.3f})")
    return {"max_abs_err": err, "worst": worst, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib_ms}


def same_bytes_op(label: str, fn, *inputs) -> None:
    """Print the device time of one PyTorch element-wise op that moves the
    same bytes as the kernel just checked (its inputs read once, one
    output written): a yardstick of what the card's memory delivers to
    such traffic, beside the bound's 3.35 TB/s."""
    print(f"  same bytes through {label}: "
          f"{time_ms(lambda: fn(*inputs), 50):.4f} ms")


def launched(name: str, before: dict) -> None:
    """Print the launches a check made, by kernel, and fail unless
    ``name``'s counter moved: the shape ran through that kernel."""
    after = launch_counts()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    print(f"  launches of that check: {json.dumps(moved)}")
    if not moved.get(name):
        fail(f"the check meant for {name} launched it no time: {moved}")


#: B3's limit against its plain version, set before its first full-width
#: run: each output within 1e-5 max(1, max|plain|) -- plus, where the
#: float32 sum over K argues for more, three times the plain version's
#: own distance from the same function in float64 (a chain fed by an
#: unscaled product, as bench_anchor_fusion's MLP block is, carries the
#: sum's rounding into values near zero).  B4, with and without
#: score_mod, keeps its own limit (``agreement`` at RTOL), held against
#: its function evaluated in float64: its split products sum more
#: exactly than the float32 plain version, which itself sits at 0.4-1.3
#: of that limit from float64 (``kernels/split_float.py``, on the card),
#: so the float32 plain version is printed beside it, not held to.
B3_RTOL, B3_SUM_FACTOR = 1e-5, 3.0


def anchored_work(em, graph) -> tuple[int, int, int]:
    """(bytes, element-wise operations, product operations) of one
    anchored kernel: its inputs read once and outputs written once; the
    chains' element operations; 2 operations a multiply-add of each
    product over its contracted extent."""
    members = frozenset(n for p in em.parts for n in p)
    nbytes = (sum(graph.node(i).nbytes for i in em.ext_ids)
              + sum(graph.node(o).nbytes for o in em.out_ids))
    ops = graph.subgraph_flops(members)
    mma = 0
    for a in members:
        node = graph.node(a)
        if node.prim == "dot_general":
            (lc, _), _ = node.params["dimension_numbers"]
            lhs = graph.node(node.inputs[0]).spec.shape
            mma += 2 * node.spec.size * math.prod(lhs[d] for d in lc)
    return nbytes, ops, mma


def float64_outputs(em, graph, vals) -> list:
    """The anchored group's function evaluated op by op in float64 on the
    card: B3's yardstick for the float32 sum's own rounding, B4's
    reference."""
    from repro_torch.core.tracer import run_subgraph

    env = {i: v.double() if v.is_floating_point() else v
           for i, v in zip(em.ext_ids, vals)}
    members = sorted(n for p in em.parts for n in p)
    run_subgraph(graph, members, env, vals[0].device)
    return [env[o] for o in em.out_ids]


def check_anchored(em, graph, gen, *, label: str, reps: int,
                   library=None, inputs=None) -> dict:
    """Hold one anchored kernel (``em.fn.launch``) against its plain
    version (``em.fn.plain``) on the card, on the same inputs: B3 with
    ``B3_RTOL`` (and the float32 sum's term), the score_mod instance with
    ``agreement``."""
    import torch

    vals = random_inputs(em, graph, gen) if inputs is None else inputs
    nbytes, ops, mma = anchored_work(em, graph)
    scored = getattr(em.fn, "score_mod", None) is not None
    max_rtol = None
    if not scored:
        want = em.fn.plain(*vals)
        ref = float64_outputs(em, graph, vals)
        sum_err = max(float((w.double() - r).abs().max())
                      for w, r in zip(want, ref))
        scale = max(max(1.0, float(w.abs().max())) for w in want)
        max_rtol = B3_RTOL + B3_SUM_FACTOR * sum_err / scale
        print(f"  {label}: the plain version's float32 distance from "
              f"float64 {sum_err:.3e} (max|plain| {scale:.3f}): limit "
              f"{max_rtol:.3e} max(1, max|plain|)")
        del want, ref
    res = check_cuda_kernel(
        label, em.fn.launch, em.fn.plain, vals, nbytes=nbytes, ops=ops,
        mma_ops=mma, reps=reps, library=library, max_rtol=max_rtol,
        reference=(lambda *v: float64_outputs(em, graph, list(v)))
        if scored else None)
    return dict(res, _bytes=nbytes)


def ext_values(comp, em, args, gen) -> list:
    """The anchored group's inputs: the call's own arguments where the
    group reads a graph input, standard normal values of the right shape
    and type where it reads a value computed outside it."""
    import torch
    from repro_torch.core.tracer import TORCH_DTYPES

    given = dict(zip(comp.graph.inputs, args))
    return [given[i] if i in given else torch.randn(
        comp.graph.node(i).spec.shape, generator=gen, device="cuda").to(
        TORCH_DTYPES[comp.graph.node(i).spec.dtype]) for i in em.ext_ids]


def anchored_of(fn, args) -> tuple:
    """(compiled, anchored Emitted list) of ``stitched_jit(fn)`` at
    ``args``, or a failure if nothing anchored."""
    from repro_torch.core import stitched_jit

    comp = stitched_jit(fn).compiled(*args)
    ems = [e for e in comp.emitted if e.kind == "anchored"]
    if not ems:
        fail(f"{getattr(fn, '__name__', fn)}: no anchored group "
             f"({comp.report.schedules})")
    return comp, ems


def product_call(M: int, K: int, N: int, gen):
    """B3's library call: ``torch.matmul`` of an (M, K) by (K, N) float32
    product alone (TF32 off), which computes less than B3."""
    import torch

    a = torch.randn(M, K, generator=gen, device="cuda")
    b = torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5
    return lambda *v: torch.matmul(a, b)


def t_gate(x, wg, wu):
    """The Llama MLP's gate projection with its SiLU x up epilogue."""
    import torch.nn.functional as F

    return F.silu(x @ wg) * (x @ wu)


def bench_mlp(x, w1, w2, r, g):
    """``benchmarks/bench_anchor_fusion.py``'s MLP block (its tanh GELU
    written out op for op)."""
    import torch

    h = (x * g + 1.0) @ w1
    h = h * (0.5 * (1.0 + torch.tanh(
        0.7978845608028654 * (h + 0.044715 * h ** 3))))
    return torch.tanh(h @ w2) + r


def bench_attn(q, k, v, bias):
    """``bench_anchor_fusion.py``'s attention block: the scale and the
    bias fold into the flash kernel's score functor."""
    import torch

    s = q @ k.transpose(-1, -2) * 0.125 + bias
    return torch.softmax(s, -1) @ v


def reducing_epilogues(x, w, g):
    """The row reductions an H100 epilogue admits (N <= 256): an RMSNorm
    (a sum), a softmax (a max and a sum), a row minimum."""
    import torch

    h = x @ w
    return (h * torch.rsqrt((h ** 2).mean(-1, keepdim=True) + 1e-6) * g,
            torch.softmax(h, -1), h.amin(-1, keepdim=True))


def phase_anchored_kernels(gen) -> tuple[dict, dict]:
    """Compute-anchored stitching's kernels through ``stitched_jit``: B3
    (``kernels/matmul.py`` + ``csrc/matmul_fused.cuh``, one generated
    instance a chain) and flash attention with a score chain (B4's
    ``score_mod``), each against its plain version with kernel, plain
    and library times and its bound; then the counted run of
    bench_anchor_fusion's two blocks.  Returns (checks, launches)."""
    import torch
    import torch.nn.functional as F

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    checks: dict[str, list] = {}
    Mp, K, N = BATCH * PROMPT, ANCHOR_K, ANCHOR_N

    def product_only(M, Kx, Nx):
        return product_call(M, Kx, Nx, gen)

    # the Llama MLP's gate projection (weights at the model's init scale)
    for label, M, main in (("prefill", Mp, True), ("decode", BATCH, False),
                           ("ragged", 2000, False)):
        args = (randn(M, K), randn(K, N, scale=K ** -0.5),
                randn(K, N, scale=K ** -0.5))
        comp, ems = anchored_of(t_gate, args)
        em = ems[0]
        res = check_anchored(
            em, comp.graph, gen, inputs=ext_values(comp, em, args, gen),
            reps=10 if M > 64 else 50,
            label=f"matmul_fused llama gate+SiLU x up {label} M{M} K{K} N{N} "
                  f"(tile {em.fn.tile})",
            library=product_only(M, K, N))
        checks.setdefault("matmul_fused", []).append(dict(res, _main=main))
        del comp, ems, em, args

    # bench_anchor_fusion's MLP block at its own shapes (unscaled, as
    # there) and at Llama's prefill width
    for M, Kx, Nx in ((128, 256, 256), (Mp, K, N)):
        args = (randn(M, Kx), randn(Kx, Nx), randn(Nx, Kx), randn(M, Kx),
                randn(Kx))
        comp, ems = anchored_of(bench_mlp, args)
        if len(ems) != 2:
            fail(f"bench MLP block: {len(ems)} anchored groups, want 2")
        for i, em in enumerate(ems):
            k_i, n_i = (Kx, Nx) if i == 0 else (Nx, Kx)
            res = check_anchored(
                em, comp.graph, gen, inputs=ext_values(comp, em, args, gen),
                reps=10,
                label=f"matmul_fused bench MLP group {i} M{M} K{k_i} N{n_i}",
                library=product_only(M, k_i, n_i))
            checks["matmul_fused"].append(res)
        del comp, ems, args

    # every row-reducing epilogue form the gate admits, at N 256
    args = (randn(Mp, K), randn(K, 256, scale=K ** -0.5), randn(256))
    comp, ems = anchored_of(reducing_epilogues, args)
    res = check_anchored(
        ems[0], comp.graph, gen, inputs=list(args), reps=20,
        label=f"matmul_fused RMSNorm+softmax+rowmin epilogue M{Mp} K{K} N256 "
              f"(tile {ems[0].fn.tile})", library=product_only(Mp, K, 256))
    checks["matmul_fused"].append(res)

    # B4 with score_mod: the bench block, and at Llama's heads and prompt
    for B, H, S, D in ((2, 4, 128, 64), (BATCH, 24, PROMPT, 128)):
        args = (randn(B, H, S, D), randn(B, H, S, D), randn(B, H, S, D),
                randn(1, 1, S, S))
        comp, ems = anchored_of(bench_attn, args)
        em = ems[0]
        if em.fn.score_mod is None:
            fail("bench attention block: no score chain folded")
        bias_i = em.ext_ids.index(comp.graph.inputs[3])
        qi = [em.ext_ids.index(comp.graph.inputs[j]) for j in range(3)]
        res = check_anchored(
            em, comp.graph, gen, inputs=ext_values(comp, em, args, gen),
            reps=20,
            label=f"flash_attention score_mod (scale 0.125 + bias [1, 1, {S}, "
                  f"{S}]) B{B} H{H} S{S} D{D}",
            library=lambda *v, _b=bias_i, _q=qi:
            F.scaled_dot_product_attention(
                v[_q[0]], v[_q[1]], v[_q[2]], attn_mask=v[_b], scale=0.125))
        checks.setdefault("flash_score_mod", []).append(
            dict(res, _main=S == 128))
        del comp, ems, em, args

    # the counted run: bench_anchor_fusion's two blocks through stitched_jit
    from repro_torch.core import stitched_jit

    mlp_args = (randn(128, 256), randn(256, 256), randn(256, 256),
                randn(128, 256), randn(256))
    attn_args = (randn(2, 4, 128, 64), randn(2, 4, 128, 64),
                 randn(2, 4, 128, 64), randn(1, 1, 128, 128))
    mlp_f, attn_f = stitched_jit(bench_mlp), stitched_jit(bench_attn)
    mlp_f(*mlp_args), attn_f(*attn_args)  # warm: builds and Triton
    reset_launch_counts()
    y_mlp, y_attn = mlp_f(*mlp_args), attn_f(*attn_args)
    torch.cuda.synchronize()
    launches = launch_counts()
    for name, f, a in (("mlp", mlp_f, mlp_args), ("attn", attn_f,
                                                  attn_args)):
        describe(f"bench {name} block", f.compiled(*a))
    print(f"launches in one call of each bench block: {json.dumps(launches)}")
    if launches["matmul_fused"] != 2 or launches["flash_score_mod"] != 1:
        fail("the bench blocks did not run as 2 B3 launches and 1 flash "
             "score_mod launch")
    ref_mlp = stitched_jit(bench_mlp, dispatch="interpret")(*mlp_args)
    ref_attn = stitched_jit(bench_attn, dispatch="interpret")(*attn_args)
    for name, y, r in (("mlp", y_mlp, ref_mlp), ("attn", y_attn, ref_attn)):
        if y.shape != r.shape or not torch.isfinite(y).all():
            fail(f"bench {name} block: shape {tuple(y.shape)} or non-finite")
        err = float((y - r).abs().max())
        print(f"bench {name} block vs the op-by-op replay: max|d|={err:.3e} "
              f"(max|y| {float(r.abs().max()):.3f})")
    return checks, launches


def rms_proj(x, g, w):
    """An RMSNorm feeding a projection (Llama's layer halves: the norm
    before the gate projection): B3's prologue reduces over K."""
    import torch

    return (x * torch.rsqrt((x ** 2).mean(-1, keepdim=True) + 1e-6) * g) @ w


def softmax_proj(x, w):
    """A softmax over N after the product: B3's epilogue reduces across
    the N tiles of a thread-block cluster."""
    import torch

    return torch.softmax(x @ w, -1)


def wide_attn(q, k, v, bias):
    """Attention above head dim 256 whose scale and bias fold into the
    wide kernel's score functor."""
    import torch

    s = q @ k.transpose(-1, -2) * (q.shape[-1] ** -0.5) + bias
    return torch.softmax(s, -1) @ v


def wide_causal_row(gen, D: int = 320) -> dict:
    """The wide kernel with a generated score functor at B4 H16 S512 D
    causal with a [1, 1, S, S] bias: the functor of ``wide_attn``'s
    anchored group called causal (the score chain first, then the causal
    mask, as the reference's ``_attn_kernel``), against the same function
    in float64, with SDPA as its library call (the bias and the causal
    mask as its float mask)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.tracer import const_tensor
    from repro_torch.kernels import flash_attention as FA

    B, H, S = BATCH, 16, PROMPT
    args = tuple(torch.randn(*sh, generator=gen, device="cuda")
                 for sh in ((B, H, S, D),) * 3 + ((1, 1, S, S),))
    comp, ems = anchored_of(wide_attn, args)
    em = ems[0]
    mod = em.fn.score_mod
    if mod is None or not mod.wide:
        fail(f"wide attention D {D}: no wide score functor folded")
    given = dict(zip(comp.graph.inputs, args))
    sargs = [(given[i] if i in given else const_tensor(
        comp.graph.node(i), "cuda")).reshape(sh)
        for i, sh in em.fn.score_operands]
    q, k, v = args[:3]
    causal = torch.ones(S, S, dtype=torch.bool, device="cuda").triu(1)

    def launch(*_):
        return FA.flash_attention_cuda(q, k, v, True, 1.0, score_mod=mod,
                                       score_args=sargs)

    def plain(*_):
        return FA.flash_attention_plain(q, k, v, True, 1.0, score_mod=mod,
                                        score_args=sargs)

    def reference(*_):
        s = mod.plain(q.double() @ k.double().transpose(-1, -2),
                      *[a.double() if a.is_floating_point() else a
                        for a in sargs])
        s = s.masked_fill(causal, -1e30)
        return torch.softmax(s, -1) @ v.double()

    mask = args[3].masked_fill(causal, float("-inf"))
    pairs = B * H * S * (S + 1) // 2
    members = frozenset(n for p in em.parts for n in p)
    per_pair = comp.graph.subgraph_flops(members) / (B * H * S * S)
    before = launch_counts()
    res = check_cuda_kernel(
        f"flash_wide_score_mod (scale D^-0.5 + bias [1, 1, {S}, {S}], "
        f"causal) B{B} H{H} S{S} D{D}", launch, plain, [],
        nbytes=4 * (4 * B * H * S * D + S * S), ops=per_pair * pairs,
        mma_ops=4 * D * pairs, reps=20, reference=reference,
        library=lambda *_: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=D ** -0.5))
    launched("flash_wide_score_mod", before)
    return res


def forced_b3(fn, args):
    """(compiled, B3 group) of ``fn``'s one product with its whole
    prologue and epilogue chains, emitted for the card whatever the cost
    model picks: the H100 preset folds a reducing prologue only where B3's
    statistics pass reads no more than the fold saves (a narrow
    projection), so the kernel row at Llama's width is built here."""
    from repro_torch.core import H100, OpKind, stitched_jit
    from repro_torch.core.codegen import emit_group

    comp = stitched_jit(fn, dispatch="interpret").compiled(*args)
    g = comp.graph
    a = next(n for n in g.nodes if g.node(n).prim == "dot_general")
    _, anc = g.reachability()
    body = [n for n in g.nodes if n != a and g.node(n).kind
            not in (OpKind.INPUT, OpKind.CONST)]
    pro = frozenset(n for n in body if (anc[a] >> n) & 1)
    parts = [p for p in (pro, frozenset({a}), frozenset(body) - pro) if p]
    return comp, emit_group(g, parts, hw=H100, anchors=(a,))


def phase_anchor_forms(gen) -> tuple[dict, dict]:
    """The forms of the anchored kernels that the reference's kernels take
    and the H100 gate once refused: B3 with a prologue that reduces over K
    (an RMSNorm feeding Llama's gate projection, M 2048, K 3072, N 8192,
    built by ``forced_b3``: the plan leaves it memory-only; and feeding
    Granite's router, M 2048, K 1024, N 32, which the plan folds), B3 with
    an epilogue that reduces across the N tiles of a cluster (a softmax at
    M 2048, K 3072, N 512 and 2048), and the wide flash kernel with a
    generated score functor (``wide_causal_row``), each against its plain
    version with kernel, plain and library times and its bound; then the
    counted run of the router-width RMSNorm, the N 2048 softmax and a wide
    attention through ``stitched_jit`` (one launch of each form).
    Returns (checks, launches)."""
    import torch
    from repro_torch.kernels import matmul as MM

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    checks: dict[str, list] = {}
    Mp, K, N = BATCH * PROMPT, ANCHOR_K, ANCHOR_N
    from repro_torch.core import stitched_jit

    KR, NR = 1024, 32  # Granite-3.0-1B-A400M's d_model and experts
    router_args = (randn(Mp, KR), randn(KR), randn(KR, NR, scale=KR ** -0.5))
    for (Mx, Kx, Nx), args, main in (
            ((Mp, K, N), (randn(Mp, K), randn(K),
                          randn(K, N, scale=K ** -0.5)), True),
            ((Mp, KR, NR), router_args, False)):
        planned = stitched_jit(rms_proj).report(*args).n_anchored
        comp, em = forced_b3(rms_proj, args)
        if em.fn.entry.pro_slots != 1:
            fail(f"RMSNorm prologue: {em.fn.entry.pro_slots} prologue slots")
        tile = MM.TILES[em.fn.tile]
        extra = Mx * Kx * 4 * -(-Nx // tile.bn)
        print(f"  RMSNorm prologue M{Mx} K{Kx} N{Nx}: the plan folds it: "
              f"{bool(planned)}; the statistics pass reads the lhs rows "
              f"once more a level for each N tile: {extra / 1e9:.4f} GB (M "
              f"K (N / {tile.bn}) floats, one level; the lhs itself "
              f"{Mx * Kx * 4 / 1e6:.1f} MB)")
        if planned != (not main):
            fail(f"RMSNorm prologue M{Mx} K{Kx} N{Nx}: the plan folds it: "
                 f"{bool(planned)}")
        before = launch_counts()
        res = check_anchored(
            em, comp.graph, gen, inputs=ext_values(comp, em, args, gen),
            reps=10, label=f"matmul_fused RMSNorm prologue (reduces over K) "
                           f"M{Mx} K{Kx} N{Nx} (tile {em.fn.tile})",
            library=product_call(Mx, Kx, Nx, gen))
        launched("matmul_fused_prologue_reduce", before)
        checks.setdefault("matmul_fused_prologue_reduce", []).append(
            dict(res, _main=main))
        del comp, em

    epi_args = {}
    for n in (512, 2048):
        args = (randn(Mp, K), randn(K, n, scale=K ** -0.5))
        epi_args[n] = args
        comp, ems = anchored_of(softmax_proj, args)
        em = ems[0]
        blocks = -(-n // MM.TILE_ROW.bn)
        before = launch_counts()
        res = check_anchored(
            em, comp.graph, gen, inputs=list(args), reps=10,
            label=f"matmul_fused softmax epilogue across a cluster of "
                  f"{blocks} M{Mp} K{K} N{n} (tile {em.fn.tile})",
            library=product_call(Mp, K, n, gen))
        launched("matmul_fused_cluster_epilogue", before)
        checks.setdefault("matmul_fused_cluster_epilogue", []).append(
            dict(res, _main=n == MM.ROW_MAX_N))
        del comp, ems, em

    checks["flash_wide_score_mod"] = [dict(wide_causal_row(gen),
                                           _main=True)]

    # the counted run: each function once through stitched_jit
    attn_args = tuple(randn(*sh) for sh in ((2, 16, 256, 320),) * 3
                      + ((1, 1, 256, 256),))
    runs = [(rms_proj, router_args), (softmax_proj, epi_args[2048]),
            (wide_attn, attn_args)]
    fns = [stitched_jit(f) for f, _ in runs]
    for f, (_, a) in zip(fns, runs):
        f(*a)  # warm
    reset_launch_counts()
    ys = [f(*a) for f, (_, a) in zip(fns, runs)]
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"launches in one call of each form: {json.dumps(launches)}")
    if (launches["matmul_fused_prologue_reduce"] != 1
            or launches["matmul_fused_cluster_epilogue"] != 1
            or launches["flash_wide_score_mod"] != 1
            or launches["matmul_fused"] != 2):
        fail("the three functions did not run as one launch of each form")
    for (f, a), y in zip(runs, ys):
        r = stitched_jit(f, dispatch="interpret")(*a)
        if y.shape != r.shape or not torch.isfinite(y).all():
            fail(f"{f.__name__}: shape {tuple(y.shape)} or non-finite")
        print(f"{f.__name__} vs the op-by-op replay: max|d|="
              f"{float((y - r).abs().max()):.3e} (max|y| "
              f"{float(r.abs().max()):.3f})")
    return checks, launches


def layer_norm_fig1(x, gamma, beta):
    """The paper's Fig. 1 LayerNorm (``examples/quickstart.py``)."""
    import torch

    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-6) * gamma + beta


def llama_mlp_input(x, g, w_gate, w_up):
    """Llama-3.2-3B's MLP input chain: the RMSNorm, then SiLU(h w_gate) x
    (h w_up)."""
    import torch
    import torch.nn.functional as F

    h = x * torch.rsqrt((x ** 2).mean(-1, keepdim=True) + 1e-6) * g
    return F.silu(h @ w_gate) * (h @ w_up)


#: A differentiable path's gradients against plain autograd on the card:
#: max |dg| <= GRAD_RTOL max(1, max|g|), each tensor.
GRAD_RTOL = 1e-4


def differentiable_path(label: str, fn, args, library=None) -> dict:
    """``stitched_jit(fn, differentiable=True)`` forward and backward on
    the card (loss sum(y ** 2)): the launches of one counted step, each
    gradient against plain autograd of ``fn`` (eager PyTorch ops, TF32
    off), forward and backward device times against eager autograd (and
    ``library``'s autograd where given), and the backward's kernels and
    HBM bytes stitched against unfused."""
    import torch
    from repro_torch.core import stitched_jit

    ins = [a.detach().requires_grad_() for a in args]
    wrapped = stitched_jit(fn, differentiable=True)

    def step(f):
        y = f(*ins)
        return torch.autograd.grad((y ** 2).sum(), ins)

    t0 = time.perf_counter()
    step(wrapped)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    reset_launch_counts()
    got = step(wrapped)
    torch.cuda.synchronize()
    launches = launch_counts()
    want = step(fn)
    worst = 0.0
    errs = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail(f"{label}: gradient {i} of shape {tuple(a.shape)} or "
                 "non-finite")
        e = float((a - b).abs().max())
        lim = GRAD_RTOL * max(1.0, float(b.abs().max()))
        errs.append(e)
        worst = max(worst, e / lim)
    fwd_rep = wrapped.report(*ins)
    bwd_rep = wrapped.backward_reports()[0]

    def times(f):
        y = f(*ins)
        loss = (y ** 2).sum()
        fwd = time_ms(lambda: f(*ins), 10)
        bwd = time_ms(lambda: torch.autograd.grad(loss, ins,
                                                  retain_graph=True), 10)
        return fwd, bwd

    t_st, t_eager = times(wrapped), times(fn)
    t_lib = times(library) if library is not None else None
    st = bwd_rep.stats
    print(f"differentiable {label}: compile_s={compile_s:.2f} launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}; "
          f"gradients max|dg|={['%.3e' % e for e in errs]} (worst err/limit "
          f"{worst:.3f}, limit {GRAD_RTOL:g} max(1, max|g|)); forward "
          f"{t_st[0]:.4f} ms / backward {t_st[1]:.4f} ms (eager autograd "
          f"{t_eager[0]:.4f} / {t_eager[1]:.4f}"
          + (f"; library {t_lib[0]:.4f} / {t_lib[1]:.4f}" if t_lib else "")
          + f"); graphs captured / replays: forward "
          f"{fwd_rep.graph_captures} / {fwd_rep.graph_replays}, backward "
          f"{bwd_rep.graph_captures} / {bwd_rep.graph_replays}"
          + f"; forward schedules {fwd_rep.schedules}; backward "
          f"schedules {bwd_rep.schedules}, kernels {st.n_kernels_stitched} "
          f"stitched / {st.n_kernels_unfused} unfused, HBM "
          f"{st.hbm_bytes_stitched / 1e6:.1f} / "
          f"{st.hbm_bytes_unfused / 1e6:.1f} MB")
    if not worst <= 1.0:
        fail(f"{label}: the stitched gradients disagree with autograd")
    if not launches["onepass"] + launches["streaming"] \
            + launches["matmul_fused"]:
        fail(f"{label}: no generated or B3 kernel launched")
    DIFF_RESULTS[label] = {
        "grad_worst": worst, "forward_ms": t_st[0], "backward_ms": t_st[1],
        "eager_forward_ms": t_eager[0], "eager_backward_ms": t_eager[1],
        "library_ms": t_lib, "launches": launches,
        "backward_kernels": [st.n_kernels_stitched, st.n_kernels_unfused],
        "backward_hbm_bytes": [st.hbm_bytes_stitched, st.hbm_bytes_unfused]}
    return launches


#: phase_differentiable's numbers, by path
DIFF_RESULTS: dict = {}


def phase_differentiable(gen) -> dict:
    """``stitched_jit(differentiable=True)`` on the card: the Fig. 1
    LayerNorm at the quickstart's [8192, 3072] (against ``F.layer_norm``'s
    autograd too) and Llama-3.2-3B's MLP input chain (M 2048 = batch 4 x
    512, K 3072, N 8192, weights at the model's init scale), forward and
    backward (``differentiable_path``).  Returns the launches of both
    counted steps."""
    import torch
    import torch.nn.functional as F

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    R, C = 8192, 3072
    ln = differentiable_path(
        f"Fig. 1 LayerNorm [{R}, {C}]", layer_norm_fig1,
        (randn(R, C), randn(C), randn(C)),
        library=lambda x, g, b: F.layer_norm(x, (C,), g, b, eps=1e-6))
    M, K, N = BATCH * PROMPT, ANCHOR_K, ANCHOR_N
    mlp = differentiable_path(
        f"Llama MLP input chain M{M} K{K} N{N}", llama_mlp_input,
        (randn(M, K), 1.0 + 0.1 * randn(K), randn(K, N, scale=K ** -0.5),
         randn(K, N, scale=K ** -0.5)))
    return {k: ln[k] + mlp[k] for k in ln}


#: Host-clock walls of a call: calls timed, each waited for.
WALL_CALLS = 30


def wall_ms(fn, n: int = WALL_CALLS) -> float:
    """Median host-clock ms of ``fn()``, the card synchronized before and
    after each call: what a caller waits for one call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def leaves(tree) -> list:
    from torch.utils import _pytree as pytree

    return pytree.tree_leaves(tree)


def dispatch_row(label: str, fn, args: tuple, vary: int, gen, checks: dict,
                 *, rtol: float, library=None) -> dict:
    """One stitched call on the card, eager schedule against one replayed
    graph (``dispatch="single"``): the first call (eager), the second
    (the capture and its replay), three more that leave ``exec_count`` where the
    capture left it, the output against ``dispatch="interpret"`` (within
    ``rtol`` max(1, max|y|)) and against the eager schedule (same
    kernels: 1e-5 max(1, max|y|)), walls (host clock, each call waited
    for) and device times (CUDA events, queued) of both and of
    ``library``, the replay's kernels against the eager schedule's
    (``replay_vs_eager``), and an earlier output kept while ``args[vary]``
    changes in place (a second graph of the same addresses).  Every
    generated and anchored instance is held against its plain version
    (``check_generated``)."""
    import torch
    from repro_torch.core import stitched_jit

    f = stitched_jit(fn)
    c = f.compiled(*args)
    flat = leaves(args)  # the schedule's inputs
    describe(f"dispatch {label}", c)
    check_generated({f"dispatch {label}": c}, gen, checks)
    want = leaves(stitched_jit(fn, dispatch="interpret")(*args))
    rep = c.report
    firsts = []
    for _ in range(2):  # eager, then the capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = leaves(f(*args))
        torch.cuda.synchronize()
        firsts.append(time.perf_counter() - t0)
        del got
    first_s, capture_s = firsts
    n = c.exec_count
    for _ in range(3):
        f(*args)
    if (n != 2 or c.exec_count != n or rep.graph_captures != 1
            or rep.graph_replays != 4 or rep.graph_eager_runs != 1):
        fail(f"dispatch {label}: exec_count {n} -> {c.exec_count}, "
             f"{rep.graph_eager_runs} eager runs, {rep.graph_captures} "
             f"captures, {rep.graph_replays} replays after five calls")
    got, eager = leaves(f(*args)), leaves(c.run_schedule(*flat))
    _, worst_i = agreement_max(got, want, rtol)
    _, worst_e = agreement_max(got, eager, 1e-5)
    if not all(bool(torch.isfinite(g).all()) for g in got) or not (
            worst_i <= 1.0 and worst_e <= 1.0):
        fail(f"dispatch {label}: the replay disagrees (err/limit "
             f"{worst_i:.3f} against interpret, {worst_e:.3f} against the "
             "eager schedule)")
    del got, eager, want

    def replay():
        f(*args)

    def eager_run():
        c.run_schedule(*flat)

    walls = {"replay": wall_ms(replay), "eager": wall_ms(eager_run)}
    devs = {"replay": time_ms(replay, 20), "eager": time_ms(eager_run, 20)}
    if library is not None:
        walls["library"] = wall_ms(lambda: library(*args))
        devs["library"] = time_ms(lambda: library(*args), 20)
    prof = replay_vs_eager(f"dispatch {label}", replay, eager_run,
                           c.graphs[-1].kernels, rep.graph_replays,
                           walls["replay"], walls["eager"])

    # an earlier output kept: the same addresses, new values in place
    y1 = leaves(f(*args))
    kept = [t.clone() for t in y1]
    saved = args[vary].clone()
    args[vary].copy_(torch.randn(args[vary].shape, generator=gen,
                                 device="cuda"))
    y2 = leaves(f(*args))
    _, worst2 = agreement_max(y2, leaves(c.run_schedule(*flat)), 1e-5)
    if not all(torch.equal(a, b) for a, b in zip(y1, kept)):
        fail(f"dispatch {label}: a replay overwrote an earlier output")
    if worst2 > 1.0 or all(torch.equal(a, b) for a, b in zip(y1, y2)):
        fail(f"dispatch {label}: the second graph's output is wrong")
    args[vary].copy_(saved)
    captures = rep.graph_captures
    del y1, y2, kept, saved
    out = {"first_call_s": first_s, "capture_call_s": capture_s,
           "exec_count": c.exec_count, "eager_runs": rep.graph_eager_runs,
           "captures": captures, "replays": rep.graph_replays,
           "pool_bytes": rep.graph_pool_bytes,
           "copy_bytes_per_call": 0,
           "wall_ms": walls, "device_ms": devs,
           "busy_ms": {"replay": prof["busy_captured_ms"],
                       "eager": prof["busy_eager_ms"]},
           "launches": prof["launches"],
           "worst_vs_interpret": worst_i, "worst_vs_eager": worst_e}
    print(f"dispatch {label}: first call (eager) {first_s:.4f} s, second "
          f"(the capture, its replay) {capture_s:.4f} s; exec_count {n} "
          f"after them and after three more, 4 replays by then; walls "
          f"(host clock, "
          f"waited for) {json.dumps({k: round(v, 4) for k, v in walls.items()})}"
          f" ms; device (CUDA events, queued) "
          f"{json.dumps({k: round(v, 4) for k, v in devs.items()})} ms; "
          f"{prof['launches']} kernels a call; err/limit {worst_i:.3f} "
          f"against interpret ({rtol:g} max(1, max|y|)), {worst_e:.3f} "
          f"against the eager schedule; bytes copied a call 0; graphs "
          f"captured {captures} "
          f"(the second: an earlier output still held), pool "
          f"{rep.graph_pool_bytes / 2 ** 20:.1f} MiB")
    return out


#: phase_dispatch's rows, by label
DISPATCH_RESULTS: dict = {}

#: Calls in one timed chain of ``traffic_rows``' h = f(h) row.
CHAIN_CALLS = 40


def traffic_rows(gen, post, p, layer_args, n_layers: int,
                 ln_args) -> None:
    """Stitched calls whose addresses do not simply repeat, wall time a
    call (host clock, the card synchronized around each timed loop,
    median of 5) of ``dispatch="single"`` against the eager schedule
    (``run_schedule``) on the same inputs:

    * Llama-3.2-3B's ``block_post`` at 1 x 128 looped over ``n_layers``
      per-layer weight sets (clones of one layer's), as a layer loop
      calls it: no set comes back among the last ``GRAPHS_PER_FUNCTION``,
      so nothing may be captured;
    * h = f(h) with the Fig. 1 LayerNorm, ``CHAIN_CALLS`` calls a chain:
      each output is the next input, its address as the allocator or a
      graph's pool gives it; the final h against the eager chain's;
    * one LayerNorm function called at six row counts, three calls each:
      device memory reserved before, with its graphs, and after the
      function is dropped, and the graphs kept (at most
      ``GRAPHS_PER_FUNCTION`` over all its signatures)."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.core import stitched_jit
    from repro_torch.core.stitch import GRAPHS_PER_FUNCTION

    def per_call(loop, calls: int) -> float:
        loop()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            loop()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / calls)
        return statistics.median(times)

    # a layer loop over per-layer weights
    _, h, q, k, v = layer_args
    sets = [pytree.tree_map(lambda t: t.clone(), p) for _ in range(n_layers)]
    f = stitched_jit(post)
    c = f.compiled(sets[0], h, q, k, v)
    flats = [leaves((pl, h, q, k, v)) for pl in sets]

    def loop_single():
        for pl in sets:
            f(pl, h, q, k, v)

    def loop_eager():
        for fl in flats:
            c.run_schedule(*fl)

    walls = {"single": per_call(loop_single, n_layers),
             "eager": per_call(loop_eager, n_layers)}
    got = leaves(f(sets[3], h, q, k, v))
    _, worst = agreement_max(got, leaves(c.run_schedule(*flats[3])), 1e-5)
    rep = c.report
    row = {"wall_ms_per_call": walls, "calls": rep.graph_eager_runs,
           "captures": rep.graph_captures, "worst_vs_eager": worst}
    print(f"dispatch layer loop, Llama-3.2-3B block_post at 1 x 128 over "
          f"{n_layers} weight sets: wall a call (host clock) "
          f"{json.dumps({a: round(b, 4) for a, b in walls.items()})} ms, "
          f"{rep.graph_eager_runs} eager runs, {rep.graph_captures} "
          f"captures, err/limit {worst:.3f} against the eager schedule")
    if rep.graph_captures or worst > 1.0:
        fail("dispatch layer loop: a set of per-layer weights was captured "
             "or the call disagrees with the eager schedule")
    DISPATCH_RESULTS[f"layer loop block_post x{n_layers}"] = row
    del sets, flats, got, f, c

    # h = f(h)
    x0, g, b = ln_args
    fh = stitched_jit(layer_norm_fig1)
    ch = fh.compiled(*ln_args)

    def chain(call):
        hh = x0
        for _ in range(CHAIN_CALLS):
            hh = call(hh)
        return hh

    def single(hh):
        return fh(hh, g, b)

    def eager(hh):
        return ch.run_schedule(hh, g, b)[0]

    walls = {"single": per_call(lambda: chain(single), CHAIN_CALLS),
             "eager": per_call(lambda: chain(eager), CHAIN_CALLS)}
    _, worst = agreement_max([chain(single)], [chain(eager)], 1e-5)
    rep = ch.report
    calls = rep.graph_eager_runs + rep.graph_replays
    row = {"wall_ms_per_call": walls, "calls": calls,
           "eager_runs": rep.graph_eager_runs,
           "replays": rep.graph_replays, "captures": rep.graph_captures,
           "evictions": rep.graph_evictions, "worst_vs_eager": worst}
    print(f"dispatch h = f(h), Fig. 1 LayerNorm [{x0.shape[0]}, "
          f"{x0.shape[1]}], {CHAIN_CALLS} calls a chain: wall a call (host "
          f"clock) {json.dumps({a: round(b, 4) for a, b in walls.items()})}"
          f" ms; of {calls} calls {rep.graph_eager_runs} eager, "
          f"{rep.graph_replays} replays, {rep.graph_captures} captures, "
          f"{rep.graph_evictions} evictions; err/limit {worst:.3f} against "
          f"the eager chain")
    if worst > 1.0:
        fail("dispatch h = f(h): the chain disagrees with the eager chain")
    DISPATCH_RESULTS["h = f(h) LayerNorm"] = row
    del fh, ch

    # one function at several shapes: the graphs it keeps, the memory
    C = x0.shape[1]
    xs = [torch.randn(1024 * m, C, generator=gen, device="cuda")
          for m in range(1, 7)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    fs = stitched_jit(layer_norm_fig1)
    for x in xs:
        for _ in range(2):  # eager, capture (the outputs dropped)
            fs(x, g, b)
        y = fs(x, g, b)  # a replay
        _, worst = agreement_max([y], [layer_norm_fig1(x, g, b)], 1e-5)
        if worst > 1.0:
            fail(f"dispatch shapes: wrong LayerNorm at {tuple(x.shape)}")
        del y
    torch.cuda.synchronize()
    with_graphs = torch.cuda.memory_reserved()
    kept = sum(len(ci.graphs) for ci in fs.instances)
    captures = sum(ci.report.graph_captures for ci in fs.instances)
    evictions = sum(ci.report.graph_evictions for ci in fs.instances)
    del fs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved()
    row = {"shapes": [list(x.shape) for x in xs], "captures": captures,
           "graphs_kept": kept, "evictions": evictions,
           "reserved_before": before, "reserved_with_graphs": with_graphs,
           "reserved_after_drop": after}
    print(f"dispatch shapes, one LayerNorm function at {len(xs)} row counts "
          f"(1024..{1024 * len(xs)} x {C}), 3 calls each: {captures} "
          f"captures, {kept} graphs kept, {evictions} evictions; reserved "
          f"{before / 2 ** 20:.1f} MiB before, {with_graphs / 2 ** 20:.1f} "
          f"MiB with the graphs, {after / 2 ** 20:.1f} MiB once the "
          "function is dropped")
    if kept > GRAPHS_PER_FUNCTION or captures != len(xs):
        fail(f"dispatch shapes: {kept} graphs kept, {captures} captures")
    DISPATCH_RESULTS["shapes LayerNorm x6"] = row
    del xs


def phase_dispatch(gen, checks: dict) -> dict:
    """``dispatch="single"`` as one replayed CUDA graph a call
    (``dispatch_row``): the Fig. 1 LayerNorm at [8192, 3072] (against
    ``F.layer_norm``), ``tests/test_plan_dispatch.py``'s
    ``mini_transformer`` at Llama's widths (2048 rows of 3072, a 8192-wide
    hidden product), and Llama-3.2-3B's ``block_post`` (attention, ``wo``,
    the MLP) called standalone at batch 1 x 128; then the LayerNorm with
    ``donate=True`` (its output written over x, one graph replayed at the
    donated address); then the counted run, one call of each.  Returns
    its launches."""
    import functools

    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core import stitched_jit
    from repro_torch.models.layers import STITCHED
    from repro_torch.models.model import block_init, block_post, block_pre

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    R, C = 8192, 3072
    ln_args = (randn(R, C), randn(C), randn(C))
    M, H = BATCH * PROMPT, ANCHOR_N
    mini_args = (randn(M, C), randn(C).abs() + 0.5, randn(C),
                 randn(C, H, scale=C ** -0.5), randn(H, C, scale=H ** -0.5))
    cfg = get_config("llama3.2-3b")
    p = block_init(cfg, gen, torch.float32, "cuda")
    h = randn(1, 128, cfg.d_model)
    q, k, v = block_pre(cfg, STITCHED, p, h,
                        torch.arange(128, device="cuda"))
    post = functools.partial(block_post, cfg, STITCHED)
    layer_args = (p, h, q, k, v)

    def mini_transformer(x, g1, b1, w1, w2):
        hh = layer_norm_fig1(x, g1, b1)
        u = F.gelu(hh @ w1, approximate="tanh")
        return torch.softmax(x + u @ w2, -1)

    rows = [(f"Fig. 1 LayerNorm [{R}, {C}]", layer_norm_fig1, ln_args, 0,
             1e-5, lambda x, g, b: F.layer_norm(x, (C,), g, b, eps=1e-6)),
            (f"mini_transformer [{M}, {C}] hidden {H}", mini_transformer,
             mini_args, 0, 1e-4, None),
            (f"Llama-3.2-3B block_post at 1 x 128", post, layer_args, 1,
             1e-4, None)]
    for label, fn, args, vary, rtol, lib in rows:
        DISPATCH_RESULTS[label] = dispatch_row(label, fn, args, vary, gen,
                                               checks, rtol=rtol,
                                               library=lib)

    # donation: the LayerNorm's output written over x
    fd = stitched_jit(layer_norm_fig1, donate=True)
    want = layer_norm_fig1(*ln_args)
    xin = ln_args[0].clone()
    cd = fd.compiled(xin, *ln_args[1:])
    first = [em for kind, em in cd.schedule if kind == "group"][0]
    y = fd(xin, *ln_args[1:])
    _, worst = agreement_max([y], [want], 1e-5)
    if y.data_ptr() != xin.data_ptr() or not first.io_aliases or worst > 1:
        fail(f"dispatch donate: aliases {first.io_aliases}, output at x "
             f"{y.data_ptr() == xin.data_ptr()}, err/limit {worst:.3f}")
    del y, want
    donated = {"wall_ms": wall_ms(lambda: fd(xin, *ln_args[1:])),
               "device_ms": time_ms(lambda: fd(xin, *ln_args[1:]), 20),
               "captures": cd.report.graph_captures,
               "replays": cd.report.graph_replays,
               "io_aliases": first.io_aliases, "worst": worst}
    if cd.report.graph_captures != 1:
        fail(f"dispatch donate: {cd.report.graph_captures} captures at one "
             "donated address")
    print(f"dispatch Fig. 1 LayerNorm, donate=True: io_aliases "
          f"{first.io_aliases} (x written over), err/limit {worst:.3f}, wall "
          f"{donated['wall_ms']:.4f} ms, device {donated['device_ms']:.4f} "
          f"ms, {donated['captures']} capture, bytes copied a call 0")
    DISPATCH_RESULTS["Fig. 1 LayerNorm donate=True"] = donated

    traffic_rows(gen, post, p, layer_args, cfg.n_layers, ln_args)

    # the counted run: one call of each, replays
    fns = [stitched_jit(fn) for _, fn, _, _, _, _ in rows] + [fd]
    calls = [a for _, _, a, _, _, _ in rows] + [(xin,) + ln_args[1:]]
    for f, a in zip(fns, calls):
        f(*a)  # eager
        f(*a)  # the capture
    torch.cuda.synchronize()
    reset_launch_counts()
    for f, a in zip(fns, calls):
        f(*a)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"launches in one replayed call of each dispatch row: "
          f"{json.dumps({k: v for k, v in launches.items() if v})}")
    for kern in ("onepass", "matmul_fused", "flash_attention", "rmsnorm"):
        if not launches[kern]:
            fail(f"the dispatch path launched no {kern} kernel")
    del fns, calls, ln_args, mini_args, layer_args, p, xin
    torch.cuda.empty_cache()
    return launches


def at_shift(v, shift: int):
    """``v``'s values in a contiguous tensor that starts ``shift`` elements
    past an aligned address."""
    import torch

    return torch.empty(v.numel() + shift, dtype=v.dtype,
                       device=v.device)[shift:].view(v.shape).copy_(v)


def flash_row(gen, checks: dict, label: str, shape, Sq: int, Skv: int,
              causal: bool, *, main: bool = False) -> None:
    """Hold flash attention (B4, or above D 256 the wide kernel) at one
    shape against its function in float64, with SDPA as its library call
    (with ``is_causal`` where its top-left causal mask is the same, Sq ==
    Skv, else with the causal offset as an explicit boolean mask), and
    fail unless the kernel meant for the shape ran."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA

    B, Hq, Hkv, D = shape
    q = torch.randn(B, Hq, Sq, D, generator=gen, device="cuda")
    k = torch.randn(B, Hkv, Skv, D, generator=gen, device="cuda")
    # v as the model hands it over: [B, S, H, D] transposed (strided)
    v = torch.randn(B, Skv, Hkv, D, generator=gen,
                    device="cuda").transpose(1, 2)
    pairs = (sum(min(Skv, i + Skv - Sq + 1) for i in range(Sq))
             if causal else Sq * Skv)
    if Sq == Skv or not causal:  # SDPA's causal mask is top-left
        def lib(a, b, c, _causal=causal):
            return F.scaled_dot_product_attention(
                a, b, c, is_causal=_causal, enable_gqa=True)
    else:  # query i sees keys up to i + Skv - Sq: the mask made once
        rows = torch.arange(Sq, device="cuda")[:, None] + (Skv - Sq)
        mask = torch.arange(Skv, device="cuda")[None, :] <= rows

        def lib(a, b, c, _mask=mask):
            return F.scaled_dot_product_attention(
                a, b, c, attn_mask=_mask, enable_gqa=True)
    name = "flash_attention_wide" if D > FA.MAX_HEAD_DIM \
        else "flash_attention"
    nbytes = 4 * (2 * q.numel() + 2 * k.numel())
    before = launch_counts()
    res = check_cuda_kernel(
        f"flash_attention {label} B{B} Hq{Hq} Hkv{Hkv} Sq{Sq} Skv{Skv} "
        f"D{D}",
        lambda a, b, c, _c=causal: FA.flash_attention_cuda(a, b, c, _c),
        lambda a, b, c, _c=causal: FA.flash_attention_plain(a, b, c, _c),
        (q, k, v), nbytes=nbytes, ops=0, mma_ops=4 * D * B * Hq * pairs,
        reps=20, library=lib,
        reference=lambda a, b, c, _c=causal: FA.flash_attention_plain(
            a.double(), b.double(), c.double(), _c))
    launched(name, before)
    checks.setdefault(name, []).append(dict(res, _bytes=nbytes, _main=main))


def decode_row(gen, checks: dict, label: str, shape, S: int, n, layers: int,
               *, main: bool = False, float64: bool = False) -> None:
    """Hold flash decode (B8) at one shape against its plain version (with
    ``float64``, against its function in float64, the float32 plain
    version's distance printed beside it), the caches one layer's view of
    an [n_layers, B, Hkv, S, D] buffer as the model hands them over, with
    SDPA as its library call, and fail unless B8 ran."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA

    B, Hq, Hkv, D = shape
    q = torch.randn(B, Hq, D, generator=gen, device="cuda")
    k = torch.randn(layers, B, Hkv, S, D, generator=gen,
                    device="cuda")[layers // 2]
    v = torch.randn(layers, B, Hkv, S, D, generator=gen,
                    device="cuda")[layers // 2]
    eff = S if n is None else n
    nbytes, ops = 4 * (2 * B * Hkv * eff * D + 2 * B * Hq * D), \
        4 * D * B * Hq * eff
    before = launch_counts()
    res = check_cuda_kernel(
        f"flash_decode {label} B{B} Hq{Hq} Hkv{Hkv} S{S} kv_len{eff} "
        f"D{D} ({len(FA.decode_subgroups(Hq // Hkv, D))} sub-group(s))",
        lambda a, b, c, _n=n: FA.flash_decode_cuda(a, b, c, _n),
        lambda a, b, c, _n=n: FA.flash_decode_plain(a, b, c, _n),
        (q, k, v), nbytes=nbytes, ops=0, mma_ops=ops,
        reps=10 if eff > 1e5 else 20, rtol=decode_rtol(eff),
        library=lambda a, b, c, _e=eff: F.scaled_dot_product_attention(
            a[:, :, None], b[:, :, :_e], c[:, :, :_e],
            enable_gqa=True)[:, :, 0],
        reference=(lambda a, b, c, _n=n: FA.flash_decode_plain(
            a.double(), b.double(), c.double(), _n)) if float64 else None)
    launched("flash_decode", before)
    checks.setdefault("flash_decode", []).append(
        dict(res, _bytes=nbytes, _main=main))


def phase_wide(gen, checks: dict) -> None:
    """Attention above head dim 256.  The wide flash kernel at B 4, 16
    heads, prompt 512, causal, at D 320 (its main row), 264 (read in
    place by its 320 instance) and 512 (its largest), at D 300 (no
    multiple of 8) with B 2, at D 320 with 4 KV heads (GQA) and with Sq
    200 < Skv 500 (causal offset, GQA), and at D 640 non-causal (two
    512-column output tiles); flash decode (B8) at D 320 with 4 query
    heads a KV head over 4,000 of 4,096 rows (the 384 instance's masked
    twin), at D 512 with 8 (two sub-groups of 4) over 3,999, at D 264 and
    at D 640 (the tiled kernel), each against its function in float64 at
    its limit of phase 3, then the device time of each kernel of the D
    320 decode call (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as FA

    for label, shape, Sq, Skv, causal in (
            ("wide d320 causal", (BATCH, 16, 16, 320), PROMPT, PROMPT, True),
            ("wide d264 causal", (BATCH, 16, 16, 264), PROMPT, PROMPT, True),
            ("wide d300 causal", (2, 16, 16, 300), PROMPT, PROMPT, True),
            ("wide d512 causal", (BATCH, 16, 16, 512), PROMPT, PROMPT, True),
            ("wide d320 gqa causal", (BATCH, 16, 4, 320), PROMPT, PROMPT,
             True),
            ("wide d320 causal offset gqa", (2, 16, 4, 320), 200, 500, True),
            ("wide d640 non-causal", (1, 8, 8, 640), PROMPT, PROMPT, False)):
        flash_row(gen, checks, label, shape, Sq, Skv, causal,
                  main=label == "wide d320 causal")
    for label, shape, S, n in (
            ("head dim 320 G 4 ragged", (1, 8, 2, 320), 4096, 4000),
            ("head dim 512 G 8 ragged", (1, 16, 2, 512), 4096, 3999),
            ("head dim 264 G 4 ragged", (2, 8, 2, 264), 2048, 2000),
            ("head dim 640 tiled ragged", (1, 8, 2, 640), 4096, 4000)):
        decode_row(gen, checks, label, shape, S, n, 1, float64=True)
    q = torch.randn(1, 8, 320, generator=gen, device="cuda")
    kv = torch.randn(2, 1, 2, 4096, 320, generator=gen, device="cuda")
    for _ in range(3):
        FA.flash_decode_cuda(q, kv[0], kv[1], 4000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            FA.flash_decode_cuda(q, kv[0], kv[1], 4000)
        torch.cuda.synchronize()
    parts = [f"{e.key.replace('(anonymous namespace)::', '').split('(')[0]}"
             f" {e.device_time_total / e.count:.2f} us"
             for e in prof.key_averages() if e.device_time_total > 0]
    print("flash_decode B1 Hq8 Hkv2 kv_len4000 D320, device time a kernel "
          "(mean of 20 calls): " + "; ".join(parts))


def phase_cuda_kernels(gen) -> dict:
    """Build the CUDA kernels from the checkout's sources, then hold each
    against its plain version at the serving path's shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import layernorm as LN
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import softmax as SM
    from repro_torch.kernels import ssd_scan as SS

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"nvcc build of {sorted(libs)}: {time.perf_counter() - t0:.1f} s "
          f"(flags {' '.join(_build.NVCC_FLAGS)})")

    checks: dict[str, list] = {}
    # Llama's prefill and decode rows; then the recurrent paths' prefill,
    # decode and train rows at each width they norm: Mamba2's 1,024 (its
    # blocks) and 2,048 (its gated norm; Zamba2's blocks), Zamba2's 4,096
    # (the concat and its gated norm) -- the kernel's 1-, 2- and 4-float4
    # instances
    T = TRAIN_BATCH * TRAIN_FRAMES
    for R, C in ((BATCH * PROMPT, 3072), (BATCH, 3072),
                 (BATCH * SERVE_PROMPT, 1024), (BATCH, 1024), (T, 1024),
                 (BATCH * SERVE_PROMPT, 2048), (BATCH, 2048), (T, 2048),
                 (BATCH * SERVE_PROMPT, 4096), (BATCH, 4096)):
        x = torch.randn(R, C, generator=gen, device="cuda")
        g = torch.randn(C, generator=gen, device="cuda")
        res = check_cuda_kernel(
            f"rmsnorm [{R}, {C}]", lambda a, b: RN.rmsnorm_cuda(a, b, 1e-6),
            lambda a, b: RN.rmsnorm_plain(a, b, 1e-6), (x, g),
            nbytes=4 * (2 * R * C + C + R), ops=4 * R * C, reps=50,
            library=lambda a, b, _C=C: F.rms_norm(a, (_C,), b, 1e-6))
        checks.setdefault("rmsnorm", []).append(
            dict(res, _bytes=4 * (2 * R * C + C + R),
                 _main=(R, C) == (BATCH * PROMPT, 3072)))
        if C == 3072 and R > BATCH:
            same_bytes_op("torch.mul: x read, one output written",
                          lambda a: torch.mul(a, 2.0, out=torch.empty_like(a)),
                          x)

    for R, C in ((T, 1280), (T - 96, 1280), (8192, 3072)):
        x = torch.randn(R, C, generator=gen, device="cuda") * 2.0 + 0.5
        g = torch.randn(C, generator=gen, device="cuda")
        b = torch.randn(C, generator=gen, device="cuda")
        dy = torch.randn(R, C, generator=gen, device="cuda")
        _, mean, rstd = LN.layernorm_plain(x, g, b, 1e-6)
        main = (R, C) == (T, 1280)
        # each input read once, each output written once; 7 and 13
        # operations an element
        nb_f = 4 * (2 * R * C + 2 * C + 2 * R)
        res = check_cuda_kernel(
            f"layernorm [{R}, {C}]",
            lambda a, c, d: LN.layernorm_cuda(a, c, d, 1e-6),
            lambda a, c, d: LN.layernorm_plain(a, c, d, 1e-6), (x, g, b),
            nbytes=nb_f, ops=7 * R * C, reps=50,
            library=lambda a, c, d, _C=C: F.layer_norm(a, (_C,), c, d, 1e-6))
        checks.setdefault("layernorm", []).append(
            dict(res, _bytes=nb_f, _main=main))
        nb_b = 4 * (3 * R * C + 3 * C + 2 * R)
        res = check_cuda_kernel(
            f"layernorm_bwd [{R}, {C}]", LN.layernorm_bwd_cuda,
            LN.layernorm_bwd_plain, (x, g, mean, rstd, dy),
            nbytes=nb_b, ops=13 * R * C, reps=50,
            library=lambda a, c, m, r, d, _b=b, _C=C:
                torch.ops.aten.native_layer_norm_backward(
                    d, a, [_C], m, r, c, _b, [True, True, True]))
        checks.setdefault("layernorm_bwd", []).append(
            dict(res, _bytes=nb_b, _main=main))
        if main:
            same_bytes_op("torch.add: x and dy read, one output written",
                          lambda a, d: torch.add(a, d,
                                                 out=torch.empty_like(a)),
                          x, dy)

    # the router's softmax (B7) and its backward (B10): Granite's prefill,
    # decode and train rows of 32 experts, a ragged 40-expert shape (the
    # 3B config's), the prefill rows one float past an aligned address
    # (the warp-a-row layout), and rows wider than the one-warp path holds
    main_fwd, main_bwd = (BATCH * PROMPT, 32), (T, 32)
    for R, C, shift in (main_fwd + (0,), (BATCH, 32, 0), main_bwd + (0,),
                        (T - 1, 40, 0), main_fwd + (1,), (256, 4096, 0)):
        x = at_shift(torch.randn(R, C, generator=gen, device="cuda"), shift)
        dy = at_shift(torch.randn(R, C, generator=gen, device="cuda"), shift)
        y = at_shift(SM.softmax_plain(x), shift)
        # max, subtract, exp, sum, divide: 5 operations an element; the
        # backward's multiply, sum, subtract, multiply: 4
        nb_f, nb_b = 4 * 2 * R * C, 4 * 3 * R * C
        res = check_cuda_kernel(
            f"softmax [{R}, {C}]{' one float off' if shift else ''} "
            f"({SM.layout(x)})", SM.softmax_cuda, SM.softmax_plain, (x,),
            nbytes=nb_f, ops=5 * R * C, reps=50,
            library=lambda a: torch.softmax(a, -1))
        checks.setdefault("softmax", []).append(
            dict(res, _bytes=nb_f, _main=(R, C, shift) == main_fwd + (0,)))
        res = check_cuda_kernel(
            f"softmax_bwd [{R}, {C}]{' one float off' if shift else ''} "
            f"({SM.layout(y, dy)})", SM.softmax_bwd_cuda,
            SM.softmax_bwd_plain, (y, dy), nbytes=nb_b, ops=4 * R * C,
            reps=50, library=lambda a, b: torch._softmax_backward_data(
                b, a, -1, torch.float32))
        checks.setdefault("softmax_bwd", []).append(
            dict(res, _bytes=nb_b, _main=(R, C, shift) == main_bwd + (0,)))

    llama = (BATCH, 24, 8, 128)             # B, Hq, Hkv, D
    hubert = (TRAIN_BATCH, 16, 16, 80)      # D 80: its own instance
    granite = (BATCH, 16, 8, 64)            # D 64
    granite_train = (TRAIN_BATCH, 16, 8, 64)
    zamba = (BATCH, 32, 32, 64)             # Zamba2's shared block
    gemma = (BATCH, 16, 16, 256)            # Gemma-7B's heads: D 256
    for label, shape, Sq, Skv, causal in (
            ("prefill causal", llama, 512, 512, True),
            ("ragged causal", llama, 500, 500, True),
            ("causal offset", llama, 200, 500, True),
            ("non-causal", llama, 512, 512, False),
            ("train non-causal", hubert, TRAIN_FRAMES, TRAIN_FRAMES, False),
            ("moe prefill causal", granite, PROMPT, PROMPT, True),
            ("moe train causal", granite_train, TRAIN_FRAMES, TRAIN_FRAMES,
             True),
            ("hybrid prefill causal", zamba, SERVE_PROMPT, SERVE_PROMPT,
             True),
            ("gemma-7b heads causal", gemma, PROMPT, PROMPT, True)):
        flash_row(gen, checks, label, shape, Sq, Skv, causal,
                  main=label == "prefill causal")

    # the SSD scan (B11) at Mamba2's prefill, Zamba2's prefill and
    # Mamba2's train batch
    for label, (b, L, H, P, N) in (
            ("mamba2 prefill", (BATCH, PROMPT, 32, 64, 128)),
            ("zamba2 prefill", (BATCH, PROMPT, 64, 64, 64)),
            ("mamba2 train", (TRAIN_BATCH, TRAIN_FRAMES, 32, 64, 128)),
            ("padded P32 N96", (2, PROMPT, 16, 32, 96)),
            ("mamba2 prefill at chunk 128", (BATCH, PROMPT, 32, 64, 128)),
            ("P256 N256 in slices", (2, PROMPT, 8, 256, 256))):
        ins = ssd_inputs(gen, b, L, H, P, N)
        chunk = 128 if "chunk 128" in label else SSD_CHUNK
        nbytes, ops, mma = ssd_work(b, L, H, P, N, SS.kernel_chunk(chunk))
        p_sl, n_sl = SS.ssd_slices(SS.kernel_chunk(chunk), P, N, SS._smem())
        before = launch_counts()
        res = check_cuda_kernel(
            f"ssd_scan {label} b{b} L{L} H{H} P{P} N{N} chunk{chunk} "
            f"(launches at chunk {SS.kernel_chunk(chunk)}, {len(p_sl)} P x "
            f"{len(n_sl)} N slices; x, B, C strided)",
            lambda *a, _c=chunk: SS.ssd_scan_cuda(*a, _c),
            lambda *a, _c=chunk: SS.ssd_scan_plain(*a, _c), ins,
            nbytes=nbytes, ops=ops, mma_ops=mma, reps=20, max_rtol=SSD_RTOL)
        launched("ssd_scan", before)
        checks.setdefault("ssd_scan", []).append(
            dict(res, _bytes=nbytes, _main=label == "mamba2 prefill"))

    # flash decode (B8) at the static-decode paths' shapes: Llama's
    # decode_32k (its batch of 128 cut to 4) and batch 1, Granite's head
    # dim 64, Zamba2's long_500k (the cell's own batch of 1), a ragged
    # kv_len, and a live prefix of a layer's strided view
    for label, shape, S, n, layers in (
            ("llama decode_32k", llama, STATIC_KV, None, 1),
            ("llama decode_32k batch 1", (1, 24, 8, 128), STATIC_KV, None,
             1),
            ("granite decode_32k", granite, STATIC_KV, None, 1),
            ("zamba2 long_500k", (1, 32, 32, 64), LONG_KV, None, 1),
            ("ragged kv_len", llama, 1024, 1000, 1),
            ("live prefix of a layer view", llama, 2048, 1500, 3),
            ("gemma-7b decode_32k", gemma, STATIC_KV, None, 1),
            ("head dim 80 masked", (BATCH, 16, 16, 80), 4096, 4000, 1),
            ("16 query heads a KV head", (BATCH, 32, 2, 128), STATIC_KV,
             None, 1)):
        decode_row(gen, checks, label, shape, S, n, layers,
                   main=label == "llama decode_32k")
    phase_wide(gen, checks)
    decode_group_sweep(gen)
    torch.cuda.empty_cache()
    return checks


def host_us(fn, n: int = 500, repeats: int = 5) -> float:
    """The host's cost of one call of ``fn`` in microseconds: the median
    over ``repeats`` loops of ``n`` calls on the host clock, the card
    synchronized before each loop (the calls timed here take less device
    time than host time, so the launch queue does not fill)."""
    import torch

    fn()
    per = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        per.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per)


def phase_router_floor(gen) -> dict:
    """The router softmax against the floor of a launch, at Granite's
    widths (d_model 1,024, 32 experts; device time as ``time_ms`` takes
    it, each call queued behind a device sleep): one empty launch
    (``torch.cuda._sleep(0)``); B7 at the prefill rows [2048, 32] and B10
    at the train rows [4096, 32], alone and beside ``torch.softmax`` and
    ``torch._softmax_backward_data``; the router pair -- the product ``xt
    @ w_router`` then B7, as ``moe_apply`` runs them -- at the prefill's
    [2048, 1024] and the decode step's [4, 1024] rows, beside the product
    alone and the product then ``torch.softmax``; the backward pair --
    ``torch.add`` of two [4096, 32] gradients then B10 -- beside the add
    alone and the add then ``torch._softmax_backward_data``.  A pair less
    its producer alone is what the kernel costs on its path.  B7 also at
    logits ten times as large, where exp(x - max) falls below float32's
    normal range and an IEEE division takes its slow path.  Then where
    the host's cost of one B7 call on the operator goes: the custom op's
    dispatch, the wrapper, the stream lookup and the ctypes entry
    (``host_us``).  Returns {row: ms or us}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import softmax as SM

    cfg = get_config(MOE_ARCH)
    d, E = cfg.d_model, cfg.n_experts
    Rp, Rd, Rt = BATCH * PROMPT, BATCH, TRAIN_BATCH * TRAIN_FRAMES
    out: dict[str, float] = {}

    def row(label, fn, reps=200):
        out[label] = time_ms(fn, reps)
        print(f"router floor: {label}: {out[label]:.4f} ms")
        return out[label]

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    empty = row("empty launch, torch.cuda._sleep(0)",
                lambda: torch.cuda._sleep(0))
    x, w = randn(Rp, E, scale=3.0), randn(d, E, scale=d ** -0.5)
    y, g1, g2 = SM.softmax_plain(randn(Rt, E, scale=3.0)), randn(Rt, E), \
        randn(Rt, E)
    b7 = row(f"B7 [{Rp}, {E}]", lambda: SM.softmax_cuda(x))
    row(f"torch.softmax [{Rp}, {E}]", lambda: torch.softmax(x, -1))
    # logits of a larger scale: exp(x - max) falls below float32's normal
    # range, where an IEEE division takes its slow path
    x10 = x * 10.0
    row(f"B7 [{Rp}, {E}], logits x 10", lambda: SM.softmax_cuda(x10))
    row(f"torch.softmax [{Rp}, {E}], logits x 10",
        lambda: torch.softmax(x10, -1))
    b10 = row(f"B10 [{Rt}, {E}]", lambda: SM.softmax_bwd_cuda(y, g1))
    row(f"torch._softmax_backward_data [{Rt}, {E}]",
        lambda: torch._softmax_backward_data(g1, y, -1, torch.float32))
    for R, step in ((Rp, "prefill"), (Rd, "decode")):
        xt = randn(R, d)
        prod = row(f"{step} product [{R}, {d}] @ [{d}, {E}]",
                   lambda _x=xt: _x @ w)
        pair = row(f"{step} product then B7",
                   lambda _x=xt: SM.softmax(_x @ w))
        lib = row(f"{step} product then torch.softmax",
                  lambda _x=xt: torch.softmax(_x @ w, -1))
        print(f"router floor: {step}: B7 on its path (pair - product) "
              f"{pair - prod:.4f} ms, torch.softmax {lib - prod:.4f} ms")
    add = row(f"torch.add of two [{Rt}, {E}]", lambda: torch.add(g1, g2))
    pair = row("add then B10", lambda: SM.softmax_bwd(y, torch.add(g1, g2)))
    lib = row("add then torch._softmax_backward_data",
              lambda: torch._softmax_backward_data(torch.add(g1, g2), y, -1,
                                                   torch.float32))
    print(f"router floor: B10 on its path (pair - add) {pair - add:.4f} ms, "
          f"torch._softmax_backward_data {lib - add:.4f} ms; B7 and B10 "
          f"alone less the empty launch: {b7 - empty:.4f} / "
          f"{b10 - empty:.4f} ms")
    call = time_ms(lambda: SM.softmax(x), 200, queued=False)
    out["call with the host's cost, the operator"] = call
    # the host's cost of one B7 call, layer by layer
    yb = torch.empty_like(x)
    entry = SM._entry("repro_softmax_fwd")
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    costs = {
        "operator repro_torch::softmax": host_us(lambda: SM.softmax(x)),
        "wrapper softmax_cuda": host_us(lambda: SM.softmax_cuda(x)),
        "torch.empty_like": host_us(lambda: torch.empty_like(x)),
        "torch.cuda.current_stream(dev).cuda_stream": host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        "torch._C._cuda_getCurrentRawStream": host_us(
            lambda: torch._C._cuda_getCurrentRawStream(dev.index)),
        "ctypes entry and launch": host_us(
            lambda: entry(x.data_ptr(), yb.data_ptr(), Rp, E, 0, stream)),
    }
    for k, us in costs.items():
        out[f"host us: {k}"] = us
    op, wrap, ent = (costs["operator repro_torch::softmax"],
                     costs["wrapper softmax_cuda"],
                     costs["ctypes entry and launch"])
    print(f"router floor: B7 call with the host's cost {call:.4f} ms; "
          f"host us a call: " + ", ".join(f"{k} {v:.2f}"
                                          for k, v in costs.items())
          + f"; so the custom op's dispatch {op - wrap:.2f} us, the "
          f"wrapper's own work {wrap - ent:.2f} us, the entry {ent:.2f} us")
    return out


def decode_group_sweep(gen) -> None:
    """Print B8's device time at one cache, [4, 2, 32768, 128] (the same
    bytes each call), against the query heads a KV head: G 1 to 8 in one
    launch, 16 in two sub-groups.  How the time grows with G, beside the
    cache's bytes floor, is what separates the kernel's per-head work
    from its reads."""
    import torch

    from repro_torch.kernels import flash_attention as FA

    B, Hkv, S, D = BATCH, 2, STATIC_KV, 128
    k = torch.randn(B, Hkv, S, D, generator=gen, device="cuda")
    v = torch.randn(B, Hkv, S, D, generator=gen, device="cuda")
    times = []
    for G in (1, 2, 3, 4, 5, 6, 7, 8, 16):
        q = torch.randn(B, Hkv * G, D, generator=gen, device="cuda")
        ms = time_ms(lambda: FA.flash_decode_cuda(q, k, v, None), 20)
        times.append(f"G{G} {ms:.4f}")
    floor = 4 * 2 * B * Hkv * S * D / HBM_BYTES_PER_S * 1e3
    print(f"flash_decode by query heads a KV head, B{B} Hkv{Hkv} S{S} D{D} "
          f"(the cache's bytes {floor:.4f} ms): " + " ".join(times))


def sass_check() -> None:
    """Whether each instance of B3, B4 and B11 built in this run holds
    tensor-core instructions, read with ``cuobjdump -sass`` on its
    library: ``HGMMA`` (``wgmma``) in every B3 kernel, ``HMMA`` with
    ``.TF32`` (``mma.sync``) in every B4 kernel, in every instance of the
    wide flash kernel (above head dim 256) and in B11's chunk and output
    passes (its state pass multiplies nothing).  Printed once; a kernel
    without them fails the run."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    # (library glob, B name, kernel name fragments with products)
    kinds = (("mm_*.so", "B3", ("mm_fused_kernel",)),
             ("attn_*.so", "B4", ("flash_fwd_kernel", "flash_wide_kernel")),
             ("flash_attention-*.so", "B4", ("flash_fwd_kernel",)),
             ("flash_attention_wide-*.so", "B4 wide", ("flash_wide_kernel",)),
             ("ssd_scan-*.so", "B11", ("ssd_chunk_kernel",
                                       "ssd_output_kernel")))
    bad = []
    for pattern, which, kernels in kinds:
        for lib in sorted(_build.BUILD_DIR.glob(pattern)):
            bad += sass_of(cuobjdump, lib, which, kernels)
    if bad:
        fail(f"no tensor-core instruction in {bad}")


def sass_of(cuobjdump, lib, which: str, kernels) -> list:
    """Print the tensor-core instructions of each kernel of ``lib`` whose
    name holds one of ``kernels``; return those without any."""
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    b3 = which == "B3"
    bad = []
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        if not any(k in name for k in kernels):
            continue
        lines = fn.splitlines()
        n = sum(("HGMMA" in ln) if b3 else ("HMMA" in ln and "TF32" in ln)
                for ln in lines)
        inst = f"{which} {lib.name.split('-')[0]}"
        print(f"sass {inst} {name[:90]}: {n} "
              f"{'HGMMA' if b3 else 'HMMA .TF32'}")
        if n == 0:
            bad.append(f"{inst} {name[:60]}")
    return bad


#: The static-decode paths' cache lengths: the reference's decode_32k and
#: long_500k cells (``src/repro/configs/base.py:138-139``).
STATIC_KV, LONG_KV = 32768, 524288


def decode_rtol(kv_len: int) -> float:
    """Flash decode's per-element limit against its plain version:
    ``agreement`` at RTOL up to 32,768 keys, then growing as the square
    root of the sum's length (float32 rounding of a sum grows so): 4e-5
    at 524,288 keys."""
    return RTOL * max(1.0, math.sqrt(kv_len / STATIC_KV))


#: The SSD scan's limit against its plain version: each output within
#: SSD_RTOL max(1, max|plain|) (float32 sums over 64-row chunks and a
#: state of up to 128 columns, in another order; the chunk-to-chunk
#: carry compounds the rounding, so a per-element relative limit is too
#: tight for outputs near zero).
SSD_RTOL, SSD_CHUNK = 1e-4, 64


def ssd_inputs(gen, b: int, L: int, H: int, P: int, N: int):
    """x [b, L, H, P], dt [b, L, H] > 0, A [H] < 0, B and C [b, L, N]: x,
    B and C column slices of one [b, L, H P + 2 N] activation, as
    ``mamba_apply`` passes them (row stride H P + 2 N)."""
    import torch
    import torch.nn.functional as F

    di = H * P
    xbc = torch.randn(b, L, di + 2 * N, generator=gen, device="cuda")
    x = xbc[..., :di].reshape(b, L, H, P)
    dt = F.softplus(torch.randn(b, L, H, generator=gen, device="cuda") - 2.0)
    A = -torch.exp(0.3 * torch.randn(H, generator=gen, device="cuda"))
    return x, dt, A, xbc[..., di:di + N], xbc[..., di + N:]


def ssd_work(b: int, L: int, H: int, P: int, N: int,
             c: int) -> tuple[int, int, int]:
    """(bytes, element-wise operations, product operations) of one scan:
    each input read once and each output written once (float32); the
    products the function needs, at 2 operations a multiply-add -- C B^T
    [c, c] over N once per (batch, chunk), since B and C are one group
    that all heads share (the kernel, like the TPU kernel, recomputes it
    per head: that extra work is not the function's), then per (batch,
    head, chunk) W x over c, C h^T and the state update over c; the
    element-wise terms (the decay and dt of W, y's scale and sum, the
    state's decay, the cumulative sum)."""
    nbytes = 4 * (2 * b * L * H * P + b * L * H + H + 2 * b * L * N
                  + b * H * P * N)
    chunks = b * (L // c)
    mma = chunks * (2 * c * c * N + H * (2 * c * c * P + 4 * c * P * N))
    elem = chunks * H * (4 * c * c + 3 * c * P + 2 * P * N + 4 * c)
    return nbytes, elem, mma


def launch_counts() -> dict:
    from repro_torch.core.codegen import OnePassKernel, StreamingKernel
    from repro_torch.kernels.flash_attention import flash_attention_cuda, \
        flash_attention_wide_cuda, flash_decode_cuda
    from repro_torch.kernels.layernorm import layernorm_bwd_cuda, \
        layernorm_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.kernels.flash_attention import ScoreMod
    from repro_torch.kernels.matmul import matmul_fused
    from repro_torch.kernels.softmax import softmax_bwd_cuda, softmax_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    from repro_torch.kernels.flash_attention import WIDE_SCORE_MOD
    from repro_torch.kernels.matmul import CLUSTER_EPILOGUE, PROLOGUE_REDUCE

    return {**{k: v.launches for k, v in bf16_counters().items()},
            "onepass": OnePassKernel.launches,
            "flash_attention_wide": flash_attention_wide_cuda.launches,
            "matmul_fused": matmul_fused.launches,
            "matmul_fused_prologue_reduce": PROLOGUE_REDUCE.launches,
            "matmul_fused_cluster_epilogue": CLUSTER_EPILOGUE.launches,
            "flash_wide_score_mod": WIDE_SCORE_MOD.launches,
            "flash_score_mod": ScoreMod.launches,
            "streaming": StreamingKernel.launches,
            "rmsnorm": rmsnorm_cuda.launches,
            "flash_attention": flash_attention_cuda.launches,
            "flash_decode": flash_decode_cuda.launches,
            "layernorm": layernorm_cuda.launches,
            "layernorm_bwd": layernorm_bwd_cuda.launches,
            "softmax": softmax_cuda.launches,
            "softmax_bwd": softmax_bwd_cuda.launches,
            "ssd_scan": ssd_scan_cuda.launches}


def bf16_counters() -> dict:
    """{name: counter} of the kernels' bfloat16 instances (counted in
    their kernel's own counter too)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import matmul as MM
    from repro_torch.kernels import rmsnorm as RN

    from repro_torch.kernels import layernorm as LN
    from repro_torch.kernels import softmax as SM
    from repro_torch.kernels import ssd_scan as SS

    return {"rmsnorm_bf16": RN.BF16, "flash_attention_bf16": FA.BF16,
            "flash_score_mod_bf16": FA.SCORE_MOD_BF16,
            "flash_decode_bf16": FA.DECODE_BF16,
            "matmul_fused_bf16": MM.BF16, "layernorm_bf16": LN.BF16,
            "layernorm_bwd_bf16": LN.BWD_BF16, "softmax_bf16": SM.BF16,
            "softmax_bwd_bf16": SM.BWD_BF16, "ssd_scan_bf16": SS.BF16}


def reset_launch_counts() -> None:
    from repro_torch.core.codegen import OnePassKernel, StreamingKernel
    from repro_torch.kernels.flash_attention import flash_attention_cuda, \
        flash_attention_wide_cuda, flash_decode_cuda
    from repro_torch.kernels.layernorm import layernorm_bwd_cuda, \
        layernorm_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.kernels.flash_attention import ScoreMod
    from repro_torch.kernels.matmul import matmul_fused
    from repro_torch.kernels.softmax import softmax_bwd_cuda, softmax_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    from repro_torch.kernels.flash_attention import WIDE_SCORE_MOD
    from repro_torch.kernels.matmul import CLUSTER_EPILOGUE, PROLOGUE_REDUCE

    PROLOGUE_REDUCE.launches = CLUSTER_EPILOGUE.launches = 0
    WIDE_SCORE_MOD.launches = 0
    for c in bf16_counters().values():
        c.launches = 0
    OnePassKernel.launches = StreamingKernel.launches = 0
    flash_attention_wide_cuda.launches = 0
    matmul_fused.launches = ScoreMod.launches = 0
    rmsnorm_cuda.launches = flash_attention_cuda.launches = 0
    flash_decode_cuda.launches = 0
    layernorm_cuda.launches = layernorm_bwd_cuda.launches = 0
    softmax_cuda.launches = softmax_bwd_cuda.launches = 0
    ssd_scan_cuda.launches = 0


def phase_serving(gen, checks: dict, arch: str = "llama3.2-3b") -> tuple:
    """``generate`` at full width in the default (stitched) mode; returns
    the launches of the counted run, and those of the scheduler phase
    (``phase_scheduler``, on the same model) for the models in
    ``SCHED_REQUESTS``, else None.  Appends the checks of the generated
    kernels it launches to ``checks``.  An MoE model also gets the
    full-width MoE layer check, and its logits are held row by row.  An
    SSM or hybrid model serves its prompt at its exact length, and its
    launches per prefill and per decode step are held to one SSD scan a
    layer (prefill only), two RMSNorms a layer and a shared application,
    one flash attention a shared application (prefill only)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, greedy_step
    from repro_torch.models.model import RECURRENT, Model, shared_layers
    from repro_torch.serving.buckets import Buckets, pad_tokens

    cfg = get_config(arch)
    moe = cfg.family == "moe"
    recurrent = cfg.family in RECURRENT
    apps = len(shared_layers(cfg))
    B, S, G = BATCH, SERVE_PROMPT, SERVE_GEN
    V = cfg.vocab_size
    bk = Buckets()
    Sp = S if recurrent else bk.bucket(S)
    max_len = bk.bucket(max(Sp, S + G))
    torch.cuda.empty_cache()
    model = Model(cfg)
    if model.fusion_mode != "stitched":
        fail(f"Model's default fusion mode is {model.fusion_mode!r}")
    params = model.init(SEED)
    prompts = np.random.default_rng(SEED).integers(0, V, (B, S))
    experts = (f" experts={cfg.n_experts} top_k={cfg.top_k} d_ff={cfg.d_ff}"
               f" capacity_factor={cfg.capacity_factor} moe_impl="
               f"{cfg.moe_impl}" if moe else "")
    if recurrent:
        experts = (f" d_inner={cfg.resolved_d_inner} ssm_heads="
                   f"{cfg.ssm_heads}x{cfg.ssm_head_dim} state={cfg.ssm_state}"
                   f" chunk={cfg.ssm_chunk} conv={cfg.conv_width}")
        if apps:
            experts += (f" shared attention before layers "
                        f"{shared_layers(cfg)} ({cfg.n_heads}x"
                        f"{cfg.resolved_head_dim} heads, d_ff={cfg.d_ff})")
    bucket = "exact: a recurrent prefill takes no pad" if recurrent \
        else f"bucket {Sp}"
    print(f"serving path: {cfg.name} layers={cfg.n_layers} d_model="
          f"{cfg.d_model}{experts} batch={B} prompt={S} ({bucket}) "
          f"gen={G} cache={max_len} float32 seed={SEED} fusion_mode=stitched")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate(model, params, prompts, G)
    cold_s = time.perf_counter() - t0
    # the counted run of the serving path
    reset_launch_counts()
    t0 = time.perf_counter()
    seqs = generate(model, params, prompts, G)
    warm_s = time.perf_counter() - t0
    launches = launch_counts()
    print(f"launches in one generate (1 prefill + {G - 1} decode steps): "
          f"{json.dumps(launches)}")
    if recurrent:
        need = ("rmsnorm", "ssd_scan") + (("flash_attention",) if apps else ())
    else:
        need = ("rmsnorm", "flash_attention") + (("softmax",) if moe else ())
    for k in need:
        if launches[k] <= 0:
            fail(f"the serving path launched no {k} kernel")
    print(f"compile_s={cold_s - warm_s:.2f} (first generate {cold_s:.2f} s "
          f"minus the second {warm_s:.2f} s: trace, plan, emit, Triton "
          f"builds)  end-to-end tokens/s={B * G / warm_s:.1f} (host clock, "
          f"{B} x {G} tokens, prefill included)")

    toks = torch.from_numpy(pad_tokens(prompts, Sp)).to("cuda")
    cache = model.init_cache(B, max_len)
    positions = torch.arange(S, S + G, device="cuda")

    def first_token():
        lg, _ = model.prefill(params, toks, cache)
        return lg[:, S - 1:S, :V].argmax(-1)

    reset_launch_counts()
    tok = first_token()
    torch.cuda.synchronize()
    per_prefill = launch_counts()
    reset_launch_counts()
    model.decode_step(params, cache, tok, positions[0],
                      kv_len=positions[0] + 1)
    torch.cuda.synchronize()
    per_decode = launch_counts()
    if cfg.family == "dense":
        static_vs_masked(model, params, cache, tok, S)
    print(f"launches per prefill: {json.dumps(per_prefill)}; per decode "
          f"step: {json.dumps(per_decode)}")
    # B3 runs the MLP gate projection with its SiLU x up (or GeGLU)
    # epilogue: once a layer (Llama), once a shared application (Zamba2);
    # no group of the MoE or the Mamba layers anchors under the H100 gate
    b3_want = (cfg.n_layers if cfg.family == "dense"
               else apps if cfg.family == "hybrid" else 0)
    for step, per in (("prefill", per_prefill), ("decode step", per_decode)):
        if per["matmul_fused"] != b3_want:
            fail(f"B3 launched {per['matmul_fused']} times per {step}, "
                 f"want {b3_want}")
    if moe and not (per_prefill["softmax"] == per_decode["softmax"]
                    == cfg.n_layers):
        fail(f"the router softmax launched {per_prefill['softmax']} times "
             f"per prefill and {per_decode['softmax']} per decode step, "
             f"want {cfg.n_layers} (one a layer)")
    if recurrent:
        from repro_torch.kernels.ssd_scan import LAUNCHES_PER_CALL

        norms = 2 * cfg.n_layers + 2 * apps + 1
        ssd = cfg.n_layers * LAUNCHES_PER_CALL
        for step, per, want in (
                ("prefill", per_prefill, {"rmsnorm": norms, "flash_attention":
                                          apps, "ssd_scan": ssd}),
                ("decode step", per_decode, {"rmsnorm": norms,
                                             "flash_attention": 0,
                                             "ssd_scan": 0})):
            for k, n in want.items():
                if per[k] != n:
                    fail(f"{k} launched {per[k]} times per {step}, want {n}")
    # the compiled functions at the prefill and the decode signatures
    p0, h = params["blocks"][0], params["embed"][toks]
    head_p = model._head_params(params)
    pos_p = torch.arange(Sp, device="cuda")
    h1, pos1 = params["embed"][tok], positions[:1]
    if recurrent:
        mc = cache["mamba"][0]
        served = {
            "prefill mamba": model.mamba.compiled(p0, h, mc["conv"],
                                                  mc["ssm"]),
            "prefill head": model.logits_head.compiled(head_p, h),
            "decode mamba": model.mamba.compiled(p0, h1, mc["conv"],
                                                 mc["ssm"]),
            "decode head": model.logits_head.compiled(head_p, h1)}
        if apps:
            sp, kv = params["shared_attn"], cache["attn"][0]
            q, k, v = model.shared_pre(sp, h, h, pos_p)
            served.update({
                "prefill shared pre": model.shared_pre.compiled(sp, h, h,
                                                                pos_p),
                "prefill shared post": model.post.compiled(sp, h, q, k, v)})
            q, k, v = model.shared_pre(sp, h1, h1, pos1)
            served.update({
                "decode shared pre": model.shared_pre.compiled(sp, h1, h1,
                                                               pos1),
                "decode shared post": model.post.compiled(
                    sp, h1, q, kv["k"], kv["v"], positions[0] + 1)})
    else:
        q, k, v = model.pre(p0, h, pos_p)
        served = {"prefill pre": model.pre.compiled(p0, h, pos_p),
                  "prefill post": model.post.compiled(p0, h, q, k, v),
                  "prefill head": model.logits_head.compiled(head_p, h)}
        q, k, v = model.pre(p0, h1, pos1)
        served.update({
            "decode pre": model.pre.compiled(p0, h1, pos1),
            "decode post": model.post.compiled(
                p0, h1, q, cache["k"][0], cache["v"][0], positions[0] + 1),
            "decode head": model.logits_head.compiled(head_p, h1)})
    for name, comp in served.items():
        describe(f"{name:19s}" if recurrent else f"{name:12s}", comp)
    # every generated kernel instance that serving launches, at its shapes
    check_generated(served, gen, checks)
    weights = sum(t.numel() * t.element_size()
                  for t in torch.utils._pytree.tree_leaves(
                      [params["blocks"], params["lm_head"],
                       params.get("shared_attn", {})]))
    print(f"weights a decode step reads (blocks + LM head"
          f"{' + shared block' if apps else ''}): {weights / 1e9:.2f} GB")
    if recurrent:
        state = sum(t.numel() * t.element_size() for c in cache["mamba"]
                    for t in c.values())
        print(f"SSM and conv state a decode step reads and writes anew: "
              f"{state / 1e9:.3f} GB")
    if moe:
        ew = sum(t.numel() * t.element_size() for p in params["blocks"]
                 for n, t in p["moe"].items() if n != "router")
        print(f"of which expert weights: {ew / 1e9:.2f} GB, all of them read "
              f"by every decode step (one token a sequence still fills a "
              f"capacity-4 buffer for each of the {cfg.n_experts} experts): "
              f"at least {ew / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s")

    ttft = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok = first_token().cpu()
        ttft.append((time.perf_counter() - t0) * 1e3)
    tok = tok.to("cuda")
    steps = []
    for i in range(G - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, _ = model.decode_step(params, cache, tok, positions[i],
                                  kv_len=positions[i] + 1)
        tok = lg[:, -1:, :V].argmax(-1)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(steps)
    print(f"time to first token={statistics.median(ttft):.2f} ms (median of "
          f"3: prefill of {B} x {Sp} + argmax + copy to the host)  decode="
          f"{step_ms:.2f} ms per token (median of {G - 1} eager steps, host "
          f"clock around a synchronized step)  decode tokens/s="
          f"{B * 1e3 / step_ms:.1f}")
    # generate's decode step as it runs there: one captured graph
    graph = greedy_step(model, params, cache)
    ctok = graph(tok, positions[0])  # warm-up, capture, first replay
    csteps = []
    for i in range(G - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctok = graph(ctok, positions[i])
        torch.cuda.synchronize()
        csteps.append((time.perf_counter() - t0) * 1e3)
    cstep_ms = statistics.median(csteps)
    print(f"decode (captured, generate's step)={cstep_ms:.2f} ms per token "
          f"(median of {G - 1} replays)  decode tokens/s="
          f"{B * 1e3 / cstep_ms:.1f}")
    captured_vs_eager(f"generate's decode step ({cfg.name}, batch {B})",
                      graph, greedy_step(model, params, cache, capture=False),
                      (tok, positions[1]), cstep_ms, step_ms)
    del graph, ctok
    where_the_time_goes("one prefill", first_token)
    dec = where_the_time_goes("one decode step", lambda: model.decode_step(
        params, cache, tok, positions[1], kv_len=positions[1] + 1))
    busy = sum(v for k, v in dec.items() if k != "wall_ms")
    print(f"decode step: device busy {busy:.2f} ms = {100 * busy / step_ms:.1f}% "
          f"of the unprofiled step ({step_ms:.2f} ms)")
    if moe:
        moe_layer_check(cfg, params, gen)

    # the plain path on the card, then both fed the plain path's tokens
    plain = Model(cfg, "xla", dispatch="interpret")
    ref_seqs = generate(plain, params, prompts, G, capture=False)
    same = float((seqs[:, S:] == ref_seqs[:, S:]).mean())
    forced = torch.from_numpy(ref_seqs[:, S:]).to("cuda")

    def forced_logits(mdl):
        """Step 0: the prefill's rows (all B x Sp for an MoE model, else
        the last prompt position's); then each decode step's B rows."""
        c = mdl.init_cache(B, max_len)
        lg, _ = mdl.prefill(params, toks, c)
        out = [lg[:, :, :V].reshape(-1, V) if moe else lg[:, S - 1, :V]]
        del lg
        for i in range(G - 1):
            lg, _ = mdl.decode_step(params, c, forced[:, i:i + 1],
                                    positions[i], kv_len=positions[i] + 1)
            out.append(lg[:, 0, :V])
        return out

    got, want = forced_logits(model), forced_logits(plain)
    torch.cuda.synchronize()
    if moe:
        agree, worst = moe_logit_rows(got, want, forced, B, Sp, S)
    else:
        got, want = torch.stack(got), torch.stack(want)
        worst = 0.0
        for i in range(G):
            err = float((got[i] - want[i]).abs().max())
            tol = 1e-4 * max(1.0, float(want[i].abs().max()))
            worst = max(worst, err / tol)
            if i in (0, G - 1) or err > tol:
                print(f"  step {i}: max|dlogits|={err:.3e} (tol {tol:.2e})")
        agree = float((got.argmax(-1) == forced.T).float().mean())
        print(f"teacher-forced agreement with fusion_mode='xla', "
              f"dispatch='interpret' over {G} steps: worst max|dlogits|/tol="
              f"{worst:.3f} (tol 1e-4 max(1, max|logits|) per step), argmax "
              f"agreement={agree:.4f} (min 0.99); free-running tokens equal: "
              f"{same:.4f}")
    if moe:
        print(f"free-running tokens equal: {same:.4f}")
    if (not all(torch.isfinite(g).all() for g in got)
            or tuple(seqs.shape) != (B, S + G)):
        fail("serving path: non-finite logits or wrong output shape")
    if worst > 1.0 or agree < 0.99:
        fail("the stitched serving path disagrees with the plain path")
    if cfg.name not in SCHED_REQUESTS:
        return launches, None
    del got, want, cache
    torch.cuda.empty_cache()
    return launches, phase_scheduler(model, params, plain)


def static_vs_masked(model, params, cache, tok, pos: int) -> None:
    """One decode step at ``pos`` with the static ``kv_len = pos + 1``
    (``flash_decode``) against the device-valued one (the masked plain
    attention) on the same cache: both attend the rows 0..pos, so the
    logits agree within 1e-4 max(1, max|logits|).  Both write the same
    cache row."""
    import torch

    p = torch.tensor(pos, device="cuda")
    want, _ = model.decode_step(params, cache, tok, p, kv_len=p + 1)
    before = launch_counts()["flash_decode"]
    got, _ = model.decode_step(params, cache, tok, pos, kv_len=pos + 1)
    torch.cuda.synchronize()
    n = launch_counts()["flash_decode"] - before
    err = float((got - want).abs().max())
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"static kv_len = pos + 1 = {pos + 1} (flash_decode, {n} launches) "
          f"against the device-valued one (masked): max|dlogits|={err:.3e} "
          f"(tol {tol:.2e}), argmax agreement {agree:.4f}")
    if n != model.cfg.n_layers or not err <= tol or agree < 0.99:
        fail("the static-kv_len decode step disagrees with the masked one")


#: Counted calls of a step in each of ``kernel_events``'s sessions, after
#: the session's first call, which is not counted.
PROFILED_CALLS = 3
#: ``kernel_events``'s sessions.
PROFILED_SESSIONS = 2


def kernel_events(fn) -> tuple[float, dict, str]:
    """Calls of ``fn`` under ``torch.profiler``: (device busy ms a call,
    {kernel name: launches a call}, records dropped) -- a replayed graph's
    kernels included, copies and fills not, whether they run as copies
    (``Memcpy`` / ``Memset`` records) or, as a graph's copy nodes may, as
    kernels (``memcpy128``, ``memcpy32_post``).  Each call is queued
    behind a device sleep and ``PROFILE_PAD_KERNELS`` spin kernels, which
    split a session's records into its calls and are counted nowhere.

    On the H100 machine the profiler drops the first kernel records of
    every session, a number that grows over a long process: 1 to 9 in run
    26P, of the eager and the replayed step alike, always in a session's
    first call and never in a later one; a call of one kernel can lose
    it all, and then its spin kernels merge with the next call's.  So
    each of ``PROFILED_SESSIONS`` sessions makes one call more
    than it counts: its first call takes the loss, the last
    ``PROFILED_CALLS`` calls are counted, and a kernel's count is the
    largest any counted call gave (a loss only lowers a count).  A kernel
    that one step launches and the other does not differs at every call.
    "Records dropped": the most by which a session's first call fell
    short of that count, and how many sessions lost the spin kernels
    before their first call (that call is then not seen at all)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def session() -> list:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(1 + PROFILED_CALLS):
                torch.cuda._sleep(PROFILE_QUEUE_CYCLES)
                for _ in range(PROFILE_PAD_KERNELS):
                    torch.cuda._sleep(1)
                fn()
            torch.cuda.synchronize()
        # a call is the records after a run of spin kernels; records
        # before the first run belong to no call
        calls, spin = [], False
        for ev in sorted(prof.events(), key=lambda e: e.time_range.start):
            if (getattr(ev, "device_type", None) != DeviceType.CUDA
                    or ev.self_device_time_total <= 0
                    or ev.name == "Command Buffer Full"):
                continue
            if "spin_kernel" in ev.name:
                if not spin:
                    calls.append([])
                spin = True
                continue
            spin = False
            if calls:
                calls[-1].append(ev)
        if len(calls) < PROFILED_CALLS or len(calls) > 1 + PROFILED_CALLS:
            fail(f"kernel_events: the profiler's records split into "
                 f"{len(calls)} calls, not {1 + PROFILED_CALLS}")
        # a loss at the session's start can take the first call's records
        # (its spin runs then merge) or the first spin run (its call then
        # precedes every run): the last PROFILED_CALLS are counted alike,
        # and an unseen first call is None
        return [None] * (1 + PROFILED_CALLS - len(calls)) + calls

    def kernels(call: list) -> dict:
        seen: dict = {}
        for ev in call:
            if not ev.name.lower().startswith(("memcpy", "memset")):
                seen[ev.name] = seen.get(ev.name, 0) + 1
        return seen

    sessions = [session() for _ in range(PROFILED_SESSIONS)]
    counted = [c for calls in sessions for c in calls[1:]]
    busy = sum(ev.self_device_time_total for c in counted
               for ev in c) / 1e3 / len(counted)
    names: dict = {}
    for c in counted:
        for k, n in kernels(c).items():
            names[k] = max(names.get(k, 0), n)
    seen = [sum(names.values()) - sum(kernels(calls[0]).values())
            for calls in sessions if calls[0] is not None]
    dropped = (f"{max(seen)}" if seen else "?") + (
        f" ({len(sessions) - len(seen)} of {len(sessions)} sessions lost "
        "the first call's spin kernels)" if len(seen) < len(sessions)
        else "")
    return busy, names, dropped


def graph_edges(graph) -> dict:
    """{dependency type: edges} of a captured graph's ``cudaGraph_t``
    (``cudaGraphGetEdges_v2``; "full" or "programmatic", the edge a
    programmatic dependent launch keeps in a graph)."""
    import ctypes

    rt = ctypes.CDLL("libcudart.so.12")
    fn = rt.cudaGraphGetEdges_v2
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if fn(g, None, None, None, ctypes.byref(n)):
        fail("cudaGraphGetEdges_v2 could not count the graph's edges")
    m = max(1, n.value)
    frm, to = (ctypes.c_void_p * m)(), (ctypes.c_void_p * m)()
    data = (ctypes.c_uint8 * (8 * m))()  # cudaGraphEdgeData: 8 bytes
    if fn(g, frm, to, data, ctypes.byref(n)):
        fail("cudaGraphGetEdges_v2 could not read the graph's edges")
    kinds = {0: "full", 1: "programmatic"}
    out: dict = {}
    for i in range(n.value):
        k = kinds.get(data[8 * i + 2], f"type {data[8 * i + 2]}")
        out[k] = out.get(k, 0) + 1
    return out


#: Device cycles ``kernel_events`` sleeps before each profiled call
#: (about 10 ms at 1.98 GHz), then ``PROFILE_PAD_KERNELS`` spin kernels.
PROFILE_QUEUE_CYCLES = 20_000_000
#: Spin kernels launched before each profiled call: with the sleep, the
#: records that split a session into its calls (one lost record does not
#: merge two calls).
PROFILE_PAD_KERNELS = 8


def captured_vs_eager(label: str, graph, eager, args: tuple,
                      wall_captured: float, wall_eager: float) -> dict:
    """Profile calls of the captured step and of the eager step on
    the same inputs (the graph's own input tensors, so that PyTorch picks
    the same element-wise kernel templates, which depend on the operands'
    alignment): ``replay_vs_eager``."""
    return replay_vs_eager(label, lambda: graph(*args),
                           lambda: eager(*graph.inputs), graph.kernels,
                           graph.replays, wall_captured, wall_eager)


def replay_vs_eager(label: str, replay, eager, kernels: dict, replays: int,
                    wall_captured: float, wall_eager: float) -> dict:
    """Profile calls of ``replay`` (one graph replay) and of ``eager``
    (the same step run eagerly): device busy beside the unprofiled walls,
    and the kernels of the replay against the eager call's (by name and
    count).  Fails if they differ, or if a replay ran Python-side
    launches (the graph's tally, ``kernels``, is the only count a replay
    adds)."""
    from repro_torch.kernels import _build

    calls = []
    count = _build.count
    _build.count = lambda owner, n=1: calls.append(owner)
    try:
        busy_c, names_c, lost_c = kernel_events(replay)
    finally:
        _build.count = count
    busy_e, names_e, lost_e = kernel_events(eager)
    n_c, n_e = sum(names_c.values()), sum(names_e.values())
    if not n_c or not n_e:
        fail(f"{label}: the profiler saw no kernel ({n_c} replayed, {n_e} "
             "eager)")
    share_c, share_e = busy_c / wall_captured, busy_e / wall_eager
    tally = {getattr(k, "__name__", str(k)): v for k, v in kernels.items()}
    print(f"{label}: captured (one graph replay) wall {wall_captured:.3f} ms"
          f", device busy {busy_c:.3f} ms ({100 * share_c:.1f}%), {n_c} "
          f"kernel launches a step from the profiler; eager wall "
          f"{wall_eager:.3f} ms, busy {busy_e:.3f} ms ({100 * share_e:.1f}%),"
          f" {n_e} launches; replays so far {replays}, launches "
          f"recorded into the graph by the wrappers: {json.dumps(tally)}; "
          f"records the profiler dropped from a session's first, uncounted "
          f"call: {lost_c} replayed, {lost_e} eager")
    if calls:
        fail(f"{label}: a replay made {len(calls)} Python-side kernel calls")
    if names_c != names_e:
        diff = {k: (names_c.get(k, 0), names_e.get(k, 0))
                for k in set(names_c) | set(names_e)
                if names_c.get(k, 0) != names_e.get(k, 0)}
        fail(f"{label}: the replay's kernels differ from the eager step's "
             f"(name: (replay, eager)): {diff}")
    return {"wall_captured_ms": wall_captured, "busy_captured_ms": busy_c,
            "wall_eager_ms": wall_eager, "busy_eager_ms": busy_e,
            "launches": n_c}


#: The scheduler phase: slots, rows a slot, tokens a request, and requests
#: by model (prompts of 100-500 tokens, cycling through the buckets of
#: 128, 256 and 512).
SCHED_SLOTS, SCHED_MAX_LEN, SCHED_GEN = 4, 1024, 16
SCHED_REQUESTS = {"llama3.2-3b": 12, MOE_ARCH: 4, HYBRID_ARCH: 4}
SCHED_LENGTHS = ((100, 128), (129, 256), (257, 500))


def phase_scheduler(model, params, plain) -> dict:
    """``ContinuousBatcher`` at full width and depth: ``SCHED_SLOTS``
    slots of ``SCHED_MAX_LEN`` rows, seeded requests of ``SCHED_GEN``
    tokens, each decode wave one replayed CUDA graph.  A cold run
    (compiles and the capture), then the counted run of the same
    requests; the same requests through an eager batcher; the counted
    run's prefills and waves replayed on the plain path (``plain``:
    ``"xla"``, ``dispatch="interpret"``, eager) fed the same tokens --
    logits within 1e-4 max(1, max|logits|) (an MoE model row by row, as
    ``moe_logit_rows``), the greedy tokens equal (the argmax of every
    plain row is the kernel path's token); then one wave profiled
    captured and eager.  A bucketed prefill (Llama, Granite) is one
    replayed graph a bucket: its token against the eager batcher's same
    prefill, ms a prefill by bucket captured against eager
    (``prefill_graphs``), and the largest bucket's prefill profiled
    captured and eager.  Returns the counted run's launches."""
    import numpy as np
    import torch
    from repro_torch.kernels.softmax import softmax_cuda
    from repro_torch.serving import ContinuousBatcher, ServeStats

    cfg = model.cfg
    V, moe = cfg.vocab_size, cfg.family == "moe"
    n = SCHED_REQUESTS[cfg.name]
    rng = np.random.default_rng(SEED + 1)
    lengths = [int(rng.integers(lo, hi + 1))
               for lo, hi in (SCHED_LENGTHS[i % 3] for i in range(n))]
    prompts = [rng.integers(0, V, s) for s in lengths]
    print(f"scheduler: {cfg.name} ContinuousBatcher n_slots={SCHED_SLOTS} "
          f"max_len={SCHED_MAX_LEN} requests={n} prompt lengths={lengths} "
          f"max_new={SCHED_GEN} float32 seed={SEED}")
    batcher = ContinuousBatcher(model, params, n_slots=SCHED_SLOTS,
                                max_len=SCHED_MAX_LEN)

    def serve(b) -> dict:
        ids = [b.submit(p, max_new=SCHED_GEN) for p in prompts]
        out = b.run()
        return {i: out[r] for i, r in enumerate(ids)}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve(batcher)
    cold_s = time.perf_counter() - t0
    # the counted run, its prefills and waves recorded for the plain path
    batcher.stats = ServeStats()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with recorded(batcher, moe) as events:
        got = serve(batcher)
    warm_s = time.perf_counter() - t0
    launches = launch_counts()
    st = batcher.stats
    graph = batcher._wave
    print(f"launches in the counted run ({st.prefills} prefills, "
          f"{st.decode_waves} waves; a replay counts the launches recorded "
          f"at capture): {json.dumps(launches)}")
    need = ["rmsnorm"] + (["softmax"] if moe else []) \
        + (["flash_attention", "matmul_fused"] if cfg.family != "moe" else
           ["flash_attention"])
    for k in need:
        if launches[k] <= 0:
            fail(f"the scheduler path launched no {k} kernel")
    if graph.replays < st.decode_waves or graph.graph is None:
        fail(f"scheduler: {st.decode_waves} waves, {graph.replays} replays "
             "of the captured wave")
    edges = graph_edges(graph.graph)
    b7 = graph.kernels.get(softmax_cuda, 0)
    print(f"the wave's graph: edges by dependency {json.dumps(edges)}; B7 "
          f"launches in it {b7}, each a programmatic dependent launch "
          f"({'kept' if edges.get('programmatic', 0) >= b7 else 'NOT kept: full edges'}"
          f" in the graph)")
    print(f"scheduler (captured): cold run {cold_s:.2f} s (compiles, the "
          f"capture), counted run {warm_s:.2f} s: {st.summary()}; "
          f"compile_counts={batcher.compile_counts()}")

    eager = ContinuousBatcher(model, params, n_slots=SCHED_SLOTS,
                              max_len=SCHED_MAX_LEN, capture=False)
    with recorded(eager, moe) as eager_events:
        got_eager = serve(eager)  # the model's functions are compiled
    se = eager.stats
    print(f"scheduler (eager prefills and waves): {se.summary()}")
    if got_eager != got:
        fail("scheduler: the eager steps' tokens differ from the replayed "
             "steps'")
    # the same requests with captured waves and eager prefills, as the
    # scheduler ran before its prefill graphs: a cold run, then counted
    # (a recurrent model's prefills are eager in both)
    mixed = None
    if batcher._prefills is not None:
        mixed = ContinuousBatcher(model, params, n_slots=SCHED_SLOTS,
                                  max_len=SCHED_MAX_LEN)
        mixed._prefills = None
        serve(mixed)
        mixed.stats = ServeStats()
        if serve(mixed) != got:
            fail("scheduler: eager prefills with captured waves gave other "
                 "tokens")
        print(f"scheduler (captured waves, eager prefills): "
              f"{mixed.stats.summary()}")
    sm = (mixed or eager).stats
    prefills = prefill_graphs(cfg.name, batcher, mixed or eager, events,
                              eager_events)
    del eager_events

    ref = plain_agreement("scheduler", events, plain, params, moe, model)
    if sorted(got) != list(range(n)) or any(
            len(v) != SCHED_GEN for v in got.values()):
        fail("scheduler: a request was not served in full")

    # one wave, replayed and eager, on the last wave's inputs (the slots
    # are idle: the rows it writes are refilled before they are read)
    toks, poss = events[-1][1], events[-1][2]
    out = captured_vs_eager(
        f"scheduler wave ({cfg.name}, {SCHED_SLOTS} slots)", graph,
        eager._wave, (toks, poss), 1e3 * st.p50_tok_s, 1e3 * se.p50_tok_s)
    where_the_time_goes(f"one replayed wave ({cfg.name})",
                        lambda: graph(toks, poss))
    if prefills["graphs"]:
        # one bucket's prefill, replayed and eager, on the graph's own
        # inputs (the slot is idle); the largest bucket served
        S = max(batcher._prefills)
        step = batcher._prefills[S]
        out_p = captured_vs_eager(
            f"scheduler prefill ({cfg.name}, bucket {S})", step,
            batcher._prefill_staged, tuple(step.inputs),
            prefills["ms"][S], prefills["eager_ms"][S])
        prefills["check_bucket"] = S
        prefills["check"] = out_p
    if mixed is not None:
        print(f"scheduler {cfg.name}, prefill graphs against eager prefills"
              f" (both with captured waves): TTFT p50/p99 "
              f"{1e3 * st.p50_ttft_s:.2f}/{1e3 * st.p99_ttft_s:.2f} against "
              f"{1e3 * sm.p50_ttft_s:.2f}/{1e3 * sm.p99_ttft_s:.2f} ms, "
              f"tokens/s {st.tok_per_s:.1f} against {sm.tok_per_s:.1f}")
    print(f"scheduler {cfg.name}: tokens/s {st.tok_per_s:.1f} (counted run, "
          f"prefills included; eager waves {se.tok_per_s:.1f}), TTFT p50/p99 "
          f"{1e3 * st.p50_ttft_s:.2f}/{1e3 * st.p99_ttft_s:.2f} ms (from "
          f"submit: requests queue behind the slots), ms a wave p50/p99 "
          f"{1e3 * st.p50_tok_s:.2f}/{1e3 * st.p99_tok_s:.2f} (eager "
          f"{1e3 * se.p50_tok_s:.2f}/{1e3 * se.p99_tok_s:.2f}), "
          f"{st.decode_waves} waves")
    SCHED_RESULTS[cfg.name] = dict(
        out, waves=st.decode_waves, tok_per_s=st.tok_per_s,
        p50_ttft_ms=1e3 * st.p50_ttft_s, p99_ttft_ms=1e3 * st.p99_ttft_s,
        p50_wave_ms=1e3 * st.p50_tok_s, p99_wave_ms=1e3 * st.p99_tok_s,
        eager_tok_per_s=se.tok_per_s, eager_p50_ttft_ms=1e3 * se.p50_ttft_s,
        eager_p99_ttft_ms=1e3 * se.p99_ttft_s, prefill=prefills,
        **({} if mixed is None else dict(
            eager_prefill_tok_per_s=sm.tok_per_s,
            eager_prefill_p50_ttft_ms=1e3 * sm.p50_ttft_s,
            eager_prefill_p99_ttft_ms=1e3 * sm.p99_ttft_s)))
    del batcher, eager, mixed, ref, events
    return launches


#: {model: the scheduler phase's numbers}, printed in the summary line
SCHED_RESULTS: dict = {}


def prefill_graphs(name: str, batcher, eager, events, eager_events) -> dict:
    """The scheduler's prefills, captured (one graph a bucket) against
    eager (``eager``'s counted run), from the counted runs: ms a prefill
    by bucket (medians, host clock to the token read), graphs and their
    pool's bytes; ``eager_events`` are the eager batcher's.  Fails if a
    bucketed prefill of the counted run was not a replay, or if a
    captured prefill and the eager batcher's same prefill were fed other
    tokens or gave another token."""
    import numpy as np

    st = batcher.stats
    graphs = batcher._prefills or {}
    pre = [e for e in events if e[0] == "prefill"]
    pre_e = [e for e in eager_events if e[0] == "prefill"]
    if len(pre) != len(pre_e):
        fail(f"scheduler {name}: {len(pre)} captured prefills, {len(pre_e)} "
             "eager")
    for a, b in zip(pre, pre_e):
        if a[1] != b[1] or not np.array_equal(a[2], b[2]) or a[5] != b[5]:
            fail(f"scheduler {name}: a prefill differs captured and eager "
                 f"(slot {a[1]}/{b[1]}, token {a[5]}/{b[5]})")

    def by_bucket(samples) -> dict:
        out: dict = {}
        for S, dt in samples:
            out.setdefault(S, []).append(1e3 * dt)
        return {S: statistics.median(v) for S, v in sorted(out.items())}

    ms, eager_ms = by_bucket(st.prefill_s), by_bucket(eager.stats.prefill_s)
    pool = sum(getattr(g, "pool_bytes", 0) for g in graphs.values())
    if graphs and st.prefill_replays != st.prefills:
        fail(f"scheduler {name}: {st.prefills} prefills, "
             f"{st.prefill_replays} replays of a bucket's graph")
    print(f"scheduler {name} prefill: {len(graphs)} graphs (buckets "
          f"{sorted(graphs)}), pool {pool / 2 ** 20:.1f} MiB; ms a prefill "
          f"by bucket (median, host clock to the token read), captured "
          f"{json.dumps({k: round(v, 3) for k, v in ms.items()})} against "
          f"eager {json.dumps({k: round(v, 3) for k, v in eager_ms.items()})}"
          f"; replays in the counted run {st.prefill_replays} of "
          f"{st.prefills} prefills")
    return {"graphs": len(graphs), "pool_bytes": pool, "ms": ms,
            "eager_ms": eager_ms, "replays": st.prefill_replays}


@contextlib.contextmanager
def recorded(batcher, moe: bool):
    """Record ``batcher``'s prefills and waves while the block runs:
    yields the list of events, each with the inputs it was fed and what
    it gave, for ``plain_agreement``: a prefill's greedy token and, where
    it ran eagerly (``_prefill_into``), its logits rows (a captured
    prefill gives its token alone); a wave's logits and tokens."""
    V = batcher.mdl.cfg.vocab_size
    events, last = [], {}
    prefill_into, prefill_token, wave = (batcher._prefill_into,
                                         batcher._prefill_token,
                                         batcher._wave)

    def rec_prefill_into(i, toks):
        last["logits"] = prefill_into(i, toks)
        return last["logits"]

    def rec_prefill_token(i, toks, true_len):
        last.pop("logits", None)
        tok = prefill_token(i, toks, true_len)
        lg = last.get("logits")
        if lg is not None:
            lg = (lg[0, :, :V] if moe
                  else lg[0, true_len - 1:true_len, :V]).clone()
        events.append(("prefill", i, toks, true_len, lg, tok))
        return tok

    def rec_wave(toks, poss):
        logits, nxt = wave(toks, poss)
        events.append(("wave", toks.clone(), poss.clone(), logits.clone(),
                       nxt.clone()))
        return logits, nxt

    batcher._prefill_into, batcher._prefill_token = (rec_prefill_into,
                                                     rec_prefill_token)
    batcher._wave = rec_wave
    try:
        yield events
    finally:
        batcher._prefill_into, batcher._prefill_token, batcher._wave = (
            prefill_into, prefill_token, wave)


def plain_agreement(label: str, events, plain, params, moe: bool,
                    model=None):
    """Replay ``recorded`` prefills and waves on the plain path
    (``plain``: ``"xla"``, ``dispatch="interpret"``, eager waves) fed the
    same tokens: logits within 1e-4 max(1, max|logits|) of the row (an
    MoE model row by row, at most ``MOE_ROW_ALLOWANCE`` of the rows
    beyond: routing flips), every greedy token the plain row's argmax.
    A captured prefill gives its token alone: its logits are those of
    the same prefill through ``model`` (the kernel path) run eagerly on a
    scratch cache, whose argmax must be the captured token.  Returns the
    plain path's batcher (its cache still allocated)."""
    import numpy as np
    import torch
    from repro_torch.serving import ContinuousBatcher

    V = plain.cfg.vocab_size
    ref = ContinuousBatcher(plain, params, n_slots=SCHED_SLOTS,
                            max_len=SCHED_MAX_LEN, capture=False)
    rows_got, rows_want, agree, n_rows = [], [], 0, 0
    for ev in events:
        if ev[0] == "prefill":
            _, i, toks, true_len, lg, tok = ev
            if lg is None:  # captured: the same prefill, eagerly
                tokens = torch.as_tensor(np.asarray(toks, np.int64)[None],
                                         device="cuda")
                lg, _ = model.prefill(params, tokens,
                                      model.init_cache(1, len(toks)))
                lg = (lg[0, :, :V] if moe
                      else lg[0, true_len - 1:true_len, :V])
            if int(lg[true_len - 1 if moe else 0].argmax()) != tok:
                fail(f"{label}: a prefill's token is not the argmax of its "
                     "logits run eagerly")
            w = ref._prefill_into(i, toks)[0, :, :V]
            w = w if moe else w[true_len - 1:true_len]
            rows_got.append(lg)
            rows_want.append(w)
            agree += int(w[true_len - 1 if moe else 0].argmax()) == tok
            n_rows += 1
        else:
            _, toks, poss, lg, nxt = ev
            w, wn = ref._wave(toks, poss)
            act = (poss > 0).nonzero().flatten()
            rows_got.append(lg[act])
            rows_want.append(w[act])
            agree += int((wn[act] == nxt[act]).sum())
            n_rows += len(act)
    g, w = torch.cat(rows_got), torch.cat(rows_want)
    err = (g - w).abs().amax(-1)
    tol = 1e-4 * w.abs().amax(-1).clamp_min(1.0)
    beyond = int((err > tol).sum())
    share = beyond / len(err)
    print(f"{label} agreement with fusion_mode='xla', dispatch="
          f"'interpret' fed the same prefills and waves: {len(err)} logit "
          f"rows, {beyond} beyond 1e-4 max(1, max|logits|) of the row, "
          f"worst err/tol {float((err / tol).max()):.3f}; greedy tokens "
          f"equal {agree} of {n_rows}")
    if not bool(torch.isfinite(g).all()):
        fail(f"{label}: non-finite logits")
    if moe:
        if share > MOE_ROW_ALLOWANCE or agree < 0.99 * n_rows:
            fail(f"{label}: the MoE logits disagree with the plain path")
    elif beyond or agree != n_rows:
        fail(f"{label}: the logits or tokens disagree with the plain path")
    return ref


#: The tuned phase: requests through the scheduler with ``autotune=True``.
#: Their prompts (257-500 tokens) all take the 512 bucket, so the phase
#: tunes one prompt bucket and the decode wave (every bucket would tune
#: three prefill signatures).
TUNED_REQUESTS, TUNED_GEN = 4, 8
#: The tuned phase's plan cache, emptied at its start (``build/`` is
#: git-ignored).
TUNED_DIR = ROOT / "build" / "plan_cache_tuned"


def named_functions(model) -> list:
    """(name, compiled function) of one of a model's sets."""
    fns = [("block", model.block), ("head", model.head), ("pre", model.pre),
           ("post", model.post), ("logits_head", model.logits_head),
           ("mamba", model.mamba), ("shared_pre", model.shared_pre)]
    return fns + [(f"post kv_len={k}", f)
                  for k, f in model.static_posts.items()]


def tuned_groups(label: str, comp, gen) -> list:
    """Each group of ``comp`` whose emitted schedule differs from the cost
    model's pick (a measured pin): the winner's and the model pick's
    device time on the same inputs, each kernel's time as ``time_ms``."""
    import dataclasses
    from repro_torch.core import H100, CostContext
    from repro_torch.core.codegen import emit_group
    from repro_torch.core.stitch import _sched_of

    ctx = CostContext(comp.graph, H100)
    rows = []
    for em in comp.emitted:
        if not em.generated:
            continue
        members = frozenset(n for p in em.parts for n in p)
        pin, model = _sched_of(em.estimate), _sched_of(ctx.best(members))
        if pin == model:
            continue
        alt = emit_group(comp.graph, em.parts, hw=H100, ctx=ctx)
        vals = random_inputs(em, comp.graph, gen)
        t_pin = time_ms(lambda: em.fn.launch(*vals), 20)
        t_model = (time_ms(lambda: alt.fn.launch(*vals), 20)
                   if alt.generated else None)
        print(f"tuned {label}: group of {len(members)} nodes R={em.fn.R} "
              f"C={em.fn.C}: measured pin {pin} {t_pin:.4f} ms, the model's "
              f"pick {model} "
              + (f"{t_model:.4f} ms" if t_model is not None else
                 f"({alt.kind}, not timed)"))
        rows.append(dataclasses.asdict(em.estimate) | {
            "pin": pin, "model": model, "pin_ms": t_pin,
            "model_ms": t_model})
    return rows


def head_softmax_schedules(gen) -> dict:
    """The LM head's softmax over the vocabulary, [2048, 128256]: the
    tuner's candidates under ``H100`` (no one-pass block fits the
    register cap; every streaming tile is one kernel), the streaming
    kernel's device time beside the cost model's estimate, and a one-pass
    instance of one row a program built under a preset without the cap,
    timed beside it."""
    import dataclasses
    import torch
    from repro_torch.core import H100, CostContext, stitched_jit
    from repro_torch.core import autotune
    from repro_torch.core.codegen import emit_group

    x = torch.randn(2048, 128256, generator=gen, device="cuda")
    comp = stitched_jit(lambda v: torch.softmax(v, -1)).compiled(x)
    em = only_generated(comp, "streaming")
    g = comp.graph
    members = frozenset(n for p in em.parts for n in p)
    ctx = CostContext(g, H100)
    info = ctx.info(members)
    cands = autotune._candidate_overrides(info, H100)
    t0 = time.perf_counter()
    pin = autotune.tune_group(g, em.parts, hw=H100, ctx=ctx)
    sweep_s = time.perf_counter() - t0
    t_stream = time_ms(lambda: em.fn.launch(x), 20)
    uncapped = dataclasses.replace(H100, max_block_elems=0,
                                   vmem_bytes=1 << 24)
    one = emit_group(g, em.parts, hw=uncapped, schedule_override={
        "schedule": "onepass", "block_rows": 1})
    if one.kind != "onepass":
        fail(f"head softmax: the uncapped one-pass emitted {one.kind}")
    got = one.fn.launch(x)[0]
    want = em.fn.plain(torch.device("cuda"), x)[0]
    err, worst = agreement([got], [want])
    t_one = time_ms(lambda: one.fn.launch(x), 20)
    out = {"candidates": cands, "tuned_pin": pin, "sweep_s": sweep_s,
           "streaming_ms": t_stream,
           "streaming_estimate_ms": 1e3 * em.estimate.latency_s,
           "onepass_br1_ms": t_one,
           "onepass_br1_estimate_ms": 1e3 * one.estimate.latency_s,
           "onepass_worst_err_over_limit": worst}
    print(f"head softmax [2048, 128256]: tuner candidates under H100 "
          f"{cands}, pin {pin} ({sweep_s:.2f} s); streaming {t_stream:.4f} "
          f"ms (model {1e3 * em.estimate.latency_s:.4f}); one-pass BR=1 "
          f"without the register cap {t_one:.4f} ms (model "
          f"{1e3 * one.estimate.latency_s:.4f}; worst err/limit "
          f"{worst:.3f})")
    if not worst <= 1.0:
        fail("head softmax: the uncapped one-pass kernel disagrees")
    return out


def phase_tuned(gen, checks: dict) -> dict:
    """Tune once, run many: Llama-3.2-3B at full width and depth through
    ``ContinuousBatcher`` with ``autotune=True`` into an empty plan cache
    (cold: every compiled signature planned, raced and swept on the card,
    and stored), then a fresh ``Model`` on the same cache (warm: every
    compile a hit -- no exploration, no stitching pass, no measurement),
    the same greedy tokens, each the plain path's argmax (teacher-forced
    as in ``phase_scheduler``).  Every generated and anchored kernel of the
    tuned plans is held against its plain version (``check_generated``).
    Then the tuned plans' waves and TTFT against the cost model's plans on
    the same requests, and the head softmax's schedules."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import PlanCache, explorer
    from repro_torch.models.model import Model
    from repro_torch.serving import ContinuousBatcher

    cfg = get_config("llama3.2-3b")
    shutil.rmtree(TUNED_DIR, ignore_errors=True)
    cache_dir = str(TUNED_DIR)
    gc.collect()  # the earlier phases' models hold reference cycles
    torch.cuda.empty_cache()
    model = Model(cfg)
    params = model.init(SEED)
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(257, 501)))
               for _ in range(TUNED_REQUESTS)]
    print(f"tuned: {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"through ContinuousBatcher n_slots={SCHED_SLOTS} max_len="
          f"{SCHED_MAX_LEN}, {TUNED_REQUESTS} requests of "
          f"{[len(p) for p in prompts]} tokens (bucket 512), max_new="
          f"{TUNED_GEN}, plan cache {TUNED_DIR.relative_to(ROOT)}")

    def serve(b):
        ids = [b.submit(p, max_new=TUNED_GEN) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = b.run()
        torch.cuda.synchronize()
        return [out[r] for r in ids], time.perf_counter() - t0

    def batcher(mdl, **kw):
        return ContinuousBatcher(mdl, params, n_slots=SCHED_SLOTS,
                                 max_len=SCHED_MAX_LEN, **kw)

    # -- cold: plan, race, sweep, store ------------------------------------
    cold = batcher(model, plan_cache=cache_dir, autotune=True)
    with recorded(cold, False) as events:
        cold_tokens, cold_s = serve(cold)
    st = cold.stats
    rows = []
    store = PlanCache(cache_dir)
    for name, fn in named_functions(cold.mdl):
        for comp in fn.instances:
            r = comp.report
            entry = store.load(r.signature)
            ms = r.partition_measured_s
            row = {"function": name, "signature": r.signature[:12],
                   "groups": r.n_groups, "stitched": r.n_stitched,
                   "anchored": r.n_anchored,
                   "candidates": r.partition_candidates,
                   "branches": r.partition_branches,
                   "partition_source": r.partition_source,
                   "partition_index": r.partition_index,
                   "winner_ms": (1e3 * ms[r.partition_index] if ms else None),
                   "model_pick_ms": 1e3 * ms[0] if ms else None,
                   "group_tuned": r.group_tuned,
                   "group_tuned_wins": r.group_tuned_wins,
                   "tune_s": r.tune_s, "caps": r.caps_hit,
                   "stored_source": (entry or {}).get("partition_source")}
            print(f"tuned cold {name}: {json.dumps(row)}")
            rows.append(row)
            if r.caps_hit.get("race_timeout") or r.partition_disqualified:
                fail(f"tuned {name}: a race timed out or lost a branch "
                     f"({r.caps_hit}, {r.partition_disqualified} "
                     "disqualified)")
            if r.caps_hit.get("partition_branches"):
                print(f"tuned {name}: the race was cut to the first "
                      f"branches ({r.caps_hit['partition_branches']} "
                      "left out, the partition_branches cap)")
            if entry is None:
                fail(f"tuned {name}: no plan-cache entry stored")
            if r.partition_candidates > 1 and (
                    r.partition_source != "measured"
                    or entry.get("partition_source") != "measured"):
                fail(f"tuned {name}: {r.partition_candidates} candidates "
                     "but the partition was not measured and stored")
            check_generated({f"tuned {name}": comp}, gen, checks)
            rows[-1]["groups_pinned"] = tuned_groups(name, comp, gen)
    n_sig = len(rows)
    print(f"tuned cold: {cold_s:.2f} s, {st.summary()}, {st.tune_s:.2f} s "
          f"measuring, {n_sig} compiled signatures")
    if st.plan_cache_misses != n_sig or st.plan_cache_hits:
        fail(f"tuned cold: {st.plan_cache_hits} hits, "
             f"{st.plan_cache_misses} misses of {n_sig} compiles")
    plain = Model(cfg, "xla", dispatch="interpret")
    plain_agreement("tuned cold", events, plain, params, False, cold.mdl)
    del plain, events

    # -- warm: a fresh model on the same cache -----------------------------
    explored = explorer.EXPLORE_RUNS
    warm = batcher(Model(cfg), plan_cache=cache_dir)
    reset_launch_counts()
    warm_tokens, warm_s = serve(warm)
    launches = launch_counts()
    print(f"tuned warm launches: {json.dumps(launches)}")
    for k in ("rmsnorm", "flash_attention", "matmul_fused"):
        if launches[k] <= 0:
            fail(f"the tuned warm run launched no {k} kernel")
    sw = warm.stats
    reports = warm.mdl.reports()
    stitched = sum(r.beam_width > 0 for r in reports)
    print(f"tuned warm: {warm_s:.2f} s, {sw.summary()}, {sw.tune_s} s "
          f"measuring, {explorer.EXPLORE_RUNS - explored} explorations, "
          f"{stitched} stitching passes, {len(reports)} compiles")
    if (sw.plan_cache_hits != len(reports) or sw.plan_cache_misses
            or len(reports) != n_sig or sw.tune_s != 0.0 or stitched
            or explorer.EXPLORE_RUNS != explored):
        fail("tuned warm: not every compile was a plain cache hit")
    if warm_tokens != cold_tokens:
        fail("tuned warm: the tokens differ from the cold run's")

    # -- the tuned plans against the cost model's, same requests -----------
    timed = {}
    for label, b in (("tuned", warm),
                     ("model", batcher(Model(cfg)))):
        if label == "model":
            serve(b)  # its compiles and capture
        b.stats = type(b.stats)()
        tokens, _ = serve(b)
        timed[label] = b.stats
        if tokens != cold_tokens and label == "tuned":
            fail("tuned: a second warm run gave other tokens")
    t, m = timed["tuned"], timed["model"]
    print(f"tuned against modeled plans (same requests, captured waves): "
          f"wave p50 {1e3 * t.p50_tok_s:.3f} / {1e3 * m.p50_tok_s:.3f} ms, "
          f"TTFT p50 {1e3 * t.p50_ttft_s:.2f} / {1e3 * m.p50_ttft_s:.2f} "
          f"ms, tokens/s {t.tok_per_s:.1f} / {m.tok_per_s:.1f}")
    head = head_softmax_schedules(gen)
    TUNED_RESULTS.update({
        "cold_s": cold_s, "tune_s": st.tune_s, "warm_s": warm_s,
            "signatures": n_sig, "warm_hits": sw.plan_cache_hits,
            "wave_p50_ms": {"tuned": 1e3 * t.p50_tok_s,
                            "model": 1e3 * m.p50_tok_s},
            "ttft_p50_ms": {"tuned": 1e3 * t.p50_ttft_s,
                            "model": 1e3 * m.p50_ttft_s},
            "functions": rows, "head_softmax": head})
    return launches


#: The tuned phase's numbers, printed in the ``{"tuned": ...}`` line
TUNED_RESULTS: dict = {}


#: Greedy steps of a static-decode phase, at the cache's last positions.
STATIC_STEPS = 4
#: Device memory a static-decode phase needs beyond its weights and
#: caches (activations, the plain path's logits and softmax, the
#: allocator's slack).
STATIC_SLACK_BYTES = 4e9


def phase_static_decode(gen, arch: str, batch: int, kv_len: int) -> dict:
    """``make_decode_step(mdl, kv_len)`` at full width and depth: the
    reference's decode cells, each step attending all ``kv_len`` rows of
    a cache filled in place from the seeded generator (a recurrent
    model's SSM and conv state from zeros), ``STATIC_STEPS`` greedy steps
    at the last positions.  Reports compile seconds, ms per step, the
    device's busy share and a profile of one step, launches per step
    (``flash_decode`` once an attention layer); holds every step's
    logits against the plain path (``"xla"`` with
    ``dispatch="interpret"``) fed the same tokens from the same cache
    state (the rows the steps write are saved and restored).  Returns
    the launches of the counted run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models.model import Model, shared_layers

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    hybrid = cfg.family == "hybrid"
    n_attn = len(shared_layers(cfg)) if hybrid else cfg.n_layers
    B, V, N = batch, cfg.vocab_size, STATIC_STEPS
    gc.collect()  # the earlier phases' models hold reference cycles
    torch.cuda.empty_cache()
    model = Model(cfg)
    params = model.init(SEED)
    # the weights a step reads: all but the embedding (one row a token)
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       torch.utils._pytree.tree_leaves(
                           {k: v for k, v in params.items() if k != "embed"}))
    cache_bytes = (2 * n_attn * B * cfg.n_kv_heads * kv_len
                   * cfg.resolved_head_dim * 4)
    free, total = torch.cuda.mem_get_info()
    print(f"static decode: {cfg.name} layers={cfg.n_layers} (attention "
          f"{n_attn}) batch={B} kv_len={kv_len} float32 seed={SEED}: caches "
          f"{cache_bytes / 1e9:.2f} GB, weights a step reads "
          f"{weight_bytes / 1e9:.2f} GB; "
          f"device memory free after the weights {free / 1e9:.2f} of "
          f"{total / 1e9:.2f} GB")
    if cache_bytes + STATIC_SLACK_BYTES > free:
        fail(f"static decode {cfg.name}: the caches need "
             f"{cache_bytes / 1e9:.2f} GB and {STATIC_SLACK_BYTES / 1e9:.0f} "
             f"GB of slack, {free / 1e9:.2f} GB are free")
    cache = model.init_cache(B, kv_len)
    kv = cache["attn"] if hybrid else [cache]
    for c in kv:
        c["k"].normal_(generator=gen)
        c["v"].normal_(generator=gen)
    positions = list(range(kv_len - N, kv_len))
    # the rows the steps write, and the Mamba states they replace
    saved = [{n: c[n][..., positions, :].clone() for n in ("k", "v")}
             for c in kv]
    state = model.recurrent_state(cache)
    state0 = [t.clone() for t in state]

    def restore():
        """In place: a captured step reads the cache where it was."""
        for c, r in zip(kv, saved):
            for n in ("k", "v"):
                c[n][..., positions, :] = r[n]
        for t, t0 in zip(state, state0):
            t.copy_(t0)

    tok0 = torch.randint(0, V, (B, 1), generator=gen, device="cuda")
    step = make_decode_step(model, kv_len)

    def run(step_fn, forced=None, times=None):
        """N steps from the saved state: greedy, or fed ``forced``."""
        restore()
        tok, logits, toks = tok0, [], []
        for i, pos in enumerate(positions):
            toks.append(tok)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, _ = step_fn(params, cache, tok, pos)
            torch.cuda.synchronize()
            if times is not None:
                times.append((time.perf_counter() - t0) * 1e3)
            logits.append(lg[:, 0, :V])
            tok = (lg[:, -1:, :V].argmax(-1) if forced is None
                   else forced[i + 1] if i + 1 < N else None)
        return logits, toks

    t0 = time.perf_counter()
    run(step)
    cold_s = time.perf_counter() - t0
    reset_launch_counts()  # the counted run of the static-decode path
    steps_ms = []
    got, toks = run(step, times=steps_ms)
    launches = launch_counts()
    step_ms = statistics.median(steps_ms)
    per_step = {k: v / N for k, v in launches.items()}
    print(f"launches per static decode step: {json.dumps(per_step)}")
    for comp in model.static_posts[kv_len].instances:
        describe("static post", comp)
    if per_step["matmul_fused"] != n_attn:
        fail(f"B3 launched {per_step['matmul_fused']} times a static decode "
             f"step, want {n_attn} (the MLP gate of each attention block)")
    if per_step["flash_decode"] != n_attn:
        fail(f"flash_decode launched {per_step['flash_decode']} times a "
             f"static decode step, want {n_attn} (one an attention layer)")
    print(f"compile_s={cold_s - sum(steps_ms) / 1e3:.2f} (the first {N} "
          f"steps minus the second {N}: trace, plan, emit, Triton builds, "
          f"the capture)  step_ms={step_ms:.2f} (median of {N} replays of "
          f"the captured step, host clock around a synchronized step) "
          f"tokens/s={B * 1e3 / step_ms:.1f}")
    eager_step = make_decode_step(model, kv_len, capture=False)
    eager_ms = []
    run(eager_step, times=eager_ms)
    restore()
    # the graph's own inputs as the arguments: an int position would be
    # filled in by a kernel the eager step does not run
    graph = step.graph
    graph.inputs[0].copy_(tok0)
    graph.inputs[1].fill_(positions[0])
    captured_vs_eager(
        f"static decode step ({cfg.name}, batch {B}, kv_len {kv_len})",
        graph, lambda t, p: eager_step(params, cache, t, p),
        tuple(graph.inputs), step_ms, statistics.median(eager_ms))
    restore()
    prof = where_the_time_goes("one static decode step", lambda: step(
        params, cache, tok0, positions[0]))
    busy = sum(v for k, v in prof.items() if k != "wall_ms")
    print(f"static decode step: device busy {busy:.2f} ms = "
          f"{100 * busy / step_ms:.1f}% of the unprofiled step "
          f"({step_ms:.2f} ms); flash_decode "
          f"{prof.get('cuda decode', 0.0):.3f} ms, at least "
          f"{cache_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms for the caches and "
          f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms for the weights at "
          f"3.35 TB/s")

    plain = Model(cfg, "xla", dispatch="interpret")
    want, _ = run(make_decode_step(plain, kv_len, capture=False),
                  forced=toks)
    restore()
    torch.cuda.synchronize()
    worst = 0.0
    for i in range(N):
        err = float((got[i] - want[i]).abs().max())
        tol = 1e-4 * max(1.0, float(want[i].abs().max()))
        worst = max(worst, err / tol)
        print(f"  step {i} (pos {positions[i]}): max|dlogits|={err:.3e} "
              f"(tol {tol:.2e})")
    g, w = torch.stack(got), torch.stack(want)
    agree = float((g.argmax(-1) == w.argmax(-1)).float().mean())
    print(f"static decode agreement with fusion_mode='xla', "
          f"dispatch='interpret' over {N} steps: worst max|dlogits|/tol="
          f"{worst:.3f} (tol 1e-4 max(1, max|logits|) per step), argmax "
          f"agreement={agree:.4f} (min 0.99)")
    if not bool(torch.isfinite(g).all()) or worst > 1.0 or agree < 0.99:
        fail(f"the static decode path of {cfg.name} disagrees with the "
             "plain path")
    print(f"static decode phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


#: Share of an MoE model's compared logit rows that may miss the limit: a
#: near tie between a token's 8th and 9th expert can route it differently
#: on the two paths (a routing flip), which moves that row by a gate share.
MOE_ROW_ALLOWANCE = 0.01


def moe_logit_rows(got: list, want: list, forced, B: int, Sp: int,
                   S: int) -> tuple[float, float]:
    """Hold an MoE model's teacher-forced logits row by row: max |dlogits|
    <= 1e-4 max(1, max|logits|) of the row, on all but
    ``MOE_ROW_ALLOWANCE`` of the rows (each row beyond it printed); the
    argmax at each teacher-forced step against the plain path's token.
    Returns (the worst step's argmax agreement, the share of rows beyond
    over the allowance)."""
    import torch

    labels = [f"prefill b{b} pos{t}" for b in range(B) for t in range(Sp)]
    for i in range(1, len(got)):
        labels += [f"decode step {i} b{b}" for b in range(B)]
    g, w = torch.cat(got), torch.cat(want)
    err = (g - w).abs().amax(-1)
    tol = 1e-4 * w.abs().amax(-1).clamp_min(1.0)
    beyond = (err > tol).nonzero().flatten().tolist()
    for r in beyond:
        print(f"  row beyond the limit: {labels[r]}: max|dlogits|="
              f"{float(err[r]):.3e} (tol {float(tol[r]):.2e})")
    # the teacher-forced rows: the last prompt position, then each step
    steps = [got[0].reshape(B, Sp, -1)[:, S - 1].argmax(-1)]
    steps += [x.argmax(-1) for x in got[1:]]
    per_step = [float((a == forced[:, i]).float().mean())
                for i, a in enumerate(steps)]
    rows_arg = float((g.argmax(-1) == w.argmax(-1)).float().mean())
    share = len(beyond) / len(labels)
    print(f"teacher-forced agreement with fusion_mode='xla', "
          f"dispatch='interpret': {len(labels)} logit rows ({B * Sp} prefill,"
          f" {len(labels) - B * Sp} decode), {len(beyond)} beyond 1e-4 "
          f"max(1, max|logits|) of the row (share {share:.5f}, allowance "
          f"{MOE_ROW_ALLOWANCE}); max|dlogits| over all rows "
          f"{float(err.max()):.3e}, worst err/tol {float((err / tol).max()):.3f}"
          f"; argmax agreement per teacher-forced step: min "
          f"{min(per_step):.4f} (min 0.99), over all rows {rows_arg:.4f}")
    return min(per_step), share / MOE_ROW_ALLOWANCE


def moe_layer_check(cfg, params, gen) -> None:
    """One layer's ``moe_apply`` at full width, [BATCH, PROMPT, d_model],
    fed the same input on the kernel path and on the plain path.  Count
    the routing flips (tokens whose top-k expert sets differ); hold y
    within 1e-4 max(1, max|y|) on every token whose expert set agrees --
    in a sequence with a flip, only the tokens before it, since the flip
    shifts the capacity slots of the later ones."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L

    p = params["blocks"][0]["moe"]
    x = torch.randn(BATCH, PROMPT, cfg.d_model, generator=gen,
                    device="cuda")
    xt = x.reshape(-1, cfg.d_model)
    out = {}
    for fm in (L.STITCHED, L.XLA):
        probs = ops.softmax((xt @ p["router"]).float(),
                            use_kernels=fm.use_kernels)
        idx = L.route(probs, cfg.top_k)[1].sort(-1).values
        y, aux = L.moe_apply(cfg, p, x, fm)
        out[fm.name] = (y.reshape(BATCH, PROMPT, -1), idx, float(aux))
    torch.cuda.synchronize()
    (yk, ik, ak), (yp, ip, ap) = out["stitched"], out["xla"]
    flipped = (ik != ip).any(-1).reshape(BATCH, PROMPT)
    held = torch.ones_like(flipped)
    for b in range(BATCH):
        where = flipped[b].nonzero().flatten()
        if len(where):
            held[b, int(where[0]):] = False
    err = float((yk - yp).abs().amax(-1)[held].max())
    tol = 1e-4 * max(1.0, float(yp.abs().max()))
    n_flip = int(flipped.sum())
    print(f"full-width MoE layer check ({cfg.n_experts} experts, top-"
          f"{cfg.top_k}, x [{BATCH}, {PROMPT}, {cfg.d_model}]): routing flips"
          f" {n_flip} of {BATCH * PROMPT} tokens (at most 2), tokens held "
          f"{int(held.sum())}; max|dy| on them {err:.3e} (tol {tol:.2e}); "
          f"aux {ak:.7f} vs {ap:.7f}")
    if n_flip > 2 or not err <= tol:
        fail("the MoE layer's kernel path disagrees with its plain path")


#: Limits of the train path against the plain path (float32, another
#: summation order in the kernels, 48 layers): the step-0 loss, each
#: gradient tensor (max |dg| over max |g| of the plain tensor), the
#: global gradient norm, and the loss of every step after the updates.
TRAIN_LOSS0_RTOL, TRAIN_GRAD_RTOL, TRAIN_GNORM_RTOL, TRAIN_LOSS_RTOL = \
    1e-5, 1e-3, 1e-4, 1e-3


@contextlib.contextmanager
def routing(record: list | None = None, force: list | None = None):
    """Within the block, ``layers.route`` appends each MoE layer's expert
    indices to ``record``; with ``force`` (a list of them, one a layer,
    in call order) it gates each token by the given experts in place of
    its own top-k -- teacher-forced routing, as the serving check feeds
    both paths the same tokens."""
    from repro_torch.models import layers as L

    orig, it = L.route, iter(force) if force is not None else None

    def route(probs, k):
        if it is None:
            vals, idx = orig(probs, k)
        else:
            idx = next(it)
            g = probs.gather(-1, idx)
            vals = g / g.sum(-1, keepdim=True)
        if record is not None:
            record.append(idx.detach())
        return vals, idx

    L.route = route
    try:
        yield
    finally:
        L.route = orig


def compare_grads(got, want) -> dict:
    """Per tensor max |dg| / max |g| of ``want``: the worst, its name, and
    every tensor beyond ``TRAIN_GRAD_RTOL``."""
    import torch

    worst, name, beyond = 0.0, "", []
    leaves = torch.utils._pytree.tree_flatten_with_path(got)[0]
    for (path, g), w in zip(leaves, torch.utils._pytree.tree_leaves(want)):
        ratio = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        key = torch.utils._pytree.keystr(path)
        if ratio > worst:
            worst, name = ratio, key
        if ratio > TRAIN_GRAD_RTOL:
            beyond.append((key, ratio))
    return {"worst": worst, "name": name, "beyond": beyond,
            "n": len(leaves)}


def phase_train(arch: str = "hubert-xlarge",
                batch: int = TRAIN_BATCH) -> dict:
    """``build_trainer`` at full width in the default (stitched) mode,
    then the plain path from the same weights and batches; returns the
    launches of the counted 5-step run.  For an MoE model the step-0
    comparison counts the routing flips between the paths and, where
    there are any, holds the gradients of the plain path teacher-forced
    onto the kernel path's routing."""
    import torch
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import build_trainer

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    moe = cfg.family == "moe"
    unit = "frames" if cfg.frontend == "audio" else "tokens"
    B, S, N = batch, TRAIN_FRAMES, TRAIN_STEPS
    data = SyntheticTokens(DataConfig(seed=SEED, global_batch=B, seq_len=S),
                           cfg)
    batches = [data.batch_at(i) for i in range(N)]
    b0 = {k: torch.as_tensor(v).to("cuda") for k, v in batches[0].items()}
    experts = (f" experts={cfg.n_experts} top_k={cfg.top_k} d_ff={cfg.d_ff}"
               if moe else f" d_ff={cfg.d_ff}")
    heads = (f"ssm_heads={cfg.ssm_heads}x{cfg.ssm_head_dim} state="
             f"{cfg.ssm_state} d_inner={cfg.resolved_d_inner}"
             if cfg.family == "ssm" else
             f"heads={cfg.n_heads}x{cfg.resolved_head_dim}{experts}")
    if cfg.family == "hybrid":
        heads = (f"ssm_heads={cfg.ssm_heads}x{cfg.ssm_head_dim} state="
                 f"{cfg.ssm_state} d_inner={cfg.resolved_d_inner} shared "
                 f"attention {cfg.n_heads}x{cfg.resolved_head_dim} every "
                 f"{cfg.attn_every} layers")
    print(f"train path: {cfg.name} layers={cfg.n_layers} d_model="
          f"{cfg.d_model} {heads} vocab={cfg.vocab_size} (padded "
          f"{cfg.padded_vocab}) "
          f"batch={B}x{S} {unit} float32 seed={SEED} steps={N} AdamW")

    def step0(mdl, params, kern=None) -> dict:
        routes = []
        with routing(record=routes):
            loss0, grads0 = loss_and_grads(mdl, params, b0)
        out = {"loss0": float(loss0),
               "gnorm0": float(optim.global_norm(grads0)), "routes": routes}
        if kern is None:
            out["grads0"] = grads0
            return out
        out.update(compare_grads(kern["grads0"], grads0))
        del grads0
        out["flips"] = [int((a.sort(-1).values != b.sort(-1).values)
                            .any(-1).sum())
                        for a, b in zip(kern["routes"], routes)]
        if sum(out["flips"]):
            with routing(force=kern["routes"]):
                lf, gf = loss_and_grads(mdl, params, b0)
            out["forced"] = {"loss0": float(lf),
                             "gnorm0": float(optim.global_norm(gf)),
                             **compare_grads(kern["grads0"], gf)}
            del gf
        return out

    def run(fusion: str, kern=None) -> dict:
        gc.collect()  # an earlier path's graphs and pools, if cycles hold them
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mdl, init_state, train_step = build_trainer(
            cfg, fusion_mode=fusion, lr=1e-3, total_steps=N)
        state = init_state(SEED)
        out = step0(mdl, state["params"], kern)
        out.update(losses=[], step_ms=[], per_step=[])
        reset_launch_counts()  # the counted run of the train path
        for b in batches:
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = train_step(state, b)
            torch.cuda.synchronize()
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out["losses"].append(train_step.last_metrics["loss"])
            after = launch_counts()
            out["per_step"].append({k: after[k] - before[k] for k in after})
        out["launches"] = launch_counts()
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if fusion == "stitched":
            prof = where_the_time_goes(
                "one train step", lambda: train_step(state, batches[0]))
            out["prof"] = prof
        n_params = sum(t.numel() for t in
                       torch.utils._pytree.tree_leaves(state["params"]))
        print(f"train {fusion}: params={n_params:,} losses="
              f"{[round(x, 6) for x in out['losses']]} step_ms="
              f"{[round(x, 2) for x in out['step_ms']]} peak_memory_GB="
              f"{out['peak_gb']:.2f} (torch.cuda.max_memory_allocated)")
        return out

    kern = run("stitched")
    launches = kern.pop("launches")
    step_ms = statistics.median(kern["step_ms"][1:])
    print(f"train step_ms={step_ms:.2f} (median of steps 2-{N}, host clock "
          f"around a synchronized step) {unit}/s={B * S * 1e3 / step_ms:.1f}")
    prof = kern.pop("prof")
    busy = sum(v for k, v in prof.items() if k != "wall_ms")
    shares = {k: round(100 * v / busy, 2) for k, v in prof.items()
              if k != "wall_ms"}
    # the profiler's own host cost stretches the profiled wall; the
    # unprofiled step's host clock is the fairer denominator
    print(f"train step profile: device busy {busy:.2f} ms; idle share "
          f"{100 * (1 - busy / step_ms):.2f}% of the unprofiled step "
          f"({step_ms:.2f} ms), {100 * (1 - busy / prof['wall_ms']):.2f}% "
          f"of the profiled wall ({prof['wall_ms']:.2f} ms); share of busy "
          f"by kind (%): {json.dumps(shares)}")
    print(f"launches per train step: {json.dumps(kern['per_step'][1])} "
          "(anchored groups: none -- the train step runs eagerly, no "
          "stitched function, so nothing anchors)")
    L = cfg.n_layers
    norm = "layernorm" if cfg.norm == "layernorm" else "rmsnorm"
    want = {norm: 2 * L + 1, "flash_attention": L}
    if cfg.family in ("ssm", "hybrid"):
        # the block's norm and the gated norm; the hybrid's shared block
        # two norms and one attention an application
        from repro_torch.kernels.ssd_scan import LAUNCHES_PER_CALL
        from repro_torch.models.model import shared_layers

        apps = len(shared_layers(cfg))
        want = {norm: 2 * L + 2 * apps + 1, "flash_attention": apps,
                "ssd_scan": L * LAUNCHES_PER_CALL}
    if norm == "layernorm":
        from repro_torch.kernels.layernorm import BWD_LAUNCHES_PER_CALL

        want["layernorm_bwd"] = (2 * L + 1) * BWD_LAUNCHES_PER_CALL
    if moe:
        want.update(softmax=L, softmax_bwd=L)
    for i, per in enumerate(kern["per_step"]):
        for k, n in want.items():
            if per[k] != n:
                fail(f"train step {i} launched {k} {per[k]} times, want {n}")

    plain = run("xla", kern)
    if any(plain["launches"].values()):
        fail(f"the plain train path launched kernels: {plain['launches']}")
    if moe:
        print(f"routing flips at step 0 between the paths, by layer: "
              f"{plain['flips']} ({sum(plain['flips'])} of "
              f"{B * S * L} routings); free-running step-0 gradients: worst "
              f"max|dg|/max|g| {plain['worst']:.2e} at {plain['name']}; "
              f"beyond {TRAIN_GRAD_RTOL:g}: {plain['beyond']}")
    # with flips, the step-0 comparison is teacher-forced onto the kernel
    # path's routing (``routing``); without, the two are the same run
    ref = plain.get("forced", plain)
    if "forced" in plain:
        print("step-0 loss, gradients and norm below: the plain path "
              "teacher-forced onto the kernel path's routing")
    l0 = abs(kern["loss0"] - ref["loss0"]) / abs(ref["loss0"])
    gn = abs(kern["gnorm0"] - ref["gnorm0"]) / ref["gnorm0"]
    dl = [abs(a - b) / abs(b) for a, b in zip(kern["losses"],
                                              plain["losses"])]
    print(f"train agreement with fusion_mode='xla': step-0 loss "
          f"{kern['loss0']:.7f} vs {ref['loss0']:.7f} (rel "
          f"{l0:.2e}, limit {TRAIN_LOSS0_RTOL:g}); step-0 gradients: worst "
          f"max|dg|/max|g| {ref['worst']:.2e} at {ref['name']} (limit "
          f"{TRAIN_GRAD_RTOL:g}, {ref['n']} tensors); global norm "
          f"{kern['gnorm0']:.6f} vs {ref['gnorm0']:.6f} (rel {gn:.2e}, "
          f"limit {TRAIN_GNORM_RTOL:g}); losses of the {N} steps: worst rel "
          f"{max(dl):.2e} (limit {TRAIN_LOSS_RTOL:g}); plain step_ms="
          f"{statistics.median(plain['step_ms'][1:]):.2f}")
    for name, ratio in ref["beyond"]:
        print(f"  gradient beyond its limit: {name}: {ratio:.2e}")
    if not all(map(math.isfinite, kern["losses"] + plain["losses"])):
        fail("train path: a loss is not finite")
    if (l0 > TRAIN_LOSS0_RTOL or ref["worst"] > TRAIN_GRAD_RTOL
            or gn > TRAIN_GNORM_RTOL or max(dl) > TRAIN_LOSS_RTOL):
        fail("the stitched train path disagrees with the plain path")
    print(f"train phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# bfloat16: the kernels' bfloat16 instances, and Llama-3.2-3B with
# bfloat16 weights serving and training (remat), Zamba2-1.2B training
# ---------------------------------------------------------------------------
#: The reference's bfloat16 bands, (rtol, atol) of each element against
#: the plain version (``src/repro/runtime/guard.py:208-213`` for B6 and
#: B8, the anchored band of :224-226 for B3 and B4), and the factor by
#: which a kernel may be further than the plain version from the same
#: function in float64 of the same bfloat16 inputs.
BF16_BAND, BF16_BAND_ANCHORED, BF16_F64_FACTOR = (2e-2, 2e-2), \
    (4e-2, 1.2e-1), 2.0
#: H100 SXM dense bfloat16 tensor-core peak (data sheet, 700 W)
BF16_OPS_PER_S = 989e12
#: The paths' agreement rule with a float32 plain run of the same weights
#: (the bfloat16 values widened): the kernel path's largest distance at
#: most this factor times the bfloat16 plain path's, plus
#: ``BF16_PATH_FLOOR`` max(1, max|float32 value|).
BF16_PATH_FACTOR, BF16_PATH_FLOOR = 1.5, 1e-3
BF16_RESULTS: dict = {}


def bf16_bound_ms(nbytes: float, ops: float, mma_ops: float,
                  mma_rate: float = None) -> tuple[float, str]:
    """(bound ms, "bytes"|"operations") at bfloat16: the bytes over the HBM
    rate against element-wise ``ops`` at float32's rate plus the products'
    ``mma_ops`` at ``mma_rate`` (the tensor cores' bfloat16 rate unless
    given)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / FP32_OPS_PER_S
             + mma_ops / (mma_rate or BF16_OPS_PER_S)) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_bf16_kernel(label: str, launch, plain, exact, inputs, *,
                      nbytes: float, ops: float = 0, mma_ops: float = 0,
                      band=BF16_BAND, reps: int = 20, library=None,
                      mma_rate: float = None) -> dict:
    """Hold a kernel's bfloat16 instance to its plain version on the same
    bfloat16 inputs: (a) every element within ``band`` of the plain
    version; (b) its largest distance from ``exact`` (the function in
    float64 of those inputs) at most ``BF16_F64_FACTOR`` times the plain
    version's.  Times as ``check_cuda_kernel``'s; the bound at bfloat16's
    rate (``bf16_bound_ms``)."""
    import torch

    def outs(r):
        return list(r) if isinstance(r, (tuple, list)) else [r]

    got, want = outs(launch(*inputs)), outs(plain(*inputs))
    ex = outs(exact(*inputs))
    torch.cuda.synchronize()
    rtol, atol = band
    worst = err = kerr = perr = 0.0
    for g, w, e in zip(got, want, ex):
        if g.dtype != w.dtype:
            fail(f"{label}: kernel output {g.dtype}, plain {w.dtype}")
        g, w, e = g.double(), w.double(), e.double().reshape(g.shape)
        d = (g - w).abs()
        err = max(err, float(d.max()))
        worst = max(worst, float((d / (atol + rtol * w.abs())).max()))
        kerr = max(kerr, float((g - e).abs().max()))
        perr = max(perr, float((w - e).abs().max()))
    ms = time_ms(lambda: launch(*inputs), reps)
    call_ms = time_ms(lambda: launch(*inputs), reps, queued=False)
    plain_ms = time_ms(lambda: plain(*inputs), max(3, reps // 4))
    lib_ms = time_ms(lambda: library(*inputs), reps) if library else None
    bound, bound_by = bf16_bound_ms(nbytes, ops, mma_ops, mma_rate)
    print(f"cuda kernel bf16 {label}: max_abs_err={err:.3e} against the "
          f"plain version (worst err/band {worst:.3f}, band rtol {rtol:g} "
          f"atol {atol:g}); against float64: kernel {kerr:.3e}, plain "
          f"{perr:.3e} (ratio {kerr / max(perr, 1e-30):.3f}, limit "
          f"{BF16_F64_FACTOR:g}) ms={ms:.4f} (call with the host's cost: "
          f"{call_ms:.4f}) plain_ms={plain_ms:.4f} library_ms="
          f"{'n/a' if lib_ms is None else f'{lib_ms:.4f}'} "
          f"bound_ms={bound:.4f} ({bound_by}: {nbytes:.0f} B, {ops:.0f} "
          f"element-wise ops, {mma_ops:.0f} product ops at "
          f"{(mma_rate or BF16_OPS_PER_S) / 1e12:g} TFLOP/s)")
    if not all(torch.isfinite(g).all() for g in got):
        fail(f"bf16 {label}: kernel output not finite")
    if worst > 1.0:
        fail(f"bf16 {label}: kernel outside the bfloat16 band of its plain "
             f"version (worst err/band {worst:.3f})")
    if kerr > BF16_F64_FACTOR * perr:
        fail(f"bf16 {label}: kernel {kerr:.3e} from float64, more than "
             f"{BF16_F64_FACTOR:g} x the plain version's {perr:.3e}")
    return {"max_abs_err": err, "worst": worst, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib_ms, "f64_err": kerr, "plain_f64_err": perr}


def check_bf16_anchored(fn, args, gen, *, label: str, library) -> dict:
    """``check_bf16_kernel`` for the anchored group of
    ``stitched_jit(fn)`` at ``args``: its function op by op in float64
    (``float64_outputs``) as the exact one, its bytes and operations
    from the graph (``anchored_work``), the anchored band."""
    comp, ems = anchored_of(fn, args)
    em = ems[0]
    vals = ext_values(comp, em, args, gen)
    nbytes, ops, mma = anchored_work(em, comp.graph)
    res = check_bf16_kernel(
        label, em.fn.launch, em.fn.plain,
        lambda *v: float64_outputs(em, comp.graph, list(v)), vals,
        nbytes=nbytes, ops=ops, mma_ops=mma, band=BF16_BAND_ANCHORED,
        library=library)
    return dict(res, _bytes=nbytes,
                _score=getattr(em.fn, "score_mod", None) is not None,
                _tile=getattr(em.fn, "tile", None))


def phase_bf16_kernels(gen) -> dict:
    """The bfloat16 instances of B6, B4 (with and without a score
    functor), B8 and B3 at Llama-3.2-3B's shapes, each held to its plain
    version (``check_bf16_kernel``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import matmul as MM
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as RN

    bf = torch.bfloat16
    checks: dict[str, list] = {}

    def rnd(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dtype)

    for R, C in ((BATCH * PROMPT, 3072), (BATCH, 3072)):
        x, g = rnd(R, C), rnd(C, scale=0.1) + 1.0
        nbytes = 2 * (2 * R * C + C) + 4 * R
        res = check_bf16_kernel(
            f"rmsnorm [{R}, {C}]", lambda a, b: RN.rmsnorm_cuda(a, b, 1e-6),
            lambda a, b: RN.rmsnorm_plain(a, b, 1e-6),
            lambda a, b: a.double() * torch.rsqrt(
                (a.double() ** 2).mean(-1, keepdim=True) + 1e-6)
            * b.double(), (x, g), nbytes=nbytes, ops=4 * R * C, reps=50,
            library=lambda a, b, _C=C: F.rms_norm(a, (_C,), b, 1e-6))
        checks.setdefault("rmsnorm_bf16", []).append(
            dict(res, _bytes=nbytes, _main=R > BATCH))

    llama = (BATCH, 24, 8, 128)
    for label, (B, Hq, Hkv, D) in (("llama prefill causal", llama),
                                    ("granite heads D64", (BATCH, 16, 8, 64)),
                                    ("gemma-7b heads D256",
                                     (BATCH, 16, 16, 256))):
        S = PROMPT
        q, k, v = rnd(B, Hq, S, D), rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
        pairs = S * (S + 1) // 2
        nbytes = 2 * (2 * q.numel() + 2 * k.numel())
        res = check_bf16_kernel(
            f"flash_attention {label} B{B} Hq{Hq} Hkv{Hkv} S{S} D{D}",
            lambda a, b, c: FA.flash_attention_cuda(a, b, c, True),
            lambda a, b, c: FA.flash_attention_plain(a, b, c, True),
            lambda a, b, c: ref.attention(a.double(), b.double(),
                                          c.double(), causal=True),
            (q, k, v), nbytes=nbytes, mma_ops=4 * D * B * Hq * pairs,
            band=BF16_BAND_ANCHORED,
            library=lambda a, b, c: F.scaled_dot_product_attention(
                a, b, c, is_causal=True, enable_gqa=True))
        checks.setdefault("flash_attention_bf16", []).append(
            dict(res, _bytes=nbytes, _main=label.startswith("llama")))

    # Llama's heads with a bias folded as a generated score functor
    # (bench_anchor_fusion's attention block, as the float32 row)
    B, H, S, D = BATCH, 24, PROMPT, 128
    args = (rnd(B, H, S, D), rnd(B, H, S, D), rnd(B, H, S, D),
            rnd(1, 1, S, S))
    res = check_bf16_anchored(
        bench_attn, args, gen,
        label=f"flash_attention score_mod (scale 0.125 + bias [1, 1, {S}, "
              f"{S}]) B{B} H{H} S{S} D{D}",
        library=lambda *v, _a=args: F.scaled_dot_product_attention(
            _a[0], _a[1], _a[2], attn_mask=_a[3], scale=0.125))
    if not res["_score"]:
        fail("bench attention block in bfloat16: no score chain folded")
    checks.setdefault("flash_score_mod_bf16", []).append(dict(res, _main=True))

    # B8 at decode_32k with a bfloat16 q, against float32 and bfloat16
    # caches
    B, Hq, Hkv, D = llama
    for cache in (torch.float32, bf):
        q = rnd(B, Hq, D)
        k, v = rnd(B, Hkv, STATIC_KV, D, dtype=cache), \
            rnd(B, Hkv, STATIC_KV, D, dtype=cache)
        q32 = q.float()
        isz = 4 if cache == torch.float32 else 2
        nbytes = isz * 2 * k.numel() + 2 * 2 * q.numel()
        res = check_bf16_kernel(
            f"flash_decode decode_32k B{B} Hq{Hq} Hkv{Hkv} S{STATIC_KV} D{D} "
            f"q bfloat16, caches {str(cache).removeprefix('torch.')}",
            lambda a, b, c: FA.flash_decode_cuda(a, b, c),
            lambda a, b, c: FA.flash_decode_plain(a, b, c),
            lambda a, b, c: ref.decode_attention(a.double(), b.double(),
                                                 c.double()),
            (q, k, v), nbytes=nbytes, mma_ops=4 * D * B * Hq * STATIC_KV,
            reps=10,
            library=lambda a, b, c, _q=(q if cache == bf else q32):
                F.scaled_dot_product_attention(_q[:, :, None], b, c,
                                               enable_gqa=True)[:, :, 0])
        checks.setdefault("flash_decode_bf16", []).append(
            dict(res, _bytes=nbytes, _main=cache == torch.float32))
        del k, v
        torch.cuda.empty_cache()

    # B3: Llama's gate projection with its SiLU x up epilogue (as the
    # float32 rows), at the prefill's M and the decode tile's
    K, N = ANCHOR_K, ANCHOR_N
    for M in (BATCH * PROMPT, BATCH):
        args = (rnd(M, K), rnd(K, N, scale=K ** -0.5),
                rnd(K, N, scale=K ** -0.5))
        res = check_bf16_anchored(
            t_gate, args, gen,
            label=f"matmul_fused llama gate+SiLU x up M{M} K{K} N{N}",
            library=lambda *v, _a=args: torch.matmul(_a[0], _a[1]))
        print(f"  (tile {res['_tile']}: {MM.TILES[res['_tile']]})")
        checks.setdefault("matmul_fused_bf16", []).append(
            dict(res, _main=M > BATCH))
    torch.cuda.empty_cache()
    bf16_memory_kernels(gen, checks)
    return checks


def ln_exact(x, g, b, eps: float):
    """LayerNorm's forward in float64."""
    xd = x.double()
    xc = xd - xd.mean(-1, keepdim=True)
    return xc * (xc * xc).mean(-1, keepdim=True).add(eps).rsqrt() \
        * g.double() + b.double()


def ln_bwd_exact(x, g, mean, rstd, dy):
    """``_ln_bwd``'s dx in float64, at the given statistics."""
    xd, dyd = x.double(), dy.double()
    xhat = (xd - mean.double()) * rstd.double()
    gdy = dyd * g.double()
    return rstd.double() * (gdy - gdy.mean(-1, keepdim=True)
                            - xhat * (gdy * xhat).mean(-1, keepdim=True))


def ssd_exact(x, dt, A, B, C):
    """The scan's y in float64 as its recurrence, h_t = exp(dt_t A)
    h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t (one step a row: the
    chunked form's function, summed in another order)."""
    import torch

    b, L, H, P = x.shape
    xd, dtd, Bd, Cd = (t.double() for t in (x, dt, B, C))
    h = torch.zeros(b, H, P, B.shape[-1], dtype=torch.float64,
                    device=x.device)
    y = torch.empty(b, L, H, P, dtype=torch.float64, device=x.device)
    for t in range(L):
        h.mul_(torch.exp(dtd[:, t] * A.double())[..., None, None]).add_(
            (dtd[:, t, :, None] * xd[:, t])[..., None]
            * Bd[:, t, None, None, :])
        y[:, t] = (h * Cd[:, t, None, None, :]).sum(-1)
    return y


def bf16_memory_kernels(gen, checks: dict) -> None:
    """The bfloat16 instances of B11, B5/B9 and B7/B10, each held to its
    plain version (``check_bf16_kernel``, on y or dx; the scan's state,
    the statistics and dgamma, dbeta are float32 and held to the plain
    version's as in float32): B11 at Mamba2's prefill and train shapes and
    Zamba2's prefill, x, B and C column slices of one bfloat16 activation;
    B5 and B9 at HuBERT-XLarge's train rows [4096, 1280] and at [8192,
    3072]; B7 and B10 at the router's [2048, 32] and at [256, 4096]."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import layernorm as LN
    from repro_torch.kernels import softmax as SM
    from repro_torch.kernels import ssd_scan as SS

    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(bf)

    # B11: products at the TF32 rate (the kernel's one to three TF32
    # products a pair, the function's count)
    for label, (b, L, H, P, N) in (
            ("mamba2 prefill", (BATCH, PROMPT, 32, 64, 128)),
            ("mamba2 train", (TRAIN_BATCH, TRAIN_FRAMES, 32, 64, 128)),
            ("zamba2 prefill", (BATCH, PROMPT, 64, 64, 64))):
        x, dt, A, Bm, Cm = ssd_inputs(gen, b, L, H, P, N)
        # one bfloat16 activation, sliced as the model slices it
        di = H * P
        xbc = torch.cat([x.reshape(b, L, di), Bm, Cm], -1).to(bf)
        x, Bm, Cm = (xbc[..., :di].reshape(b, L, H, P),
                     xbc[..., di:di + N], xbc[..., di + N:])
        c = SS.kernel_chunk(SSD_CHUNK)
        _, elem, mma = ssd_work(b, L, H, P, N, c)
        nbytes = 2 * (2 * b * L * H * P + 2 * b * L * N) \
            + 4 * (b * L * H + H + b * H * P * N)
        _, state = SS.ssd_scan_cuda(x, dt, A, Bm, Cm, SSD_CHUNK)
        _, want_state = SS.ssd_scan_plain(x, dt, A, Bm, Cm, SSD_CHUNK)
        serr = float((state - want_state).abs().max())
        slim = SSD_RTOL * max(1.0, float(want_state.abs().max()))
        print(f"  ssd_scan bf16 {label}: final state (float32) "
              f"max_abs_err={serr:.3e} against the plain version (limit "
              f"{slim:.3e})")
        if not serr <= slim:
            fail(f"bf16 ssd_scan {label}: the state is {serr:.3e} from the "
                 f"plain version's, past {slim:.3e}")
        before = launch_counts()
        res = check_bf16_kernel(
            f"ssd_scan {label} b{b} L{L} H{H} P{P} N{N} chunk{SSD_CHUNK} "
            "(x, B, C bfloat16 strided slices)",
            lambda *a: SS.ssd_scan_cuda(*a, SSD_CHUNK)[0],
            lambda *a: SS.ssd_scan_plain(*a, SSD_CHUNK)[0],
            ssd_exact, (x, dt, A, Bm, Cm), nbytes=nbytes, ops=elem,
            mma_ops=mma, mma_rate=SPLIT_OPS_PER_S * 3, reps=20)
        launched("ssd_scan_bf16", before)
        checks.setdefault("ssd_scan_bf16", []).append(
            dict(res, _bytes=nbytes, _main=label == "mamba2 prefill"))
        del x, xbc, Bm, Cm, dt

    eps = 1e-5
    for R, C in ((TRAIN_BATCH * TRAIN_FRAMES, 1280), (8192, 3072)):
        x, dy = rnd(R, C), rnd(R, C)
        g, b = rnd(C, scale=0.1) + 1.0, rnd(C, scale=0.1)
        nbytes = 2 * (2 * R * C + 2 * C) + 8 * R
        res = check_bf16_kernel(
            f"layernorm [{R}, {C}]",
            lambda *a: LN.layernorm_cuda(*a, eps)[0],
            lambda *a: LN.layernorm_plain(*a, eps)[0],
            lambda *a: ln_exact(*a, eps), (x, g, b), nbytes=nbytes,
            ops=8 * R * C, reps=50,
            library=lambda *a, _C=C: F.layer_norm(a[0], (_C,), a[1], a[2],
                                                  eps))
        checks.setdefault("layernorm_bf16", []).append(
            dict(res, _bytes=nbytes, _main=C == 1280))
        _, mean, rstd = LN.layernorm_plain(x, g, b, eps)
        _, dg, db = LN.layernorm_bwd_cuda(x, g, mean, rstd, dy)
        _, pdg, pdb = LN.layernorm_bwd_plain(x, g, mean, rstd, dy)
        for name, got, want in (("dgamma", dg, pdg), ("dbeta", db, pdb)):
            err = float((got - want).abs().max())
            lim = 1e-5 * float(want.abs().max()) + 1e-5
            if not err <= lim:
                fail(f"bf16 layernorm_bwd [{R}, {C}]: {name} (float32) "
                     f"{err:.3e} from the plain version's, past {lim:.3e}")
        nbytes = 2 * (3 * R * C + C) + 8 * R + 8 * C
        before = launch_counts()
        res = check_bf16_kernel(
            f"layernorm_bwd [{R}, {C}] (both launches; dgamma, dbeta within "
            "1e-5 max|plain| + 1e-5 of the plain version's)",
            lambda *a: LN.layernorm_bwd_cuda(*a)[0],
            lambda *a: LN.layernorm_bwd_plain(*a)[0], ln_bwd_exact,
            (x, g, mean, rstd, dy), nbytes=nbytes, ops=10 * R * C, reps=50,
            library=lambda *a, _C=C, _b=b: torch.ops.aten.
            native_layer_norm_backward(a[4], a[0], [_C], a[2], a[3], a[1],
                                       _b, [True, True, True]))
        launched("layernorm_bwd_bf16", before)
        checks.setdefault("layernorm_bwd_bf16", []).append(
            dict(res, _bytes=nbytes, _main=C == 1280))
        del x, dy

    for R, C in ((2048, 32), (256, 4096)):
        x, dy = rnd(R, C, scale=3.0), rnd(R, C)
        nbytes = 2 * 2 * R * C
        res = check_bf16_kernel(
            f"softmax [{R}, {C}] ({SM.layout(x)})", SM.softmax_cuda,
            SM.softmax_plain, lambda a: torch.softmax(a.double(), -1), (x,),
            nbytes=nbytes, ops=4 * R * C, reps=200,
            library=lambda a: torch.softmax(a, -1))
        checks.setdefault("softmax_bf16", []).append(
            dict(res, _bytes=nbytes, _main=C == 32))
        y = SM.softmax_plain(x)
        nbytes = 2 * 3 * R * C
        res = check_bf16_kernel(
            f"softmax_bwd [{R}, {C}] ({SM.layout(y, dy)})",
            SM.softmax_bwd_cuda, SM.softmax_bwd_plain,
            lambda a, d: a.double() * (d.double() - (
                d.double() * a.double()).sum(-1, keepdim=True)), (y, dy),
            nbytes=nbytes, ops=3 * R * C, reps=200,
            library=lambda a, d: torch._softmax_backward_data(d, a, -1, bf))
        checks.setdefault("softmax_bwd_bf16", []).append(
            dict(res, _bytes=nbytes, _main=C == 32))
    torch.cuda.empty_cache()


def nonzero(counts: dict) -> str:
    """The launch counts that moved, as JSON."""
    return json.dumps({k: n for k, n in counts.items() if n})


def tree_float(tree):
    """A param tree's floating leaves in float32 (new tensors)."""
    import torch

    return torch.utils._pytree.tree_map(lambda t: t.float(), tree)


def path_rule(label: str, got, plain, exact) -> dict:
    """The bfloat16 paths' agreement (``BF16_PATH_FACTOR``): the kernel
    path's max distance from the float32 run against the bfloat16 plain
    path's; fails past it."""
    err = float((got.double() - exact.double()).abs().max())
    perr = float((plain.double() - exact.double()).abs().max())
    limit = BF16_PATH_FACTOR * perr + BF16_PATH_FLOOR * max(
        1.0, float(exact.abs().max()))
    if not (err <= limit and math.isfinite(err)):
        fail(f"{label}: the bfloat16 kernel path is {err:.4e} from the "
             f"float32 plain run, past {limit:.4e} (the bfloat16 plain "
             f"path: {perr:.4e})")
    return {"err": err, "plain_err": perr, "limit": limit}


def rows_beyond(got, plain, exact) -> tuple[int, int]:
    """How many logit rows [rows, V] miss ``path_rule`` taken row by row,
    and how many would with the two bfloat16 paths swapped (printed for an
    MoE model, whose rule is the path's: a routing flip moves a row by a
    gate share and, through attention, the rows after it, on either
    path)."""
    e = exact.double()
    floor = BF16_PATH_FLOOR * e.abs().amax(-1).clamp_min(1.0)
    dg = (got.double() - e).abs().amax(-1)
    dp = (plain.double() - e).abs().amax(-1)
    return (int((dg > BF16_PATH_FACTOR * dp + floor).sum()),
            int((dp > BF16_PATH_FACTOR * dg + floor).sum()))


#: Short names of the models in ``BF16_RESULTS`` and the path labels.
SHORT = {"llama3.2-3b": "llama", "mamba2-370m": "mamba2",
         "zamba2-1.2b": "zamba2", "granite-moe-1b-a400m": "granite",
         "hubert-xlarge": "hubert"}
#: The bfloat16 instances each family's serving path must launch (the
#: router's softmax stays float32 behind its cast: B7 in float32)
BF16_SERVE_KERNELS = {
    "dense": ("rmsnorm_bf16", "flash_attention_bf16", "matmul_fused_bf16"),
    "ssm": ("rmsnorm_bf16", "ssd_scan_bf16"),
    "hybrid": ("rmsnorm_bf16", "ssd_scan_bf16", "flash_attention_bf16"),
    "moe": ("rmsnorm_bf16", "flash_attention_bf16", "softmax")}


def phase_bf16_serve(gen, arch: str, forward: bool) -> tuple[dict, dict]:
    """A model with ``param_dtype=torch.bfloat16`` at full width and
    depth: the forward at batch 4 x 512 (where ``forward``) and
    ``generate`` (batch 4, 500 prompt tokens -- bucketed to 512, or exact
    for a recurrent model -- 16 greedy tokens, the float32 cache of 1,024
    rows, each decode step one replayed CUDA graph), each held to a
    float32 plain run of the same weights by ``path_rule``; returns the
    launches of the counted forward (empty without one) and generate."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, greedy_step
    from repro_torch.models import Model
    from repro_torch.models.model import RECURRENT
    from repro_torch.serving.buckets import Buckets, pad_tokens

    t_phase = time.perf_counter()
    bf = torch.bfloat16
    cfg = get_config(arch)
    name = SHORT[arch]
    need = BF16_SERVE_KERNELS[cfg.family]
    moe = cfg.family == "moe"
    V = cfg.vocab_size
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(cfg, param_dtype=bf)
    params = model.init(SEED)
    plain = Model(cfg, "xla", dispatch="interpret", param_dtype=bf)
    plain32 = Model(cfg, "xla", dispatch="interpret")
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, V, (BATCH, PROMPT))).to("cuda")
    print(f"bf16 paths: {cfg.name} layers={cfg.n_layers} d_model="
          f"{cfg.d_model} param_dtype=bfloat16 seed={SEED}; "
          + (f"forward batch={BATCH}x{PROMPT}; " if forward else "")
          + f"generate batch={BATCH} prompt={SERVE_PROMPT} gen={SERVE_GEN} "
          f"float32 cache")
    out: dict = {}

    fwd: dict = {}
    if forward:
        with torch.no_grad():
            model.forward(params, toks)  # compile
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            logits = model.forward(params, toks)[0]
            torch.cuda.synchronize()
            fwd = launch_counts()
            out["forward_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.forward(params, toks)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            out["forward_ms"] = statistics.median(walls)
            prof = where_the_time_goes(f"one bf16 {name} forward",
                                       lambda: model.forward(params, toks))
            busy = sum(v for k, v in prof.items() if k != "wall_ms")
            out["forward_busy"] = busy / out["forward_ms"]
            lp = plain.forward(params, toks)[0]
            p32 = tree_float(params)
            l32 = plain32.forward(p32, toks)[0]
            rows = [t[..., :V].reshape(-1, V) for t in (logits, lp, l32)]
            out["forward_rule"] = path_rule(f"bf16 {name} forward", *rows)
            out["forward_rows_beyond"] = rows_beyond(*rows)
            del lp, l32, logits, p32, rows
        print(f"bf16 {name} forward: {out['forward_ms']:.2f} ms (median of "
              f"3, host clock around a synchronized call) peak_memory_GB="
              f"{out['forward_peak_gb']:.2f}; device busy {busy:.2f} ms = "
              f"{100 * out['forward_busy']:.1f}% of the call; launches "
              f"{nonzero(fwd)}; against float32: kernel path "
              f"{out['forward_rule']['err']:.4e}, bf16 plain "
              f"{out['forward_rule']['plain_err']:.4e} (limit "
              f"{out['forward_rule']['limit']:.4e}; row by row, "
              f"{out['forward_rows_beyond'][0]} of {BATCH * PROMPT} rows "
              f"beyond it, {out['forward_rows_beyond'][1]} with the paths "
              "swapped)")
        for k in need:
            if fwd[k] <= 0:
                fail(f"the bf16 {name} forward launched no {k}")

    # generate: the counted run, then TTFT, the captured decode step, the
    # busy share, and the teacher-forced logits of every step
    B, S, G = BATCH, SERVE_PROMPT, SERVE_GEN
    prompts = rng.integers(0, V, (B, S))
    generate(model, params, prompts, G)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    seqs = generate(model, params, prompts, G)
    out["generate_s"] = time.perf_counter() - t0
    gen_launches = launch_counts()
    out["generate_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for k in need:
        if gen_launches[k] <= 0:
            fail(f"the bf16 {name} generate launched no {k}")
    bk = Buckets()
    Sp = S if cfg.family in RECURRENT else bk.bucket(S)
    max_len = bk.bucket(max(Sp, S + G))
    ptoks = torch.from_numpy(pad_tokens(prompts, Sp)).to("cuda")
    positions = torch.arange(S, S + G, device="cuda")
    cache = model.init_cache(B, max_len)

    def first_token():
        lg, _ = model.prefill(params, ptoks, cache)
        return lg[:, S - 1:S, :V].argmax(-1)

    ttft = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok = first_token().cpu()
        ttft.append((time.perf_counter() - t0) * 1e3)
    tok = tok.to("cuda")
    graph = greedy_step(model, params, cache)
    ctok = graph(tok, positions[0])
    steps = []
    for i in range(G - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctok = graph(ctok, positions[i])
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    del graph, ctok
    out["ttft_ms"] = statistics.median(ttft)
    out["decode_ms"] = statistics.median(steps)
    pre = where_the_time_goes(f"one bf16 {name} prefill", first_token)
    out["prefill_busy_by_kind"] = {
        k: round(v, 4) for k, v in pre.items() if k != "wall_ms"}
    dec = where_the_time_goes(f"one bf16 {name} decode step", lambda:
                              model.decode_step(params, cache, tok,
                                                positions[1],
                                                kv_len=positions[1] + 1))
    busy = sum(v for k, v in dec.items() if k != "wall_ms")
    out["decode_busy"] = busy / out["decode_ms"]

    forced = torch.from_numpy(seqs[:, S:]).to("cuda")

    def forced_logits(mdl, p):
        """Step 0: the prefill's rows (all B x Sp for an MoE model, else
        the last prompt position's); then each decode step's B rows."""
        c = mdl.init_cache(B, max_len)
        lg, _ = mdl.prefill(p, ptoks, c)
        rows = [lg[:, :, :V].reshape(-1, V).float() if moe
                else lg[:, S - 1, :V].float()]
        for i in range(G - 1):
            lg, _ = mdl.decode_step(p, c, forced[:, i:i + 1], positions[i],
                                    kv_len=positions[i] + 1)
            rows.append(lg[:, 0, :V].float())
        return rows

    with torch.no_grad():
        got = forced_logits(model, params)
        want = forced_logits(plain, params)
        p32 = tree_float(params)
        exact = forced_logits(plain32, p32)
        del p32
    if moe:  # the path's rule over every row of every step at once
        rows = [torch.cat(t) for t in (got, want, exact)]
        r = path_rule(f"bf16 {name} generate", *rows)
        worst = r["err"] / r["limit"]
        out["generate_rows_beyond"] = rows_beyond(*rows)
        print(f"  bf16 {name} generate, {len(rows[0])} logit rows (the "
              f"prefill's {B * Sp}, then {B} a step): kernel {r['err']:.4e}, "
              f"plain {r['plain_err']:.4e} from float32 (limit "
              f"{r['limit']:.4e}); row by row, "
              f"{out['generate_rows_beyond'][0]} rows beyond it, "
              f"{out['generate_rows_beyond'][1]} with the paths swapped")
        del rows
    else:
        worst = 0.0
        for i in range(G):
            r = path_rule(f"bf16 {name} generate step {i}", got[i], want[i],
                          exact[i])
            worst = max(worst, r["err"] / r["limit"])
            if i in (0, G - 1):
                print(f"  bf16 {name} generate step {i}: kernel "
                      f"{r['err']:.4e}, plain {r['plain_err']:.4e} from "
                      f"float32 (limit {r['limit']:.4e})")
    out["generate_worst"] = worst
    print(f"bf16 {name} generate: TTFT={out['ttft_ms']:.2f} ms (median of 3) "
          f"decode={out['decode_ms']:.2f} ms per token (captured, median of "
          f"{G - 1} replays) decode busy {100 * out['decode_busy']:.1f}% "
          f"(eager step's device time over the captured step) "
          f"generate_s={out['generate_s']:.3f} peak_memory_GB="
          f"{out['generate_peak_gb']:.2f}; worst err/limit over {G} steps "
          f"{worst:.3f}; launches {nonzero(gen_launches)}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    if tuple(seqs.shape) != (B, S + G):
        fail(f"bf16 {name} generate: wrong output shape")
    BF16_RESULTS[f"{name}_serve"] = out
    del got, want, exact, cache, model, plain, plain32, params
    gc.collect()
    torch.cuda.empty_cache()
    return fwd, gen_launches


def bf16_ulps(a, b) -> float:
    """The largest |a - b| in bfloat16 ulps of b's binade (2^-133 at
    least, the smallest subnormal's)."""
    import torch

    b = b.double()
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp(min=2.0 ** -126)))
                     - 7)
    return float(((a.double() - b).abs() / ulp).max())


def bf16_train_want(cfg, remat: bool) -> dict:
    """The launches of one bfloat16 train step, by kernel: the forward's
    norms and kernels, twice a layer under remat (the recompute); B9's
    two launches a LayerNorm backward."""
    from repro_torch.kernels.layernorm import BWD_LAUNCHES_PER_CALL
    from repro_torch.kernels.ssd_scan import LAUNCHES_PER_CALL

    L, k = cfg.n_layers, 2 if remat else 1
    if cfg.family == "ssm":
        want = {"rmsnorm": 2 * k * L + 1,
                "ssd_scan": k * L * LAUNCHES_PER_CALL}
    elif cfg.norm == "layernorm":
        want = {"layernorm": k * 2 * L + 1, "flash_attention": k * L,
                "layernorm_bwd": (k * 2 * L + 1) * BWD_LAUNCHES_PER_CALL}
    else:
        want = {"rmsnorm": 2 * k * L + 1, "flash_attention": k * L}
    want.update({f"{n}_bf16": v for n, v in want.items()})
    return want


def phase_bf16_train(arch: str = "llama3.2-3b", remat: bool = True) -> dict:
    """Training with ``param_dtype=torch.bfloat16`` (and ``remat`` "full"
    where asked): batch 8 x 512, 5 AdamW steps through
    ``make_train_step`` (the update written in place, as the reference's
    trainer donates its state).  Step 0: loss and gradients by
    ``path_rule`` against a float32 plain run of the same weights; with
    remat, the gradients equal those without within one bfloat16 ulp; the
    launches of each step are ``bf16_train_want``'s.  Returns the launches
    of the counted 5 steps."""
    import torch
    from torch.utils._pytree import tree_flatten_with_path, tree_leaves, \
        keystr
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import Model

    t_phase = time.perf_counter()
    bf = torch.bfloat16
    cfg = get_config(arch)
    name = SHORT[arch]
    L = cfg.n_layers
    B, S, N = TRAIN_BATCH, TRAIN_FRAMES, TRAIN_STEPS
    unit = "frames" if cfg.frontend == "audio" else "tokens"
    gc.collect()
    torch.cuda.empty_cache()
    print(f"bf16 train path: {cfg.name} layers={L} param_dtype=bfloat16 "
          f"remat={remat}{' (full)' if remat else ''} batch={B}x{S} {unit} "
          f"steps={N} AdamW; allocated before it "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    data = SyntheticTokens(DataConfig(seed=SEED, global_batch=B, seq_len=S),
                           cfg)
    batches = [{k: torch.as_tensor(v).to("cuda")
                for k, v in data.batch_at(i).items()} for i in range(N)]
    mdl = Model(cfg, param_dtype=bf, remat=remat)
    params = mdl.init(SEED)
    out: dict = {}

    # step 0: the float32 plain run first (its params dropped after it)
    p32 = tree_float(params)
    l32, g32 = loss_and_grads(Model(cfg, "xla", remat=remat), p32,
                              batches[0])
    del p32
    torch.cuda.empty_cache()
    reset_launch_counts()
    lk, gk = loss_and_grads(mdl, params, batches[0])
    torch.cuda.synchronize()
    step0 = launch_counts()
    ulps, lnr = 0.0, lk
    if remat:
        lnr, gnr = loss_and_grads(Model(cfg, param_dtype=bf, remat=False),
                                  params, batches[0])
        ulps = max(bf16_ulps(a, b) for a, b in zip(tree_leaves(gk),
                                                    tree_leaves(gnr)))
        del gnr
    lp, gp = loss_and_grads(Model(cfg, "xla", param_dtype=bf, remat=remat),
                            params, batches[0])
    worst, where = 0.0, ""
    for (path, a), p, e in zip(tree_flatten_with_path(gk)[0],
                               tree_leaves(gp), tree_leaves(g32)):
        r = path_rule(f"bf16 {name} train step 0 gradient {keystr(path)}",
                      a, p, e)
        if r["err"] / r["limit"] > worst:
            worst, where = r["err"] / r["limit"], keystr(path)
    loss_rule = path_rule(f"bf16 {name} train step 0 loss", lk.reshape(1),
                          lp.reshape(1), l32.reshape(1))
    del gk, gp, g32
    torch.cuda.empty_cache()
    print(f"bf16 {name} train step 0: loss kernel {float(lk):.6f} plain bf16 "
          f"{float(lp):.6f} float32 {float(l32):.6f} (kernel "
          f"{loss_rule['err']:.3e}, "
          f"plain {loss_rule['plain_err']:.3e} from float32, limit "
          f"{loss_rule['limit']:.3e}); gradients: worst err/limit {worst:.3f} "
          f"at {where}"
          + (f"; remat against no remat: loss {float(lk):.6f} vs "
             f"{float(lnr):.6f}, gradients within {ulps:.3f} bfloat16 ulps "
             f"(limit 1)" if remat else "")
          + f"; launches {nonzero(step0)}")
    if ulps > 1.0 or float(lk) != float(lnr):
        fail(f"bf16 {name} train: remat changed the step-0 loss or "
             f"gradients ({ulps:.3f} ulps)")
    want = bf16_train_want(cfg, remat)
    for k, n in want.items():
        if step0[k] != n:
            fail(f"bf16 {name} train step 0 launched {k} {step0[k]} times, "
                 f"want {n}")

    opt_cfg = optim.AdamWConfig(lr=1e-3, warmup_steps=min(20, N // 10),
                                total_steps=N)
    state = optim.init(opt_cfg, params)
    step = make_train_step(mdl, opt_cfg, donate=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, step_ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, b)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    out.update(losses=losses, step_ms=step_ms,
               step_ms_median=statistics.median(step_ms[1:]),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               loss_rule=loss_rule, grad_worst=worst, remat_ulps=ulps)
    # a sixth step under the profiler: where the step's time goes
    prof = where_the_time_goes(f"one bf16 {name} train step"
                               + (" (remat)" if remat else ""),
                               lambda: step(params, state, batches[0]))
    busy = sum(v for k, v in prof.items() if k != "wall_ms")
    out["busy_share"] = busy / out["step_ms_median"]
    out["busy_by_kind"] = {k: round(100 * v / busy, 2)
                           for k, v in prof.items() if k != "wall_ms"}
    print(f"bf16 {name} train: losses={[round(x, 5) for x in losses]} "
          f"step_ms={[round(x, 1) for x in step_ms]} median of steps 2-{N} "
          f"{out['step_ms_median']:.1f} ms "
          f"({B * S * 1e3 / out['step_ms_median']:.0f} {unit}/s) "
          f"peak_memory_GB={out['peak_gb']:.2f} "
          f"(torch.cuda.max_memory_allocated, the 5 steps); launches "
          f"{nonzero(launches)}; device "
          f"busy {100 * out['busy_share']:.1f}% of the median step, by kind "
          f"(%): {json.dumps(out['busy_by_kind'])}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    if not all(map(math.isfinite, losses)):
        fail(f"bf16 {name} train: a loss is not finite")
    for k, n in want.items():
        if launches[k] != N * n:
            fail(f"bf16 {name} train launched {k} {launches[k]} times in {N} "
                 f"steps, want {N * n}")
    BF16_RESULTS[f"{name}_train"] = out
    del params, state, mdl, batches
    gc.collect()
    torch.cuda.empty_cache()
    return launches


#: The bfloat16 model paths of phase 11b, in order: (label, arch, what)
#: with what "serve" (``generate``), "forward+serve" or "train" (remat
#: "full") / "train-noremat"
BF16_PATHS = (("bf16_forward+bf16_serve", "llama3.2-3b", "forward+serve"),
              ("bf16_train", "llama3.2-3b", "train"),
              ("bf16_ssm_serve", SSM_ARCH, "serve"),
              ("bf16_ssm_train", SSM_ARCH, "train"),
              ("bf16_hybrid_serve", HYBRID_ARCH, "serve"),
              ("bf16_encoder_train", "hubert-xlarge", "train-noremat"),
              ("bf16_moe_forward+bf16_moe_serve", MOE_ARCH, "forward+serve"))


def phase_bf16_paths(gen) -> dict:
    """Every bfloat16 model path (``BF16_PATHS``), each model freed before
    the next; returns {path label: its launches}."""
    launches = {}
    for label, arch, what in BF16_PATHS:
        if what.startswith("train"):
            launches[label] = phase_bf16_train(arch, remat=what == "train")
        else:
            fwd, serve = phase_bf16_serve(gen, arch,
                                          what.startswith("forward"))
            names = label.split("+")
            if len(names) == 2:
                launches[names[0]] = fwd
            launches[names[-1]] = serve
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Drive the PyTorch port on one CUDA card (see the "
                    "module's docstring for the phases).")
    ap.add_argument(
        "--phase", choices=("all", "router", "tuned", "dispatch", "bf16"),
        default="all",
        help="'router': only the device line, the build and the router "
             "floor rows (phase 3c), then their JSON line; no path runs. "
             "'tuned': only the device line and the tuned phase (5c), "
             "then its JSON line. 'dispatch': only the device line and "
             "the dispatch phase (3f), then its JSON line. 'bf16': only "
             "the device line, the build and the bfloat16 phase (5e: the "
             "kernels' bfloat16 rows, Llama-3.2-3B's bfloat16 forward, "
             "generate and remat training, Mamba2-370m's generate and "
             "remat training, Zamba2-1.2B's generate, HuBERT-XLarge's "
             "training, Granite's forward and generate, Zamba2-1.2B's "
             "float32 training), then its JSON lines")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"FAIL: {ROOT} is not a checkout of the repository "
              "(src/repro_torch missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "build" / "triton_cache"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    print(device_line())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    if args.phase == "router":
        from repro_torch.kernels import _build
        _build.build_all()
        print(json.dumps({"router_floor": phase_router_floor(gen)}))
        return 0
    if args.phase == "tuned":
        phase_tuned(gen, {})
        print(json.dumps({"tuned": TUNED_RESULTS}, default=str))
        return 0
    if args.phase == "dispatch":
        phase_dispatch(gen, {})
        print(json.dumps({"dispatch": DISPATCH_RESULTS}, default=str))
        return 0
    if args.phase == "bf16":
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        _build.build_all()
        print(f"nvcc build: {time.perf_counter() - t0:.1f} s")
        bf16_checks = phase_bf16_kernels(gen)
        phase_bf16_paths(gen)
        phase_train(HYBRID_ARCH, HYBRID_TRAIN_BATCH)
        print(json.dumps({"bf16": BF16_RESULTS,
                          "bf16_kernels": {k: summarize(v) for k, v in
                                           bf16_checks.items()}},
                         default=str))
        print(f"chip_smoke --phase bf16: {time.perf_counter() - t_start:.1f}"
              " s")
        return 0
    phase_kernels(gen)
    checks = phase_cuda_kernels(gen)
    phase_router_floor(gen)
    anchor_checks, anchor_launches = phase_anchored_kernels(gen)
    checks.update(anchor_checks)
    form_checks, form_launches = phase_anchor_forms(gen)
    checks.update(form_checks)
    diff_launches = phase_differentiable(gen)
    dispatch_launches = phase_dispatch(gen, checks)
    reset_launch_counts()
    fwd_launches, fwd_checks = phase_main_path(gen)
    checks.update(fwd_checks)
    n_fwd = sum(map(len, fwd_checks.values()))
    serve_launches, sched_launches = phase_serving(gen, checks)
    n_gen = sum(len(checks[k]) for k in ("onepass", "streaming"))
    train_launches = phase_train()
    moe_serve_launches, moe_sched_launches = phase_serving(gen, checks,
                                                           MOE_ARCH)
    n_moe = sum(len(checks[k]) for k in ("onepass", "streaming")) - n_gen
    moe_train_launches = phase_train(MOE_ARCH)
    ssm_serve_launches, _ = phase_serving(gen, checks, SSM_ARCH)
    hybrid_serve_launches, hybrid_sched_launches = phase_serving(
        gen, checks, HYBRID_ARCH)
    n_rec = sum(len(checks[k]) for k in ("onepass", "streaming")) \
        - n_gen - n_moe
    print(f"generated kernel instances held against their plain versions: "
          f"{n_fwd} of the forward path, {n_gen - n_fwd} more of serving, "
          f"{n_moe} more of MoE serving, {n_rec} more of SSM and hybrid "
          f"serving")
    ssm_train_launches = phase_train(SSM_ARCH)
    checks.update(phase_bf16_kernels(gen))
    bf16_launches = phase_bf16_paths(gen)
    hybrid_train_launches = phase_train(HYBRID_ARCH, HYBRID_TRAIN_BATCH)
    t_static = time.perf_counter()
    static_launches = phase_static_decode(gen, "llama3.2-3b", BATCH,
                                          STATIC_KV)
    long_launches = phase_static_decode(gen, HYBRID_ARCH, 1, LONG_KV)
    print(f"static decode phases: {time.perf_counter() - t_static:.1f} s")
    # last of the paths: the earlier phases run as they did before it
    tuned_launches = phase_tuned(gen, checks)
    sass_check()

    kernels = []
    for name, route, source, replaces in (
            ("onepass", "triton", "src/repro_torch/core/codegen.py",
             "src/repro/core/codegen.py:973"),
            ("streaming", "cuda", "src/repro_torch/csrc/streaming.cuh",
             "src/repro/core/codegen.py:763"),
            ("rmsnorm", "cuda", "src/repro_torch/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:20"),
            ("flash_attention", "cuda",
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:87"),
            ("flash_attention_wide", "cuda",
             "src/repro_torch/csrc/flash_attention_wide.cu",
             "src/repro/kernels/flash_attention.py:87"),
            ("layernorm", "cuda", "src/repro_torch/csrc/layernorm.cu",
             "src/repro/kernels/layernorm.py:34"),
            ("layernorm_bwd", "cuda", "src/repro_torch/csrc/layernorm.cu",
             "src/repro/kernels/layernorm.py:92"),
            ("softmax", "cuda", "src/repro_torch/csrc/softmax.cu",
             "src/repro/kernels/softmax.py:22"),
            ("softmax_bwd", "cuda", "src/repro_torch/csrc/softmax.cu",
             "src/repro/kernels/softmax.py:52"),
            ("ssd_scan", "cuda", "src/repro_torch/csrc/ssd_scan.cu",
             "src/repro/kernels/ssd_scan.py:75"),
            ("flash_decode", "cuda", "src/repro_torch/csrc/flash_decode.cu",
             "src/repro/kernels/flash_attention.py:161"),
            ("matmul_fused", "cuda", "src/repro_torch/csrc/matmul_fused.cuh",
             "src/repro/kernels/matmul.py:53"),
            ("flash_score_mod", "cuda",
             "src/repro_torch/csrc/flash_attention.cuh",
             "src/repro/kernels/flash_attention.py:31"),
            ("matmul_fused_prologue_reduce", "cuda",
             "src/repro_torch/csrc/matmul_fused.cuh",
             "src/repro/kernels/matmul.py:53"),
            ("matmul_fused_cluster_epilogue", "cuda",
             "src/repro_torch/csrc/matmul_fused.cuh",
             "src/repro/kernels/matmul.py:53"),
            ("flash_wide_score_mod", "cuda",
             "src/repro_torch/csrc/flash_attention_wide.cuh",
             "src/repro/kernels/flash_attention.py:31"),
            ("rmsnorm_bf16", "cuda", "src/repro_torch/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:20"),
            ("flash_attention_bf16", "cuda",
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:87"),
            ("flash_score_mod_bf16", "cuda",
             "src/repro_torch/csrc/flash_attention.cuh",
             "src/repro/kernels/flash_attention.py:31"),
            ("flash_decode_bf16", "cuda",
             "src/repro_torch/csrc/flash_decode.cu",
             "src/repro/kernels/flash_attention.py:161"),
            ("matmul_fused_bf16", "cuda",
             "src/repro_torch/csrc/matmul_fused.cuh",
             "src/repro/kernels/matmul.py:53"),
            ("layernorm_bf16", "cuda", "src/repro_torch/csrc/layernorm.cu",
             "src/repro/kernels/layernorm.py:34"),
            ("layernorm_bwd_bf16", "cuda", "src/repro_torch/csrc/layernorm.cu",
             "src/repro/kernels/layernorm.py:92"),
            ("softmax_bf16", "cuda", "src/repro_torch/csrc/softmax.cu",
             "src/repro/kernels/softmax.py:22"),
            ("softmax_bwd_bf16", "cuda", "src/repro_torch/csrc/softmax.cu",
             "src/repro/kernels/softmax.py:52"),
            ("ssd_scan_bf16", "cuda", "src/repro_torch/csrc/ssd_scan.cu",
             "src/repro/kernels/ssd_scan.py:75")):
        s = summarize(checks[name])
        by_path = {"forward": fwd_launches[name],
                   "serve": serve_launches[name],
                   "train": train_launches[name],
                   "moe_serve": moe_serve_launches[name],
                   "moe_train": moe_train_launches[name],
                   "ssm_serve": ssm_serve_launches[name],
                   "hybrid_serve": hybrid_serve_launches[name],
                   "ssm_train": ssm_train_launches[name],
                   "static_decode": static_launches[name],
                   "hybrid_long_decode": long_launches[name],
                   "scheduler": sched_launches[name],
                   "moe_scheduler": moe_sched_launches[name],
                   "hybrid_scheduler": hybrid_sched_launches[name],
                   "tuned": tuned_launches[name],
                   "anchor_bench": anchor_launches[name],
                   "anchor_forms": form_launches[name],
                   "differentiable": diff_launches[name],
                   "dispatch": dispatch_launches[name],
                   **{path: n[name] for path, n in bf16_launches.items()},
                   "hybrid_train": hybrid_train_launches[name]}
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "call_ms": s["call_ms"], "timing": TIMING,
            "instances_checked": s["instances_checked"]})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the "
          "device line to the summary")
    print(json.dumps({"scheduler": SCHED_RESULTS}))
    print(json.dumps({"tuned": TUNED_RESULTS}, default=str))
    print(json.dumps({"differentiable": DIFF_RESULTS}))
    print(json.dumps({"dispatch": DISPATCH_RESULTS}, default=str))
    print(json.dumps({"bf16": BF16_RESULTS}, default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
