#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

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
   [4, 32] (decode) and [4096, 32] (train), at a ragged [4095, 40] and at
   [256, 4096] (wider than the one-warp path), and the flash attention
   kernel at the prefill shape (causal), at a ragged Sq = Skv = 500, with
   Sq 200 < Skv 500 (causal offset), non-causal, at the HuBERT train
   path's [8, 16, 512, 80] non-causal, at Granite's head dim 64
   ([4, 16 (Hkv 8), 512, 64] and [8, 16 (Hkv 8), 512, 64], causal) and
   at Zamba2's prompt ([4, 32, 500, 64] causal, ragged), at Gemma-7B's
   heads ([4, 16, 512, 256], causal) and above the tuned head dims
   ([4, 16, 512, 320], causal: the wide kernel,
   ``csrc/flash_attention_wide.cu``), each against the same function in
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
   128 instance, its columns masked at 80), 16 query heads a KV head
   (two sub-groups) and head dim 320 (the wide kernel, one query row),
   each element within r |plain| + r mean|plain|, r = 1e-5 max(1,
   sqrt(kv_len / 32768)), with SDPA as its library call; then its time
   at one cache against the query heads a KV head (1 to 8, and 16).
   Beside RMSNorm's prefill row and the
   LayerNorm backward's train row it prints the time of one PyTorch
   element-wise op moving the same bytes (``torch.mul``, ``torch.add``).
   Each check of the flash,
   SSD and decode kernels prints the launches it made, by kernel, and
   fails unless the kernel meant for its shape ran.
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
   step, and holds its anchored instances against their plain versions.
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
   (``"xla"`` with ``dispatch="interpret"``: no kernel of any kind) fed
   the same tokens.
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
12. Static-decode paths (``make_decode_step(mdl, kv_len)``, the
   reference's decode cells): Llama-3.2-3B at decode_32k (28 layers,
   batch 4, a 30 GB cache of 32,768 rows from the seeded generator) and
   Zamba2-1.2B at long_500k (batch 1, 7 shared-block caches of 524,288
   rows, 60 GB; SSM state from zeros), 4 greedy steps at the last
   positions each: compile seconds, ms per step, launches per step (flash
   decode once an attention layer), a profile of one step, every step's
   logits held against the plain path fed the same tokens.
13. Whether each B3, B4 and B11 instance built in the run holds
   tensor-core instructions (``cuobjdump -sass``: ``HGMMA`` in B3, ``HMMA``
   ``.TF32`` in B4 and in B11's chunk and output passes), printed once;
   then a ``{"kernels": [...]}`` summary line (per kernel: the times of
   its main-path instance, else of its checked instance that moves the most
   bytes, the largest error of any instance, ``timing`` saying how the
   times were taken, launches by path), then the last line
   ``{"ok": true, "device": {...}}``.

Imports ``torch`` and the port only.
"""
from __future__ import annotations

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


def kernel_kind(name: str) -> str:
    low = name.lower()
    if "rms_vec_kernel" in low or "rms_scalar_kernel" in low:
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
    if any(k in low for k in ("gemm", "sm90", "cutlass", "matmul", "xmma",
                              "gemv")):
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
    where it reads a value computed outside it."""
    import torch

    given = dict(zip(comp.graph.inputs, args))
    return [given[i] if i in given else torch.randn(
        comp.graph.node(i).spec.shape, generator=gen, device="cuda")
        for i in em.ext_ids]


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
    # 3B config's), and rows wider than the one-warp path holds
    main_fwd, main_bwd = (BATCH * PROMPT, 32), (T, 32)
    for R, C in (main_fwd, (BATCH, 32), main_bwd, (T - 1, 40), (256, 4096)):
        x = torch.randn(R, C, generator=gen, device="cuda")
        dy = torch.randn(R, C, generator=gen, device="cuda")
        y = SM.softmax_plain(x)
        # max, subtract, exp, sum, divide: 5 operations an element; the
        # backward's multiply, sum, subtract, multiply: 4
        nb_f, nb_b = 4 * 2 * R * C, 4 * 3 * R * C
        res = check_cuda_kernel(
            f"softmax [{R}, {C}]", SM.softmax_cuda, SM.softmax_plain, (x,),
            nbytes=nb_f, ops=5 * R * C, reps=50,
            library=lambda a: torch.softmax(a, -1))
        checks.setdefault("softmax", []).append(
            dict(res, _bytes=nb_f, _main=(R, C) == main_fwd))
        res = check_cuda_kernel(
            f"softmax_bwd [{R}, {C}]", SM.softmax_bwd_cuda,
            SM.softmax_bwd_plain, (y, dy), nbytes=nb_b, ops=4 * R * C,
            reps=50, library=lambda a, b: torch._softmax_backward_data(
                b, a, -1, torch.float32))
        checks.setdefault("softmax_bwd", []).append(
            dict(res, _bytes=nb_b, _main=(R, C) == main_bwd))

    llama = (BATCH, 24, 8, 128)             # B, Hq, Hkv, D
    hubert = (TRAIN_BATCH, 16, 16, 80)      # D 80: its own instance
    granite = (BATCH, 16, 8, 64)            # D 64
    granite_train = (TRAIN_BATCH, 16, 8, 64)
    zamba = (BATCH, 32, 32, 64)             # Zamba2's shared block
    gemma = (BATCH, 16, 16, 256)            # Gemma-7B's heads: D 256
    wide = (BATCH, 16, 16, 320)             # above 256: the wide kernel
    for label, (B, Hq, Hkv, D), Sq, Skv, causal in (
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
            ("gemma-7b heads causal", gemma, PROMPT, PROMPT, True),
            ("wide d320 causal", wide, PROMPT, PROMPT, True)):
        q = torch.randn(B, Hq, Sq, D, generator=gen, device="cuda")
        k = torch.randn(B, Hkv, Skv, D, generator=gen, device="cuda")
        # v as the model hands it over: [B, S, H, D] transposed (strided)
        v = torch.randn(B, Skv, Hkv, D, generator=gen,
                        device="cuda").transpose(1, 2)
        pairs = (sum(min(Skv, i + Skv - Sq + 1) for i in range(Sq))
                 if causal else Sq * Skv)
        lib = None
        if Sq == Skv:  # SDPA's causal mask is top-left: equal only here
            def lib(a, b, c, _causal=causal):
                return F.scaled_dot_product_attention(
                    a, b, c, is_causal=_causal, enable_gqa=True)
        name = "flash_attention_wide" if D > FA.MAX_HEAD_DIM \
            else "flash_attention"
        before = launch_counts()
        res = check_cuda_kernel(
            f"flash_attention {label} B{B} Hq{Hq} Hkv{Hkv} Sq{Sq} Skv{Skv} "
            f"D{D}",
            lambda a, b, c, _c=causal: FA.flash_attention_cuda(a, b, c, _c),
            lambda a, b, c, _c=causal: FA.flash_attention_plain(a, b, c, _c),
            (q, k, v), nbytes=4 * (2 * q.numel() + 2 * k.numel()),
            ops=0, mma_ops=4 * D * B * Hq * pairs, reps=20, library=lib,
            reference=lambda a, b, c, _c=causal: FA.flash_attention_plain(
                a.double(), b.double(), c.double(), _c))
        launched(name, before)
        checks.setdefault(name, []).append(
            dict(res, _bytes=4 * (2 * q.numel() + 2 * k.numel()),
                 _main=label == "prefill causal"))

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
    for label, (B, Hq, Hkv, D), S, n, layers in (
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
             None, 1),
            ("head dim 320 on the wide kernel", (1, 8, 2, 320), 4096, 4000,
             1)):
        q = torch.randn(B, Hq, D, generator=gen, device="cuda")
        # the caches as the model hands them over: one layer's view of an
        # [n_layers, B, Hkv, S, D] buffer
        k = torch.randn(layers, B, Hkv, S, D, generator=gen,
                        device="cuda")[layers // 2]
        v = torch.randn(layers, B, Hkv, S, D, generator=gen,
                        device="cuda")[layers // 2]
        eff = S if n is None else n
        nbytes, ops = 4 * (2 * B * Hkv * eff * D + 2 * B * Hq * D), \
            4 * D * B * Hq * eff
        name = "flash_decode" if FA.decode_instance(D) else \
            "flash_attention_wide"
        before = launch_counts()
        res = check_cuda_kernel(
            f"flash_decode {label} B{B} Hq{Hq} Hkv{Hkv} S{S} kv_len{eff} "
            f"D{D} ({len(FA.decode_subgroups(Hq // Hkv))} sub-group(s))",
            lambda a, b, c, _n=n: FA.flash_decode_cuda(a, b, c, _n),
            lambda a, b, c, _n=n: FA.flash_decode_plain(a, b, c, _n),
            (q, k, v), nbytes=nbytes, ops=0, mma_ops=ops,
            reps=10 if eff > 1e5 else 20,
            rtol=decode_rtol(eff),
            library=lambda a, b, c, _e=eff: F.scaled_dot_product_attention(
                a[:, :, None], b[:, :, :_e], c[:, :, :_e],
                enable_gqa=True)[:, :, 0])
        launched(name, before)
        checks.setdefault(name, []).append(
            dict(res, _bytes=nbytes, _main=label == "llama decode_32k"))
        del q, k, v
    decode_group_sweep(gen)
    torch.cuda.empty_cache()
    return checks


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
    ``.TF32`` (``mma.sync``) in every B4 kernel and in B11's chunk and
    output passes (its state pass multiplies nothing).  Printed once; a
    kernel without them fails the run."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    # (library glob, B name, kernel name fragments with products)
    kinds = (("mm_*.so", "B3", ("mm_fused_kernel",)),
             ("attn_*.so", "B4", ("flash_fwd_kernel",)),
             ("flash_attention-*.so", "B4", ("flash_fwd_kernel",)),
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

    return {"onepass": OnePassKernel.launches,
            "flash_attention_wide": flash_attention_wide_cuda.launches,
            "matmul_fused": matmul_fused.launches,
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

    OnePassKernel.launches = StreamingKernel.launches = 0
    flash_attention_wide_cuda.launches = 0
    matmul_fused.launches = ScoreMod.launches = 0
    rmsnorm_cuda.launches = flash_attention_cuda.launches = 0
    flash_decode_cuda.launches = 0
    layernorm_cuda.launches = layernorm_bwd_cuda.launches = 0
    softmax_cuda.launches = softmax_bwd_cuda.launches = 0
    ssd_scan_cuda.launches = 0


def phase_serving(gen, checks: dict, arch: str = "llama3.2-3b") -> dict:
    """``generate`` at full width in the default (stitched) mode; returns
    the launches of the counted run.  Appends the checks of the generated
    kernels it launches to ``checks``.  An MoE model also gets the
    full-width MoE layer check, and its logits are held row by row.  An
    SSM or hybrid model serves its prompt at its exact length, and its
    launches per prefill and per decode step are held to one SSD scan a
    layer (prefill only), two RMSNorms a layer and a shared application,
    one flash attention a shared application (prefill only)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
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
          f"{step_ms:.2f} ms per token (median of {G - 1} steps, host clock "
          f"around a synchronized step)  decode tokens/s={B * 1e3 / step_ms:.1f}")
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
    ref_seqs = generate(plain, params, prompts, G)
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
    return launches


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
    mamba0 = list(cache.get("mamba", []))

    def restore():
        for c, r in zip(kv, saved):
            for n in ("k", "v"):
                c[n][..., positions, :] = r[n]
        if mamba0:
            cache["mamba"][:] = mamba0

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
          f"steps minus the second {N}: trace, plan, emit, Triton builds)  "
          f"step_ms={step_ms:.2f} (median of {N}, host clock around a "
          f"synchronized step) tokens/s={B * 1e3 / step_ms:.1f}")
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
    want, _ = run(make_decode_step(plain, kv_len), forced=toks)
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


def phase_train(arch: str = "hubert-xlarge") -> dict:
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
    B, S, N = TRAIN_BATCH, TRAIN_FRAMES, TRAIN_STEPS
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
    if cfg.family == "ssm":  # the block's norm and the gated norm
        from repro_torch.kernels.ssd_scan import LAUNCHES_PER_CALL

        want = {norm: 2 * L + 1, "flash_attention": 0,
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


def main() -> int:
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
    phase_kernels(gen)
    checks = phase_cuda_kernels(gen)
    anchor_checks, anchor_launches = phase_anchored_kernels(gen)
    checks.update(anchor_checks)
    reset_launch_counts()
    fwd_launches, fwd_checks = phase_main_path(gen)
    checks.update(fwd_checks)
    n_fwd = sum(map(len, fwd_checks.values()))
    serve_launches = phase_serving(gen, checks)
    n_gen = sum(len(checks[k]) for k in ("onepass", "streaming"))
    train_launches = phase_train()
    moe_serve_launches = phase_serving(gen, checks, MOE_ARCH)
    n_moe = sum(len(checks[k]) for k in ("onepass", "streaming")) - n_gen
    moe_train_launches = phase_train(MOE_ARCH)
    ssm_serve_launches = phase_serving(gen, checks, SSM_ARCH)
    hybrid_serve_launches = phase_serving(gen, checks, HYBRID_ARCH)
    n_rec = sum(len(checks[k]) for k in ("onepass", "streaming")) \
        - n_gen - n_moe
    print(f"generated kernel instances held against their plain versions: "
          f"{n_fwd} of the forward path, {n_gen - n_fwd} more of serving, "
          f"{n_moe} more of MoE serving, {n_rec} more of SSM and hybrid "
          f"serving")
    ssm_train_launches = phase_train(SSM_ARCH)
    t_static = time.perf_counter()
    static_launches = phase_static_decode(gen, "llama3.2-3b", BATCH,
                                          STATIC_KV)
    long_launches = phase_static_decode(gen, HYBRID_ARCH, 1, LONG_KV)
    print(f"static decode phases: {time.perf_counter() - t_static:.1f} s")
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
             "src/repro/kernels/flash_attention.py:31")):
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
                   "anchor_bench": anchor_launches[name]}
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
