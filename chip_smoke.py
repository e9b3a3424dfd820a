#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (Triton
compiles the generated kernels there; nothing is downloaded).  Phases,
each of which makes the script exit non-zero when it fails:

1. Device: the card's name and power limit (``nvidia-smi``).
2. Kernels: each generated kernel against its plain PyTorch version on
   the card, in float32 -- the one-pass kernel on the quickstart LayerNorm
   at [8192, 3072], the streaming kernel on a softmax at [2048, 128256] --
   with kernel, plain and library-call times (CUDA events, median) and
   the least time the card could take (bytes over 3.35 TB/s, operations
   over 67 TFLOP/s float32; H100 SXM data sheet).
3. Main path: Llama-3.2-3B at full width, all 28 layers, batch 4, prompt
   512, float32 weights from a seed: ``Model.forward`` (a stitched_jit
   block per layer, then a stitched head with the softmax over the
   vocabulary), its compile and step times, the plans, the launch count
   of each kernel, and the agreement with the same graphs replayed op by
   op in plain PyTorch on the card (``dispatch="interpret"``).  Every
   generated kernel instance of the main path is then held against its
   plain version at its main-path shapes.
4. A ``{"kernels": [...]}`` summary line, then the last line
   ``{"ok": true, "device": {...}}``.

Imports ``torch`` and the port only.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM data-sheet peaks (dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

SEED = 0
BATCH, PROMPT = 4, 512


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
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
    check passes while the ratio is at most 1."""
    import torch

    err = worst = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        limit = (rtol * w.abs() + floor * float(w.abs().mean())) \
            .clamp_min(torch.finfo(torch.float32).tiny)
        err = max(err, float(diff.max()))
        worst = max(worst, float((diff / limit).max()))
    return err, worst


def check_kernel(em, graph, gen, *, label: str, reps: int,
                 library=None) -> dict:
    """Hold one generated kernel against its plain version on the card.

    Tolerance: ``agreement`` (per element, relative to the plain value).
    Launches made here are reset before the main path and never counted
    there.
    """
    import torch

    kern = em.fn
    vals = random_inputs(em, graph, gen)
    got = kern.launch(*vals)
    want = kern.plain(torch.device("cuda"), *vals)
    torch.cuda.synchronize()
    err, worst = agreement(got, want)
    ms = time_ms(lambda: kern.launch(*vals), reps)
    plain_ms = time_ms(lambda: kern.plain(torch.device("cuda"), *vals),
                       max(3, reps // 4))
    lib_ms = time_ms(lambda: library(*vals), reps) if library else None
    bound, bound_by, nbytes, ops = kernel_bound(em, graph)
    print(f"kernel {kern.schedule:9s} {label}: R={kern.R} C={kern.C} "
          f"BR={kern.BR} max_abs_err={err:.3e} (worst err/limit "
          f"{worst:.3f}, limit {RTOL:g}|plain| + {FLOOR:g} mean|plain|) "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
          f"{'n/a' if lib_ms is None else f'{lib_ms:.4f}'} "
          f"bound_ms={bound:.4f} ({bound_by}: {nbytes} B, {ops} ops)")
    if not all(torch.isfinite(g.float()).all() for g in got):
        fail(f"{label}: kernel output not finite")
    if not worst <= 1.0:
        fail(f"{label}: kernel disagrees with its plain version "
             f"(worst err/limit {worst:.3f})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms}


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

    xs = torch.randn(2048, 128256, generator=gen, device="cuda")
    c = stitched_jit(lambda v: torch.softmax(v, -1)).compiled(xs)
    em = only_generated(c, "streaming")
    check_kernel(em, c.graph, gen, label="softmax [2048, 128256]", reps=10,
                 library=lambda v: torch.softmax(v, -1))


def describe(name: str, rep, graph) -> None:
    n_dot = sum(1 for n in graph.nodes.values() if n.prim == "dot_general")
    print(f"{name}: nodes={len(graph)} dot_general={n_dot} "
          f"groups={rep.n_groups} generated={rep.n_generated} "
          f"onepass={rep.n_onepass} streaming={rep.n_streaming} "
          f"packed={rep.n_packed} stitched={rep.n_stitched} "
          f"reused={rep.emission_reused} plan_s={rep.plan_time_s:.3f} "
          f"schedules={rep.schedules}")


def where_the_time_goes(model, params, tokens) -> None:
    """Device time of one forward by kind of kernel (torch.profiler):
    generated Triton kernels, matrix products, and the plain PyTorch ops
    of packed subgraphs and leftover nodes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.forward(params, tokens)
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
        low = name.lower()
        kind = ("generated" if low == "kernel" else
                "matmul" if any(k in low for k in ("gemm", "sm90", "cutlass",
                                                   "matmul", "xmma"))
                else "plain ops")
        kinds[kind] = kinds.get(kind, 0.0) + dev_us / 1e3
        rows.append((dev_us / 1e3, ev.count, name[:60]))
    busy = sum(kinds.values())
    print(f"profile of one forward (wall {wall_ms:.1f} ms under the "
          f"profiler): device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.1f}% of wall)")
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:10s} {ms:9.2f} ms  {100 * ms / max(busy, 1e-9):5.1f}%")
    for ms, n, name in sorted(rows, reverse=True)[:12]:
        print(f"    {ms:9.2f} ms  x{n:<5d} {name}")


def phase_main_path(gen) -> tuple[dict, list]:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.codegen import OnePassKernel, StreamingKernel
    from repro_torch.models.model import Model

    cfg = get_config("llama3.2-3b")
    model = Model(cfg)
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
    describe("block", block_c.report, block_c.graph)
    describe("head", head_c.report, head_c.graph)
    head_softmax = [e for e in head_c.emitted
                    if any(head_c.graph.node(n).prim == "reduce_max"
                           for p in e.parts for n in p)]
    if not head_softmax or head_softmax[0].kind != "streaming":
        fail("the head's softmax group did not take the streaming schedule: "
             f"{head_c.report.schedules}")

    # the counted run of the main path
    OnePassKernel.launches = 0
    StreamingKernel.launches = 0
    t0 = time.perf_counter()
    logits, probs = model.forward(params, tokens)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"onepass": OnePassKernel.launches,
                "streaming": StreamingKernel.launches}
    print(f"launches in one forward: {json.dumps(launches)} "
          f"first_step_s={first_s:.2f} (includes Triton builds)")
    for k, n in launches.items():
        if n <= 0:
            fail(f"the main path launched no {k} kernel")

    where_the_time_goes(model, params, tokens)

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
    plain = Model(cfg, dispatch="interpret")
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
    stats: dict[str, dict] = {}
    checked = set()
    for name, comp in (("block", block_c), ("head", head_c)):
        for em in comp.emitted:
            if not em.generated or id(em.fn) in checked:
                continue
            checked.add(id(em.fn))
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
            nbytes = kernel_bound(em, comp.graph)[2]
            best = stats.get(em.kind)
            if best is None or nbytes > best["_bytes"]:
                stats[em.kind] = dict(res, _bytes=nbytes)
    return launches, stats


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

    print(device_line())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    phase_kernels(gen)
    launches, stats = phase_main_path(gen)

    replaces = {"onepass": "src/repro/core/codegen.py:973",
                "streaming": "src/repro/core/codegen.py:763"}
    kernels = []
    for name in ("onepass", "streaming"):
        s = stats[name]
        kernels.append({
            "name": name, "route": "triton",
            "source": "src/repro_torch/core/codegen.py",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
