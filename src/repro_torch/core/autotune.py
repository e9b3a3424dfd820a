"""Measured schedule and partition tuning on the card: the port of
``repro.core.autotune``.

The analytic latency-evaluator picks one-pass block rows, streaming
tiles and the stitch partition from a model of the card; the kernels it
prices can run otherwise (register pressure, a cluster's geometry, the
order of a group's reductions).  ``tune_pattern`` and ``tune_group``
sweep the same candidate space the model enumerates -- one-pass block
rows under the register cap (``cost_model.onepass_rows``), streaming
tiles (``cost_model.stream_tiles``), the thread-composition variants --
but *measure* each emitted kernel on dummy inputs and return the fastest
as a schedule override; ``tune_partitions`` races the stitcher's top-k
candidate partitions (each with schedule-family swaps of its groups).
The results land in the persistent plan cache (``core/plan_cache.py``):
tune once, run many.

How a candidate is built and timed on the card, against the reference:

* **One build round a sweep** (``batch_compile=True``, the counterpart
  of the reference's single ``lax.switch`` compile): emission registers
  every candidate's generated CUDA source (B2 and the anchored B3 / B4
  instances, ``kernels/_build.py::register_generated``), one parallel
  ``nvcc`` round builds them all, and every candidate runs once -- which
  compiles the Triton ones (B1's ``BR`` is a constexpr) -- before any is
  timed.  ``batch_compile=False`` builds, warms and times one candidate
  after the other: the equivalence oracle, as in the reference.
* **Device time** from CUDA events recorded on the current stream, each
  timed call queued behind a device sleep so the events see the kernels
  and not the host's launch; warm-up calls, then the best of ``iters``
  (``_time_callable``, the seam tests patch with a deterministic fake).
  On the CPU (``REPRO_AUTOTUNE=force``) the plain versions run under the
  host clock, which says nothing of the card: that is for tests.
* **A partition branch is one replay.**  The reference times a branch as
  one compiled dispatch; here each branch's region program is captured
  once as a CUDA graph and its replay is timed, so Python's launch cost
  does not favour partitions with fewer groups.
* **Isomorphic candidates are measured once**: partition branches whose
  groups have equal structure and pins (the reference's rule), and on
  the card schedule candidates that launch the same kernel (the
  streaming kernel takes its geometry from the row, so its tiles are one
  kernel; one-pass candidates of one padded block are one kernel).
* **Integer dummy inputs are zeros** (an index out of range would be a
  device-side assert that leaves the CUDA context unusable); float ones
  come from a seeded ``torch.Generator`` on the device.
* **Nothing fails silently.**  A candidate whose emission, build or
  launch fails is a generator bug and raises.  Only an injected
  ``race_crash`` branch is disqualified, as in the reference; a wedged
  race (``tuner_hang``) is cut by the watchdog and recorded in
  ``ctx.caps`` (``race_timeout``), and the caller serves the model's
  partition.
* **Never inside a capture.**  A compile reached from a
  ``CapturedStep`` warm-up tunes there, before the capture; the tuner
  raises if the current stream is capturing.  Its own graphs use their
  own memory pools, and its launches are not counted
  (``_build.uncounted``).

Gating: measuring is meaningful only on the card, so the sweep runs on a
CUDA device (or under ``REPRO_AUTOTUNE=force``, for the CPU tests);
otherwise the caller keeps the analytic model's choices.
"""
from __future__ import annotations

import contextlib
import functools
import math
import os
import time
from dataclasses import dataclass, field

import torch

from ..kernels import _build
from ..runtime.guard import RaceTimeoutError, race_timeout_s, \
    watchdog_cancelled, watchdog_sleep, with_watchdog
from ..testing import faults as _faults
from .codegen import OnePassKernel, StreamingKernel, _override_estimate, \
    emit_group, emit_pattern, pattern_emittable
from .cost_model import H100, Hardware, onepass_rows, stream_tiles
from .ir import Graph, OpKind
from .plan_cache import override_fp
from .stitcher import MAX_PARTITION_BRANCHES
from .tracer import TORCH_DTYPES, bind_node, const_tensor

#: Env switch: "force" measures even without a card (tests).
ENV_AUTOTUNE = "REPRO_AUTOTUNE"

#: Device cycles the card sleeps before each timed call (about half a
#: millisecond): the host enqueues the call meanwhile, so the events
#: bracket device time, not the wrapper's Python.
QUEUE_CYCLES = 1_000_000

#: Seed of the dummy inputs' generator.
SEED = 0

__all__ = ["ENV_AUTOTUNE", "MAX_PARTITION_BRANCHES", "PartitionTuneResult",
           "autotune_available", "tune_group", "tune_partitions",
           "tune_pattern"]


def autotune_available(device="cuda") -> bool:
    """Measured tuning is meaningful only on the card: true for a CUDA
    ``device`` on a host that has one, or under ``REPRO_AUTOTUNE=force``
    (the CPU tests)."""
    if os.environ.get(ENV_AUTOTUNE, "").lower() == "force":
        return True
    return torch.device(device).type == "cuda" and torch.cuda.is_available()


def _not_capturing(device: torch.device) -> None:
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "autotune: the current stream is capturing a CUDA graph; the "
            "tuner measures before a capture (a step's warm-up), never "
            "inside one")


def _candidate_overrides(info, hw: Hardware) -> list[dict]:
    cands: list[dict] = []
    for br in onepass_rows(hw, info.C):
        cands.append({"schedule": "onepass", "block_rows": br})
        if br >= info.R:
            break
    for br, bc in stream_tiles(hw, info.C):
        cands.append({"schedule": "streaming", "block_rows": br,
                      "block_cols": bc})
    return cands


def _recompute_variants(graph, pattern, info, ctx, hw):
    """Yield (override, estimate) for every feasible thread-composition
    one-pass of ``pattern``: block sizes whose ``reuse_plan`` flips fit
    the on-chip budget.  Shared by the measured sweep and the partition
    race's swap branches."""
    from .cost_model import estimate_onepass, reuse_plan

    if info is None:
        return
    for br in onepass_rows(hw, info.C):
        rp = (ctx.reuse(pattern, br) if ctx is not None
              else reuse_plan(graph, pattern, info, br, hw))
        if rp is not None and rp.feasible and rp.recompute:
            est = estimate_onepass(graph, pattern, info, br, hw, ctx=ctx,
                                   recompute=rp.recompute)
            if est.feasible:
                yield ({"schedule": "onepass",
                        "block_rows": est.block_rows,
                        "recompute": sorted(est.recompute_ids)}, est)
        if br >= info.R:
            break


def _recompute_overrides(graph, pattern, info, ctx, hw) -> list[dict]:
    """Thread-composition candidates for the measured sweep: one override
    per distinct (block_rows, flip set)."""
    out: list[dict] = []
    seen: set[tuple] = set()
    for over, _est in _recompute_variants(graph, pattern, info, ctx, hw):
        fp = override_fp(over)
        if fp not in seen:
            seen.add(fp)
            out.append(over)
    return out


def _dummy_inputs(graph: Graph, ext_ids, device: torch.device) -> list:
    """Float inputs standard normal from a seeded generator on
    ``device``; integer and boolean inputs zeros (always in range)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    vals = []
    for i in ext_ids:
        spec = graph.node(i).spec
        dt = TORCH_DTYPES[spec.dtype]
        if dt.is_floating_point:
            vals.append(torch.randn(spec.shape, generator=gen, device=device,
                                    dtype=torch.float32).to(dt))
        else:
            vals.append(torch.zeros(spec.shape, dtype=dt, device=device))
    return vals


def _time_callable(fn, args, *, warmup: int = 1, iters: int = 3,
                   key=None) -> float:
    """Best-of-``iters`` time of ``fn(*args)`` in seconds, after
    ``warmup`` untimed calls.

    With CUDA tensors among ``args``: device time from a pair of CUDA
    events on the current stream, the call queued behind a device sleep.
    Else the host clock (the CPU tests).  ``key`` identifies the
    candidate (its override, or a partition branch's key); it is unused
    here but lets tests patch this function with a deterministic fake so
    the batched and serial paths, and the two packages, can be compared
    exactly.
    """
    del key
    for _ in range(warmup):
        fn(*args)
    best = math.inf
    if not any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            best = min(best, time.perf_counter() - t0)
        return best
    stream = torch.cuda.current_stream()
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_CYCLES)
        start.record(stream)
        fn(*args)
        end.record(stream)
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e-3)
    return best


#: Sentinel for seam detection: tests replace ``_time_callable`` with a
#: deterministic fake that never runs its candidate; the card-side
#: preparation that only the real timer uses (capturing a partition
#: branch as a CUDA graph) stands down while the seam is patched.
_TIME_CALLABLE_DEFAULT = _time_callable


class _InjectedCrash(RuntimeError):
    """The ``race_crash`` fault: the one failure a race disqualifies."""


def _sane_timing(t) -> bool:
    """A usable sample: finite, non-negative, an actual number."""
    try:
        t = float(t)
    except (TypeError, ValueError):
        return False
    return math.isfinite(t) and t >= 0.0


def _card_key(over: dict, em, device: torch.device) -> tuple:
    """Schedule candidates that run the same kernel on the card share one
    measurement: the streaming kernel's launch takes its geometry from
    the row (``StreamingKernel.cluster``), so every tile of a union is
    one kernel; one-pass candidates of one padded block are one kernel.
    On the CPU the plain versions differ by tile, so nothing is shared."""
    kern = em.fn
    if device.type == "cuda":
        if isinstance(kern, StreamingKernel):
            return ("streaming", kern.source())
        if isinstance(kern, OnePassKernel):
            return ("onepass", kern.source(), kern.BR)
    return override_fp(over)


def _prepare(fn, args, device: torch.device, *, graph: bool):
    """``fn`` ready to be timed: run once (every build and compile it
    needs happens here, and an injected crash shows), on the card on a
    side stream as a capture's warm-up is; with ``graph`` then captured
    as a CUDA graph in its own memory pool, and its replay returned."""
    if device.type != "cuda":
        fn(*args)
        return fn
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream(device).wait_stream(side)
    if not graph:
        return fn
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn(*args)

    def replay(*_a, _g=g):
        _g.replay()

    return replay


def _measure_branches(fns, args, keys, device: torch.device, *,
                      rep_of: dict[int, int] | None = None,
                      batch_compile: bool = True,
                      graphs: bool = False) -> list[float | None]:
    """Per-branch best time (None: the branch was disqualified by an
    injected crash).  ``rep_of`` (branch -> representative) lets
    isomorphic branches share one measurement; ``graphs`` times each
    branch as one replayed CUDA graph on the card.

    Batched: one build round for every registered generated source, each
    representative warmed once (Triton compiles), then one timed sample
    each (screening) and the two front-runners refined (best of two more
    samples).  Serial: each representative built, warmed and timed in
    turn, best of three.
    """
    if rep_of is None:
        rep_of = {k: k for k in range(len(fns))}
    reps = sorted(set(rep_of.values()))
    graphs = (graphs and device.type == "cuda"
              and _time_callable is _TIME_CALLABLE_DEFAULT)
    timed: dict[int, float] = {}
    with _build.uncounted():
        if not batch_compile:
            for k in reps:
                try:
                    fn = _prepare(fns[k], args, device, graph=graphs)
                except _InjectedCrash:
                    continue
                timed[k] = _time_callable(fn, args, key=keys[k])
        else:
            if device.type == "cuda":
                _build.build_all()  # one parallel nvcc round
            ready: dict[int, object] = {}
            for k in reps:
                try:
                    ready[k] = _prepare(fns[k], args, device, graph=graphs)
                except _InjectedCrash:
                    continue
            for k, fn in ready.items():
                timed[k] = _time_callable(fn, args, warmup=1, iters=1,
                                          key=keys[k])
            ranked = sorted((k for k in timed if _sane_timing(timed[k])),
                            key=timed.get)
            for k in ranked[:2]:  # top-2 refinement
                t = _time_callable(ready[k], args, warmup=1, iters=2,
                                   key=keys[k])
                if _sane_timing(t):
                    timed[k] = min(timed[k], t)
    # NaN / inf / negative samples disqualify their branch, never the race
    timed = {k: t for k, t in timed.items() if _sane_timing(t)}
    return [timed.get(rep_of[k]) for k in range(len(fns))]


def _emit_candidates(info, hw: Hardware, emit,
                     extra: list[dict] | None = None
                     ) -> list[tuple[dict, object]]:
    """Emit every candidate of the analytic space (plus ``extra``
    recompute overrides) and keep those the emitter honoured: an override
    the emitter re-priced as infeasible falls back to the analytic pick,
    and a fallback kernel racing under the override's label would persist
    a pin whose parameters never ran.  Emission errors raise."""
    cands: list[tuple[dict, object]] = []
    for over in _candidate_overrides(info, hw) + list(extra or ()):
        em = emit(over)
        est = em.estimate
        if est.schedule != over["schedule"]:
            continue
        want_br = over.get("block_rows")
        if want_br and est.block_rows != max(1, min(want_br, info.R)):
            continue  # emitter fell back to a different launch dim
        if sorted(est.recompute_ids) != sorted(over.get("recompute", ())):
            continue  # stage-vs-recompute fallback masquerading
        cands.append((over, em))
    return cands


def _sweep(info, hw: Hardware, emit, graph: Graph, device: torch.device, *,
           batch_compile: bool,
           extra_overrides: list[dict] | None = None) -> dict | None:
    cands = _emit_candidates(info, hw, emit, extra=extra_overrides)
    if not cands:
        return None
    fns = [functools.partial(em.fn, device) for _, em in cands]
    keys = [override_fp(over) for over, _ in cands]
    rep_by: dict[tuple, int] = {}
    rep_of = {k: rep_by.setdefault(_card_key(over, em, device), k)
              for k, (over, em) in enumerate(cands)}
    args = _dummy_inputs(graph, cands[0][1].ext_ids, device)
    times = _measure_branches(fns, args, keys, device, rep_of=rep_of,
                              batch_compile=batch_compile)
    best_t, best_over = math.inf, None
    for (over, _em), t in zip(cands, times):
        if t is not None and t < best_t:
            best_t, best_over = t, over
    return best_over


def _union_info(graph: Graph, union: frozenset[int], ctx):
    if ctx is not None:
        return ctx.info(union)
    from .rowspec import analyze

    return analyze(graph, union)


def tune_pattern(graph: Graph, pattern: frozenset[int], *,
                 hw: Hardware = H100, ctx=None, batch_compile: bool = True,
                 device="cuda") -> dict | None:
    """Measure candidate schedules for one pattern; None -> keep analytic.

    Returns the winning ``{"schedule", "block_rows"[, "block_cols"]
    [, "recompute"]}`` override, or None when the pattern has no row view
    or is not emittable.
    """
    device = torch.device(device)
    _not_capturing(device)
    info = _union_info(graph, pattern, ctx)
    if info is None or not pattern_emittable(graph, pattern, info=info):
        return None

    def emit(over):
        return emit_pattern(graph, pattern, hw=hw, ctx=ctx,
                            schedule_override=over)

    return _sweep(info, hw, emit, graph, device, batch_compile=batch_compile,
                  extra_overrides=_recompute_overrides(graph, pattern,
                                                       info, ctx, hw))


def tune_group(graph: Graph, parts, *, hw: Hardware = H100, ctx=None,
               batch_compile: bool = True, device="cuda") -> dict | None:
    """Measure candidate schedules for a stitch group's union kernel.

    ``parts`` are the group's member patterns (as for ``emit_group``).
    The candidate space is the analytic sweep over the *union*: one-pass
    block rows against streaming tiles, plus the thread-composition
    variants.  Returns the winning override, or None when the union has
    no row view or is not emittable.
    """
    device = torch.device(device)
    _not_capturing(device)
    parts = tuple(frozenset(p) for p in parts)
    union: frozenset[int] = frozenset()
    for p in parts:
        union |= p
    info = _union_info(graph, union, ctx)
    if info is None or not pattern_emittable(graph, union, info=info):
        return None

    def emit(over):
        return emit_group(graph, parts, hw=hw, ctx=ctx,
                          schedule_override=over)

    return _sweep(info, hw, emit, graph, device, batch_compile=batch_compile,
                  extra_overrides=_recompute_overrides(graph, union,
                                                       info, ctx, hw))


# ---------------------------------------------------------------------------
# joint partition x schedule tuning (paper: tune the stitching *scheme*)
# ---------------------------------------------------------------------------
@dataclass
class PartitionTuneResult:
    """Outcome of racing candidate partitions on the card."""

    index: int                   # winning candidate (rank in model order)
    overrides: list[dict]        # per-group schedule pin for the winner
                                 # ({} = the analytic pick)
    measured_s: list[float] = field(default_factory=list)
    # best measured time per candidate (inf: never timed)
    branches: int = 0            # (partition, assignment) pairs raced
    disqualified: int = 0        # branches an injected crash took out


def _alt_schedule_override(graph, union, info, ctx, hw) -> dict | None:
    """The best-priced feasible override from the schedule family the
    analytic model did NOT pick (onepass <-> streaming): the coarse
    schedule axis that can flip a partition comparison on the card."""
    best = ctx.best(union)
    alt = {"onepass": "streaming", "streaming": "onepass"}.get(best.schedule)
    if alt is None or info is None:
        return None
    pick: tuple[dict, float] | None = None
    for over in _candidate_overrides(info, hw):
        if over["schedule"] != alt:
            continue
        est = _override_estimate(graph, union, info, over, hw, ctx=ctx)
        if est is None:
            continue
        if pick is None or est.latency_s < pick[1]:
            pick = (over, est.latency_s)
    return pick[0] if pick else None


def _recompute_swap_override(graph, union, info, ctx, hw) -> dict | None:
    """The best-priced feasible *recompute one-pass* override for a union
    whose analytic best is something else: the stage-vs-recompute axis of
    the race."""
    best = ctx.best(union)
    if best.schedule == "onepass":
        return None
    pick: tuple[dict, float] | None = None
    for over, est in _recompute_variants(graph, union, info, ctx, hw):
        if pick is None or est.latency_s < pick[1]:
            pick = (over, est.latency_s)
    return pick[0] if pick else None


def _region_schedule(graph: Graph, region: frozenset[int],
                     kernels: list) -> list[tuple[str, int]] | None:
    """Dependency-ordered execution plan of ``region`` for one candidate:
    group kernels plus the region nodes this candidate leaves bare.
    None on a dependence cycle (defensive: convex groups make none)."""
    member_of: dict[int, int] = {}
    for k, (em, members) in enumerate(kernels):
        for nid in members:
            member_of[nid] = k
    sched: list[tuple[str, int]] = []
    done: set[int] = set()
    pending_nodes = [n for n in sorted(region) if n not in member_of]
    pending_kernels = list(range(len(kernels)))
    while pending_nodes or pending_kernels:
        progressed = False
        keep_n: list[int] = []
        for nid in pending_nodes:
            if all(i not in region or i in done
                   for i in graph.node(nid).inputs):
                sched.append(("node", nid))
                done.add(nid)
                progressed = True
            else:
                keep_n.append(nid)
        pending_nodes = keep_n
        keep_k: list[int] = []
        for k in pending_kernels:
            em, members = kernels[k]
            if all(e not in region or e in done for e in em.ext_ids):
                sched.append(("kernel", k))
                done.update(members)
                progressed = True
            else:
                keep_k.append(k)
        pending_kernels = keep_k
        if not progressed:
            return None
    return sched


def _partition_runner(graph: Graph, sched, kernels, ext_ids: list[int],
                      out_ids: list[int], device: torch.device):
    """One candidate's region program: group kernels in dependency order,
    bare nodes replayed by ``bind_node`` -- every branch maps the region's
    external inputs to the same outputs."""
    def runner(*ext_vals):
        env = dict(zip(ext_ids, ext_vals))

        def value(i):
            return env[i] if i in env else const_tensor(graph.node(i),
                                                        device)

        for kind, item in sched:
            if kind == "node":
                node = graph.node(item)
                env[item] = bind_node(node, [value(i) for i in node.inputs],
                                      device)
            else:
                em = kernels[item][0]
                outs = em.fn(device, *[env[i] for i in em.ext_ids])
                env.update(zip(em.out_ids, outs))
        return tuple(value(o) for o in out_ids)

    return runner


@dataclass
class _Branch:
    ci: int                      # candidate partition index
    assignment: dict             # group index -> schedule override
    runner: object               # region program for this assignment
    mkey: tuple                  # structural measurement key (iso dedup)
    tkey: tuple                  # _time_callable seam key


def _branch_tkey(ci: int, assignment: dict) -> tuple:
    return ("partition", ci,
            tuple(sorted((gi, override_fp(over))
                         for gi, over in assignment.items())))


def _candidate_branches(graph: Graph, ci: int, groups, region, ext_ids,
                        out_ids, ctx, hw, device,
                        emit_cache: dict) -> list[_Branch]:
    """All (this partition, schedule-assignment) branches: the
    all-analytic assignment first, then one swap per stitched group into
    the other schedule family's best-priced override, plus one
    stage-vs-recompute swap where the analytic best left a feasible
    thread-composition one-pass on the table."""
    def emitted_for(grp, over: dict | None):
        anchors = tuple(grp.anchors)
        key = (grp.members, anchors, override_fp(over))
        if key not in emit_cache:
            em = emit_group(graph, grp.parts, hw=hw, ctx=ctx,
                            schedule_override=over or None, anchors=anchors)
            if anchors:
                pass  # anchored emission has one fixed scheme
            elif over and em.estimate.schedule != over.get("schedule"):
                em = None  # emitter fell back: not the asked-for schedule
            elif over and sorted(em.estimate.recompute_ids) != sorted(
                    over.get("recompute", ())):
                em = None  # stage-vs-recompute choice not honoured
            emit_cache[key] = em
        return emit_cache[key]

    def build(assignment: dict) -> _Branch | None:
        kernels = []
        mkey_parts = []
        for gi, grp in enumerate(groups):
            over = assignment.get(gi)
            em = emitted_for(grp, over)
            if em is None:
                return None
            kernels.append((em, grp.members))
            mkey_parts.append((ctx.struct_key(grp.members),
                               override_fp(over)))
        sched = _region_schedule(graph, region, kernels)
        if sched is None:
            return None
        bare = tuple(sorted(n for n in region
                            if all(n not in m for _, m in kernels)))
        mkey = (tuple(mkey_parts),
                tuple(ctx.struct_key(frozenset({n})) for n in bare))
        runner = _partition_runner(graph, sched, kernels, ext_ids, out_ids,
                                   device)
        return _Branch(ci, assignment, runner, mkey,
                       _branch_tkey(ci, assignment))

    base = build({})
    if base is None:
        return []
    out = [base]
    for gi, grp in enumerate(groups):
        if grp.anchors or not grp.stitched:
            continue  # anchored groups race as they are: no family swap
        for swap in (_alt_schedule_override, _recompute_swap_override):
            over = swap(graph, grp.members, ctx.info(grp.members), ctx, hw)
            if over is None:
                continue
            br = build({gi: over})
            if br is not None:
                out.append(br)
    return out


def tune_partitions(graph: Graph, candidates, *, hw: Hardware = H100,
                    ctx=None, batch_compile: bool = True,
                    device="cuda") -> PartitionTuneResult | None:
    """Race candidate partitions (each a list of ``StitchGroup``) on the
    card; return the measured winner and its schedule assignment.

    The branch space is every (partition, candidate-schedule) pair: each
    candidate contributes its all-analytic assignment plus one swap per
    stitched group into the other schedule family (and a recompute swap).
    Every branch runs the same *region* -- the union of every candidate's
    members, with the nodes a candidate does not cover replayed bare --
    so every branch takes the same inputs and returns the same outputs.
    At most ``MAX_PARTITION_BRANCHES`` branches race (the all-analytic
    ones first; a cut is recorded as the ``partition_branches`` cap).
    Screening plus top-2 refinement picks the winner; isomorphic
    branches are measured once.  Returns None when nothing could be
    measured or the race timed out (``race_timeout`` in ``ctx.caps``):
    the caller keeps the cost model's ranking.
    """
    device = torch.device(device)
    _not_capturing(device)
    if ctx is None:
        from .costctx import CostContext

        ctx = CostContext(graph, hw)
    candidates = [list(c) for c in candidates]
    if not candidates or not candidates[0]:
        return None

    region: frozenset[int] = frozenset()
    for groups in candidates:
        for grp in groups:
            region |= grp.members
    b = ctx.bounds(region)
    ext_ids = [i for i in b.inputs
               if graph.node(i).kind is not OpKind.CONST]
    out_ids = list(b.outputs)

    emit_cache: dict = {}
    branches: list[_Branch] = []
    for ci, groups in enumerate(candidates):
        branches.extend(_candidate_branches(
            graph, ci, groups, region, ext_ids, out_ids, ctx, hw, device,
            emit_cache))
    if not branches:
        return None
    if len(branches) > MAX_PARTITION_BRANCHES:
        # keep every all-analytic assignment, then swaps in order
        ctx.note_cap("partition_branches",
                     len(branches) - MAX_PARTITION_BRANCHES)
        base = [br for br in branches if not br.assignment]
        swaps = [br for br in branches if br.assignment]
        branches = (base + swaps)[:MAX_PARTITION_BRANCHES]

    # ``race_crash``: one branch's runner raises; the race disqualifies
    # it and commits a winner from the healthy branches.
    crash = _faults.fire("race_crash")
    if crash is not None:
        try:
            idx = int(crash.params.get("branch", 0)) % len(branches)
        except (TypeError, ValueError):
            idx = 0

        def _crashed_runner(*_a):
            raise _InjectedCrash("injected race_crash branch failure")

        # unique keys: the crashed branch is its own representative
        branches[idx] = _Branch(branches[idx].ci, branches[idx].assignment,
                                _crashed_runner, ("injected_crash", idx),
                                ("injected_crash", idx))

    args = _dummy_inputs(graph, ext_ids, device)
    if batch_compile and device.type == "cuda":
        _build.build_all()  # the build round runs before the watchdog
    stream = torch.cuda.current_stream(device) \
        if device.type == "cuda" else None

    def _measured():
        # ``tuner_hang``: a wedged measurement, contained by the watchdog
        hang = _faults.fire("tuner_hang")
        if hang is not None:
            watchdog_sleep(hang.sleep_s())
        if watchdog_cancelled():
            # the caller timed out and moved on: start no device work
            # from an abandoned thread
            return None
        # the watchdog's thread runs on the caller's stream
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            return _measure_partition_branches(branches, args, device,
                                               batch_compile=batch_compile)

    try:
        times = with_watchdog(_measured, race_timeout_s(),
                              label="partition race")
    except RaceTimeoutError:
        ctx.note_cap("race_timeout", 1)
        return None
    if times is None:
        return None

    measured_s = [math.inf] * len(candidates)
    best_k = -1
    for k, t in enumerate(times):
        if t is None:
            continue
        ci = branches[k].ci
        measured_s[ci] = min(measured_s[ci], t)
        if best_k < 0 or t < times[best_k]:
            best_k = k
    if best_k < 0:
        return None
    win = branches[best_k]
    overrides = [dict(win.assignment.get(gi, {}))
                 for gi in range(len(candidates[win.ci]))]
    return PartitionTuneResult(index=win.ci, overrides=overrides,
                               measured_s=measured_s,
                               branches=len(branches),
                               disqualified=sum(t is None for t in times))


def _measure_partition_branches(branches: list[_Branch], args,
                                device: torch.device, *,
                                batch_compile: bool
                                ) -> list[float | None]:
    """Per-branch best time, each branch one replayed graph on the card.
    Isomorphic branches (equal ``mkey``) share one measurement."""
    rep_by_mkey: dict[tuple, int] = {}
    for k, br in enumerate(branches):
        rep_by_mkey.setdefault(br.mkey, k)
    rep_of = {k: rep_by_mkey[br.mkey] for k, br in enumerate(branches)}
    return _measure_branches([br.runner for br in branches], args,
                             [br.tkey for br in branches], device,
                             rep_of=rep_of, batch_compile=batch_compile,
                             graphs=True)
