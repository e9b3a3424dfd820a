"""``stitched_jit`` -- the FusionStitching public API of the port.

Usage::

    fused = stitched_jit(layer_norm)        # trace -> plan -> stitch -> emit
    y = fused(x, gamma, beta)               # x, gamma, beta on the card

Pipeline: trace (``make_fx`` lowered to the reference vocabulary) -> plan
(``make_plan``) -> **stitch** (``stitcher.search_groups``: adjacent
row-compatible patterns and sandwiched singletons merge into stitch
groups, priced by the latency evaluator; the top-k distinct candidate
partitions are kept and, with ``autotune=True`` on the card, *raced* by
``autotune.tune_partitions`` -- the committed partition is the measured
winner, not just the cost-model pick -- and each stitched group's
schedule is measured by ``autotune.tune_group``) -> emit (ONE generated
Triton kernel per group; a group folded around a
compute anchor -- ``stitcher.absorb_anchors``, on by default as in the
reference, ``REPRO_ANCHOR=0`` turns it off -- becomes ONE anchored CUDA
kernel: the fused matmul B3 or flash attention with the score chain).
Structurally
isomorphic groups (repeated layers) are emitted once and rebound per
instance, and share one measured schedule.  Plans are cached per
shape/dtype signature in-process and, when ``$REPRO_PLAN_CACHE`` (or
``plan_cache=``) names a directory, across processes
(``core/plan_cache.py``): a later process whose graph has the same
signature loads the patterns, the stitch groups and their (measured)
schedules and skips exploration, stitching and measurement.

Dispatch:

* ``"single"`` runs the schedule -- generated kernels, packed subgraphs
  and the leftover single ops (matmuls among them) -- as eager launches
  on the call's device.  On CPU tensors each generated kernel runs its
  plain version; on CUDA tensors it launches or raises.
* ``"interpret"`` replays the traced graph op by op in plain PyTorch: the
  equivalence oracle.  The plan and report are built all the same.

``differentiable=True`` (``DifferentiableStitched``) stitches the
backward too: the VJP of ``fn``, traced functionalized, is another
fusion-planned graph.

A failed emission or launch raises: there is no fallback rung (the
reference's guard ladder, shadow verification, canary, background racing
and mesh options are not ported yet, ``ROADMAP.md`` A.8 and A.10).
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .codegen import Emitted, emit_group
from .costctx import CostContext
from .cost_model import H100, Hardware, KernelEstimate, anchor_enabled
from .ir import FusionPlan, Graph, OpKind, StitchGroup
from .plan_cache import PlanCache, entry_format_for, \
    entry_partition_source, entry_to_groups, entry_to_plan, \
    graph_signature, override_fp, plan_to_entry
from .planner import PlanStats, make_plan, plan_stats
from .stitcher import absorb_anchors, search_groups
from .tracer import bind_node, const_tensor, trace_with_tree


@dataclass
class StitchReport:
    """What the compiler did with one stitched function."""
    stats: PlanStats
    n_generated: int                 # generated kernels (onepass + streaming)
    n_packed: int                    # subgraphs run as plain ops
    scratch_bytes: int               # planned on-chip bytes/row (report)
    scratch_naive_bytes: int
    plan_time_s: float
    patterns: list[frozenset] = field(default_factory=list)
    dispatch: str = "single"
    schedules: list = field(default_factory=list)  # per emitted unit
    groups: list = field(default_factory=list)     # per group: its parts
    n_groups: int = 0
    n_stitched: int = 0              # groups fusing >1 part
    n_anchored: int = 0              # groups folded into a compute anchor
    stitched_hbm_bytes_saved: int = 0
    emission_reused: int = 0         # isomorphic groups rebound
    beam_width: int = 0
    beam_states_explored: int = 0
    partition_source: str = "model"  # how the committed partition was chosen
    partition_candidates: int = 0    # distinct top-k partitions considered
    partition_index: int = 0         # winner's rank in the model ordering
    #                                  (> 0: the card disagreed with the model)
    n_recomputed: int = 0
    recompute_bytes_freed: int = 0
    caps_hit: dict = field(default_factory=dict)
    # -- persistent plan cache + measured tuning -----------------------------
    plan_cache_hit: bool = False     # plan loaded from the cache directory
    autotuned: bool = False          # something was measured for this plan
    signature: str = ""              # graph_signature (the cache key)
    group_tuned: int = 0             # groups with a *measured* schedule
    group_tuned_wins: int = 0        # ...where it differs from the model's
    plan_cache_hits: int = 0         # this cache instance's load hits
    plan_cache_misses: int = 0       # ...and misses (absent/corrupt entries)
    tune_s: float = 0.0              # seconds spent measuring (0 on a hit)
    partition_branches: int = 0      # (partition, schedules) branches raced
    partition_disqualified: int = 0  # ...taken out by an injected crash
    partition_measured_s: list = field(default_factory=list)
    #                                  best time per candidate (inf: none)

    @property
    def n_onepass(self) -> int:
        return self.schedules.count("onepass")

    @property
    def n_streaming(self) -> int:
        return self.schedules.count("streaming")


class _Compiled:
    """One traced + planned + emitted instance for a fixed signature."""

    def __init__(self, graph: Graph, emitted: list[Emitted],
                 schedule: list[tuple[str, Any]], report: StitchReport,
                 out_spec, dispatch: str, device: torch.device):
        self.graph = graph
        self.emitted = emitted
        self.schedule = schedule  # [("group", Emitted) | ("node", nid)]
        self.report = report
        self.out_spec = out_spec
        self.dispatch = dispatch
        self.device = device

    def _value(self, env, i):
        return env[i] if i in env else const_tensor(self.graph.node(i),
                                                    self.device)

    def run_schedule(self, *flat_args) -> tuple:
        graph, dev = self.graph, self.device
        env: dict[int, Any] = dict(zip(graph.inputs, flat_args))
        for kind, item in self.schedule:
            if kind == "node":
                node = graph.node(item)
                env[item] = bind_node(node, [self._value(env, i)
                                             for i in node.inputs], dev)
            else:
                outs = item.fn(dev, *[env[i] for i in item.ext_ids])
                env.update(zip(item.out_ids, outs))
        return tuple(self._value(env, o) for o in graph.outputs)

    def run_plain(self, *flat_args) -> tuple:
        """The traced graph replayed op by op in plain PyTorch."""
        graph, dev = self.graph, self.device
        env: dict[int, Any] = dict(zip(graph.inputs, flat_args))
        for nid in graph.topo_order():
            if nid in env:
                continue
            node = graph.node(nid)
            env[nid] = bind_node(node, [self._value(env, i)
                                        for i in node.inputs], dev)
        return tuple(env[o] for o in graph.outputs)

    def __call__(self, flat_args):
        run = self.run_schedule if self.dispatch == "single" else self.run_plain
        return pytree.tree_unflatten(list(run(*flat_args)), self.out_spec)


def _build_schedule(graph: Graph, emitted: list[Emitted]
                    ) -> list[tuple[str, Any]]:
    """Topologically order the macro-nodes: emitted groups and the leftover
    single ops (graph inputs and consts are not scheduled).  Groups are
    convex, so the macro-node graph is acyclic; ties go to the lowest
    member id, which keeps the order close to the traced one."""
    import heapq

    units: list[tuple[str, Any, list[int]]] = []
    unit_of: dict[int, int] = {}
    for em in emitted:
        members = sorted(n for p in em.parts for n in p)
        for nid in members:
            unit_of[nid] = len(units)
        units.append(("group", em, members))
    for nid in graph.topo_order():
        node = graph.node(nid)
        if nid not in unit_of and node.kind not in (OpKind.INPUT,
                                                    OpKind.CONST):
            unit_of[nid] = len(units)
            units.append(("node", nid, [nid]))
    deps: list[set[int]] = [set() for _ in units]
    users: list[list[int]] = [[] for _ in units]
    for u, (_, _, members) in enumerate(units):
        for m in members:
            for i in graph.node(m).inputs:
                d = unit_of.get(i)
                if d is not None and d != u and d not in deps[u]:
                    deps[u].add(d)
                    users[d].append(u)
    heap = [(units[u][2][0], u) for u in range(len(units)) if not deps[u]]
    heapq.heapify(heap)
    schedule: list[tuple[str, Any]] = []
    while heap:
        _, u = heapq.heappop(heap)
        schedule.append(units[u][:2])
        for v in users[u]:
            deps[v].discard(u)
            if not deps[v]:
                heapq.heappush(heap, (units[v][2][0], v))
    if len(schedule) != len(units):
        raise RuntimeError("stitch schedule has a dependency cycle")
    return schedule


# ---------------------------------------------------------------------------
# isomorphic-emission dedup (CostContext.struct_key)
# ---------------------------------------------------------------------------
def _ext_seen_order(graph: Graph, union: frozenset[int],
                    wanted: set[int]) -> list[int]:
    """External inputs in first-reference order over the sorted members:
    a *structural* order, equal between unions with equal struct keys."""
    order: list[int] = []
    seen: set[int] = set()
    for nid in sorted(union):
        for i in graph.node(nid).inputs:
            if i in wanted and i not in seen:
                seen.add(i)
                order.append(i)
    return order


#: Consts above this element count are fingerprinted by identity (node
#: id) instead of content.
_CONST_HASH_MAX_ELEMS = 65536


def _hash_const(h, nid: int, value) -> None:
    v = np.asarray(value)
    h.update(repr((v.shape, str(v.dtype))).encode())
    if v.size <= _CONST_HASH_MAX_ELEMS:
        h.update(v.tobytes())
    else:
        h.update(repr(("by-identity", nid)).encode())


def _emit_signature(graph: Graph, ctx: CostContext,
                    union: frozenset[int], override: dict | None,
                    anchors: tuple = ()) -> tuple:
    """Dedup key for emission: structural isomorphism + what the emitted
    kernel bakes in beyond the struct key (primitive params and constant
    values, member and external, the schedule pin, and the anchors,
    positionally within the sorted members so isomorphic anchored layers
    still dedup)."""
    h = hashlib.sha1()
    params_fp = []
    for nid in sorted(union):
        n = graph.node(nid)
        params_fp.append(tuple(sorted(
            (k, repr(v)) for k, v in n.params.items()
            if not k.startswith("_"))))
    seen: set[int] = set()
    for nid in sorted(union):
        for i in graph.node(nid).inputs:
            if i in union or i in seen:
                continue
            seen.add(i)
            cn = graph.node(i)
            if cn.kind is OpKind.CONST and cn.value is not None:
                _hash_const(h, i, cn.value)
    smem = sorted(union)
    apos = tuple(smem.index(a) for a in anchors)
    return (ctx.struct_key(union), tuple(params_fp), h.hexdigest(),
            override_fp(override), apos)


def _rebind_emitted(graph: Graph, ctx: CostContext, union: frozenset[int],
                    parts: tuple, template: Emitted,
                    template_seen: list[int]) -> Emitted | None:
    """Reuse a structurally identical compiled kernel for ``union``,
    routing arguments through the shared first-seen correspondence.
    Outputs are members in sorted order on both sides (positional)."""
    b = ctx.bounds(union)
    ext_ids = [i for i in b.inputs if graph.node(i).kind is not OpKind.CONST]
    out_ids = list(b.outputs)
    seen = _ext_seen_order(graph, union, set(ext_ids))
    if (len(seen) != len(template_seen)
            or len(ext_ids) != len(template.ext_ids)
            or len(out_ids) != len(template.out_ids)):
        return None
    t_slot = {e: s for s, e in enumerate(template_seen)}
    pos = {e: j for j, e in enumerate(ext_ids)}
    try:
        mapping = tuple(pos[seen[t_slot[e]]] for e in template.ext_ids)
    except (KeyError, IndexError):
        return None

    def rebound(device, *vals, _fn=template.fn, _m=mapping):
        return _fn(device, *(vals[i] for i in _m))

    return Emitted(rebound, template.kind, template.estimate, ext_ids,
                   out_ids, template.scratch_bytes,
                   template.scratch_naive_bytes, parts=parts,
                   hbm_saved=template.hbm_saved,
                   n_recomputed=template.n_recomputed,
                   recompute_bytes_freed=template.recompute_bytes_freed)


def _remap_override(over: dict, src_members: list[int],
                    dst_members: list[int]) -> dict:
    """Retarget a struct-shared schedule override to an isomorphic
    sibling.  The ``recompute`` flip set names node ids: it maps through
    the positional correspondence of the sorted member lists (equal
    ``struct_key``s imply equal id-offset sequences).  A broken
    correspondence drops the field (re-decided at emission), never a
    foreign-id pin."""
    out = dict(over)
    rec = out.get("recompute")
    if rec:
        pos = {nid: i for i, nid in enumerate(src_members)}
        try:
            out["recompute"] = sorted(dst_members[pos[int(r)]] for r in rec)
        except (KeyError, IndexError, ValueError):
            out.pop("recompute", None)
    return out


def _sched_of(est: KernelEstimate) -> dict:
    """Persistable schedule pin of an estimate (with the streaming tile
    and the stage-vs-recompute flip set)."""
    d: dict = {"schedule": est.schedule}
    if est.block_rows > 0:
        d["block_rows"] = est.block_rows
    if est.schedule == "streaming" and est.block_cols > 0:
        d["block_cols"] = est.block_cols
    if est.schedule == "onepass" and est.recompute_ids:
        d["recompute"] = sorted(est.recompute_ids)
    return d


def resolve_device(device) -> torch.device:
    """The entry points' device rule: CUDA unless the caller asks for the
    CPU; a CUDA device on a host without one is an error, never a
    silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass "
            "device='cpu' to run the plain versions on the CPU")
    return dev


class StitchedFunction:
    def __init__(self, fn: Callable, *, hw: Hardware = H100,
                 dispatch: str = "single", stitch_groups: bool = True,
                 device="cuda", plan_cache: str | None = None,
                 autotune: bool = False, use_remote_fusion: bool = True,
                 functional: bool = False):
        if dispatch not in ("single", "interpret"):
            raise ValueError(
                f"dispatch must be 'single' or 'interpret', got {dispatch!r}")
        self._fn = fn
        self._options = dict(hw=hw, dispatch=dispatch,
                             stitch_groups=stitch_groups, device=device,
                             plan_cache=plan_cache, autotune=autotune,
                             use_remote_fusion=use_remote_fusion)
        self._functional = functional
        self._autograd: DifferentiableStitched | None = None
        self._hw = hw
        self._dispatch = dispatch
        self._stitch_groups = stitch_groups
        self._autotune = autotune
        self._remote = use_remote_fusion
        self.device = resolve_device(device)
        self._plan_cache = (PlanCache(plan_cache) if plan_cache
                            else PlanCache.from_env())
        self._cache: dict[tuple, _Compiled] = {}

    def _check_devices(self, flat) -> None:
        for leaf in flat:
            if not isinstance(leaf, torch.Tensor):
                raise TypeError(f"stitched functions take tensors, got "
                                f"{type(leaf).__name__}")
            if leaf.device.type != self.device.type:
                raise ValueError(
                    f"input on {leaf.device}, but this stitched function "
                    f"runs on {self.device}")

    def _compile(self, args) -> tuple[_Compiled, list]:
        flat, in_spec = pytree.tree_flatten(args)
        self._check_devices(flat)
        key = (str(in_spec),) + tuple((tuple(a.shape), a.dtype)
                                      for a in flat)
        compiled = self._cache.get(key)
        if compiled is None:
            compiled = self._build(args)
            self._cache[key] = compiled
        return compiled, flat

    def _load_cached_plan(self, graph: Graph, sig: str
                          ) -> tuple[FusionPlan, list[dict], dict] | None:
        if self._plan_cache is None:
            return None
        entry = self._plan_cache.load(sig)
        if entry is None:
            return None
        decoded = entry_to_plan(entry, graph)
        if decoded is None:
            return None
        plan, overrides = decoded
        return plan, overrides, entry

    def _can_measure(self) -> bool:
        from .autotune import autotune_available

        return self._autotune and autotune_available(self.device)

    def _build(self, args) -> _Compiled:
        t0 = time.perf_counter()
        graph, out_spec = trace_with_tree(self._fn, *args,
                                          functional=self._functional)
        hw = self._hw
        ctx = CostContext(graph, hw)
        sig = graph_signature(graph, hw, remote_fusion=self._remote)
        can_measure = self._can_measure()
        tune_s = 0.0

        # persistent cache: an identical graph signature in any process
        # reuses the stored patterns, group composition and (measured)
        # schedules and skips exploration *and* stitching entirely.
        overrides: list[dict] = []
        entry: dict | None = None
        cached = self._load_cached_plan(graph, sig)
        autotuned = False
        if cached is not None:
            plan, overrides, entry = cached
        else:
            plan = make_plan(graph, hw, use_remote_fusion=self._remote,
                             ctx=ctx)
            if can_measure:
                from .autotune import tune_pattern

                # isomorphic patterns share one measured sweep; shared
                # pins are remapped to each sibling's node ids.
                t1 = time.perf_counter()
                tuned_by_struct: dict[tuple, tuple] = {}
                for pat in plan.patterns:
                    skey = ctx.struct_key(pat.members)
                    members = sorted(pat.members)
                    hit = tuned_by_struct.get(skey)
                    if hit is None:
                        over = tune_pattern(graph, pat.members, hw=hw,
                                            ctx=ctx, device=self.device) or {}
                        tuned_by_struct[skey] = (over, members)
                    else:
                        over = _remap_override(hit[0], hit[1], members)
                    overrides.append(over)
                autotuned = True
                tune_s += time.perf_counter() - t1
            if not overrides:
                overrides = [{} for _ in plan.patterns]

        # ---- stitch groups: compose patterns into megakernels -------------
        # The partition search ranks the top-k candidate partitions by
        # modeled gain; with measurement on, the candidates are raced on
        # the card and the measured winner is committed.  A cached entry
        # whose partition was measured already is trusted; a model-sourced
        # one degrades to re-measuring and is upgraded in place.
        stitch_stats = None
        partition_source = "model"
        partition_index = 0
        partition_candidates = 0
        race = None
        groups_from_cache = False
        if self._stitch_groups:
            loaded = (entry_to_groups(entry, plan, graph)
                      if entry is not None else None)
            cached_source = (entry_partition_source(entry)
                             if entry is not None else "model")
            if loaded is not None and (cached_source == "measured"
                                       or not can_measure):
                groups, group_overrides = loaded
                groups_from_cache = True
                partition_source = cached_source
                # a pre-anchor (v5) composition re-plans its anchors on
                # load (absorption is deterministic); the store below
                # rewrites the upgraded entry as v6.
                if anchor_enabled() and not any(g.anchors for g in groups):
                    a_groups, n_anch = absorb_anchors(
                        graph, [list(g.parts) for g in groups], ctx)
                    if n_anch:
                        over_by = {g.parts: o for g, o in
                                   zip(groups, group_overrides)}
                        groups = a_groups
                        group_overrides = [dict(over_by.get(g.parts, {}))
                                           for g in groups]
            else:
                # a model-sourced entry re-measures the *partition*, but
                # its group pins are reused for any winner group with the
                # same parts.
                loaded_over_by_parts: dict[tuple, dict] = {}
                if loaded is not None:
                    for lgrp, lover in zip(*loaded):
                        if lover:
                            loaded_over_by_parts[lgrp.parts] = lover
                result = search_groups(graph, plan, hw, ctx=ctx)
                stitch_stats = result.stats
                candidates = result.candidates
                partition_candidates = len(candidates)
                groups = result.groups
                if can_measure and len(candidates) > 1:
                    from .autotune import tune_partitions

                    t1 = time.perf_counter()
                    race = tune_partitions(
                        graph, [c.groups for c in candidates], hw=hw,
                        ctx=ctx, device=self.device)
                    tune_s += time.perf_counter() - t1
                    if race is not None:
                        # the race's family swaps screen partitions; the
                        # winner's pins come from the group sweep below
                        groups = candidates[race.index].groups
                        partition_source = "measured"
                        partition_index = race.index
                        autotuned = True
                # a lone candidate stays model-sourced: "measured" is
                # never stamped without a race
                group_overrides = [
                    dict(loaded_over_by_parts.get(grp.parts, {}))
                    for grp in groups]
        else:
            groups = [StitchGroup((p.members,)) for p in plan.patterns]
            group_overrides = [{} for _ in groups]

        # ---- measured group tuning ----------------------------------------
        # Stitched unions get their one-pass / streaming choice and tile
        # measured; a cache hit holding a measured pin (``tuned``) is
        # trusted, and a v2 entry arrives with its group schedules
        # dropped, so it re-tunes here.
        group_tuned = group_tuned_wins = 0
        tuned_fresh = False
        if can_measure and self._stitch_groups:
            from .autotune import tune_group

            group_tuned_by_struct: dict[tuple, tuple] = {}
            for gi, grp in enumerate(groups):
                if grp.anchors or not grp.stitched:
                    # anchored groups keep their kernel's fixed scheme;
                    # single patterns are tune_pattern's job
                    continue
                gover = group_overrides[gi]
                analytic = _sched_of(ctx.best(grp.members))
                if gover.get("tuned"):
                    group_tuned += 1
                    pin = {k: v for k, v in gover.items() if k != "tuned"}
                    group_tuned_wins += pin != analytic
                    continue
                skey = ctx.struct_key(grp.members)
                members = sorted(grp.members)
                hit = group_tuned_by_struct.get(skey)
                if hit is not None:
                    over = (_remap_override(hit[0], hit[1], members)
                            if hit[0] is not None else None)
                else:
                    t1 = time.perf_counter()
                    over = tune_group(graph, grp.parts, hw=hw, ctx=ctx,
                                      device=self.device)
                    tune_s += time.perf_counter() - t1
                    group_tuned_by_struct[skey] = (over, members)
                if over is None:
                    continue
                group_tuned += 1
                group_tuned_wins += over != analytic
                group_overrides[gi] = dict(over, tuned=True)
                tuned_fresh = True
            autotuned = True

        pat_over = {pat.members: over
                    for pat, over in zip(plan.patterns, overrides)}
        emit_cache: dict[tuple, tuple[Emitted, list[int]]] = {}
        emitted: list[Emitted] = []
        reused = 0
        for grp, gover in zip(groups, group_overrides):
            union = grp.members
            over = gover or (pat_over.get(grp.parts[0], {})
                             if len(grp.parts) == 1 else {})
            over = {k: v for k, v in over.items() if k != "tuned"}
            parts = tuple(tuple(sorted(p)) for p in grp.parts)
            ekey = _emit_signature(graph, ctx, union, over, grp.anchors)
            em = None
            hit = emit_cache.get(ekey)
            if hit is not None:
                em = _rebind_emitted(graph, ctx, union, parts, *hit)
                reused += em is not None
            if em is None:
                em = emit_group(graph, grp.parts, hw=hw, ctx=ctx,
                                anchors=grp.anchors,
                                schedule_override=over or None)
                emit_cache[ekey] = (em, _ext_seen_order(graph, union,
                                                        set(em.ext_ids)))
            emitted.append(em)
        schedule = _build_schedule(graph, emitted)

        cached_hit = cached is not None
        pc = self._plan_cache
        poisoned = pc is not None and sig in pc.poison
        store_fresh = pc is not None and not cached_hit and not poisoned
        # a hit whose entry lacked a usable groups section, was in an
        # older format, or whose groups were just measured for the first
        # time is written back, so later processes skip the work
        store_backfill = (pc is not None and cached_hit
                          and self._stitch_groups and not poisoned
                          and (not groups_from_cache or tuned_fresh
                               or (entry or {}).get("format")
                               != entry_format_for(groups)))
        if store_fresh or store_backfill:
            em_of_pattern = {em.parts[0]: em for em in emitted
                             if len(em.parts) == 1}
            schedules = []
            for pat, over in zip(plan.patterns, overrides):
                em = em_of_pattern.get(tuple(sorted(pat.members)))
                if em is not None:
                    schedules.append(_sched_of(em.estimate))
                elif over:
                    schedules.append(dict(over))
                else:
                    schedules.append(_sched_of(ctx.best(pat.members)))
            # groups persist only when the stitcher ran: a
            # stitch_groups=False run must not write its singletons
            groups_arg = groups if self._stitch_groups else None
            group_scheds = ([dict(gover) if gover.get("tuned")
                             else _sched_of(em.estimate)
                             for em, gover in zip(emitted, group_overrides)]
                            if self._stitch_groups else None)
            pc.store(sig, plan_to_entry(
                plan, schedules, sig, groups=groups_arg,
                group_schedules=group_scheds,
                partition_source=(partition_source if self._stitch_groups
                                  else None)))

        report = StitchReport(
            stats=plan_stats(graph, plan, ctx=ctx, groups=groups),
            n_generated=sum(1 for e in emitted if e.generated),
            n_packed=sum(1 for e in emitted if e.kind == "packed"),
            scratch_bytes=sum(e.scratch_bytes for e in emitted),
            scratch_naive_bytes=sum(e.scratch_naive_bytes for e in emitted),
            plan_time_s=time.perf_counter() - t0,
            patterns=[p.members for p in plan.patterns],
            dispatch=self._dispatch,
            schedules=[e.kind for e in emitted],
            groups=[g.parts for g in groups],
            n_groups=len(groups),
            n_stitched=sum(1 for g in groups if g.stitched),
            n_anchored=sum(1 for g in groups if g.anchors),
            stitched_hbm_bytes_saved=sum(e.hbm_saved for e in emitted),
            emission_reused=reused,
            beam_width=stitch_stats.beam_width if stitch_stats else 0,
            beam_states_explored=(stitch_stats.states_explored
                                  if stitch_stats else 0),
            partition_source=partition_source,
            partition_candidates=partition_candidates,
            partition_index=partition_index,
            n_recomputed=sum(e.n_recomputed for e in emitted),
            recompute_bytes_freed=sum(e.recompute_bytes_freed
                                      for e in emitted),
            caps_hit=dict(ctx.caps),
            plan_cache_hit=cached_hit,
            autotuned=autotuned,
            signature=sig,
            group_tuned=group_tuned,
            group_tuned_wins=group_tuned_wins,
            plan_cache_hits=pc.hits if pc is not None else 0,
            plan_cache_misses=pc.misses if pc is not None else 0,
            tune_s=tune_s,
            partition_branches=race.branches if race is not None else 0,
            partition_disqualified=(race.disqualified if race is not None
                                    else 0),
            partition_measured_s=(list(race.measured_s) if race is not None
                                  else []),
        )
        return _Compiled(graph, emitted, schedule, report, out_spec,
                         self._dispatch, self.device)

    @property
    def n_compiled(self) -> int:
        """Distinct signatures compiled so far."""
        return len(self._cache)

    @property
    def instances(self) -> list[_Compiled]:
        """The compiled instances so far, one a signature."""
        return list(self._cache.values())

    def reports(self) -> list[StitchReport]:
        """Reports of every compiled instance, in compile order (the
        scheduler sums plan-cache hits and misses from these)."""
        return [c.report for c in self._cache.values()]

    def __call__(self, *args):
        if (self.device.type == "cuda" and torch.is_grad_enabled()
                and any(isinstance(a, torch.Tensor) and a.requires_grad
                        for a in pytree.tree_leaves(args))):
            # as the reference's function differentiates under jax.grad:
            # the kernels forward, the stitched VJP backward
            if self._autograd is None:
                self._autograd = DifferentiableStitched(self._fn,
                                                        **self._options)
            return self._autograd(*args)
        compiled, flat = self._compile(args)
        return compiled(flat)

    def compiled(self, *args) -> _Compiled:
        """The compiled instance for these example args."""
        return self._compile(args)[0]

    def report(self, *args) -> StitchReport:
        return self._compile(args)[0].report


def _static_key(v) -> Any:
    """A non-tensor argument's part of a cache key."""
    try:
        hash(v)
        return (type(v).__name__, v)
    except TypeError:
        return (type(v).__name__, repr(v))


class _StitchedVJP(torch.autograd.Function):
    """One differentiable call: the forward runs the stitched kernels and
    saves the primal inputs (recompute-style, as the reference's
    ``custom_vjp``); the backward runs the stitched VJP
    (``DifferentiableStitched._backward``)."""

    @staticmethod
    def forward(ctx, owner, skey, out_spec, *tensors):
        outs = pytree.tree_leaves(owner._forward[skey](*tensors))
        ctx.owner, ctx.skey, ctx.out_spec = owner, skey, out_spec
        ctx.save_for_backward(*tensors)
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cts):
        grads = ctx.owner._backward(ctx.skey, ctx.out_spec, cts,
                                    ctx.saved_tensors)
        return (None, None, None, *grads)


class DifferentiableStitched:
    """``stitched_jit(fn, differentiable=True)``: a function whose
    outputs carry autograd's graph.  The forward is ``fn`` stitched (its
    kernels on the card); the backward is ``vjp_fn(ct, *primals)`` --
    ``torch.func.vjp(fn, *primals)`` applied to the cotangents -- traced
    functionalized and stitched too, one ``StitchedFunction`` a (shapes,
    dtypes, device) key (``bwd_cache``), the reference's ``bwd_cache``
    (``src/repro/core/stitch.py:1438-1460``): the paper's training
    support, where the backward graph is just another fusion-planned
    graph.  The backward keeps the forward's options (``plan_cache``,
    ``autotune``, ``stitch_groups``, ...).  Arguments are pytrees; the
    floating tensor leaves are differentiated, other tensor leaves are
    inputs without a gradient, and non-tensor leaves are baked into the
    traced function (one forward and backward a distinct value)."""

    def __init__(self, fn: Callable, **options):
        self._fn = fn
        self._options = options
        self.device = resolve_device(options.get("device", "cuda"))
        self._forward: dict[tuple, StitchedFunction] = {}
        self._tensor_fns: dict[tuple, Callable] = {}
        self.bwd_cache: dict[tuple, StitchedFunction] = {}

    def _split(self, args) -> tuple[tuple, list]:
        """(static key, tensor leaves); the tensor function of the key
        registered on first sight."""
        flat, spec = pytree.tree_flatten(args)
        pos = [i for i, a in enumerate(flat) if isinstance(a, torch.Tensor)]
        statics = {i: a for i, a in enumerate(flat)
                   if not isinstance(a, torch.Tensor)}
        skey = (str(spec), len(flat), tuple(
            (i, _static_key(a)) for i, a in sorted(statics.items())))
        if skey not in self._tensor_fns:
            fn, n = self._fn, len(flat)

            def tensor_fn(*tensors, _spec=spec, _pos=tuple(pos),
                          _statics=dict(statics)):
                leaves = [_statics.get(i) for i in range(n)]
                for i, t in zip(_pos, tensors):
                    leaves[i] = t
                return fn(*pytree.tree_unflatten(leaves, _spec))

            self._tensor_fns[skey] = tensor_fn
            self._forward[skey] = StitchedFunction(tensor_fn,
                                                   **self._options)
        return skey, [flat[i] for i in pos]

    def __call__(self, *args):
        skey, tensors = self._split(args)
        out_spec = self._forward[skey].compiled(*tensors).out_spec
        outs = _StitchedVJP.apply(self, skey, out_spec, *tensors)
        return pytree.tree_unflatten(list(outs), out_spec)

    def _backward(self, skey, out_spec, cts, primals) -> list:
        diff = [i for i, t in enumerate(primals) if t.is_floating_point()]
        key = (skey, tuple((tuple(t.shape), t.dtype) for t in primals),
               str(primals[0].device) if primals else "")
        sf = self.bwd_cache.get(key)
        if sf is None:
            tensor_fn = self._tensor_fns[skey]

            def vjp_fn(ct, *prims, _diff=tuple(diff)):
                def f(*d):
                    full = list(prims)
                    for i, t in zip(_diff, d):
                        full[i] = t
                    return tensor_fn(*full)

                _, pullback = torch.func.vjp(f, *[prims[i] for i in _diff])
                return pullback(ct)

            sf = StitchedFunction(vjp_fn, functional=True, **self._options)
            self.bwd_cache[key] = sf
        grads = sf(pytree.tree_unflatten(list(cts), out_spec), *primals)
        out: list = [None] * len(primals)
        for i, g in zip(diff, grads):
            out[i] = g
        return out

    def report(self, *args) -> StitchReport:
        """The forward's report at ``args``."""
        skey, tensors = self._split(args)
        return self._forward[skey].report(*tensors)

    def compiled(self, *args) -> _Compiled:
        """The forward's compiled instance at ``args``."""
        skey, tensors = self._split(args)
        return self._forward[skey].compiled(*tensors)

    def backward_reports(self) -> list[StitchReport]:
        """The reports of every compiled backward instance."""
        return [r for sf in self.bwd_cache.values() for r in sf.reports()]


def stitched_jit(fn: Callable, *, hw: Hardware = H100,
                 dispatch: str = "single", stitch_groups: bool = True,
                 device="cuda", plan_cache: str | None = None,
                 autotune: bool = False,
                 use_remote_fusion: bool = True,
                 differentiable: bool = False):
    """Wrap ``fn`` (a function of tensors, or pytrees of tensors) with the
    FusionStitching trace -> plan -> stitch -> emit pipeline.

    ``hw`` is the cost model's hardware preset (``H100`` by default;
    ``V5E`` plans exactly as the JAX package does, for a TPU's VMEM and
    with no register cap, so its kernels are for the CPU parity tests,
    not the card).  ``dispatch`` is
    ``"single"`` (the stitched schedule) or ``"interpret"`` (op-by-op
    plain replay).  ``stitch_groups=False`` emits one kernel per plan
    pattern.  ``device`` is where the function runs: CUDA unless the
    caller passes ``device="cpu"``; inputs must lie there.
    ``plan_cache`` names a persistent plan-cache directory (default
    ``$REPRO_PLAN_CACHE`` when set).  With ``autotune=True`` on the card
    (or under ``REPRO_AUTOTUNE=force``) the patterns' and stitched
    groups' schedules and the top-k partitions are measured instead of
    modeled, and the results land in the plan cache.
    ``use_remote_fusion=False`` turns off the planner's remote fusion.

    With ``differentiable=True`` the result is a ``DifferentiableStitched``:
    a ``torch.autograd.Function`` whose forward runs the stitched kernels
    and saves the primal inputs, and whose backward traces the VJP of
    ``fn`` (``torch.func.vjp``) and stitches it too, one stitched backward
    a (shapes, dtypes, device) key -- recompute-style, as the reference's
    ``custom_vjp``.  ``report`` is the forward's, ``backward_reports()``
    the backward functions'.  Without it, a call on the card whose inputs
    require grad (grad mode on) takes the same route, as the reference's
    function differentiates under ``jax.grad``; on the CPU the plain
    versions carry autograd's graph themselves.
    """
    options = dict(hw=hw, dispatch=dispatch, stitch_groups=stitch_groups,
                   device=device, plan_cache=plan_cache, autotune=autotune,
                   use_remote_fusion=use_remote_fusion)
    if differentiable:
        return DifferentiableStitched(fn, **options)
    return StitchedFunction(fn, **options)


def fusion_report(fn: Callable, *example_args, hw: Hardware = H100,
                  device="cuda") -> StitchReport:
    """Plan ``fn`` on example inputs and return the plan statistics."""
    return stitched_jit(fn, hw=hw, device=device).report(*example_args)
