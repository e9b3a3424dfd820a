"""``stitched_jit`` -- the FusionStitching public API of the port.

Usage::

    fused = stitched_jit(layer_norm)        # trace -> plan -> stitch -> emit
    y = fused(x, gamma, beta)               # x, gamma, beta on the card

Pipeline: trace (``make_fx`` lowered to the reference vocabulary) -> plan
(``make_plan``) -> **stitch** (``stitcher.search_groups``: adjacent
row-compatible patterns and sandwiched singletons merge into stitch
groups, priced by the latency evaluator; the top-k partitions are kept
and the cost-model winner is committed -- there is no measured race yet)
-> emit (ONE generated Triton kernel per group; a group folded around a
compute anchor -- ``stitcher.absorb_anchors``, on by default as in the
reference, ``REPRO_ANCHOR=0`` turns it off -- becomes ONE anchored CUDA
kernel: the fused matmul B3 or flash attention with the score chain).
Structurally
isomorphic groups (repeated layers) are emitted once and rebound per
instance.  Plans are cached per shape/dtype signature in-process.

Dispatch:

* ``"single"`` runs the schedule -- generated kernels, packed subgraphs
  and the leftover single ops (matmuls among them) -- as eager launches
  on the call's device.  On CPU tensors each generated kernel runs its
  plain version; on CUDA tensors it launches or raises.
* ``"interpret"`` replays the traced graph op by op in plain PyTorch: the
  equivalence oracle.  The plan and report are built all the same.

A failed emission or launch raises: there is no fallback rung.
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
from .cost_model import H100, Hardware
from .ir import Graph, OpKind, StitchGroup
from .planner import PlanStats, make_plan, plan_stats
from .stitcher import search_groups
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
    partition_source: str = "model"
    partition_candidates: int = 0
    n_recomputed: int = 0
    recompute_bytes_freed: int = 0
    caps_hit: dict = field(default_factory=dict)

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
                    union: frozenset[int], anchors: tuple = ()) -> tuple:
    """Dedup key for emission: structural isomorphism + what the emitted
    kernel bakes in beyond the struct key (primitive params and constant
    values, member and external, and the anchors, positionally within
    the sorted members so isomorphic anchored layers still dedup)."""
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
    return (ctx.struct_key(union), tuple(params_fp), h.hexdigest(), apos)


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
                 device="cuda"):
        if dispatch not in ("single", "interpret"):
            raise ValueError(
                f"dispatch must be 'single' or 'interpret', got {dispatch!r}")
        self._fn = fn
        self._hw = hw
        self._dispatch = dispatch
        self._stitch_groups = stitch_groups
        self.device = resolve_device(device)
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

    def _build(self, args) -> _Compiled:
        t0 = time.perf_counter()
        graph, out_spec = trace_with_tree(self._fn, *args)
        hw = self._hw
        ctx = CostContext(graph, hw)
        plan = make_plan(graph, hw, ctx=ctx)
        stitch_stats = None
        candidates = 0
        if self._stitch_groups:
            result = search_groups(graph, plan, hw, ctx=ctx)
            stitch_stats = result.stats
            candidates = len(result.candidates)
            groups = result.groups
        else:
            groups = [StitchGroup((p.members,)) for p in plan.patterns]

        emit_cache: dict[tuple, tuple[Emitted, list[int]]] = {}
        emitted: list[Emitted] = []
        reused = 0
        for grp in groups:
            union = grp.members
            parts = tuple(tuple(sorted(p)) for p in grp.parts)
            ekey = _emit_signature(graph, ctx, union, grp.anchors)
            em = None
            hit = emit_cache.get(ekey)
            if hit is not None:
                em = _rebind_emitted(graph, ctx, union, parts, *hit)
                reused += em is not None
            if em is None:
                em = emit_group(graph, grp.parts, hw=hw, ctx=ctx,
                                anchors=grp.anchors)
                emit_cache[ekey] = (em, _ext_seen_order(graph, union,
                                                        set(em.ext_ids)))
            emitted.append(em)
        schedule = _build_schedule(graph, emitted)

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
            partition_candidates=candidates,
            n_recomputed=sum(e.n_recomputed for e in emitted),
            recompute_bytes_freed=sum(e.recompute_bytes_freed
                                      for e in emitted),
            caps_hit=dict(ctx.caps),
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

    def __call__(self, *args):
        compiled, flat = self._compile(args)
        return compiled(flat)

    def compiled(self, *args) -> _Compiled:
        """The compiled instance for these example args."""
        return self._compile(args)[0]

    def report(self, *args) -> StitchReport:
        return self._compile(args)[0].report


def stitched_jit(fn: Callable, *, hw: Hardware = H100,
                 dispatch: str = "single", stitch_groups: bool = True,
                 device="cuda") -> StitchedFunction:
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
    """
    return StitchedFunction(fn, hw=hw, dispatch=dispatch,
                            stitch_groups=stitch_groups, device=device)
