"""Fusion-plan composition: beam search over candidate patterns (paper §5.3)
plus remote fusion (paper §5, Fig. 5) and final latency-evaluator pick.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .costctx import CostContext
from .cost_model import H100, Hardware, best_estimate
from .explorer import FusionExplorer
from .ir import FUSIBLE_KINDS, FusionPlan, Graph, OpKind, Pattern

BEAM_WIDTH = 3  # paper: 3 buffer sets


@dataclass
class _Beam:
    patterns: list[Pattern] = field(default_factory=list)
    covered: frozenset[int] = frozenset()
    score: float = 0.0


def beam_search(graph: Graph, candidates: dict[int, list[Pattern]],
                width: int = BEAM_WIDTH) -> list[FusionPlan]:
    """Compose up to ``width`` disjoint-pattern plans (paper §5.3).

    Traverses producer -> consumer; appends each vertex candidate to each
    buffer set when non-overlapping; keeps the top ``width`` accumulated-f
    sets per step.
    """
    beams = [_Beam()]
    for vid in graph.topo_order():
        cands = candidates.get(vid)
        if not cands:
            continue
        grown: list[_Beam] = list(beams)  # skipping vid is always an option
        for beam in beams:
            if vid in beam.covered:
                continue
            for pat in cands:
                if len(pat.members) <= 1 or pat.overlaps(beam.covered):
                    continue
                grown.append(_Beam(beam.patterns + [pat],
                                   beam.covered | pat.members,
                                   beam.score + pat.score))
        # dedupe by covered-set signature, keep top-width
        uniq: dict[tuple, _Beam] = {}
        for b in sorted(grown, key=lambda b: -b.score):
            key = tuple(sorted(p.members for p in b.patterns))
            if key not in uniq:
                uniq[key] = b
            if len(uniq) >= width * 4:
                break
        beams = sorted(uniq.values(), key=lambda b: -b.score)[:width]

    return [FusionPlan(b.patterns, b.score) for b in beams]


def _leftover_singletons(graph: Graph, plan: FusionPlan) -> list[int]:
    covered = plan.covered()
    return [nid for nid in graph.topo_order()
            if graph.node(nid).kind in FUSIBLE_KINDS and nid not in covered]


def coalesce_plan(graph: Graph, plan: FusionPlan, hw: Hardware = H100,
                  max_rounds: int = 4,
                  ctx: CostContext | None = None) -> FusionPlan:
    """Greedy pairwise pattern merging after beam search.

    PatternReduction grows patterns from a producer toward consumers, so a
    side-input's producer chain (e.g. the scale/bias broadcasts feeding a
    LayerNorm epilogue) can land in a sibling pattern.  Merging two plan
    patterns is legal when their union is convex and closes no dependency
    cycle through the other patterns (``_closes_cycle``); we accept a
    merge when the delta-evaluator scores the union at least as well as
    the parts (the union also saves a launch, folded into the score).
    Leftover singletons adjacent to a pattern are absorbed the same way.

    Merges respect the explorer's ``MAX_PATTERN`` guardrail: a *pattern*
    stays small enough for the delta-evaluator's simplified VMEM model to
    be trusted.  Composing kernels beyond that bound is the stitcher's
    job (``stitcher.make_groups``), which prices unions with the accurate
    latency evaluator instead.
    """
    from .explorer import MAX_PATTERN

    if ctx is None:
        ctx = CostContext(graph, hw)

    # caps_hit dedup: a (singleton, pattern) absorb or pattern-pair merge
    # blocked by MAX_PATTERN is one lost exploration, however many rounds
    # re-scan it; successful placements and non-touching scans are not
    # truncations at all.
    absorb_blocked: set[tuple] = set()
    merge_blocked: set[tuple] = set()

    pats = [p.members for p in plan.patterns]
    for _ in range(max_rounds):
        changed = False
        # absorb leftover singleton producers/consumers
        tmp_plan = FusionPlan([Pattern(m, 0.0) for m in pats], 0.0)
        for nid in _leftover_singletons(graph, tmp_plan):
            for i, members in enumerate(pats):
                touches = (any(c in members for c in graph.consumers(nid))
                           or any(inp in members
                                  for inp in graph.node(nid).inputs))
                if not touches:
                    continue
                if len(members) >= MAX_PATTERN:
                    absorb_blocked.add((nid, members))
                    continue
                union = ctx.union(members, frozenset({nid}))
                if ctx.is_convex(union) and \
                        ctx.score(union) >= ctx.score(members) and \
                        not _closes_cycle(graph, union,
                                          pats[:i] + pats[i + 1:]):
                    pats[i] = union
                    changed = True
                    break
        # pairwise merges
        i = 0
        while i < len(pats):
            j = i + 1
            while j < len(pats):
                if len(pats[i]) + len(pats[j]) > MAX_PATTERN:
                    merge_blocked.add(frozenset((pats[i], pats[j])))
                    j += 1
                    continue
                union = ctx.union(pats[i], pats[j])
                if ctx.is_convex(union):
                    s_union = ctx.score(union)
                    s_parts = ctx.score(pats[i]) + ctx.score(pats[j])
                    others = pats[:i] + pats[i + 1:j] + pats[j + 1:]
                    if s_union >= s_parts and \
                            not _closes_cycle(graph, union, others):
                        pats[i] = union
                        pats.pop(j)
                        changed = True
                        continue
                j += 1
            i += 1
        if not changed:
            break

    # an absorb/merge a later round completed is not a truncation
    final = set(pats)
    ctx.note_cap("max_pattern_absorb",
                 sum(1 for nid, members in absorb_blocked
                     if not any(nid in p for p in final)))
    ctx.note_cap("max_pattern_merge",
                 sum(1 for pair in merge_blocked
                     if all(p in final for p in pair)))

    out = FusionPlan([Pattern(m, ctx.score(m)) for m in pats])
    out.total_score = sum(p.score for p in out.patterns)
    return out


def _closes_cycle(graph: Graph, members: frozenset[int],
                  groups: list[frozenset[int]]) -> bool:
    """Would one launch of ``members`` close a dependency cycle, inside
    (a path that leaves ``members`` and re-enters it: not convex) or
    through the other launch ``groups``?  Convex groups can still depend
    on each other (a -> b' and b -> a', with a, a' in one group and b, b'
    in the other).  So the outside nodes reachable from ``members`` grow
    by every group they touch, with all that the group feeds, until
    nothing changes; a cycle exists iff they meet an ancestor."""
    desc, anc = graph.reachability()
    pmask = d = a = 0
    for nid in members:
        pmask |= 1 << nid
        d |= desc[nid]
        a |= anc[nid]
    reach = d & ~pmask
    pending: list[tuple[int, int]] = []
    for grp in groups:
        gmask = gdesc = 0
        for nid in grp:
            gmask |= 1 << nid
            gdesc |= desc[nid]
        pending.append((gmask, gdesc))
    grew = True
    while grew and not reach & a:
        grew = False
        rest = []
        for gmask, gdesc in pending:
            if reach & gmask:
                reach |= (gmask | gdesc) & ~pmask
                grew = True
            else:
                rest.append((gmask, gdesc))
        pending = rest
    return bool(reach & a)


def remote_fusion(graph: Graph, plan: FusionPlan, hw: Hardware = H100,
                  max_pack: int = 8,
                  ctx: CostContext | None = None) -> FusionPlan:
    """Pack leftover non-adjacent kernels to cut launch count (paper Fig. 5).

    The paper introduces a virtual producer ``h`` over all pattern roots and
    re-runs PatternReduction; the effect is *kernel packing* of remote
    patterns.  We realize the same effect directly: leftover singletons are
    packed greedily into launch groups, as long as a group closes no
    dependency cycle with itself or with the plan's other launches.
    """
    if ctx is None:
        ctx = CostContext(graph, hw)
    singles = _leftover_singletons(graph, plan)
    launches = [p.members for p in plan.patterns]
    packed: list[Pattern] = []
    bucket: list[int] = []
    for nid in singles:
        trial = frozenset(bucket + [nid])
        if len(trial) <= max_pack and not _closes_cycle(graph, trial,
                                                        launches):
            bucket.append(nid)
        else:
            if len(bucket) > 1:
                packed.append(Pattern(frozenset(bucket), 0.0))
                launches.append(frozenset(bucket))
            bucket = [nid]
    if len(bucket) > 1:
        packed.append(Pattern(frozenset(bucket), 0.0))
    if not packed:
        return plan
    return FusionPlan(plan.patterns + packed, plan.total_score)


def plan_latency(graph: Graph, plan: FusionPlan, hw: Hardware = H100,
                 composition: str = "auto",
                 ctx: CostContext | None = None) -> float:
    """Accurate plan cost: latency-evaluator over patterns + leftovers.

    ``composition="thread"`` restricts every pattern to the packed
    (thread-local) schedule — the XLA baseline's capability envelope.
    """
    from .cost_model import estimate_packed

    total = 0.0
    for pat in plan.patterns:
        if composition == "thread":
            total += estimate_packed(graph, pat.members, hw,
                                     ctx=ctx).latency_s
        elif ctx is not None:
            total += ctx.best(pat.members).latency_s
        else:
            total += best_estimate(graph, pat.members, hw).latency_s
    for nid in _leftover_singletons(graph, plan):
        single = frozenset({nid})
        total += (ctx.best(single) if ctx is not None
                  else best_estimate(graph, single, hw)).latency_s
    return total


def make_plan(graph: Graph, hw: Hardware = H100,
              use_remote_fusion: bool = True,
              ctx: CostContext | None = None) -> FusionPlan:
    """explore -> beam-search -> latency pick -> remote fusion.

    All stages share one ``CostContext``, so every pattern's rowspec
    analysis, boundary sets, delta score and latency estimate are
    computed at most once per graph.
    """
    if ctx is None:
        ctx = CostContext(graph, hw)
    explorer = FusionExplorer(graph, hw, ctx=ctx)
    candidates = explorer.explore()
    plans = beam_search(graph, candidates)
    if not plans:
        plans = [FusionPlan()]
    best = min(plans, key=lambda p: plan_latency(graph, p, hw, ctx=ctx))
    assert best.validate_disjoint(), "planner produced overlapping patterns"
    best = coalesce_plan(graph, best, hw, ctx=ctx)
    assert best.validate_disjoint()
    if use_remote_fusion:
        best = remote_fusion(graph, best, hw, ctx=ctx)
        assert best.validate_disjoint()
    return best


# ---------------------------------------------------------------------------
# plan statistics (feeds the Table-2-style benchmarks)
# ---------------------------------------------------------------------------
@dataclass
class PlanStats:
    n_nodes: int
    n_fusible: int
    n_patterns: int
    n_kernels_stitched: int     # launches under this plan
    n_kernels_unfused: int      # launches op-by-op (TF analogue)
    hbm_bytes_stitched: int
    hbm_bytes_unfused: int
    #: guardrail -> how often it truncated exploration (``MAX_PATTERN``
    #: merges refused, top-k candidate lists cut, partition-race branch
    #: caps...).  "No silent caps": an empty dict means every search ran
    #: to completion.
    caps_hit: dict = field(default_factory=dict)

    @property
    def kernel_reduction(self) -> float:
        return self.n_kernels_stitched / max(1, self.n_kernels_unfused)

    @property
    def traffic_reduction(self) -> float:
        return self.hbm_bytes_stitched / max(1, self.hbm_bytes_unfused)


def plan_stats(graph: Graph, plan: FusionPlan,
               composition: str = "auto",
               ctx: CostContext | None = None,
               groups: "list | None" = None) -> PlanStats:
    """Plan metrics.  ``composition`` sets the reuse accounting:
      "auto"   -- per-pattern best schedule (block composition when the
                  row view exists, thread-composition packing otherwise),
      "thread" -- XLA-style thread-local reuse only (same-index chains
                  stay in registers; cross-parallelism intermediates
                  spill half the time): used for the XLA baseline rows.

    With ``groups`` (a list of ``StitchGroup``) the launch/traffic
    accounting is per stitched megakernel instead of per pattern:
    ``n_patterns`` still reports the plan's granularity, while kernel
    counts and HBM bytes reflect group execution.
    """
    from .cost_model import best_estimate

    fusible = graph.fusible_nodes()
    covered = plan.covered()
    if groups is not None:
        for g in groups:
            covered = covered | g.members
    leftovers = [n for n in fusible if n not in covered]
    opaque = [n for n in graph.nodes if graph.node(n).kind is OpKind.OPAQUE
              and graph.node(n).prim != "tuple_get"]
    # compute anchors launch standalone like opaque ops *unless* an
    # anchored group folded them into its own kernel (they are then
    # covered and already counted by that group's unit).  The unfused
    # baseline always counts them: it predates anchoring by definition.
    anchors_all = [n for n in graph.nodes
                   if graph.node(n).kind is OpKind.ANCHOR]
    free_anchors = [n for n in anchors_all if n not in covered]

    units = ([g.members for g in groups] if groups is not None
             else [p.members for p in plan.patterns])
    hbm_st = 0
    for members in units:
        if composition == "thread":
            hbm_st += (graph.pattern_hbm_bytes(members)
                       + graph.internal_bytes(members) // 2)
        elif ctx is not None:
            hbm_st += ctx.best(members).hbm_bytes
        else:
            hbm_st += best_estimate(graph, members).hbm_bytes
    for nid in leftovers + opaque + free_anchors:
        hbm_st += graph.unfused_hbm_bytes(frozenset({nid}))

    hbm_un = sum(graph.unfused_hbm_bytes(frozenset({n}))
                 for n in fusible + opaque + anchors_all)

    return PlanStats(
        n_nodes=len(graph),
        n_fusible=len(fusible),
        n_patterns=len(plan.patterns),
        n_kernels_stitched=(len(units) + len(leftovers) + len(opaque)
                            + len(free_anchors)),
        n_kernels_unfused=len(fusible) + len(opaque) + len(anchors_all),
        hbm_bytes_stitched=hbm_st,
        hbm_bytes_unfused=hbm_un,
        caps_hit=dict(getattr(ctx, "caps", {}) or {}),
    )
