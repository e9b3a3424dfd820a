"""VMEM scratch planning via dominance-based slot sharing (paper §4.4).

The paper allocates GPU shared memory with a dominance-tree dataflow
analysis: walking ops in topological order, an op's request can reuse a
previously allocated slot iff the old value is dead (all of its consumers
are dominated by / ordered before the requester).  The scarce on-chip
resource ("VMEM" in the names below: the hardware preset's on-chip budget,
shared memory and registers on a GPU block); the stitched kernel's emission order is a fixed
topological linearization, on which the dominance condition degenerates to
a live-interval condition: slot S (last value v) is reusable at node x iff
every consumer of v precedes x in emission order.  We implement exactly
that check (not a heuristic) and additionally expose the dominator sets so
tests can verify legality independently.

Returned sizes are *bytes per block-row*; the codegen multiplies by the
chosen block row count BR.
"""
from __future__ import annotations

from dataclasses import dataclass

from .ir import Graph, OpKind
from .rowspec import RowInfo, role_bytes_per_row


@dataclass
class ScratchPlan:
    slot_of: dict[int, int]          # node id -> slot index
    slot_bytes: list[int]            # per-row bytes of each slot
    naive_bytes: int                 # sum of all requests (no sharing)

    @property
    def total_bytes(self) -> int:
        return sum(self.slot_bytes)

    @property
    def reuse_ratio(self) -> float:
        return self.total_bytes / self.naive_bytes if self.naive_bytes else 1.0


def plan_scratch(graph: Graph, pattern: frozenset[int], info: RowInfo,
                 order: list[int] | None = None,
                 recompute: frozenset[int] = frozenset()) -> ScratchPlan:
    """Assign VMEM scratch slots to pattern intermediates with reuse.

    ``order`` overrides the emission linearization (must be a topological
    order of ``pattern``); stitch groups pass the back-to-back member
    concatenation so liveness spans pattern boundaries.  Members in
    ``recompute`` (the thread-composition stitching scheme: the value is
    re-evaluated inside each consumer instead of staged) get no slot,
    and the liveness of the values they read is *extended* to the sites
    where the recomputed expression is actually evaluated -- the
    positions of its transitive non-recomputed consumers.
    """
    if order is None:
        order = sorted(pattern)
    pos = {nid: i for i, nid in enumerate(order)}
    outputs = set(graph.pattern_outputs(pattern))

    # positions where a recomputed value is materialized: every site its
    # inlined expression is (re)evaluated, i.e. its transitive non-
    # recomputed consumers' emission positions.
    mat_memo: dict[int, tuple[int, ...]] = {}

    def mat_positions(nid: int) -> tuple[int, ...]:
        if nid not in recompute:
            return (pos[nid],)
        got = mat_memo.get(nid)
        if got is None:
            sites: list[int] = []
            for c in graph.consumers(nid):
                if c in pattern:
                    sites.extend(mat_positions(c))
            got = tuple(sites)
            mat_memo[nid] = got
        return got

    # last use position of each member value (within the pattern)
    last_use: dict[int, int] = {}
    for nid in order:
        for i in graph.node(nid).inputs:
            if i in pattern:
                for p in mat_positions(nid):
                    last_use[i] = max(last_use.get(i, -1), p)
    for nid in outputs:
        last_use[nid] = len(order)  # outputs live to the end (written to HBM)

    slot_of: dict[int, int] = {}
    slot_bytes: list[int] = []
    slot_free_at: list[int] = []     # emission position after which slot is free
    naive = 0

    for nid in order:
        if nid in recompute:
            continue  # rematerialized per consumer: no slot at all
        node = graph.node(nid)
        need = role_bytes_per_row(info.role(nid), info.C, node.spec.itemsize)
        if need == 0 or node.kind in (OpKind.RESHAPE, OpKind.BROADCAST):
            continue  # aliases / per-col constants need no per-row scratch
        naive += need
        # dominance/liveness reuse: find a free slot large enough
        chosen = -1
        for s, free_at in enumerate(slot_free_at):
            if free_at <= pos[nid] and slot_bytes[s] >= need:
                chosen = s
                break
        if chosen < 0:
            # try growing a free slot instead of opening a new one
            for s, free_at in enumerate(slot_free_at):
                if free_at <= pos[nid]:
                    slot_bytes[s] = need
                    chosen = s
                    break
        if chosen < 0:
            slot_bytes.append(need)
            slot_free_at.append(-1)
            chosen = len(slot_bytes) - 1
        slot_of[nid] = chosen
        slot_free_at[chosen] = last_use.get(nid, pos[nid] + 1)

    return ScratchPlan(slot_of=slot_of, slot_bytes=slot_bytes, naive_bytes=naive)


# ---------------------------------------------------------------------------
# stage vs. recompute: the thread-composition stitching scheme (paper §4)
# ---------------------------------------------------------------------------
def recompute_extra_ops(graph: Graph, pattern: frozenset[int],
                        recompute: frozenset[int], op_cost) -> float:
    """Exact extra per-step compute of rematerializing ``recompute``.

    Mirrors the emitter: each *read* of a recomputed value r by a
    materialized consumer re-evaluates r's expression, recursively
    inlining inputs that are themselves recomputed.  So r is evaluated
    ``E(r) = sum over member consumers c of reads_c(r) * (E(c) if c is
    recomputed else 1)`` times instead of once; the extra cost is
    ``(E(r) - 1) * op_cost(r)`` summed over the flipped set.
    ``op_cost(nid)`` prices ONE evaluation of node ``nid`` per grid
    step (the caller closes over block dims and the VPU cost table).
    """
    evals: dict[int, int] = {}

    def E(r: int) -> int:
        got = evals.get(r)
        if got is None:
            total = 0
            for c in graph.consumers(r):
                if c not in pattern:
                    continue
                reads = sum(1 for i in graph.node(c).inputs if i == r)
                total += reads * (E(c) if c in recompute else 1)
            evals[r] = got = total
        return got

    return sum((E(r) - 1) * op_cost(r) for r in recompute if E(r) > 1)


@dataclass
class ReusePlan:
    """Per-value stage-vs-recompute decision for one kernel (paper §4's
    stitching-scheme tuning: shared-memory staging vs thread-composition
    recompute, chosen per interface value under the VMEM budget)."""

    recompute: frozenset[int]      # values rematerialized per consumer
    bytes_freed_per_row: int       # scratch bytes/row the flips elide
    extra_ops_per_step: float      # added VPU element-ops per grid step
    feasible: bool                 # working set fits VMEM after the flips

    @property
    def n_recomputed(self) -> int:
        return len(self.recompute)


#: Flip candidates are re-priced in windows of this size per greedy
#: round (each evaluation re-runs the slot allocator, and the widest
#: slots are ranked first); a round only advances to the next window
#: when the current one frees nothing, so no candidate is ever silently
#: skipped -- the window is a staging order, not a truncation.
MAX_REUSE_CANDIDATES_PER_ROUND = 16


def plan_reuse(graph: Graph, pattern: frozenset[int], info: RowInfo,
               vmem_bytes: int, *, block_rows: int, fixed_step_bytes: int,
               op_cost, candidates, order: list[int] | None = None
               ) -> ReusePlan:
    """Decide stage vs. recompute per staged value (paper §4).

    Starts all-staged and greedily flips *closure units* -- a value
    together with its legal member ancestors -- until the one-pass
    double-buffered working set ``2 * (fixed_step_bytes + scratch *
    block_rows)`` fits ``vmem_bytes``.  The unit matters: flipping a
    value alone extends its cone inputs' liveness to the flip's
    evaluation sites (often a net-zero slot saving), while flipping the
    whole closure rematerializes from kernel externals, which are
    VMEM-resident anyway.  Units are ranked by the freed-bytes-per-
    extra-op ratio; recompute FLOPs are free exactly when the kernel is
    memory-bound, so flips happen only to reach VMEM feasibility, never
    when staging already fits.  ``candidates`` maps each legal flip
    target to its ``recompute_cost`` cone price (ops/row; the caller
    screens legality via ``cost_model.recompute_cost``: not a reduce,
    not an output, cone free of reduce-level crossings) -- the cone
    price breaks ties in the per-round evaluation order, so of two
    equally wide slots the cheaper-to-rematerialize value is tried
    first.  ``op_cost(nid)`` prices one per-step evaluation of a node.
    """
    br = max(1, block_rows)
    chosen: frozenset[int] = frozenset()
    base = plan_scratch(graph, pattern, info, order=order)
    cur = base

    def working(plan: ScratchPlan) -> int:
        return fixed_step_bytes + plan.total_bytes * br

    cone_price = (candidates if isinstance(candidates, dict)
                  else {nid: 0.0 for nid in candidates})
    legal = frozenset(cone_price)
    _, anc = graph.reachability()
    pmask = 0
    for m in pattern:
        pmask |= 1 << m

    def unit(v: int) -> frozenset[int]:
        """v plus its legal member ancestors: the closure whose flip
        reads only externals (and staged illegal leaves) at the
        evaluation sites."""
        m = anc[v] & pmask
        out = {v}
        while m:
            lsb = m & -m
            a = lsb.bit_length() - 1
            m ^= lsb
            if a in legal:
                out.add(a)
        return frozenset(out)

    extra_ops = 0.0
    pool = sorted(
        (nid for nid in legal if nid in base.slot_of),
        key=lambda n: (-role_bytes_per_row(info.role(n), info.C,
                                           graph.node(n).spec.itemsize),
                       cone_price[n], n))
    while 2 * working(cur) > vmem_bytes and pool:
        best = None  # (ratio, nid, unit, plan, extra)
        for start in range(0, len(pool), MAX_REUSE_CANDIDATES_PER_ROUND):
            for nid in pool[start:start + MAX_REUSE_CANDIDATES_PER_ROUND]:
                trial = chosen | unit(nid)
                if trial == chosen:
                    continue
                plan = plan_scratch(graph, pattern, info, order=order,
                                    recompute=trial)
                freed = cur.total_bytes - plan.total_bytes
                if freed <= 0:
                    continue
                extra = recompute_extra_ops(graph, pattern, trial,
                                            op_cost) - extra_ops
                ratio = extra / freed
                if best is None or (ratio, nid) < (best[0], best[1]):
                    best = (ratio, nid, trial, plan, extra)
            if best is not None:
                break  # earliest productive window decides this round
        if best is None:
            break
        _, nid, trial, plan, extra = best
        chosen = trial
        cur = plan
        extra_ops += extra
        pool = [n for n in pool if n not in chosen]

    return ReusePlan(
        recompute=chosen,
        bytes_freed_per_row=base.total_bytes - cur.total_bytes,
        extra_ops_per_step=extra_ops,
        feasible=2 * working(cur) <= vmem_bytes,
    )


# ---------------------------------------------------------------------------
# stitch groups: scratch planning across pattern boundaries (paper §4)
# ---------------------------------------------------------------------------
@dataclass
class GroupScratchPlan(ScratchPlan):
    """A ``ScratchPlan`` over a whole stitch group.

    ``staged_ids`` are the inter-part interface values: produced by one
    member pattern, consumed by another, and internal to the group --
    exactly the tensors that round-trip HBM under per-pattern emission
    and stay in VMEM scratch inside the stitched megakernel.
    """

    staged_ids: tuple[int, ...] = ()
    staged_bytes_per_row: int = 0
    recomputed_ids: tuple[int, ...] = ()   # interface values inlined instead
    recompute_bytes_per_row: int = 0       # staged bytes those flips elide


def group_order(graph: Graph, parts) -> list[int]:
    """Back-to-back emission order of a group: members of each part in
    topological order, parts ordered by first member.  Keeping each
    part's values live over a contiguous range maximizes slot reuse
    between parts; when the concatenation would break a dependence (an
    interleaved part feeding an earlier part's tail) it falls back to
    the global topological order."""
    ordered = sorted((sorted(p) for p in parts), key=lambda p: p[0])
    cat = [nid for part in ordered for nid in part]
    union = set(cat)
    seen: set[int] = set()
    for nid in cat:
        if any(i in union and i not in seen for i in graph.node(nid).inputs):
            return sorted(cat)
        seen.add(nid)
    return cat


def plan_partition_scratch(graph: Graph, partition, info_of,
                           recompute_of=None
                           ) -> "list[GroupScratchPlan | None]":
    """Scratch plans for every group of one *candidate* partition.

    ``partition`` is a sequence of groups, each a sequence of member
    patterns; ``info_of`` maps a union frozenset to its ``RowInfo`` (or
    None -- e.g. ``CostContext.info``).  ``recompute_of`` (optional)
    maps a union to the recompute set its chosen schedule carries, so a
    candidate only feasible under thread-composition recompute is
    priced by its post-flip staged footprint.  The top-k partition
    tuner uses this to compare candidates by staged VMEM footprint
    before spending silicon time on them; a group with no row view maps
    to None (it would emit as a packed kernel with no explicit
    scratch).
    """
    plans: "list[GroupScratchPlan | None]" = []
    for parts in partition:
        parts_fs = tuple(frozenset(p) for p in parts)
        union: frozenset[int] = frozenset()
        for p in parts_fs:
            union |= p
        info = info_of(union)
        if info is None:
            plans.append(None)
            continue
        rec = frozenset(recompute_of(union)) if recompute_of else frozenset()
        plans.append(plan_group_scratch(graph, parts_fs, info, recompute=rec))
    return plans


def plan_group_scratch(graph: Graph, parts, info: RowInfo,
                       recompute: frozenset[int] = frozenset()
                       ) -> GroupScratchPlan:
    """``plan_scratch`` extended to span patterns: one allocation over the
    concatenated member order, plus the staged-interface accounting the
    stitch reports read.  Interface values in ``recompute`` are inlined
    into their consumers instead of staged: they get no slot and no
    explicit VMEM buffer, and the bytes they would have staged are
    reported as freed."""
    union: frozenset[int] = frozenset()
    for p in parts:
        union |= p
    order = group_order(graph, parts)
    base = plan_scratch(graph, union, info, order=order, recompute=recompute)

    # staged = interface values that are internal to the group: crossing
    # parts but with no reader outside (those are outputs: HBM anyway)
    outset = set(graph.outputs)
    staged: list[int] = []
    staged_bytes = 0
    recomputed: list[int] = []
    rec_bytes = 0
    for nid in graph.interface_values(parts):
        cons = graph.consumers(nid)
        if nid in outset or any(c not in union for c in cons):
            continue
        per_row = role_bytes_per_row(info.role(nid), info.C,
                                     graph.node(nid).spec.itemsize)
        if nid in recompute:
            recomputed.append(nid)
            rec_bytes += per_row
            continue
        staged.append(nid)
        staged_bytes += per_row
    return GroupScratchPlan(slot_of=base.slot_of, slot_bytes=base.slot_bytes,
                            naive_bytes=base.naive_bytes,
                            staged_ids=tuple(staged),
                            staged_bytes_per_row=staged_bytes,
                            recomputed_ids=tuple(recomputed),
                            recompute_bytes_per_row=rec_bytes)
