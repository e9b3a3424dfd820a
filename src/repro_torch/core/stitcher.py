"""Cross-pattern stitch grouping (paper §4: the stitched megakernel).

``make_plan`` emits *patterns* -- convex fusible subgraphs bounded by the
explorer's ``MAX_PATTERN`` guardrail and priced by the fast
delta-evaluator.  Under per-pattern emission every pattern still lowers
to its own kernel, so values flowing between patterns
round-trip HBM and each pattern pays its own launch + pad/reshape
boundary -- the global-memory traffic and kernel-call overhead the
paper's stitching scheme exists to remove.

``search_groups`` is the pass between planning and emission that closes
that gap: it partitions the pattern chain (patterns in min-member order,
plus the fusible singleton ops sandwiched between them) into
``StitchGroup``s, each later emitted as ONE generated kernel executing its
member patterns back-to-back with inter-pattern values kept on chip.
Partitions are priced by ``cost_model.stitch_gain`` -- the accurate
latency evaluator, which captures exactly the trade the delta-evaluator
cannot: interface HBM bytes + launches saved vs. the VMEM pressure of
the union (a union that no longer fits one-pass residency falls to the
multi-phase streaming schedule; one with no feasible stitched schedule
is refused).  Groups may therefore exceed ``MAX_PATTERN``: stitching is
how the system composes beyond the planning guardrail.

The partition itself is found by a **beam search** over group
boundaries (default 4): each beam state is a
prefix partition of the chain, scored by its cumulative modeled latency
gain; at every pattern a state either extends its open group or closes
it.  Width 1 degenerates to the original greedy forward merge, which a
wider beam can only match or beat -- the chosen partition is compared
against the greedy one and the better (by total gain) is returned, so
beam results are never worse under the cost model.  All union pricing
goes through the ``CostContext`` memos (``stitch_gain`` keyed by the
parts tuple, ``info``/``bounds``/``best`` keyed by the union), so
repeated prefixes across beam states are priced once.  Chains are first
split into independent *segments* at structurally unmergeable
boundaries, and structurally isomorphic segments (repeated transformer
layers, recognized via ``CostContext.struct_key``) replay the first
instance's searched partition instead of re-searching.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

from .codegen import EMITTABLE_PRIMS, anchor_emittable, pattern_emittable
from .cost_model import H100, Hardware, anchor_enabled
from .costctx import CostContext
from .ir import FUSIBLE_KINDS, FusionPlan, Graph, OpKind, StitchGroup

#: Bound on the candidate partitions assembled from segment swaps: the
#: most a race measures (``autotune.MAX_PARTITION_BRANCHES``, defined here
#: so that the stitcher does not import the tuner).
MAX_PARTITION_BRANCHES = 32

#: Hard cap on stitched-union size (node count): VMEM scratch planning and
#: kernel emission stay tractable.  Groups are intended to exceed the
#: explorer's per-pattern bound, so this is several times MAX_PATTERN.
MAX_GROUP_NODES = 512

#: Env knob: beam width of the stitch-partition search (1 = greedy).
ENV_BEAM = "REPRO_STITCH_BEAM"

#: Default beam width when ``$REPRO_STITCH_BEAM`` is unset.
DEFAULT_BEAM_WIDTH = 4

#: Env knob: how many distinct top-ranked partitions ``search_groups``
#: retains for measured tuning (1 = the cost-model winner only).
ENV_TOPK = "REPRO_STITCH_TOPK"

#: Default top-k when ``$REPRO_STITCH_TOPK`` is unset.
DEFAULT_TOPK = 3


def beam_width_from_env() -> int:
    try:
        width = int(os.environ.get(ENV_BEAM, DEFAULT_BEAM_WIDTH))
    except ValueError:
        return DEFAULT_BEAM_WIDTH
    return max(1, width)


def topk_from_env() -> int:
    try:
        k = int(os.environ.get(ENV_TOPK, DEFAULT_TOPK))
    except ValueError:
        return DEFAULT_TOPK
    return max(1, k)


@dataclass
class StitchStats:
    """What the partition search did (surfaces in ``StitchReport``)."""

    beam_width: int = 1
    states_explored: int = 0     # successor states priced across segments
    segments: int = 0            # independent subchains searched
    segments_reused: int = 0     # isomorphic segments replaying a partition
    gain_s: float = 0.0          # total modeled latency gain of the result
    greedy_gain_s: float = 0.0   # what the width-1 (greedy) partition gains
    topk: int = 1                # how many candidates the search was asked for
    candidates: int = 1          # distinct candidate partitions retained
    pair_swaps: int = 0          # multi-segment (2-swap) candidates assembled


@dataclass
class PartitionCandidate:
    """One candidate partition of the pattern chain, ready for emission."""

    groups: list                 # list[StitchGroup]
    gain_s: float                # total modeled stitch gain of the partition
    scratch_bytes: int = 0       # staged VMEM bytes/row across stitched groups


@dataclass
class TopKResult:
    """Ranked distinct partitions from ``search_groups``.

    ``candidates[0]`` is the cost-model winner (the floor-compared
    partition previous revisions returned outright); the remainder are
    the next-best distinct partitions in descending modeled gain -- the
    measurement candidates a measured race would time (the port has no
    race yet: ``stitch`` commits ``candidates[0]``).  Unpacking as ``groups, stats = search_groups(...)`` keeps
    working: iteration yields the winning groups then the stats.
    """

    candidates: list[PartitionCandidate]
    stats: StitchStats

    @property
    def groups(self) -> list:
        return self.candidates[0].groups

    def __iter__(self):
        return iter((self.groups, self.stats))


def _absorbable(graph: Graph, nid: int, covered: set[int]) -> bool:
    """Can a leftover node ride along inside a stitched kernel?"""
    node = graph.node(nid)
    return (nid not in covered and node.kind in FUSIBLE_KINDS
            and node.prim in EMITTABLE_PRIMS)


def _convex_closure(graph: Graph, union: frozenset[int],
                    covered: set[int]) -> tuple[frozenset[int], list[int]] | None:
    """Close ``union`` under convexity by absorbing the violating nodes.

    The violating set (outside nodes that are both descendants and
    ancestors of members -- ``is_convex``'s mask test) is exactly the
    ops *sandwiched* between the parts.  Each must be an absorbable
    leftover singleton; anything else (an opaque op, a member of another
    pattern) makes the merge illegal.  Returns (closed union, absorbed
    node ids) or None.
    """
    desc, anc = graph.reachability()
    absorbed: list[int] = []
    for _ in range(len(graph)):  # absorbing can expose new violations
        pmask = d = a = 0
        for nid in union:
            pmask |= 1 << nid
            d |= desc[nid]
            a |= anc[nid]
        viol = d & a & ~pmask
        if not viol:
            return union, sorted(absorbed)
        new: list[int] = []
        while viol:
            lsb = viol & -viol
            nid = lsb.bit_length() - 1
            viol ^= lsb
            if not _absorbable(graph, nid, covered):
                return None
            new.append(nid)
        absorbed.extend(new)
        union = union | frozenset(new)
    return None


def _try_merge(graph: Graph, cur: list[frozenset[int]], pat: frozenset[int],
               ctx: CostContext, covered: set[int],
               require_gain: bool = True) -> list[frozenset[int]] | None:
    """Grow the current group by ``pat`` (+ sandwiched singletons); None if
    the union is non-convex, not row-consistent, or (``require_gain``)
    infeasible / not worth stitching.  The beam search passes
    ``require_gain=False`` so it can hold unions whose gain only turns
    positive -- or whose schedule only turns feasible -- after further
    growth (a combine stage can *shrink* the union's IO working set);
    such open groups score zero until they price well, and are split
    back into their parts if still unprofitable when the state closes.
    """
    union: frozenset[int] = pat
    for p in cur:
        union |= p
    if len(union) > MAX_GROUP_NODES:
        return None
    closed = _convex_closure(graph, union, covered)
    if closed is None:
        return None
    union, extras = closed
    if len(union) > MAX_GROUP_NODES:  # absorption must respect the cap too
        return None
    parts = sorted(cur + [frozenset({e}) for e in extras] + [pat], key=min)
    union = ctx.union_all(parts)  # register parts: incremental bounds
    info = ctx.info(union)
    if info is None or not pattern_emittable(graph, union, info=info):
        return None
    if require_gain:
        gain = ctx.stitch_gain(tuple(parts))
        if not gain.feasible or gain.latency_gain_s <= 0.0:
            return None
    return parts


def _pair_mergeable(graph: Graph, a: frozenset[int],
                    b: frozenset[int], ctx: CostContext) -> bool:
    """Could ``a`` and ``b`` ever share a group?  Structural tests only
    (convex closure, row view, emittable prims, size cap) -- all
    monotone under union growth, so a failing pair is a hard segment
    boundary no partition can cross.  The closure runs with an empty
    ``covered`` set: a sandwiched node belonging to another plan pattern
    is no obstacle (that pattern would simply join the group), only an
    opaque / non-emittable one is.  Gain is deliberately not tested: a
    pair whose union prices badly may still join a profitable wider
    group.
    """
    union = a | b
    if len(union) > MAX_GROUP_NODES:
        return False
    closed = _convex_closure(graph, union, set())
    if closed is None:
        return False
    union, _ = closed
    if len(union) > MAX_GROUP_NODES:
        return False
    info = ctx.info(union)
    return info is not None and pattern_emittable(graph, union, info=info)


@dataclass(frozen=True)
class _State:
    """One beam state: a prefix partition of the segment's chain."""

    closed: tuple            # closed groups, each a tuple of parts
    cur: tuple               # open group's parts ((): none yet)
    absorbed: frozenset      # leftover singletons absorbed by this state
    gain: float              # cumulative latency gain incl. the open group
    cur_gain: float          # the open group's share of ``gain``


def _state_rank_key(s: _State) -> tuple:
    """Total deterministic beam order: gain (descending), then the
    partition shape tuple (parts per group), then each group's first
    member.  Equal-score offers previously fell back to dict-insertion
    order, so the beam contents -- and therefore the chosen partition
    and its ``graph_signature``-keyed cache entry -- could differ
    between runs that merely discovered patterns in a different order.
    """
    shape = tuple(len(g) for g in s.closed) + ((len(s.cur),) if s.cur else ())
    firsts = tuple(min(p) for g in s.closed for p in g) \
        + tuple(min(p) for p in s.cur)
    return (-s.gain, shape, firsts)


def _partition_fp(groups) -> tuple:
    """Hashable identity of a partition (dedup across beam states)."""
    return tuple(tuple(tuple(sorted(p)) for p in g) for g in groups)


def _candidate_rank_key(cand: tuple) -> tuple:
    """Deterministic candidate order: gain desc, then shape, then ids."""
    groups, gain = cand
    shape = tuple(len(g) for g in groups)
    firsts = tuple(min(p) for g in groups for p in g)
    return (-gain, shape, firsts)


class _PartitionSearch:
    """Beam search over group-boundary partitions of one pattern chain.

    Shared across segments so extras absorbed by a committed partition
    stay unavailable to later segments (``self.absorbed``), and so the
    explored-state count aggregates.
    """

    def __init__(self, graph: Graph, ctx: CostContext,
                 base_covered: frozenset[int], width: int):
        self.graph = graph
        self.ctx = ctx
        self.base = base_covered          # every plan-pattern member
        self.width = width
        self.absorbed: set[int] = set()   # extras committed by prior segments
        self.states_explored = 0

    def _covered(self, extra: frozenset[int]) -> set[int]:
        return set(self.base) | self.absorbed | extra

    def _group_gain(self, parts: tuple) -> float:
        if len(parts) <= 1:
            return 0.0
        return self.ctx.stitch_gain(tuple(parts)).latency_gain_s

    def _group_score(self, parts: tuple) -> float:
        """Beam score of a (possibly open) group: its gain when it has a
        feasible stitched schedule, else 0 -- an infeasible open group
        is held optimistically (a later member may shrink its IO back
        into feasibility) but valued as if split back into its parts,
        which is exactly what ``_repair`` does if it never recovers."""
        if len(parts) <= 1:
            return 0.0
        g = self.ctx.stitch_gain(tuple(parts))
        return g.latency_gain_s if g.feasible else 0.0

    # -- width-1: the original greedy forward merge -------------------------
    def greedy(self, pats: list[frozenset[int]]
               ) -> tuple[list[tuple], float]:
        groups: list[tuple] = []
        cur: list[frozenset[int]] = []
        absorbed: frozenset[int] = frozenset()
        for pat in pats:
            if cur:
                self.states_explored += 1
                merged = _try_merge(self.graph, cur, pat, self.ctx,
                                    self._covered(absorbed))
                if merged is not None:
                    cur = merged
                    for p in merged:
                        absorbed = absorbed | (p - self.base)
                    continue
                groups.append(tuple(cur))
            cur = [pat]
        if cur:
            groups.append(tuple(cur))
        return groups, sum(self._group_gain(g) for g in groups)

    # -- width-N beam -------------------------------------------------------
    def beam(self, pats: list[frozenset[int]],
             pattern_set: set[frozenset[int]],
             keep: int = 1) -> list[tuple[list[tuple], float]]:
        """Beam-search the segment; return up to ``keep`` distinct
        repaired partitions ranked by ``_candidate_rank_key`` (gain
        descending with the deterministic shape tie-break)."""
        states = [_State((), (), frozenset(), 0.0, 0.0)]
        for pat in pats:
            nxt: dict[tuple, _State] = {}

            def offer(s: _State) -> None:
                self.states_explored += 1
                key = (s.cur, s.absorbed)
                old = nxt.get(key)
                if old is None or s.gain > old.gain or (
                        s.gain == old.gain
                        and _state_rank_key(s) < _state_rank_key(old)):
                    nxt[key] = s

            for s in states:
                # close the open group, start a new one at ``pat``
                closed = s.closed + ((s.cur,) if s.cur else ())
                offer(_State(closed, (pat,), s.absorbed, s.gain, 0.0))
                # extend the open group with ``pat``
                if s.cur:
                    merged = _try_merge(self.graph, list(s.cur), pat,
                                        self.ctx, self._covered(s.absorbed),
                                        require_gain=False)
                    if merged is not None:
                        cur = tuple(merged)
                        absorbed = s.absorbed
                        for p in merged:
                            absorbed = absorbed | (p - self.base)
                        g = self._group_score(cur)
                        offer(_State(s.closed, cur, absorbed,
                                     s.gain - s.cur_gain + g, g))
            states = sorted(nxt.values(), key=_state_rank_key)[:self.width]

        out: list[tuple[list[tuple], float]] = []
        seen: set[tuple] = set()
        for s in sorted(states, key=_state_rank_key):
            groups = list(s.closed) + ([s.cur] if s.cur else [])
            repaired, gain = self._repair(groups, pattern_set)
            fp = _partition_fp(repaired)
            if fp in seen:
                continue
            seen.add(fp)
            out.append((repaired, gain))
            if len(out) >= keep:
                break
        return sorted(out, key=_candidate_rank_key)

    def _repair(self, groups: list[tuple],
                pattern_set: set[frozenset[int]]
                ) -> tuple[list[tuple], float]:
        """Split any group whose final schedule is infeasible or whose
        gain is non-positive back into its pattern parts (the beam may
        pass through such unions hoping for later growth; keeping one
        would be worse than not stitching).  Absorbed extras of a split
        group return to the leftover pool.
        """
        out: list[tuple] = []
        total = 0.0
        for g in groups:
            if len(g) > 1:
                sg = self.ctx.stitch_gain(tuple(g))
                if not sg.feasible or sg.latency_gain_s <= 0.0:
                    out.extend((p,) for p in g if p in pattern_set)
                    continue
                total += sg.latency_gain_s
            out.append(tuple(g))
        return out, total

    # -- isomorphic-segment replay ------------------------------------------
    def apply_shape(self, pats: list[frozenset[int]],
                    shape: tuple[int, ...]) -> list[tuple] | None:
        """Re-apply a searched partition (runs of consecutive patterns per
        group) to an isomorphic segment; every merge is re-validated, so
        a mismatch (differing leftovers, infeasible union) degrades to a
        fresh search instead of a miscompile."""
        if sum(shape) != len(pats):
            return None
        groups: list[tuple] = []
        absorbed: frozenset[int] = frozenset()
        i = 0
        for run in shape:
            cur = [pats[i]]
            i += 1
            for _ in range(run - 1):
                self.states_explored += 1
                merged = _try_merge(self.graph, cur, pats[i], self.ctx,
                                    self._covered(absorbed),
                                    require_gain=False)
                if merged is None:
                    return None
                cur = merged
                for p in merged:
                    absorbed = absorbed | (p - self.base)
                i += 1
            if len(cur) > 1:
                sg = self.ctx.stitch_gain(tuple(cur))
                if not sg.feasible or sg.latency_gain_s <= 0.0:
                    return None  # not profitable here: search this segment
            groups.append(tuple(cur))
        return groups

    def commit(self, groups: list[tuple]) -> None:
        """Make a chosen partition's absorbed extras unavailable to later
        segments (mirrors the global ``covered`` of the greedy pass)."""
        for g in groups:
            for p in g:
                self.absorbed |= set(p) - self.base


def _shape_of(groups: list[tuple],
              pattern_set: set[frozenset[int]]) -> tuple[int, ...]:
    """Partition shape: patterns per group, in chain order (extras are
    instance-specific and re-absorbed on replay)."""
    return tuple(sum(1 for p in g if p in pattern_set) for g in groups)


def _segments(graph: Graph, pats: list[frozenset[int]],
              ctx: CostContext) -> list[list[frozenset[int]]]:
    """Split the chain at structurally unmergeable adjacent pairs."""
    segs: list[list[frozenset[int]]] = [[pats[0]]]
    for prev, pat in zip(pats, pats[1:]):
        if _pair_mergeable(graph, prev, pat, ctx):
            segs[-1].append(pat)
        else:
            segs.append([pat])
    return segs


def _absorb_leftovers(graph: Graph, groups: list[list[frozenset[int]]],
                      ctx: CostContext, covered: set[int]) -> None:
    """Fold leftover fusible singletons adjacent to a group into it.

    A leftover producer/consumer of a group member currently runs as a
    bare op in the dispatch schedule; riding along inside the stitched
    kernel removes its HBM round-trip for free when the union stays
    row-consistent and the latency evaluator agrees.
    """
    for nid in graph.topo_order():
        if not _absorbable(graph, nid, covered):
            continue
        node = graph.node(nid)
        for g in groups:
            members: frozenset[int] = frozenset()
            for p in g:
                members |= p
            touches = (any(c in members for c in graph.consumers(nid))
                       or any(i in members for i in node.inputs))
            if not touches:
                continue
            union = members | {nid}
            if len(union) > MAX_GROUP_NODES or not ctx.is_convex(union):
                continue
            info = ctx.info(union)
            if info is None or not pattern_emittable(graph, union, info=info):
                continue
            parts = sorted(g + [frozenset({nid})], key=min)
            gain = ctx.stitch_gain(tuple(parts))
            if gain.feasible and gain.latency_gain_s >= 0.0:
                g[:] = parts
                covered.add(nid)
                break


# ---------------------------------------------------------------------------
# compute-anchored absorption (fold groups into adjacent compute kernels)
# ---------------------------------------------------------------------------
def absorb_anchors(graph: Graph, groups: list[list[frozenset[int]]],
                   ctx: CostContext) -> tuple[list[StitchGroup], int]:
    """Open anchored stitch groups around compute ops.

    Walks every ``dot_general`` anchor in topo order and tries to fold
    the memory-stitched groups flanking it into the compute kernel's own
    grid: *prologue* groups whose every escaping value feeds only the
    anchor, and the *epilogue* group that solely consumes the anchor's
    result.  When the epilogue chain is a softmax tail whose output is
    itself consumed by a second ``dot_general`` (the flash-attention
    shape), both anchors and the chain fold into one attention kernel.

    Folding is committed only when ``codegen.anchor_emittable`` accepts
    the structure and ``cost_model.anchor_gain`` prices the interface
    saving as feasible (the device's own gate included) and strictly
    positive.  Returns the full group list (plain groups unchanged,
    folded ones replaced by anchored ``StitchGroup``s carrying their
    ``unanchored`` composition) plus the number of anchored groups.
    """
    outset = set(graph.outputs)
    owner: dict[int, int] = {}
    for gi, g in enumerate(groups):
        for p in g:
            for nid in p:
                owner[nid] = gi
    members_of = [frozenset().union(*g) if g else frozenset()
                  for g in groups]

    consumed: set[int] = set()       # group indices folded away
    used_anchor: set[int] = set()
    anchored: list[StitchGroup] = []

    def _sole_consumer_group(a: int) -> int | None:
        """The one group that consumes every use of ``a``, or None."""
        cons = graph.consumers(a)
        if not cons or a in outset:
            return None
        gis = {owner.get(c) for c in cons}
        if len(gis) != 1 or None in gis:
            return None
        gi = gis.pop()
        return None if gi in consumed else gi

    def _prologue_groups(a: int, taken: set[int]) -> list[int]:
        """Groups whose every escaping value feeds only the anchor."""
        pros: list[int] = []
        for i in graph.node(a).inputs:
            gi = owner.get(i)
            if gi is None or gi in consumed or gi in taken or gi in pros:
                continue
            mem = members_of[gi]
            ok = True
            for nid in mem:
                if nid in outset or any(
                        c not in mem and c != a
                        for c in graph.consumers(nid)):
                    ok = False
                    break
            if ok:
                pros.append(gi)
        return pros

    def _chain_feeds_anchor(gi: int) -> int | None:
        """If every escaping value of group ``gi`` feeds one fresh
        ``dot_general`` anchor, return that anchor id."""
        mem = members_of[gi]
        heads: set[int] = set()
        for nid in mem:
            if nid in outset:
                return None
            for c in graph.consumers(nid):
                if c not in mem:
                    heads.add(c)
        if len(heads) != 1:
            return None
        h = heads.pop()
        node = graph.node(h)
        if (node.kind is not OpKind.ANCHOR or node.prim != "dot_general"
                or h in used_anchor):
            return None
        return h

    for a in graph.topo_order():
        node = graph.node(a)
        if (node.kind is not OpKind.ANCHOR or node.prim != "dot_general"
                or a in used_anchor):
            continue
        epi = _sole_consumer_group(a)
        # candidate ladder: the two-anchor attention fold first (epilogue
        # chain consumed by a second dot_general), then the plain
        # single-anchor fold -- a chain feeding another matmul that is
        # *not* a softmax tail must still fold into its own anchor.
        attempts: list[tuple[list[int], list[int]]] = []
        if epi is not None:
            pv = _chain_feeds_anchor(epi)
            if pv is not None:
                attempts.append(([a, pv], [epi]))
            attempts.append(([a], [epi]))
        attempts.append(([a], []))
        for anchors, epi_fold in attempts:
            fold = list(epi_fold)
            fold.extend(_prologue_groups(a, set(fold)))
            if not fold:
                continue
            parts = sorted(
                [p for gi in fold for p in groups[gi]]
                + [frozenset({x}) for x in anchors], key=min)
            if not anchor_emittable(graph, tuple(parts),
                                    tuple(sorted(anchors))):
                continue
            gain = ctx.anchor_gain(tuple(sorted(anchors)),
                                   tuple(members_of[gi] for gi in fold))
            if not gain.feasible or gain.hbm_bytes_saved <= 0:
                continue
            sub = [(min(members_of[gi]), tuple(groups[gi])) for gi in fold] \
                + [(x, (frozenset({x}),)) for x in anchors]
            anchored.append(StitchGroup(
                tuple(parts),
                anchors=tuple(sorted(anchors)),
                unanchored=tuple(g for _, g in sorted(sub))))
            consumed.update(fold)
            used_anchor.update(anchors)
            break

    out: list[StitchGroup] = list(anchored)
    for gi, g in enumerate(groups):
        if gi not in consumed:
            out.append(StitchGroup(tuple(g)))
    out.sort(key=lambda sg: min(sg.members))
    return out, len(anchored)


def _candidate_scratch_bytes(graph: Graph, ctx: CostContext,
                             groups: list[tuple]) -> int:
    """Staged VMEM bytes/row a candidate partition would allocate.

    A union whose chosen schedule recomputes interface values (the
    thread-composition scheme) is priced by its post-flip footprint --
    candidates only feasible under recompute rank by what they would
    actually stage, not by the infeasible all-staged layout."""
    from .memory_planner import plan_partition_scratch

    def recompute_of(union: frozenset[int]):
        est = ctx.best(union)
        return est.recompute_ids if est.schedule == "onepass" else ()

    total = 0
    for sp in plan_partition_scratch(graph, groups, ctx.info, recompute_of):
        if sp is not None:
            total += sp.staged_bytes_per_row
    return total


def search_groups(graph: Graph, plan: FusionPlan, hw: Hardware = H100,
                  ctx: CostContext | None = None,
                  absorb_leftovers: bool = True,
                  beam_width: int | None = None,
                  topk: int | None = None) -> TopKResult:
    """Partition the plan's patterns into stitch groups; return the top-k
    distinct candidate partitions plus the search statistics.

    Patterns are walked in topological (min-member) order.  The chain is
    split into segments at structurally unmergeable boundaries; each
    segment's group partition is found by a ``beam_width``-wide beam
    search (default ``$REPRO_STITCH_BEAM`` / 4; width 1 reproduces the
    original greedy forward merge) and compared against the greedy
    partition, keeping the better by total modeled gain -- a wider beam
    is never worse under the cost model.  Segments isomorphic to an
    already-searched one (equal per-pattern ``struct_key`` sequences)
    replay its partition.  Unmerged patterns become singleton groups, so
    the result always covers every plan pattern exactly once.

    Beyond the winner, up to ``topk`` (``$REPRO_STITCH_TOPK``, default
    3) distinct runner-up partitions are retained: each segment's beam
    keeps its ranked end states, and global runners-up swap one
    segment's choice for its next-best alternative, ranked by modeled
    gain with the staged-VMEM footprint as the deterministic tie-break.
    ``autotune.tune_partitions`` races these candidates on the card
    instead of trusting the cost-model ranking.
    """
    if ctx is None:
        ctx = CostContext(graph, hw)
    width = max(1, int(beam_width if beam_width is not None
                       else beam_width_from_env()))
    k = max(1, int(topk if topk is not None else topk_from_env()))
    pats = sorted((p.members for p in plan.patterns), key=lambda m: min(m))
    stats = StitchStats(beam_width=width, topk=k)
    if not pats:
        return TopKResult([PartitionCandidate([], 0.0)], stats)

    base_covered: frozenset[int] = frozenset()
    for m in pats:
        base_covered |= m
    pattern_set = set(pats)
    search = _PartitionSearch(graph, ctx, base_covered, width)

    segs = _segments(graph, pats, ctx)
    stats.segments = len(segs)

    shape_memo: dict[tuple, tuple[int, ...]] = {}
    seg_choices: list[list[tuple[list[tuple], float]]] = []
    groups: list[list[frozenset[int]]] = []
    for seg in segs:
        seg_key = tuple(ctx.struct_key(p) for p in seg)
        replayed: list[tuple] | None = None
        if width > 1 and seg_key in shape_memo:
            replayed = search.apply_shape(seg, shape_memo[seg_key])
        # greedy always runs: it is the score floor (the chosen partition
        # is never worse, replayed or searched) and stats.greedy_gain_s
        # honestly reports what width-1 would have gained.
        greedy_groups, greedy_gain = search.greedy(seg)
        stats.greedy_gain_s += greedy_gain
        cands = [(greedy_groups, greedy_gain)]
        if replayed is not None:
            stats.segments_reused += 1
            replay_gain = sum(search._group_gain(g) for g in replayed)
            cands.append((replayed, replay_gain))
        elif width > 1:
            cands.extend(search.beam(seg, pattern_set, keep=k))
        # dedup + deterministic ranking (gain desc, then shape)
        ranked: list[tuple[list[tuple], float]] = []
        seen: set[tuple] = set()
        for cand in sorted(cands, key=_candidate_rank_key):
            fp = _partition_fp(cand[0])
            if fp not in seen:
                seen.add(fp)
                ranked.append(cand)
        chosen = ranked[0][0]
        if width > 1 and replayed is None:
            shape_memo[seg_key] = _shape_of(chosen, pattern_set)
        seg_choices.append(ranked[:k])
        search.commit(chosen)
        groups.extend(list(g) for g in chosen)

    stats.states_explored = search.states_explored
    stats.gain_s = sum(search._group_gain(tuple(g)) for g in groups)

    covered: set[int] = set()
    for g in groups:
        for p in g:
            covered |= p
    if absorb_leftovers:
        _absorb_leftovers(graph, groups, ctx, covered)

    best = PartitionCandidate(
        [StitchGroup(tuple(g)) for g in groups],
        ctx.partition_gain([tuple(g) for g in groups]),
        _candidate_scratch_bytes(graph, ctx, [tuple(g) for g in groups]))
    candidates = [best]
    if anchor_enabled():
        # compute-anchored variant: fold flanking groups into adjacent
        # dot_general kernels.  Put first when any fold commits -- it is
        # served by default, with the memory-only partition kept after it.
        a_groups, n_anch = absorb_anchors(graph, [list(g) for g in groups],
                                          ctx)
        if n_anch:
            extra = 0.0
            for g in a_groups:
                if not g.anchors:
                    continue
                folded = tuple(
                    frozenset(x for p in sub for x in p)
                    for sub in g.unanchored
                    if frozenset(x for p in sub for x in p)
                    - frozenset(g.anchors))
                extra += ctx.anchor_gain(g.anchors, folded).latency_gain_s
            candidates.insert(0, PartitionCandidate(
                a_groups, best.gain_s + extra, best.scratch_bytes))
    # global runners-up: swap one segment's choice for its next-ranked
    # alternative -- and, when several segments have alternatives,
    # combine the rank-1 swaps of two segments at once (multi-segment
    # swap candidates; single swaps cannot express a winner that needs
    # both segments changed).  The pair pool is bounded by the race's
    # ``MAX_PARTITION_BRANCHES`` so candidate assembly cannot outgrow
    # what the silicon sweep would ever measure.  A swap whose groups
    # would double-cover a node (alternatives absorbed different
    # leftovers than the committed partition) is skipped.  Valid swaps
    # are ranked by modeled gain (``CostContext.partition_gain``) with
    # the staged-VMEM footprint as the tie-break -- when two runners-up
    # price identically, the one pressuring VMEM less gets the silicon
    # slot -- and truncated to the k-1 measurement slots (logged via
    # ``ctx.note_cap``: no silent caps).
    def _assemble(choice_of: dict[int, int]) -> PartitionCandidate | None:
        alt_groups: list[tuple] = []
        for sj, other in enumerate(seg_choices):
            alt_groups.extend(
                tuple(g) for g in other[choice_of.get(sj, 0)][0])
        members = [n for g in alt_groups for p in g for n in p]
        if len(members) != len(set(members)):
            return None
        return PartitionCandidate(
            [StitchGroup(g) for g in alt_groups],
            ctx.partition_gain(alt_groups),
            _candidate_scratch_bytes(graph, ctx, alt_groups))

    alts: list[PartitionCandidate] = []
    for si, ranked in enumerate(seg_choices):
        for ai in range(1, len(ranked)):
            cand = _assemble({si: ai})
            if cand is not None:
                alts.append(cand)
    swappable = [si for si, ranked in enumerate(seg_choices)
                 if len(ranked) > 1]
    pairs = [(si, sj) for pi, si in enumerate(swappable)
             for sj in swappable[pi + 1:]]
    paired = 0
    for n_done, (si, sj) in enumerate(pairs):
        if len(alts) >= MAX_PARTITION_BRANCHES:
            ctx.note_cap("topk_pair_swaps", len(pairs) - n_done)
            break
        cand = _assemble({si: 1, sj: 1})
        if cand is not None:
            alts.append(cand)
            paired += 1
    alts.sort(key=lambda c: (
        -c.gain_s, c.scratch_bytes,
        tuple(tuple(tuple(sorted(p)) for p in g.parts) for g in c.groups)))
    ctx.note_cap("topk_candidates", len(alts) - (k - 1))
    candidates.extend(alts[:k - 1])
    stats.candidates = len(candidates)
    stats.pair_swaps = paired
    return TopKResult(candidates, stats)


def make_groups(graph: Graph, plan: FusionPlan, hw: Hardware = H100,
                ctx: CostContext | None = None,
                absorb_leftovers: bool = True,
                beam_width: int | None = None) -> list[StitchGroup]:
    """Partition the plan's patterns into stitch groups (compat wrapper
    around ``search_groups``, discarding the search statistics)."""
    return search_groups(graph, plan, hw, ctx=ctx,
                         absorb_leftovers=absorb_leftovers,
                         beam_width=beam_width).groups
