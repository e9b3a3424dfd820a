"""Per-graph cost-model context: the planner's memoization layer.

The explorer / beam search / coalesce pipeline scores thousands of
overlapping candidate patterns per graph, and the seed recomputed rowspec
``analyze()``, pattern boundary sets and delta scores from scratch for
every one of them.  ``CostContext`` makes each of those a
compute-once-per-pattern lookup, shared by every planner stage working on
one graph:

  * ``info(P)``     -- memoized ``rowspec.analyze`` result (or None),
  * ``bounds(P)``   -- memoized external inputs / outputs / internal
                       members; ``union(A, B)`` builds a union pattern's
                       bounds *incrementally* from its parts (only the
                       parts' boundary nodes can change state, so the
                       update is O(boundary), not O(|P| * consumers)),
  * ``score(P)``    -- memoized delta-evaluator f(P),
  * ``best(P)``     -- memoized latency-evaluator schedule pick,
  * ``is_convex(P)``-- the Graph's bitset reachability mask test.
"""
from __future__ import annotations

from dataclasses import dataclass

from .ir import Graph
from .rowspec import RowInfo, analyze


@dataclass(frozen=True)
class PatternBounds:
    """Boundary sets of one candidate pattern (all id-sorted tuples)."""

    inputs: tuple[int, ...]    # external values the pattern reads
    outputs: tuple[int, ...]   # members consumed outside (or graph outputs)
    internal: tuple[int, ...]  # members every consumer of which is inside

    @classmethod
    def compute(cls, graph: Graph, pattern: frozenset[int],
                outset: frozenset[int]) -> "PatternBounds":
        ins: set[int] = set()
        outs: list[int] = []
        internal: list[int] = []
        for nid in pattern:
            for i in graph.node(nid).inputs:
                if i not in pattern:
                    ins.add(i)
            cons = graph.consumers(nid)
            if nid in outset or any(c not in pattern for c in cons):
                outs.append(nid)
            elif cons:
                internal.append(nid)
            # else: dead member (no consumers, not a graph output) --
            # neither an output nor an HBM-saving internal value.
        return cls(tuple(sorted(ins)), tuple(sorted(outs)),
                   tuple(sorted(internal)))


class CostContext:
    """Memoized cost-model queries for one graph + hardware config."""

    def __init__(self, graph: Graph, hw=None):
        from .cost_model import H100

        self.graph = graph
        self.hw = hw if hw is not None else H100
        self.outset = frozenset(graph.outputs)
        self._info: dict[frozenset[int], RowInfo | None] = {}
        self._bounds: dict[frozenset[int], PatternBounds] = {}
        self._parts: dict[frozenset[int], tuple] = {}  # union -> (a, b)
        self._score: dict[frozenset[int], float] = {}
        self._best: dict[frozenset[int], object] = {}
        self._scratch: dict[frozenset[int], object] = {}
        self._roles: dict[tuple, object] = {}  # (nid, R, C) -> Role | None
        self._score_by_struct: dict[tuple, float] = {}
        self._nsig: dict[int, int] = {}       # nid -> interned static sig id
        self._sig_intern: dict[tuple, int] = {}
        self._convex: dict[frozenset[int], bool] = {}
        self._stitch_gain: dict[tuple, object] = {}  # parts tuple -> StitchGain
        self._partition_gain: dict[tuple, float] = {}  # partition fp -> gain
        self._anchor_gain: dict[tuple, object] = {}  # (anchors, parts) -> AnchorGain
        self._recompute_cost: dict[tuple, object] = {}  # (pattern, nid)
        self._reuse: dict[tuple, object] = {}  # (pattern, br) -> ReusePlan|None
        #: search/planner cap hits ("no silent caps"): name -> count of
        #: explorations a guardrail truncated.  Surfaces in
        #: ``PlanStats.caps_hit`` via ``planner.plan_stats``.
        self.caps: dict[str, int] = {}

    def note_cap(self, name: str, n: int = 1) -> None:
        """Record that a cap/guardrail truncated exploration ``n`` times."""
        if n > 0:
            self.caps[name] = self.caps.get(name, 0) + n

    # -- structural queries --------------------------------------------------
    def is_convex(self, pattern: frozenset[int]) -> bool:
        got = self._convex.get(pattern)
        if got is None:
            got = self.graph.is_convex(pattern)
            self._convex[pattern] = got
        return got

    def info(self, pattern: frozenset[int]) -> RowInfo | None:
        got = self._info.get(pattern, _MISSING)
        if got is _MISSING:
            got = analyze(self.graph, pattern,
                          ext=self.bounds(pattern).inputs,
                          role_cache=self._roles)
            self._info[pattern] = got
        return got

    def scratch(self, pattern: frozenset[int], info: RowInfo,
                recompute: frozenset[int] = frozenset()):
        """Memoized VMEM scratch plan (independent of the block-row sweep;
        keyed by the stage-vs-recompute flip set)."""
        key = (pattern, recompute)
        got = self._scratch.get(key)
        if got is None:
            from .memory_planner import plan_scratch

            got = plan_scratch(self.graph, pattern, info,
                               recompute=recompute)
            self._scratch[key] = got
        return got

    def recompute_cost(self, pattern: frozenset[int], nid: int):
        """Memoized ``cost_model.recompute_cost`` (cone + legality)."""
        key = (pattern, nid)
        got = self._recompute_cost.get(key)
        if got is None:
            from .cost_model import recompute_cost

            got = recompute_cost(self.graph, pattern, nid,
                                 self.info(pattern),
                                 outputs=self.bounds(pattern).outputs,
                                 hw=self.hw)
            self._recompute_cost[key] = got
        return got

    def reuse(self, pattern: frozenset[int], block_rows: int):
        """Memoized stage-vs-recompute decision (``cost_model.reuse_plan``)."""
        key = (pattern, block_rows)
        got = self._reuse.get(key, _MISSING)
        if got is _MISSING:
            from .cost_model import reuse_plan

            info = self.info(pattern)
            got = (reuse_plan(self.graph, pattern, info, block_rows,
                              self.hw, ctx=self)
                   if info is not None else None)
            self._reuse[key] = got
        return got

    def bounds(self, pattern: frozenset[int]) -> PatternBounds:
        got = self._bounds.get(pattern)
        if got is None:
            parts = self._parts.pop(pattern, None)
            if parts is not None:
                got = self._union_bounds(pattern, *parts)
            else:
                got = PatternBounds.compute(self.graph, pattern, self.outset)
            self._bounds[pattern] = got
        return got

    def union(self, a: frozenset[int], b: frozenset[int]) -> frozenset[int]:
        """Union two patterns, remembering the parts so the union's bounds
        can later be derived incrementally (lazily: most candidate unions
        are discarded as non-convex / low-score before ever being
        scored, so no boundary work happens here)."""
        u = a | b
        if u not in self._bounds and u not in self._parts:
            self._parts[u] = (a, b)
        return u

    def union_all(self, parts) -> frozenset[int]:
        """Left-fold ``union`` over a parts sequence, registering every
        prefix so a stitched union's bounds derive incrementally from
        its (already-memoized) parts -- the beam search re-prices
        overlapping prefixes of the same group constantly, and this
        turns each re-price into O(boundary) instead of O(|union|)."""
        it = iter(parts)
        u = next(it)
        for p in it:
            u = self.union(u, p)
        return u

    def _union_bounds(self, u: frozenset[int], a: frozenset[int],
                      b: frozenset[int]) -> PatternBounds:
        """Union bounds from the parts' bounds: only the parts' boundary
        nodes can change classification (an external input may become a
        member, an output may become internal; internal stays internal)."""
        ba, bb = self.bounds(a), self.bounds(b)
        graph, outset = self.graph, self.outset
        ins = {i for i in ba.inputs + bb.inputs if i not in u}
        outs: set[int] = set()
        # parts may overlap (explorer unions share the producer), so
        # classify through sets: internal-in-either stays internal.
        internal = set(ba.internal) | set(bb.internal)
        for nid in set(ba.outputs) | set(bb.outputs):
            if nid in internal:
                continue
            cons = graph.consumers(nid)
            if nid in outset or any(c not in u for c in cons):
                outs.add(nid)
            elif cons:
                internal.add(nid)
        return PatternBounds(tuple(sorted(ins)), tuple(sorted(outs)),
                             tuple(sorted(internal)))

    # -- derived byte counts --------------------------------------------------
    def internal_bytes(self, pattern: frozenset[int]) -> int:
        graph = self.graph
        return sum(graph.node(n).nbytes for n in self.bounds(pattern).internal)

    def hbm_bytes(self, pattern: frozenset[int]) -> int:
        """External reads + writes of the fused kernel (CONSTs >128 elts)."""
        from .ir import OpKind

        graph = self.graph
        b = self.bounds(pattern)
        rd = sum(graph.node(i).nbytes for i in b.inputs
                 if graph.node(i).kind is not OpKind.CONST
                 or graph.node(i).spec.size > 128)
        wr = sum(graph.node(o).nbytes for o in b.outputs)
        return rd + wr

    # -- cost-model entries ---------------------------------------------------
    def _node_sig(self, nid: int) -> int:
        """Interned id of a node's pattern-independent signature."""
        got = self._nsig.get(nid)
        if got is None:
            n = self.graph.nodes[nid]
            from .ir import OpKind

            raw = (n.prim, n.spec.shape, n.spec.dtype,
                   tuple(n.params["axes"]) if "axes" in n.params else None,
                   n.kind is OpKind.CONST, nid in self.outset,
                   len(self.graph.consumers(nid)))
            got = self._sig_intern.setdefault(raw, len(self._sig_intern))
            self._nsig[nid] = got
        return got

    def struct_key(self, pattern: frozenset[int]) -> tuple:
        """Translation-invariant structural signature of a pattern.

        Two patterns with equal keys (same prims/shapes/dtypes/params,
        same internal wiring, same boundary fan-in/fan-out counts) have
        identical delta scores, so candidates in repeated transformer
        blocks are scored once per unique structure instead of once per
        instance.  One pass over the pattern's edges: members are
        referenced by id offset from the pattern base (>= 0), external
        inputs by first-seen local index (< 0); the trailer records each
        external's interned signature + in-pattern read count and each
        member's inside-consumer count.
        """
        nodes = self.graph.nodes
        nsig = self._node_sig
        members = sorted(pattern)
        base = members[0]
        inside_count: dict[int, int] = {}
        ext_local: dict[int, int] = {}
        ext_count: dict[int, int] = {}
        # flat all-int key (separator -(1<<40) delimits member rows):
        # hashing/equality on a flat int tuple is much cheaper than on
        # nested tuples of strings in this hot path.
        sep = -(1 << 40)
        parts: list[int] = []
        for nid in members:
            parts.append(sep)
            parts.append(nsig(nid))
            parts.append(nid - base)
            for i in nodes[nid].inputs:
                if i in pattern:
                    inside_count[i] = inside_count.get(i, 0) + 1
                    parts.append(i - base)
                else:
                    loc = ext_local.setdefault(i, len(ext_local))
                    ext_count[i] = ext_count.get(i, 0) + 1
                    parts.append(-1 - loc)
        parts.append(sep)
        for i in ext_local:
            parts.append(nsig(i))
            parts.append(ext_count[i])
        parts.append(sep)
        for nid in members:
            parts.append(inside_count.get(nid, 0))
        return tuple(parts)

    def score(self, pattern: frozenset[int]) -> float:
        got = self._score.get(pattern)
        if got is None:
            key = self.struct_key(pattern)
            got = self._score_by_struct.get(key)
            if got is None:
                from .cost_model import delta_evaluator

                got = delta_evaluator(self.graph, pattern, self.hw,
                                      ctx=self)
                self._score_by_struct[key] = got
            self._score[pattern] = got
        return got

    def best(self, pattern: frozenset[int]):
        got = self._best.get(pattern)
        if got is None:
            from .cost_model import best_estimate

            got = best_estimate(self.graph, pattern, self.hw, ctx=self)
            self._best[pattern] = got
        return got

    def stitch_gain(self, parts: tuple):
        """Memoized cross-pattern stitch pricing (``cost_model.stitch_gain``).

        The stitcher's greedy growth re-prices overlapping prefixes of
        the same group; per-part estimates are already memoized via
        ``best``/``hbm_bytes``, this memoizes the combination."""
        key = tuple(parts)
        got = self._stitch_gain.get(key)
        if got is None:
            from .cost_model import stitch_gain

            got = stitch_gain(self.graph, key, self.hw, ctx=self)
            self._stitch_gain[key] = got
        return got

    def partition_gain(self, partition) -> float:
        """Memoized whole-partition gain (``cost_model.partition_gain``).

        The top-k search re-ranks overlapping candidate partitions (the
        winner plus its single-segment swaps share most groups); the
        per-group gains are memoized via ``stitch_gain``, this memoizes
        the candidate-level sum keyed by the partition fingerprint."""
        key = tuple(tuple(frozenset(p) for p in g) for g in partition)
        got = self._partition_gain.get(key)
        if got is None:
            from .cost_model import partition_gain

            got = partition_gain(self.graph, key, self.hw, ctx=self)
            self._partition_gain[key] = got
        return got

    def anchor_gain(self, anchors: tuple, parts: tuple):
        """Memoized compute-anchor pricing (``cost_model.anchor_gain``)."""
        key = (tuple(anchors), tuple(parts))
        got = self._anchor_gain.get(key)
        if got is None:
            from .cost_model import anchor_gain

            got = anchor_gain(self.graph, key[0], key[1], self.hw, ctx=self)
            self._anchor_gain[key] = got
        return got


_MISSING = object()
