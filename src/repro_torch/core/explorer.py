"""Fusion-pattern exploration: PatternReduction approximate DP (paper §5.2).

Candidate patterns are generated per vertex in post-order (consumers
before producers); each vertex keeps only the top-k (k=3) patterns in
which it is the *producer* (earliest member).  ``PatternReduction`` builds
a vertex's candidates from its consumers' candidate sets with a recursive
divide-and-conquer over consumer groups, giving the paper's O(V+E)-ish
complexity instead of O(2^V).

Remote fusion (paper §5, Fig. 5) packs non-adjacent patterns via a
virtual producer; we expose it as a post-pass over the final plan
(``remote_fusion`` in ``planner.py``) that packs leftover compatible
kernels, which is the same mechanism applied after plan selection.
"""
from __future__ import annotations

import itertools

from .costctx import CostContext
from .cost_model import H100, Hardware
from .ir import FUSIBLE_KINDS, Graph, Pattern

TOP_K = 3          # paper: top-3 candidate patterns per vertex
MAX_GROUP = 2      # paper: recursive split of consumers into groups
MAX_PATTERN = 96   # guardrail on pattern size (VMEM planning stays sane)

#: Number of ``explore()`` runs in this process (plan-cache tests read it
#: to prove a cache hit skipped exploration entirely).
EXPLORE_RUNS = 0


def _fusible_consumers(graph: Graph, nid: int) -> list[int]:
    return [c for c in graph.consumers(nid)
            if graph.node(c).kind in FUSIBLE_KINDS]


class FusionExplorer:
    """Generates candidate fusion patterns for every fusible vertex."""

    def __init__(self, graph: Graph, hw: Hardware = H100, top_k: int = TOP_K,
                 ctx: CostContext | None = None):
        self.graph = graph
        self.hw = hw
        self.top_k = top_k
        self.ctx = ctx if ctx is not None else CostContext(graph, hw)
        self.candidates: dict[int, list[Pattern]] = {}

    # -- scoring / validity ---------------------------------------------------
    def score(self, members: frozenset[int]) -> float:
        return self.ctx.score(members)

    def _valid(self, members: frozenset[int]) -> bool:
        if len(members) > MAX_PATTERN:
            return False
        return self.ctx.is_convex(members)

    # -- PatternReduction -----------------------------------------------------
    def _reduce_consumer_group(self, vid: int,
                               group: list[int]) -> list[Pattern]:
        """Top-k candidate patterns of {vid} ∪ (choices from group)."""
        if len(group) > MAX_GROUP:
            mid = len(group) // 2
            left = self._reduce_consumer_group(vid, group[:mid])
            right = self._reduce_consumer_group(vid, group[mid:])
            # combine the two halves' results (both already contain vid)
            merged: list[Pattern] = []
            for a in left:
                for b in right:
                    members = self.ctx.union(a.members, b.members)
                    if self._valid(members):
                        merged.append(Pattern(members, self.score(members)))
            merged.extend(left)
            merged.extend(right)
            return self._topk(merged)

        # base case: enumerate each consumer's candidates (or empty)
        choice_lists = []
        for c in group:
            opts: list[frozenset[int] | None] = [None]
            opts.extend(p.members for p in self.candidates.get(c, []))
            choice_lists.append(opts)

        out: list[Pattern] = []
        base = frozenset({vid})
        for combo in itertools.product(*choice_lists):
            members = base
            for m in combo:
                if m is not None:
                    members = self.ctx.union(members, m)
            if len(members) == 1:
                continue
            if self._valid(members):
                out.append(Pattern(members, self.score(members)))
        return self._topk(out)

    def _topk(self, patterns: list[Pattern]) -> list[Pattern]:
        uniq: dict[frozenset[int], Pattern] = {}
        for p in patterns:
            uniq.setdefault(p.members, p)
        ranked = sorted(uniq.values(), key=lambda p: -p.score)
        return ranked[: self.top_k]

    # -- main entry -----------------------------------------------------------
    def explore(self) -> dict[int, list[Pattern]]:
        """Candidate patterns per vertex (vertex = pattern producer)."""
        global EXPLORE_RUNS
        EXPLORE_RUNS += 1
        order = self.graph.topo_order()
        for vid in reversed(order):  # post-order: last vertex first (§5.2)
            node = self.graph.node(vid)
            if node.kind not in FUSIBLE_KINDS:
                continue
            singleton = Pattern(frozenset({vid}), 0.0)
            consumers = _fusible_consumers(self.graph, vid)
            cands = self._reduce_consumer_group(vid, consumers) if consumers else []
            # keep positive-score candidates; always offer the singleton
            cands = [p for p in cands if p.score > 0.0]
            self.candidates[vid] = self._topk(cands) + [singleton]
        return self.candidates
