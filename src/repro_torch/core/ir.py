"""Tensor-operation graph IR for the FusionStitching planner.

The IR is a flat SSA graph of tensor ops.  It is produced by tracing an
arbitrary PyTorch function (``repro_torch.core.tracer``), consumed by the fusion
explorer / planner (paper §5) and by the stitched-kernel code generator
(paper §4).

Op-kind taxonomy follows the paper's classification (§4): *light
element-wise*, *expensive element-wise* and *reduction* ops are the fusible
memory-intensive kinds; GEMM/conv and data-dependent indexing ops are
``OPAQUE`` fusion boundaries (the paper's "compute intensive" ops).
"""
from __future__ import annotations

import enum
import functools
from dataclasses import dataclass, field
from typing import Any, Iterable, Sequence

import numpy as np


class OpKind(enum.Enum):
    INPUT = "input"              # graph input (not a member of any pattern)
    CONST = "const"              # literal / captured constant
    LIGHT_EW = "light_ew"        # add/sub/mul/cmp/select/... (paper: light elem-wise)
    EXPENSIVE_EW = "expensive_ew"  # exp/log/tanh/rsqrt/... (paper: expensive elem-wise)
    REDUCE = "reduce"            # reduce_{sum,max,min,prod} over axes
    BROADCAST = "broadcast"      # broadcast_in_dim
    RESHAPE = "reshape"          # shape-only: reshape / squeeze / expand_dims
    TRANSPOSE = "transpose"      # layout permutation (memory-intensive per paper §1)
    ANCHOR = "anchor"            # compute-intensive op (GEMM / conv / attention):
    #                              never a pattern member; a graph break
    #                              that runs as a plain PyTorch op
    COLLECTIVE = "collective"    # cross-device data movement: a hard
    #                              stitch-group boundary
    OPAQUE = "opaque"            # gather / scan / ... : hard fusion boundary


#: Kinds that may be members of a fusion pattern.
FUSIBLE_KINDS = frozenset(
    {
        OpKind.LIGHT_EW,
        OpKind.EXPENSIVE_EW,
        OpKind.REDUCE,
        OpKind.BROADCAST,
        OpKind.RESHAPE,
        OpKind.TRANSPOSE,
    }
)


@dataclass(frozen=True)
class TensorSpec:
    shape: tuple[int, ...]
    dtype: str  # canonical numpy dtype name, e.g. "float32", "bfloat16"

    # cached: the planner reads these tens of thousands of times per graph
    # (cached_property writes the instance __dict__ directly, which frozen
    # dataclasses permit; equality/hash still use the fields only).
    @functools.cached_property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n

    @functools.cached_property
    def itemsize(self) -> int:
        if self.dtype == "bfloat16":
            return 2
        return np.dtype(self.dtype).itemsize

    @functools.cached_property
    def nbytes(self) -> int:
        return self.size * self.itemsize

    def __repr__(self) -> str:  # compact: f32[8,128]
        short = {
            "float32": "f32",
            "bfloat16": "bf16",
            "float16": "f16",
            "int32": "i32",
            "int64": "i64",
            "bool": "pred",
            "float64": "f64",
        }.get(self.dtype, self.dtype)
        return f"{short}[{','.join(map(str, self.shape))}]"


@dataclass
class Node:
    """One SSA tensor op.

    ``params`` carries primitive-specific attributes (reduce axes, broadcast
    dimension mapping, transpose permutation, ...).  ``value`` is set only for
    ``CONST`` nodes.
    """

    nid: int
    prim: str
    kind: OpKind
    inputs: tuple[int, ...]
    spec: TensorSpec
    params: dict[str, Any] = field(default_factory=dict)
    value: Any = None  # CONST payload
    label: str = ""    # debug name (fx node name)

    @property
    def nbytes(self) -> int:
        return self.spec.nbytes

    def __repr__(self) -> str:
        ins = ",".join(f"%{i}" for i in self.inputs)
        return f"%{self.nid} = {self.prim}({ins}) : {self.spec} [{self.kind.value}]"


class Graph:
    """A small dataflow graph with the queries the planner needs.

    Nodes are stored in topological order (construction order from the
    tracer guarantees this).
    """

    def __init__(self) -> None:
        self.nodes: dict[int, Node] = {}
        self.inputs: list[int] = []
        self.outputs: list[int] = []
        self._consumers: dict[int, list[int]] | None = None
        self._reach: tuple[dict[int, int], dict[int, int]] | None = None

    # -- construction ------------------------------------------------------
    def add(self, node: Node) -> int:
        self.nodes[node.nid] = node
        self._consumers = None
        self._reach = None
        return node.nid

    # -- queries -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.nodes)

    def node(self, nid: int) -> Node:
        return self.nodes[nid]

    def consumers(self, nid: int) -> list[int]:
        if self._consumers is None:
            cons: dict[int, list[int]] = {n: [] for n in self.nodes}
            for n in self.nodes.values():
                for i in n.inputs:
                    cons[i].append(n.nid)
            self._consumers = cons
        return self._consumers[nid]

    def topo_order(self) -> list[int]:
        """Topological order (producers first).  Construction order is topo."""
        return sorted(self.nodes)

    def num_edges(self) -> int:
        return sum(len(n.inputs) for n in self.nodes.values())

    def fusible_nodes(self) -> list[int]:
        return [n.nid for n in self.nodes.values() if n.kind in FUSIBLE_KINDS]

    # -- pattern validity ---------------------------------------------------
    def reachability(self) -> tuple[dict[int, int], dict[int, int]]:
        """Per-node (descendants, ancestors) bitmasks, bit i = node id i.

        Computed once per graph in O(V·E/64) big-int word ops and
        invalidated on ``add``; ``is_convex`` then becomes an
        O(|P|·V/64) mask test instead of a per-call BFS.
        """
        if self._reach is None:
            ids = sorted(self.nodes)
            desc: dict[int, int] = {}
            for nid in reversed(ids):
                m = 0
                for c in self.consumers(nid):
                    m |= (1 << c) | desc[c]
                desc[nid] = m
            anc: dict[int, int] = {}
            for nid in ids:
                m = 0
                for i in self.nodes[nid].inputs:
                    m |= (1 << i) | anc[i]
                anc[nid] = m
            self._reach = (desc, anc)
        return self._reach

    def is_convex(self, pattern: frozenset[int]) -> bool:
        """True iff fusing ``pattern`` introduces no cyclic dependence.

        Paper §5.2 / Fig. 6: a pattern is invalid if a path exits the
        pattern and re-enters it.  Equivalent check: no node *outside* the
        pattern is both a descendant of a member and an ancestor of a
        member; with the precomputed reachability bitmasks that is one
        AND-NOT over V-bit ints.
        """
        if len(pattern) <= 1:
            return True
        desc, anc = self.reachability()
        pmask = d = a = 0
        for nid in pattern:
            pmask |= 1 << nid
            d |= desc[nid]
            a |= anc[nid]
        return not (d & a & ~pmask)

    def pattern_inputs(self, pattern: frozenset[int]) -> list[int]:
        """External values read by the pattern (deduped, stable order)."""
        seen: list[int] = []
        for nid in sorted(pattern):
            for i in self.nodes[nid].inputs:
                if i not in pattern and i not in seen:
                    seen.append(i)
        return seen

    def pattern_outputs(self, pattern: frozenset[int]) -> list[int]:
        """Pattern members consumed outside the pattern (or graph outputs)."""
        outs: list[int] = []
        outset = set(self.outputs)
        for nid in sorted(pattern):
            if nid in outset or any(c not in pattern for c in self.consumers(nid)):
                outs.append(nid)
        return outs

    def internal_bytes(self, pattern: frozenset[int]) -> int:
        """Bytes of intermediates that stop round-tripping HBM when fused.

        A member tensor is *internal* iff every consumer is inside the
        pattern and it is not a graph output.  These are exactly the values
        the paper keeps in registers / shared memory (for us: VREG / VMEM).
        """
        outset = set(self.outputs)
        total = 0
        for nid in pattern:
            if nid in outset:
                continue
            cons = self.consumers(nid)
            if cons and all(c in pattern for c in cons):
                total += self.nodes[nid].nbytes
        return total

    def pattern_hbm_bytes(self, pattern: frozenset[int]) -> int:
        """HBM traffic of the fused kernel: external reads + external writes."""
        rd = sum(self.nodes[i].nbytes for i in self.pattern_inputs(pattern)
                 if self.nodes[i].kind is not OpKind.CONST or self.nodes[i].spec.size > 128)
        wr = sum(self.nodes[o].nbytes for o in self.pattern_outputs(pattern))
        return rd + wr

    def unfused_hbm_bytes(self, pattern: frozenset[int]) -> int:
        """HBM traffic if every member ran as its own kernel."""
        total = 0
        for nid in pattern:
            node = self.nodes[nid]
            rd = sum(self.nodes[i].nbytes for i in node.inputs
                     if self.nodes[i].kind is not OpKind.CONST or self.nodes[i].spec.size > 128)
            total += rd + node.nbytes
        return total

    def interface_values(self, parts: Sequence[frozenset[int]]) -> list[int]:
        """Values produced in one of the disjoint patterns and consumed in
        another -- the inter-pattern HBM round-trips cross-pattern
        stitching (paper §4) eliminates: under per-pattern emission each
        is written to HBM by the producer kernel and re-read by the
        consumer kernel(s); inside one stitch group it is staged in VMEM
        instead (``memory_planner.plan_group_scratch``)."""
        owner: dict[int, int] = {}
        for k, part in enumerate(parts):
            for nid in part:
                owner[nid] = k
        return [nid for nid, k in sorted(owner.items())
                if any(owner.get(c, k) != k for c in self.consumers(nid))]

    def subgraph_flops(self, pattern: Iterable[int]) -> int:
        """Element-op count (not MXU flops) of the pattern, for the VPU term."""
        total = 0
        for nid in pattern:
            node = self.nodes[nid]
            if node.kind in (OpKind.LIGHT_EW, OpKind.EXPENSIVE_EW):
                total += node.spec.size
            elif node.kind is OpKind.REDUCE:
                total += self.nodes[node.inputs[0]].spec.size
        return total

    # -- debug ---------------------------------------------------------------
    def pprint(self) -> str:
        lines = [f"graph: {len(self.nodes)} nodes, {self.num_edges()} edges"]
        for nid in self.topo_order():
            mark = "->" if nid in self.outputs else "  "
            lines.append(f" {mark} {self.nodes[nid]!r}")
        return "\n".join(lines)


@dataclass(frozen=True)
class Pattern:
    """A candidate fusion pattern: a convex subgraph + its explorer score."""

    members: frozenset[int]
    score: float  # delta-evaluator f(P), higher is better

    def __len__(self) -> int:
        return len(self.members)

    def overlaps(self, covered: set[int] | frozenset[int]) -> bool:
        return not self.members.isdisjoint(covered)


@dataclass(frozen=True)
class StitchGroup:
    """An ordered set of fusion patterns emitted as ONE stitched kernel.

    ``parts`` are disjoint convex patterns (plan patterns plus any
    absorbed leftover singletons, each a singleton part) whose union is
    itself convex and row-consistent; the group executes its members
    back-to-back inside one generated kernel, keeping inter-part values
    on chip instead of round-tripping HBM (paper §4's composition of
    operators with varied data dependencies into one large kernel).

    ``anchors`` names compute-intensive (``OpKind.ANCHOR``) nodes the
    group is built *around*: each appears in ``parts`` as its own
    singleton part, and the emitter folds the surrounding parts into the
    anchor's compute kernel as prologue/epilogue chains (the fused matmul
    B3, flash attention with a score chain) instead of staging them
    across separate launches.  ``unanchored`` keeps the pre-fold
    composition (a tuple of part-tuples, one per original group plus one
    per bare anchor), as the reference records it.
    """

    parts: tuple[frozenset[int], ...]
    anchors: tuple[int, ...] = ()
    unanchored: tuple = ()

    @functools.cached_property
    def members(self) -> frozenset[int]:
        out: frozenset[int] = frozenset()
        for p in self.parts:
            out |= p
        return out

    def __len__(self) -> int:
        return len(self.parts)

    @property
    def stitched(self) -> bool:
        return len(self.parts) > 1


@dataclass
class FusionPlan:
    """A set of disjoint patterns covering (a subset of) the graph (§5.1)."""

    patterns: list[Pattern] = field(default_factory=list)
    total_score: float = 0.0

    def covered(self) -> set[int]:
        s: set[int] = set()
        for p in self.patterns:
            s |= p.members
        return s

    def validate_disjoint(self) -> bool:
        seen: set[int] = set()
        for p in self.patterns:
            if not p.members.isdisjoint(seen):
                return False
            seen |= p.members
        return True
