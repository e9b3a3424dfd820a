"""Canonical row-structure analysis for fusion patterns.

The kernel generator views every tensor in a pattern through a 2D ``(R, C)``
row view: ``C`` is the (single, trailing) reduce/broadcast axis and ``R``
is the product of all leading axes.  This is the row-block analogue of the
paper's "data locality" requirement for warp/block composition (§4.1):
intra-row reuse is legal only when producers and consumers agree on the
row partitioning, exactly like the paper requires warp/block locality.

Tensor roles:
  FULL   -- shape folds to (R, C)
  ROW    -- shape folds to (R,) or (R, 1): per-row scalars (reduce results)
  COL    -- shape folds to (C,) or (1, C): per-column params (scale/bias)
  SCALAR -- size-1 tensors

``analyze`` returns ``None`` when the pattern has no consistent row view;
such patterns are still fusible via *kernel packing* (plain ops) but not
via the stitched one-pass kernel.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

from .ir import Graph, OpKind


class Role(enum.Enum):
    FULL = "full"
    ROW = "row"
    COL = "col"
    SCALAR = "scalar"


@dataclass
class RowInfo:
    R: int
    C: int
    roles: dict[int, Role]          # node id -> role (members + external inputs)
    reduce_nodes: list[int]
    expensive_nodes: list[int]

    def role(self, nid: int) -> Role:
        return self.roles[nid]


def _classify_shape(shape: tuple[int, ...], R: int, C: int) -> Role | None:
    size = 1
    for d in shape:
        size *= d
    if size == 1:
        return Role.SCALAR
    if size == R * C and shape and shape[-1] == C:
        return Role.FULL
    if size == R:
        return Role.ROW
    if size == C and shape and shape[-1] == C:
        return Role.COL
    return None


_MISS = object()


def _resolve_square(graph: Graph, members: list, roles: dict[int, Role],
                    C: int) -> bool:
    """Where R == C, a tensor of C elements whose last dim is C may hold a
    row's scalars (ROW) or a column parameter (COL): its size says
    nothing.  ``_classify_shape`` calls it ROW; decide it here from how it
    is made and used, in place in ``roles``: a reduction makes ROW; a
    ``broadcast_in_dim`` whose input's last axis lands on its output's
    last axis keeps the role (a FULL output: COL), else the input is ROW;
    an element-wise op aligns its operands at their trailing axes, so
    against a FULL output such an operand is COL, and an operand of the
    output's own shape shares its role; a reshape keeps it.  False where
    one stays undecided: no row view."""
    nodes = graph.nodes
    open_ = {n for n, r in roles.items() if r is Role.ROW
             and nodes[n].spec.shape and nodes[n].spec.shape[-1] == C
             and nodes[n].spec.size == C}

    def known(n: int) -> Role | None:
        return None if n in open_ else roles.get(n)

    def decide(n: int, role: Role | None) -> bool:
        if n in open_ and role in (Role.ROW, Role.COL):
            roles[n] = role
            open_.discard(n)
            return True
        return False

    changed = True
    while open_ and changed:
        changed = False
        for m in members:
            shape = m.spec.shape
            if m.kind is OpKind.REDUCE:
                changed |= decide(m.nid, Role.ROW)
            elif m.kind is OpKind.BROADCAST:
                src = m.inputs[0]
                dims = tuple(m.params.get("broadcast_dimensions", ()))
                last = bool(dims) and dims[-1] == len(shape) - 1
                out = known(m.nid)
                if out is Role.FULL:
                    changed |= decide(src, Role.COL if last else Role.ROW)
                elif out is not None:
                    changed |= decide(src, out if last else Role.ROW)
                if last:
                    changed |= decide(m.nid, known(src))
            elif m.kind is OpKind.RESHAPE:
                changed |= decide(m.inputs[0], known(m.nid))
                changed |= decide(m.nid, known(m.inputs[0]))
            else:
                out = known(m.nid)
                for i in m.inputs:
                    if out is Role.FULL:
                        changed |= decide(i, Role.COL)
                    elif nodes[i].spec.shape == shape:
                        changed |= decide(i, out)
                        changed |= decide(m.nid, known(i))
    return not open_


def analyze(graph: Graph, pattern: frozenset[int], *,
            ext: "tuple[int, ...] | list[int] | None" = None,
            role_cache: dict | None = None) -> RowInfo | None:
    """Infer the (R, C) row view for ``pattern``, or None if unsupported.

    ``ext`` (the pattern's external inputs) and ``role_cache`` (a
    per-graph ``{(nid, R, C): Role}`` memo) let a ``CostContext`` skip
    the boundary re-scan and repeated shape classification -- this
    function runs once per *distinct* candidate pattern, thousands of
    times per planned graph.
    """
    nodes = graph.nodes
    members = [nodes[n] for n in pattern]

    # transposes break the row view; the plan keeps them in packed groups.
    if any(m.kind is OpKind.TRANSPOSE for m in members):
        return None

    # 1. find C: the common trailing reduce axis, else the widest last dim.
    reduce_nodes = [m for m in members if m.kind is OpKind.REDUCE]
    C = None
    for m in reduce_nodes:
        op_shape = nodes[m.inputs[0]].spec.shape
        axes = tuple(m.params.get("axes", ()))
        if not op_shape or axes != (len(op_shape) - 1,):
            return None  # only trailing-axis reductions are row-compatible
        c = op_shape[-1]
        if C is not None and c != C:
            return None  # mixed reduce widths: no single row view
        C = c
    if C is None:
        widest = max(members, key=lambda m: m.spec.size)
        if not widest.spec.shape:
            return None
        C = widest.spec.shape[-1]

    # 2. find R from the largest FULL tensor.
    R = None
    for m in members:
        size = m.spec.size
        if m.spec.shape and m.spec.shape[-1] == C and size % C == 0 and size // C > 0:
            r = size // C
            if r > (R or 0):
                R = r
    if R is None or R == 0:
        return None

    # 3. classify every member + external input.
    if ext is None:
        ext = graph.pattern_inputs(pattern)
    roles: dict[int, Role] = {}
    for nid in list(pattern) + list(ext):
        if role_cache is not None:
            key = (nid, R, C)
            role = role_cache.get(key, _MISS)
            if role is _MISS:
                role = _classify_shape(nodes[nid].spec.shape, R, C)
                role_cache[key] = role
        else:
            role = _classify_shape(nodes[nid].spec.shape, R, C)
        if role is None:
            return None
        roles[nid] = role
    if R == C and not _resolve_square(graph, members, roles, C):
        return None

    # 4. structural checks the emitter relies on.
    for m in members:
        if m.kind is OpKind.REDUCE:
            if roles[m.inputs[0]] is not Role.FULL or roles[m.nid] is not Role.ROW:
                return None
        elif m.kind is OpKind.BROADCAST:
            src, dst = roles[m.inputs[0]], roles[m.nid]
            ok = (src, dst) in {
                (Role.ROW, Role.ROW), (Role.ROW, Role.FULL),
                (Role.COL, Role.COL), (Role.COL, Role.FULL),
                (Role.SCALAR, Role.SCALAR), (Role.SCALAR, Role.ROW),
                (Role.SCALAR, Role.COL), (Role.SCALAR, Role.FULL),
                (Role.FULL, Role.FULL),
            }
            if not ok:
                return None
        elif m.kind is OpKind.RESHAPE:
            if roles[m.inputs[0]] != roles[m.nid]:
                return None

    expensive = sorted(m.nid for m in members if m.kind is OpKind.EXPENSIVE_EW)
    return RowInfo(R=R, C=C, roles=roles,
                   reduce_nodes=sorted(m.nid for m in reduce_nodes),
                   expensive_nodes=expensive)


def role_bytes_per_row(role: Role, C: int, itemsize: int) -> int:
    """Scratch bytes one row of a value with ``role`` occupies in VMEM."""
    if role is Role.FULL:
        return C * itemsize
    if role is Role.ROW:
        return itemsize
    if role is Role.COL:
        return 0  # shared across rows; charged once, not per row
    return 0
