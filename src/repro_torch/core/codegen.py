"""Stitched-kernel code generation (paper §4) for Hopper, in Triton.

``emit_pattern`` / ``emit_group`` compile one fusion pattern or stitch
group.  A group whose union has a row view (``rowspec.analyze``) and only
emittable primitives becomes ONE generated kernel:

* ``OnePassKernel`` -- the *block composition* scheme.  Replaces the JAX
  package's ``core/codegen.py::_emit_pallas`` (one Pallas TPU kernel per
  group).  One program owns ``BR`` rows; each row is ``BLOCK_C =
  next_pow2(C)`` columns wide with masked loads and stores; every member
  is evaluated in topological order on that register block with roles
  FULL (BR, BLOCK_C), ROW (BR, 1), COL (1, BLOCK_C) and SCALAR ();
  reductions are ``tl.sum``/``tl.max`` over axis 1 with masked lanes set
  to the identity; staged values stay register tensors; a recompute flip
  re-emits the producer's expression at each use.
* ``StreamingKernel`` -- the multi-phase *streaming* scheme for rows too
  long to keep on chip.  Replaces ``core/codegen.py::
  _emit_pallas_streaming``.  The TPU kernel walks a sequential grid
  (rows, phases, column tiles) carrying VMEM accumulators between grid
  steps; blocks on the card run in parallel in no order, so here each
  program owns ``BR`` rows and itself loops over the phases and, inside
  each, over ``BC``-wide column tiles, with one (BR, 1) f32 accumulator
  per reduction in registers.  Phase p recomputes the nodes of reduce
  level <= p; the tail tile is masked; outputs are stored in the last
  phase.

Both kernels move only what the group reads and writes, so HBM bandwidth
bounds them (a few element operations per byte, far below the card's
balance point); the design keeps every intermediate of the group in
registers, so each input is read once (one-pass) or once per phase
(streaming) and each output written once.  ``BR`` and ``BC`` are the
plan's block rows and columns, padded to powers of two; the preset's
``Hardware.max_block_elems`` bounds them in the planner, not here.  The
generator writes one
``@triton.jit`` source per group into ``build/kernels`` (content-hashed)
and imports it there, because Triton compiles from a source file.

Beside each kernel is its plain PyTorch version, the *row-view
evaluator* (``plain``): the same member walk on whole rows (one-pass) or
on the same phases and column tiles with f32 accumulators (streaming).
A kernel object called with CPU tensors runs its plain version; with
CUDA tensors it launches the kernel or raises -- there is no fallback.
``OnePassKernel.launches`` / ``StreamingKernel.launches`` count launches.

Patterns with no row view are *packed*: their subgraph runs as plain
PyTorch ops (the JAX package leaves them to XLA outside any Pallas
kernel).
"""
from __future__ import annotations

import hashlib
import importlib.util
import math
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Sequence

import torch

from .cost_model import H100, Hardware, KernelEstimate, best_estimate, \
    block_fits, estimate_packed, next_pow2, reduce_levels, stitch_gain
from .ir import Graph, OpKind
from .memory_planner import group_order, plan_group_scratch, plan_scratch
from .rowspec import Role, RowInfo, analyze
from .tracer import TORCH_DTYPES, const_tensor, run_subgraph

# --------------------------------------------------------------------------
# emittable vocabulary: exactly what the Triton generator lowers
# --------------------------------------------------------------------------
_TL_UNARY = {
    "exp": "tl.exp({0})", "exp2": "tl.exp2({0})", "log": "tl.log({0})",
    "sin": "tl.sin({0})", "cos": "tl.cos({0})", "sqrt": "tl.sqrt_rn({0})",
    "rsqrt": "tl.rsqrt({0})", "logistic": "tl.sigmoid({0})",
    "erf": "tl.erf({0})", "floor": "tl.floor({0})", "ceil": "tl.ceil({0})",
    # libdevice keeps the relative precision near 0 that exp(x) - 1,
    # log(1 + x) and 2 sigmoid(2x) - 1 lose, as XLA's lowerings do
    "expm1": "libdevice.expm1({0})", "log1p": "libdevice.log1p({0})",
    "tanh": "libdevice.tanh({0})",
}
_TL_BINARY = {
    "add": "({0} + {1})", "sub": "({0} - {1})", "mul": "({0} * {1})",
    "div": "({0} / {1})", "max": "tl.maximum({0}, {1})",
    "min": "tl.minimum({0}, {1})", "eq": "({0} == {1})",
    "ne": "({0} != {1})", "ge": "({0} >= {1})", "gt": "({0} > {1})",
    "le": "({0} <= {1})", "lt": "({0} < {1})", "and": "({0} & {1})",
    "or": "({0} | {1})", "xor": "({0} ^ {1})",
}


#: Lowered by ``RowKernel._expr`` itself, outside the two tables.
_SPECIAL = {"broadcast_in_dim", "convert_element_type", "integer_pow",
            "square", "neg", "abs", "not", "select_n", "clamp", "is_finite",
            "sign"}
_PASS = ("reshape", "squeeze", "expand_dims", "copy", "stop_gradient")
_REDUCES = {"reduce_sum", "reduce_max", "reduce_min"}

#: Primitives a generated kernel may hold.  The reference's set also has
#: round, pow, atan2, rem, erfc, cbrt, nextafter and the prod/and/or
#: reductions; here a group with one of those runs packed.
EMITTABLE_PRIMS = frozenset(set(_TL_UNARY) | set(_TL_BINARY) | _SPECIAL
                            | set(_PASS) | _REDUCES | {"const"})

#: Repo-local build directory of generated kernel sources (and Triton's
#: cache, unless ``TRITON_CACHE_DIR`` is set): listed in ``.gitignore``.
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"


def pattern_emittable(graph: Graph, pattern: frozenset[int],
                      info: "RowInfo | None" = ...) -> bool:
    """Can the kernel generator stitch this pattern?  Pass a precomputed
    ``analyze`` result via ``info`` to skip re-running the inference."""
    if info is ...:
        info = analyze(graph, pattern)
    if info is None:
        return False
    return all(graph.node(n).prim in EMITTABLE_PRIMS for n in pattern)


@dataclass
class Emitted:
    """A compiled pattern or stitch group: callable + report metadata.

    ``fn(device, *ext_tensors) -> tuple(outputs)``."""
    fn: Callable
    kind: str                    # "onepass" | "streaming" | "packed"
    estimate: KernelEstimate
    ext_ids: list[int]           # runtime external inputs (non-const)
    out_ids: list[int]
    scratch_bytes: int
    scratch_naive_bytes: int
    parts: tuple = ()            # member patterns (sorted id tuples)
    hbm_saved: int = 0           # inter-pattern HBM bytes the group avoids
    n_recomputed: int = 0        # values inlined per consumer (not staged)
    recompute_bytes_freed: int = 0

    @property
    def generated(self) -> bool:
        return self.kind in ("onepass", "streaming")


# --------------------------------------------------------------------------
# row-view helpers shared by the plain evaluators and the wrappers
# --------------------------------------------------------------------------
def _to_rowview(v: torch.Tensor, role: Role, R: int, C: int) -> torch.Tensor:
    if role is Role.FULL:
        return v.reshape(R, C)
    if role is Role.ROW:
        return v.reshape(R, 1)
    if role is Role.COL:
        return v.reshape(1, C)
    return v.reshape(())


def _role_shape(role: Role, rows: int, cols: int) -> tuple[int, ...]:
    return {Role.FULL: (rows, cols), Role.ROW: (rows, 1),
            Role.COL: (1, cols), Role.SCALAR: ()}[role]


_IDENTITY = {"reduce_sum": 0.0, "reduce_max": -math.inf,
             "reduce_min": math.inf}


def _reduce_rows(prim: str, x: torch.Tensor) -> torch.Tensor:
    """Row reduction of a (rows, cols) block into (rows, 1), in f32."""
    xf = x.to(torch.float32)
    if prim == "reduce_sum":
        return xf.sum(-1, keepdim=True)
    if prim == "reduce_max":
        return xf.amax(-1, keepdim=True)
    return xf.amin(-1, keepdim=True)


def _combine(prim: str, acc: torch.Tensor, part: torch.Tensor):
    if prim == "reduce_sum":
        return acc + part
    if prim == "reduce_max":
        return torch.maximum(acc, part)
    return torch.minimum(acc, part)


class _RowEval:
    """Evaluate members on (rows, cols) blocks of a row view in PyTorch.

    The shared core of both plain versions: ``compute`` mirrors what the
    generated kernels emit for each primitive (reductions in f32, cast to
    the node's type; a recompute flip re-evaluates its producer inline).
    """

    def __init__(self, graph: Graph, roles: dict, rows: int, cols: int,
                 device, recompute: frozenset[int] = frozenset()):
        self.graph, self.roles = graph, roles
        self.rows, self.cols = rows, cols
        self.device = device
        self.recompute = recompute
        self.env: dict[int, torch.Tensor] = {}

    def val(self, i: int) -> torch.Tensor:
        if i in self.env:
            return self.env[i]
        if i in self.recompute:
            return self.compute(i)
        # a scalar const (multi-element consts are kernel inputs in env)
        return const_tensor(self.graph.node(i), self.device).reshape(())

    def compute(self, nid: int) -> torch.Tensor:
        node = self.graph.node(nid)
        prim = node.prim
        dt = TORCH_DTYPES[node.spec.dtype]
        if prim in _REDUCES:
            return _reduce_rows(prim, self.val(node.inputs[0])).to(dt)
        if prim == "broadcast_in_dim":
            shape = _role_shape(self.roles[nid], self.rows, self.cols)
            return self.val(node.inputs[0]).expand(shape)
        if prim in _PASS:
            return self.val(node.inputs[0])
        return node.params["_fn"](self.device,
                                  *(self.val(i) for i in node.inputs))


# --------------------------------------------------------------------------
# the generated kernels
# --------------------------------------------------------------------------
_TL_DTYPES = {"float32": "tl.float32", "bfloat16": "tl.bfloat16",
              "float16": "tl.float16", "float64": "tl.float64",
              "int64": "tl.int64", "int32": "tl.int32", "int16": "tl.int16",
              "int8": "tl.int8", "uint8": "tl.uint8", "bool": "tl.int1"}

def _literal(value) -> str:
    v = value.item() if hasattr(value, "item") else value
    if isinstance(v, bool):
        return "True" if v else "False"
    if isinstance(v, int):
        return repr(v)
    v = float(v)
    if math.isnan(v):
        return "float('nan')"
    if math.isinf(v):
        return "float('inf')" if v > 0 else "float('-inf')"
    return repr(v)


class RowKernel:
    """A generated kernel for one group plus its plain version.

    ``const_ids`` are multi-element constants the group reads: they are
    kernel inputs like ``ext_ids`` (materialized on the call's device).
    """

    schedule = ""
    launches = 0  # per subclass: kernel launches (plain runs excluded)

    def __init__(self, graph: Graph, pattern: frozenset[int], info: RowInfo,
                 ext_ids: Sequence[int], out_ids: Sequence[int], *,
                 block_rows: int, order: Sequence[int] | None = None,
                 recompute: frozenset[int] = frozenset()):
        self.graph = graph
        self.R, self.C = info.R, info.C
        self.roles = info.roles
        self.members = list(order) if order is not None else sorted(pattern)
        self.ext_ids = list(ext_ids)
        self.out_ids = list(out_ids)
        self.const_ids = [i for i in graph.pattern_inputs(pattern)
                          if graph.node(i).kind is OpKind.CONST
                          and graph.node(i).spec.size > 1]
        self.block_rows = max(1, min(block_rows, self.R))
        self.recompute = frozenset(recompute)
        self._src: str | None = None
        self._kernel = None

    # -- wrapper ---------------------------------------------------------------
    def __call__(self, device, *vals) -> tuple:
        devs = {v.device.type for v in vals} or {torch.device(device).type}
        if devs == {"cpu"}:
            return self.plain(device, *vals)
        if devs != {"cuda"}:
            raise ValueError(
                f"{type(self).__name__}: inputs must all lie on the CPU "
                f"(plain version) or all on CUDA (kernel); got devices "
                f"{sorted(devs)}")
        return self.launch(*vals)

    def _inputs(self, vals, device) -> list[torch.Tensor]:
        ins = [_to_rowview(v, self.roles[i], self.R, self.C)
               for i, v in zip(self.ext_ids, vals)]
        for c in self.const_ids:
            ins.append(_to_rowview(const_tensor(self.graph.node(c), device),
                                   self.roles[c], self.R, self.C))
        return ins

    def _outputs(self, rv: list[torch.Tensor]) -> tuple:
        return tuple(v.reshape(self.graph.node(o).spec.shape)
                     for o, v in zip(self.out_ids, rv))

    def _alloc_outputs(self, device) -> list[torch.Tensor]:
        outs = []
        for o in self.out_ids:
            role = self.roles[o]
            shape = {Role.FULL: (self.R, self.C), Role.ROW: (self.R,),
                     Role.COL: (self.C,), Role.SCALAR: (1,)}[role]
            outs.append(torch.empty(
                shape, dtype=TORCH_DTYPES[self.graph.node(o).spec.dtype],
                device=device))
        return outs

    def launch(self, *vals) -> tuple:
        device = vals[0].device if vals else torch.device("cuda")
        ins = [x.contiguous() for x in self._inputs(vals, device)]
        outs = self._alloc_outputs(device)
        kernel, grid, meta = self._compiled()
        kernel[grid](*ins, *outs, self.R, self.C, **meta)
        type(self).launches += 1
        return self._outputs(outs)

    def _compiled(self):
        if self._kernel is None:
            self._kernel = _load_kernel(self.source())
        return self._kernel, self.grid(), self.meta()

    def source(self) -> str:
        if self._src is None:
            self._src = self._generate()
        return self._src

    # -- expression building ----------------------------------------------------
    def _dt(self, nid: int) -> str:
        return _TL_DTYPES[self.graph.node(nid).spec.dtype]

    def _expr(self, nid: int, val: Callable[[int], str],
              shape_of: Callable[[Role], str]) -> str:
        """Triton expression of one non-reduce member."""
        node = self.graph.node(nid)
        prim = node.prim
        dt = self._dt(nid)
        ins = [val(i) for i in node.inputs]
        if prim == "broadcast_in_dim":
            src_role = self.roles[node.inputs[0]]
            role = self.roles[nid]
            if src_role is role:
                return ins[0]
            if src_role is Role.SCALAR:
                return f"(tl.zeros({shape_of(role)}, {dt}) + {ins[0]})"
            return f"tl.broadcast_to({ins[0]}, {shape_of(role)})"
        if prim in _PASS:
            return ins[0]
        if prim == "convert_element_type":
            if node.spec.dtype == "bool":
                return f"({ins[0]} != 0)"
            return f"({ins[0]}).to({dt})"
        if prim == "integer_pow":
            y = int(node.params["y"])
            base = ins[0] if y > 0 else f"(1.0 / {ins[0]})"
            return "(" + " * ".join([base] * max(1, abs(y))) + ")" if y else \
                f"(tl.zeros_like({ins[0]}) + 1)"
        if prim == "square":
            return f"({ins[0]} * {ins[0]})"
        if prim == "neg":
            return f"(-{ins[0]})"
        if prim == "abs":
            return f"tl.abs({ins[0]})"
        if prim == "not":
            return f"({ins[0]} == 0)"
        if prim == "select_n" and len(ins) == 3:
            pred = ins[0]
            if self.graph.node(node.inputs[0]).spec.dtype != "bool":
                pred = f"({pred} != 0)"
            return f"tl.where({pred}, {ins[2]}, {ins[1]}).to({dt})"
        if prim == "clamp":
            return f"tl.minimum(tl.maximum({ins[1]}, {ins[0]}), {ins[2]})"
        if prim == "is_finite":
            return f"(tl.abs({ins[0]}) < float('inf'))"
        if prim == "sign":
            x = ins[0]
            return (f"tl.where({x} > 0, 1.0, tl.where({x} < 0, -1.0, 0.0))"
                    f".to({dt})")
        if prim in _TL_UNARY:
            x = ins[0]
            if node.spec.dtype != "float32":
                x = f"({x}).to(tl.float32)"
            return f"{_TL_UNARY[prim].format(x)}.to({dt})"
        if prim in _TL_BINARY:
            e = _TL_BINARY[prim].format(*ins)
            return e if node.spec.dtype == "bool" else f"{e}.to({dt})"
        raise NotImplementedError(
            f"primitive {prim!r} has no Triton lowering in the generator")

    def _reduce_expr(self, prim: str, operand: str, mask: str) -> str:
        ident = _literal(_IDENTITY[prim])
        fn = {"reduce_sum": "tl.sum", "reduce_max": "tl.max",
              "reduce_min": "tl.min"}[prim]
        return (f"{fn}(tl.where({mask}, ({operand}).to(tl.float32), "
                f"{ident}), axis=1)[:, None]")

    def _signature(self) -> list[str]:
        n_in = len(self.ext_ids) + len(self.const_ids)
        return ([f"in{k}" for k in range(n_in)]
                + [f"out{k}" for k in range(len(self.out_ids))])

    def _in_nodes(self) -> list[int]:
        return self.ext_ids + self.const_ids


class OnePassKernel(RowKernel):
    """Block composition: one program, ``BR`` whole rows, all in registers."""

    schedule = "onepass"
    launches = 0

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.BLOCK_C = next_pow2(self.C)
        self.BR = next_pow2(self.block_rows)

    def grid(self):
        return (_cdiv(self.R, self.BR),)

    def meta(self) -> dict:
        warps = min(16, max(4, self.BR * self.BLOCK_C // 1024))
        return {"BR": self.BR, "BLOCK_C": self.BLOCK_C, "num_warps": warps}

    # -- plain version ------------------------------------------------------------
    def plain(self, device, *vals) -> tuple:
        ev = _RowEval(self.graph, self.roles, self.R, self.C, device,
                      self.recompute)
        for i, v in zip(self._in_nodes(), self._inputs(vals, device)):
            ev.env[i] = v
        for nid in self.members:
            if nid in self.recompute:
                continue
            ev.env[nid] = ev.compute(nid)
        out = []
        for o in self.out_ids:
            role = self.roles[o]
            v = ev.env[o].expand(_role_shape(role, self.R, self.C))
            out.append(v.to(TORCH_DTYPES[self.graph.node(o).spec.dtype]))
        return self._outputs(out)

    # -- Triton source ----------------------------------------------------------
    def _generate(self) -> str:
        shape = {Role.FULL: "(BR, BLOCK_C)", Role.ROW: "(BR, 1)",
                 Role.COL: "(1, BLOCK_C)", Role.SCALAR: "()"}
        L = ["pid = tl.program_id(0)",
             "rows = pid * BR + tl.arange(0, BR)[:, None]",
             "cols = tl.arange(0, BLOCK_C)[None, :]",
             "rmask = rows < R",
             "cmask = cols < C",
             "fmask = rmask & cmask",
             "offs = rows.to(tl.int64) * C + cols"]
        names: dict[int, str] = {}
        for k, i in enumerate(self._in_nodes()):
            role = self.roles[i]
            ptr = f"in{k}"
            if role is Role.FULL:
                L.append(f"x{i} = tl.load({ptr} + offs, mask=fmask, other=0)")
            elif role is Role.ROW:
                L.append(f"x{i} = tl.load({ptr} + rows, mask=rmask, other=0)")
            elif role is Role.COL:
                L.append(f"x{i} = tl.load({ptr} + cols, mask=cmask, other=0)")
            else:
                L.append(f"x{i} = tl.load({ptr})")
            names[i] = f"x{i}"

        def val(i: int) -> str:
            if i in names:
                return names[i]
            if i in self.recompute:
                return compute(i)
            return _literal(self.graph.node(i).value)  # scalar const

        def compute(nid: int) -> str:
            node = self.graph.node(nid)
            if node.prim in _REDUCES:
                e = self._reduce_expr(node.prim, val(node.inputs[0]), "fmask")
                return f"{e}.to({self._dt(nid)})"
            return self._expr(nid, val, shape.get)

        for nid in self.members:
            if nid in self.recompute:
                continue
            L.append(f"v{nid} = {compute(nid)}")
            names[nid] = f"v{nid}"
        for k, o in enumerate(self.out_ids):
            role = self.roles[o]
            v = f"tl.broadcast_to({names[o]}, {shape[role]})" \
                if role is not Role.SCALAR else names[o]
            v = f"({v}).to({self._dt(o)})"
            if role is Role.FULL:
                L.append(f"tl.store(out{k} + offs, {v}, mask=fmask)")
            elif role is Role.ROW:
                L.append(f"tl.store(out{k} + rows, {v}, mask=rmask)")
            elif role is Role.COL:
                L.append(f"tl.store(out{k} + cols, {v}, "
                         f"mask=cmask & (pid == 0))")
            else:
                L.append(f"tl.store(out{k}, {v}, mask=pid == 0)")
        sig = ", ".join(self._signature()
                        + ["R", "C", "BR: tl.constexpr",
                           "BLOCK_C: tl.constexpr"])
        return _module(sig, L)


class StreamingKernel(RowKernel):
    """Multi-phase streaming: per program, phases x column tiles, f32
    accumulators in registers."""

    schedule = "streaming"
    launches = 0

    def __init__(self, *a, block_cols: int, **kw):
        super().__init__(*a, **kw)
        pat = frozenset(self.members)
        self.lvl = reduce_levels(self.graph, pat)
        self.phases = max(self.lvl.values(), default=0) + 1
        self.reduces = [n for n in self.members
                        if self.graph.node(n).kind is OpKind.REDUCE]
        self.BC = next_pow2(max(1, min(block_cols, self.C)))
        self.BR = next_pow2(self.block_rows)

    def grid(self):
        return (_cdiv(self.R, self.BR),)

    def meta(self) -> dict:
        warps = min(16, max(4, self.BR * self.BC // 1024))
        return {"BR": self.BR, "BC": self.BC, "num_warps": warps}

    # -- plain version ------------------------------------------------------------
    def plain(self, device, *vals) -> tuple:
        R, C, bc = self.R, self.C, self.BC
        ins = dict(zip(self._in_nodes(), self._inputs(vals, device)))
        accs = {r: torch.full((R, 1), _IDENTITY[self.graph.node(r).prim],
                              dtype=torch.float32, device=device)
                for r in self.reduces}
        outs = []
        for o in self.out_ids:
            role = self.roles[o]
            outs.append(torch.empty(
                _role_shape(role, R, C),
                dtype=TORCH_DTYPES[self.graph.node(o).spec.dtype],
                device=device))
        n_tiles = math.ceil(C / bc)
        for p in range(self.phases):
            for j in range(n_tiles):
                c0, c1 = j * bc, min(C, (j + 1) * bc)
                ev = _RowEval(self.graph, self.roles, R, c1 - c0, device)
                for i, v in ins.items():
                    role = self.roles[i]
                    ev.env[i] = v[:, c0:c1] if role in (Role.FULL, Role.COL) \
                        else v
                for nid in self.members:
                    node = self.graph.node(nid)
                    if node.kind is OpKind.REDUCE:
                        if self.lvl[nid] - 1 == p:  # accumulate this phase
                            part = _reduce_rows(node.prim,
                                                ev.val(node.inputs[0]))
                            accs[nid] = _combine(node.prim, accs[nid], part)
                        elif self.lvl[nid] <= p:    # finished earlier
                            ev.env[nid] = accs[nid].to(
                                TORCH_DTYPES[node.spec.dtype])
                    elif self.lvl[nid] <= p:
                        ev.env[nid] = ev.compute(nid)
                if p != self.phases - 1:
                    continue
                for o, buf in zip(self.out_ids, outs):
                    role = self.roles[o]
                    v = ev.env[o].expand(_role_shape(role, R, c1 - c0))
                    if role is Role.FULL:
                        buf[:, c0:c1] = v
                    elif role is Role.COL:
                        buf[:, c0:c1] = v
                    elif j == 0:
                        buf[...] = v
        return self._outputs(outs)

    # -- Triton source ----------------------------------------------------------
    def _generate(self) -> str:
        shape = {Role.FULL: "(BR, BC)", Role.ROW: "(BR, 1)",
                 Role.COL: "(1, BC)", Role.SCALAR: "()"}
        L = ["pid = tl.program_id(0)",
             "rows = pid * BR + tl.arange(0, BR)[:, None]",
             "rmask = rows < R",
             "row_base = rows.to(tl.int64) * C",
             "n_tiles = tl.cdiv(C, BC)"]
        in_nodes = self._in_nodes()
        tile_loads = []
        for k, i in enumerate(in_nodes):
            role = self.roles[i]
            if role is Role.ROW:
                L.append(f"x{i} = tl.load(in{k} + rows, mask=rmask, other=0)")
            elif role is Role.SCALAR:
                L.append(f"x{i} = tl.load(in{k})")
            elif role is Role.FULL:
                tile_loads.append(f"x{i} = tl.load(in{k} + row_base + cols, "
                                  f"mask=fmask, other=0)")
            else:
                tile_loads.append(f"x{i} = tl.load(in{k} + cols, "
                                  f"mask=cmask, other=0)")
        for r in self.reduces:
            ident = _literal(_IDENTITY[self.graph.node(r).prim])
            L.append(f"acc{r} = tl.full((BR, 1), {ident}, tl.float32)")

        for p in range(self.phases):
            last = p == self.phases - 1
            L.append(f"for t in range(0, n_tiles):  # phase {p}")
            body = ["cols = t * BC + tl.arange(0, BC)[None, :]",
                    "cmask = cols < C",
                    "fmask = rmask & cmask"] + tile_loads
            names = {i: f"x{i}" for i in in_nodes}

            def val(i: int) -> str:
                if i in names:
                    return names[i]
                return _literal(self.graph.node(i).value)

            for nid in self.members:
                node = self.graph.node(nid)
                if node.kind is not OpKind.REDUCE and self.lvl[nid] > p:
                    continue
                if node.kind is OpKind.REDUCE:
                    if self.lvl[nid] - 1 > p:
                        continue
                    if self.lvl[nid] - 1 == p:
                        part = self._reduce_expr(node.prim,
                                                 val(node.inputs[0]), "fmask")
                        comb = {"reduce_sum": "acc{0} + {1}",
                                "reduce_max": "tl.maximum(acc{0}, {1})",
                                "reduce_min": "tl.minimum(acc{0}, {1})"}
                        body.append(f"acc{nid} = "
                                    + comb[node.prim].format(nid, part))
                    else:
                        body.append(f"v{nid} = acc{nid}.to({self._dt(nid)})")
                        names[nid] = f"v{nid}"
                    continue
                body.append(f"v{nid} = "
                            + self._expr(nid, val, shape.get))
                names[nid] = f"v{nid}"
            if last:
                for k, o in enumerate(self.out_ids):
                    role = self.roles[o]
                    v = f"tl.broadcast_to({names[o]}, {shape[role]})" \
                        if role is not Role.SCALAR else names[o]
                    v = f"({v}).to({self._dt(o)})"
                    if role is Role.FULL:
                        body.append(f"tl.store(out{k} + row_base + cols, {v}, "
                                    "mask=fmask)")
                    elif role is Role.COL:
                        body.append(f"tl.store(out{k} + cols, {v}, "
                                    "mask=cmask & (pid == 0))")
                    elif role is Role.ROW:
                        body.append(f"tl.store(out{k} + rows, {v}, "
                                    "mask=rmask & (t == 0))")
                    else:
                        body.append(f"tl.store(out{k}, {v}, "
                                    "mask=(pid == 0) & (t == 0))")
            L.extend("    " + b for b in body)
        sig = ", ".join(self._signature()
                        + ["R", "C", "BR: tl.constexpr", "BC: tl.constexpr"])
        return _module(sig, L)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _module(signature: str, body: list[str]) -> str:
    lines = ["# Generated by repro_torch.core.codegen: one stitch group.",
             "import triton",
             "import triton.language as tl",
             "from triton.language.extra import libdevice",
             "",
             "",
             "@triton.jit",
             f"def kernel({signature}):"]
    lines += ["    " + b for b in body]
    return "\n".join(lines) + "\n"


def _load_kernel(src: str):
    """Write ``src`` into the build directory under its content hash and
    import it (Triton compiles from a source file).  Triton itself is
    imported here, never at module import: the CPU tests import this
    module on hosts with no Triton."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton_cache"))
    import triton  # noqa: F401  (fails loudly where Triton is missing)

    digest = hashlib.sha1(src.encode()).hexdigest()[:20]
    kdir = BUILD_DIR / "kernels"
    kdir.mkdir(parents=True, exist_ok=True)
    path = kdir / f"k_{digest}.py"
    if not path.exists():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(src)
        os.replace(tmp, path)
    name = f"repro_torch_gen_{digest}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.kernel


# --------------------------------------------------------------------------
# emission
# --------------------------------------------------------------------------
def _emit_packed(graph: Graph, pattern: frozenset[int],
                 ext_ids: list[int], out_ids: list[int]) -> Callable:
    """Kernel packing: run the subgraph as plain PyTorch ops."""
    members = sorted(pattern)

    def packed_fn(device, *ext_vals):
        env: dict[int, Any] = dict(zip(ext_ids, ext_vals))
        run_subgraph(graph, members, env, device)
        return tuple(env[o] for o in out_ids)

    return packed_fn


def _boundary(graph: Graph, union: frozenset[int], ctx):
    if ctx is not None:
        b = ctx.bounds(union)
        ext_all, out_ids = list(b.inputs), list(b.outputs)
    else:
        ext_all = graph.pattern_inputs(union)
        out_ids = graph.pattern_outputs(union)
    ext_ids = [i for i in ext_all if graph.node(i).kind is not OpKind.CONST]
    return ext_ids, out_ids


def emit_pattern(graph: Graph, pattern: frozenset[int], *,
                 hw: Hardware = H100, ctx=None) -> Emitted:
    """Compile one pattern (a single-part group)."""
    return emit_group(graph, (tuple(sorted(pattern)),), hw=hw, ctx=ctx)


def emit_group(graph: Graph, parts, *, hw: Hardware = H100,
               ctx=None) -> Emitted:
    """Compile one stitch group into a single generated kernel (paper §4).

    ``parts`` are the group's member patterns.  The union runs as ONE
    kernel executing the parts back-to-back (inter-part values stay in
    registers; ``plan_group_scratch`` still prices the spanning liveness
    for the report).  A union with no row view or a non-emittable member
    runs packed.
    """
    parts = tuple(tuple(sorted(p)) for p in parts)
    parts_fs = tuple(frozenset(p) for p in parts)
    union = frozenset(n for p in parts for n in p)
    info = ctx.info(union) if ctx is not None else analyze(graph, union)
    est = ctx.best(union) if ctx is not None else best_estimate(graph, union, hw)
    ext_ids, out_ids = _boundary(graph, union, ctx)
    hbm_saved = 0
    if len(parts) > 1:
        hbm_saved = (ctx.stitch_gain(parts_fs) if ctx is not None else
                     stitch_gain(graph, parts_fs, hw)).hbm_bytes_saved

    if (pattern_emittable(graph, union, info=info)
            and est.schedule in ("onepass", "streaming")):
        rec = frozenset(est.recompute_ids) if est.schedule == "onepass" \
            else frozenset()
        order = group_order(graph, parts_fs)
        if len(parts) > 1:
            scratch = plan_group_scratch(graph, parts_fs, info, recompute=rec)
        else:
            scratch = plan_scratch(graph, union, info, recompute=rec)
        br = max(1, min(est.block_rows or 1, info.R))
        cols = info.C if est.schedule == "onepass" else min(
            est.block_cols or 2048, info.C)
        if not block_fits(hw, br, cols):
            raise ValueError(
                f"planned {br} x {cols} block exceeds the preset's "
                f"{hw.max_block_elems} elements per value")
        rec_freed = 0
        if est.schedule == "onepass":
            if rec:
                base = (plan_group_scratch(graph, parts_fs, info)
                        if len(parts) > 1 else plan_scratch(graph, union, info))
                rec_freed = (base.total_bytes - scratch.total_bytes) * br
            kern = OnePassKernel(graph, union, info, ext_ids, out_ids,
                                 block_rows=est.block_rows, order=order,
                                 recompute=rec)
        else:
            kern = StreamingKernel(graph, union, info, ext_ids, out_ids,
                                   block_rows=est.block_rows, order=order,
                                   block_cols=est.block_cols or 2048)
        return Emitted(kern, kern.schedule, est, ext_ids, out_ids,
                       scratch.total_bytes, scratch.naive_bytes, parts=parts,
                       hbm_saved=hbm_saved, n_recomputed=len(rec),
                       recompute_bytes_freed=rec_freed)

    fn = _emit_packed(graph, union, ext_ids, out_ids)
    if est.schedule != "packed":  # emitter gap: price what actually runs
        est = estimate_packed(graph, union, hw, ctx=ctx)
    return Emitted(fn, "packed", est, ext_ids, out_ids, 0, 0, parts=parts,
                   hbm_saved=hbm_saved)
