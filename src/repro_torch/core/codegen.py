"""Stitched-kernel code generation (paper §4) for Hopper.

``emit_pattern`` / ``emit_group`` compile one fusion pattern or stitch
group.  A group whose union has a row view (``rowspec.analyze``) and only
emittable primitives becomes ONE generated kernel:

* ``OnePassKernel`` -- the *block composition* scheme, in Triton.
  Replaces the JAX package's ``core/codegen.py::_emit_pallas`` (one
  Pallas TPU kernel per group).  One program owns ``BR`` rows; each row
  is ``BLOCK_C = next_pow2(C)`` columns wide with masked loads and
  stores; every member is evaluated in topological order on that
  register block with roles FULL (BR, BLOCK_C), ROW (BR, 1), COL (1,
  BLOCK_C) and SCALAR (); reductions are ``tl.sum``/``tl.max`` over axis
  1 with masked lanes set to the identity; staged values stay register
  tensors; a recompute flip re-emits the producer's expression at each
  use.
* ``StreamingKernel`` -- the multi-phase *streaming* scheme for rows too
  long for registers, in CUDA C++.  Replaces ``core/codegen.py::
  _emit_pallas_streaming``.  The TPU kernel walks a sequential grid
  (rows, phases, column tiles) carrying VMEM accumulators between grid
  steps and reads every full-row input once per phase.  Here
  ``codegen_cuda.stream_struct`` writes the group as C++ of one element
  in phases (phase p evaluates the nodes of reduce level <= p and
  accumulates the reductions of level p + 1), and ``csrc/streaming.cuh``
  holds each row on chip: split across a thread-block cluster of up to
  eight CTAs, each staging its slice in shared memory once, the phases'
  reductions combined across the cluster through distributed shared
  memory, the outputs written in the last phase.

Both kernels move only what the group reads and writes, so HBM bandwidth
bounds them (a few element operations per byte, far below the card's
balance point); each input is read once and each output written once
(the streaming kernel re-reads from device memory only the columns of a
row longer than its cluster holds).  ``BR`` and ``BC`` are the plan's
block rows and columns, padded to powers of two; the preset's
``Hardware.max_block_elems`` bounds them in the planner, not here.  The
one-pass generator writes one ``@triton.jit`` source per group into
``build/kernels`` (content-hashed) and imports it there, because Triton
compiles from a source file; the streaming generator's ``.cu`` builds
with ``nvcc`` at its first launch (``kernels/_build.py``).

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

import ctypes
import hashlib
import importlib.util
import math
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..kernels import _build
from . import codegen_cuda as cc
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
    # round half to even, as lax.round(TO_NEAREST_EVEN) and torch.round
    "round": "libdevice.nearbyint({0})", "erfc": "libdevice.erfc({0})",
    "cbrt": "libdevice.cbrt({0})",
}
_TL_BINARY = {
    "add": "({0} + {1})", "sub": "({0} - {1})", "mul": "({0} * {1})",
    "div": "({0} / {1})", "max": "tl.maximum({0}, {1})",
    "min": "tl.minimum({0}, {1})", "eq": "({0} == {1})",
    "ne": "({0} != {1})", "ge": "({0} >= {1})", "gt": "({0} > {1})",
    "le": "({0} <= {1})", "lt": "({0} < {1})", "and": "({0} & {1})",
    "or": "({0} | {1})", "xor": "({0} ^ {1})",
    "pow": "libdevice.pow({0}, {1})", "atan2": "libdevice.atan2({0}, {1})",
    # lax.rem: the remainder with the dividend's sign (C fmod)
    "rem": "libdevice.fmod({0}, {1})",
    # one step on the bits (``_nextafter``): libdevice's, under Triton's
    # flushed denormals, steps from 0 to the smallest normal float
    "nextafter": "_nextafter({0}, {1})",
}


#: Lowered by ``RowKernel._expr`` itself, outside the two tables.
_SPECIAL = {"broadcast_in_dim", "convert_element_type", "integer_pow",
            "square", "neg", "abs", "not", "select_n", "clamp", "is_finite",
            "sign"}
_PASS = ("reshape", "squeeze", "expand_dims", "copy", "stop_gradient")
_REDUCES = {"reduce_sum", "reduce_max", "reduce_min", "reduce_prod",
            "reduce_and", "reduce_or"}

#: Primitives a generated kernel may hold: the reference's set, lowered
#: here to Triton (the one-pass kernel, and the tables below) and by
#: ``codegen_cuda`` to CUDA C++ (the streaming and anchored kernels).
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


# --------------------------------------------------------------------------
# compute-anchored groups: structural matchers
# --------------------------------------------------------------------------
class AnchorEmitError(RuntimeError):
    """Anchored emission found a structure the matchers do not accept.
    The port raises it (no fallback rung): the stitcher commits an
    anchored group only after ``anchor_emittable`` accepted it."""


#: Shape-plumbing prims the softmax-tail matcher walks through (they are
#: elided along with the tail itself -- the flash kernel's online softmax
#: replaces the whole chain).
_PASSTHROUGH = {"reshape", "squeeze", "expand_dims", "convert_element_type",
                "copy", "stop_gradient", "broadcast_in_dim"}


def _match_matmul_anchor(graph: Graph, union: frozenset[int],
                         a: int) -> dict | None:
    """Match a single-anchor group: prologue -> dot_general -> epilogue.

    Requires an unbatched contraction ``(..., K) @ (K, N)`` with the rhs
    external to the group, a prologue whose row view is (M, K) and whose
    every escaping value feeds only the anchor, and an epilogue with row
    view (M, N) that solely consumes the anchor's result.
    """
    node = graph.node(a)
    if node.prim != "dot_general" or len(node.inputs) < 2:
        return None
    dn = node.params.get("dimension_numbers")
    if dn is None:
        return None
    (cl, cr), (bl, br_) = dn
    if tuple(bl) or tuple(br_):
        return None
    lhs_id, rhs_id = node.inputs[0], node.inputs[1]
    lhs_spec = graph.node(lhs_id).spec
    rhs_spec = graph.node(rhs_id).spec
    if len(rhs_spec.shape) != 2 or rhs_id in union:
        return None
    if tuple(cl) != (len(lhs_spec.shape) - 1,) or tuple(cr) != (0,):
        return None
    K, N = rhs_spec.shape
    if not lhs_spec.shape or lhs_spec.shape[-1] != K:
        return None
    M = lhs_spec.size // K
    if node.spec.size != M * N or not node.spec.shape \
            or node.spec.shape[-1] != N:
        return None

    mem = union - {a}
    if not mem or any(graph.node(m).prim not in EMITTABLE_PRIMS
                      for m in mem):
        return None
    _, anc = graph.reachability()
    pro = frozenset(m for m in mem if (anc[a] >> m) & 1)
    epi = mem - pro
    outset = set(graph.outputs)

    pro_info = None
    if pro:
        if lhs_id not in pro:
            return None
        for m in pro:
            if m in outset or any(c not in pro and c != a
                                  for c in graph.consumers(m)):
                return None
        pro_info = analyze(graph, pro)
        if pro_info is None or pro_info.R != M or pro_info.C != K:
            return None
    elif lhs_id in union:
        return None

    epi_info = None
    if epi:
        if a in outset or any(c not in epi for c in graph.consumers(a)):
            return None
        epi_info = analyze(graph, epi)
        if epi_info is None or epi_info.R != M or epi_info.C != N:
            return None
    return {"kind": "matmul", "a": a, "lhs": lhs_id, "rhs": rhs_id,
            "M": M, "K": K, "N": N, "pro": pro, "epi": epi,
            "pro_info": pro_info, "epi_info": epi_info}


def _match_softmax_tail(graph: Graph, chain: frozenset[int],
                        root: int) -> tuple[int, frozenset[int]] | None:
    """Match ``div(exp(sub(s, max(s))), sum(exp(...)))`` ending at ``root``
    (walking through shape-plumbing wrappers); returns (s_pre, elided
    members) where ``s_pre`` is the pre-softmax score value the flash
    kernel's score functor must reproduce.  The port's ``_softmax``
    lowering (``tracer.softmax``) is this chain without the reference's
    ``max(-inf, .)`` clamp, which the matcher walks through when present.
    """
    elided: set[int] = set()

    def back(nid: int) -> int:
        while nid in chain and graph.node(nid).prim in _PASSTHROUGH:
            elided.add(nid)
            nid = graph.node(nid).inputs[0]
        return nid

    div_id = back(root)
    if div_id not in chain or graph.node(div_id).prim != "div":
        return None
    elided.add(div_id)
    num_id = back(graph.node(div_id).inputs[0])
    den_id = back(graph.node(div_id).inputs[1])
    if den_id not in chain or graph.node(den_id).prim != "reduce_sum":
        return None
    elided.add(den_id)
    if back(graph.node(den_id).inputs[0]) != num_id:
        return None
    if num_id not in chain or graph.node(num_id).prim != "exp":
        return None
    elided.add(num_id)
    sub_id = back(graph.node(num_id).inputs[0])
    if sub_id not in chain or graph.node(sub_id).prim != "sub":
        return None
    elided.add(sub_id)
    s_pre = back(graph.node(sub_id).inputs[0])
    mx_id = back(graph.node(sub_id).inputs[1])
    if mx_id in chain and graph.node(mx_id).prim == "max":
        ins = graph.node(mx_id).inputs
        guard = [i for i in ins
                 if graph.node(i).kind is OpKind.CONST
                 and graph.node(i).spec.size == 1
                 and graph.node(i).value is not None
                 and np.isneginf(np.asarray(graph.node(i).value))]
        rest = [i for i in ins if i not in guard]
        if len(guard) == 1 and len(rest) == 1:
            elided.add(mx_id)
            mx_id = back(rest[0])
    if mx_id not in chain or graph.node(mx_id).prim != "reduce_max":
        return None
    elided.add(mx_id)
    if back(graph.node(mx_id).inputs[0]) != s_pre:
        return None
    for r in (den_id, mx_id):
        rnode = graph.node(r)
        op_shape = graph.node(rnode.inputs[0]).spec.shape
        if tuple(rnode.params.get("axes", ())) != (len(op_shape) - 1,):
            return None
    return s_pre, frozenset(elided)


def _pad4(shape: tuple[int, ...]) -> tuple[int, int, int, int]:
    return (1,) * (4 - len(shape)) + tuple(shape)


def _score_shape_ok(shape: tuple[int, ...],
                    extent: tuple[int, int, int, int]) -> bool:
    if len(shape) > 4:
        return False
    return all(d == 1 or d == e for d, e in zip(_pad4(shape), extent))


def _match_attention_anchors(graph: Graph, union: frozenset[int],
                             anchors: tuple[int, ...]) -> dict | None:
    """Match a two-anchor group: QK dot -> score chain -> softmax -> PV dot.

    q/k/v must be external 4D operands with flash-compatible dimension
    numbers; the chain between the anchors must end in a softmax tail,
    and everything upstream of it (scale / bias / mask) must evaluate on
    score tiles -- each value's shape, padded to 4D, has every dim
    either 1 or the full (B, H, Sq, Skv) extent.
    """
    qk, pv = anchors
    nqk, npv = graph.node(qk), graph.node(pv)
    if nqk.prim != "dot_general" or npv.prim != "dot_general":
        return None
    dn_qk = nqk.params.get("dimension_numbers")
    dn_pv = npv.params.get("dimension_numbers")
    if dn_qk is None or dn_pv is None:
        return None
    if (tuple(map(tuple, dn_qk[0])), tuple(map(tuple, dn_qk[1]))) \
            != (((3,), (3,)), ((0, 1), (0, 1))):
        return None
    if (tuple(map(tuple, dn_pv[0])), tuple(map(tuple, dn_pv[1]))) \
            != (((3,), (2,)), ((0, 1), (0, 1))):
        return None
    q_id, k_id = nqk.inputs[0], nqk.inputs[1]
    p_id, v_id = npv.inputs[0], npv.inputs[1]
    if any(x in union for x in (q_id, k_id, v_id)):
        return None
    q_spec, k_spec = graph.node(q_id).spec, graph.node(k_id).spec
    v_spec = graph.node(v_id).spec
    if len(q_spec.shape) != 4 or len(k_spec.shape) != 4 \
            or len(v_spec.shape) != 4:
        return None
    B, H, Sq, D = q_spec.shape
    _, _, Sk, _ = k_spec.shape
    if k_spec.shape != (B, H, Sk, D) or v_spec.shape != (B, H, Sk, D):
        return None
    extent = (B, H, Sq, Sk)

    chain = union - {qk, pv}
    outset = set(graph.outputs)
    if qk in outset or p_id not in chain:
        return None
    for m in chain:
        if m in outset or any(c not in chain and c != pv
                              for c in graph.consumers(m)):
            return None
    if any(c not in chain for c in graph.consumers(qk)):
        return None

    tail = _match_softmax_tail(graph, chain, p_id)
    if tail is None:
        return None
    s_pre, elided = tail
    score = chain - elided
    if s_pre == qk:
        if score:
            return None
    elif s_pre not in score:
        return None

    score_ext: list[int] = []
    _, anc = graph.reachability()
    for m in sorted(score):
        node = graph.node(m)
        if node.prim not in EMITTABLE_PRIMS or node.kind is OpKind.REDUCE:
            return None
        if m != s_pre and not ((anc[s_pre] >> m) & 1):
            return None  # a score member the pre-softmax value never reads
        if not _score_shape_ok(node.spec.shape, extent):
            return None
        if node.prim == "broadcast_in_dim":
            bd = tuple(node.params.get("broadcast_dimensions", ()))
            in_nd = len(graph.node(node.inputs[0]).spec.shape)
            out_nd = len(node.spec.shape)
            if bd != tuple(range(out_nd - in_nd, out_nd)):
                return None  # not suffix-aligned: 4D padding would misread it
        for i in node.inputs:
            if i in score or i == qk:
                continue
            ispec = graph.node(i).spec
            if not _score_shape_ok(ispec.shape, extent):
                return None
            if i not in score_ext:
                score_ext.append(i)
    return {"kind": "attention", "qk": qk, "pv": pv,
            "q": q_id, "k": k_id, "v": v_id,
            "extent": extent, "D": D, "s_pre": s_pre,
            "score": score, "score_ext": score_ext}


def anchor_emittable(graph: Graph, parts, anchors) -> bool:
    """Can ``_emit_anchored`` compile this anchored group?  Structural
    test only (dimension numbers, row views, softmax tail) -- pricing and
    the device's own feasibility are the cost model's job."""
    union = frozenset(n for p in parts for n in p)
    anchors = tuple(sorted(anchors))
    if len(anchors) == 1:
        return _match_matmul_anchor(graph, union, anchors[0]) is not None
    if len(anchors) == 2:
        return _match_attention_anchors(graph, union, anchors) is not None
    return False


@dataclass
class Emitted:
    """A compiled pattern or stitch group: callable + report metadata.

    ``fn(device, *ext_tensors) -> tuple(outputs)``."""
    fn: Callable
    kind: str                    # "onepass" | "streaming" | "packed" | "anchored"
    estimate: KernelEstimate
    ext_ids: list[int]           # runtime external inputs (non-const)
    out_ids: list[int]
    scratch_bytes: int
    scratch_naive_bytes: int
    parts: tuple = ()            # member patterns (sorted id tuples)
    hbm_saved: int = 0           # inter-pattern HBM bytes the group avoids
    n_recomputed: int = 0        # values inlined per consumer (not staged)
    recompute_bytes_freed: int = 0
    io_aliases: dict | None = None  # ext pos -> out pos written into it

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


#: The identity of each reduction.  ``reduce_and`` / ``reduce_or`` run
#: as the min / max of (x != 0) in float32, their result cast to bool.
_IDENTITY = {"reduce_sum": 0.0, "reduce_max": -math.inf,
             "reduce_min": math.inf, "reduce_prod": 1.0, "reduce_and": 1.0,
             "reduce_or": 0.0}


def _reduce_rows(prim: str, x: torch.Tensor) -> torch.Tensor:
    """Row reduction of a (rows, cols) block into (rows, 1), in f32."""
    if prim in ("reduce_and", "reduce_or"):
        x = x != 0
    xf = x.to(torch.float32)
    if prim == "reduce_sum":
        return xf.sum(-1, keepdim=True)
    if prim == "reduce_prod":
        return xf.prod(-1, keepdim=True)
    if prim in ("reduce_max", "reduce_or"):
        return xf.amax(-1, keepdim=True)
    return xf.amin(-1, keepdim=True)


def _combine(prim: str, acc: torch.Tensor, part: torch.Tensor):
    if prim == "reduce_sum":
        return acc + part
    if prim == "reduce_prod":
        return acc * part
    if prim in ("reduce_max", "reduce_or"):
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
    """A generated kernel for one group plus its plain version: the
    wrapper (CPU tensors run ``plain``, CUDA tensors ``launch``) and the
    row views of its inputs and outputs.

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
        #: {ext position: output position}: the output is written into
        #: that donated input's storage (``_alias_map``)
        self.io_aliases: dict[int, int] = {}

    # -- wrapper ---------------------------------------------------------------
    def __call__(self, device, *vals) -> tuple:
        devs = {v.device.type for v in vals} or {torch.device(device).type}
        if devs == {"cpu"}:
            return self._write_aliases(vals, self.plain(device, *vals))
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

    def _in_nodes(self) -> list[int]:
        return self.ext_ids + self.const_ids

    def _donated(self, vals, i: int, like: torch.Tensor) -> bool:
        """Can output ``like`` live in input ``i``'s storage?  Only a
        contiguous input of its dtype: another would be copied by
        ``contiguous()`` and the output land in the copy."""
        v = vals[i]
        return (v.is_contiguous() and v.dtype == like.dtype
                and v.numel() == like.numel())

    def _aliased(self, vals, outs: list[torch.Tensor]) -> list[torch.Tensor]:
        """The kernel's output buffers, each aliased one in its donated
        input's storage."""
        for i, j in self.io_aliases.items():
            if self._donated(vals, i, outs[j]):
                outs[j] = vals[i].view(outs[j].shape)
        return outs

    def _write_aliases(self, vals, outs: tuple) -> tuple:
        """The plain version's outputs, each aliased one copied into its
        donated input's storage and returned as it, as the kernel writes
        it there.  An output that is a view of a donated input is cloned
        first: the copy would overwrite it."""
        if not self.io_aliases:
            return outs
        writes = [(i, j) for i, j in self.io_aliases.items()
                  if self._donated(vals, i, outs[j])]
        dst = {vals[i].untyped_storage().data_ptr() for i, _ in writes}
        outs = [o.clone() if o.untyped_storage().data_ptr() in dst else o
                for o in outs]
        for i, j in writes:
            outs[j] = vals[i].view(outs[j].shape).copy_(outs[j])
        return tuple(outs)


class OnePassKernel(RowKernel):
    """Block composition (Triton): one program, ``BR`` whole rows, all in
    registers."""

    schedule = "onepass"
    launches = 0

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.BLOCK_C = next_pow2(self.C)
        self.BR = next_pow2(self.block_rows)
        self._src: str | None = None
        self._kernel = None

    def launch(self, *vals) -> tuple:
        device = vals[0].device if vals else torch.device("cuda")
        ins = [x.contiguous() for x in self._inputs(vals, device)]
        outs = self._aliased(vals, self._alloc_outputs(device))
        kernel, grid, meta = self._compiled()
        kernel[grid](*ins, *outs, self.R, self.C, **meta)
        _build.count(type(self))
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
        if prim in ("reduce_and", "reduce_or"):
            operand = f"(({operand}) != 0)"
        x = f"tl.where({mask}, ({operand}).to(tl.float32), {ident})"
        if prim == "reduce_prod":
            return f"tl.reduce({x}, 1, _prod)[:, None]"
        fn = {"reduce_sum": "tl.sum", "reduce_max": "tl.max",
              "reduce_min": "tl.min", "reduce_and": "tl.min",
              "reduce_or": "tl.max"}[prim]
        return f"{fn}({x}, axis=1)[:, None]"

    def _from_f32(self, expr: str, nid: int) -> str:
        """A float32 reduction result as node ``nid``'s type."""
        if self.graph.node(nid).spec.dtype == "bool":
            return f"({expr} != 0)"
        return f"{expr}.to({self._dt(nid)})"

    def _signature(self) -> list[str]:
        n_in = len(self.ext_ids) + len(self.const_ids)
        return ([f"in{k}" for k in range(n_in)]
                + [f"out{k}" for k in range(len(self.out_ids))])


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
                return self._from_f32(e, nid)
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


#: Shared memory in which a CTA of the streaming kernel stages its slice
#: of a row (``csrc/streaming.cuh``): three CTAs an SM at this size.
STAGE_BYTES = 64 * 1024
#: The most CTAs a row is split across: the portable cluster size.
MAX_CLUSTER = 8


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _ptrs(ts):
    return (ctypes.c_void_p * max(1, len(ts)))(*[t.data_ptr() for t in ts])


class StreamingKernel(RowKernel):
    """Multi-phase streaming (B2): the group as generated CUDA C++
    (``codegen_cuda.stream_struct``) in ``csrc/streaming.cuh``, each row
    held on chip across a thread-block cluster (``cluster``).  Its plain
    version walks the same phases over ``BC``-wide column tiles with
    float32 accumulators."""

    schedule = "streaming"
    launches = 0

    def __init__(self, *a, block_cols: int, eager: bool = False, **kw):
        super().__init__(*a, **kw)
        pat = frozenset(self.members)
        self.lvl = reduce_levels(self.graph, pat)
        self.phases = max(self.lvl.values(), default=0) + 1
        self.reduces = [n for n in self.members
                        if self.graph.node(n).kind is OpKind.REDUCE]
        self.BC = next_pow2(max(1, min(block_cols, self.C)))
        self.BR = next_pow2(self.block_rows)
        self.staged = cc.staged_inputs(self.graph, self.roles,
                                       self._in_nodes())
        self.entry = cc.GeneratedEntry("stream", self._generate,
                                       "repro_stream_launch",
                                       cc.STREAM_ARGTYPES,
                                       eager=eager)

    def cluster(self) -> tuple[int, int, int]:
        """(K, slice, staged): a cluster owns one row, split across K
        CTAs, the fewest whose slices fit ``STAGE_BYTES`` (at most
        ``MAX_CLUSTER``); each owns ``slice`` columns and stages ``staged``
        of them (all, but in a row longer than the cluster holds)."""
        per_col = sum(b for _, b in self.staged)
        K = 1
        while (K < MAX_CLUSTER
               and per_col * _round16(_cdiv(self.C, K)) > STAGE_BYTES):
            K *= 2
        width = _round16(_cdiv(self.C, K))
        staged = width if per_col == 0 else min(
            width, STAGE_BYTES // per_col // 16 * 16)
        return K, width, staged

    def launch(self, *vals) -> tuple:
        device = vals[0].device if vals else torch.device("cuda")
        if any(v.device.type != "cuda" for v in vals):
            raise ValueError("streaming kernel: the kernel takes CUDA "
                             "tensors; got " + ", ".join(
                                 str(v.device) for v in vals))
        for i, v in zip(self.ext_ids, vals):
            want = TORCH_DTYPES[self.graph.node(i).spec.dtype]
            if v.dtype != want:
                raise TypeError(f"streaming kernel: input {i} is {v.dtype}, "
                                f"the group was compiled for {want}")
        ins = [x.contiguous() for x in self._inputs(vals, device)]
        outs = self._aliased(vals, self._alloc_outputs(device))
        K, width, staged = self.cluster()
        # bulk copies need every staged row 16-byte aligned
        bulk = all(ins[k].data_ptr() % 16 == 0 and self.C * b % 16 == 0
                   for k, b in self.staged)

        _build.check(self.entry(
            _ptrs(ins), _ptrs(outs), self.R, self.C, K, width, staged,
            int(bulk), torch.cuda.current_stream(device).cuda_stream),
            "repro_stream_launch")
        _build.count(type(self))
        return self._outputs(outs)

    def host(self, lib, *vals) -> tuple:
        """The generated source's host form on CPU tensors: ``lib`` is the
        source built for the host with g++ (its ``repro_host_stream``
        walks every row phase by phase), the CPU tests' check of the
        generated C++ against the plain version."""
        ins = [x.contiguous() for x in self._inputs(vals, torch.device("cpu"))]
        outs = self._alloc_outputs("cpu")
        lib.repro_host_stream(_ptrs(ins), _ptrs(outs),
                              ctypes.c_longlong(self.R),
                              ctypes.c_longlong(self.C))
        return self._outputs(outs)

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

    # -- CUDA C++ source --------------------------------------------------------
    def source(self) -> str:
        return self.entry.source

    def _generate(self) -> str:
        return cc.streaming_source(cc.stream_struct(
            self.graph, self.members, self.roles, self._in_nodes(),
            self.out_ids))


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
             "def _prod(a, b):",
             "    return a * b",
             "",
             "",
             "@triton.jit",
             "def _nextafter(x, y):",
             "    # IEEE nextafter on float32 bits: a step of one toward y",
             "    bits = x.to(tl.int32, bitcast=True)",
             "    step = tl.where((x > 0) == (y > x), 1, -1)",
             "    r = (bits + step).to(tl.float32, bitcast=True)",
             "    tiny = tl.where(y > x, 1, -2147483647).to(tl.float32,",
             "                                              bitcast=True)",
             "    r = tl.where(x == 0, tiny, r)",
             "    r = tl.where(x == y, y, r)",
             "    return tl.where((x != x) | (y != y), x + y, r)",
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


def _override_estimate(graph: Graph, pattern: frozenset[int], info,
                       override: dict, hw: Hardware,
                       ctx=None) -> KernelEstimate | None:
    """Re-price a cached or tuned schedule choice; None if it does not
    apply (the reference's ``codegen._override_estimate``): an unknown
    schedule, no row view, or a block the preset refuses (the register
    cap under ``H100``) degrade to the analytic sweep."""
    from .cost_model import estimate_onepass, estimate_streaming

    sched = override.get("schedule")
    if sched == "packed":
        return estimate_packed(graph, pattern, hw, ctx=ctx)
    if info is None:
        return None
    if sched == "onepass":
        rec = frozenset(int(x) for x in override.get("recompute", ())
                        if isinstance(x, int)
                        and not isinstance(x, bool)) & pattern
        if rec:
            # a corrupt or hand-edited pin naming an output (or a value
            # nothing inside reads) must degrade, not miscompile: the
            # generator never materializes a recomputed value.
            outs = set(graph.pattern_outputs(pattern))
            rec = frozenset(
                r for r in rec
                if r not in outs
                and any(c in pattern for c in graph.consumers(r)))
        est = estimate_onepass(graph, pattern, info,
                               int(override.get("block_rows", 8)), hw,
                               ctx=ctx, recompute=rec or None)
        return est if est.feasible else None
    if sched == "streaming":
        est = estimate_streaming(graph, pattern, info,
                                 int(override.get("block_rows", 8)),
                                 int(override.get("block_cols", 2048)), hw,
                                 ctx=ctx)
        return est if est.feasible else None
    return None


def _alias_map(graph: Graph, roles: dict, ext_ids: list[int],
               out_ids: list[int],
               donate_into: frozenset[int] | None) -> dict[int, int]:
    """Donated inputs written over by the one-pass kernel's outputs (the
    reference's ``codegen._alias_map``): each input of ``donate_into``
    (graph inputs whose only readers are this group's members) takes the
    first unclaimed output of its role and dtype, FULL -> FULL or ROW ->
    ROW.  Legal for ``OnePassKernel``: a program loads its row block
    whole before it stores, and no other program touches those rows.  A
    COL or scalar input is read by every program: never aliased."""
    aliases: dict[int, int] = {}
    for i, e in enumerate(ext_ids):
        if not donate_into or e not in donate_into:
            continue
        role = roles.get(e)
        if role not in (Role.FULL, Role.ROW):
            continue
        for j, o in enumerate(out_ids):
            if (j not in aliases.values() and roles[o] is role
                    and graph.node(o).spec.dtype == graph.node(e).spec.dtype):
                aliases[i] = j
                break
    return aliases


def _alias_map_streaming(kern: "StreamingKernel",
                         donate_into: frozenset[int] | None
                         ) -> dict[int, int]:
    """``_alias_map`` for the streaming kernel (B2), re-derived for
    ``csrc/streaming.cuh``: only FULL -> FULL, and only an input the
    kernel stages, while the cluster holds the whole row (``staged`` =
    ``slice``).  Every phase then reads that input from shared memory,
    each element staged by the thread (or the bulk copy completed)
    before the last phase stores over it.  Refused: a row longer than
    the cluster holds (the columns past the stage are read from device
    memory in every phase, after an earlier phase may have stored), an
    unstaged input (read from device memory in every phase), and ROW
    inputs (every thread of the row's CTAs reads them in every phase)."""
    _, width, staged = kern.cluster()
    if not donate_into or staged < width:
        return {}
    pos = sorted(k for k, _ in kern.staged if k < len(kern.ext_ids))
    sub = _alias_map(kern.graph, kern.roles, [kern.ext_ids[k] for k in pos],
                     kern.out_ids, donate_into)
    return {pos[i]: j for i, j in sub.items()}


def emit_pattern(graph: Graph, pattern: frozenset[int], *,
                 hw: Hardware = H100, ctx=None,
                 schedule_override: dict | None = None,
                 donate_into: frozenset[int] | None = None) -> Emitted:
    """Compile one pattern (a single-part group)."""
    return emit_group(graph, (tuple(sorted(pattern)),), hw=hw, ctx=ctx,
                      schedule_override=schedule_override,
                      donate_into=donate_into)


def emit_group(graph: Graph, parts, *, hw: Hardware = H100,
               ctx=None, anchors: tuple = (),
               schedule_override: dict | None = None,
               donate_into: frozenset[int] | None = None) -> Emitted:
    """Compile one stitch group into a single generated kernel (paper §4).

    ``parts`` are the group's member patterns.  The union runs as ONE
    kernel executing the parts back-to-back (inter-part values stay in
    registers; ``plan_group_scratch`` still prices the spanning liveness
    for the report).  A union with no row view or a non-emittable member
    runs packed.  A group with ``anchors`` becomes one anchored compute
    kernel (``_emit_anchored``), whose scheme is fixed: an override does
    not apply to it.  ``schedule_override`` (from the plan cache or the
    measured tuner) pins {schedule, block_rows, block_cols, recompute}
    instead of the analytic sweep's pick; one that does not apply
    (``_override_estimate``) falls back to the sweep.  ``donate_into``
    names graph inputs whose only readers are this group's members: a
    generated kernel writes outputs over them where its scheme allows
    (``_alias_map``, ``_alias_map_streaming``; ``Emitted.io_aliases``).
    An anchored or packed group aliases nothing, as in the reference.
    """
    if anchors:
        return _emit_anchored(graph, parts, tuple(sorted(anchors)), hw=hw,
                              ctx=ctx)
    parts = tuple(tuple(sorted(p)) for p in parts)
    parts_fs = tuple(frozenset(p) for p in parts)
    union = frozenset(n for p in parts for n in p)
    info = ctx.info(union) if ctx is not None else analyze(graph, union)
    est = None
    if schedule_override:
        est = _override_estimate(graph, union, info, schedule_override, hw,
                                 ctx=ctx)
    if est is None:
        est = ctx.best(union) if ctx is not None \
            else best_estimate(graph, union, hw)
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
                                   block_cols=est.block_cols or 2048,
                                   eager=hw.platform == "gpu")
        kern.io_aliases = (
            _alias_map(graph, info.roles, ext_ids, out_ids, donate_into)
            if est.schedule == "onepass"
            else _alias_map_streaming(kern, donate_into))
        return Emitted(kern, kern.schedule, est, ext_ids, out_ids,
                       scratch.total_bytes, scratch.naive_bytes, parts=parts,
                       hbm_saved=hbm_saved, n_recomputed=len(rec),
                       recompute_bytes_freed=rec_freed,
                       io_aliases=kern.io_aliases or None)

    fn = _emit_packed(graph, union, ext_ids, out_ids)
    if est.schedule != "packed":  # emitter gap: price what actually runs
        est = estimate_packed(graph, union, hw, ctx=ctx)
    return Emitted(fn, "packed", est, ext_ids, out_ids, 0, 0, parts=parts,
                   hbm_saved=hbm_saved)


# --------------------------------------------------------------------------
# compute-anchored emission
# --------------------------------------------------------------------------
def _eval_chain(graph: Graph, order: Sequence[int], roles: dict, rows: int,
                cols: int, env: dict) -> dict:
    """The plain version of a folded chain: its members in ``order`` on
    whole row-view tensors (``_RowEval``), ``env`` holding the operands'
    views; multi-element constants are read by role."""
    device = next(iter(env.values())).device
    ev = _RowEval(graph, roles, rows, cols, device)
    ev.env.update(env)
    for nid in order:
        node = graph.node(nid)
        if node.kind is OpKind.CONST:
            continue
        for i in node.inputs:
            if i not in ev.env and graph.node(i).kind is OpKind.CONST \
                    and graph.node(i).spec.size > 1:
                ev.env[i] = _to_rowview(const_tensor(graph.node(i), device),
                                        roles[i], rows, cols)
        ev.env[nid] = ev.compute(nid)
    return ev.env


def _anchored_estimate(graph: Graph, union: frozenset[int],
                       hw: Hardware, block_rows: int,
                       n_steps: int) -> KernelEstimate:
    """An anchored kernel's latency: its bytes over the HBM rate, each
    anchor's products over ``hw.bf16_flops`` where both its operands are
    bfloat16 (and the preset names that rate), else ``hw.peak_flops``."""
    hbm = graph.pattern_hbm_bytes(union)
    compute_s = 0.0
    for a in union:
        node = graph.node(a)
        if node.kind is not OpKind.ANCHOR:
            continue
        ins = [graph.node(i).spec for i in node.inputs[:2]]
        flops = 2 * node.spec.size * ins[0].shape[-1]
        native = hw.bf16_flops and all(s.dtype == "bfloat16" for s in ins)
        compute_s += flops / (hw.bf16_flops if native else hw.peak_flops)
    return KernelEstimate(
        schedule="anchored", block_rows=block_rows,
        latency_s=hbm / hw.hbm_bw + compute_s
        + hw.launch_s + hw.hbm_latency_s,
        hbm_bytes=hbm, vpu_ops=0.0, scratch_bytes=0,
        n_steps=n_steps, feasible=True)


def _chain_operands(graph: Graph, members: frozenset[int],
                    skip: set[int]) -> list[int]:
    """A chain's operands: its external inputs (not ``skip``) that are
    runtime values or multi-element constants, in the order of
    ``pattern_inputs``."""
    return [i for i in graph.pattern_inputs(members)
            if i not in skip and (graph.node(i).kind is not OpKind.CONST
                                  or graph.node(i).spec.size > 1)]


def _emit_anchored(graph: Graph, parts, anchors, *, hw: Hardware = H100,
                   ctx=None) -> Emitted:
    """Compile an anchored stitch group into ONE compute kernel whose
    grid also runs the folded prologue/epilogue chains.  Raises
    ``AnchorEmitError`` on a structure the matchers refuse: there is no
    fallback rung."""
    from .cost_model import anchor_interface_bytes

    parts = tuple(tuple(sorted(p)) for p in parts)
    union = frozenset(n for p in parts for n in p)
    anchor_set = set(anchors)
    ext_ids, out_ids = _boundary(graph, union, ctx)
    folded = tuple(frozenset(p) for p in parts
                   if not (len(p) == 1 and p[0] in anchor_set))
    hbm_saved = anchor_interface_bytes(graph, anchors, folded)
    if len(anchors) == 1:
        m = _match_matmul_anchor(graph, union, anchors[0])
        if m is None:
            raise AnchorEmitError("anchored matmul: structure mismatch")
        return _emit_anchored_matmul(graph, parts, m, ext_ids, out_ids,
                                     hbm_saved, folded, hw=hw)
    if len(anchors) == 2:
        m = _match_attention_anchors(graph, union, anchors)
        if m is None:
            raise AnchorEmitError("anchored attention: structure mismatch")
        if list(out_ids) != [m["pv"]]:
            raise AnchorEmitError("anchored attention: escaping chain value")
        return _emit_anchored_attention(graph, parts, m, ext_ids,
                                        hbm_saved, folded, hw=hw)
    raise AnchorEmitError(f"unsupported anchor count {len(anchors)}")


def _scratch(graph: Graph, anchors, folded, hw: Hardware,
             tpu_bytes: int) -> int:
    """Report bytes of an anchored kernel: the reference's figure under a
    TPU preset, the CUDA instance's shared memory under a GPU one."""
    from .cost_model import _anchor_vmem

    if hw.platform == "gpu":
        got = _anchor_vmem(graph, anchors, hw, folded)
        return 0 if got is None else got
    return tpu_bytes


def _emit_anchored_matmul(graph: Graph, parts, m: dict, ext_ids, out_ids,
                          hbm_saved: int, folded, *,
                          hw: Hardware) -> Emitted:
    """B3: ``kernels.matmul.matmul_fused`` with the chains as its plain
    prologue/epilogue callables and a generated CUDA instance
    (``codegen_cuda``) for the card."""
    from ..kernels import matmul as mm
    from . import codegen_cuda as cc

    a, lhs_id, rhs_id = m["a"], m["lhs"], m["rhs"]
    M, K, N = m["M"], m["K"], m["N"]
    pro, epi = m["pro"], m["epi"]
    pro_info, epi_info = m["pro_info"], m["epi_info"]
    pro_order, epi_order = sorted(pro), sorted(epi)

    if pro:
        pro_ops = _chain_operands(graph, pro, set())
        pro_roles_d = pro_info.roles

        def prologue(*blocks):
            env = _eval_chain(graph, pro_order, pro_roles_d, M, K,
                              dict(zip(pro_ops, blocks)))
            return env[lhs_id].expand(M, K)
    else:
        pro_ops, prologue = [lhs_id], None
        pro_roles_d = {lhs_id: Role.FULL}
    if epi:
        epi_ops = _chain_operands(graph, epi, {a})
        epi_roles_d = epi_info.roles

        acc_dtype = TORCH_DTYPES[graph.node(a).spec.dtype]

        def epilogue(acc, *blocks):
            env = dict(zip(epi_ops, blocks))
            # the product in its own type, as the reference's anchor_dtype
            env[a] = acc.to(acc_dtype)
            env = _eval_chain(graph, epi_order, epi_roles_d, M, N, env)
            return tuple(env[o] for o in out_ids)
    else:
        epi_ops, epilogue = [], None
        epi_roles_d = {a: Role.FULL}
    pro_roles = [pro_roles_d[i].value for i in pro_ops]
    epi_roles = [epi_roles_d[i].value for i in epi_ops]
    out_roles = [epi_roles_d[o].value for o in out_ids]
    out_dtypes = [TORCH_DTYPES[graph.node(o).spec.dtype] for o in out_ids]
    out_shapes = [graph.node(o).spec.shape for o in out_ids]
    epi_slots = sum(graph.node(n).kind is OpKind.REDUCE for n in epi)
    pro_slots = sum(graph.node(n).kind is OpKind.REDUCE for n in pro)
    row_reduce = epi_slots > 0
    # bfloat16 lhs and rhs: the native instances; any other pair the TF32
    # split's
    native = (graph.node(lhs_id).spec.dtype
              == graph.node(rhs_id).spec.dtype == "bfloat16")
    tile = mm.pick_tile(M, N, row_reduce, native)
    tiles = ([mm.TILES.index(mm.TILE_ROW)] if row_reduce else
             [mm.TILES.index(t) for t in (mm.TILE_LARGE, mm.TILE_SMALL,
                                          mm.TILE_DECODE)])

    def source() -> str:
        return cc.matmul_source(
            cc.prologue_struct(graph, pro_order, pro_roles_d, pro_ops,
                               lhs_id, graph.node(rhs_id).spec.dtype),
            cc.epilogue_struct(graph, epi_order, epi_roles_d, epi_ops, a,
                               out_ids, split=native), tiles, native)

    entry = cc.GeneratedEntry("mm", source, "repro_mm_fused",
                              cc.MATMUL_ARGTYPES,
                              eager=hw.platform == "gpu")
    entry.epi_slots, entry.pro_slots = epi_slots, pro_slots
    entry.native = native

    def operands(device, ext_vals):
        env = dict(zip(ext_ids, ext_vals))

        def get(i):
            return env[i] if i in env else const_tensor(graph.node(i),
                                                        device)

        return ([get(i) for i in pro_ops], get(rhs_id),
                [get(i) for i in epi_ops])

    def run(call, device, ext_vals, **kw):
        outs = call(*operands(device, ext_vals), M=M, K=K, N=N,
                    out_roles=out_roles, out_dtypes=out_dtypes, **kw)
        return tuple(o.reshape(s) for o, s in zip(outs, out_shapes))

    chains = dict(pro_roles=pro_roles, epi_roles=epi_roles,
                  prologue=prologue, epilogue=epilogue)

    def fn(device, *ext_vals):
        return run(mm.matmul_fused, device, ext_vals, entry=entry, tile=tile,
                   **chains)

    # the kernel and its plain version on tensors of any one device (the
    # plain version on the card is chip_smoke's yardstick)
    fn.launch = lambda *v: run(mm.matmul_fused_cuda, v[0].device, v,
                               entry=entry, tile=tile)
    fn.plain = lambda *v: run(mm.matmul_fused_plain, v[0].device, v,
                              **chains)
    fn.entry, fn.tile = entry, tile
    fn.chain = {"M": M, "K": K, "N": N, "pro_ops": pro_ops,
                "pro_roles": pro_roles, "prologue": prologue,
                "epi_ops": epi_ops, "epi_roles": epi_roles,
                "epilogue": epilogue, "out_roles": out_roles,
                "out_dtypes": out_dtypes}
    union = frozenset(n for p in parts for n in p)
    bm = max(1, min(mm.DEFAULT_BLOCK_M, M))
    est = _anchored_estimate(graph, union, hw, bm, math.ceil(M / bm))
    tpu = bm * K * graph.node(lhs_id).spec.itemsize \
        + K * N * graph.node(rhs_id).spec.itemsize + bm * N * 4
    vmem = _scratch(graph, (a,), folded, hw, tpu)
    return Emitted(fn, "anchored", est, ext_ids, list(out_ids), vmem, vmem,
                   parts=parts, hbm_saved=hbm_saved)


def _emit_anchored_attention(graph: Graph, parts, m: dict, ext_ids,
                             hbm_saved: int, folded, *,
                             hw: Hardware) -> Emitted:
    """B4 with a score chain: ``kernels.flash_attention`` called with
    ``causal=False`` and ``scale=1.0`` (the chain carries the graph's own
    scale), as the reference calls it."""
    from ..kernels import flash_attention as fa
    from . import codegen_cuda as cc

    qk, pv = m["qk"], m["pv"]
    q_id, k_id, v_id = m["q"], m["k"], m["v"]
    B, H, Sq, Sk = m["extent"]
    D = m["D"]
    s_pre, score, score_ext = m["s_pre"], m["score"], m["score_ext"]
    score_order = sorted(score)
    out_spec = graph.node(pv).spec
    score_shapes = [_pad4(graph.node(i).spec.shape) for i in score_ext]

    qk_dtype = TORCH_DTYPES[graph.node(qk).spec.dtype]

    def plain_mod(s, *args):
        # the product in its own type first, as the generated functor
        env = {qk: s.reshape(graph.node(qk).spec.shape).to(qk_dtype)}
        env.update((i, a.reshape(graph.node(i).spec.shape))
                   for i, a in zip(score_ext, args))
        run_subgraph(graph, score_order, env, s.device)
        return env[s_pre].expand(B, H, Sq, Sk)

    wide = fa.flash_instance(D) is None

    def source() -> str:
        return cc.attention_source(
            cc.score_struct(graph, score_order, score_ext, qk, s_pre),
            wide=wide, dtype=graph.node(q_id).spec.dtype)

    mod = None
    if score:
        mod = fa.ScoreMod(plain_mod, cc.GeneratedEntry(
            "attn", source, "repro_flash_scored", cc.ATTENTION_ARGTYPES,
            eager=hw.platform == "gpu"), wide=wide)

    def run(call, device, ext_vals):
        env = dict(zip(ext_ids, ext_vals))

        def get(i):
            return env[i] if i in env else const_tensor(graph.node(i),
                                                        device)

        sargs = [get(i).reshape(sh) for i, sh in zip(score_ext, score_shapes)]
        out = call(get(q_id), get(k_id), get(v_id), False, 1.0,
                   score_mod=mod, score_args=sargs)
        return (out.to(TORCH_DTYPES[out_spec.dtype])
                .reshape(out_spec.shape),)

    def fn(device, *ext_vals):
        return run(fa.flash_attention, device, ext_vals)

    fn.launch = lambda *v: run(fa.flash_attention_cuda, v[0].device, v)
    fn.plain = lambda *v: run(fa.flash_attention_plain, v[0].device, v)
    fn.score_mod = mod
    fn.score_operands = list(zip(score_ext, score_shapes))
    fn.extent = (B, H, Sq, Sk)
    union = frozenset(n for p in parts for n in p)
    bq = max(1, min(fa.FLASH_BQ, Sq))
    n_steps = B * H * math.ceil(Sq / bq) * math.ceil(Sk / fa.flash_kbk(D))
    est = _anchored_estimate(graph, union, hw, bq, n_steps)
    rb, rk = max(1, min(128, Sq)), max(1, min(128, Sk))
    tpu = rb * D * 4 + rk * D * 8 + rb * rk * 4 + rb * (D + 2) * 4
    vmem = _scratch(graph, (qk, pv), folded, hw, tpu)
    return Emitted(fn, "anchored", est, ext_ids, [pv], vmem, vmem,
                   parts=parts, hbm_saved=hbm_saved)
