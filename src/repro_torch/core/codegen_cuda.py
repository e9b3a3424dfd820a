"""CUDA C++ lowering of stitched chains: the hooks of the anchored kernels.

Compute-anchored stitching folds memory-bound chains into a compute
kernel: a prologue and an epilogue into the fused matmul B3
(``csrc/matmul_fused.cuh``) and a score chain into flash attention
(``csrc/flash_attention.cuh``).  This module writes each chain as C++
functions of ONE element (the row view's roles decide how an operand is
indexed: ``full`` by (row, column), ``row`` by row, ``col`` by column,
``scalar`` once), and the ``.cu`` source that instantiates the kernel
template with them.  It lowers exactly ``codegen.EMITTABLE_PRIMS`` (the
Triton generator's set, one vocabulary for both), each node on its own
dtype (``_typed``): the anchored chains hold float32, bfloat16 and bool
values (the H100 gate refuses others; a bfloat16 value computes in
float32, rounds to its type at its node and is stored as its bits), the
streaming groups every dtype of the row view.

* ``prologue_struct`` -- ``Pro``: the lhs element (m, k), in phases
  where the prologue reduces over K (its statistics first).
* ``epilogue_struct`` -- ``Epi``: the epilogue in phases, as the
  streaming kernel runs a group: phase p evaluates the nodes of reduce level
  <= p and accumulates the reductions of level p + 1; the last phase
  stores the outputs.
* ``score_struct`` -- ``Score``: flash attention's score functor (the
  tuned instances' template, or the wide kernel's above head dim 256).
* ``stream_struct`` -- ``Group``: a whole stitched group for the
  streaming kernel (``csrc/streaming.cuh``, B2), in the same phases, on
  the group's own dtypes: bfloat16 and float16 values compute in float32
  and round to their type at every node that has it, as PyTorch does.

Every function is ``__host__ __device__``: under a host compile
(``csrc/chain.cuh`` makes the two empty macros) the same text builds
with g++, and ``host_harness`` adds C entry points that run the chains
on host arrays, so the CPU tests hold the generated C++ to the plain
row-view evaluator without a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import re
from typing import Sequence

from .ir import Graph, OpKind
from .rowspec import Role

_CU_UNARY = {
    "exp": "expf({0})", "exp2": "exp2f({0})", "log": "logf({0})",
    "sin": "sinf({0})", "cos": "cosf({0})", "sqrt": "sqrtf({0})",
    "rsqrt": "repro_chain::rsqrt_({0})",
    "logistic": "repro_chain::logistic({0})", "erf": "erff({0})",
    "erfc": "erfcf({0})", "floor": "floorf({0})", "ceil": "ceilf({0})",
    "round": "rintf({0})", "expm1": "expm1f({0})", "log1p": "log1pf({0})",
    "tanh": "tanhf({0})", "cbrt": "cbrtf({0})", "abs": "fabsf({0})",
    "neg": "(-{0})", "sign": "repro_chain::sign({0})",
    "is_finite": "repro_chain::finite({0})", "not": "(!{0})",
    "square": "({0} * {0})",
}
_CU_BINARY = {
    "add": "({0} + {1})", "sub": "({0} - {1})", "mul": "({0} * {1})",
    "div": "({0} / {1})", "max": "fmaxf({0}, {1})",
    "min": "fminf({0}, {1})", "pow": "powf({0}, {1})",
    "atan2": "atan2f({0}, {1})", "rem": "fmodf({0}, {1})",
    "nextafter": "nextafterf({0}, {1})", "eq": "({0} == {1})",
    "ne": "({0} != {1})", "ge": "({0} >= {1})", "gt": "({0} > {1})",
    "le": "({0} <= {1})", "lt": "({0} < {1})", "and": "({0} && {1})",
    "or": "({0} || {1})", "xor": "({0} != {1})",
}
#: reduce node -> the combine code of ``csrc/chain.cuh`` (repro_chain::ident)
REDUCE_OPS = {"reduce_sum": 0, "reduce_max": 1, "reduce_min": 2,
              "reduce_prod": 3, "reduce_and": 4, "reduce_or": 5}
_PASS = ("reshape", "squeeze", "expand_dims", "copy", "stop_gradient",
         "broadcast_in_dim")
_OTHER = ("convert_element_type", "integer_pow", "select_n", "clamp", "const")

#: Everything this module lowers.
CUDA_PRIMS = frozenset(set(_CU_UNARY) | set(_CU_BINARY) | set(REDUCE_OPS)
                       | set(_PASS) | set(_OTHER))

_CTYPES = {"float32": "float", "bfloat16": "float", "bool": "bool"}


def ctype(dtype: str) -> str:
    """What an anchored chain's value of ``dtype`` computes in."""
    if dtype not in _CTYPES:
        raise ValueError(f"the anchored CUDA chains hold float32, bfloat16 "
                         f"and bool values, not {dtype}")
    return _CTYPES[dtype]


def literal(value, dtype: str) -> str:
    v = value.item() if hasattr(value, "item") else value
    if dtype == "bool":
        return "true" if bool(v) else "false"
    v = float(v)
    if math.isnan(v):
        return "NAN"
    if math.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    r = repr(v)
    return f"{r}f" if ("." in r or "e" in r) else f"{r}.0f"


def _expr(graph: Graph, nid: int, ins: Sequence[str]) -> str:
    """C++ expression of one non-reduce node on its inputs' element
    values, but for the casts, which ``_typed`` writes."""
    node = graph.node(nid)
    prim = node.prim
    in_dt = [graph.node(i).spec.dtype for i in node.inputs]
    if prim in _PASS:
        return ins[0]
    if prim == "integer_pow":
        y = int(node.params["y"])
        if y == 0:
            return "1.0f"
        base = ins[0] if y > 0 else f"(1.0f / {ins[0]})"
        return "(" + " * ".join([base] * abs(y)) + ")"
    if prim == "select_n" and len(ins) == 3:
        pred = ins[0] if in_dt[0] == "bool" else f"({ins[0]} != 0)"
        return f"({pred} ? {ins[2]} : {ins[1]})"
    if prim == "clamp":
        return f"fminf(fmaxf({ins[1]}, {ins[0]}), {ins[2]})"
    if prim in _CU_UNARY:
        return _CU_UNARY[prim].format(ins[0])
    if prim in _CU_BINARY:
        return _CU_BINARY[prim].format(*ins)
    raise NotImplementedError(f"primitive {prim!r} has no CUDA lowering")


#: The streaming groups' types: what a value of each dtype computes in,
#: and what it is stored as.
_COMPUTE = {"float32": "float", "bfloat16": "float", "float16": "float",
            "float64": "double", "bool": "bool", "int64": "long long",
            "int32": "int", "int16": "short", "int8": "signed char",
            "uint8": "unsigned char"}
_STORAGE = dict(_COMPUTE, bfloat16="uint16_t", float16="uint16_t")
_HALF = {"bfloat16": "bf16", "float16": "f16"}
#: dtypes B3 stages a (M, K) prologue operand (or the lhs) in by cp.async
_MM_STAGED = ("float32", "bfloat16")
#: dtypes the streaming kernel stages in shared memory (as float32 values
#: they are exact); the others it reads from device memory in every phase
STAGED_DTYPES = {"float32": 4, "bfloat16": 2, "float16": 2, "bool": 1,
                 "int8": 1, "uint8": 1, "int16": 2}
_FLOATS = ("float32", "bfloat16", "float16", "float64")


def _typed(graph: Graph, nid: int, ins: Sequence[str]) -> str:
    """The C++ expression of one non-reduce node on its own dtype:
    integer or bool inputs of a floating node are cast to its type first
    (C++ would divide integers), integer logic is bitwise, and a bfloat16
    or float16 result is rounded to its type."""
    node = graph.node(nid)
    dt = node.spec.dtype
    if dt in _FLOATS and node.prim not in _PASS:
        ins = [f"static_cast<{_COMPUTE[dt]}>({x})"
               if graph.node(i).spec.dtype not in _FLOATS else x
               for i, x in zip(node.inputs, ins)]
    if node.prim == "convert_element_type":
        e = (f"({ins[0]} != 0)" if dt == "bool"
             else f"static_cast<{_COMPUTE[dt]}>({ins[0]})")
    elif dt not in _FLOATS and dt != "bool" and node.prim in ("and", "or",
                                                              "xor"):
        e = "({0} {op} {1})".format(*ins, op={"and": "&", "or": "|",
                                              "xor": "^"}[node.prim])
    else:
        e = _expr(graph, nid, ins)
    if dt in _HALF:
        return f"repro_chain::round_{_HALF[dt]}(static_cast<float>({e}))"
    return e if dt == "bool" else f"static_cast<{_COMPUTE[dt]}>({e})"


class _Writer:
    """Member statements of one element chain.  Values are named by
    position (operand k is ``xk``, the j-th member ``vj``), never by node
    id, so that isomorphic chains of different graphs -- a layer's
    prefill and decode signatures, the forward and the serving path --
    write the same source and share one build.  Each node computes on its
    own dtype (``_typed``)."""

    def __init__(self, graph: Graph, operands: Sequence[int],
                 members: Sequence[int]):
        self.graph = graph
        self.names = {i: f"x{k}" for k, i in enumerate(operands)}
        self.local = {n: f"v{j}" for j, n in enumerate(members)}

    def val(self, i: int) -> str:
        if i in self.names:
            return self.names[i]
        n = self.graph.node(i)  # a scalar const
        if n.spec.dtype not in _FLOATS + ("bool",):
            return f"static_cast<{_COMPUTE[n.spec.dtype]}>({int(n.value)})"
        return literal(n.value, "bool" if n.spec.dtype == "bool"
                       else "float32")

    def stmt(self, nid: int) -> str:
        node = self.graph.node(nid)
        ins = [self.val(i) for i in node.inputs]
        e = _typed(self.graph, nid, ins)
        self.names[nid] = self.local[nid]
        return (f"const {_COMPUTE[node.spec.dtype]} {self.local[nid]} = "
                f"{e};")


def _load_expr(k: int, dtype: str, index: str) -> tuple[str, str]:
    """(computed type, expression) of operand ``k`` read at ``index``."""
    v = f"static_cast<const {_STORAGE[dtype]}*>(in[{k}])[{index}]"
    if dtype in _HALF:
        v = f"repro_chain::from_{_HALF[dtype]}({v})"
    return ctype(dtype), v


def _load(k: int, dtype: str, index: str) -> str:
    t, v = _load_expr(k, dtype, index)
    return f"const {t} x{k} = {v};"


def _role_index(role: Role, row: str, col: str, width: str) -> str:
    return {Role.FULL: f"{row} * {width} + {col}", Role.ROW: row,
            Role.COL: col, Role.SCALAR: "0"}[role]


def _members(graph: Graph, order: Sequence[int]) -> list[int]:
    return [n for n in order if graph.node(n).kind is not OpKind.CONST]


def prologue_struct(graph: Graph, order: Sequence[int], roles: dict,
                    operands: Sequence[int], lhs: int,
                    rhs_dtype: str = "float32") -> str:
    """``Pro``: the lhs element (m, k) from the prologue operands (in
    ``operands`` order; a lone lhs operand when the prologue is empty,
    and then ``kIdentity``: the kernel copies the raw lhs), in phases as
    ``Epi``: phase p < kPhases - 1 accumulates the reductions over K of
    level p + 1 (the kernel's pass over the row before its k-tiles), the
    last phase returns the element.  ``kStaged`` names the operand the
    kernel stages a k-tile at a time with 16-byte copies (the first
    float32 or bfloat16 one of the whole (M, K) view; -1 if none;
    ``kStagedBf16`` whether it is bfloat16), and ``elem_at`` is ``elem``
    with that operand's value given (read from the staged tile, or four
    at a time in the statistics pass).  ``kExact``: the lhs is bfloat16,
    so its values are exact in TF32; ``kRhsBf16``: the product's rhs
    (``rhs_dtype``) is bfloat16."""
    members = _members(graph, order)
    staged = next((k for k, i in enumerate(operands)
                   if roles[i] is Role.FULL
                   and graph.node(i).spec.dtype in _MM_STAGED), -1)
    staged_bf16 = (staged >= 0
                   and graph.node(operands[staged]).spec.dtype == "bfloat16")
    loads = [_load(k, graph.node(i).spec.dtype,
                   _role_index(roles[i], "m", "k", "K"))
             for k, i in enumerate(operands)]
    at_loads = [f"const float x{k} = xs;" if k == staged else ld
                for k, ld in enumerate(loads)]

    def ret(w):
        return [f"return static_cast<float>({w.val(lhs)});"]

    branches, reduces, lvl, phases = _phased(graph, members, operands,
                                             loads, ret)
    at_branches = _phased(graph, members, operands, at_loads, ret)[0]
    n = len(operands)
    identity = (not members and list(operands) == [lhs]
                and graph.node(lhs).spec.dtype in _MM_STAGED)
    slots = _slot_functions(graph, reduces, lvl, phases)
    sig = ("long long m, long long k, long long K, const float* red, "
           "float* part) const {")
    return "\n".join([
        "struct Pro {",
        f"  static constexpr bool kIdentity = {str(identity).lower()};",
        f"  static constexpr int kIn = {n};",
        f"  static constexpr int kStaged = {staged};",
        f"  static constexpr bool kStagedBf16 = {str(staged_bf16).lower()};",
        "  static constexpr bool kExact = "
        f"{str(graph.node(lhs).spec.dtype == 'bfloat16').lower()};",
        f"  static constexpr bool kRhsBf16 = "
        f"{str(rhs_dtype == 'bfloat16').lower()};",
        *slots[:3],
        f"  const void* in[{max(1, n)}];",
        *slots[3:],
        "  template <int P>",
        f"  __host__ __device__ float elem({sig}",
        "    (void)red; (void)part;",
        *branches,
        "    return 0.f;",
        "  }",
        "  template <int P>",
        f"  __host__ __device__ float elem_at(float xs, {sig}",
        "    (void)xs; (void)red; (void)part;",
        *at_branches,
        "    return 0.f;",
        "  }",
        "  __host__ __device__ float operator()(long long m, long long k,",
        "                                       long long K,",
        "                                       const float* red) const {",
        "    return elem<kPhases - 1>(m, k, K, red, nullptr);",
        "  }",
        "};"])


def _phased(graph: Graph, members: Sequence[int], operands: Sequence[int],
            loads: Sequence[str], store, *, anchor: int | None = None,
            acc: str = "acc") -> tuple[list[str], list[int], dict, int]:
    """The ``if constexpr (P == p)`` branches of a chain run in phases, as
    the streaming kernel runs a group: phase p evaluates the nodes of
    reduce level <= p and accumulates the reductions of level p + 1 into
    ``part`` (one float32 slot each), reading the finished ones from
    ``red``; the last phase appends ``store(writer)``.  Returns
    (branches, reduce nodes in slot order, levels, phases)."""
    from .cost_model import reduce_levels

    lvl = reduce_levels(graph, frozenset(members))
    phases = max(lvl.values(), default=0) + 1
    reduces = [n for n in members if graph.node(n).kind is OpKind.REDUCE]
    slot = {r: s for s, r in enumerate(reduces)}
    branches = []
    for p in range(phases):
        w = _Writer(graph, operands, members)
        if anchor is not None:
            w.names[anchor] = acc
        body = list(loads)
        for nid in members:
            node = graph.node(nid)
            if node.kind is OpKind.REDUCE:
                s = slot[nid]
                if lvl[nid] - 1 == p:
                    x = w.val(node.inputs[0])
                    if node.prim in ("reduce_and", "reduce_or"):
                        x = f"(({x}) != 0 ? 1.f : 0.f)"
                    body.append(f"part[{s}] = repro_chain::combine("
                                f"{REDUCE_OPS[node.prim]}, part[{s}], "
                                f"static_cast<float>({x}));")
                elif lvl[nid] <= p:
                    dt = node.spec.dtype
                    v = f"red[{s}]"
                    if dt == "bool":
                        v = f"({v} != 0)"
                    elif dt in _HALF:
                        v = f"repro_chain::round_{_HALF[dt]}({v})"
                    elif dt != "float32":
                        v = f"static_cast<{_COMPUTE[dt]}>({v})"
                    body.append(f"const {_COMPUTE[dt]} {w.local[nid]} = {v};")
                    w.names[nid] = w.local[nid]
                continue
            if lvl[nid] <= p:
                body.append(w.stmt(nid))
        if p == phases - 1:
            body.extend(store(w))
        kw = "if" if p == 0 else "} else if"
        branches.append(f"    {kw} constexpr (P == {p}) {{")
        branches.extend("      " + b for b in body)
    branches.append("    }")
    return branches, reduces, lvl, phases


def _slot_functions(graph: Graph, reduces: Sequence[int], lvl: dict,
                    phases: int) -> list[str]:
    ops = ", ".join(str(REDUCE_OPS[graph.node(r).prim]) for r in reduces)
    phs = ", ".join(str(lvl[r] - 1) for r in reduces)
    return [
        f"  static constexpr int kPhases = {phases};",
        f"  static constexpr int kSlots = {len(reduces)};",
        f"  static constexpr int kSlotsArr = {max(1, len(reduces))};",
        "  __host__ __device__ static constexpr int slot_op(int s) {",
        f"    constexpr int ops[kSlotsArr] = {{{ops or '0'}}};",
        "    return ops[s];",
        "  }",
        "  __host__ __device__ static constexpr int slot_phase(int s) {",
        f"    constexpr int phs[kSlotsArr] = {{{phs or '0'}}};",
        "    return phs[s];",
        "  }"]


def _store_cond(role: Role, row: str, col: str) -> str | None:
    """Where an output of ``role`` is stored once: ``full`` everywhere,
    ``row`` at column 0, ``col`` at row 0, ``scalar`` at (0, 0)."""
    return {Role.FULL: None, Role.ROW: f"{col} == 0", Role.COL: f"{row} == 0",
            Role.SCALAR: f"{row} == 0 && {col} == 0"}[role]


def epilogue_struct(graph: Graph, order: Sequence[int], roles: dict,
                    operands: Sequence[int], anchor: int,
                    out_ids: Sequence[int], split: bool = False) -> str:
    """``Epi``: the epilogue on one accumulator element, in phases (the
    anchor's value is ``acc``, rounded to the anchor's type first where
    it is bfloat16, as the reference's ``anchor_dtype`` cast; ``out_ids``
    are stored in the last phase by role: ``full`` everywhere, ``row`` at
    n == 0, ``col`` at m == 0, ``scalar`` at (0, 0)).  With ``split`` (the
    native bfloat16 instances) it also has the element's operand reads
    apart from its chain: ``Ops``, ``load(m, n, N)`` and ``elem_ops<P>(acc,
    ops, m, n, N)``, so that a thread issues the reads of many elements
    before the first store (a read after a store through another pointer
    is not moved ahead of it, and would wait out its latency alone)."""
    members = _members(graph, order)
    exprs = [_load_expr(k, graph.node(i).spec.dtype,
                        _role_index(roles[i], "m", "n", "N"))
             for k, i in enumerate(operands)]
    loads = [f"const {t} x{k} = {v};" for k, (t, v) in enumerate(exprs)]

    def store(w: _Writer) -> list[str]:
        lines = []
        for k, o in enumerate(out_ids):
            dt = graph.node(o).spec.dtype
            t = _STORAGE[dt]
            v = (f"repro_chain::to_{_HALF[dt]}(static_cast<float>"
                 f"({w.val(o)}))" if dt in _HALF
                 else f"static_cast<{t}>({w.val(o)})")
            st = (f"static_cast<{t}*>(out[{k}])"
                  f"[{_role_index(roles[o], 'm', 'n', 'N')}] = {v};")
            cond = _store_cond(roles[o], "m", "n")
            lines.append(st if cond is None else f"if ({cond}) {st}")
        return lines

    acc = _rounded(graph.node(anchor).spec.dtype, "acc")
    branches, reduces, lvl, phases = _phased(
        graph, members, operands, loads, store, anchor=anchor, acc=acc)
    n_in, n_out = len(operands), len(out_ids)
    slots = _slot_functions(graph, reduces, lvl, phases)
    ops = []
    if split:
        held = [f"const {t} x{k} = o.x{k};" for k, (t, _) in enumerate(exprs)]
        ops_branches = _phased(graph, members, operands, held, store,
                               anchor=anchor, acc=acc)[0]
        ops = [
            "  struct Ops {",
            *(f"    {t} x{k};" for k, (t, _) in enumerate(exprs)),
            "    char pad;",
            "  };",
            "  __host__ __device__ Ops load(long long m, long long n,",
            "                               long long N) const {",
            "    (void)m; (void)n; (void)N;",
            "    Ops o;",
            *(f"    o.x{k} = {v};" for k, (_, v) in enumerate(exprs)),
            "    return o;",
            "  }",
            "  template <int P>",
            "  __host__ __device__ void elem_ops(float acc, const Ops& o,",
            "                                    long long m, long long n,",
            "                                    long long N) const {",
            "    (void)o; const float* red = nullptr; float* part = nullptr;",
            "    (void)red; (void)part;",
            *ops_branches,
            "  }"]
    return "\n".join([
        "struct Epi {",
        f"  static constexpr int kIn = {n_in};",
        f"  static constexpr int kOut = {n_out};",
        *slots[:3],
        f"  const void* in[{max(1, n_in)}];",
        f"  void* out[{max(1, n_out)}];",
        *slots[3:],
        "  template <int P>",
        "  __host__ __device__ void elem(float acc, long long m, long long n,",
        "                                long long N, const float* red,",
        "                                float* part) const {",
        "    (void)red; (void)part;",
        *branches,
        "  }",
        *ops,
        "};"])


def staged_inputs(graph: Graph, roles: dict,
                  operands: Sequence[int]) -> list[tuple[int, int]]:
    """(operand index, element bytes) of the inputs the streaming kernel
    stages in shared memory: the full-row ones of a dtype it stages."""
    return [(k, STAGED_DTYPES[graph.node(i).spec.dtype])
            for k, i in enumerate(operands)
            if roles[i] is Role.FULL
            and graph.node(i).spec.dtype in STAGED_DTYPES]


def _rounded(dtype: str, x: str) -> str:
    """The float32 expression ``x`` rounded to ``dtype`` where that is a
    16-bit float (an anchor's product in its own type), else ``x``."""
    return f"repro_chain::round_{_HALF[dtype]}({x})" if dtype in _HALF else x


def _as_float(dtype: str, x: str) -> str:
    if dtype in _HALF:
        return f"repro_chain::from_{_HALF[dtype]}({x})"
    return x if dtype == "float32" else f"static_cast<float>({x})"


def stream_struct(graph: Graph, order: Sequence[int], roles: dict,
                  operands: Sequence[int], out_ids: Sequence[int]) -> str:
    """``Group``: a stitched group for ``csrc/streaming.cuh`` -- its
    staged inputs (``staged_inputs``: ``stage``, ``fetch``), ``load``
    (every operand's value at element (r, c) of the row view, the
    unstaged ones read by role, into ``Vals``), and ``elem`` in phases on
    those values, ``out_ids`` stored in the last phase by role."""
    members = _members(graph, order)
    staged = staged_inputs(graph, roles, operands)
    sidx = {k: j for j, (k, _) in enumerate(staged)}
    fields, reads = [], []
    for k, i in enumerate(operands):
        dt = graph.node(i).spec.dtype
        t = _COMPUTE[dt]
        if k in sidx:
            v = f"fv[{sidx[k]}]"
            if dt == "bool":
                v = f"({v} != 0.f)"
            elif dt not in _FLOATS:
                v = f"static_cast<{t}>({v})"
        else:
            v = (f"static_cast<const {_STORAGE[dt]}*>(in[{k}])"
                 f"[{_role_index(roles[i], 'r', 'c', 'C')}]")
            if dt in _HALF:
                v = f"repro_chain::from_{_HALF[dt]}({v})"
        fields.append(f"    {t} x{k};")
        reads.append(f"    v.x{k} = {v};")
    loads = [f"const {_COMPUTE[graph.node(i).spec.dtype]} x{k} = v.x{k};"
             for k, i in enumerate(operands)]

    def store(w: _Writer) -> list[str]:
        lines = []
        for k, o in enumerate(out_ids):
            dt = graph.node(o).spec.dtype
            st = _STORAGE[dt]
            v = (f"repro_chain::to_{_HALF[dt]}(static_cast<float>"
                 f"({w.val(o)}))" if dt in _HALF
                 else f"static_cast<{st}>({w.val(o)})")
            line = (f"static_cast<{st}*>(out[{k}])"
                    f"[{_role_index(roles[o], 'r', 'c', 'C')}] = {v};")
            cond = _store_cond(roles[o], "r", "c")
            lines.append(line if cond is None else f"if ({cond}) {line}")
        return lines

    branches, reduces, lvl, phases = _phased(graph, members, operands, loads,
                                             store)
    fetch, stage = [], []
    for j, (k, _) in enumerate(staged):
        dt = graph.node(operands[k]).spec.dtype
        ptr = f"const {_STORAGE[dt]}*"
        fetch.append(f"    fv[{j}] = st ? "
                     f"{_as_float(dt, f'static_cast<{ptr}>(st[{j}])[lc]')} : "
                     f"{_as_float(dt, f'static_cast<{ptr}>(in[{k}])[g]')};")
        stage.append(f"    static_cast<{_STORAGE[dt]}*>(st[{j}])[lc] = "
                     f"static_cast<{ptr}>(in[{k}])[g];")
    n_in, n_out, n_st = len(operands), len(out_ids), len(staged)
    nbytes = ", ".join(str(b) for _, b in staged) or "0"
    srcs = ", ".join(str(k) for k, _ in staged) or "0"
    return "\n".join([
        "struct Group {",
        f"  static constexpr int kIn = {n_in};",
        f"  static constexpr int kOut = {n_out};",
        f"  static constexpr int kStaged = {n_st};",
        f"  static constexpr int kStagedArr = {max(1, n_st)};",
        f"  const void* in[{max(1, n_in)}];",
        f"  void* out[{max(1, n_out)}];",
        *_slot_functions(graph, reduces, lvl, phases),
        "  __host__ __device__ static constexpr int staged_bytes(int j) {",
        f"    constexpr int b[kStagedArr] = {{{nbytes}}};",
        "    return b[j];",
        "  }",
        "  __host__ __device__ const void* staged_src(int j) const {",
        f"    constexpr int k[kStagedArr] = {{{srcs}}};",
        "    return in[k[j]];",
        "  }",
        "  __host__ __device__ void stage(void* const* st, long long lc,",
        "                                 long long g) const {",
        "    (void)st; (void)lc; (void)g;",
        *stage,
        "  }",
        "  __host__ __device__ void fetch(const void* const* st, long long lc,",
        "                                 long long g, float* fv) const {",
        "    (void)st; (void)lc; (void)g; (void)fv;",
        *fetch,
        "  }",
        "  struct Vals {",
        *fields,
        "  };",
        "  __host__ __device__ void load(long long r, long long c, long long C,",
        "                                const float* fv, Vals& v) const {",
        "    (void)r; (void)c; (void)C; (void)fv; (void)v;",
        *reads,
        "  }",
        "  template <int P>",
        "  __host__ __device__ void elem(long long r, long long c, long long C,",
        "                                const Vals& v, const float* red,",
        "                                float* part) const {",
        "    (void)r; (void)c; (void)C; (void)v; (void)red; (void)part;",
        *branches,
        "  }",
        "};"])


def score_struct(graph: Graph, order: Sequence[int],
                 operands: Sequence[int], qk: int, s_pre: int) -> str:
    """``Score``: flash attention's functor, the pre-softmax score of one
    (b, h, qi, ki) from the scaled q k^T value ``s`` (rounded to the
    product's type first where it is bfloat16, as B3's accumulator) and
    the score operands, each read through its 4D strides ``st``."""
    loads = [_load(k, graph.node(i).spec.dtype,
                   f"b * st[{k}][0] + h * st[{k}][1] + qi * st[{k}][2] "
                   f"+ ki * st[{k}][3]")
             for k, i in enumerate(operands)]
    members = _members(graph, order)
    w = _Writer(graph, operands, members)
    w.names[qk] = _rounded(graph.node(qk).spec.dtype, "s")
    body = list(loads)
    for nid in members:
        body.append(w.stmt(nid))
    body.append(f"return static_cast<float>({w.val(s_pre)});")
    n = len(operands)
    return "\n".join([
        "struct Score {",
        "  static constexpr bool kIdentity = false;",
        f"  static constexpr int kIn = {n};",
        f"  const void* in[{max(1, n)}];",
        f"  long long st[{max(1, n)}][4];",
        "  __host__ __device__ float operator()(float s, int b, int h,",
        "                                       int qi, int ki) const {",
        *("    " + b for b in body),
        "  }",
        "};"])


# --------------------------------------------------------------------------
# whole sources
# --------------------------------------------------------------------------
_HEAD = "// Generated by repro_torch.core.codegen_cuda: one anchored group."


def struct_slots(struct: str) -> int:
    """The row reductions (``kSlots``) of a generated ``Pro`` or ``Epi``."""
    return int(re.search(r"static constexpr int kSlots = (\d+);",
                         struct).group(1))


def matmul_source(pro: str, epi: str, tiles: Sequence[int],
                  native: bool = False) -> str:
    """The ``.cu`` of one anchored matmul: the template instantiated with
    ``pro`` and ``epi`` at the tiles ``tiles`` (indices into
    ``kernels.matmul.TILES``, or with ``native`` into ``NATIVE_TILES``:
    the bfloat16 template ``csrc/matmul_bf16.cuh``), a C entry for the
    card, and the host
    harness for the CPU tests.  Each instance's shared memory is asserted
    to be ``Tile.smem`` at the chain's own counts of row reductions."""
    from ..kernels.matmul import tile_set

    epi_slots, pro_slots = struct_slots(epi), struct_slots(pro)

    cases, asserts = [], []
    for t in tiles:
        c = tile_set(native)[t]
        if native:
            call = f"launch_bf16<{c.template_args}>"
            fn, name = "native_smem_bytes", "NATIVE_TILES"
            smem = (f"{c.bm}, {c.bn}, {c.stages}, {c.wn}, {c.am}, "
                    "Epi::kSlots, Pro::kSlots")
        else:
            call = f"launch<{c.template_args}>"
            fn, name = "smem_bytes", "TILES"
            smem = (f"{c.bm}, {c.bn}, {c.bk}, {c.stages}, {c.raw_stages}, "
                    f"{c.wn}, {c.am}, Epi::kSlots, Pro::kSlots")
        cases.append(f"    case {t}: return static_cast<int>(repro_mm::{call}"
                     "(pro, rhs, epi, M, K, N, s));")
        asserts.append(f"static_assert(repro_mm::{fn}({smem}) == "
                       f"{c.smem(epi_slots, pro_slots)}, "
                       f"\"kernels/matmul.py::{name}[{t}]\");")
    header = "matmul_bf16.cuh" if native else "matmul_fused.cuh"

    return "\n".join([
        _HEAD, f'#include "{header}"', "", "namespace {", pro, "",
        epi, "}  // namespace", "",
        "// the shared memory the H100 gate prices is the instance's own",
        *asserts, "", "#ifdef __CUDACC__",
        'extern "C" int repro_mm_fused(int tile, const void* const* pro_in,',
        "                              const void* rhs,",
        "                              const void* const* epi_in,",
        "                              void* const* outs, int M, int K, int N,",
        "                              void* stream) {",
        "  Pro pro;",
        "  for (int i = 0; i < Pro::kIn; ++i) pro.in[i] = pro_in[i];",
        "  Epi epi;",
        "  for (int i = 0; i < Epi::kIn; ++i) epi.in[i] = epi_in[i];",
        "  for (int i = 0; i < Epi::kOut; ++i) epi.out[i] = outs[i];",
        "  cudaStream_t s = static_cast<cudaStream_t>(stream);",
        "  switch (tile) {", *cases,
        "    default: return static_cast<int>(cudaErrorInvalidValue);",
        "  }", "}", "#else",
        'extern "C" void repro_host_pro(const void* const* ins, float* lhs,',
        "                               long long M, long long K) {",
        "  Pro pro;",
        "  for (int i = 0; i < Pro::kIn; ++i) pro.in[i] = ins[i];",
        "  repro_mm::prologue_host(pro, lhs, M, K, false);",
        "}",
        'extern "C" void repro_host_pro_staged(const void* const* ins,',
        "                                      float* lhs, long long M,",
        "                                      long long K) {",
        "  Pro pro;",
        "  for (int i = 0; i < Pro::kIn; ++i) pro.in[i] = ins[i];",
        "  repro_mm::prologue_host(pro, lhs, M, K, true);",
        "}",
        'extern "C" void repro_host_epi(const float* acc,',
        "                               const void* const* ins,",
        "                               void* const* outs, long long M,",
        "                               long long N) {",
        "  Epi epi;",
        "  for (int i = 0; i < Epi::kIn; ++i) epi.in[i] = ins[i];",
        "  for (int i = 0; i < Epi::kOut; ++i) epi.out[i] = outs[i];",
        "  repro_mm::epilogue_host(epi, acc, M, N);",
        "}", "#endif", ""])


def attention_source(score: str, wide: bool = False,
                     dtype: str = "float32") -> str:
    """The ``.cu`` of one anchored attention: the flash template
    (``csrc/flash_attention.cuh``, or with ``wide`` the template above
    head dim 256, ``csrc/flash_attention_wide.cuh``) instantiated with the
    ``Score`` functor on q, k, v and o of ``dtype`` (float32 or bfloat16),
    a C entry for the card, and the host harness of the functor for the
    CPU tests."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"anchored attention on {dtype} operands")
    ns = "repro_flash_wide" if wide else "repro_flash"
    header = "flash_attention_wide.cuh" if wide else "flash_attention.cuh"
    t = "uint16_t" if dtype == "bfloat16" else "float"
    if wide:
        params = [
            f"  {ns}::Params<{t}> p{{static_cast<const {t}*>(q),",
            f"      static_cast<const {t}*>(k), static_cast<const {t}*>(v),",
            f"      static_cast<{t}*>(o), q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,",
            "      v_sb, v_sh, v_ss, Hq, Hq / Hkv, Sq, Skv, D, scale, causal};",
            f"  return {ns}::run(p, mod, B, static_cast<cudaStream_t>(stream));"]
    else:
        params = [
            f"  {ns}::Params p{{q, k, v, o, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,",
            "      v_sb, v_sh, v_ss, Hq, Hq / Hkv, Sq, Skv, D, scale, causal};",
            f"  return {ns}::run<{t}>(p, mod, B,",
            "                         static_cast<cudaStream_t>(stream));"]
    return "\n".join([
        _HEAD, f'#include "{header}"', "", "namespace {", score,
        "}  // namespace", "", "#ifdef __CUDACC__",
        'extern "C" int repro_flash_scored(',
        "    const void* q, const void* k, const void* v, void* o, int B,",
        "    int Hq, int Hkv, int Sq, int Skv, int D, long long q_sb,",
        "    long long q_sh, long long q_ss, long long k_sb, long long k_sh,",
        "    long long k_ss, long long v_sb, long long v_sh, long long v_ss,",
        "    float scale, int causal, const void* const* score_in,",
        "    const long long* score_st, void* stream) {",
        "  Score mod;",
        "  for (int i = 0; i < Score::kIn; ++i) {",
        "    mod.in[i] = score_in[i];",
        "    for (int d = 0; d < 4; ++d) mod.st[i][d] = score_st[4 * i + d];",
        "  }",
        "  if (Hkv < 1 || Hq % Hkv != 0)",
        "    return static_cast<int>(cudaErrorInvalidValue);",
        *params,
        "}", "#else",
        'extern "C" void repro_host_score(const float* s,',
        "                                 const void* const* ins,",
        "                                 const long long* st, float* out,",
        "                                 int B, int H, int Sq, int Sk) {",
        "  Score mod;",
        "  for (int i = 0; i < Score::kIn; ++i) {",
        "    mod.in[i] = ins[i];",
        "    for (int d = 0; d < 4; ++d) mod.st[i][d] = st[4 * i + d];",
        "  }",
        "  long long idx = 0;",
        "  for (int b = 0; b < B; ++b)",
        "    for (int h = 0; h < H; ++h)",
        "      for (int qi = 0; qi < Sq; ++qi)",
        "        for (int ki = 0; ki < Sk; ++ki, ++idx)",
        "          out[idx] = mod(s[idx], b, h, qi, ki);",
        "}", "#endif", ""])


def streaming_source(group: str) -> str:
    """The ``.cu`` of one streaming group: ``csrc/streaming.cuh``
    instantiated with ``group`` (``stream_struct``), a C entry for the
    card, and the host harness for the CPU tests."""
    return "\n".join([
        "// Generated by repro_torch.core.codegen_cuda: one streaming group.",
        '#include "streaming.cuh"', "", "namespace {", group,
        "}  // namespace", "", "#ifdef __CUDACC__",
        'extern "C" int repro_stream_launch(const void* const* ins,',
        "                                   void* const* outs, long long R,",
        "                                   long long C, int K, long long slice,",
        "                                   long long cap, int bulk,",
        "                                   void* stream) {",
        "  Group g;",
        "  for (int i = 0; i < Group::kIn; ++i) g.in[i] = ins[i];",
        "  for (int i = 0; i < Group::kOut; ++i) g.out[i] = outs[i];",
        "  return static_cast<int>(repro_stream::launch(",
        "      g, R, C, K, slice, cap, bulk,",
        "      static_cast<cudaStream_t>(stream)));",
        "}", "#else",
        'extern "C" void repro_host_stream(const void* const* ins,',
        "                                  void* const* outs, long long R,",
        "                                  long long C) {",
        "  Group g;",
        "  for (int i = 0; i < Group::kIn; ++i) g.in[i] = ins[i];",
        "  for (int i = 0; i < Group::kOut; ++i) g.out[i] = outs[i];",
        "  repro_stream::run_host(g, R, C);",
        "}", "#endif", ""])


# --------------------------------------------------------------------------
# a generated library, built on first use
# --------------------------------------------------------------------------
class GeneratedEntry:
    """The C entry ``symbol`` of a generated source, built by ``nvcc``
    (``kernels._build.generated_library``) and bound with ctypes at its
    first call.  ``eager`` (a group planned for the card) writes the
    source and registers it for the build at construction, so that every
    generated source known at a first launch builds in one parallel
    round; otherwise the source is written at first use."""

    def __init__(self, kind: str, make_source, symbol: str, argtypes, *,
                 eager: bool = True):
        self.kind = kind
        self._make_source = make_source
        self._source: str | None = None
        self.symbol = symbol
        self.argtypes = argtypes
        self._fn = None
        if eager:
            from ..kernels import _build

            _build.register_generated(self.name, self.source)

    @property
    def source(self) -> str:
        if self._source is None:
            self._source = self._make_source()
        return self._source

    @property
    def name(self) -> str:
        digest = hashlib.sha1(self.source.encode()).hexdigest()[:16]
        return f"{self.kind}_{digest}"

    def __call__(self, *args) -> int:
        if self._fn is None:
            from ..kernels import _build

            fn = getattr(_build.generated_library(self.name, self.source),
                         self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn(*args)


_P = ctypes.c_void_p
MATMUL_ARGTYPES = [ctypes.c_int, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, _P]
STREAM_ARGTYPES = [_P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _P]
ATTENTION_ARGTYPES = ([_P] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
                      + [ctypes.c_float, ctypes.c_int, _P, _P, _P])
