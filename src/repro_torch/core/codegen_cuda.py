"""CUDA C++ lowering of stitched chains: the hooks of the anchored kernels.

Compute-anchored stitching folds memory-bound chains into a compute
kernel: a prologue and an epilogue into the fused matmul B3
(``csrc/matmul_fused.cuh``) and a score chain into flash attention
(``csrc/flash_attention.cuh``).  This module writes each chain as C++
functions of ONE element (the row view's roles decide how an operand is
indexed: ``full`` by (row, column), ``row`` by row, ``col`` by column,
``scalar`` once), and the ``.cu`` source that instantiates the kernel
template with them.  It lowers exactly ``codegen.EMITTABLE_PRIMS`` (the
Triton generator's set, one vocabulary for both), in float32 and bool.

* ``prologue_struct`` -- ``Pro``: the lhs element (m, k).
* ``epilogue_struct`` -- ``Epi``: the epilogue in phases, as the Triton
  streaming kernel runs them: phase p evaluates the nodes of reduce level
  <= p and accumulates the reductions of level p + 1; the last phase
  stores the outputs.
* ``score_struct`` -- ``Score``: flash attention's score functor.

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

_CTYPES = {"float32": "float", "bool": "bool"}


def ctype(dtype: str) -> str:
    if dtype not in _CTYPES:
        raise ValueError(f"the CUDA chains compute in float32 and bool, "
                         f"not {dtype}")
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
    values."""
    node = graph.node(nid)
    prim = node.prim
    in_dt = [graph.node(i).spec.dtype for i in node.inputs]
    if prim in _PASS:
        return ins[0]
    if prim == "convert_element_type":
        if node.spec.dtype == "bool":
            return f"({ins[0]} != 0)"
        return f"static_cast<{ctype(node.spec.dtype)}>({ins[0]})"
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


class _Writer:
    """Member statements of one element chain.  Values are named by
    position (operand k is ``xk``, the j-th member ``vj``), never by node
    id, so that isomorphic chains of different graphs -- a layer's
    prefill and decode signatures, the forward and the serving path --
    write the same source and share one build."""

    def __init__(self, graph: Graph, operands: Sequence[int],
                 members: Sequence[int]):
        self.graph = graph
        self.names = {i: f"x{k}" for k, i in enumerate(operands)}
        self.local = {n: f"v{j}" for j, n in enumerate(members)}

    def val(self, i: int) -> str:
        if i in self.names:
            return self.names[i]
        n = self.graph.node(i)  # a scalar const
        return literal(n.value, n.spec.dtype)

    def stmt(self, nid: int) -> str:
        node = self.graph.node(nid)
        e = _expr(self.graph, nid, [self.val(i) for i in node.inputs])
        self.names[nid] = self.local[nid]
        return f"const {ctype(node.spec.dtype)} {self.local[nid]} = {e};"


def _load(k: int, dtype: str, index: str) -> str:
    t = ctype(dtype)
    return f"const {t} x{k} = static_cast<const {t}*>(in[{k}])[{index}];"


def _role_index(role: Role, row: str, col: str, width: str) -> str:
    return {Role.FULL: f"{row} * {width} + {col}", Role.ROW: row,
            Role.COL: col, Role.SCALAR: "0"}[role]


def _members(graph: Graph, order: Sequence[int]) -> list[int]:
    return [n for n in order if graph.node(n).kind is not OpKind.CONST]


def prologue_struct(graph: Graph, order: Sequence[int], roles: dict,
                    operands: Sequence[int], lhs: int) -> str:
    """``Pro``: the lhs element (m, k) from the prologue operands (in
    ``operands`` order; a lone lhs operand when the prologue is empty,
    and then ``kIdentity``: the kernel copies the raw float32 lhs)."""
    members = _members(graph, order)
    body = [_load(k, graph.node(i).spec.dtype,
                  _role_index(roles[i], "m", "k", "K"))
            for k, i in enumerate(operands)]
    w = _Writer(graph, operands, members)
    for nid in members:
        if graph.node(nid).kind is OpKind.REDUCE:
            raise ValueError("a prologue that reduces over K has no CUDA "
                             "instance (the cost model's gate refuses it)")
        body.append(w.stmt(nid))
    body.append(f"return static_cast<float>({w.val(lhs)});")
    n = len(operands)
    identity = (not members and list(operands) == [lhs]
                and graph.node(lhs).spec.dtype == "float32")
    return "\n".join([
        "struct Pro {",
        f"  static constexpr bool kIdentity = {str(identity).lower()};",
        f"  static constexpr int kIn = {n};",
        f"  const void* in[{max(1, n)}];",
        "  __host__ __device__ float operator()(long long m, long long k,",
        "                                       long long K) const {",
        *("    " + b for b in body),
        "  }",
        "};"])


def epilogue_struct(graph: Graph, order: Sequence[int], roles: dict,
                    operands: Sequence[int], anchor: int,
                    out_ids: Sequence[int]) -> str:
    """``Epi``: the epilogue on one accumulator element, in phases (the
    anchor's value is ``acc``; ``out_ids`` are stored in the last phase
    by role: ``full`` everywhere, ``row`` at n == 0, ``col`` at m == 0,
    ``scalar`` at (0, 0))."""
    from .cost_model import reduce_levels

    members = _members(graph, order)
    lvl = reduce_levels(graph, frozenset(members))
    phases = max(lvl.values(), default=0) + 1
    reduces = [n for n in members if graph.node(n).kind is OpKind.REDUCE]
    slot = {r: s for s, r in enumerate(reduces)}
    loads = [_load(k, graph.node(i).spec.dtype,
                   _role_index(roles[i], "m", "n", "N"))
             for k, i in enumerate(operands)]
    branches = []
    for p in range(phases):
        w = _Writer(graph, operands, members)
        w.names[anchor] = "acc"
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
                    v = f"red[{s}]"
                    if node.spec.dtype == "bool":
                        v = f"({v} != 0)"
                    body.append(f"const {ctype(node.spec.dtype)} "
                                f"{w.local[nid]} = {v};")
                    w.names[nid] = w.local[nid]
                continue
            if lvl[nid] <= p:
                body.append(w.stmt(nid))
        if p == phases - 1:
            for k, o in enumerate(out_ids):
                t = ctype(graph.node(o).spec.dtype)
                store = (f"static_cast<{t}*>(out[{k}])"
                         f"[{_role_index(roles[o], 'm', 'n', 'N')}] = "
                         f"static_cast<{t}>({w.val(o)});")
                cond = {Role.FULL: None, Role.ROW: "n == 0",
                        Role.COL: "m == 0",
                        Role.SCALAR: "m == 0 && n == 0"}[roles[o]]
                body.append(store if cond is None
                            else f"if ({cond}) {store}")
        kw = "if" if p == 0 else "} else if"
        branches.append(f"    {kw} constexpr (P == {p}) {{")
        branches.extend("      " + b for b in body)
    branches.append("    }")
    ops = ", ".join(str(REDUCE_OPS[graph.node(r).prim]) for r in reduces)
    phs = ", ".join(str(lvl[r] - 1) for r in reduces)
    n_in, n_out = len(operands), len(out_ids)
    return "\n".join([
        "struct Epi {",
        f"  static constexpr int kIn = {n_in};",
        f"  static constexpr int kOut = {n_out};",
        f"  static constexpr int kPhases = {phases};",
        f"  static constexpr int kSlots = {len(reduces)};",
        f"  static constexpr int kSlotsArr = {max(1, len(reduces))};",
        f"  const void* in[{max(1, n_in)}];",
        f"  void* out[{max(1, n_out)}];",
        "  __host__ __device__ static constexpr int slot_op(int s) {",
        f"    constexpr int ops[kSlotsArr] = {{{ops or '0'}}};",
        "    return ops[s];",
        "  }",
        "  __host__ __device__ static constexpr int slot_phase(int s) {",
        f"    constexpr int phs[kSlotsArr] = {{{phs or '0'}}};",
        "    return phs[s];",
        "  }",
        "  template <int P>",
        "  __host__ __device__ void elem(float acc, long long m, long long n,",
        "                                long long N, const float* red,",
        "                                float* part) const {",
        "    (void)red; (void)part;",
        *branches,
        "  }",
        "};"])


def score_struct(graph: Graph, order: Sequence[int],
                 operands: Sequence[int], qk: int, s_pre: int) -> str:
    """``Score``: flash attention's functor, the pre-softmax score of one
    (b, h, qi, ki) from the scaled q k^T value ``s`` and the score
    operands, each read through its 4D strides ``st``."""
    loads = [_load(k, graph.node(i).spec.dtype,
                   f"b * st[{k}][0] + h * st[{k}][1] + qi * st[{k}][2] "
                   f"+ ki * st[{k}][3]")
             for k, i in enumerate(operands)]
    members = _members(graph, order)
    w = _Writer(graph, operands, members)
    w.names[qk] = "s"
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


def matmul_source(pro: str, epi: str, tiles: Sequence[int]) -> str:
    """The ``.cu`` of one anchored matmul: the template instantiated with
    ``pro`` and ``epi`` at the tiles ``tiles`` (indices into
    ``kernels.matmul.TILES``), a C entry for the card, and the host
    harness for the CPU tests."""
    from ..kernels.matmul import TILES

    cases, asserts = [], []
    for t in tiles:
        c = TILES[t]
        cases.append(f"    case {t}: return static_cast<int>(repro_mm::launch<"
                     f"{c.template_args}>(pro, rhs, epi, M, K, N, s));")
        smem = (f"{c.bm}, {c.bn}, {c.bk}, {c.stages}, {c.raw_stages}, "
                f"{c.wn}, {c.am}")
        asserts.append(f"static_assert(repro_mm::smem_bytes({smem}) == "
                       f"{c.smem_bytes}, \"kernels/matmul.py::TILES[{t}]\");")
    return "\n".join([
        _HEAD, '#include "matmul_fused.cuh"', "", "namespace {", pro, "",
        epi, "}  // namespace", "",
        "// the shared memory the H100 gate prices is the instance's own",
        *asserts, "", "#ifdef __CUDACC__",
        'extern "C" int repro_mm_fused(int tile, const void* const* pro_in,',
        "                              const float* rhs,",
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
        "  for (long long m = 0; m < M; ++m)",
        "    for (long long k = 0; k < K; ++k) lhs[m * K + k] = pro(m, k, K);",
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


def attention_source(score: str) -> str:
    """The ``.cu`` of one anchored attention: the flash template
    instantiated with the ``Score`` functor, a C entry for the card, and
    the host harness of the functor for the CPU tests."""
    return "\n".join([
        _HEAD, '#include "flash_attention.cuh"', "", "namespace {", score,
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
        "  repro_flash::Params p{static_cast<const float*>(q),",
        "                        static_cast<const float*>(k),",
        "                        static_cast<const float*>(v),",
        "                        static_cast<float*>(o), q_sb, q_sh, q_ss,",
        "                        k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, Hq,",
        "                        Hq / Hkv, Sq, Skv, D, scale, causal};",
        "  return repro_flash::run(p, mod, B, static_cast<cudaStream_t>(stream));",
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
ATTENTION_ARGTYPES = ([_P] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
                      + [ctypes.c_float, ctypes.c_int, _P, _P, _P])
