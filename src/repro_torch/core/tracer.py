"""PyTorch function -> IR tracer.

This is the JIT entry point of the port's stitching compiler.  A function
of tensors is traced with ``torch.fx.experimental.proxy_tensor.make_fx``
(fake tensors: nothing is computed) to a graph of aten ops, and each aten
op is *lowered* to the JAX package's primitive vocabulary, so that the
planner sees the same graph the reference sees for the same function:

* ``mean`` -> ``reduce_sum`` + ``broadcast_in_dim`` (keepdim) + ``div`` by
  a ``const``;
* a rank-raising implicit broadcast -> an explicit ``broadcast_in_dim``
  (same-rank size-1 broadcasting stays implicit, as in a jaxpr);
* a Python scalar operand -> a ``const`` node, created just before its
  consumer;
* ``pow`` by an integer -> ``integer_pow``; ``silu`` -> ``logistic`` * x;
  ``_softmax`` -> ``reduce_max``/``sub``/``exp``/``reduce_sum``/``div``;
  ``gelu`` (tanh and exact) as ``jax.nn.gelu`` writes it; the backward
  ops of the VJPs of the reference's patterns (``_softmax_backward_data``,
  ``gelu_backward``, ``silu_backward``, ``sigmoid_backward``,
  ``tanh_backward``, ``threshold_backward``) and ``relu`` in element-wise
  primitives, and a filled tensor (``fill``, ``ones_like``, ...) as a
  broadcast ``const`` (``_LOWERED``; ``check_lowerings`` holds each to its
  aten op);
  ``where`` -> ``select_n``; ``mm``/``bmm`` -> ``dot_general``
  (``OpKind.ANCHOR``), folding a last-two-dims transpose of an operand and
  the flatten/unflatten views ``matmul`` wraps around ``mm``;
* views that only copy (``clone``, ``contiguous``, a same-shape view) are
  aliases, not nodes.

Every node keeps an executable handle -- ``params["_fn"]``, a callable
``fn(device, *input_tensors)`` -- so that any subgraph can be replayed in
plain PyTorch (``bind_node``/``run_subgraph``), the counterpart of the
reference's primitive re-binding.  An aten op with no lowering becomes an
``OPAQUE`` node whose handle calls the aten op itself.  A backward
function is traced functionalized (``trace_with_tree(functional=True)``),
so no in-place op reaches its graph.
"""
from __future__ import annotations

import math
import operator
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

from .classify import classify
from .ir import Graph, Node, OpKind, TensorSpec

aten = torch.ops.aten

_DTYPE_NAMES = {
    torch.float32: "float32", torch.float16: "float16",
    torch.bfloat16: "bfloat16", torch.float64: "float64",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}
TORCH_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    return _DTYPE_NAMES[dtype]


def _spec_of(t) -> TensorSpec:
    return TensorSpec(tuple(int(d) for d in t.shape), dtype_name(t.dtype))


# --------------------------------------------------------------------------
# execution handles: fn(device, *inputs) -> tensor
# --------------------------------------------------------------------------
def _ipow(x, y: int):
    """x ** y by repeated multiplication (the generated kernels' order)."""
    if y == 0:
        return torch.ones_like(x)
    base = x if y > 0 else 1.0 / x
    out = base
    for _ in range(abs(y) - 1):
        out = out * base
    return out


def _select_n(which, *cases):
    if len(cases) == 2:
        return torch.where(which.to(torch.bool), cases[1], cases[0])
    out = cases[0]
    for i, c in enumerate(cases[1:], start=1):
        out = torch.where(which == i, c, out)
    return out


def _broadcast_in_dim(x, shape, dims):
    view = [1] * len(shape)
    for i, d in enumerate(dims):
        view[d] = x.shape[i]
    return x.reshape(view).expand(shape)


def dot_general(a, b, dimension_numbers):
    """``lax.dot_general`` semantics on torch tensors (f32 accumulation is
    torch.matmul's own)."""
    (lc, rc), (lb, rb) = dimension_numbers
    lc, rc, lb, rb = tuple(lc), tuple(rc), tuple(lb), tuple(rb)
    nb = len(lb)
    if (lb == tuple(range(nb)) and rb == tuple(range(nb))
            and lc == (a.dim() - 1,)):
        if rc == (b.dim() - 2,) and b.dim() == nb + 2:
            return torch.matmul(a, b)
        if rc == (b.dim() - 1,) and b.dim() == nb + 2:
            return torch.matmul(a, b.transpose(-1, -2))
    la = [d for d in range(a.dim()) if d not in lc and d not in lb]
    ra = [d for d in range(b.dim()) if d not in rc and d not in rb]
    batch = [a.shape[d] for d in lb]
    m = [a.shape[d] for d in la]
    n = [b.shape[d] for d in ra]
    k = math.prod(a.shape[d] for d in lc)
    a2 = a.permute(*lb, *la, *lc).reshape(math.prod(batch), math.prod(m), k)
    b2 = b.permute(*rb, *rc, *ra).reshape(math.prod(batch), k, math.prod(n))
    return torch.bmm(a2, b2).reshape(*batch, *m, *n)


_UNARY: dict[str, Callable] = {
    "neg": torch.neg, "abs": torch.abs, "sign": torch.sign,
    "floor": torch.floor, "ceil": torch.ceil, "round": torch.round,
    "exp": torch.exp, "exp2": torch.exp2, "expm1": torch.expm1,
    "log": torch.log, "log1p": torch.log1p, "tanh": torch.tanh,
    "sin": torch.sin, "cos": torch.cos, "logistic": torch.sigmoid,
    "erf": torch.erf, "rsqrt": torch.rsqrt, "sqrt": torch.sqrt,
    "not": torch.logical_not, "is_finite": torch.isfinite,
    "square": lambda x: x * x, "erfc": torch.erfc,
    "cbrt": lambda x: torch.sign(x) * torch.abs(x).pow(1.0 / 3.0),
}
_BINARY: dict[str, Callable] = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
    "max": torch.maximum, "min": torch.minimum, "pow": torch.pow,
    "eq": torch.eq, "ne": torch.ne, "ge": torch.ge, "gt": torch.gt,
    "le": torch.le, "lt": torch.lt, "atan2": torch.atan2,
    "rem": torch.fmod, "and": torch.logical_and,
    "or": torch.logical_or, "xor": torch.logical_xor,
    "nextafter": torch.nextafter,
}
_REDUCE_FNS: dict[str, Callable] = {
    "reduce_sum": lambda x, d: torch.sum(x, dim=d),
    "reduce_max": lambda x, d: torch.amax(x, dim=d),
    "reduce_min": lambda x, d: torch.amin(x, dim=d),
    "reduce_prod": lambda x, d: torch.prod(x, dim=d[0]) if len(d) == 1
    else torch.prod(x.flatten(d[0], d[-1]), dim=d[0]),
    "reduce_and": lambda x, d: torch.all(x != 0, dim=d),
    "reduce_or": lambda x, d: torch.any(x != 0, dim=d),
}


def make_fn(prim: str, params: dict, spec: TensorSpec) -> Callable:
    """The executable handle of a lowered primitive."""
    if prim in _UNARY:
        f = _UNARY[prim]
        return lambda dev, x: f(x)
    if prim in _BINARY:
        f = _BINARY[prim]
        return lambda dev, a, b: f(a, b)
    if prim in _REDUCE_FNS:
        f, axes = _REDUCE_FNS[prim], tuple(params["axes"])
        return lambda dev, x: f(x, axes)
    if prim == "integer_pow":
        y = int(params["y"])
        return lambda dev, x: _ipow(x, y)
    if prim == "select_n":
        return lambda dev, *xs: _select_n(*xs)
    if prim == "convert_element_type":
        dt = TORCH_DTYPES[params["new_dtype"]]
        return lambda dev, x: x.to(dt)
    if prim == "broadcast_in_dim":
        shape, dims = tuple(params["shape"]), tuple(params["broadcast_dimensions"])
        return lambda dev, x: _broadcast_in_dim(x, shape, dims)
    if prim == "reshape":
        shape = tuple(params["new_sizes"])
        return lambda dev, x: x.reshape(shape)
    if prim == "transpose":
        perm = tuple(params["permutation"])
        return lambda dev, x: x.permute(perm)
    if prim in ("copy", "stop_gradient"):
        return lambda dev, x: x
    if prim == "slice":
        idx = tuple(slice(s, e, st) for s, e, st in zip(
            params["start_indices"], params["limit_indices"],
            params["strides"]))
        return lambda dev, x: x[idx]
    if prim == "concatenate":
        dim = int(params["dimension"])
        return lambda dev, *xs: torch.cat(xs, dim)
    if prim == "iota":
        dim, shape = int(params["dimension"]), tuple(params["shape"])
        dt = TORCH_DTYPES[spec.dtype]

        def iota(dev):
            v = torch.arange(shape[dim], dtype=dt, device=dev)
            return _broadcast_in_dim(v, shape, (dim,))
        return iota
    if prim == "dot_general":
        dn = params["dimension_numbers"]
        return lambda dev, a, b: dot_general(a, b, dn)
    raise NotImplementedError(f"no execution handle for primitive {prim!r}")


# --------------------------------------------------------------------------
# the tracer
# --------------------------------------------------------------------------
_ALIAS_OPS = {aten.clone.default, aten.alias.default, aten.detach.default,
              aten.lift_fresh_copy.default, aten.contiguous.default}
_VIEW_OPS = {aten.view.default, aten._unsafe_view.default,
             aten.reshape.default, aten.unsqueeze.default,
             aten.squeeze.dim, aten.squeeze.dims, aten.squeeze.default,
             aten.flatten.using_ints, aten.unflatten.int}
_UNARY_ATEN = {
    aten.neg.default: "neg", aten.abs.default: "abs", aten.exp.default: "exp",
    aten.exp2.default: "exp2", aten.expm1.default: "expm1",
    aten.log.default: "log", aten.log1p.default: "log1p",
    aten.tanh.default: "tanh", aten.sin.default: "sin", aten.cos.default: "cos",
    aten.sigmoid.default: "logistic", aten.erf.default: "erf",
    aten.rsqrt.default: "rsqrt", aten.sqrt.default: "sqrt",
    aten.floor.default: "floor", aten.ceil.default: "ceil",
    aten.sign.default: "sign", aten.logical_not.default: "not",
}
_BINARY_ATEN = {
    "add": "add", "sub": "sub", "mul": "mul", "div": "div",
    "maximum": "max", "minimum": "min", "ge": "ge", "gt": "gt", "le": "le",
    "lt": "lt", "eq": "eq", "ne": "ne", "atan2": "atan2",
    "logical_and": "and", "logical_or": "or",
}
_SCALAR_TYPES = (int, float, bool)


def _val(n):
    return n.meta.get("val") if hasattr(n, "meta") else None


#: Ops a view chain around a batched product may hold (value-preserving
#: index maps; ``expand`` only to the shape it already has).
_CHAIN_OPS = _VIEW_OPS | {aten.permute.default, aten.transpose.int,
                          aten.t.default, aten.expand.default}


def _replay(chain, shape):
    """Replay the view chain ``chain`` (fx nodes, first applied first) on
    a contiguous meta tensor of ``shape``; None if a step is not a view
    there or an ``expand`` grows the tensor."""
    m = torch.empty(tuple(shape), device="meta")
    for c in chain:
        before = tuple(m.shape)
        try:
            m = c.target(m, *c.args[1:], **c.kwargs)
        except RuntimeError:
            return None
        if c.target is aten.expand.default and tuple(m.shape) != before:
            return None
    return m


def _same_view(m, ref) -> bool:
    """Equal shape and equal strides on every dim longer than 1: the two
    views read the same elements of a contiguous source."""
    return (tuple(m.shape) == tuple(ref.shape)
            and all(a == b for a, b, d in zip(m.stride(), ref.stride(),
                                              m.shape) if d != 1))


def _batched_source(a):
    """(source, transposed) for a bmm operand ``a`` [BH, X, Y] that is a
    view chain of a rank-r source flattened over its r - 2 leading dims
    (``transposed``: with its last two dims swapped first); the deepest
    such source, or None."""
    x, y = _val(a).shape[1:]
    chain: list = []
    cur, found = a, None
    while True:
        sv = _val(cur)
        if isinstance(sv, torch.Tensor) and sv.dim() >= 3:
            m = _replay(chain, sv.shape)
            if m is not None:
                base = torch.empty(tuple(sv.shape), device="meta")
                bh = math.prod(sv.shape[:-2])
                if (tuple(sv.shape[-2:]) == (x, y)
                        and _same_view(m, base.view(bh, x, y))):
                    found = (cur, False)
                elif (tuple(sv.shape[-2:]) == (y, x) and _same_view(
                        m, base.transpose(-1, -2).view(bh, x, y))):
                    found = (cur, True)
        if not (hasattr(cur, "target") and cur.target in _CHAIN_OPS):
            return found
        chain.insert(0, cur)
        cur = cur.args[0]


def _unflatten_end(n, out: tuple):
    """The last node of the single-use view chain that takes bmm ``n``'s
    [BH, M, N] result to a contiguous ``out`` = batch + (M, N) (``n``
    itself for a rank-3 product), or None."""
    ref = torch.empty(out, device="meta")
    chain: list = []
    cur = n
    for _ in range(8):
        m = _replay(chain, _val(n).shape)
        if m is not None and _same_view(m, ref):
            return cur
        users = list(cur.users)
        if len(users) != 1 or users[0].target not in _CHAIN_OPS:
            return None
        cur = users[0]
        chain.append(cur)
    return None


class _Tracer:
    def __init__(self) -> None:
        self.graph = Graph()
        self._next = 0
        self.env: dict[Any, int] = {}     # fx node -> IR node id

    # -- node construction -------------------------------------------------
    def new(self, prim: str, inputs: Sequence[int], spec: TensorSpec, *,
            params: dict | None = None, kind: OpKind | None = None,
            value=None, label: str = "", fn: Callable | None = None) -> int:
        p = dict(params or {})
        if kind is None:
            kind = classify(prim)
        if fn is None and kind not in (OpKind.INPUT, OpKind.CONST):
            fn = make_fn(prim, p, spec)
        if fn is not None:
            p["_fn"] = fn
        node = Node(self._next, prim, kind, tuple(inputs), spec, p, value,
                    label)
        self.graph.add(node)
        self._next += 1
        return node.nid

    def const(self, value, dtype: str) -> int:
        return self.new("const", (), TensorSpec((), dtype), kind=OpKind.CONST,
                        value=value)

    def spec(self, nid: int) -> TensorSpec:
        return self.graph.node(nid).spec

    def promote(self, nid: int, out_rank: int) -> int:
        """Rank-raising broadcast made explicit (jnp's rank promotion)."""
        s = self.spec(nid)
        r = len(s.shape)
        if r == 0 or r >= out_rank:
            return nid
        shape = (1,) * (out_rank - r) + s.shape
        return self.new("broadcast_in_dim", (nid,), TensorSpec(shape, s.dtype),
                        params={"shape": shape,
                                "broadcast_dimensions":
                                    tuple(range(out_rank - r, out_rank))})

    def elementwise(self, prim: str, args: Sequence, out: TensorSpec,
                    operand_dtype: str | None = None, **params) -> int:
        """Lower an elementwise op: broadcasts first, then scalar consts,
        then the op -- the order a jaxpr records them in."""
        rank = len(out.shape)
        tensor_ids = {}
        for i, a in enumerate(args):
            if not isinstance(a, _SCALAR_TYPES):
                tensor_ids[i] = self.promote(self.env[a], rank)
        if operand_dtype is None:
            operand_dtype = next(
                (self.spec(t).dtype for t in tensor_ids.values()), out.dtype)
        ins = []
        for i, a in enumerate(args):
            if i in tensor_ids:
                ins.append(tensor_ids[i])
            elif isinstance(a, float) and not operand_dtype.startswith(
                    ("float", "bfloat")):
                ins.append(self.const(a, "float32"))
            else:
                ins.append(self.const(a, operand_dtype))
        return self.new(prim, ins, out, params=params)

    def ew(self, prim: str, ins: Sequence, spec: TensorSpec, **params) -> int:
        """An element-wise node on IR ids (ints) and Python floats (each
        a ``const`` node of ``spec``'s dtype, float32 beside a bool
        result), ranks raised as ``elementwise`` raises them: the building
        block of the multi-node lowerings."""
        rank = len(spec.shape)
        ids = []
        for a in ins:
            if isinstance(a, float):
                dt = spec.dtype if spec.dtype != "bool" else "float32"
                ids.append(self.const(a, dt))
            else:
                ids.append(self.promote(a, rank))
        return self.new(prim, ids, spec, params=params)

    # -- lowering ------------------------------------------------------------
    def lower(self, gm: torch.fx.GraphModule) -> Graph:
        placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
        self._matmul_views(gm)
        for n in placeholders:
            nid = self.new("input", (), _spec_of(_val(n)), kind=OpKind.INPUT,
                           label=n.name)
            self.graph.inputs.append(nid)
            self.env[n] = nid
        out_node = None
        for n in gm.graph.nodes:
            if n.op == "placeholder":
                continue
            if n.op == "output":
                out_node = n
                continue
            if n.op == "get_attr":
                t = getattr(gm, n.target)
                self.env[n] = self.new(
                    "const", (), _spec_of(t), kind=OpKind.CONST,
                    value=t.detach().cpu().numpy(), label=n.name)
                continue
            if n.op != "call_function":
                raise NotImplementedError(f"fx node {n.op} {n.target}")
            if n in self.fold_alias:  # a folded bmm's unflattening views
                self.env[n] = self.env[self.fold_alias[n]]
                continue
            self.env[n] = self.lower_call(n)
        flat_out = pytree.tree_leaves(out_node.args[0])
        self.graph.outputs = [self.env[o] for o in flat_out]
        return _prune(self.graph)

    def _matmul_views(self, gm) -> None:
        """``x @ w`` with x of rank > 2 traces to view(x) -> mm -> view.
        Mark such mm nodes so they lower to ONE rank-k ``dot_general`` on
        the unflattened operand, as the reference traces them.  A batched
        product (``q @ k.transpose(-1, -2)``, ``p @ v`` or their
        ``einsum`` forms on rank-4 operands) traces to views -> bmm ->
        views; ``_bmm_views`` marks those."""
        self.mm_unflat: dict[Any, Any] = {}
        self.bmm_fold: dict[Any, tuple] = {}
        self.fold_alias: dict[Any, Any] = {}
        for n in gm.graph.nodes:
            if n.op == "call_function" and n.target is aten.bmm.default:
                self._bmm_views(n)
            if n.op != "call_function" or n.target is not aten.mm.default:
                continue
            a = n.args[0]
            if not (hasattr(a, "target") and a.target in _VIEW_OPS):
                continue
            src = a.args[0]
            sv, av = _val(src), _val(a)
            if sv is None or sv.dim() < 2 or sv.shape[-1] != av.shape[-1]:
                continue
            users = list(n.users)
            if users and all(u.target in _VIEW_OPS
                             and tuple(_val(u).shape)
                             == tuple(sv.shape[:-1]) + (_val(n).shape[-1],)
                             for u in users):
                self.mm_unflat[n] = src

    def _bmm_views(self, n) -> None:
        """Mark ``n`` (a bmm) to lower to ONE rank-r ``dot_general`` when
        each operand is a view chain of a rank-r tensor flattened over its
        r - 2 leading (batch) dims, with or without its last two dims
        swapped, both with the same batch dims, and the product's only
        use is a view chain back to ``batch + (M, N)``.  A chain is
        recognised by replaying it on a meta tensor and comparing the
        strides with those of the plain flatten."""
        ops = []
        for a in n.args[:2]:
            got = _batched_source(a)
            if got is None:
                return
            ops.append(got)
        (a_src, a_t), (b_src, b_t) = ops
        sa, sb = _val(a_src).shape, _val(b_src).shape
        if len(sa) != len(sb) or sa[:-2] != sb[:-2]:
            return
        out = tuple(sa[:-2]) + tuple(_val(n).shape[1:])
        end = _unflatten_end(n, out)
        if end is None:
            return
        r = len(sa)
        dn = (((r - 2 if a_t else r - 1,), (r - 1 if b_t else r - 2,)),
              (tuple(range(r - 2)), tuple(range(r - 2))))
        self.bmm_fold[n] = (a_src, b_src, dn, out)
        if end is not n:
            self.fold_alias[end] = n

    def lower_call(self, n) -> int:
        t = n.target
        out = _val(n)
        if t is operator.getitem:
            base = self.env[n.args[0]]
            return self.new("tuple_get", (base,), _spec_of(out),
                            params={"index": n.args[1]}, kind=OpKind.OPAQUE,
                            fn=lambda dev, x, i=n.args[1]: x[i])
        if t in _ALIAS_OPS:
            return self.env[n.args[0]]
        name = t.overloadpacket.__name__ if hasattr(t, "overloadpacket") else ""
        spec = _spec_of(out) if isinstance(out, torch.Tensor) else None
        args = n.args

        if t in _VIEW_OPS:
            src = self.env[args[0]]
            if self.spec(src).shape == spec.shape:
                return src
            return self.new("reshape", (src,), spec,
                            params={"new_sizes": spec.shape,
                                    "dimensions": None})
        if t is aten._to_copy.default:
            src = self.env[args[0]]
            if self.spec(src).dtype == spec.dtype:
                return src
            return self.new("convert_element_type", (src,), spec,
                            params={"new_dtype": spec.dtype})
        if t in _UNARY_ATEN:
            return self.elementwise(_UNARY_ATEN[t], args[:1], spec)
        if (name in _BINARY_ATEN and len(args) == 2
                and n.kwargs.get("alpha", 1) == 1
                and n.kwargs.get("rounding_mode") is None):
            prim = _BINARY_ATEN[name]
            tensor_dt = next((self.spec(self.env[a]).dtype for a in args
                              if not isinstance(a, _SCALAR_TYPES)), spec.dtype)
            return self.elementwise(prim, args, spec, operand_dtype=tensor_dt)
        if t in (aten.pow.Tensor_Scalar,):
            y = args[1]
            if isinstance(y, int) or (isinstance(y, float) and y.is_integer()
                                      and abs(y) <= 8):
                return self.new("integer_pow", (self.env[args[0]],), spec,
                                params={"y": int(y)})
            return self.elementwise("pow", args, spec)
        if t is aten.silu.default:
            x = self.env[args[0]]
            s = self.new("logistic", (x,), spec)
            return self.new("mul", (x, s), spec)
        if t is aten._softmax.default:
            return self.softmax(self.env[args[0]], int(args[1]), spec)
        if t in _LOWERED:
            return _LOWERED[t](self, n, spec)
        if t in (aten.mean.dim, aten.sum.dim_IntList, aten.amax.default,
                 aten.amin.default):
            x = self.env[args[0]]
            xs = self.spec(x)
            rank = len(xs.shape)
            dims = args[1] if len(args) > 1 else list(range(rank))
            dims = [dims] if isinstance(dims, int) else list(dims or range(rank))
            axes = tuple(sorted(d % rank for d in dims))
            keep = bool(args[2]) if len(args) > 2 else False
            prim = {"mean": "reduce_sum", "sum": "reduce_sum",
                    "amax": "reduce_max", "amin": "reduce_min"}[name]
            red_shape = tuple(d for i, d in enumerate(xs.shape) if i not in axes)
            r = self.new(prim, (x,), TensorSpec(red_shape, spec.dtype),
                         params={"axes": axes})
            if keep:
                r = self.new("broadcast_in_dim", (r,), spec,
                             params={"shape": spec.shape,
                                     "broadcast_dimensions": tuple(
                                         i for i in range(rank)
                                         if i not in axes)})
            if name == "mean":
                cnt = math.prod(xs.shape[a] for a in axes)
                c = self.const(float(cnt), spec.dtype)
                r = self.new("div", (r, c), spec)
            return r
        if t is aten.where.self:
            c, a, b = args
            rank = len(spec.shape)
            ins = [self.promote(self.env[c], rank) if not isinstance(
                c, _SCALAR_TYPES) else self.const(c, "bool")]
            for v in (b, a):
                ins.append(self.promote(self.env[v], rank)
                           if not isinstance(v, _SCALAR_TYPES)
                           else self.const(v, spec.dtype))
            return self.new("select_n", ins, spec)
        if t is aten.scalar_tensor.default:
            return self.const(args[0], spec.dtype)
        if t in (aten.full.default,) and not spec.shape:
            return self.const(args[1], spec.dtype)
        if t is aten.expand.default:
            x = self.env[args[0]]
            xs = self.spec(x)
            if xs.shape == spec.shape:
                return x
            r = len(spec.shape) - len(xs.shape)
            return self.new("broadcast_in_dim", (x,), spec,
                            params={"shape": spec.shape,
                                    "broadcast_dimensions":
                                        tuple(range(r, len(spec.shape)))})
        if t in (aten.permute.default, aten.transpose.int, aten.t.default):
            x = self.env[args[0]]
            rank = len(self.spec(x).shape)
            if t is aten.permute.default:
                perm = tuple(d % rank for d in args[1])
            else:
                d0, d1 = ((args[1] % rank, args[2] % rank)
                          if t is aten.transpose.int else (0, 1))
                perm = list(range(rank))
                perm[d0], perm[d1] = perm[d1], perm[d0]
                perm = tuple(perm)
            if perm == tuple(range(rank)):
                return x
            return self.new("transpose", (x,), spec,
                            params={"permutation": perm})
        if t is aten.slice.Tensor:
            x = self.env[args[0]]
            xs = self.spec(x)
            rank = len(xs.shape)
            dim = (args[1] if len(args) > 1 else 0) % rank
            start = args[2] if len(args) > 2 and args[2] is not None else 0
            end = args[3] if len(args) > 3 and args[3] is not None else xs.shape[dim]
            step = args[4] if len(args) > 4 else 1
            size = xs.shape[dim]
            start = max(0, start + size if start < 0 else min(start, size))
            end = max(0, end + size if end < 0 else min(end, size))
            if (start, end, step) == (0, size, 1):
                return x
            starts = [0] * rank
            limits = list(xs.shape)
            strides = [1] * rank
            starts[dim], limits[dim], strides[dim] = start, end, step
            return self.new("slice", (x,), spec,
                            params={"start_indices": tuple(starts),
                                    "limit_indices": tuple(limits),
                                    "strides": tuple(strides)})
        if t is aten.cat.default:
            xs = [self.env[a] for a in args[0]]
            dim = (args[1] if len(args) > 1 else 0) % len(spec.shape)
            return self.new("concatenate", xs, spec,
                            params={"dimension": dim})
        if t in (aten.arange.default, aten.arange.start,
                 aten.arange.start_step):
            vals = list(args)
            start, end, step = ((0, vals[0], 1) if len(vals) == 1 else
                                (vals[0], vals[1], 1) if len(vals) == 2 else
                                tuple(vals))
            r = self.new("iota", (), spec,
                         params={"dtype": spec.dtype, "shape": spec.shape,
                                 "dimension": 0})
            if step != 1:
                r = self.new("mul", (r, self.const(step, spec.dtype)), spec)
            if start != 0:
                r = self.new("add", (r, self.const(start, spec.dtype)), spec)
            return r
        if t in (aten.mm.default, aten.bmm.default):
            return self.matmul(n, spec)
        return self.opaque(n, spec)

    def softmax(self, x: int, dim: int, spec: TensorSpec) -> int:
        shape = spec.shape
        rank = len(shape)
        dim %= rank
        red = tuple(d for i, d in enumerate(shape) if i != dim)
        keep = tuple(1 if i == dim else d for i, d in enumerate(shape))
        bdims = tuple(i for i in range(rank) if i != dim)
        dt = spec.dtype
        m = self.new("reduce_max", (x,), TensorSpec(red, dt),
                     params={"axes": (dim,)})
        mb = self.new("broadcast_in_dim", (m,), TensorSpec(keep, dt),
                      params={"shape": keep, "broadcast_dimensions": bdims})
        s = self.new("sub", (x, mb), spec)
        e = self.new("exp", (s,), spec)
        z = self.new("reduce_sum", (e,), TensorSpec(red, dt),
                     params={"axes": (dim,)})
        zb = self.new("broadcast_in_dim", (z,), TensorSpec(keep, dt),
                      params={"shape": keep, "broadcast_dimensions": bdims})
        return self.new("div", (e, zb), spec)

    def matmul(self, n, spec: TensorSpec) -> int:
        if n in self.bmm_fold:
            a_src, b_src, dn, out = self.bmm_fold[n]
            return self.new("dot_general", (self.env[a_src], self.env[b_src]),
                            TensorSpec(out, spec.dtype),
                            params={"dimension_numbers": dn})
        a_fx, b_fx = n.args[0], n.args[1]
        if n in self.mm_unflat:
            a_fx = self.mm_unflat[n]
            sv = _val(a_fx)
            spec = TensorSpec(tuple(sv.shape[:-1]) + (spec.shape[-1],),
                              spec.dtype)
        a, b = self.env[a_fx], self.env[b_fx]
        ra = len(self.spec(a).shape)
        nb = 1 if n.target is aten.bmm.default else 0
        rc = nb  # rhs contracting dim: (K, N) or (B, K, N)
        bnode = self.graph.node(b)
        # fold a transpose of the rhs's last two dims into the contraction
        if (bnode.prim == "transpose"
                and tuple(bnode.params["permutation"])
                == tuple(range(nb)) + (nb + 1, nb)):
            b = bnode.inputs[0]
            rc = nb + 1
        dn = (((ra - 1,), (rc,)), (tuple(range(nb)), tuple(range(nb))))
        return self.new("dot_general", (a, b), spec,
                        params={"dimension_numbers": dn})

    def opaque(self, n, spec) -> int:
        """Any other aten op: a hard graph break that calls the op itself."""
        flat, tree = pytree.tree_flatten((n.args, n.kwargs))
        slots = [i for i, a in enumerate(flat) if isinstance(a, torch.fx.Node)]
        ins = [self.env[flat[i]] for i in slots]
        target = n.target

        def call(dev, *vals, _flat=tuple(flat), _slots=tuple(slots)):
            args = list(_flat)
            for i, v in zip(_slots, vals):
                args[i] = v
            a, k = pytree.tree_unflatten(args, tree)
            if "device" in k:
                k = dict(k, device=dev)
            return target(*a, **k)

        out = _val(n)
        if spec is None:  # multi-output op: projections via tuple_get
            first = next(v for v in out if isinstance(v, torch.Tensor))
            return self.new(str(n.target), ins, _spec_of(first),
                            params={"multi_out": len(out)},
                            kind=OpKind.OPAQUE, fn=call)
        return self.new(str(n.target), ins, spec, kind=OpKind.OPAQUE,
                        fn=call)


# --------------------------------------------------------------------------
# multi-node lowerings: the ops a forward and the VJPs of the reference's
# patterns emit, in the reference's primitives (each held to its aten op
# by ``check_lowerings``)
# --------------------------------------------------------------------------
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_INV_SQRT_2 = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _gelu(tr: _Tracer, n, spec: TensorSpec) -> int:
    """``gelu``, as ``jax.nn.gelu`` writes it: ``x * cdf`` with the tanh
    form's cdf ``0.5 (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3)))``, or the
    exact one's ``(erf(x / sqrt 2) + 1) / 2``."""
    x = tr.env[n.args[0]]
    if n.kwargs.get("approximate", "none") == "tanh":
        x3 = tr.new("integer_pow", (x,), spec, params={"y": 3})
        inner = tr.ew("add", [x, tr.ew("mul", [0.044715, x3], spec)], spec)
        t = tr.new("tanh", (tr.ew("mul", [_SQRT_2_OVER_PI, inner], spec),),
                   spec)
        cdf = tr.ew("mul", [0.5, tr.ew("add", [1.0, t], spec)], spec)
        return tr.ew("mul", [x, cdf], spec)
    e = tr.new("erf", (tr.ew("mul", [x, _INV_SQRT_2], spec),), spec)
    return tr.ew("div", [tr.ew("mul", [x, tr.ew("add", [e, 1.0], spec)],
                               spec), 2.0], spec)


def _gelu_backward(tr: _Tracer, n, spec: TensorSpec) -> int:
    """``gelu_backward(grad, x)``: ``grad * gelu'(x)``, the derivative of
    the form ``approximate`` names (PyTorch's own formulas)."""
    g, x = tr.env[n.args[0]], tr.env[n.args[1]]
    approx = n.kwargs.get("approximate",
                          n.args[2] if len(n.args) > 2 else "none")
    if approx == "tanh":
        x2 = tr.new("integer_pow", (x,), spec, params={"y": 2})
        x3 = tr.new("integer_pow", (x,), spec, params={"y": 3})
        inner = tr.ew("mul", [_SQRT_2_OVER_PI, tr.ew(
            "add", [x, tr.ew("mul", [0.044715, x3], spec)], spec)], spec)
        t = tr.new("tanh", (inner,), spec)
        left = tr.ew("mul", [0.5, x], spec)
        d_left = tr.ew("mul", [0.5, tr.ew("add", [1.0, t], spec)], spec)
        d_inner = tr.ew("mul", [_SQRT_2_OVER_PI, tr.ew(
            "add", [1.0, tr.ew("mul", [3.0 * 0.044715, x2], spec)], spec)],
            spec)
        sech2 = tr.ew("sub", [1.0, tr.ew("mul", [t, t], spec)], spec)
        d_right = tr.ew("mul", [tr.ew("mul", [left, sech2], spec), d_inner],
                        spec)
        return tr.ew("mul", [g, tr.ew("add", [d_left, d_right], spec)], spec)
    cdf = tr.ew("mul", [0.5, tr.ew("add", [1.0, tr.new(
        "erf", (tr.ew("mul", [x, _INV_SQRT_2], spec),), spec)], spec)], spec)
    pdf = tr.ew("mul", [_INV_SQRT_2PI, tr.new("exp", (tr.ew(
        "mul", [-0.5, tr.ew("mul", [x, x], spec)], spec),), spec)], spec)
    return tr.ew("mul", [g, tr.ew("add", [cdf, tr.ew("mul", [x, pdf], spec)],
                                  spec)], spec)


def _silu_backward(tr: _Tracer, n, spec: TensorSpec) -> int:
    """``silu_backward(grad, x)``: ``grad s (1 + x (1 - s))``, s the
    logistic of x."""
    g, x = tr.env[n.args[0]], tr.env[n.args[1]]
    sg = tr.new("logistic", (x,), spec)
    inner = tr.ew("add", [1.0, tr.ew("mul", [x, tr.ew("sub", [1.0, sg], spec)],
                                     spec)], spec)
    return tr.ew("mul", [g, tr.ew("mul", [sg, inner], spec)], spec)


def _sigmoid_backward(tr: _Tracer, n, spec: TensorSpec) -> int:
    """``sigmoid_backward(grad, y)``: ``grad y (1 - y)``."""
    g, y = tr.env[n.args[0]], tr.env[n.args[1]]
    return tr.ew("mul", [g, tr.ew("mul", [y, tr.ew("sub", [1.0, y], spec)],
                                  spec)], spec)


def _tanh_backward(tr: _Tracer, n, spec: TensorSpec) -> int:
    """``tanh_backward(grad, y)``: ``grad (1 - y^2)``."""
    g, y = tr.env[n.args[0]], tr.env[n.args[1]]
    return tr.ew("mul", [g, tr.ew("sub", [1.0, tr.ew("mul", [y, y], spec)],
                                  spec)], spec)


def _threshold_backward(tr: _Tracer, n, spec: TensorSpec) -> int:
    """``threshold_backward(grad, x, t)``: 0 where x <= t, else grad (a
    ``select_n``, as ``where`` lowers)."""
    g, x = tr.env[n.args[0]], tr.env[n.args[1]]
    keep = tr.ew("le", [x, float(n.args[2])], TensorSpec(spec.shape, "bool"))
    return tr.ew("select_n", [keep, g, 0.0], spec)


def _relu(tr: _Tracer, n, spec: TensorSpec) -> int:
    """``relu``: ``max(x, 0)``, as ``jax.nn.relu``."""
    return tr.ew("max", [tr.env[n.args[0]], 0.0], spec)


def _softmax_backward(tr: _Tracer, n, spec: TensorSpec) -> int:
    """``_softmax_backward_data(grad, y, dim)``: ``y (grad - sum(grad y,
    dim))``."""
    g, y = tr.env[n.args[0]], tr.env[n.args[1]]
    shape, rank = spec.shape, len(spec.shape)
    dim = int(n.args[2]) % rank
    red = tuple(d for i, d in enumerate(shape) if i != dim)
    keep = tuple(1 if i == dim else d for i, d in enumerate(shape))
    gy = tr.ew("mul", [g, y], spec)
    s = tr.new("reduce_sum", (gy,), TensorSpec(red, spec.dtype),
               params={"axes": (dim,)})
    sb = tr.new("broadcast_in_dim", (s,), TensorSpec(keep, spec.dtype),
                params={"shape": keep, "broadcast_dimensions": tuple(
                    i for i in range(rank) if i != dim)})
    return tr.ew("mul", [y, tr.ew("sub", [g, sb], spec)], spec)


def _filled(tr: _Tracer, n, spec: TensorSpec) -> int:
    """A tensor of one value (``fill``, ``ones_like``, ``zeros_like``,
    ``full_like``): a broadcast ``const``, independent of the tensor it
    was shaped like."""
    t = n.target
    value = (1 if t is aten.ones_like.default else
             0 if t is aten.zeros_like.default else n.args[1])
    c = tr.const(value, spec.dtype)
    if not spec.shape:
        return c
    return tr.new("broadcast_in_dim", (c,), spec,
                  params={"shape": spec.shape, "broadcast_dimensions": ()})


_LOWERED: dict[Any, Callable] = {
    aten.gelu.default: _gelu,
    aten.gelu_backward.default: _gelu_backward,
    aten.silu_backward.default: _silu_backward,
    aten.sigmoid_backward.default: _sigmoid_backward,
    aten.tanh_backward.default: _tanh_backward,
    aten.threshold_backward.default: _threshold_backward,
    aten.relu.default: _relu,
    aten._softmax_backward_data.default: _softmax_backward,
    aten.fill.Scalar: _filled,
    aten.ones_like.default: _filled,
    aten.zeros_like.default: _filled,
    aten.full_like.default: _filled,
}


def _prune(graph: Graph) -> Graph:
    """Drop nodes no output depends on (folded transposes and views) and
    renumber densely, keeping topological order: the planner's convexity
    bitsets index nodes by id."""
    live: set[int] = set(graph.outputs)
    for nid in sorted(graph.nodes, reverse=True):
        if nid in live:
            live.update(graph.node(nid).inputs)
    live.update(graph.inputs)
    remap = {old: new for new, old in enumerate(sorted(live))}
    out = Graph()
    for old in sorted(live):
        n = graph.node(old)
        out.add(Node(remap[old], n.prim, n.kind,
                     tuple(remap[i] for i in n.inputs), n.spec, n.params,
                     n.value, n.label))
    out.inputs = [remap[i] for i in graph.inputs]
    out.outputs = [remap[o] for o in graph.outputs]
    return out


def _mutating(gm: torch.fx.GraphModule) -> list[str]:
    """The in-place (mutating) aten ops of a traced graph."""
    return sorted({str(n.target) for n in gm.graph.nodes
                   if n.op == "call_function"
                   and isinstance(n.target, torch._ops.OpOverload)
                   and n.target._schema.is_mutable})


def trace_with_tree(fn: Callable, *example_args,
                    functional: bool = False) -> tuple[Graph, Any]:
    """Trace ``fn`` on example tensors (any pytree of tensors) to a Graph.

    Returns ``(graph, out_spec)``: graph inputs are the flattened leaves of
    ``example_args`` in order, graph outputs the flattened leaves of the
    result; ``out_spec`` rebuilds the result's structure.  Tracing runs
    on fake tensors, so no real computation happens at any size.  Each
    leaf is traced as a tensor of its own, even where the example passes
    one tensor twice (Zamba2's first shared block gets the embedding as
    both its hidden state and its ``emb0``): the compiled graph is reused
    for calls whose leaves differ.

    ``functional`` traces ``fn`` under ``torch.func.functionalize`` (the
    in-place ops autograd's formulas use, such as SiLU's ``fill_`` and
    ``sub_``, become their out-of-place forms) and raises if an in-place
    op is left: a backward function (``stitched_jit(differentiable=True)``)
    is traced so.  Without it the trace keeps what ``fn`` does (an
    in-place cache write stays an opaque, in-place node).
    """
    flat, in_spec = pytree.tree_flatten(example_args)
    flat = [t.detach() if isinstance(t, torch.Tensor) else t for t in flat]
    holder = {}

    def flat_fn(*leaves):
        args = pytree.tree_unflatten(list(leaves), in_spec)
        res = fn(*args)
        out, holder["spec"] = pytree.tree_flatten(res)
        return tuple(out)

    if functional:
        gm = make_fx(torch.func.functionalize(flat_fn, remove="mutations"),
                     tracing_mode="fake")(*flat)
        left = _mutating(gm)
        if left:
            raise ValueError(f"functionalized trace still mutates: {left}")
    else:
        gm = make_fx(flat_fn, tracing_mode="fake")(*flat)
    return _Tracer().lower(gm), holder["spec"]


def trace(fn: Callable, *example_args, functional: bool = False) -> Graph:
    """``trace_with_tree`` without the output structure."""
    return trace_with_tree(fn, *example_args, functional=functional)[0]


def lowering_cases(seed: int = 0, shape=(6, 40)) -> dict:
    """{name: (the aten op as a function of tensors, its inputs)} for
    every multi-node lowering (``_LOWERED``), on inputs from ``seed``."""
    gen = torch.Generator().manual_seed(seed)

    def r():
        return torch.randn(*shape, generator=gen)

    x, g = r(), r()
    y = torch.sigmoid(r())
    return {
        "gelu": (lambda a: aten.gelu(a), (x,)),
        "gelu_tanh": (lambda a: aten.gelu(a, approximate="tanh"), (x,)),
        "gelu_backward": (lambda a, b: aten.gelu_backward(a, b), (g, x)),
        "gelu_backward_tanh": (lambda a, b: aten.gelu_backward(
            a, b, approximate="tanh"), (g, x)),
        "silu_backward": (lambda a, b: aten.silu_backward(a, b), (g, x)),
        "sigmoid_backward": (lambda a, b: aten.sigmoid_backward(a, b),
                             (g, y)),
        "tanh_backward": (lambda a, b: aten.tanh_backward(a, b),
                          (g, torch.tanh(x))),
        "threshold_backward": (lambda a, b: aten.threshold_backward(
            a, b, 0.0), (g, x)),
        "relu": (lambda a: aten.relu(a), (x,)),
        "_softmax_backward_data": (lambda a, b: aten._softmax_backward_data(
            a, b, -1, torch.float32), (g, torch.softmax(x, -1))),
        "fill": (lambda a: aten.fill(a, 1.5), (x,)),
        "ones_like": (lambda a: aten.ones_like(a) * a, (x,)),
        "zeros_like": (lambda a: aten.zeros_like(a) + a, (x,)),
        "full_like": (lambda a: aten.full_like(a, -2.0), (x,)),
    }


def check_lowerings(seed: int = 0) -> dict:
    """{name: (max |lowering - aten op|, OPAQUE nodes left)} of every
    multi-node lowering: the op traced and lowered to the reference's
    primitives, replayed op by op in plain PyTorch, against the aten op
    itself on the same random inputs."""
    out = {}
    for name, (fn, args) in lowering_cases(seed).items():
        graph = trace(fn, *args)
        env = dict(zip(graph.inputs, args))
        run_subgraph(graph, [n for n in graph.topo_order()
                             if n not in env], env, "cpu")
        got = env[graph.outputs[0]]
        want = fn(*args)
        opaque = sum(graph.node(n).kind is OpKind.OPAQUE
                     for n in graph.nodes)
        out[name] = (float((got.to(want.dtype) - want).abs().max()), opaque)
    return out


# --------------------------------------------------------------------------
# graph execution helpers (plain PyTorch replay)
# --------------------------------------------------------------------------
def const_tensor(node: Node, device) -> torch.Tensor:
    """A CONST node's value as a tensor on ``device`` (cached per device)."""
    cache = node.params.setdefault("_tensors", {})
    key = str(device)
    t = cache.get(key)
    if t is None:
        t = torch.as_tensor(np.asarray(node.value),
                            dtype=TORCH_DTYPES[node.spec.dtype]).to(device)
        cache[key] = t
    return t


def bind_node(node: Node, invals: Sequence[Any], device) -> Any:
    """Re-execute one traced node on concrete tensors."""
    if node.kind is OpKind.CONST:
        return const_tensor(node, device)
    fn = node.params.get("_fn")
    if fn is None:
        raise ValueError(f"node {node!r} is not executable")
    return fn(device, *invals)


def run_subgraph(graph: Graph, members: Sequence[int], env: dict[int, Any],
                 device) -> None:
    """Evaluate ``members`` (topo-sorted ids) in-place into ``env``."""
    for nid in sorted(members):
        node = graph.node(nid)
        if node.kind is OpKind.CONST:
            env[nid] = const_tensor(node, device)
            continue
        invals = [env[i] if i in env else const_tensor(graph.node(i), device)
                  for i in node.inputs]
        env[nid] = bind_node(node, invals, device)
