"""``stitched_jit(fn, differentiable=True)`` in the PyTorch port, against the
JAX package.

The reference's differentiable wrapper is a ``custom_vjp`` whose backward
traces ``jax.vjp(fn)`` and stitches it; the port's is a
``torch.autograd.Function`` whose backward traces ``torch.func.vjp(fn)``,
functionalized, and stitches it.  The same inputs, made with numpy from a
seed, go through both (the reference in Pallas interpret mode under
``jax.grad``, the port's plain versions on the CPU under
``torch.autograd.grad``) for the reference's own patterns
(``tests/test_codegen_stitch.py``): LayerNorm, RMSNorm, softmax, the bias
+ tanh-GELU chain and the tanh + SiLU chain.  Also: every multi-node
lowering of the tracer against its aten op, no ``OPAQUE`` node and no
in-place op in the backward graphs, the backward cache, pytree and
non-tensor arguments, and the reports.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.core import stitched_jit as jstitched_jit  # noqa: E402
from repro_torch.core import OpKind, check_lowerings, stitched_jit  # noqa: E402
from repro_torch.core import tracer as T  # noqa: E402

rng = np.random.default_rng(7)


def _j_ln(x, g, b):
    m = jnp.mean(x, axis=-1, keepdims=True)
    v = jnp.mean((x - m) ** 2, axis=-1, keepdims=True)
    return (x - m) * jax.lax.rsqrt(v + 1e-6) * g + b


def _t_ln(x, g, b):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + 1e-6) * g + b


#: name -> (reference fn, port fn, input shapes, atol); rtol 1e-3 as the
#: reference's own gradient tests (``test_codegen_stitch.py:78-89``,
#: atol 1e-3; ``test_plan_dispatch.py:129-141``, atol 1e-4)
PATTERNS = {
    "layernorm": (_j_ln, _t_ln, [(32, 96), (96,), (96,)], 1e-3),
    "rmsnorm": (lambda x, g: x * jax.lax.rsqrt(
        jnp.mean(x * x, -1, keepdims=True) + 1e-6) * g,
        lambda x, g: x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                                     + 1e-6) * g,
        [(16, 64), (64,)], 1e-4),
    "softmax": (lambda x: jax.nn.softmax(x, axis=-1),
                lambda x: torch.softmax(x, -1), [(8, 200)], 1e-4),
    "bias_gelu": (lambda x, b: jax.nn.gelu(x + b, approximate=True),
                  lambda x, b: F.gelu(x + b, approximate="tanh"),
                  [(64, 32), (32,)], 1e-4),
    "residual_silu": (lambda x, y: jnp.tanh(x) + jax.nn.silu(y) * x,
                      lambda x, y: torch.tanh(x) + F.silu(y) * x,
                      [(8, 128), (8, 128)], 1e-4),
}


def _inputs(shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _torch_grads(fn, args):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y = fn(*ts)
    return y, torch.autograd.grad((y ** 2).sum(), ts)


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_gradients_match_the_reference(name):
    """sum(y ** 2) through each package's differentiable wrapper: the
    port's gradients are the reference's (``jax.grad``, Pallas interpret)
    at the reference's tolerances, and its outputs its forward."""
    jfn, tfn, shapes, atol = PATTERNS[name]
    args = _inputs(shapes)
    jw = jstitched_jit(jfn, differentiable=True)
    want = jax.grad(lambda *a: jnp.sum(jw(*a) ** 2),
                    argnums=tuple(range(len(args))))(*args)
    tw = stitched_jit(tfn, differentiable=True, device="cpu")
    y, got = _torch_grads(tw, args)
    assert y.grad_fn is not None
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jw(*args)),
                               rtol=1e-4, atol=1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=atol)


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_backward_graphs_hold_no_opaque_or_inplace_op(name):
    """The stitched backward's graph (the VJP traced functionalized) is
    all primitives of the reference's vocabulary: no ``OPAQUE`` node, and
    no in-place op (SiLU's formula writes with ``fill_`` and ``sub_``;
    the functionalized trace has their out-of-place forms)."""
    _, tfn, shapes, _ = PATTERNS[name]
    args = [torch.from_numpy(a).requires_grad_() for a in _inputs(shapes)]
    tw = stitched_jit(tfn, differentiable=True, device="cpu")
    torch.autograd.grad((tw(*args) ** 2).sum(), args)
    (sf,) = tw.bwd_cache.values()
    (comp,) = sf.instances
    graph = comp.graph
    assert not [graph.node(n).prim for n in graph.nodes
                if graph.node(n).kind is OpKind.OPAQUE]
    assert not [graph.node(n).prim for n in graph.nodes
                if graph.node(n).prim.endswith("_")]
    fwd = tw.compiled(*args).graph
    assert not [fwd.node(n).prim for n in fwd.nodes
                if fwd.node(n).kind is OpKind.OPAQUE]


def test_silu_vjp_mutates_without_functionalization():
    """Why the backward is traced functionalized: SiLU's VJP traced as it
    is holds in-place ops, which ``functional=True`` removes."""
    x, ct = torch.randn(4, 8), torch.randn(4, 8)

    def vjp_fn(c, a):
        return torch.func.vjp(F.silu, a)[1](c)

    plain = T.trace(vjp_fn, ct, x)
    assert any(plain.node(n).kind is OpKind.OPAQUE for n in plain.nodes)
    functional = T.trace(vjp_fn, ct, x, functional=True)
    assert not any(functional.node(n).kind is OpKind.OPAQUE
                   for n in functional.nodes)


@pytest.mark.parametrize("name", sorted(T.lowering_cases()))
def test_lowering_matches_its_aten_op(name):
    """Each multi-node lowering, replayed op by op, equals the aten op it
    lowers on random inputs, and leaves no ``OPAQUE`` node."""
    err, opaque = check_lowerings(seed=3)[name]
    assert err <= 1e-6 and opaque == 0


@pytest.mark.parametrize("approximate", ["none", "tanh"])
def test_gelu_lowers_as_the_reference_writes_it(approximate):
    """``F.gelu`` traces to ``jax.nn.gelu``'s primitives (no ``OPAQUE``
    node), and its stitched forward and backward equal the reference's
    function and gradient on the same inputs."""
    x = rng.standard_normal((16, 48)).astype(np.float32)
    graph = T.trace(lambda a: F.gelu(a, approximate=approximate),
                    torch.from_numpy(x))
    prims = sorted(graph.node(n).prim for n in graph.nodes
                   if graph.node(n).kind not in (OpKind.INPUT,
                                                 OpKind.CONST))
    assert ("tanh" if approximate == "tanh" else "erf") in prims
    assert not any(graph.node(n).kind is OpKind.OPAQUE for n in graph.nodes)
    jfn = lambda a: jax.nn.gelu(a, approximate=approximate == "tanh")  # noqa: E731
    tw = stitched_jit(lambda a: F.gelu(a, approximate=approximate),
                      differentiable=True, device="cpu")
    y, (g,) = _torch_grads(tw, [x])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jfn(x)),
                               rtol=1e-5, atol=1e-6)
    want = jax.grad(lambda a: jnp.sum(jfn(a) ** 2))(x)
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-4)


def test_backward_cache_hits_on_the_same_shapes_and_misses_on_new_ones():
    """One stitched backward a (shapes, dtypes, device) key, as the
    reference's ``bwd_cache``: a second call at the same shapes reuses
    it, new shapes build another."""
    _, tfn, shapes, _ = PATTERNS["layernorm"]
    tw = stitched_jit(tfn, differentiable=True, device="cpu")

    def step(rows):
        args = [torch.randn(rows, 96, requires_grad=True),
                torch.randn(96, requires_grad=True),
                torch.randn(96, requires_grad=True)]
        return torch.autograd.grad((tw(*args) ** 2).sum(), args)

    step(32)
    assert len(tw.bwd_cache) == 1
    (sf,) = tw.bwd_cache.values()
    step(32)
    assert len(tw.bwd_cache) == 1 and sf.n_compiled == 1
    assert list(tw.bwd_cache.values()) == [sf]
    step(48)
    assert len(tw.bwd_cache) == 2
    assert len(tw.backward_reports()) == 2
    assert all(r.n_groups >= 1 for r in tw.backward_reports())


def test_pytree_and_non_tensor_arguments():
    """A dict of tensors in, a tuple out, a float and a string beside
    them: the floating tensor leaves get gradients, an integer tensor
    none; each non-tensor value traces a function of its own."""
    def fn(p, idx, scale, mode):
        h = p["x"] * p["g"] * scale
        h = torch.tanh(h) if mode == "tanh" else torch.sigmoid(h)
        return h, h.sum(-1) + idx.float()

    x = torch.randn(8, 16, requires_grad=True)
    g = torch.randn(16, requires_grad=True)
    idx = torch.arange(8)
    tw = stitched_jit(fn, differentiable=True, device="cpu")
    for scale, mode in ((0.5, "tanh"), (2.0, "sig"), (0.5, "tanh")):
        y1, y2 = tw({"x": x, "g": g}, idx, scale, mode)
        got = torch.autograd.grad((y1 ** 2).sum() + y2.sum(), (x, g))
        w1, w2 = fn({"x": x, "g": g}, idx, scale, mode)
        want = torch.autograd.grad((w1 ** 2).sum() + w2.sum(), (x, g))
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert len(tw._forward) == 2 and len(tw.bwd_cache) == 2


def test_report_is_the_forwards_and_plan_cache_passes_through(tmp_path):
    """``report`` is the forward's report; the backward function keeps
    the forward's options (a second wrapper on the same plan cache loads
    both plans from it)."""
    _, tfn, shapes, _ = PATTERNS["rmsnorm"]
    args = [torch.randn(*s, requires_grad=True) for s in shapes]
    reps = []
    for _ in range(2):
        tw = stitched_jit(tfn, differentiable=True, device="cpu",
                          plan_cache=str(tmp_path))
        torch.autograd.grad((tw(*args) ** 2).sum(), args)
        reps.append((tw.report(*args), tw.backward_reports()[0]))
        assert tw.report(*args).n_generated >= 1
    (f1, b1), (f2, b2) = reps
    assert not f1.plan_cache_hit and not b1.plan_cache_hit
    assert f2.plan_cache_hit and b2.plan_cache_hit
    assert f1.signature != b1.signature


def test_plain_function_on_the_cpu_differentiates_as_the_reference():
    """A stitched function without ``differentiable`` under autograd: the
    reference's differentiates under ``jax.grad`` (it does not raise), so
    the port's outputs carry a gradient too -- on the CPU through its
    plain versions -- equal to the reference's."""
    jfn, tfn, shapes, atol = PATTERNS["layernorm"]
    args = _inputs(shapes)
    jsf = jstitched_jit(jfn)
    want = jax.grad(lambda *a: jnp.sum(jsf(*a) ** 2),
                    argnums=(0, 1, 2))(*args)
    y, got = _torch_grads(stitched_jit(tfn, device="cpu"), args)
    assert y.grad_fn is not None
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=atol)


def test_differentiable_defaults_to_cuda_and_raises_without_it():
    """The entry point's device rule holds for the differentiable wrapper:
    CUDA unless the caller asks for the CPU, an error without a card."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stitched_jit(lambda x: x * 2.0, differentiable=True)
    w = stitched_jit(lambda x: x * 2.0, differentiable=True, device="cpu")
    x = torch.ones(4, 8, requires_grad=True)
    (g,) = torch.autograd.grad(w(x).sum(), x)
    torch.testing.assert_close(g, torch.full((4, 8), 2.0))
