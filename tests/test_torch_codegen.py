"""Emitter parity: the port's generated-kernel plain versions (the row-view
evaluators of ``OnePassKernel`` and ``StreamingKernel``) against the JAX
package's Pallas emitters (interpret mode) on the same traced function.

Both packages are given the same hardware preset, so they pick the same
schedule; a small-budget ``Hardware(vmem_bytes=...)`` forces streaming in
both.  Tolerances: float32 with another summation order (whole-row vs
tiled partial sums), rtol 1e-5 / atol 1e-5 unless stated.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import codegen as jcodegen  # noqa: E402
from repro.core import cost_model as jcost  # noqa: E402
from repro.core import trace as jtrace  # noqa: E402
from repro_torch.core import codegen as tcodegen  # noqa: E402
from repro_torch.core import cost_model as tcost  # noqa: E402
from repro_torch.core import trace as ttrace  # noqa: E402
from repro_torch.core.rowspec import Role, analyze  # noqa: E402

rng = np.random.default_rng(5)


def j_roles(x, rowb, colb, s):
    """FULL/ROW/COL/SCALAR inputs; FULL, ROW, COL and SCALAR outputs."""
    m = jnp.mean(x * colb, axis=-1, keepdims=True)          # ROW
    y = (x - m) * colb + rowb * s                           # FULL
    return y, m * s, colb * 2.0 + s, s * 3.0                # FULL ROW COL SC


def t_roles(x, rowb, colb, s):
    m = (x * colb).mean(-1, keepdim=True)
    y = (x - m) * colb + rowb * s
    return y, m * s, colb * 2.0 + s, s * 3.0


def j_ln(x, g, b):
    m = jnp.mean(x, axis=-1, keepdims=True)
    v = jnp.mean((x - m) ** 2, axis=-1, keepdims=True)
    return (x - m) * jax.lax.rsqrt(v + 1e-5) * g + b


def t_ln(x, g, b):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + 1e-5) * g + b


def j_fanout(x, g):
    """Six tanh branches live across two sweeps: staging every FULL value
    does not fit a 32 KiB budget, recomputing the branches does."""
    t = x * g + 1.0
    us = [jnp.tanh(t * (0.1 * (i + 1))) for i in range(6)]
    acc = x
    for u in us:
        acc = acc + u
    for u in us:
        acc = acc * (u + 0.5)
    return acc * jnp.mean(acc, axis=-1, keepdims=True)


def t_fanout(x, g):
    t = x * g + 1.0
    us = [torch.tanh(t * (0.1 * (i + 1))) for i in range(6)]
    acc = x
    for u in us:
        acc = acc + u
    for u in us:
        acc = acc * (u + 0.5)
    return acc * acc.mean(-1, keepdim=True)


def _emit_both(jfn, tfn, args, jhw, thw):
    jg = jtrace(jfn, *args)
    tg = ttrace(tfn, *[torch.from_numpy(a) for a in args])
    pat = frozenset(jg.fusible_nodes())
    assert pat == frozenset(tg.fusible_nodes())
    jem = jcodegen.emit_pattern(jg, pat, hw=jhw, interpret=True)
    tem = tcodegen.emit_pattern(tg, pat, hw=thw)
    assert tem.ext_ids == jem.ext_ids and tem.out_ids == jem.out_ids
    jvals = [args[jg.inputs.index(i)] for i in jem.ext_ids]
    jout = jem.fn(*jvals)
    tout = tem.fn("cpu", *[torch.from_numpy(v) for v in jvals])
    return jg, tg, pat, jem, tem, jout, tout


def _assert_close(jout, tout, rtol=1e-5, atol=1e-5):
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                                   atol=atol)


def _role_args(R, C):
    return [rng.standard_normal((R, C)).astype(np.float32),
            rng.standard_normal((R, 1)).astype(np.float32),
            rng.standard_normal(C).astype(np.float32),
            np.asarray(rng.standard_normal(), np.float32)]


def test_onepass_roles_and_ragged_rows():
    R, C = 37, 200   # 37 rows: not a multiple of any block size
    jg, tg, pat, jem, tem, jout, tout = _emit_both(
        j_roles, t_roles, _role_args(R, C), jcost.V5E, tcost.V5E)
    assert jem.estimate.schedule == tem.kind == "onepass"
    kern = tem.fn
    assert isinstance(kern, tcodegen.OnePassKernel)
    assert R % max(1, jem.estimate.block_rows) != 0 or R % kern.BR != 0
    info = analyze(tg, pat)
    assert {info.role(o) for o in tem.out_ids} == set(Role)
    assert {info.role(i) for i in tem.ext_ids} == set(Role)
    _assert_close(jout, tout)


def test_streaming_roles_ragged_rows_and_tail_tile():
    R, C = 37, 2500  # 2500 = 4 x 512 + a ragged 452-wide tail tile
    small = dict(vmem_bytes=192 * 1024)  # one-pass no longer fits
    jg, tg, pat, jem, tem, jout, tout = _emit_both(
        j_roles, t_roles, _role_args(R, C), jcost.Hardware(**small),
        tcost.Hardware(**small))
    assert jem.estimate.schedule == tem.kind == "streaming"
    kern = tem.fn
    assert isinstance(kern, tcodegen.StreamingKernel)
    assert C % kern.BC != 0 and R % kern.BR != 0
    assert kern.phases == 2
    _assert_close(jout, tout)


def test_streaming_layernorm_three_phases():
    x = rng.standard_normal((4, 2048)).astype(np.float32)
    g = rng.standard_normal(2048).astype(np.float32)
    b = rng.standard_normal(2048).astype(np.float32)
    small = dict(vmem_bytes=96 * 1024)
    _, _, _, jem, tem, jout, tout = _emit_both(
        j_ln, t_ln, [x, g, b], jcost.Hardware(**small),
        tcost.Hardware(**small))
    assert jem.estimate.schedule == tem.kind == "streaming"
    assert tem.fn.phases == 3
    # three tiled passes vs whole-row sums: rtol 1e-4 (float32 LN of
    # unit-normal rows amplifies the summation-order difference by rstd)
    _assert_close(jout, tout, rtol=1e-4, atol=1e-4)


def test_onepass_recompute_flip_matches_reference():
    x = rng.standard_normal((64, 512)).astype(np.float32)
    g = (np.abs(rng.standard_normal(512)) + 0.5).astype(np.float32)
    tight = dict(vmem_bytes=32 * 1024)
    _, _, _, jem, tem, jout, tout = _emit_both(
        j_fanout, t_fanout, [x, g], jcost.Hardware(**tight),
        tcost.Hardware(**tight))
    assert jem.estimate.schedule == tem.kind == "onepass"
    assert tem.n_recomputed == jem.n_recomputed > 0
    assert tem.fn.recompute == frozenset(jem.estimate.recompute_ids)
    # tanh and long product chains: rtol 1e-4
    _assert_close(jout, tout, rtol=1e-4, atol=1e-4)


def test_generated_sources_cover_every_role():
    """The Triton source the card compiles: one program per BR rows, masked
    loads/stores, reductions with identity-filled lanes, ROW/COL/SCALAR
    broadcasting, a COL output written by program 0 only."""
    R, C = 37, 200
    args = [torch.from_numpy(a) for a in _role_args(R, C)]
    tg = ttrace(t_roles, *args)
    pat = frozenset(tg.fusible_nodes())
    one = tcodegen.emit_pattern(tg, pat, hw=tcost.V5E).fn
    src = one.source()
    assert "@triton.jit" in src and "tl.program_id(0)" in src
    assert "tl.sum(tl.where(fmask" in src
    assert "mask=cmask & (pid == 0)" in src          # COL output
    assert "mask=pid == 0" in src                     # SCALAR output
    compile(src, "<generated>", "exec")
    args = [torch.from_numpy(a) for a in _role_args(R, 2500)]
    tg = ttrace(t_roles, *args)
    stream = tcodegen.emit_pattern(tg, frozenset(tg.fusible_nodes()),
                                   hw=tcost.Hardware(vmem_bytes=192 * 1024)).fn
    assert isinstance(stream, tcodegen.StreamingKernel)
    s2 = stream.source()
    assert s2.count("for t in range(0, n_tiles)") == stream.phases
    assert "mask=rmask & (t == 0)" in s2               # ROW output, once
    compile(s2, "<generated>", "exec")


def test_launch_counters_untouched_by_plain_runs():
    args = _role_args(8, 64)
    before = (tcodegen.OnePassKernel.launches,
              tcodegen.StreamingKernel.launches)
    _emit_both(j_roles, t_roles, args, jcost.V5E, tcost.V5E)
    assert (tcodegen.OnePassKernel.launches,
            tcodegen.StreamingKernel.launches) == before


def test_non_cpu_tensors_never_take_the_plain_path():
    """A kernel handed tensors that are not on the CPU launches (CUDA) or
    raises -- here on the meta device it must raise, not run plain."""
    args = [torch.from_numpy(a) for a in _role_args(37, 200)]
    tg = ttrace(t_roles, *args)
    em = tcodegen.emit_pattern(tg, frozenset(tg.fusible_nodes()),
                               hw=tcost.V5E)
    assert em.kind == "onepass"
    meta = [torch.empty(tg.node(i).spec.shape, device="meta")
            for i in em.ext_ids]
    with pytest.raises(ValueError, match="devices"):
        em.fn("cpu", *meta)


def _one_primitive_group(prim):
    """A graph whose one fusible node applies ``prim`` to [4, 8] inputs
    (a reduction also gets the members that give it a row view)."""
    from repro_torch.core.classify import classify
    from repro_torch.core.ir import Graph, Node, OpKind, TensorSpec

    g = Graph()

    def add(p, inputs, out_shape, dtype="float32", **params):
        kind = OpKind.INPUT if p == "input" else classify(p)
        g.add(Node(len(g.nodes), p, kind, tuple(inputs),
                   TensorSpec(out_shape, dtype), params))
        if kind is OpKind.INPUT:
            g.inputs.append(len(g.nodes) - 1)
        return len(g.nodes) - 1

    full = (4, 8)
    x, y = add("input", (), full), add("input", (), full)
    if prim in ("and", "or", "xor", "not"):
        a, b = add("input", (), full, "bool"), add("input", (), full, "bool")
        nid = add(prim, (a,) if prim == "not" else (a, b), full, "bool")
    elif prim == "select_n":
        pred = add("input", (), full, "bool")
        nid = add(prim, (pred, x, y), full)
    elif prim == "clamp":
        nid = add(prim, (y, x, add("input", (), full)), full)
    elif prim in tcodegen._REDUCES:
        # a row view needs a FULL member: x - broadcast(reduce(x))
        r = add(prim, (x,), (4,), axes=(1,))
        b = add("broadcast_in_dim", (r,), full, shape=full,
                broadcast_dimensions=(0,))
        nid = add("sub", (x, b), full)
        g.outputs = [nid]
        return g, frozenset({r, b, nid})
    elif prim == "broadcast_in_dim":
        nid = add(prim, (add("input", (), (4, 1)),), full, shape=full,
                  broadcast_dimensions=(0, 1))
    elif prim == "convert_element_type":
        nid = add(prim, (x,), full, "bfloat16", new_dtype="bfloat16")
    elif prim == "integer_pow":
        nid = add(prim, (x,), full, y=3)
    elif prim in tcodegen._TL_BINARY:
        out = "bool" if prim in ("eq", "ne", "ge", "gt", "le", "lt") \
            else "float32"
        nid = add(prim, (x, y), full, out)
    else:
        nid = add(prim, (x,), full, "bool" if prim == "is_finite"
                  else "float32")
    g.outputs = [nid]
    return g, frozenset({nid})


@pytest.mark.parametrize("prim",
                         sorted(tcodegen.EMITTABLE_PRIMS - {"const"}))
def test_every_emittable_primitive_has_a_lowering(prim):
    """What ``pattern_emittable`` admits, the generator can write: both
    kernels' Triton source for a one-primitive group (no Triton needed)."""
    g, pat = _one_primitive_group(prim)
    info = analyze(g, pat)
    assert tcodegen.pattern_emittable(g, pat, info=info)
    ext = g.pattern_inputs(pat)
    for kern in (tcodegen.OnePassKernel(g, pat, info, ext, g.outputs,
                                        block_rows=2),
                 tcodegen.StreamingKernel(g, pat, info, ext, g.outputs,
                                          block_rows=2, block_cols=4)):
        compile(kern.source(), f"<{prim} {kern.schedule}>", "exec")


@pytest.mark.parametrize("prim", ["expm1", "log1p", "tanh"])
def test_precise_unary_primitives_lower_through_libdevice(prim):
    """``expm1``, ``log1p`` and ``tanh`` are emitted as libdevice calls,
    which keep the relative precision near 0 that ``exp(x) - 1``,
    ``log(1 + x)`` and ``2 sigmoid(2x) - 1`` lose (XLA lowers them
    precisely too)."""
    g, pat = _one_primitive_group(prim)
    info = analyze(g, pat)
    ext = g.pattern_inputs(pat)
    for kern in (tcodegen.OnePassKernel(g, pat, info, ext, g.outputs,
                                        block_rows=2),
                 tcodegen.StreamingKernel(g, pat, info, ext, g.outputs,
                                          block_rows=2, block_cols=4)):
        src = kern.source()
        assert "from triton.language.extra import libdevice" in src
        assert f"libdevice.{prim}(" in src
        for imprecise in ("tl.exp(", "tl.log(", "tl.sigmoid("):
            assert imprecise not in src


@pytest.mark.parametrize("prim", ["tan", "atan"])
def test_unlowered_primitives_run_packed(prim):
    """A primitive outside the generator's vocabulary (``tan``, ``atan``:
    outside the reference's too) runs its group packed, never as a
    generated kernel that would fail at its first launch on the card.
    ``pow`` and ``atan2``, which this test held to the packed path before
    the generator lowered them, now emit kernels
    (``test_pow_and_atan2_lower_to_generated_kernels``)."""
    from repro_torch.core.classify import classify
    from repro_torch.core.ir import Graph, Node, OpKind, TensorSpec

    g = Graph()
    g.add(Node(0, "input", OpKind.INPUT, (), TensorSpec((4, 8), "float32"),
               {}))
    g.inputs.append(0)
    g.add(Node(1, prim, classify(prim), (0,), TensorSpec((4, 8), "float32"),
               {"_fn": lambda dev, x: getattr(torch, prim)(x)}))
    g.outputs = [1]
    assert prim not in tcodegen.EMITTABLE_PRIMS | jcodegen.EMITTABLE_PRIMS
    em = tcodegen.emit_pattern(g, frozenset({1}), hw=tcost.H100)
    assert em.kind == "packed"
    x = torch.randn(4, 8)
    torch.testing.assert_close(em.fn("cpu", x)[0], getattr(torch, prim)(x))


@pytest.mark.parametrize("name", ["pow", "atan2"])
def test_pow_and_atan2_lower_to_generated_kernels(name):
    """The tracer emits ``pow`` (a non-integer exponent) and ``atan2``;
    the generator lowers both (libdevice), so their group is a generated
    kernel whose plain version computes the function."""
    fns = {"pow": lambda x, y: x.abs() ** 0.5 * x.sum(-1, keepdim=True),
           "atan2": lambda x, y: torch.atan2(x, y) * x.sum(-1, keepdim=True)}
    fn = fns[name]
    x, y = torch.randn(16, 64), torch.randn(16, 64)
    tg = ttrace(fn, x, y)
    assert name in {n.prim for n in tg.nodes.values()}
    em = tcodegen.emit_pattern(tg, frozenset(tg.fusible_nodes()),
                               hw=tcost.H100)
    assert em.kind == "onepass"
    assert f"libdevice.{name}(" in em.fn.source()
    from repro_torch.core import stitched_jit
    # the same torch ops in the same order: float32 default tolerances
    torch.testing.assert_close(stitched_jit(fn, device="cpu")(x, y),
                               fn(x, y))


@pytest.mark.parametrize("shape", [(37, 200), (64, 3072), (16, 8192),
                                   (4, 20000)])
def test_planned_block_is_the_launched_block(shape):
    """The H100 preset's register cap decides the block: the kernel
    launches the plan's rows, and its block fits the cap."""
    x = torch.randn(*shape)
    tg = ttrace(lambda v: torch.softmax(v, -1), x)
    em = tcodegen.emit_pattern(tg, frozenset(tg.fusible_nodes()),
                               hw=tcost.H100)
    assert em.generated
    kern = em.fn
    width = kern.BLOCK_C if em.kind == "onepass" else kern.BC
    assert kern.BR == tcost.next_pow2(em.estimate.block_rows)
    assert kern.BR * width <= tcost.H100.max_block_elems
    assert em.kind == ("streaming" if shape[1] > 8192 else "onepass")
