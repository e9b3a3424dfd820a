"""Emitter parity: the port's generated-kernel plain versions (the row-view
evaluators of ``OnePassKernel`` and ``StreamingKernel``) against the JAX
package's Pallas emitters (interpret mode) on the same traced function.

Both packages are given the same hardware preset, so they pick the same
schedule; a small-budget ``Hardware(vmem_bytes=...)`` forces streaming in
both.  Tolerances: float32 with another summation order (whole-row vs
tiled partial sums), rtol 1e-5 / atol 1e-5 unless stated.

The streaming kernel's generated CUDA C++ is built for the host with g++
(``_host_build``) and its host form held to the plain row-view
evaluator; the one-pass kernel's Triton source compiles as Python.
"""
import dataclasses

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
from _host_build import gxx  # noqa: E402

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


def test_generated_sources_cover_every_role(tmp_path):
    """The sources the card compiles.  One-pass (Triton): one program per
    BR rows, masked loads/stores, reductions with identity-filled lanes,
    ROW/COL/SCALAR broadcasting, a COL output written by program 0 only.
    Streaming (CUDA C++): one branch a phase, the ROW output stored once
    a row and the COL output once; built with g++, its host form matches
    the plain row-view evaluator."""
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
    em = tcodegen.emit_pattern(tg, frozenset(tg.fusible_nodes()),
                               hw=tcost.Hardware(vmem_bytes=192 * 1024))
    stream = em.fn
    assert isinstance(stream, tcodegen.StreamingKernel)
    s2 = stream.source()
    assert "triton" not in s2 and '#include "streaming.cuh"' in s2
    assert s2.count("constexpr (P == ") == stream.phases
    assert "if (c == 0)" in s2                         # ROW output, once
    assert "if (r == 0)" in s2                         # COL output, once
    vals = [args[tg.inputs.index(i)] for i in em.ext_ids]
    got = stream.host(gxx(tmp_path, s2, "roles"), *vals)
    for g, w in zip(got, stream("cpu", *vals)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def _scalar_output_group():
    """One streaming group with a FULL, a ROW, a COL and a SCALAR output
    (x - max(x), max(x), 2 colb, 3 s), built in the IR."""
    from repro_torch.core.classify import classify
    from repro_torch.core.ir import Graph, Node, OpKind, TensorSpec
    from repro_torch.core.tracer import make_fn

    R, C = 5, 300
    g = Graph()

    def add(prim, ins, out_shape, value=None, **params):
        kind = (OpKind.INPUT if prim == "input" else
                OpKind.CONST if prim == "const" else classify(prim))
        spec = TensorSpec(out_shape, "float32")
        if kind not in (OpKind.INPUT, OpKind.CONST):
            params["_fn"] = make_fn(prim, params, spec)
        nid = len(g.nodes)
        g.add(Node(nid, prim, kind, tuple(ins), spec, params, value))
        if kind is OpKind.INPUT:
            g.inputs.append(nid)
        return nid

    x, colb, s = add("input", (), (R, C)), add("input", (), (C,)), \
        add("input", (), ())
    mx = add("reduce_max", (x,), (R,), axes=(1,))
    full = add("sub", (x, add("broadcast_in_dim", (mx,), (R, C), shape=(R, C),
                              broadcast_dimensions=(0,))), (R, C))
    col = add("mul", (colb, add("const", (), (), value=2.0)), (C,))
    scal = add("mul", (s, add("const", (), (), value=3.0)), ())
    g.outputs = [full, mx, col, scal]
    members = frozenset(n for n in g.nodes
                        if g.node(n).kind not in (OpKind.INPUT, OpKind.CONST))
    return g, members


def test_streaming_row_col_and_scalar_outputs_on_the_host(tmp_path):
    """Every output role of a streaming group, written once by the
    generated C++ (ROW at column 0, COL at row 0, SCALAR at (0, 0)), as
    the plain version writes it."""
    g, pat = _scalar_output_group()
    info = analyze(g, pat)
    assert {info.role(o) for o in g.outputs} == set(Role)
    ext = g.pattern_inputs(pat)
    kern = tcodegen.StreamingKernel(g, pat, info, ext, g.outputs,
                                    block_rows=2, block_cols=128)
    vals = [torch.randn(g.node(i).spec.shape) for i in ext]
    got = kern.host(gxx(tmp_path, kern.source(), "outputs"), *vals)
    want = kern("cpu", *vals)
    assert [tuple(t.shape) for t in got] == [(5, 300), (5,), (300,), ()]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_streaming_cluster_geometry():
    """The row split: a cluster owns one row, split across the fewest CTAs
    whose slices fit the stage (up to a cluster of eight), slices a
    multiple of 16 columns, the last CTA's slice ragged where the row is
    no multiple of the slice; a row longer than eight stages holds stages
    what fits."""
    def kern(R, C, dtype=torch.float32, block_rows=8):
        tg = ttrace(lambda v: torch.softmax(v, -1),
                    torch.zeros(R, C, dtype=dtype))
        pat = frozenset(tg.fusible_nodes())
        return tcodegen.StreamingKernel(
            tg, pat, analyze(tg, pat), tg.pattern_inputs(pat), tg.outputs,
            block_rows=block_rows, block_cols=2048)

    assert kern(2048, 128256).cluster() == (8, 16032, 16032)
    assert kern(64, 600000).cluster() == (8, 75008, 16384)
    assert kern(37, 2500).cluster() == (1, 2512, 2512)
    # 100003 columns: seven slices of 12512 and a ragged last one of 12419
    K, width, staged = kern(37, 100003).cluster()
    assert (K, width, staged) == (8, 12512, 12512)
    assert 0 < 100003 - (K - 1) * width < width
    # bfloat16 rows stage two bytes a column
    assert kern(8, 40000, torch.bfloat16).cluster() == (2, 20000, 20000)


def test_streaming_launch_takes_cuda_tensors_only():
    """The streaming kernel has one route: its launch refuses tensors not
    on a CUDA card (it never runs the plain version), and the group is
    no Triton source."""
    tg = ttrace(lambda v: torch.softmax(v, -1), torch.zeros(4, 20000))
    em = tcodegen.emit_pattern(tg, frozenset(tg.fusible_nodes()),
                               hw=tcost.H100)
    assert em.kind == "streaming"
    assert "triton" not in em.fn.source()
    with pytest.raises(ValueError, match="CUDA"):
        em.fn.launch(torch.randn(4, 20000))
    meta = torch.empty(4, 20000, device="meta")
    with pytest.raises(ValueError, match="devices"):
        em.fn("cpu", meta)


def test_bf16_streaming_group_on_the_host(tmp_path):
    """A bfloat16 streaming group (RMSNorm in, float32 inside, bfloat16
    out) built with g++: its float32-output twin against the plain
    version, each element within 1e-5 |plain| + 1e-5 mean|plain| (sums in
    another order), and the bfloat16 output that twin's result rounded to
    nearest even, bit for bit (same sums, one last rounding)."""
    def rms_f32(x, g):
        xf = x.float()
        return xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + 1e-6) * g

    def rms(x, g):
        return rms_f32(x, g).to(x.dtype)

    r = np.random.default_rng(7)
    x = torch.from_numpy(r.standard_normal((9, 3000)).astype(np.float32))
    gm = torch.from_numpy(r.standard_normal(3000).astype(np.float32))
    got = {}
    for name, fn in (("f32", rms_f32), ("bf16", rms)):
        tg = ttrace(fn, x.bfloat16(), gm)
        # a 2048-element register cap: a 3000-wide row no longer fits one
        # pass
        em = tcodegen.emit_pattern(
            tg, frozenset(tg.fusible_nodes()),
            hw=dataclasses.replace(tcost.H100, max_block_elems=2048))
        assert em.kind == "streaming"
        kern = em.fn
        assert "repro_chain::from_bf16" in kern.source()
        vals = [x.bfloat16(), gm][:len(em.ext_ids)]
        got[name] = kern.host(gxx(tmp_path, kern.source(), name), *vals)[0]
        if name == "f32":
            want = kern("cpu", *vals)[0]
            assert got[name].dtype == want.dtype == torch.float32
            limit = 1e-5 * want.abs() + 1e-5 * float(want.abs().mean())
            assert bool(((got[name] - want).abs() <= limit).all())
        else:
            assert "repro_chain::round_bf16" in kern.source()
    assert got["bf16"].dtype == torch.bfloat16
    assert torch.equal(got["bf16"], got["f32"].to(torch.bfloat16))


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
    from repro_torch.core.tracer import make_fn

    g = Graph()

    def add(p, inputs, out_shape, dtype="float32", **params):
        kind = OpKind.INPUT if p == "input" else classify(p)
        spec = TensorSpec(out_shape, dtype)
        if p == "clamp":  # lax.clamp(lo, x, hi); the tracer emits none
            params["_fn"] = lambda dev, lo, x, hi: torch.minimum(
                torch.maximum(x, lo), hi)
        elif kind is not OpKind.INPUT and p not in tcodegen._PASS:
            params["_fn"] = make_fn(p, params, spec)
        g.add(Node(len(g.nodes), p, kind, tuple(inputs), spec, params))
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


def _group_inputs(g, ext):
    vals = []
    for i in ext:
        spec = g.node(i).spec
        if spec.dtype == "bool":
            vals.append(torch.from_numpy(rng.standard_normal(spec.shape) > 0))
        else:
            vals.append(torch.from_numpy(
                rng.standard_normal(spec.shape).astype(np.float32)))
    return vals


@pytest.mark.parametrize("prim",
                         sorted(tcodegen.EMITTABLE_PRIMS - {"const"}))
def test_every_emittable_primitive_has_a_lowering(tmp_path, prim):
    """What ``pattern_emittable`` admits, the generators can write: the
    one-pass kernel's Triton source for a one-primitive group compiles
    (no Triton needed), and the streaming kernel's CUDA C++ builds with
    g++ and its host form computes what the plain version computes."""
    g, pat = _one_primitive_group(prim)
    info = analyze(g, pat)
    assert tcodegen.pattern_emittable(g, pat, info=info)
    ext = g.pattern_inputs(pat)
    one = tcodegen.OnePassKernel(g, pat, info, ext, g.outputs, block_rows=2)
    compile(one.source(), f"<{prim} onepass>", "exec")
    stream = tcodegen.StreamingKernel(g, pat, info, ext, g.outputs,
                                      block_rows=2, block_cols=4)
    vals = _group_inputs(g, ext)
    got = stream.host(gxx(tmp_path, stream.source(), "prim"), *vals)[0]
    want = stream("cpu", *vals)[0]
    assert got.dtype == want.dtype
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6,
                               equal_nan=True)


@pytest.mark.parametrize("prim", ["expm1", "log1p", "tanh"])
def test_precise_unary_primitives_lower_through_libdevice(tmp_path, prim):
    """``expm1``, ``log1p`` and ``tanh`` are emitted as libdevice calls in
    the one-pass kernel and as ``expm1f``, ``log1pf``, ``tanhf`` in the
    streaming kernel's C++, which keep the relative precision near 0 that
    ``exp(x) - 1``, ``log(1 + x)`` and ``2 sigmoid(2x) - 1`` lose (XLA
    lowers them precisely too): the host form holds 1e-6 relative at
    |x| <= 1e-4."""
    g, pat = _one_primitive_group(prim)
    info = analyze(g, pat)
    ext = g.pattern_inputs(pat)
    src = tcodegen.OnePassKernel(g, pat, info, ext, g.outputs,
                                 block_rows=2).source()
    assert "from triton.language.extra import libdevice" in src
    assert f"libdevice.{prim}(" in src
    for imprecise in ("tl.exp(", "tl.log(", "tl.sigmoid("):
        assert imprecise not in src
    stream = tcodegen.StreamingKernel(g, pat, info, ext, g.outputs,
                                      block_rows=2, block_cols=4)
    assert f"{prim}f(" in stream.source()
    x = (torch.rand(4, 8) * 2 - 1) * 1e-4
    got = stream.host(gxx(tmp_path, stream.source(), prim), x)[0]
    torch.testing.assert_close(got, getattr(torch, prim)(x), rtol=1e-6,
                               atol=0)


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
