"""Compute-anchored stitching in the PyTorch port, against the JAX package.

Anchoring is on by default in both packages (``REPRO_ANCHOR``).  The same
inputs, made with numpy from a seed, go through the reference (Pallas in
interpret mode) and the port (plain versions on the CPU):

* B3's plain version (``kernels.matmul.matmul_fused``) against the
  reference's ``matmul_fused`` with prologue operands in all four roles;
* the tracer's rank-4 ``dot_general`` for ``q @ k^T`` and ``p @ v``;
* ``anchor_interface_bytes``, ``anchor_gain`` and ``anchor_emittable``;
* the ``V5E`` plans of the reduced Llama block, the two blocks of
  ``benchmarks/bench_anchor_fusion.py`` and the full-width block, and
  ``stitched_jit``'s outputs;
* the ``H100`` gate (the CUDA instances' own constants);
* the generated CUDA C++ chains, built for the host with g++ and held to
  the plain row-view evaluator.
"""
import ctypes
import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import codegen as jcodegen  # noqa: E402
from repro.core import cost_model as jcost  # noqa: E402
from repro.kernels.matmul import matmul_fused as jmatmul_fused  # noqa: E402
from repro.models.layers import FusionMode  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.model import block_apply as jblock_apply  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import codegen as tcodegen  # noqa: E402
from repro_torch.core import cost_model as tcost  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import matmul as MM  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.layers import XLA  # noqa: E402
from repro_torch.models.layers import FusionMode as TFusionMode  # noqa: E402
from repro_torch.models.model import block_apply, block_init  # noqa: E402
from _host_build import gxx, ptrs  # noqa: E402

rng = np.random.default_rng(23)
CSRC = MM.__file__.rsplit("/", 2)[0] + "/csrc"


# ---------------------------------------------------------------------------
# the probe graphs: bench_anchor_fusion's two blocks, written in both
# ---------------------------------------------------------------------------
def j_mlp(x, w1, w2, r, g):
    h = (x * g + 1.0) @ w1
    h = jax.nn.gelu(h, approximate=True) @ w2
    return jnp.tanh(h) + r


def t_mlp(x, w1, w2, r, g):
    h = (x * g + 1.0) @ w1
    # jax.nn.gelu(approximate=True), op for op
    h = h * (0.5 * (1.0 + torch.tanh(
        0.7978845608028654 * (h + 0.044715 * h ** 3))))
    h = h @ w2
    return torch.tanh(h) + r


def j_attn(q, k, v, bias):
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * 0.125 + bias
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhqk,bhkd->bhqd", p, v)


def t_attn(q, k, v, bias):
    s = q @ k.transpose(-1, -2) * 0.125 + bias
    return torch.softmax(s, -1) @ v


def t_attn_einsum(q, k, v, bias):
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 0.125 + bias
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)


def _mlp_args(M=128, K=256, N=256):
    return [rng.standard_normal(s).astype(np.float32)
            for s in [(M, K), (K, N), (N, K), (M, K), (K,)]]


def _attn_args(B=2, H=4, S=128, D=64):
    return [rng.standard_normal(s).astype(np.float32)
            for s in [(B, H, S, D)] * 3 + [(1, 1, S, S)]]


def _t(args):
    return [torch.from_numpy(a) for a in args]


def _block_setup():
    jcfg = jget_config("llama3.2-3b").reduced()
    cfg = get_config("llama3.2-3b").reduced()
    jparams = JModel(jcfg, fusion_mode="xla").init(jax.random.PRNGKey(3))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    B, S = 2, 16
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jlayer = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"])

    def jfn(p, hh, pos):
        return jblock_apply(jcfg, p, hh, fm=FusionMode("xla"),
                            positions=pos)[0]

    return (jfn, (jlayer, jnp.asarray(h), jnp.arange(S)),
            functools.partial(block_apply, cfg, fm=XLA),
            (tparams["blocks"][0], torch.from_numpy(h), torch.arange(S)))


def _probes():
    """(name, jax fn, jax args, torch fn, torch args) of the three graphs."""
    jfn, ja, tfn, ta = _block_setup()
    mlp, attn = _mlp_args(), _attn_args()
    return [("block", jfn, ja, tfn, ta),
            ("mlp", j_mlp, mlp, t_mlp, _t(mlp)),
            ("attn", j_attn, attn, t_attn, _t(attn))]


@pytest.fixture
def anchoring_on(monkeypatch):
    monkeypatch.delenv("REPRO_ANCHOR", raising=False)


# ---------------------------------------------------------------------------
# B3's plain version against the reference's matmul_fused
# ---------------------------------------------------------------------------
def test_b3_plain_matches_the_reference_kernel():
    """M 200 (ragged against the reference's block_m 128), K 96, N 160;
    prologue operands in the roles full/row/col/scalar, a two-output
    epilogue (full and row operands).  float32 sums over K = 96 in
    another order: rtol 1e-5."""
    M, K, N = 200, 96, 160
    full, row = rng.standard_normal((M, K)), rng.standard_normal((M, 1))
    col, sc = rng.standard_normal((1, K)), rng.standard_normal(())
    rhs = rng.standard_normal((K, N))
    e_full, e_row = rng.standard_normal((M, N)), rng.standard_normal((M, 1))
    vals = [np.asarray(v, np.float32)
            for v in (full, row, col, sc, rhs, e_full, e_row)]
    roles = dict(pro_roles=["full", "row", "col", "scalar"],
                 epi_roles=["full", "row"], out_roles=["full", "full"])

    def jpro(f, r, c, s):
        return f * c + r * s

    def jepi(acc, ef, er):
        return jnp.tanh(acc) + ef, acc * er

    want = jmatmul_fused(
        [jnp.asarray(v) for v in vals[:4]], jnp.asarray(vals[4]),
        [jnp.asarray(v) for v in vals[5:]], M=M, K=K, N=N,
        out_dtypes=[jnp.float32] * 2, prologue=jpro, epilogue=jepi,
        interpret=True, **roles)
    t = [torch.from_numpy(v) for v in vals]
    got = MM.matmul_fused(
        t[:4], t[4], t[5:], M=M, K=K, N=N, out_dtypes=[torch.float32] * 2,
        prologue=lambda f, r, c, s: f * c + r * s,
        epilogue=lambda acc, ef, er: (torch.tanh(acc) + ef, acc * er),
        **roles)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def test_b3_wrapper_never_runs_plain_on_other_devices():
    meta = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="CPU"):
        MM.matmul_fused([meta], torch.empty(8, 8, device="meta"), [],
                        M=4, K=8, N=8, pro_roles=["full"], epi_roles=[],
                        out_roles=["full"], out_dtypes=[torch.float32])


@pytest.mark.parametrize("tile", MM.TILES,
                         ids=["large", "small", "row", "decode"])
def test_tiles_cover_the_template(tile):
    """Each instance meets the template's static asserts: whole
    warpgroups of 64 rows, a ``wgmma`` width (32 or 128) a consumer,
    k8 steps, the producer's 4-float tasks spread evenly over its 128
    threads; a ring of at least two stages within one block's shared
    memory, a partial sum held by at most ``stages`` operand stages; and
    ``pick_tile`` picks by (M, N, row_reduce) alone."""
    t = tile
    assert t.bm % 64 == 0 and t.bn % (8 * t.wn) == 0 and t.bn % 32 == 0
    assert t.bn // t.wn in (32, 128) and t.bk % 8 == 0
    assert t.am == t.bm or (t.am == 8 and t.bm == 64 and t.wn == 1)
    assert (t.bn * t.bk // 4) % 128 == 0
    assert t.stages >= t.promote and t.producers in (1, 2)
    assert t.raw_stages % t.producers == 0
    assert t.raw_stages // t.producers >= 2
    assert t.threads == 128 * (t.consumers + t.producers) <= 1024
    assert t.smem_bytes <= tcost.H100.vmem_bytes
    assert MM.pick_tile(4, 8192, False) == MM.TILES.index(MM.TILE_DECODE)
    assert MM.pick_tile(9, 8192, False) == MM.TILES.index(MM.TILE_SMALL)
    assert MM.pick_tile(128, 256, False) == MM.TILES.index(MM.TILE_SMALL)
    assert MM.pick_tile(2048, 8192, False) == MM.TILES.index(MM.TILE_LARGE)
    assert MM.pick_tile(2000, 8192, False) == MM.TILES.index(MM.TILE_LARGE)
    assert MM.pick_tile(4, 256, True) == MM.TILES.index(MM.TILE_ROW)


# ---------------------------------------------------------------------------
# the tracer: rank-4 dot_generals, as the reference's einsum traces
# ---------------------------------------------------------------------------
def _sequence(graph):
    return [(n.prim, n.spec.shape, n.spec.dtype, n.inputs)
            for n in graph.nodes.values()]


def _dns(graph):
    return [tuple(map(tuple, map(lambda x: tuple(map(tuple, x)),
                                 n.params["dimension_numbers"])))
            for n in graph.nodes.values() if n.prim == "dot_general"]


def _jdns(graph):
    return [tuple(map(tuple, map(lambda x: tuple(map(tuple, x)),
                                 n.params["_raw_params"]["dimension_numbers"])))
            for n in graph.nodes.values() if n.prim == "dot_general"]


@pytest.mark.parametrize("form", ["matmul", "einsum"])
def test_batched_products_trace_to_rank4_dot_generals(form):
    q, k, v, bias = _attn_args(S=32, D=16)
    jscore = jcore.trace(lambda q, k, b: jnp.einsum(
        "bhqd,bhkd->bhqk", q, k) * 0.125 + b, q, k, bias)
    jpv = jcore.trace(lambda p, v: jnp.einsum("bhqk,bhkd->bhqd", p, v),
                      np.ones((2, 4, 32, 32), np.float32), v)
    if form == "matmul":
        tscore = tcore.trace(lambda q, k, b: q @ k.transpose(-1, -2) * 0.125
                             + b, *_t([q, k, bias]))
        tpv = tcore.trace(lambda p, v: p @ v, torch.ones(2, 4, 32, 32),
                          torch.from_numpy(v))
    else:
        tscore = tcore.trace(lambda q, k, b: torch.einsum(
            "bhqd,bhkd->bhqk", q, k) * 0.125 + b, *_t([q, k, bias]))
        tpv = tcore.trace(lambda p, v: torch.einsum("bhqk,bhkd->bhqd", p, v),
                          torch.ones(2, 4, 32, 32), torch.from_numpy(v))
    for tg, jg in ((tscore, jscore), (tpv, jpv)):
        assert _sequence(tg) == _sequence(jg)
        assert _dns(tg) == _jdns(jg)
    assert _dns(tscore) == [(((3,), (3,)), ((0, 1), (0, 1)))]
    assert _dns(tpv) == [(((3,), (2,)), ((0, 1), (0, 1)))]


def test_grouped_attention_keeps_its_rank3_products():
    """``ref.attention`` folds the query heads of a KV head into the rows
    of a rank-3 product: those views are no batch flatten, so the
    products stay rank 3 and the block plans as before."""
    from repro_torch.kernels import ref

    q, k = torch.randn(2, 8, 16, 32), torch.randn(2, 2, 16, 32)
    g = tcore.trace(lambda q, k, v: ref.attention(q, k, v), q, k, k)
    assert [len(n.spec.shape) for n in g.nodes.values()
            if n.prim == "dot_general"] == [3, 3]


# ---------------------------------------------------------------------------
# the cost model and the matchers, against the reference
# ---------------------------------------------------------------------------
def _anchored(compiled):
    return [(grp, em) for grp, em in zip(compiled.report.groups,
                                          compiled.emitted)
            if em.kind in ("anchored", "pallas")
            and em.estimate.schedule == "anchored"]


def _anchor_figures(graph, groups, cost, emittable, hw):
    out = []
    for g in groups:
        if not g.anchors:
            continue
        folded = tuple(frozenset(x for p in sub for x in p)
                       for sub in g.unanchored
                       if frozenset(x for p in sub for x in p)
                       - frozenset(g.anchors))
        gain = cost.anchor_gain(graph, g.anchors, folded, hw)
        out.append((emittable(graph, g.parts, g.anchors),
                    cost.anchor_interface_bytes(graph, g.anchors, folded),
                    gain.hbm_bytes_saved, gain.vmem_bytes, gain.feasible,
                    gain.latency_gain_s))
    return out


def _groups(core, graph, hw):
    ctx = core.CostContext(graph, hw)
    plan = core.make_plan(graph, hw, ctx=ctx)
    return core.search_groups(graph, plan, hw, ctx=ctx).groups


@pytest.mark.parametrize("name", ["block", "mlp", "attn"])
def test_anchor_pricing_matches_the_reference(anchoring_on, name):
    _, jfn, ja, tfn, ta = next(p for p in _probes() if p[0] == name)
    jg, tg = jcore.trace(jfn, *ja), tcore.trace(tfn, *ta)
    jf = _anchor_figures(jg, _groups(jcore, jg, jcore.V5E), jcost,
                         jcodegen.anchor_emittable, jcore.V5E)
    tf = _anchor_figures(tg, _groups(tcore, tg, tcore.V5E), tcost,
                         tcodegen.anchor_emittable, tcore.V5E)
    assert len(tf) == len(jf) >= 1
    for t, j in zip(tf, jf):
        assert t[:5] == j[:5]
        assert t[5] == pytest.approx(j[5], rel=1e-12)
        assert t[0] is True and t[4] is True


def test_anchor_switch_reads_the_reference_variable(monkeypatch):
    monkeypatch.delenv("REPRO_ANCHOR", raising=False)
    assert tcost.anchor_enabled()
    for off in ("0", "off", "false", "OFF"):
        monkeypatch.setenv("REPRO_ANCHOR", off)
        assert not tcost.anchor_enabled()
    monkeypatch.setenv("REPRO_ANCHOR", "1")
    assert tcost.anchor_enabled()


# ---------------------------------------------------------------------------
# V5E plans and outputs, as the reference's
# ---------------------------------------------------------------------------
def test_reduced_block_anchors_the_gate_projection(anchoring_on):
    jfn, ja, tfn, ta = _block_setup()
    jc = jcore.stitched_jit(jfn, hw=jcore.V5E).compiled(*ja)
    tc = tcore.stitched_jit(tfn, hw=tcore.V5E, device="cpu").compiled(*ta)
    assert tc.report.n_groups == jc.report.n_groups == 8
    assert tc.report.n_anchored == jc.report.n_anchored == 1
    grp = tc.report.groups[-1]
    assert tc.report.schedules[-1] == "anchored"
    assert [sorted(tc.graph.node(n).prim for n in p) for p in grp] == [
        ["dot_general"], ["logistic", "mul", "mul"]]
    assert tc.report.stitched_hbm_bytes_saved == \
        jc.report.stitched_hbm_bytes_saved
    assert tc.report.stats.n_kernels_stitched == \
        jc.report.stats.n_kernels_stitched
    assert tc.report.n_generated + tc.report.n_anchored == jc.report.n_pallas


@pytest.mark.parametrize("name,anchored,launches,memory_only", [
    ("mlp", 2, 2, 5), ("attn", 1, 1, 3)])
def test_bench_blocks_plan_as_the_reference(monkeypatch, name, anchored,
                                            launches, memory_only):
    _, jfn, ja, tfn, ta = next(p for p in _probes() if p[0] == name)
    reports = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("REPRO_ANCHOR", flag)
        reports[flag] = (
            jcore.stitched_jit(jfn, hw=jcore.V5E).report(*ja),
            tcore.stitched_jit(tfn, hw=tcore.V5E, device="cpu").report(*ta))
    (jon, ton), (joff, toff) = reports["1"], reports["0"]
    assert ton.n_anchored == jon.n_anchored == anchored
    assert toff.n_anchored == joff.n_anchored == 0
    assert ton.stats.n_kernels_stitched == jon.stats.n_kernels_stitched \
        == launches
    assert toff.stats.n_kernels_stitched == joff.stats.n_kernels_stitched \
        == memory_only
    assert ton.stitched_hbm_bytes_saved == jon.stitched_hbm_bytes_saved
    assert toff.stitched_hbm_bytes_saved == joff.stitched_hbm_bytes_saved
    assert ton.stitched_hbm_bytes_saved > toff.stitched_hbm_bytes_saved


def test_einsum_attention_plans_as_the_matmul_form(anchoring_on):
    args = _t(_attn_args())
    a = tcore.stitched_jit(t_attn, hw=tcore.V5E, device="cpu").report(*args)
    b = tcore.stitched_jit(t_attn_einsum, hw=tcore.V5E,
                           device="cpu").report(*args)
    assert a.n_anchored == b.n_anchored == 1
    assert a.stitched_hbm_bytes_saved == b.stitched_hbm_bytes_saved


@pytest.mark.parametrize("name", ["block", "mlp", "attn"])
def test_stitched_outputs_match_the_reference(anchoring_on, name):
    """The anchored plan's outputs (plain versions on the CPU) against the
    reference's (Pallas interpret).  The block and the attention block
    agree to 1e-5 relative to their largest value.  The MLP block's two
    unscaled products (values up to ~400) put either package 3-4e-5 from
    the float64 result, so there the two are each held to 1e-4 of it
    and to each other, and the port to its own op-by-op replay at
    1e-6."""
    _, jfn, ja, tfn, ta = next(p for p in _probes() if p[0] == name)
    got = tcore.stitched_jit(tfn, hw=tcore.V5E, device="cpu")(*ta).numpy()
    want = np.asarray(jcore.stitched_jit(jfn, hw=jcore.V5E)(*ja))
    scale = np.abs(want).max()
    if name != "mlp":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
        return
    f64 = t_mlp(*[t.double() for t in ta]).numpy()
    for y in (got, want):
        np.testing.assert_allclose(y, f64, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    replay = tcore.stitched_jit(tfn, hw=tcore.V5E, device="cpu",
                                dispatch="interpret")(*ta).numpy()
    np.testing.assert_allclose(got, replay, rtol=0, atol=1e-6 * scale)


def test_full_width_block_anchors_nothing_under_v5e(anchoring_on):
    """Llama-3.2-3B width (B 4, S 512), traced on abstract shapes: the
    reference's resident-panel gate refuses every fold (the gate
    projection's panel alone is 100 MB against an 8 MB budget), so both
    plan 8 groups, none anchored, with the same stitched bytes."""
    from repro.models.model import Model as JM

    jcfg, cfg = jget_config("llama3.2-3b"), get_config("llama3.2-3b")
    shapes = jax.eval_shape(JM(jcfg, fusion_mode="xla").init,
                            jax.random.PRNGKey(0))
    jlayer = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape[1:], a.dtype),
        shapes["blocks"])
    jg = jcore.trace(
        lambda p, hh, pos: jblock_apply(jcfg, p, hh, fm=FusionMode("xla"),
                                        positions=pos)[0],
        jlayer, jax.ShapeDtypeStruct((4, 512, 3072), jnp.float32),
        jax.ShapeDtypeStruct((512,), jnp.int32))
    tg = tcore.trace(functools.partial(block_apply, cfg, fm=XLA),
                     block_init(cfg, None, torch.float32, "meta"),
                     torch.empty(4, 512, 3072, device="meta"),
                     torch.empty(512, dtype=torch.int64, device="meta"))
    saved = []
    for core, g in ((jcore, jg), (tcore, tg)):
        ctx = core.CostContext(g, core.V5E)
        plan = core.make_plan(g, core.V5E, ctx=ctx)
        groups = core.search_groups(g, plan, core.V5E, ctx=ctx).groups
        assert len(groups) == 8 and not any(x.anchors for x in groups)
        saved.append(sum(ctx.stitch_gain(x.parts).hbm_bytes_saved
                         for x in groups if x.stitched))
    assert saved[0] == saved[1]


def test_isomorphic_anchored_layers_share_emission(anchoring_on):
    w = torch.from_numpy((rng.standard_normal((64, 64)) * 0.05)
                         .astype(np.float32))

    def stack(x, w):
        for _ in range(4):
            x = torch.tanh((x * 2.0 + 1.0) @ w)
        return x

    x = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32))
    for hw in (tcore.V5E, tcore.H100):
        sf = tcore.stitched_jit(stack, hw=hw, device="cpu")
        rep = sf.report(x, w)
        assert rep.n_anchored >= 2 and rep.emission_reused >= 1
        torch.testing.assert_close(sf(x, w), stack(x, w), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the H100 gate
# ---------------------------------------------------------------------------
def _h100_anchored(fn, *args):
    c = tcore.stitched_jit(fn, device="meta").compiled(*args)
    out = []
    for grp, em in zip(c.report.groups, c.emitted):
        if em.kind != "anchored":
            continue
        dots = [n for p in grp for n in p
                if c.graph.node(n).prim == "dot_general"]
        out.append(([(c.graph.node(c.graph.node(d).inputs[0]).spec.shape,
                      c.graph.node(c.graph.node(d).inputs[1]).spec.shape)
                     for d in dots],
                    sorted(c.graph.node(n).prim for p in grp for n in p
                           if c.graph.node(n).prim != "dot_general"),
                    em.scratch_bytes))
    return c.report, out


def test_h100_plans_the_llama_gate_projection_anchored(anchoring_on):
    """At Llama-3.2-3B's full width on meta tensors, the H100 gate (the
    CUDA instance's shared memory, not a resident panel) admits the MLP
    gate projection with its SiLU x up epilogue: in the forward block at
    M 2048 (the large tile) and in serving's decode ``block_post`` at
    M 4 (the decode tile); nothing else of the layer anchors."""
    from repro_torch.models.model import block_post

    cfg = get_config("llama3.2-3b")
    p = block_init(cfg, None, torch.float32, "meta")
    rep, got = _h100_anchored(
        functools.partial(block_apply, cfg, fm=XLA), p,
        torch.empty(4, 512, 3072, device="meta"),
        torch.empty(512, dtype=torch.int64, device="meta"))
    assert rep.n_groups == 8
    assert got == [([((4, 512, 3072), (3072, 8192))],
                    ["logistic", "mul", "mul"], MM.TILE_LARGE.smem_bytes)]
    E = functools.partial(torch.empty, device="meta")
    rep, got = _h100_anchored(
        functools.partial(block_post, cfg, TFusionMode("stitched")), p, E(4, 1, 3072), E(4, 24, 1, 128), E(4, 8, 1024, 128),
        E(4, 8, 1024, 128), torch.empty((), dtype=torch.int64, device="meta"))
    assert got == [([((4, 1, 3072), (3072, 8192))],
                    ["logistic", "mul", "mul"], MM.TILE_DECODE.smem_bytes)]


def _meta_case(name):
    """(fn, args, want) of one piece of a carried model at full width on
    meta tensors, as its path compiles it: ``want`` is the list of
    anchored groups (operand shapes of the product, the folded prims)."""
    from repro_torch.models import layers as TL
    from repro_torch.models.model import (block_post, block_pre,
                                          head_apply, mamba_block,
                                          shared_pre)

    fm = TFusionMode("stitched")
    E = functools.partial(torch.empty, device="meta")
    arch, piece = name.split(":")
    cfg = get_config(arch)
    B, S = 4, 512 if cfg.family != "hybrid" else 500
    pos = torch.empty(S, dtype=torch.int64, device="meta")
    h = E(B, S, cfg.d_model)
    if piece == "mamba":
        p = block_init(cfg, None, torch.float32, "meta")
        c = TL.mamba_cache_init(cfg, B, torch.float32, "meta")
        return (functools.partial(mamba_block, cfg, fm), (p, h, c["conv"],
                                                          c["ssm"]), [])
    if piece == "head":
        p = {"final_norm": TL.norm_init(cfg, torch.float32, "meta"),
             "lm_head": E(cfg.d_model, cfg.padded_vocab)}
        return functools.partial(head_apply, cfg, fm), (p, h), []
    if cfg.family == "hybrid":
        p = {"norm1": {"g": E(2 * cfg.d_model)},
             "attn": TL.attn_init(cfg, None, torch.float32, "meta",
                                  d_in=2 * cfg.d_model),
             "norm2": TL.norm_init(cfg, torch.float32, "meta"),
             "mlp": TL.mlp_init(cfg, None, torch.float32, "meta")}
        x = torch.cat([h, h], -1)
        if piece == "pre":
            return (functools.partial(shared_pre, cfg, fm), (p, h, h, pos),
                    [])
    else:
        p = block_init(cfg, None, torch.float32, "meta")
        x = h
        if piece == "pre":
            return functools.partial(block_pre, cfg, fm), (p, h, pos), []
    q, k, v = TL.attn_qkv(cfg, p["attn"], x, pos)
    want = {"llama3.2-3b": [([((B, S, 3072), (3072, 8192))],
                             ["logistic", "mul", "mul"])],
            "zamba2-1.2b": [([((B, S, 2048), (2048, 8192))],
                             ["add", "add", "integer_pow", "mul", "mul",
                              "mul", "mul", "mul", "tanh"])]}.get(arch, [])
    return functools.partial(block_post, cfg, fm), (p, h, q, k, v), want


H100_PIECES = ["llama3.2-3b:pre", "llama3.2-3b:post", "llama3.2-3b:head",
               "zamba2-1.2b:pre", "zamba2-1.2b:post", "zamba2-1.2b:mamba",
               "granite-moe-1b-a400m:pre", "granite-moe-1b-a400m:post",
               "mamba2-370m:mamba"]


@pytest.mark.parametrize("name", H100_PIECES)
def test_h100_anchoring_decisions_at_the_carried_shapes(anchoring_on, name):
    """The H100 gate's decisions on every path's pieces at full width:
    the MLP gate projection anchored in Llama's layer (SiLU x up) and in
    Zamba2's shared block (GeGLU), each on the large tile; nothing in the
    attention half, the head (its RMSNorm is B6's custom op, and its
    softmax over the vocabulary is wider than a cluster of the row tile
    holds), the MoE layer or the Mamba layers.  Whole-block shared memory as the
    budget admits no more than half of it did."""
    fn, args, want = _meta_case(name)
    rep, got = _h100_anchored(fn, *args)
    assert rep.n_anchored == len(want)
    assert [g[:2] for g in got] == want
    assert all(g[2] == MM.TILE_LARGE.smem_bytes for g in got)


@pytest.mark.parametrize("name,n_b3,n_scored", [("mlp", 2, 0),
                                                ("attn", 0, 1)])
def test_h100_plans_the_bench_blocks_as_two_b3_and_one_score_mod(
        anchoring_on, name, n_b3, n_scored):
    fn, args = {"mlp": (t_mlp, _mlp_args()), "attn": (t_attn,
                                                     _attn_args())}[name]
    c = tcore.stitched_jit(fn, device="cpu").compiled(*_t(args))
    ems = [e for e in c.emitted if e.kind == "anchored"]
    scored = [e for e in ems if getattr(e.fn, "score_mod", None)]
    assert len(ems) - len(scored) == n_b3 and len(scored) == n_scored


def _matmul_then(epilogue, N, K=64, M=32):
    def fn(x, w):
        return epilogue(x @ w)
    return fn, (torch.randn(M, K), torch.randn(K, N))


@pytest.mark.parametrize("N,anchored", [(256, 1), (512, 1), (2048, 1),
                                        (2304, 0)])
def test_h100_gate_refuses_an_epilogue_reduction_wider_than_a_block(
        anchoring_on, N, anchored):
    """A softmax over N after the product: the row tile's blocks along N
    form one thread-block cluster of at most ``MAX_CLUSTER`` (8 x 256 =
    2,048 columns), which exchanges the row partials through distributed
    shared memory, so N 512 and 2048 anchor on the H100 and N 2304, past
    the largest cluster, stays memory-only (the reference's V5E gate
    admits each: it keeps the row in VMEM).  The stitched result is the
    function's either way."""
    assert MM.ROW_MAX_N == 2048
    fn, args = _matmul_then(lambda h: torch.softmax(h, -1), N)
    rep = tcore.stitched_jit(fn, device="cpu").report(*args)
    assert rep.n_anchored == anchored
    v5e = tcore.stitched_jit(fn, hw=tcore.V5E, device="cpu").report(*args)
    assert v5e.n_anchored == 1
    sf = tcore.stitched_jit(fn, device="cpu")
    torch.testing.assert_close(sf(*args), fn(*args), rtol=1e-5, atol=1e-6)


def _rmsnorm_proj(x, w, g):
    xn = x * torch.rsqrt((x ** 2).mean(-1, keepdim=True) + 1e-6) * g
    return xn @ w


def test_h100_gate_refuses_a_prologue_reduction(tmp_path, anchoring_on):
    """An RMSNorm feeding the product: the CUDA kernel first streams the
    block's lhs rows over K for the row statistics, then evaluates the
    prologue on each staged k-tile, so the fold is admitted on the H100
    as under V5E (the reference stages the whole (bm, K) block) where the
    statistics pass reads no more than the fold saves (here two N tiles
    of the small tile: twice the lhs, the interface's round trip).  The
    anchored result is the function's, and the generated ``Pro`` (two
    phases: the sum of squares, then the element), built with g++, is
    the plain chain."""
    args = (torch.randn(32, 64), torch.randn(64, 48), torch.randn(64))
    sf = tcore.stitched_jit(_rmsnorm_proj, device="cpu")
    assert sf.report(*args).n_anchored == 1
    assert tcore.stitched_jit(_rmsnorm_proj, hw=tcore.V5E,
                              device="cpu").report(*args).n_anchored == 1
    torch.testing.assert_close(sf(*args), _rmsnorm_proj(*args), rtol=1e-5,
                               atol=1e-5)
    c = sf.compiled(*args)
    em = next(e for e in c.emitted if e.kind == "anchored")
    assert em.fn.entry.pro_slots == 1 and em.fn.entry.epi_slots == 0
    assert "struct Pro {\n  static constexpr bool kIdentity = false;" \
        in em.fn.entry.source
    assert "static constexpr int kPhases = 2;" in em.fn.entry.source
    _check_matmul_chain(tmp_path, "pro_red", em, c.graph)


@pytest.mark.parametrize("M,K,N,anchored", [
    (2048, 1024, 32, 1),      # Granite's router: one N tile
    (2048, 2048, 64, 1),      # two N tiles: the pass reads what it saves
    (2048, 2048, 128, 0),     # four: more than it saves
    (2048, 3072, 8192, 0),    # Llama's gate projection
    (2048, 3072, 128256, 0)])  # Llama's LM head after the final norm
def test_h100_prices_the_statistics_pass_of_a_reducing_prologue(
        anchoring_on, M, K, N, anchored):
    """B3 reads a reducing prologue's lhs rows again for each N tile
    (``cost_model.prologue_stats_bytes``): the H100 preset folds an
    RMSNorm into a narrow projection, where that pass reads no more than
    the fold saves, and leaves a wide one memory-only (the forward path's
    LM head among them, so its plan is the parent's)."""
    E = functools.partial(torch.empty, device="meta")
    c = tcore.stitched_jit(_rmsnorm_proj, device="meta").compiled(
        E(M, K), E(K, N), E(K))
    assert c.report.n_anchored == anchored
    a = next(n for n in c.graph.nodes if c.graph.node(n).prim
             == "dot_general")
    parts = [frozenset(n for n in c.graph.nodes
                       if c.graph.node(n).kind not in (tcodegen.OpKind.INPUT,
                                                       tcodegen.OpKind.CONST)
                       and n != a)]
    extra = tcost.prologue_stats_bytes(c.graph, (a,), parts)
    tile = MM.TILES[MM.pick_tile(M, N, False)]
    assert extra == M * K * 4 * -(-N // tile.bn)
    saved = tcost.anchor_interface_bytes(c.graph, (a,), parts)
    assert (extra <= saved) == bool(anchored)


def test_h100_keeps_the_forward_heads_plan(anchoring_on):
    """The forward path's head (``fusion_mode="xla"``: the final RMSNorm
    as plain ops, then the LM head and the softmax over the vocabulary)
    at Llama-3.2-3B's full width: no anchored group, as at the parent --
    the norm's fold into the LM head would read the lhs again for each
    of its 1,002 N tiles."""
    from repro_torch.models import layers as TL
    from repro_torch.models.model import head_apply

    cfg = get_config("llama3.2-3b")
    E = functools.partial(torch.empty, device="meta")
    p = {"final_norm": TL.norm_init(cfg, torch.float32, "meta"),
         "lm_head": E(cfg.d_model, cfg.padded_vocab)}
    rep, got = _h100_anchored(functools.partial(head_apply, cfg, XLA), p,
                              E(4, 512, cfg.d_model))
    assert rep.n_anchored == 0 and got == []
    assert "streaming" in rep.schedules


def _row_mins(n):
    def fn(x, w):
        h = x @ w
        out = h
        for i in range(n):
            out = out - (h * float(i + 1)).amax(-1, keepdim=True)
        return out
    return fn


@pytest.mark.parametrize("n,anchored", [(12, 1), (31, 0)])
def test_h100_gate_takes_more_row_reductions_than_eight(tmp_path,
                                                        anchoring_on, n,
                                                        anchored):
    """An epilogue of ``n`` row maxima: the slot exchanges are sized from
    the chain's own count, so 12 anchor (the kernel once held 8); 31 pass
    one block's shared memory (``Tile.smem``: 768 bytes a slot on the row
    tile) and stay memory-only.  The result is the function's; the
    admitted chain's host build is the plain evaluator."""
    fn = _row_mins(n)
    args = (torch.randn(16, 32), torch.randn(32, 64))
    sf = tcore.stitched_jit(fn, device="cpu")
    assert sf.report(*args).n_anchored == anchored
    smem = MM.TILE_ROW.smem(n, 0)
    assert (smem <= tcost.H100.anchor_budget) == bool(anchored)
    torch.testing.assert_close(sf(*args), fn(*args), rtol=1e-5, atol=1e-5)
    if anchored:
        c = sf.compiled(*args)
        em = next(e for e in c.emitted if e.kind == "anchored")
        assert em.fn.entry.epi_slots == n
        assert f"static constexpr int kSlots = {n};" in em.fn.entry.source
        _check_matmul_chain(tmp_path, f"rows{n}", em, c.graph)


def test_h100_attention_gate_is_the_flash_instance(anchoring_on):
    args = _t(_attn_args(S=64, D=64))
    rep, got = _h100_anchored(t_attn, *[a.to("meta") for a in args])
    assert rep.n_anchored == 1 and got[0][2] == FA.flash_smem_bytes(64)
    # head dim 160 runs zero-padded on the D 256 instance; 264 on the
    # wide kernel with its generated score functor
    pad = [torch.empty(1, 2, 64, 160, device="meta")] * 3 \
        + [torch.empty(1, 1, 64, 64, device="meta")]
    rep, got = _h100_anchored(t_attn, *pad)
    assert rep.n_anchored == 1 and got[0][2] == FA.flash_smem_bytes(256)
    big = [torch.empty(1, 2, 64, 264, device="meta")] * 3 \
        + [torch.empty(1, 1, 64, 64, device="meta")]
    rep, got = _h100_anchored(t_attn, *big)
    assert rep.n_anchored == 1 and got[0][2] == FA.flash_smem_bytes(264)
    assert FA.flash_smem_bytes(264) == 157_696  # the D 320 wide instance
    vals = [torch.randn(*t.shape) for t in big]
    sf = tcore.stitched_jit(t_attn, device="cpu")
    c = sf.compiled(*vals)
    em = next(e for e in c.emitted if e.kind == "anchored")
    assert em.fn.score_mod is not None
    assert '#include "flash_attention_wide.cuh"' in em.fn.score_mod.entry.source
    torch.testing.assert_close(sf(*vals), t_attn(*vals), rtol=1e-5,
                               atol=1e-5)


def test_h100_gate_admits_a_head_dim_256_attention_group(anchoring_on):
    """Gemma-7B's heads (16 x 256): the D 256 flash instance takes more
    than half a block's shared memory (the TPU's double-buffer rule), and
    the H100 gate admits it against one block's whole 232,448 bytes."""
    args = [torch.empty(4, 16, 512, 256, device="meta")] * 3 \
        + [torch.empty(1, 1, 512, 512, device="meta")]
    rep, got = _h100_anchored(t_attn, *args)
    assert FA.flash_smem_bytes(256) > tcost.H100.vmem_budget
    assert FA.flash_smem_bytes(256) <= tcost.H100.anchor_budget
    assert rep.n_anchored == 1 and got[0][2] == FA.flash_smem_bytes(256)


@pytest.mark.parametrize("part", ["flash", "matmul"])
def test_gate_constants_are_the_kernels_own(part):
    """The Python constants the gate reads are the ones the CUDA sources
    use.  Flash attention: its block rows, head-dim instances, K/V tile
    rows, register-Q limit and row strides are mirrored, and
    ``flash_smem_bytes`` is ``smem_floats`` evaluated on the parsed
    constants.  The matmul template takes its tiles as template
    arguments from ``kernels.matmul.TILES``, and the generated source
    asserts (at compile time, g++ here and nvcc on the card) that each
    instance's shared memory is ``Tile.smem_bytes``."""
    if part == "flash":
        cuh = open(f"{CSRC}/flash_attention.cuh").read()
        bq = int(re.search(r"kBQ = (\d+)", cuh).group(1))
        assert bq == FA.FLASH_BQ
        kb_q, kb_smem = map(int, re.search(
            r"kbk\(int d\) \{ return qreg\(d\) \? (\d+) : (\d+);",
            cuh).groups())
        qreg = int(re.search(r"qreg\(int d\) \{ return d <= (\d+);",
                             cuh).group(1))
        assert qreg == FA.FLASH_QREG_MAX_D
        ks = int(re.search(r"kstride\(int d\) \{ return d \+ (\d+);",
                           cuh).group(1))
        vs = int(re.search(r"vstride\(int d\) \{ return d \+ (\d+);",
                           cuh).group(1))
        dims = tuple(int(d) for d in re.findall(r"p\.D == (\d+)", cuh))
        assert dims == FA.FLASH_HEAD_DIMS
        for d in dims:
            kbk = kb_q if d <= qreg else kb_smem
            assert FA.flash_kbk(d) == kbk
            floats = 2 * kbk * ((d + ks) + (d + vs)) \
                + (0 if d <= qreg else bq * (d + ks))
            assert FA.flash_smem_bytes(d) == 4 * floats
        return
    mm = open(f"{CSRC}/matmul_fused.cuh").read()
    assert int(re.search(r"kMaxCluster = (\d+)", mm).group(1)) \
        == MM.MAX_CLUSTER
    fn, args = _matmul_then(lambda h: torch.tanh(h) * 2.0 + 1.0, 64)
    em = next(e for e in tcore.stitched_jit(fn, device="cpu")
              .compiled(*args).emitted if e.kind == "anchored")
    src = em.fn.entry.source
    for t in (MM.TILE_LARGE, MM.TILE_SMALL, MM.TILE_DECODE):
        assert f"launch<{t.template_args}>" in src
        assert t.template_args.startswith(
            f"{t.bm}, {t.bn}, {t.bk}, {t.stages}, {t.raw_stages}, {t.wn}, ")
        assert (f"smem_bytes({t.bm}, {t.bn}, {t.bk}, {t.stages}, "
                f"{t.raw_stages}, {t.wn}, {t.am}, Epi::kSlots, "
                f"Pro::kSlots) == {t.smem_bytes}") in src


# ---------------------------------------------------------------------------
# the generated C++ chains, built for the host with g++
# ---------------------------------------------------------------------------
_ROLE_SHAPE = {"full": lambda R, C: (R, C), "row": lambda R, C: (R, 1),
               "col": lambda R, C: (1, C), "scalar": lambda R, C: ()}


def _rand(shape, dtype):
    if dtype == torch.bool:
        return rng.standard_normal(shape) > 0
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-6,
                               atol=1e-6 * max(1.0, np.abs(want).max()))


def _check_matmul_chain(tmp_path, tag, em, graph):
    ch = em.fn.chain
    lib = gxx(tmp_path, em.fn.entry.source, tag)
    M, K, N = ch["M"], ch["K"], ch["N"]

    def operands(ops, roles, C):
        return [np.ascontiguousarray(_rand(
            _ROLE_SHAPE[r](M, C), torch.bool
            if graph.node(i).spec.dtype == "bool" else torch.float32))
            for i, r in zip(ops, roles)]

    pro = operands(ch["pro_ops"], ch["pro_roles"], K)
    tpro = [torch.from_numpy(np.asarray(a)) for a in pro]
    want = (ch["prologue"](*[MM._view(t, r, M, K) for t, r in
                             zip(tpro, ch["pro_roles"])])
            if ch["prologue"] else tpro[0])
    # the prologue read through its loads, and from its staged operand
    for entry in (lib.repro_host_pro, lib.repro_host_pro_staged):
        lhs = np.empty((M, K), np.float32)
        entry(ptrs(pro), lhs.ctypes.data_as(ctypes.c_void_p),
              ctypes.c_longlong(M), ctypes.c_longlong(K))
        _close(lhs, want.numpy())

    acc = _rand((M, N), torch.float32)
    epi = operands(ch["epi_ops"], ch["epi_roles"], N)
    outs = [np.zeros(_ROLE_SHAPE[r](M, N) or (1, 1),
                     np.bool_ if dt == torch.bool else np.float32)
            for r, dt in zip(ch["out_roles"], ch["out_dtypes"])]
    lib.repro_host_epi(acc.ctypes.data_as(ctypes.c_void_p), ptrs(epi),
                       ptrs(outs), ctypes.c_longlong(M), ctypes.c_longlong(N))
    tepi = [MM._view(torch.from_numpy(np.asarray(a)), r, M, N)
            for a, r in zip(epi, ch["epi_roles"])]
    wants = (ch["epilogue"](torch.from_numpy(acc), *tepi)
             if ch["epilogue"] else (torch.from_numpy(acc),))
    for o, w, r in zip(outs, wants, ch["out_roles"]):
        _close(o.reshape(_ROLE_SHAPE[r](M, N) or (1, 1)),
               w.expand(_ROLE_SHAPE[r](M, N) or (1, 1)).numpy())


def _check_score_chain(tmp_path, tag, em):
    mod = em.fn.score_mod
    lib = gxx(tmp_path, mod.entry.source, tag)
    B, H, Sq, Sk = em.fn.extent
    s = _rand((B, H, Sq, Sk), torch.float32)
    ops = [np.ascontiguousarray(_rand(sh, torch.float32))
           for _, sh in em.fn.score_operands]
    st = []
    for a in ops:
        st += [x // 4 if d != 1 else 0 for x, d in zip(a.strides, a.shape)]
    out = np.empty_like(s)
    lib.repro_host_score(s.ctypes.data_as(ctypes.c_void_p), ptrs(ops),
                         (ctypes.c_longlong * max(4, len(st)))(*st),
                         out.ctypes.data_as(ctypes.c_void_p), B, H, Sq, Sk)
    want = mod.plain(torch.from_numpy(s),
                     *[torch.from_numpy(a) for a in ops])
    _close(out, want.numpy())


@pytest.mark.parametrize("name", ["block", "mlp", "attn"])
@pytest.mark.parametrize("hw", ["V5E", "H100"])
def test_generated_chains_match_the_plain_evaluator(tmp_path, anchoring_on,
                                                    name, hw):
    """Every anchored group of the probe graphs: its generated prologue,
    epilogue or score functor, built with g++ (``__host__`` and
    ``__device__`` are empty there), against the plain row-view
    evaluator at 1e-6 relative."""
    *_, tfn, ta = next(p for p in _probes() if p[0] == name)
    c = tcore.stitched_jit(tfn, hw=getattr(tcore, hw),
                           device="cpu").compiled(*ta)
    n = 0
    for i, em in enumerate(c.emitted):
        if em.kind != "anchored":
            continue
        n += 1
        if hasattr(em.fn, "chain"):
            _check_matmul_chain(tmp_path, f"{name}{i}", em, c.graph)
        else:
            _check_score_chain(tmp_path, f"{name}{i}", em)
    assert n >= 1


def _reducing_epilogues(x, w, g):
    h = x @ w
    return (h * torch.rsqrt((h ** 2).mean(-1, keepdim=True) + 1e-6) * g,
            torch.softmax(h, -1), h.amin(-1, keepdim=True))


def test_generated_reduction_epilogue_matches_the_plain_evaluator(
        tmp_path, anchoring_on):
    """An epilogue with row reductions (an RMSNorm, a softmax, a row min:
    sum, max and min over N 160, the forms the H100 gate admits) runs in
    phases; its host build matches the plain evaluator."""
    args = (torch.randn(40, 96), torch.randn(96, 160), torch.randn(160))
    c = tcore.stitched_jit(_reducing_epilogues, device="cpu").compiled(*args)
    ems = [e for e in c.emitted if e.kind == "anchored"]
    assert len(ems) == 1 and ems[0].fn.tile == MM.TILES.index(MM.TILE_ROW)
    assert "kPhases = 3" in ems[0].fn.entry.source
    _check_matmul_chain(tmp_path, "red", ems[0], c.graph)
    torch.testing.assert_close(
        c.run_schedule(*args)[0], _reducing_epilogues(*args)[0], rtol=1e-5,
        atol=1e-5)


# ---------------------------------------------------------------------------
# ROADMAP C.5: the whole vocabulary, in both generators
# ---------------------------------------------------------------------------
C5 = ["round", "pow", "atan2", "rem", "erfc", "cbrt", "nextafter",
      "reduce_prod", "reduce_and", "reduce_or"]


def _prim_graph(ir, classify, prim, with_fn):
    """x, y [4, 8] -> one node of ``prim`` (a reduction as x - bcast(r))."""
    g = ir.Graph()

    def add(p, inputs, out_shape, dtype="float32", **params):
        kind = ir.OpKind.INPUT if p == "input" else classify(p)
        spec = ir.TensorSpec(out_shape, dtype)
        if with_fn and kind is not ir.OpKind.INPUT:
            from repro_torch.core.tracer import make_fn
            params["_fn"] = make_fn(p, params, spec)
        g.add(ir.Node(len(g.nodes), p, kind, tuple(inputs), spec, params))
        if kind is ir.OpKind.INPUT:
            g.inputs.append(len(g.nodes) - 1)
        return len(g.nodes) - 1

    x, y = add("input", (), (4, 8)), add("input", (), (4, 8))
    if prim.startswith("reduce_"):
        dt = "bool" if prim in ("reduce_and", "reduce_or") else "float32"
        r = add(prim, (x,), (4,), dt, axes=(1,))
        if dt == "bool":
            r = add("convert_element_type", (r,), (4,), new_dtype="float32")
        b = add("broadcast_in_dim", (r,), (4, 8), shape=(4, 8),
                broadcast_dimensions=(0,))
        out = add("sub", (x, b), (4, 8))
    elif prim in ("round", "erfc", "cbrt"):
        out = add(prim, (x,), (4, 8))
    else:
        out = add(prim, (x, y), (4, 8))
    g.outputs = [out]
    return g, frozenset(n for n in g.nodes if n not in g.inputs)


def test_emittable_vocabulary_is_the_reference_set():
    from repro_torch.core import codegen_cuda

    assert tcodegen.EMITTABLE_PRIMS == jcodegen.EMITTABLE_PRIMS
    assert codegen_cuda.CUDA_PRIMS == tcodegen.EMITTABLE_PRIMS


@pytest.mark.parametrize("prim", C5)
def test_pattern_emittable_matches_the_reference(prim):
    from repro.core import ir as jir
    from repro.core.classify import classify as jclassify
    from repro_torch.core import ir as tir
    from repro_torch.core.classify import classify as tclassify

    jg, jpat = _prim_graph(jir, jclassify, prim, False)
    tg, tpat = _prim_graph(tir, tclassify, prim, True)
    assert tcodegen.pattern_emittable(tg, tpat) is True
    assert tcodegen.pattern_emittable(tg, tpat) == \
        jcodegen.pattern_emittable(jg, jpat)


@pytest.mark.parametrize("prim", C5)
def test_new_primitives_lower_in_both_generators(tmp_path, prim):
    """Triton: the one-pass kernel's source compiles as Python and the
    group's plain version computes the primitive.  CUDA C++: the
    streaming group and an epilogue of the primitive build with g++ and
    match the plain evaluator."""
    from repro_torch.core import ir as tir
    from repro_torch.core.classify import classify as tclassify

    from repro_torch.core.rowspec import analyze
    from repro_torch.core.tracer import run_subgraph

    g, pat = _prim_graph(tir, tclassify, prim, True)
    info = analyze(g, pat)
    ext = g.pattern_inputs(pat)
    x, y = torch.randn(4, 8), torch.randn(4, 8) + 2.0
    if prim == "pow":
        x = x.abs() + 0.5  # a real power
    ref = {g.inputs[0]: x, g.inputs[1]: y}
    run_subgraph(g, sorted(pat), ref, "cpu")
    vals = [ref[i] for i in ext]
    one = tcodegen.OnePassKernel(g, pat, info, ext, g.outputs, block_rows=2)
    compile(one.source(), f"<{prim} onepass>", "exec")
    stream = tcodegen.StreamingKernel(g, pat, info, ext, g.outputs,
                                      block_rows=2, block_cols=4)
    lib = gxx(tmp_path, stream.source(), f"{prim}_stream")
    for got in (one("cpu", *vals)[0], stream("cpu", *vals)[0],
                stream.host(lib, *vals)[0]):
        torch.testing.assert_close(got, ref[g.outputs[0]])

    from repro_torch.core import codegen_cuda as cc
    src = cc.matmul_source(
        cc.prologue_struct(g, [], {g.inputs[0]: tcodegen.Role.FULL},
                           [g.inputs[0]], g.inputs[0]),
        cc.epilogue_struct(g, sorted(pat), info.roles, ext[1:],
                           g.inputs[0], g.outputs), [0])
    lib = gxx(tmp_path, src, prim)
    out = np.zeros((4, 8), np.float32)
    lib.repro_host_epi(x.numpy().ctypes.data_as(ctypes.c_void_p),
                       ptrs([ref[i].numpy() for i in ext[1:]]),
                       ptrs([out]), ctypes.c_longlong(4), ctypes.c_longlong(8))
    _close(out, ref[g.outputs[0]].numpy())


def _ln_proj(x, g, b, w):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return ((x - m) * torch.rsqrt(v + 1e-5) * g + b) @ w


@pytest.mark.parametrize("form", ["rmsnorm_prologue", "layernorm_prologue",
                                  "softmax_n2048", "twelve_maxima"])
def test_new_b3_forms_plain_versions_against_float64(form):
    """B3's plain version (``matmul_fused_plain``: the chains on whole
    tensors around ``torch.matmul``) of each new form -- a prologue that
    reduces over K in one and in two levels, a softmax epilogue over the
    2,048 columns of the largest cluster, twelve row reductions -- against
    the same group evaluated op by op in float64, within 1e-5 max(1,
    max|ref|) an output."""
    from repro_torch.core.tracer import run_subgraph

    g = torch.Generator().manual_seed(5)

    def r(*s, scale=1.0):
        return torch.randn(*s, generator=g) * scale

    fn, args = {
        "rmsnorm_prologue": (_rmsnorm_proj, (r(48, 96), r(96, 80, scale=0.1),
                                             r(96))),
        "layernorm_prologue": (_ln_proj, (r(40, 72), r(72), r(72),
                                          r(72, 56, scale=0.1))),
        "softmax_n2048": (lambda x, w: torch.softmax(x @ w, -1),
                          (r(16, 64), r(64, 2048, scale=0.1))),
        "twelve_maxima": (_row_mins(12), (r(24, 32), r(32, 300, scale=0.1))),
    }[form]
    c = tcore.stitched_jit(fn, device="cpu", dispatch="interpret").compiled(
        *args)
    gr = c.graph
    a = next(n for n in gr.nodes if gr.node(n).prim == "dot_general")
    _, anc = gr.reachability()
    body = [n for n in gr.nodes if n != a and gr.node(n).kind
            not in (tcodegen.OpKind.INPUT, tcodegen.OpKind.CONST)]
    pro = frozenset(n for n in body if (anc[a] >> n) & 1)
    parts = [p for p in (pro, frozenset({a}), frozenset(body) - pro) if p]
    em = tcodegen.emit_group(gr, parts, hw=tcost.H100, anchors=(a,))
    given = dict(zip(gr.inputs, args))
    vals = [given[i] for i in em.ext_ids]
    got = em.fn.plain(*vals)
    env = {i: given[i].double() for i in em.ext_ids}
    run_subgraph(gr, sorted(n for p in em.parts for n in p), env, "cpu")
    for o, w in zip(got, [env[i] for i in em.out_ids]):
        assert o.dtype == torch.float32
        err = float((o.double() - w).abs().max())
        assert err <= 1e-5 * max(1.0, float(w.abs().max()))
