"""Tracer and planner parity of the PyTorch port against the JAX package.

The same function, written once with ``jnp`` and once with ``torch``, must
trace to the same primitive sequence and plan to the same patterns and
``PlanStats`` under the ``V5E`` preset (the reference's constants).  For
the reduced Llama block the graphs differ in detail (documented in
ROADMAP "C"), so the test holds the port to the same number of
``dot_general`` breaks and of one-pass / streaming / packed groups.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.layers import FusionMode  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.model import block_apply as jblock_apply  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.layers import XLA  # noqa: E402
from repro_torch.models.model import block_apply  # noqa: E402

rng = np.random.default_rng(11)


def j_layernorm(x, g, b):
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean((x - mean) ** 2, axis=-1, keepdims=True)
    return (x - mean) * jax.lax.rsqrt(var + 1e-6) * g + b


def t_layernorm(x, g, b):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-6) * g + b


def j_rmsnorm(x, g):
    ms = jnp.mean(x ** 2, axis=-1, keepdims=True)
    return x * jax.lax.rsqrt(ms + 1e-6) * g


def t_rmsnorm(x, g):
    ms = (x ** 2).mean(-1, keepdim=True)
    return x * torch.rsqrt(ms + 1e-6) * g


def j_softmax(x):
    from repro.kernels import ref
    return ref.softmax(x)


CASES = {
    "layernorm": (j_layernorm, t_layernorm, [(64, 256), (256,), (256,)]),
    "rmsnorm": (j_rmsnorm, t_rmsnorm, [(64, 256), (256,)]),
    "softmax": (j_softmax, tref.softmax, [(64, 256)]),
}


def _args(shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _sequence(graph):
    return [(n.prim, n.spec.shape, n.spec.dtype, n.inputs)
            for n in graph.nodes.values()]


@pytest.mark.parametrize("name", sorted(CASES))
def test_primitive_sequence_matches_reference(name):
    jfn, tfn, shapes = CASES[name]
    args = _args(shapes)
    jg = jcore.trace(jfn, *args)
    tg = tcore.trace(tfn, *[torch.from_numpy(a) for a in args])
    assert _sequence(tg) == _sequence(jg)
    assert tg.inputs == jg.inputs and tg.outputs == jg.outputs
    for jn, tn in zip(jg.nodes.values(), tg.nodes.values()):
        assert tn.kind.value == jn.kind.value
        for key in ("axes", "broadcast_dimensions", "shape", "y"):
            if key in jn.params:
                assert tuple(np.atleast_1d(tn.params[key])) == \
                    tuple(np.atleast_1d(jn.params[key])), (tn, key)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_and_stats_match_reference_under_v5e(name):
    jfn, tfn, shapes = CASES[name]
    args = _args(shapes)
    jg = jcore.trace(jfn, *args)
    tg = tcore.trace(tfn, *[torch.from_numpy(a) for a in args])
    jplan = jcore.make_plan(jg, jcore.V5E)
    tplan = tcore.make_plan(tg, tcore.V5E)
    assert sorted(sorted(p.members) for p in tplan.patterns) == \
        sorted(sorted(p.members) for p in jplan.patterns)
    js = jcore.plan_stats(jg, jplan)
    ts = tcore.plan_stats(tg, tplan, ctx=tcore.CostContext(tg, tcore.V5E))
    assert ts.n_patterns == js.n_patterns
    assert ts.n_kernels_stitched == js.n_kernels_stitched
    assert ts.n_kernels_unfused == js.n_kernels_unfused
    assert ts.hbm_bytes_stitched == js.hbm_bytes_stitched
    assert ts.hbm_bytes_unfused == js.hbm_bytes_unfused


def test_v5e_estimates_are_the_reference_numbers():
    args = _args(CASES["layernorm"][2])
    jg = jcore.trace(j_layernorm, *args)
    tg = tcore.trace(t_layernorm, *[torch.from_numpy(a) for a in args])
    pat = frozenset(jg.fusible_nodes())
    je = jcore.best_estimate(jg, pat, jcore.V5E)
    te = tcore.best_estimate(tg, pat, tcore.V5E)
    assert (te.schedule, te.block_rows, te.n_steps, te.hbm_bytes) == \
        (je.schedule, je.block_rows, je.n_steps, je.hbm_bytes)
    assert te.latency_s == pytest.approx(je.latency_s, rel=1e-12)
    assert tcore.delta_evaluator(tg, pat, tcore.V5E) == pytest.approx(
        jcore.delta_evaluator(jg, pat, jcore.V5E), rel=1e-12)


# ---------------------------------------------------------------------------
# the reduced Llama block
# ---------------------------------------------------------------------------
def _block_setup(monkeypatch):
    monkeypatch.setenv("REPRO_ANCHOR", "0")
    jcfg = jget_config("llama3.2-3b").reduced()
    cfg = get_config("llama3.2-3b").reduced()
    jparams = JModel(jcfg, fusion_mode="xla").init(jax.random.PRNGKey(3))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = from_jax_params(np_params, device="cpu")
    B, S = 2, 16
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jlayer = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"])

    def jfn(p, hh, pos):
        return jblock_apply(jcfg, p, hh, fm=FusionMode("xla"),
                            positions=pos)[0]

    jargs = (jlayer, jnp.asarray(h), jnp.arange(S))
    targs = (tparams["blocks"][0], torch.from_numpy(h), torch.arange(S))
    return jfn, jargs, functools.partial(block_apply, cfg, fm=XLA), targs


def _jax_schedules(compiled):
    return [em.estimate.schedule if em.kind == "pallas" else "packed"
            for em in compiled.emitted]


def test_reduced_block_plans_like_the_reference(monkeypatch):
    jfn, jargs, tfn, targs = _block_setup(monkeypatch)
    jc = jcore.stitched_jit(jfn, hw=jcore.V5E).compiled(*jargs)
    tc = tcore.stitched_jit(tfn, hw=tcore.V5E, device="cpu").compiled(*targs)

    def n_dot(g):
        return sum(1 for n in g.nodes.values() if n.prim == "dot_general")

    assert n_dot(tc.graph) == n_dot(jc.graph) == 9
    js, ts = _jax_schedules(jc), tc.report.schedules
    for sched in ("onepass", "streaming", "packed"):
        assert ts.count(sched) == js.count(sched), (sched, ts, js)
    assert tc.report.n_groups == jc.report.n_groups
    assert tc.report.stats.n_kernels_unfused == \
        jc.report.stats.n_kernels_unfused


def test_reduced_block_vocabulary_is_the_reference_vocabulary(monkeypatch):
    jfn, jargs, tfn, targs = _block_setup(monkeypatch)
    jv = {n.prim for n in jcore.trace(jfn, *jargs).nodes.values()}
    tv = {n.prim for n in tcore.trace(tfn, *targs).nodes.values()}
    # ``jnp.square`` has no aten counterpart: torch.square traces to
    # pow(x, 2), which lowers to ``integer_pow`` (ROADMAP "C")
    assert tv - {"integer_pow"} <= jv
    assert {"dot_general", "reduce_max", "reduce_sum", "select_n", "iota",
            "concatenate", "slice", "transpose", "logistic"} <= tv


def _full_width_groups(cost, G, hw, emittable):
    ctx = cost.CostContext(G, hw)
    plan = cost.make_plan(G, hw, ctx=ctx)
    out = []
    for grp in cost.search_groups(G, plan, hw, ctx=ctx).groups:
        est = ctx.best(grp.members)
        ok = emittable(G, grp.members, info=ctx.info(grp.members))
        out.append((est.schedule if ok else "packed",
                    est.block_rows if ok else 0))
    return out


def test_full_width_block_plans_like_the_reference(monkeypatch):
    """Llama-3.2-3B width (d_model 3072, 24/8 heads, d_ff 8192, B=4,
    S=512), traced without computing anything (abstract shapes in JAX,
    meta tensors in the port): under ``V5E`` both packages plan the same
    groups -- RMSNorm one-pass at block_rows 128, the masked softmax tail
    at 1, residual + RMSNorm at 64, SiLU x up at 1, four packed -- in the
    same order."""
    from repro.core.codegen import pattern_emittable as j_emittable
    from repro.models.model import Model as JM
    from repro_torch.core.codegen import pattern_emittable as t_emittable
    from repro_torch.models.model import block_init

    monkeypatch.setenv("REPRO_ANCHOR", "0")
    jcfg = jget_config("llama3.2-3b")
    cfg = get_config("llama3.2-3b")
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
    tlayer = block_init(cfg, None, torch.float32, "meta")
    tg = tcore.trace(functools.partial(block_apply, cfg, fm=XLA), tlayer,
                     torch.empty(4, 512, 3072, device="meta"),
                     torch.empty(512, dtype=torch.int64, device="meta"))
    jgroups = _full_width_groups(jcore, jg, jcore.V5E, j_emittable)
    tgroups = _full_width_groups(tcore, tg, tcore.V5E, t_emittable)
    assert tgroups == jgroups
    assert [g for g in tgroups if g[0] == "onepass"] == [
        ("onepass", 128), ("onepass", 1), ("onepass", 64), ("onepass", 1)]
    assert len(jg) == 115


# ---------------------------------------------------------------------------
# remote fusion closes no dependency cycle between launches
# ---------------------------------------------------------------------------
def _dag(inputs_of: dict[int, tuple[int, ...]]):
    """A graph of elementwise ops over one input (node 0)."""
    from repro_torch.core.ir import Graph, Node, OpKind, TensorSpec

    spec = TensorSpec((4,), "float32")
    g = Graph()
    g.add(Node(0, "input", OpKind.INPUT, (), spec))
    for nid in sorted(inputs_of):
        g.add(Node(nid, "neg", OpKind.LIGHT_EW, inputs_of[nid], spec))
    used = {i for ins in inputs_of.values() for i in ins}
    g.inputs, g.outputs = [0], [n for n in inputs_of if n not in used]
    return g


def _quotient_has_cycle(graph, groups) -> bool:
    """Brute force: contract each group to one unit, then Kahn's sort."""
    unit = {n: n for n in graph.nodes}
    for grp in groups:
        for n in grp:
            unit[n] = ("g", min(grp))
    deps = {u: set() for u in unit.values()}
    for n in graph.nodes:
        for i in graph.node(n).inputs:
            if unit[i] != unit[n]:
                deps[unit[n]].add(unit[i])
    done: set = set()
    while True:
        ready = [u for u in deps if u not in done and deps[u] <= done]
        if not ready:
            return len(done) != len(deps)
        done.update(ready)


@pytest.mark.parametrize("with_pattern", [True, False])
def test_remote_fusion_packs_no_cycle_with_the_plan(with_pattern):
    """{1, 4} is a plan pattern; {2, 3} is convex on its own but, beside
    {1, 4}, closes a cycle (1 -> 3, 2 -> 4).  Remote fusion must leave 2
    and 3 unpacked there, and pack them where the pattern is absent."""
    from repro_torch.core.ir import FusionPlan, Pattern
    from repro_torch.core.planner import remote_fusion

    graph = _dag({1: (0,), 2: (0,), 3: (1,), 4: (2,)})
    assert graph.is_convex(frozenset({2, 3}))
    pats = [Pattern(frozenset({1, 4}), 0.0)] if with_pattern else []
    out = remote_fusion(graph, FusionPlan(pats, 0.0))
    launches = [p.members for p in out.patterns]
    assert not _quotient_has_cycle(graph, launches)
    if with_pattern:
        assert launches == [frozenset({1, 4})]
    else:
        assert frozenset({1, 2, 3, 4}) in launches


class _SizeScores:
    """A cost context that scores a pattern by its size, so coalescing
    takes every convex merge -- except one that mixes {2, 3} with another
    node."""

    def __init__(self, graph):
        self.graph = graph

    def union(self, a, b):
        return a | b

    def is_convex(self, members):
        return self.graph.is_convex(members)

    def score(self, members):
        mixed = members & {2, 3} and members - {2, 3}
        return -1.0 if mixed else float(len(members))

    def note_cap(self, *args):
        pass


def test_coalesce_merges_no_cycle_with_the_plan():
    """{1} and {4} would merge into a convex {1, 4}, which closes a cycle
    with the pattern {2, 3} (1 -> 3, 2 -> 4): coalescing must refuse it."""
    from repro_torch.core.ir import FusionPlan, Pattern
    from repro_torch.core.planner import coalesce_plan

    graph = _dag({1: (0,), 2: (0,), 3: (1,), 4: (2,)})
    plan = FusionPlan([Pattern(frozenset(m), 0.0)
                       for m in ({1}, {4}, {2, 3})], 0.0)
    out = coalesce_plan(graph, plan, ctx=_SizeScores(graph))
    launches = [p.members for p in out.patterns]
    assert not _quotient_has_cycle(graph, launches)
    assert sorted(map(sorted, launches)) == [[1], [2, 3], [4]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_closes_cycle_matches_a_brute_force_sort(seed):
    """On random DAGs with acyclic sets of convex launches, a trial launch
    closes a cycle exactly when the contracted graph cannot be sorted."""
    from repro_torch.core.planner import _closes_cycle

    r = np.random.default_rng(seed)
    n = 24
    graph = _dag({i: tuple(sorted({int(r.integers(0, i)) for _ in
                                   range(int(r.integers(1, 3)))}))
                  for i in range(1, n)})
    groups: list[frozenset[int]] = []
    free = set(range(1, n))
    for _ in range(40):
        grp = frozenset(int(v) for v in r.choice(sorted(free), 3,
                                                 replace=False))
        if graph.is_convex(grp) and \
                not _quotient_has_cycle(graph, groups + [grp]):
            groups.append(grp)
            free -= grp
        if len(free) < 8:
            break
    assert groups
    seen = set()
    for _ in range(200):
        trial = frozenset(int(v) for v in r.choice(
            sorted(free), int(r.integers(2, 5)), replace=False))
        want = _quotient_has_cycle(graph, groups + [trial])
        assert _closes_cycle(graph, trial, groups) == want
        seen.add(want)
    assert seen == {True, False}
