"""``stitched_jit`` parity of the PyTorch port against the JAX package.

Outputs and ``StitchReport`` counts (groups, generated kernels -- the
reference's ``n_pallas`` -- and packed subgraphs) against
``repro.core.stitched_jit`` in Pallas interpret mode, under the ``V5E``
preset so both packages plan alike; plus the port's own dispatch modes.
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
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.layers import XLA  # noqa: E402
from repro_torch.models.model import block_apply  # noqa: E402

rng = np.random.default_rng(21)


def j_layernorm(x, g, b):
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean((x - mean) ** 2, axis=-1, keepdims=True)
    return (x - mean) * jax.lax.rsqrt(var + 1e-6) * g + b


def t_layernorm(x, g, b):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-6) * g + b


def j_softmax(x):
    m = jnp.max(x, axis=-1, keepdims=True)
    e = jnp.exp(x - m)
    return e / jnp.sum(e, axis=-1, keepdims=True)


def t_softmax(x):
    return torch.softmax(x, -1)


def _report_counts_match(jf, tf, jargs, targs):
    jr = jf.report(*jargs)
    tr = tf.report(*targs)
    assert tr.n_groups == jr.n_groups
    assert tr.n_generated == jr.n_pallas
    assert tr.n_packed == jr.n_packed
    assert tr.n_stitched == jr.n_stitched
    return jr, tr


def test_layernorm_matches_reference():
    x = rng.standard_normal((100, 256)).astype(np.float32)
    g = rng.standard_normal(256).astype(np.float32)
    b = rng.standard_normal(256).astype(np.float32)
    jf = jcore.stitched_jit(j_layernorm, hw=jcore.V5E)
    tf = tcore.stitched_jit(t_layernorm, hw=tcore.V5E, device="cpu")
    targs = [torch.from_numpy(a) for a in (x, g, b)]
    y = tf(*targs)
    # float32 LayerNorm, another summation order: rtol/atol 1e-5
    np.testing.assert_allclose(y.numpy(), np.asarray(jf(x, g, b)),
                               rtol=1e-5, atol=1e-5)
    jr, tr = _report_counts_match(jf, tf, (x, g, b), targs)
    assert tr.n_generated == 1 and tr.schedules == ["onepass"]
    assert tr.stats.n_kernels_unfused == jr.stats.n_kernels_unfused == 16


def test_long_row_softmax_matches_reference():
    x = (3 * rng.standard_normal((8, 20000))).astype(np.float32)
    jf = jcore.stitched_jit(j_softmax, hw=jcore.V5E)
    tf = tcore.stitched_jit(t_softmax, hw=tcore.V5E, device="cpu")
    y = tf(torch.from_numpy(x))
    # float32 sums of 20,000 terms in two orders differ by up to
    # ~sqrt(n) * eps ~ 1e-5 relative on each side: rtol 1e-4, atol 1e-9
    np.testing.assert_allclose(y.numpy(), np.asarray(jf(x)), rtol=1e-4,
                               atol=1e-9)
    _report_counts_match(jf, tf, (x,), (torch.from_numpy(x),))


def test_long_row_softmax_streams_under_h100():
    """A row of 128,256 f32 (501 KB) exceeds one block's 227 KB of shared
    memory: the H100 preset must pick the streaming kernel."""
    x = rng.standard_normal((4, 128256)).astype(np.float32)
    tf = tcore.stitched_jit(t_softmax, device="cpu")
    rep = tf.report(torch.from_numpy(x))
    assert rep.schedules == ["streaming"]
    y = tf(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), torch.softmax(
        torch.from_numpy(x), -1).numpy(), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("dispatch", ["single", "interpret"])
def test_reduced_block_matches_reference(monkeypatch, dispatch):
    monkeypatch.setenv("REPRO_ANCHOR", "0")
    jcfg = jget_config("llama3.2-3b").reduced()
    cfg = get_config("llama3.2-3b").reduced()
    jparams = JModel(jcfg, fusion_mode="xla").init(jax.random.PRNGKey(1))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    B, S = 2, 16
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jlayer = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"])

    def jfn(p, hh, pos):
        return jblock_apply(jcfg, p, hh, fm=FusionMode("xla"),
                            positions=pos)[0]

    jf = jcore.stitched_jit(jfn, hw=jcore.V5E)
    tf = tcore.stitched_jit(functools.partial(block_apply, cfg, fm=XLA),
                            hw=tcore.V5E, dispatch=dispatch, device="cpu")
    jargs = (jlayer, jnp.asarray(h), jnp.arange(S))
    targs = (tparams["blocks"][0], torch.from_numpy(h), torch.arange(S))
    y = tf(*targs)
    # float32 through 7 matmuls and two norms: rtol/atol 1e-4
    np.testing.assert_allclose(y.numpy(), np.asarray(jf(*jargs)),
                               rtol=1e-4, atol=1e-4)
    _report_counts_match(jf, tf, jargs, targs)


def test_isomorphic_groups_emit_once(monkeypatch):
    """Memory-only dedup: anchoring off, as the reference's own test of
    it (``test_isomorphic_layers_emit_once``); with anchoring on, each
    RMSNorm folds into its matmul's epilogue (``test_torch_anchor.py``
    covers the anchored dedup)."""
    monkeypatch.setenv("REPRO_ANCHOR", "0")

    def chain(x, w, g):
        def rms(v):
            return v * torch.rsqrt((v ** 2).mean(-1, keepdim=True) + 1e-6) * g
        h = x @ w
        h = rms(h) @ w
        return rms(h) @ w

    x, w, g = torch.randn(64, 128), torch.randn(128, 128), torch.randn(128)
    tf = tcore.stitched_jit(chain, device="cpu")
    rep = tf.report(x, w, g)
    assert rep.n_generated == 2 and rep.emission_reused == 1
    ref = tcore.stitched_jit(chain, device="cpu", dispatch="interpret")
    torch.testing.assert_close(tf(x, w, g), ref(x, w, g), rtol=1e-5,
                               atol=1e-5)


def test_schedule_runs_groups_before_their_consumers():
    x = torch.randn(32, 64)
    g = torch.randn(64)
    tf = tcore.stitched_jit(t_layernorm, device="cpu")
    comp = tf.compiled(x, g, g)
    done = set(comp.graph.inputs)
    for kind, item in comp.schedule:
        if kind == "node":
            ins, outs = comp.graph.node(item).inputs, [item]
        else:
            ins, outs = item.ext_ids, [n for p in item.parts for n in p]
        assert all(i in done or comp.graph.node(i).kind.value == "const"
                   for i in ins)
        done.update(outs)
    assert tf.n_compiled == 1
    tf(x, g, g)
    assert tf.n_compiled == 1  # same signature: no recompile


@pytest.mark.parametrize("name", ["layernorm", "rmsnorm", "softmax"])
def test_oracles_match_reference(name):
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref

    x = rng.standard_normal((33, 300)).astype(np.float32)
    g = rng.standard_normal(300).astype(np.float32)
    b = rng.standard_normal(300).astype(np.float32)
    args = {"layernorm": (x, g, b), "rmsnorm": (x, g), "softmax": (x,)}[name]
    want = getattr(jref, name)(*args)
    got = getattr(tref, name)(*[torch.from_numpy(a) for a in args])
    # float32, another summation order: rtol/atol 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_one_tensor_passed_twice_compiles_two_inputs():
    """A compiled graph traced where the caller passed one tensor for two
    arguments must not read that one input for both when reused with two
    different tensors (Zamba2's first shared block passes the embedding
    as its hidden state and its ``emb0``)."""
    tf = tcore.stitched_jit(lambda a, b: a * 2.0 - b, device="cpu")
    x, y = torch.randn(8, 16), torch.randn(8, 16)
    torch.testing.assert_close(tf(x, x), x)
    torch.testing.assert_close(tf(x, y), x * 2.0 - y)
    assert tf.n_compiled == 1

