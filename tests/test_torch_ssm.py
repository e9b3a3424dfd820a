"""The SSM (Mamba2) and hybrid (Zamba2) slice on the CPU, against the JAX
package.

The reduced Mamba2-370m (2 layers, 16 heads of 16, state 16, chunk 16) and
Zamba2-1.2B (4 layers, the shared block before layers 0 and 2) and the
SSD scan, fed the same numpy inputs as their counterparts in ``repro``
(the Pallas kernel in interpret mode, as the JAX package's own tests run
it): the scan's plain version, oracle and operator, its autograd against
``jax.vjp``, ``mamba_apply`` in prefill (with and without a chunk pad) and
in a decode step, the weight conversion, ``generate``, the loss and its
gradients, and three ``build_trainer`` steps.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticTokens as JSyntheticTokens  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jssd_kernel  # noqa: E402
from repro.launch.serve import generate as jgenerate  # noqa: E402
from repro.launch.train import build_trainer as jbuild_trainer  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.layers import FusionMode as JFusionMode  # noqa: E402
from repro.models.layers import mamba_apply as jmamba_apply  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import split_float as SF  # noqa: E402
from repro_torch.kernels import ssd_scan as K  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.layers import FusionMode, mamba_apply  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

SSM, HYBRID = "mamba2-370m", "zamba2-1.2b"
rng = np.random.default_rng(15)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the SSD scan: plain version, oracle and operator against the Pallas kernel
# ---------------------------------------------------------------------------
#: name -> (b, L, H, P, N, chunk): the reduced configs' shapes, one chunk
#: and several, a head dim and state of Zamba2's and Mamba2's proportions,
#: a head dim and state that are no multiple of the CUDA kernel's tiles
SCAN_SHAPES = {"reduced": (2, 32, 16, 16, 16, 16),
               "one-chunk": (1, 16, 4, 16, 16, 16),
               "odd-heads": (2, 48, 3, 8, 4, 16),
               "wide-state": (1, 64, 2, 16, 64, 32),
               "odd-P20-N36": (2, 96, 5, 20, 36, 32)}


def _scan_inputs(b, L, H, P, N):
    x = rng.standard_normal((b, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, L, H)) - 2.0)) \
        .astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    B = rng.standard_normal((b, L, N)).astype(np.float32)
    C = rng.standard_normal((b, L, N)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("name", sorted(SCAN_SHAPES))
def test_ssd_scan_matches_the_pallas_kernel(name):
    b, L, H, P, N, chunk = SCAN_SHAPES[name]
    ins = _scan_inputs(b, L, H, P, N)
    jy, js = jssd_kernel(*map(jnp.asarray, ins), chunk=chunk, interpret=True)
    before = K.ssd_scan_cuda.launches
    # the plain version, the operator, the oracle, and the CUDA kernel's
    # chunk-parallel decomposition with plain and with split products
    for fn in (K.ssd_scan_plain, K.ssd_scan,
               lambda *a: ref.ssd_scan(*a[:5], chunk=a[5]),
               SF.ssd_chunked,
               lambda *a: SF.ssd_chunked(*a, product=SF.split_matmul)):
        y, s = fn(*map(_t, ins), chunk)
        assert y.shape == (b, L, H, P) and s.shape == (b, H, P, N)
        assert s.dtype == torch.float32
        # float32 sums over the chunk and the state in another order
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4,
                                   atol=1e-5)
    assert K.ssd_scan_cuda.launches == before   # the plain versions ran


@pytest.mark.parametrize("name", sorted(SCAN_SHAPES))
def test_ssd_scan_oracle_with_an_initial_state_matches_the_reference(name):
    b, L, H, P, N, chunk = SCAN_SHAPES[name]
    ins = _scan_inputs(b, L, H, P, N)
    h0 = rng.standard_normal((b, H, P, N)).astype(np.float32)
    jy, js = jref.ssd_scan(*map(jnp.asarray, ins), chunk=chunk,
                           init_state=jnp.asarray(h0))
    y, s = ref.ssd_scan(*map(_t, ins), chunk=chunk, init_state=_t(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-5)


def test_ssd_scan_refuses_a_ragged_sequence():
    ins = [_t(a) for a in _scan_inputs(1, 20, 2, 16, 16)]
    for fn in (lambda: K.ssd_scan_plain(*ins, 16),
               lambda: ref.ssd_scan(*ins, chunk=16)):
        with pytest.raises(ValueError, match="multiple of the chunk"):
            fn()


def test_ssd_scan_grad_matches_jax_vjp():
    b, L, H, P, N, chunk = SCAN_SHAPES["reduced"]
    ins = _scan_inputs(b, L, H, P, N)
    dy = rng.standard_normal((b, L, H, P)).astype(np.float32)
    ds = rng.standard_normal((b, H, P, N)).astype(np.float32)
    _, pullback = jax.vjp(lambda *a: jops.ssd_scan(*a, chunk=chunk),
                          *map(jnp.asarray, ins))
    want = pullback((jnp.asarray(dy), jnp.asarray(ds)))
    ts = [_t(a).requires_grad_() for a in ins]
    y, s = ops.ssd_scan(*ts, chunk=chunk)
    got = torch.autograd.grad((y, s), ts, (_t(dy), _t(ds)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        # the VJP of the same oracle, float32 in another order
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    # y alone (training drops the state): the plain path's grads agree
    ts2 = [_t(a).requires_grad_() for a in ins]
    g1 = torch.autograd.grad(ops.ssd_scan(*ts, chunk=chunk)[0], ts, _t(dy))
    g2 = torch.autograd.grad(
        ops.ssd_scan(*ts2, chunk=chunk, use_kernels=False)[0], ts2, _t(dy))
    for a, w in zip(g1, g2):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)


def test_ssd_scan_operator_is_one_node():
    ins = [_t(a) for a in _scan_inputs(2, 32, 16, 16, 16)]
    gm = make_fx(lambda *a: ops.ssd_scan(*a, chunk=16)[0] * 2.0,
                 tracing_mode="fake")(*ins)
    nodes = [str(n.target) for n in gm.graph.nodes
             if n.op == "call_function"
             and str(n.target).startswith("repro_torch.")]
    assert nodes == ["repro_torch.ssd_scan.default"]


def test_ssd_scan_cuda_wrapper_refuses_cpu_tensors():
    ins = [_t(a) for a in _scan_inputs(1, 16, 2, 16, 16)]
    with pytest.raises(ValueError, match="CUDA"):
        K.ssd_scan_cuda(*ins, 16)


# ---------------------------------------------------------------------------
# configs, weights and the Mamba layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_configs_are_the_reference_configs(arch):
    mine, theirs = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(mine.reduced()) == \
        dataclasses.asdict(theirs.reduced())


_MODELS = {}


def _reduced(arch):
    """The reduced configs and the JAX model's weights on both sides."""
    if arch not in _MODELS:
        jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
        jm = build_model(jcfg, "stitched", remat=False)
        jparams = jm.init(jax.random.PRNGKey(7))
        tparams = from_jax_params(_np(jparams), device="cpu")
        _MODELS[arch] = (jcfg, cfg, jm, jparams, tparams)
    return _MODELS[arch]


def test_convert_carries_the_stacked_mamba_blocks():
    _, cfg, _, jparams, tparams = _reduced(SSM)
    jblocks = _np(jparams["blocks"])
    assert len(tparams["blocks"]) == cfg.n_layers
    for i, blk in enumerate(tparams["blocks"]):
        assert sorted(blk) == ["mamba", "norm1"]
        for name, arr in jblocks["mamba"].items():
            np.testing.assert_array_equal(blk["mamba"][name].numpy(), arr[i])


def test_convert_carries_the_hybrid_list_and_shared_block():
    _, cfg, _, jparams, tparams = _reduced(HYBRID)
    jp = _np(jparams)
    assert sorted(tparams) == sorted(jp)
    assert len(tparams["blocks"]) == cfg.n_layers == len(jp["blocks"])
    for mine, theirs in zip(tparams["blocks"], jp["blocks"]):
        for a, w in zip(jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(lambda t: t.numpy(), mine)),
                jax.tree_util.tree_leaves(theirs)):
            np.testing.assert_array_equal(a, w)
    sa = tparams["shared_attn"]
    assert tuple(sa["norm1"]["g"].shape) == (2 * cfg.d_model,)
    assert tuple(sa["attn"]["wq"].shape) == (
        2 * cfg.d_model, cfg.n_heads * cfg.resolved_head_dim)
    assert tuple(sa["attn"]["wo"].shape) == (
        cfg.n_heads * cfg.resolved_head_dim, cfg.d_model)
    np.testing.assert_array_equal(sa["mlp"]["w_gate"].numpy(),
                                  jp["shared_attn"]["mlp"]["w_gate"])


def _layer_weights(arch):
    jcfg, cfg, _, jparams, tparams = _reduced(arch)
    jblocks = jparams["blocks"]
    jp = (jax.tree_util.tree_map(lambda a: a[0], jblocks["mamba"])
          if isinstance(jblocks, dict) else jblocks[0]["mamba"])
    return jcfg, cfg, jp, tparams["blocks"][0]["mamba"]


#: prompt length -> why: 32 (two chunks, no pad), 21 (a chunk pad of 11),
#: 2 (shorter than the conv window: the conv cache is zero-padded)
PREFILL_LENGTHS = {"no-pad": 32, "chunk-pad": 21, "short": 2}


@pytest.mark.parametrize("fusion", ["stitched", "xla"])
@pytest.mark.parametrize("case", sorted(PREFILL_LENGTHS))
@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_mamba_apply_prefill_and_decode_match_the_reference(arch, case,
                                                            fusion):
    jcfg, cfg, jp, tp = _layer_weights(arch)
    S = PREFILL_LENGTHS[case]
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jcache = {"conv": jnp.zeros((2, cfg.conv_width - 1,
                                 cfg.resolved_d_inner + 2 * cfg.ssm_state)),
              "ssm": jnp.zeros((2, cfg.ssm_heads, cfg.ssm_head_dim,
                                cfg.ssm_state))}
    jfm, fm = JFusionMode(fusion), FusionMode(fusion)
    jy, jc = jmamba_apply(jcfg, jp, jnp.asarray(x), fm=jfm, cache=jcache)
    cache = {k: _t(v) for k, v in _np(jcache).items()}
    y, c = mamba_apply(cfg, tp, _t(x), fm=fm, cache=cache)
    # float32 through two projections and the scan, another order
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-5)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-4, atol=1e-5)
    # without a cache: the same output, no state
    y0, c0 = mamba_apply(cfg, tp, _t(x), fm=fm)
    assert c0 is None
    torch.testing.assert_close(y0, y, rtol=0, atol=0)
    # one decode step from the prefill's caches
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jy1, jc1 = jmamba_apply(jcfg, jp, jnp.asarray(x1), fm=jfm, cache=jc)
    y1, c1 = mamba_apply(cfg, tp, _t(x1), fm=fm, cache=c)
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy1), rtol=1e-4,
                               atol=1e-5)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(c1[k].numpy(), np.asarray(jc1[k]),
                                   rtol=1e-4, atol=1e-5)


def test_stitched_mamba_layer_holds_the_scan_as_one_opaque_node():
    """The serving layer, traced: the SSD scan and the RMSNorms are
    custom ops; the depthwise convolution, the softplus and the chunk pad
    are opaque aten nodes (the reference lowers the convolution as an
    anchor and the softplus into element-wise primitives)."""
    _, cfg, _, _, tparams = _reduced(SSM)
    mdl = Model(cfg, device="cpu")
    cache = mdl.init_cache(2, 32)["mamba"][0]
    comp = mdl.mamba.compiled(tparams["blocks"][0],
                              torch.zeros(2, 21, cfg.d_model),
                              cache["conv"], cache["ssm"])
    prims = [n.prim for n in comp.graph.nodes.values()]
    assert prims.count("repro_torch.ssd_scan.default") == 1
    assert prims.count("repro_torch.rmsnorm.default") == 2
    assert {"aten.convolution.default", "aten.softplus.default",
            "aten.constant_pad_nd.default"} <= set(prims)
    assert [tuple(comp.graph.node(o).spec.shape)
            for o in comp.graph.outputs][1:] == [
        (2, cfg.conv_width - 1, cfg.resolved_d_inner + 2 * cfg.ssm_state),
        (2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)]


# ---------------------------------------------------------------------------
# the whole slice: serving and training against the JAX model
# ---------------------------------------------------------------------------
GEN = 5


@pytest.mark.parametrize("fusion", ["stitched", "xla"])
@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_generate_matches_jax_generate(arch, fusion):
    """A 21-token prompt (no bucket size; a chunk pad of 11): the
    reference runs stitched (its Pallas kernels in interpret mode), the
    port in both of its modes."""
    _, cfg, jm, jparams, tparams = _reduced(arch)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 21))
    want = jgenerate(jm, jparams, prompts.astype(np.int32), GEN)
    got = serve.generate(Model(cfg, fusion, device="cpu"), tparams, prompts,
                         GEN)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_prefill_and_decode_logits_match_jax(arch):
    jcfg, cfg, _, jparams, tparams = _reduced(arch)
    jm = build_model(jcfg, "xla", remat=False)   # the same function, faster
    prompts = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 19))
    jc = jm.init_cache(2, 32)
    jlogits, jc = jm.prefill(jparams, tokens=jnp.asarray(prompts, jnp.int32),
                             cache=jc)
    mdl = Model(cfg, device="cpu")
    cache = mdl.init_cache(2, 32)
    logits, _ = mdl.prefill(tparams, _t(prompts), cache)
    # float32 through the layers, another summation order
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=2e-4)
    tok = np.array([[3], [7]])
    for pos in (19, 20):
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(tok, jnp.int32),
                                jnp.asarray(pos), kv_len=jnp.asarray(pos + 1))
        tl, _ = mdl.decode_step(tparams, cache, _t(tok), torch.tensor(pos),
                                kv_len=torch.tensor(pos + 1))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=2e-4)
        tok = tok + 1


def test_hybrid_cache_has_one_kv_cache_per_shared_application():
    _, cfg, _, _, _ = _reduced(HYBRID)
    cache = Model(cfg, device="cpu").init_cache(2, 32)
    assert len(cache["mamba"]) == cfg.n_layers
    assert len(cache["attn"]) == len(range(0, cfg.n_layers, cfg.attn_every))
    assert tuple(cache["attn"][0]["k"].shape) == (
        2, cfg.n_kv_heads, 32, cfg.resolved_head_dim)
    assert cache["mamba"][0]["ssm"].dtype == torch.float32


def _batch(jcfg, step=0):
    return JSyntheticTokens(JDataConfig(seed=1, global_batch=2, seq_len=20),
                            jcfg).batch_at(step)


@pytest.mark.parametrize("fusion", ["stitched", "xla"])
@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_loss_and_grads_match_jax_value_and_grad(arch, fusion):
    """Sequences of 20 tokens: a chunk pad of 12 inside the loss."""
    jcfg, cfg, _, jparams, tparams = _reduced(arch)
    jm = build_model(jcfg, fusion, remat=False)
    batch = _batch(jcfg)
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch))
    mdl = Model(cfg, fusion, device="cpu")
    loss, grads = loss_and_grads(mdl, tparams,
                                 {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jg = _np(jgrads)
    got = jax.tree_util.tree_map(lambda t: t.numpy(), grads)
    if isinstance(jg["blocks"], dict):   # the stacked ssm blocks
        got["blocks"] = jax.tree_util.tree_map(lambda *xs: np.stack(xs),
                                               *got["blocks"])
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(jg)
    for a, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jg)):
        # float32 through the layers and the scan, another order
        np.testing.assert_allclose(a, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-7)


def test_three_train_steps_match_the_reference_trainer():
    jcfg, cfg, _, _, _ = _reduced(SSM)
    _, jinit, jstep = jbuild_trainer(jcfg, fusion_mode="stitched", lr=1e-3,
                                     total_steps=3)
    jstate = jinit(jax.random.PRNGKey(2))
    _, _, tstep = train.build_trainer(cfg, lr=1e-3, total_steps=3,
                                      device="cpu")
    tparams = from_jax_params(_np(jstate["params"]), device="cpu")
    tstate = {"params": tparams,
              "opt": optim.init(optim.AdamWConfig(), tparams)}
    for step in range(3):
        batch = _batch(jcfg, step)
        jstate = jstep(jstate, batch)
        tstate = tstep(tstate, batch)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(tstep.last_metrics[k],
                                       jstep.last_metrics[k], rtol=1e-5)


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_serve_and_train_main_run_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "5", "--gen", "3"])
    train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps",
                "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "sample:" in out
    assert "step     1 loss=" in out
