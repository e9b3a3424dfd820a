"""The MoE slice on the CPU, against the JAX package.

The reduced Granite MoE (2 layers, 4 experts, top-2, d_ff 64) and the
router's softmax kernels, fed the same numpy inputs as their counterparts
in ``repro`` (Pallas in interpret mode, as the JAX package's own tests run
it): the softmax plain versions and operators, their autograd against
``jax.vjp``, ``moe_apply`` (sort and einsum dispatch, with and without
dropped tokens), the weight conversion, ``generate``, the loss and its
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
from repro.kernels.softmax import softmax as jsoftmax  # noqa: E402
from repro.kernels.softmax import softmax_bwd as jsoftmax_bwd  # noqa: E402
from repro.kernels.softmax import softmax_fwd as jsoftmax_fwd  # noqa: E402
from repro.launch.serve import generate as jgenerate  # noqa: E402
from repro.launch.train import build_trainer as jbuild_trainer  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.layers import FusionMode as JFusionMode  # noqa: E402
from repro.models.layers import moe_apply as jmoe_apply  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import softmax as SM  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.layers import FusionMode, moe_apply  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ARCH = "granite-moe-1b-a400m"
rng = np.random.default_rng(14)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the router's softmax: plain versions and operators against the Pallas
# kernels
# ---------------------------------------------------------------------------
#: shape -> block_rows of the Pallas call: the router's [T, 32]; a ragged
#: [7, 40] (a padded last block of 4 rows); the reduced config's 4 experts;
#: Granite-3B's router width at a ragged count (a padded last block of 63
#: rows at the reference's default 64)
SOFTMAX_SHAPES = {"router-32": ((64, 32), 64), "ragged-40": ((7, 40), 4),
                  "reduced-4": ((3, 4), 2), "granite-3b-2047": ((2047, 40), 64)}


def _softmax_inputs(shape):
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, dy


@pytest.mark.parametrize("name", sorted(SOFTMAX_SHAPES))
def test_softmax_forward_matches_the_pallas_kernel(name):
    shape, br = SOFTMAX_SHAPES[name]
    x, _ = _softmax_inputs(shape)
    want = np.asarray(jsoftmax_fwd(jnp.asarray(x), block_rows=br,
                                   interpret=True))
    before = SM.softmax_cuda.launches
    for fn in (SM.softmax_plain, SM.softmax):
        y = fn(_t(x))
        assert y.shape == x.shape and y.dtype == torch.float32
        # float32, the same steps; exp may differ by an ulp
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-6, atol=1e-7)
    assert SM.softmax_cuda.launches == before   # the plain version ran


@pytest.mark.parametrize("name", sorted(SOFTMAX_SHAPES))
def test_softmax_backward_matches_the_pallas_kernel(name):
    shape, br = SOFTMAX_SHAPES[name]
    x, dy = _softmax_inputs(shape)
    y = np.asarray(jsoftmax_fwd(jnp.asarray(x), interpret=True))
    want = np.asarray(jsoftmax_bwd(jnp.asarray(y), jnp.asarray(dy),
                                   block_rows=br, interpret=True))
    before = SM.softmax_bwd_cuda.launches
    for fn in (SM.softmax_bwd_plain, SM.softmax_bwd):
        dx = fn(_t(y), _t(dy))
        assert dx.shape == y.shape
        # a row sum of up to 40 products, in another order
        np.testing.assert_allclose(dx.numpy(), want, rtol=1e-5, atol=1e-6)
    assert SM.softmax_bwd_cuda.launches == before


def test_softmax_grad_matches_jax_vjp():
    x, dy = _softmax_inputs((2, 24, 32))
    _, pullback = jax.vjp(jsoftmax, jnp.asarray(x))
    (want,) = pullback(jnp.asarray(dy))
    xt = _t(x).requires_grad_()
    (got,) = torch.autograd.grad(ops.softmax(xt), xt, _t(dy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # the plain path's gradient (torch.softmax's own backward) agrees too
    xt = _t(x).requires_grad_()
    (plain,) = torch.autograd.grad(ops.softmax(xt, use_kernels=False), xt,
                                   _t(dy))
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-6)


def test_softmax_operators_are_one_node_each():
    x = torch.randn(6, 32, requires_grad=True)
    gm = make_fx(lambda a: ops.softmax(a) * 2.0, tracing_mode="fake")(x)
    nodes = [str(n.target) for n in gm.graph.nodes
             if n.op == "call_function"
             and str(n.target).startswith("repro_torch.")]
    assert nodes == ["repro_torch.softmax.default"]
    y, dy = torch.rand(6, 32), torch.randn(6, 32)
    gm = make_fx(lambda a, b: SM.softmax_bwd(a, b) + 1.0,
                 tracing_mode="fake")(y, dy)
    nodes = [str(n.target) for n in gm.graph.nodes
             if n.op == "call_function"
             and str(n.target).startswith("repro_torch.")]
    assert nodes == ["repro_torch.softmax_bwd.default"]


def test_softmax_cuda_wrappers_refuse_cpu_tensors():
    x, dy = (_t(a) for a in _softmax_inputs((4, 32)))
    with pytest.raises(ValueError, match="CUDA"):
        SM.softmax_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        SM.softmax_bwd_cuda(x, dy)


@pytest.mark.parametrize("case", ["float16", "0-d", "meta"])
def test_softmax_cuda_wrappers_refuse_before_any_launch(case):
    """What the wrappers' quick test lets past it is a float32 CUDA tensor
    with rows; anything else gets ``_check``'s error, before the library is
    loaded (this host has none to load)."""
    x = {"float16": torch.randn(4, 32).half(), "0-d": torch.tensor(1.0),
         "meta": torch.empty(4, 32, device="meta")}[case]
    with pytest.raises(ValueError, match="CUDA"):
        SM.softmax_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        SM.softmax_bwd_cuda(x, x)


# ---------------------------------------------------------------------------
# the config, the weights and the MoE layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [ARCH, "granite-moe-3b-a800m"])
def test_configs_are_the_reference_configs(arch):
    mine, theirs = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(mine.reduced()) == \
        dataclasses.asdict(theirs.reduced())


@pytest.fixture(scope="module")
def reduced():
    """The reduced configs and the JAX model's weights on both sides."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jm = build_model(jcfg, "stitched", remat=False)
    jparams = jm.init(jax.random.PRNGKey(7))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jcfg, cfg, jm, jparams, tparams


def test_convert_carries_the_moe_subtree(reduced):
    jcfg, cfg, _, jparams, tparams = reduced
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    jblocks = jax.tree_util.tree_map(np.asarray, jparams["blocks"])
    assert jblocks["moe"]["w_gate"].shape == (cfg.n_layers, E, d, ff)
    assert len(tparams["blocks"]) == cfg.n_layers
    shapes = {"router": (d, E), "w_gate": (E, d, ff), "w_up": (E, d, ff),
              "w_down": (E, ff, d)}
    for i, blk in enumerate(tparams["blocks"]):
        assert sorted(blk) == sorted(jblocks)
        assert sorted(blk["moe"]) == sorted(shapes)
        for name, shape in shapes.items():
            assert tuple(blk["moe"][name].shape) == shape
            np.testing.assert_array_equal(blk["moe"][name].numpy(),
                                          jblocks["moe"][name][i])
    assert sorted(tparams) == sorted(jparams)


#: name -> (config overrides, x shape, whether the capacity drops tokens):
#: the reduced config, and ``tests/test_perf_features.py``'s overflow case
#: (2 experts, top-2, capacity factor 0.25: 8 slots for 32 pairs an expert)
MOE_CASES = {"reduced": ({}, (2, 16), False),
             "drops": ({"n_experts": 2, "top_k": 2, "capacity_factor": 0.25},
                       (1, 32), True)}


@pytest.mark.parametrize("fusion", ["stitched", "xla"])
@pytest.mark.parametrize("impl", ["sort", "einsum"])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_the_reference(case, impl, fusion):
    over, (B, S), drops = MOE_CASES[case]
    jcfg = jget_config(ARCH).reduced(**over)
    cfg = get_config(ARCH).reduced(**over)
    jparams = build_model(jcfg, "xla").init(jax.random.PRNGKey(3))
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a)[0],
                                jparams["blocks"]["moe"])
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                         device="cpu")["blocks"][0]["moe"]
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jy, jaux = jmoe_apply(jcfg, jax.tree_util.tree_map(jnp.asarray, jp),
                          jnp.asarray(x), JFusionMode(fusion), impl=impl)
    y, aux = moe_apply(cfg, tp, _t(x), FusionMode(fusion), impl=impl)
    jy = np.asarray(jy)
    assert y.shape == (B, S, cfg.d_model)
    # float32 through three matmuls, other summation orders
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-5,
                               atol=1e-5 * np.abs(jy).max())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    # the overflow case drops every choice of some tokens: zero rows
    zero_rows = int((np.abs(jy).max(-1) == 0).sum())
    assert (zero_rows > 0) == drops
    assert int((y.abs().amax(-1) == 0).sum()) == zero_rows


# ---------------------------------------------------------------------------
# the whole slice: serving and training against the JAX model
# ---------------------------------------------------------------------------
GEN = 5


@pytest.mark.parametrize("fusion", ["stitched", "xla"])
def test_generate_matches_jax_generate(reduced, fusion):
    """The reference runs stitched (its Pallas kernels in interpret mode);
    the port in both of its modes."""
    _, cfg, jm, jparams, tparams = reduced
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 13))
    want = jgenerate(jm, jparams, prompts.astype(np.int32), GEN)
    got = serve.generate(Model(cfg, fusion, device="cpu"), tparams, prompts,
                         GEN)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("fusion", ["stitched", "xla"])
def test_prefill_and_decode_logits_match_jax(reduced, fusion):
    _, cfg, jm, jparams, tparams = reduced
    prompts = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 16))
    jc = jm.init_cache(2, 32)
    jlogits, jc = jm.prefill(jparams, tokens=jnp.asarray(prompts, jnp.int32),
                             cache=jc)
    mdl = Model(cfg, fusion, device="cpu")
    cache = mdl.init_cache(2, 32)
    logits, _ = mdl.prefill(tparams, _t(prompts), cache)
    # float32 through 2 layers, another summation order
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=2e-4)
    tok = np.array([[3], [7]])
    for pos in (16, 17):
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(tok, jnp.int32),
                                jnp.asarray(pos), kv_len=jnp.asarray(pos + 1))
        tl, _ = mdl.decode_step(tparams, cache, _t(tok), torch.tensor(pos),
                                kv_len=torch.tensor(pos + 1))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=2e-4)
        tok = tok + 1


def test_stitched_post_holds_the_moe_ops(reduced):
    """The serving layer's second half, traced: the router softmax is one
    opaque custom op, the sort, search and scatters opaque aten nodes,
    and nothing else of the graph is left unplanned."""
    _, cfg, _, _, tparams = reduced
    mdl = Model(cfg, device="cpu")
    comp = mdl.post.compiled(tparams["blocks"][0],
                             torch.zeros(2, 8, cfg.d_model),
                             torch.zeros(2, 4, 8, 32),
                             torch.zeros(2, 2, 8, 32),
                             torch.zeros(2, 2, 8, 32))
    prims = {n.prim for n in comp.graph.nodes.values()}
    assert {"repro_torch.softmax.default", "aten.topk.default",
            "aten.sort.stable", "aten.searchsorted.Tensor",
            "aten.scatter.src", "aten.index_put.default",
            "aten.index_select.default"} <= prims
    assert "aten.index_put_.default" not in prims      # out of place
    assert comp.report.n_generated >= 1


def _batch(jcfg, step=0):
    return JSyntheticTokens(JDataConfig(seed=1, global_batch=2, seq_len=16),
                            jcfg).batch_at(step)


@pytest.mark.parametrize("fusion", ["stitched", "xla"])
def test_loss_and_grads_match_jax_value_and_grad(reduced, fusion):
    jcfg, cfg, _, jparams, tparams = reduced
    jm = build_model(jcfg, fusion, remat=False)
    batch = _batch(jcfg)
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch))
    mdl = Model(cfg, fusion, device="cpu")
    loss, grads = loss_and_grads(mdl, tparams,
                                 {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    # the load-balance term is in both losses
    _, aux = mdl.apply_aux(tparams, tokens=_t(batch["tokens"][:, :-1]))
    assert float(aux) > 0
    jg = jax.tree_util.tree_map(np.asarray, jgrads)
    got = {k: jax.tree_util.tree_map(lambda t: t.numpy(), v)
           for k, v in grads.items() if k != "blocks"}
    got["blocks"] = jax.tree_util.tree_map(
        lambda *xs: np.stack(xs),
        *[jax.tree_util.tree_map(lambda t: t.numpy(), b)
          for b in grads["blocks"]])
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(jg)
    for a, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jg)):
        # float32 through 2 layers, another summation order
        np.testing.assert_allclose(a, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-7)


def test_three_train_steps_match_the_reference_trainer(reduced):
    jcfg, cfg, _, _, _ = reduced
    _, jinit, jstep = jbuild_trainer(jcfg, fusion_mode="stitched", lr=1e-3,
                                     total_steps=3)
    jstate = jinit(jax.random.PRNGKey(2))
    _, _, tstep = train.build_trainer(cfg, lr=1e-3, total_steps=3,
                                      device="cpu")
    tparams = from_jax_params(
        jax.tree_util.tree_map(np.asarray, jstate["params"]), device="cpu")
    tstate = {"params": tparams,
              "opt": optim.init(optim.AdamWConfig(), tparams)}
    for step in range(3):
        batch = _batch(jcfg, step)
        jstate = jstep(jstate, batch)
        tstate = tstep(tstate, batch)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(tstep.last_metrics[k],
                                       jstep.last_metrics[k], rtol=1e-5)


def test_serve_and_train_main_run_the_moe_model_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "5", "--gen", "3"])
    train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
                "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "sample:" in out
    assert "step     1 loss=" in out


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_model_names_the_families_it_lacks(family):
    """The ssm and hybrid families are ported: their reduced configs
    build Mamba blocks.  A family the port does not know is named."""
    arch = {"ssm": "mamba2-370m", "hybrid": "zamba2-1.2b"}[family]
    params = Model(get_config(arch).reduced(), device="cpu").init(0)
    assert sorted(params["blocks"][0]) == ["mamba", "norm1"]
    assert ("shared_attn" in params) == (family == "hybrid")
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              family=f"{family}-x")
    with pytest.raises(ValueError, match=f"family '{family}-x'"):
        Model(cfg, device="cpu").init(0)
