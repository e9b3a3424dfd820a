"""The training slice on the CPU, against the JAX package.

Each module of the train path is fed the same numpy inputs as its
counterpart in ``repro`` (Pallas in interpret mode, as the JAX package's
own tests run it): the LayerNorm kernels' plain versions and operators,
the gradients of the ``ops`` wrappers against ``jax.vjp``, AdamW against
``repro.optim.apply``, the synthetic batches bit for bit, and the whole
slice -- the reduced HuBERT (with a padded vocabulary) and Llama losses
and gradients against ``jax.value_and_grad(mdl.loss)``, and three steps
of ``build_trainer`` on both sides.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticTokens as JSyntheticTokens  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.layernorm import _ln_bwd as j_ln_bwd  # noqa: E402
from repro.kernels.layernorm import layernorm_fwd as jlayernorm_fwd  # noqa: E402
from repro.launch.train import build_trainer as jbuild_trainer  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticTokens  # noqa: E402
from repro_torch.kernels import layernorm as LN  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import loss_and_grads, make_train_step  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

rng = np.random.default_rng(13)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# LayerNorm: the plain versions and the operators against the Pallas kernels
# ---------------------------------------------------------------------------
LN_SHAPES = {"hubert-rows": (2048, 1280), "ragged-rank3": (3, 37, 200)}


def _ln_inputs(shape):
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    g = rng.standard_normal(shape[-1]).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, g, b, dy


@pytest.mark.parametrize("name", sorted(LN_SHAPES))
def test_layernorm_forward_matches_the_pallas_kernel(name):
    x, g, b, _ = _ln_inputs(LN_SHAPES[name])
    # block_rows 16: 111 rows of the rank-3 case leave a ragged last block
    jy, (jm, jr) = jlayernorm_fwd(jnp.asarray(x), jnp.asarray(g),
                                  jnp.asarray(b), eps=1e-6, block_rows=16,
                                  interpret=True)
    before = LN.layernorm_cuda.launches
    for fn in (LN.layernorm_plain, LN.layernorm):
        y, mean, rstd = fn(_t(x), _t(g), _t(b), 1e-6)
        assert y.shape == x.shape
        assert mean.shape == rstd.shape == (x.size // x.shape[-1], 1)
        assert mean.dtype == rstd.dtype == torch.float32
        # float32, the same formula in another summation order
        for got, want in ((y, jy), (mean, jm), (rstd, jr)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
    assert LN.layernorm_cuda.launches == before   # the plain version ran


@pytest.mark.parametrize("name", sorted(LN_SHAPES))
def test_layernorm_backward_matches_the_pallas_kernel(name):
    x, g, b, dy = _ln_inputs(LN_SHAPES[name])
    C = x.shape[-1]
    _, (jm, jr) = jlayernorm_fwd(jnp.asarray(x), jnp.asarray(g),
                                 jnp.asarray(b), eps=1e-6, interpret=True)
    jdx, jdg, jdb = j_ln_bwd(jnp.asarray(x.reshape(-1, C)), jnp.asarray(g),
                             jm, jr, jnp.asarray(dy.reshape(-1, C)),
                             block_rows=16, interpret=True)
    before = LN.layernorm_bwd_cuda.launches
    for fn in (LN.layernorm_bwd_plain, LN.layernorm_bwd):
        dx, dg, db = fn(_t(x), _t(g), _t(np.asarray(jm)), _t(np.asarray(jr)),
                        _t(dy))
        assert dx.shape == x.shape and dg.shape == db.shape == (C,)
        np.testing.assert_allclose(dx.numpy().reshape(-1, C),
                                   np.asarray(jdx), rtol=1e-5, atol=1e-5)
        # sums over up to 2048 rows, in another order
        for got, want in ((dg, jdg), (db, jdb)):
            want = np.asarray(want)
            tol = 1e-4 * max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    assert LN.layernorm_bwd_cuda.launches == before


def test_layernorm_operator_ignores_the_statistics_gradients():
    x, g, b, dy = (_t(a) for a in _ln_inputs((6, 64)))
    xs = [t.clone().requires_grad_() for t in (x, g, b)]
    y, mean, rstd = LN.layernorm(*xs, 1e-6)
    # gradients arriving for mean and rstd do not reach the inputs
    grads = torch.autograd.grad((y * dy).sum() + mean.sum() + rstd.sum(), xs)
    want = torch.autograd.grad((LN.layernorm(*xs, 1e-6)[0] * dy).sum(), xs)
    for a, w in zip(grads, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)


def test_layernorm_is_one_node_with_grad_inputs():
    x, g, b = (torch.randn(s, requires_grad=True) for s in ((6, 64), 64, 64))
    gm = make_fx(lambda a, c, d: ops.layernorm(a, c, d, 1e-6) * 2.0,
                 tracing_mode="fake")(x, g, b)
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"
             and str(n.target).startswith("repro_torch.layernorm")]
    assert len(nodes) == 1


def test_cuda_wrappers_refuse_cpu_tensors():
    x, g, b, dy = (_t(a) for a in _ln_inputs((4, 32)))
    with pytest.raises(ValueError, match="CUDA"):
        LN.layernorm_cuda(x, g, b, 1e-6)
    _, m, r = LN.layernorm_plain(x, g, b, 1e-6)
    with pytest.raises(ValueError, match="CUDA"):
        LN.layernorm_bwd_cuda(x, g, m, r, dy)


# ---------------------------------------------------------------------------
# gradients of the ops wrappers against jax.vjp of the reference's ops
# ---------------------------------------------------------------------------
def _vjp_both(jfn, tfn, args, cot):
    _, pullback = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    want = pullback(jnp.asarray(cot))
    targs = [_t(a).requires_grad_() for a in args]
    got = torch.autograd.grad(tfn(*targs), targs, _t(cot))
    return got, want


def _close_grads(got, want, rtol=1e-5, atol=1e-5):
    for a, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=rtol,
                                   atol=atol * max(1.0, np.abs(w).max()))


def test_layernorm_grad_matches_jax_vjp():
    x, g, b, dy = _ln_inputs((3, 24, 160))
    got, want = _vjp_both(
        lambda a, c, d: jops.layernorm(a, c, d, 1e-6),
        lambda a, c, d: ops.layernorm(a, c, d, 1e-6), (x, g, b), dy)
    # dgamma and dbeta sum over 72 rows
    _close_grads(got, want, rtol=1e-4)


def test_rmsnorm_grad_matches_jax_vjp():
    x, g, _, dy = _ln_inputs((5, 96))
    got, want = _vjp_both(lambda a, c: jops.rmsnorm(a, c, 1e-6),
                          lambda a, c: ops.rmsnorm(a, c, 1e-6), (x, g), dy)
    _close_grads(got, want, rtol=1e-4)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_attention_grad_matches_jax_vjp(causal):
    B, Hq, Hkv, S, D = 2, 4, 2, 24, 16   # GQA: two query heads a KV head
    q = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    do = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    got, want = _vjp_both(
        lambda a, c, d: jops.attention(a, c, d, causal=causal, block_q=8,
                                       block_k=8),
        lambda a, c, d: ops.attention(a, c, d, causal=causal), (q, k, v), do)
    _close_grads(got, want)


# ---------------------------------------------------------------------------
# AdamW and the synthetic data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bf16,ef", [(False, False), (True, False),
                                     (True, True)],
                         ids=["f32", "bf16", "bf16-error-feedback"])
def test_adamw_matches_the_reference(bf16, ef):
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=1.0,
                  bf16_grads=bf16, error_feedback=ef)
    jcfg, tcfg = joptim.AdamWConfig(**cfg_kw), optim.AdamWConfig(**cfg_kw)
    shapes = {"w": (16, 8), "layers": [{"g": (8,)}, {"g": (8,)}]}
    p_np = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p_np), \
        jax.tree_util.tree_map(_t, p_np)
    js, ts = joptim.init(jcfg, jp), optim.init(tcfg, tp)
    for step in range(4):
        # steps 0 and 2 clip (global norm about 4), 1 and 3 do not (0.04)
        scale = 0.3 if step % 2 == 0 else 0.003
        g_np = jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(p.shape) * scale).astype(
                np.float32), p_np)
        jg, js = joptim.compress_grads(
            jcfg, jax.tree_util.tree_map(jnp.asarray, g_np), js)
        tg, ts = optim.compress_grads(
            tcfg, jax.tree_util.tree_map(_t, g_np), ts)
        jp, js, jm = joptim.apply(jcfg, jp, jg, js)
        tp, ts, tm = optim.apply(tcfg, tp, tg, ts)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        for tree in ("p", "m", "v"):
            j = jp if tree == "p" else js[tree]
            t = tp if tree == "p" else ts[tree]
            for a, w in zip(jax.tree_util.tree_leaves(t),
                            jax.tree_util.tree_leaves(j)):
                np.testing.assert_allclose(np.asarray(a), np.asarray(w),
                                           rtol=1e-6, atol=1e-6)
        assert int(ts["step"]) == int(js["step"]) == step + 1


@pytest.mark.parametrize("arch", ["hubert-xlarge", "llama3.2-3b"])
def test_synthetic_batches_equal_the_reference_bit_for_bit(arch):
    kw = dict(seed=3, global_batch=4, seq_len=12)
    j = JSyntheticTokens(JDataConfig(**kw), jget_config(arch).reduced())
    t = SyntheticTokens(DataConfig(**kw), get_config(arch).reduced())
    for step in (0, 5):
        jb, tb = j.batch_at(step), t.batch_at(step)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])
    assert t.next_batch().keys() == j.next_batch().keys()


# ---------------------------------------------------------------------------
# the whole slice: loss, gradients and train steps against the JAX model
# ---------------------------------------------------------------------------
SLICE = {"hubert-vocab504": ("hubert-xlarge", {"vocab_size": 504}),
         "llama": ("llama3.2-3b", {})}


def _configs(name):
    arch, over = SLICE[name]
    return jget_config(arch).reduced(**over), get_config(arch).reduced(**over)


def _batch(jcfg, step=0):
    return JSyntheticTokens(JDataConfig(seed=1, global_batch=2, seq_len=16),
                            jcfg).batch_at(step)


def _port_blocks_stacked(tree):
    """The port's per-layer list of block dicts as the JAX package's
    stacked tree of numpy arrays."""
    blocks = tree["blocks"]
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs),
                                  *[jax.tree_util.tree_map(
                                      lambda t: t.numpy(), b)
                                    for b in blocks])


@pytest.mark.parametrize("fusion", ["stitched", "xla"])
@pytest.mark.parametrize("name", sorted(SLICE))
def test_loss_and_grads_match_jax_value_and_grad(name, fusion):
    jcfg, cfg = _configs(name)
    jm = build_model(jcfg, fusion, remat=False)
    jparams = jm.init(jax.random.PRNGKey(11))
    batch = _batch(jcfg)
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch))
    mdl = Model(cfg, fusion, device="cpu")
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    loss, grads = loss_and_grads(mdl, tparams,
                                 {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jg = jax.tree_util.tree_map(np.asarray, jgrads)
    got = {k: jax.tree_util.tree_map(lambda t: t.numpy(), v)
           for k, v in grads.items() if k != "blocks"}
    got["blocks"] = _port_blocks_stacked(grads)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(jg)
    for a, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jg)):
        # float32 through 2 layers, another summation order
        np.testing.assert_allclose(a, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-7)


def test_pad_columns_are_masked():
    jcfg, cfg = _configs("hubert-vocab504")
    mdl = Model(cfg, device="cpu")
    params = mdl.init(0)
    frames = _t(_batch(jcfg)["frames"])
    logits = mdl.apply(params, frames=frames)
    assert logits.shape[-1] == cfg.padded_vocab == 512
    assert (logits[..., cfg.vocab_size:] == -1e30).all()
    assert (logits[..., :cfg.vocab_size] > -1e3).all()


@pytest.mark.parametrize("name", sorted(SLICE))
def test_three_train_steps_match_the_reference_trainer(name):
    jcfg, cfg = _configs(name)
    jm, jinit, jstep = jbuild_trainer(jcfg, fusion_mode="stitched", lr=1e-3,
                                      total_steps=3)
    jstate = jinit(jax.random.PRNGKey(2))
    mdl, _, tstep = train.build_trainer(cfg, lr=1e-3, total_steps=3,
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


def test_microbatched_step_accumulates_like_one_batch():
    _, cfg = _configs("hubert-vocab504")
    mdl = Model(cfg, device="cpu")
    params = mdl.init(0)
    opt_cfg = optim.AdamWConfig(lr=1e-3)
    batch = {k: _t(v) for k, v in _batch(
        jget_config("hubert-xlarge").reduced(vocab_size=504)).items()}
    outs = [make_train_step(mdl, opt_cfg, microbatches=n)(
        params, optim.init(opt_cfg, params), batch) for n in (1, 2)]
    (p1, _, m1), (p2, _, m2) = outs
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    for a, b in zip(torch.utils._pytree.tree_leaves(p1),
                    torch.utils._pytree.tree_leaves(p2)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "llama3.2-3b"])
def test_train_main_runs_on_the_cpu(arch, capsys):
    train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps",
                "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "step     1 loss=" in out
