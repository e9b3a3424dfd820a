"""``remat`` and ``remat_policy`` on the port's ``Model`` (CPU).

The reference wraps each scanned layer in ``jax.checkpoint`` when it
trains (``src/repro/models/model.py:169-172``); the port runs each layer
under ``torch.utils.checkpoint``.  The loss and gradients are those
without remat ("full", "dots" and "none"; float32, within 1e-6
relative), they hold the reference's ``jax.value_and_grad`` of a
``Model(remat=True)`` at the train slice's tolerance, the recompute runs
the layer's kernels a second time in the backward, and nothing is
recomputed under ``no_grad``, with a cache, or for the hybrid.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticTokens as JSyntheticTokens  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402

ARCHS = ("llama3.2-3b", "granite-moe-1b-a400m", "mamba2-370m",
         "hubert-xlarge")


def _batch(arch, step=0):
    return JSyntheticTokens(JDataConfig(seed=1, global_batch=2, seq_len=16),
                            jget_config(arch).reduced()).batch_at(step)


def _tbatch(arch):
    return {k: torch.from_numpy(np.array(v)) for k, v in _batch(arch).items()}


def _grads(arch, **kw):
    cfg = get_config(arch).reduced()
    mdl = Model(cfg, device="cpu", **kw)
    params = Model(cfg, device="cpu").init(3)
    return loss_and_grads(mdl, params, _tbatch(arch))


@pytest.mark.parametrize("policy", M.REMAT_POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_loss_and_gradients_without_it(arch, policy):
    loss, grads = _grads(arch, remat=True, remat_policy=policy)
    loss0, grads0 = _grads(arch, remat=False)
    np.testing.assert_allclose(float(loss), float(loss0), rtol=1e-6)
    for g, g0 in zip(tree_leaves(grads), tree_leaves(grads0)):
        scale = float(g0.abs().max())
        assert float((g - g0).abs().max()) <= 1e-6 * max(scale, 1e-30)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-1b-a400m"])
def test_remat_holds_the_references_value_and_grad(arch, policy):
    """``jax.value_and_grad(Model(remat=True, remat_policy=...).loss)``
    against the port's remat step: the train slice's tolerances (loss
    1e-5 relative; gradients 1e-4 of each leaf's largest value)."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jm = jbuild_model(jcfg, remat=True, remat_policy=policy)
    jparams = jm.init(jax.random.PRNGKey(11))
    batch = _batch(arch)
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch))
    mdl = Model(cfg, device="cpu", remat=True, remat_policy=policy)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    loss, grads = loss_and_grads(mdl, tparams, _tbatch(arch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jg = jax.tree_util.tree_map(np.asarray, jgrads)
    for k in ("embed", "final_norm", "lm_head"):
        for a, w in zip(tree_leaves(grads[k]), jax.tree_util.tree_leaves(
                jg[k])):
            np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max() + 1e-7)
    for i, blk in enumerate(grads["blocks"]):
        want = jax.tree_util.tree_map(lambda x: x[i], jg["blocks"])
        for a, w in zip(tree_leaves(blk), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max() + 1e-7)


def _count(monkeypatch, obj, name):
    calls = []
    fn = getattr(obj, name)

    def counted(*a, **k):
        calls.append(torch.is_grad_enabled())
        return fn(*a, **k)

    monkeypatch.setattr(obj, name, counted)
    return calls


@pytest.mark.parametrize("remat,policy,per_layer", [
    (False, "full", 2), (True, "none", 2), (True, "full", 4),
    (True, "dots", 4)])
def test_the_recompute_runs_each_norm_again(monkeypatch, remat, policy,
                                            per_layer):
    """Two RMSNorms a Llama layer: run once in the forward, and once more
    in the backward where the layer is recomputed."""
    cfg = get_config("llama3.2-3b").reduced()
    norms = _count(monkeypatch, RN, "rmsnorm_plain")
    mdl = Model(cfg, device="cpu", remat=remat, remat_policy=policy)
    loss_and_grads(mdl, mdl.init(0), _tbatch("llama3.2-3b"))
    assert len(norms) == per_layer * cfg.n_layers + 1


def test_dots_saves_the_two_dimensional_products():
    assert M._dots_policy(None, torch.ops.aten.mm.default) \
        == M.CheckpointPolicy.MUST_SAVE
    assert M._dots_policy(None, torch.ops.aten.addmm.default) \
        == M.CheckpointPolicy.MUST_SAVE
    assert M._dots_policy(None, torch.ops.aten.bmm.default) \
        == M.CheckpointPolicy.PREFER_RECOMPUTE


def test_no_remat_under_no_grad_with_a_cache_or_for_the_hybrid(monkeypatch):
    calls = _count(monkeypatch, M, "checkpoint")
    cfg = get_config("llama3.2-3b").reduced()
    mdl = Model(cfg, device="cpu")
    params = mdl.init(0)
    tokens = _tbatch("llama3.2-3b")["tokens"][:, :8]
    with torch.no_grad():
        mdl.apply(params, tokens=tokens)
        assert not mdl.remats()
    with torch.enable_grad():
        cache = mdl.init_cache(2, 16)
        mdl.prefill(params, tokens, cache)
        mdl.decode_step(params, cache, tokens[:, :1], 8,
                        kv_len=torch.tensor(9))
    assert calls == []
    hyb = Model(get_config("zamba2-1.2b").reduced(), device="cpu")
    loss_and_grads(hyb, hyb.init(0), _tbatch("zamba2-1.2b"))
    assert calls == [] and not hyb.remats()
    mdl.apply(params, tokens=tokens)          # grad enabled: one a layer
    assert len(calls) == cfg.n_layers
