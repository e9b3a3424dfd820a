"""The whole slice: the port's ``Model.forward`` on the reduced 2-layer
Llama config against the JAX ``Model`` built with ``fusion_mode="xla"``,
on the same weights (carried over by ``repro_torch.models.convert``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import V5E  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

B, S = 2, 16


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("llama3.2-3b").reduced()
    cfg = get_config("llama3.2-3b").reduced()
    assert cfg == cfg.__class__(**{f: getattr(jcfg, f)
                                   for f in cfg.__dataclass_fields__})
    jm = JModel(jcfg, fusion_mode="xla")
    jparams = jm.init(jax.random.PRNGKey(7))
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S))
    jlogits, _, _ = jm.apply(jparams, tokens=jnp.asarray(tokens))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return cfg, tparams, torch.from_numpy(tokens), np.asarray(jlogits)


@pytest.mark.parametrize("hw", ["h100", "v5e"])
def test_forward_matches_jax_model(setup, hw):
    cfg, params, tokens, jlogits = setup
    kw = {} if hw == "h100" else {"hw": V5E}
    model = Model(cfg, "xla", device="cpu", **kw)
    logits, probs = model.forward(params, tokens)
    assert logits.shape == (B, S, cfg.padded_vocab)
    # float32 through 2 layers of matmuls, norms and softmaxes, another
    # summation order: atol 2e-4 on logits of magnitude ~1
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=1e-4,
                               atol=2e-4)
    assert (logits.argmax(-1).numpy() == jlogits.argmax(-1)).all()
    ref = jax.nn.softmax(jnp.asarray(jlogits), axis=-1)
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref), atol=1e-6)


def test_forward_compiles_the_block_once(setup):
    cfg, params, tokens, _ = setup
    model = Model(cfg, "xla", device="cpu")
    model.forward(params, tokens)
    model.forward(params, tokens)
    assert model.block.n_compiled == 1 and model.head.n_compiled == 1


def test_head_softmax_streams_and_block_generates_kernels(setup):
    cfg, params, tokens, _ = setup
    model = Model(cfg, "xla", device="cpu")
    h = params["embed"][tokens]
    block = model.block.report(params["blocks"][0], h, torch.arange(S))
    head = model.head.report({"final_norm": params["final_norm"],
                              "lm_head": params["lm_head"]}, h)
    assert block.n_generated >= 1
    assert "streaming" in head.schedules or "onepass" in head.schedules


def test_seeded_init_is_deterministic():
    cfg = get_config("llama3.2-3b").reduced()
    model = Model(cfg, "xla", device="cpu")
    a, b = model.init(3), model.init(3)
    torch.testing.assert_close(a["blocks"][1]["mlp"]["w_up"],
                               b["blocks"][1]["mlp"]["w_up"])
    assert not torch.equal(model.init(4)["lm_head"], a["lm_head"])
