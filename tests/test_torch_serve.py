"""The serving slice on the CPU: the port's ``generate`` (stitched mode,
the kernels' plain versions) against the JAX package's ``generate`` on
the same weights, bucketing, compile counts, and the in-place cache."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.serve import generate as jgenerate  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving.buckets import Buckets as JBuckets  # noqa: E402
from repro.serving.buckets import pad_tokens as jpad_tokens  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.layers import STITCHED, XLA  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.buckets import ENV_BUCKETS, Buckets, pad_tokens  # noqa: E402

GEN = 6


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("llama3.2-3b").reduced()
    cfg = get_config("llama3.2-3b").reduced()
    jm = build_model(jcfg, "xla")
    jparams = jm.init(jax.random.PRNGKey(5))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return cfg, jm, jparams, tparams


@pytest.mark.parametrize("S", [5, 13])
def test_generate_matches_jax_generate(setup, S):
    cfg, jm, jparams, tparams = setup
    prompts = np.random.default_rng(S).integers(0, cfg.vocab_size, (2, S))
    want = jgenerate(jm, jparams, prompts.astype(np.int32), GEN,
                     stitched=False)
    got = serve.generate(Model(cfg, device="cpu"), tparams, prompts, GEN)
    assert got.shape == (2, S + GEN)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("fusion", ["stitched", "xla"])
def test_prefill_logits_match_jax(setup, fusion):
    cfg, jm, jparams, tparams = setup
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 13))
    padded = pad_tokens(prompts, 16)
    jlogits, _ = jm.prefill(jparams, tokens=jnp.asarray(padded, jnp.int32),
                            cache=jm.init_cache(2, 32))
    mdl = Model(cfg, fusion, device="cpu")
    logits, _ = mdl.prefill(tparams, torch.from_numpy(padded),
                            mdl.init_cache(2, 32))
    # float32 through 2 layers, another summation order
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=2e-4)


def test_decode_logits_match_jax(setup):
    cfg, jm, jparams, tparams = setup
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 8))
    jc = jm.init_cache(2, 16)
    _, jc = jm.prefill(jparams, tokens=jnp.asarray(prompts, jnp.int32),
                       cache=jc)
    mdl = Model(cfg, device="cpu")
    cache = mdl.init_cache(2, 16)
    mdl.prefill(tparams, torch.from_numpy(prompts), cache)
    tok = np.array([[3], [7]])
    for pos in (8, 9):
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(tok, jnp.int32),
                                jnp.asarray(pos), kv_len=jnp.asarray(pos + 1))
        tl, _ = mdl.decode_step(tparams, cache, torch.from_numpy(tok),
                                torch.tensor(pos),
                                kv_len=torch.tensor(pos + 1))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=2e-4)
        tok = tok + 1


def test_decode_compiles_once_and_prefill_once_per_bucket(setup):
    cfg, _, _, tparams = setup
    mdl = Model(cfg, device="cpu")
    rng = np.random.default_rng(3)

    def run(S):
        serve.generate(mdl, tparams, rng.integers(0, cfg.vocab_size, (2, S)),
                       GEN)
        return (mdl.pre.n_compiled, mdl.post.n_compiled,
                mdl.logits_head.n_compiled)

    # prompt bucket 8, cache bucket 16: one prefill and one decode
    # signature each, across 5 decode steps
    assert run(5) == (2, 2, 2)
    assert run(7) == (2, 2, 2)          # same buckets: nothing re-traced
    assert run(9) == (3, 3, 3)          # prompt bucket 16: one more prefill


def test_cache_is_written_in_place(setup):
    cfg, _, _, tparams = setup
    mdl = Model(cfg, device="cpu")
    cache = mdl.init_cache(2, 16)
    ptrs = (cache["k"].data_ptr(), cache["v"].data_ptr())
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 8)))
    _, out = mdl.prefill(tparams, tokens, cache)
    assert out is cache
    assert cache["k"][:, :, :, :8].abs().sum() > 0
    assert cache["k"][:, :, :, 8:].abs().sum() == 0
    tok = tokens[:, -1:]
    for pos in range(8, 11):
        _, out = mdl.decode_step(tparams, cache, tok, torch.tensor(pos),
                                 kv_len=torch.tensor(pos + 1))
        assert out is cache
        assert (cache["k"].data_ptr(), cache["v"].data_ptr()) == ptrs
        assert cache["v"][:, :, :, pos].abs().sum() > 0
    assert cache["k"][:, :, :, 11:].abs().sum() == 0


@pytest.mark.parametrize("fm", [STITCHED, XLA], ids=lambda f: f.name)
def test_decode_ignores_cache_rows_past_kv_len(setup, fm):
    """A decode step at position ``pos`` reads the cache rows 0..pos only:
    rows past it (stale or never written) leave its logits unchanged."""
    cfg, _, _, tparams = setup
    mdl = Model(cfg, fm.name, device="cpu")
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    clean = mdl.init_cache(2, 16)
    mdl.prefill(tparams, tokens, clean)
    stale = {k: v.clone() for k, v in clean.items()}
    for v in stale.values():
        v[:, :, :, 9:] = torch.from_numpy(
            1e3 * rng.standard_normal(v[:, :, :, 9:].shape).astype(np.float32))
    tok, pos = tokens[:, -1:], torch.tensor(8)
    want, _ = mdl.decode_step(tparams, clean, tok, pos, kv_len=pos + 1)
    got, _ = mdl.decode_step(tparams, stale, tok, pos, kv_len=pos + 1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(stale["k"][:, :, :, :9], clean["k"][:, :, :, :9],
                               rtol=0, atol=0)


@pytest.mark.parametrize("spec", ["", "16,48,128", "100"])
def test_buckets_match_the_reference(monkeypatch, spec):
    monkeypatch.setenv(ENV_BUCKETS, spec)
    ours, theirs = Buckets.from_env(), JBuckets.from_env()
    for n in range(1, 301):
        assert ours.bucket(n) == theirs.bucket(n), n
        assert ours.pad_len(n, cap=256) == theirs.pad_len(n, cap=256), n
    toks = np.arange(10).reshape(2, 5)
    np.testing.assert_array_equal(pad_tokens(toks, 8), jpad_tokens(toks, 8))


def test_serve_main_runs_on_the_cpu(capsys):
    serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                "--prompt-len", "5", "--gen", "3"])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "sample:" in out


def test_layer_loop_reuses_one_compiled_block(setup):
    cfg, _, _, tparams = setup
    mdl = Model(cfg, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 8)))
    mdl.prefill(tparams, tokens, mdl.init_cache(2, 8))
    assert cfg.n_layers == 2
    assert (mdl.pre.n_compiled, mdl.post.n_compiled) == (1, 1)
    comp = mdl.post.compiled(tparams["blocks"][0],
                             torch.zeros(2, 8, cfg.d_model),
                             torch.zeros(2, 4, 8, 32),
                             torch.zeros(2, 2, 8, 32),
                             torch.zeros(2, 2, 8, 32))
    assert any(n.prim == "repro_torch.flash_attention.default"
               for n in comp.graph.nodes.values())
