"""The reference's four dense and vision-language configs in the port,
against the JAX package at the reduced size (2 layers, d_model 128, 4
query heads of 32, 2 KV heads, vocab 512; the vision stub 8 rows).

* Gemma-7B, Mistral-NeMo-12B, InternVL2-26B and DeepSeek-67B: the
  config's fields; the forward logits (``apply``); ``make_prefill_step``
  then two ``make_decode_step`` steps, logits and cache rows; the
  weights carried over by ``models/convert.py``.
* InternVL2-26B's vision splice (``vision_embeds`` as the first rows)
  through ``apply``, ``loss`` and ``make_prefill_step``.
* HuBERT-XLarge's ``make_prefill_step`` with ``frames``: logits and the
  non-causal prompt's cache, against the reference's ``{"attn": {"k",
  "v"}}``.
* ``batch_specs``: keys, shapes and dtypes against the reference's for
  all ten configs and four cells.

Both packages run float32 on the same numpy inputs and weights; the JAX
model is built with ``fusion_mode="xla"`` (plain ``jnp``), the port's in
its default ``"stitched"`` mode, whose kernels run their plain versions
on the CPU.  Tolerance: rtol 1e-4, atol 2e-4 on logits of magnitude ~1
(two layers of float32 products summed in another order); the cache
rows 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as J  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import configs as T  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

NEW = ["gemma-7b", "mistral-nemo-12b", "internvl2-26b", "deepseek-67b"]
B, S, MAX_LEN = 2, 12, 16
RTOL, ATOL = 1e-4, 2e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=NEW)
def reduced(request):
    """(arch, jcfg, cfg, JAX model, JAX params, the port's params)."""
    arch = request.param
    jcfg, cfg = J.get_config(arch).reduced(), T.get_config(arch).reduced()
    jm = build_model(jcfg, "xla", remat=False)
    jparams = jm.init(jax.random.PRNGKey(11))
    return arch, jcfg, cfg, jm, jparams, from_jax_params(_np(jparams),
                                                         device="cpu")


def _tokens(cfg, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _vision(cfg, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)


def _leaf_table(tree) -> dict:
    """{key path: (shape, dtype)} of a param tree, key order aside."""
    flat, _ = torch.utils._pytree.tree_flatten_with_path(tree)
    return {torch.utils._pytree.keystr(k): (tuple(t.shape), t.dtype)
            for k, t in flat}


@pytest.mark.parametrize("arch", NEW)
def test_the_config_is_the_references(arch):
    got, want = T.get_config(arch), J.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())
    assert (got.padded_vocab, got.resolved_head_dim) == \
        (want.padded_vocab, want.resolved_head_dim)


def test_arch_ids_are_the_references_ten():
    assert T.ARCH_IDS == J.ARCH_IDS and len(T.ARCH_IDS) == 10
    assert list(T.all_configs()) == list(J.all_configs())


def test_forward_logits_match_the_reference(reduced):
    arch, _, cfg, jm, jparams, tparams = reduced
    tokens = _tokens(cfg, 1)
    jl, _, _ = jm.apply(jparams, tokens=jnp.asarray(tokens, jnp.int32))
    got = Model(cfg, device="cpu").apply(tparams, _t(tokens))
    assert got.shape == (B, S, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)


def test_prefill_then_two_decode_steps_match_the_reference(reduced):
    """``make_prefill_step`` over S tokens into a MAX_LEN-row cache (a
    vision model's first rows spliced), then ``make_decode_step`` at
    kv_len S + 1 (the rows written) and at MAX_LEN (the whole cache, the
    rows never written attended as zeros)."""
    arch, jcfg, cfg, jm, jparams, tparams = reduced
    tokens = _tokens(cfg, 2)
    jb = {"tokens": jnp.asarray(tokens, jnp.int32)}
    tb = {"tokens": _t(tokens)}
    if cfg.frontend == "vision":
        ve = _vision(cfg, 3)
        jb["vision_embeds"], tb["vision_embeds"] = jnp.asarray(ve), _t(ve)
    jl, jc = jsteps.make_prefill_step(jm)(jparams, jb,
                                          jm.init_cache(B, MAX_LEN))
    mdl = Model(cfg, device="cpu")
    cache = mdl.init_cache(B, MAX_LEN)
    tl, out = steps.make_prefill_step(mdl)(tparams, tb, cache)
    assert out is cache
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    tok = tl[:, -1:, :cfg.vocab_size].argmax(-1)
    for pos, kv_len in ((S, S + 1), (S + 1, MAX_LEN)):
        jl, jc = jsteps.make_decode_step(jm, kv_len)(
            jparams, jc, jnp.asarray(tok.numpy(), jnp.int32), pos)
        tl, cache = steps.make_decode_step(mdl, kv_len)(tparams, cache, tok,
                                                        pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
        tok = tl[:, -1:, :cfg.vocab_size].argmax(-1)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jc["attn"][name]), rtol=1e-5,
                                   atol=1e-5)
    assert cache["k"][:, :, :, :S + 2].abs().sum(-1).min() > 0
    assert cache["k"][:, :, :, S + 2:].abs().sum() == 0


def test_convert_carries_every_leaf(reduced):
    """``from_jax_params`` gives the tree ``Model.init`` makes: the same
    keys, one dict a layer, every leaf of the same shape and dtype, and
    the values of the reference's stacked layer i in layer i."""
    arch, _, cfg, _, jparams, tparams = reduced
    for dt in (torch.float32, torch.bfloat16):
        own = Model(cfg, device="cpu", param_dtype=dt).init(0)
        carried = tparams if dt == torch.float32 else from_jax_params(
            _np(jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                       jparams)), device="cpu")
        assert _leaf_table(carried) == _leaf_table(own)
    wq = np.asarray(jparams["blocks"]["attn"]["wq"])
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(
            tparams["blocks"][i]["attn"]["wq"].numpy(), wq[i])


# ---------------------------------------------------------------------------
# the vision splice
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def vlm():
    jcfg = J.get_config("internvl2-26b").reduced()
    cfg = T.get_config("internvl2-26b").reduced()
    jm = build_model(jcfg, "xla", remat=False)
    jparams = jm.init(jax.random.PRNGKey(12))
    return cfg, jm, jparams, from_jax_params(_np(jparams), device="cpu")


def test_the_splice_replaces_the_first_rows(vlm):
    cfg, _, _, tparams = vlm
    mdl = Model(cfg, device="cpu")
    tokens, ve = _t(_tokens(cfg, 4)), _t(_vision(cfg, 5))
    h = mdl._embed(tparams, tokens, vision_embeds=ve)
    nv = cfg.n_vision_tokens
    torch.testing.assert_close(h[:, :nv], ve, rtol=0, atol=0)
    torch.testing.assert_close(h[:, nv:], tparams["embed"][tokens[:, nv:]],
                               rtol=0, atol=0)
    bf = Model(cfg, device="cpu", param_dtype=torch.bfloat16)
    hb = bf._embed(bf.init(0), tokens, vision_embeds=ve)
    assert hb.dtype == torch.bfloat16
    torch.testing.assert_close(hb[:, :nv], ve.to(torch.bfloat16), rtol=0,
                               atol=0)


def test_the_splice_through_apply_and_loss(vlm):
    cfg, jm, jparams, tparams = vlm
    tokens, ve = _tokens(cfg, 6, (B, S + 1)), _vision(cfg, 7)
    jl, _, _ = jm.apply(jparams, tokens=jnp.asarray(tokens[:, :-1], jnp.int32),
                        vision_embeds=jnp.asarray(ve))
    mdl = Model(cfg, device="cpu")
    tl = mdl.apply(tparams, _t(tokens[:, :-1]), vision_embeds=_t(ve))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    plain = mdl.apply(tparams, _t(tokens[:, :-1]))
    assert not torch.allclose(tl, plain, atol=1e-2)  # the splice is used
    jloss = jm.loss(jparams, {"tokens": jnp.asarray(tokens, jnp.int32),
                              "vision_embeds": jnp.asarray(ve)})
    tloss = mdl.loss(tparams, {"tokens": _t(tokens),
                               "vision_embeds": _t(ve)})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_the_splice_through_prefill(vlm):
    """``Model.prefill`` with ``vision_embeds`` against the reference's,
    and its cache rows: the spliced rows' keys and values are written."""
    cfg, jm, jparams, tparams = vlm
    tokens, ve = _tokens(cfg, 8), _vision(cfg, 9)
    jl, jc = jm.prefill(jparams, tokens=jnp.asarray(tokens, jnp.int32),
                        cache=jm.init_cache(B, MAX_LEN),
                        vision_embeds=jnp.asarray(ve))
    mdl = Model(cfg, device="cpu")
    cache = mdl.init_cache(B, MAX_LEN)
    tl, _ = mdl.prefill(tparams, _t(tokens), cache, vision_embeds=_t(ve))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jc["attn"][name]), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the audio prompt with a cache
# ---------------------------------------------------------------------------
def test_encoder_prefill_with_frames_matches_the_reference():
    """HuBERT's prompt through ``make_prefill_step``: ``frames`` in, the
    logits and the cache of a non-causal prompt (every row sees every
    other: a later frame moves an earlier row's logits)."""
    jcfg = J.get_config("hubert-xlarge").reduced()
    cfg = T.get_config("hubert-xlarge").reduced()
    jm = build_model(jcfg, "xla", remat=False)
    jparams = jm.init(jax.random.PRNGKey(13))
    tparams = from_jax_params(_np(jparams), device="cpu")
    frames = np.random.default_rng(14).standard_normal(
        (B, S, cfg.frontend_dim)).astype(np.float32)
    jl, jc = jsteps.make_prefill_step(jm)(
        jparams, {"frames": jnp.asarray(frames)}, jm.init_cache(B, MAX_LEN))
    mdl = Model(cfg, device="cpu")
    cache = mdl.init_cache(B, MAX_LEN)
    tl, _ = steps.make_prefill_step(mdl)(tparams, {"frames": _t(frames)},
                                         cache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    assert set(jc) == {"attn"} and set(jc["attn"]) == {"k", "v"}
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == jc["attn"][name].shape
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jc["attn"][name]), rtol=1e-5,
                                   atol=1e-5)
    moved = frames.copy()
    moved[:, -1] += 1.0
    tl2, _ = steps.make_prefill_step(mdl)(
        tparams, {"frames": _t(moved)}, mdl.init_cache(B, MAX_LEN))
    assert not torch.allclose(tl2[:, 0], tl[:, 0], atol=1e-4)


# ---------------------------------------------------------------------------
# batch_specs
# ---------------------------------------------------------------------------
_DTYPES = {jnp.dtype(jnp.int32): torch.int32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16,
           jnp.dtype(jnp.float32): torch.float32}


@pytest.mark.parametrize("arch", T.ARCH_IDS)
@pytest.mark.parametrize("cell", list(T.SHAPES))
def test_batch_specs_are_the_references(arch, cell):
    cfg, jcfg = T.get_config(arch), J.get_config(arch)
    want = jsteps.batch_specs(jcfg, J.SHAPES[cell])
    got = steps.batch_specs(cfg, T.SHAPES[cell])
    assert list(got) == list(want)
    for k, spec in want.items():
        assert tuple(got[k].shape) == tuple(spec.shape), k
        assert got[k].dtype == _DTYPES[jnp.dtype(spec.dtype)], k
        assert got[k].device.type == "meta"
    f32 = steps.batch_specs(cfg, T.SHAPES[cell], torch.float32, batch=3)
    jf32 = jsteps.batch_specs(jcfg, J.SHAPES[cell], jnp.float32)
    for k, spec in jf32.items():
        assert tuple(f32[k].shape) == (3,) + tuple(spec.shape)[1:]
        assert f32[k].dtype == _DTYPES[jnp.dtype(spec.dtype)]
