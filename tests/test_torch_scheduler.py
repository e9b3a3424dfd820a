"""The continuous-batching scheduler on the CPU, against the JAX package.

The reduced configs, with the reference's seed-0 weights carried across
by ``models/convert.py``: the port's ``decode_step`` at a position a
slot against the reference's ``jax.vmap`` of ``decode_step`` over the
same slots (logits and each slot's cache), the port's
``ContinuousBatcher`` against ``repro.serving.ContinuousBatcher`` on one
seeded prompt mix (token ids per request), the reference test's own
cases against the port's ``generate``, compile counts a bucket, and the
capture module's CPU behaviour (an eager step; the launch tally).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import ContinuousBatcher as JBatcher  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import capture  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import make_decode_step  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import ContinuousBatcher, Request, \
    ServeStats  # noqa: E402

LLAMA, GRANITE = "llama3.2-3b", "granite-moe-1b-a400m"
SSM, HYBRID = "mamba2-370m", "zamba2-1.2b"
RTOL, ATOL = 1e-4, 2e-4

_MODELS: dict = {}


def _setup(arch):
    """The reduced configs, the reference's plain model and its seed-0
    weights on both sides."""
    if arch not in _MODELS:
        jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
        jm = build_model(jcfg, "xla", remat=False)
        jparams = jm.init(jax.random.PRNGKey(0))
        tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                                  device="cpu")
        _MODELS[arch] = (cfg, jm, jparams, tparams)
    return _MODELS[arch]


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int64)
            for n in lengths]


# ---------------------------------------------------------------------------
# one wave: decode_step with a position a slot against the reference's vmap
# ---------------------------------------------------------------------------
def _ref_wave(jm, jparams, prompts, max_len, toks, poss):
    """The reference scheduler's wave: each slot's batch-1 cache filled by
    its prompt, stacked, then ``jax.vmap(decode_one)``
    (``src/repro/serving/scheduler.py:208-213``)."""
    V = jm.cfg.vocab_size
    slots = []
    for p in prompts:
        _, c = jm.prefill(jparams, tokens=jnp.asarray(p[None], jnp.int32),
                          cache=jm.init_cache(1, max_len))
        slots.append(c)
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *slots)

    def decode_one(p, cache_slot, tok, pos):
        logits, nc = jm.decode_step(p, cache_slot, tok, pos, kv_len=pos + 1)
        return logits[:, -1, :V], nc

    logits, cache = jax.vmap(decode_one, in_axes=(None, 0, 0, 0))(
        jparams, stacked, jnp.asarray(toks[:, None, :], jnp.int32),
        jnp.asarray(poss, jnp.int32))
    return np.asarray(logits[:, 0]), jax.tree_util.tree_map(np.asarray, cache)


def _slot_tensors(family, jcache, cache, i):
    """Slot ``i``'s cache tensors on both sides, in one order:
    (name, reference array, port tensor)."""
    out = []
    if family in ("dense", "moe"):
        for n in ("k", "v"):   # [slots, L, 1, ...] and [L, slots, ...]
            out.append((n, jcache["attn"][n][i, :, 0], cache[n][:, i]))
        return out
    if family == "ssm":        # [slots, L, 1, ...] stacked Mamba layers
        for layer, mc in enumerate(cache["mamba"]):
            for n in ("conv", "ssm"):
                out.append((f"mamba{layer}.{n}",
                            jcache["mamba"][n][i, layer, 0], mc[n][i]))
        return out
    for layer, mc in enumerate(cache["mamba"]):   # hybrid: lists
        for n in ("conv", "ssm"):
            out.append((f"mamba{layer}.{n}",
                        jcache["blocks"][layer]["mamba"][n][i, 0], mc[n][i]))
    for a, kv in enumerate(cache["attn"]):
        for n in ("k", "v"):
            out.append((f"attn{a}.{n}", jcache["attn"][a][n][i, 0],
                        kv[n][i]))
    return out


@pytest.mark.parametrize("arch", [LLAMA, GRANITE, SSM, HYBRID])
def test_decode_step_at_a_position_a_slot_matches_the_reference_vmap(arch):
    cfg, jm, jparams, tparams = _setup(arch)
    max_len = 32
    prompts = _prompts(cfg, (9, 4, 14), seed=1)
    poss = np.array([len(p) for p in prompts])
    toks = np.array([[3], [11], [7]])
    want_logits, jcache = _ref_wave(jm, jparams, prompts, max_len, toks,
                                    poss)

    mdl = Model(cfg, device="cpu")
    cache = mdl.init_cache(len(prompts), max_len)
    for i, p in enumerate(prompts):
        mdl.prefill(tparams, torch.from_numpy(p[None]),
                    mdl.slot_cache(cache, i))
    pos = torch.from_numpy(poss)
    logits, out = mdl.decode_step(tparams, cache, torch.from_numpy(toks), pos,
                                  kv_len=pos + 1)
    assert out is cache
    np.testing.assert_allclose(logits[:, 0, :cfg.vocab_size].numpy(),
                               want_logits, rtol=RTOL, atol=ATOL)
    for i in range(len(prompts)):
        for name, want, got in _slot_tensors(cfg.family, jcache, cache, i):
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                       atol=ATOL, err_msg=f"slot {i} {name}")


def test_decode_step_refuses_positions_of_another_batch():
    cfg, _, _, tparams = _setup(LLAMA)
    mdl = Model(cfg, device="cpu")
    cache = mdl.init_cache(3, 16)
    with pytest.raises(ValueError, match="pos of shape"):
        mdl.decode_step(tparams, cache, torch.zeros(3, 1, dtype=torch.long),
                        torch.tensor([1, 2]))


def test_slot_cache_views_write_into_the_stacked_cache():
    """A prefill into ``slot_cache(cache, i)`` fills row i of the stack in
    place and no other row; a recurrent state is written in place."""
    for arch in (LLAMA, HYBRID):
        cfg, _, _, tparams = _setup(arch)
        mdl = Model(cfg, device="cpu")
        cache = mdl.init_cache(3, 16)
        ptrs = capture.leaf_signature(cache)
        mdl.prefill(tparams, torch.arange(5)[None], mdl.slot_cache(cache, 1))
        assert capture.leaf_signature(cache) == ptrs
        for t in torch.utils._pytree.tree_leaves(cache):
            rows = t if arch == HYBRID else t.transpose(0, 1)
            assert rows[1].abs().sum() > 0
            assert rows[0].abs().sum() == 0 and rows[2].abs().sum() == 0
        assert len(mdl.recurrent_state(cache)) == (
            2 * cfg.n_layers if arch == HYBRID else 0)


# ---------------------------------------------------------------------------
# the scheduler against the reference scheduler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [LLAMA, SSM, HYBRID])
def test_batcher_matches_the_reference_batcher(arch):
    """Five requests through two slots (a refill mid-flight), prompts
    bucketed for the dense model and exact for the recurrent ones."""
    cfg, jm, jparams, tparams = _setup(arch)
    prompts = _prompts(cfg, (9, 5, 13, 6, 11), seed=2)
    want_server = JBatcher(jm, jparams, n_slots=2, max_len=48)
    want_ids = [want_server.submit(p.astype(np.int32), max_new=5)
                for p in prompts]
    want = want_server.run()
    server = ContinuousBatcher(Model(cfg, device="cpu"), tparams, n_slots=2,
                               max_len=48)
    ids = [server.submit(p, max_new=5) for p in prompts]
    got = server.run()
    assert ids == want_ids
    for rid in ids:
        assert got[rid] == want[rid], f"request {rid}"
    assert server.stats.prefills == want_server.stats.prefills == 5
    assert server.stats.decode_waves == want_server.stats.decode_waves
    assert server.stats.tokens_out == want_server.stats.tokens_out == 25


def _refs(mdl, params, prompts, gen):
    return [serve.generate(mdl, params, p[None], gen)[0, len(p):].tolist()
            for p in prompts]


@pytest.mark.parametrize("case", ["batched_equals_single", "refill", "ssm",
                                  "eos"])
def test_reference_scheduler_cases(case):
    """``tests/test_serving_scheduler.py:22, 38, 51`` and
    ``tests/test_serving_stitched.py``'s EOS case, on the port."""
    cfg, _, _, tparams = _setup(SSM if case == "ssm" else LLAMA)
    mdl = Model(cfg, device="cpu")
    if case == "batched_equals_single":
        prompts, gen = _prompts(cfg, (9, 5, 13), seed=3), 6
        server = ContinuousBatcher(mdl, tparams, n_slots=3, max_len=64)
    elif case == "refill":
        prompts, gen = _prompts(cfg, (4, 5, 6, 7, 8), seed=4), 4
        server = ContinuousBatcher(mdl, tparams, n_slots=2, max_len=48)
    elif case == "ssm":
        prompts, gen = _prompts(cfg, (7, 11), seed=5), 5
        server = ContinuousBatcher(mdl, tparams, n_slots=2, max_len=40)
        assert server._pad_prompts is False
    else:
        prompts, gen = _prompts(cfg, (9, 5, 13, 7), seed=6), 8
        eos = _refs(mdl, tparams, prompts[:1], gen)[0][gen // 2]
        server = ContinuousBatcher(mdl, tparams, n_slots=2, max_len=64,
                                   eos_id=eos)
    rids = [server.submit(p, max_new=gen) for p in prompts]
    results = server.run()
    assert set(results) == set(rids)
    refs = _refs(mdl, tparams, prompts, gen)
    if case == "eos":
        def cut(seq):
            return seq[: seq.index(eos) + 1] if eos in seq else seq

        refs = [cut(r) for r in refs]
        assert any(len(results[rid]) < gen for rid in rids)
    for rid, ref in zip(rids, refs):
        assert results[rid] == ref, f"request {rid}"
    if case == "refill":
        assert server.stats.prefills == 5
        assert server.stats.tokens_out == 20
        assert all(len(v) == 4 for v in results.values())


def test_prompt_mix_compiles_once_per_bucket():
    """A 7-length prompt mix collapses onto its buckets: one prefill
    compile a bucket, one decode compile in all; the same mix again
    compiles nothing."""
    cfg, _, _, tparams = _setup(LLAMA)
    prompts = _prompts(cfg, (3, 5, 6, 7, 8, 9, 12), seed=7)  # 8 x5, 16 x2
    server = ContinuousBatcher(Model(cfg, device="cpu"), tparams, n_slots=3,
                               max_len=48)
    for p in prompts:
        server.submit(p, max_new=3)
    server.run()
    assert server.compile_counts() == {"prefill": 2, "decode": 1}
    assert server.stats.replans == 3          # 2 prefill shapes + 1 decode
    assert 0.0 < server.stats.hit_rate < 1.0
    assert server.stats.tok_per_s_steady > 0.0
    before = server.stats.replans
    for p in prompts:
        server.submit(p, max_new=3)
    server.run()
    assert server.stats.replans == before
    assert server.compile_counts() == {"prefill": 2, "decode": 1}


def test_serve_stats_percentiles_and_summary():
    st = ServeStats(prefills=2, decode_waves=3, tokens_out=8, wall_s=2.0,
                    ttft_s=[0.1, 0.3], wave_s=[0.01, 0.02, 0.03],
                    shape_hits=3, shape_misses=1, steady_wall_s=0.5,
                    steady_tokens=5)
    assert st.tok_per_s == 4.0 and st.tok_per_s_steady == 10.0
    assert st.hit_rate == 0.75 and st.replans == 1
    assert st.p50_ttft_s == pytest.approx(0.2)
    assert st.p50_tok_s == pytest.approx(0.02)
    assert st.p99_tok_s == pytest.approx(0.0298)
    assert "2 prefills, 3 decode waves, 8 tokens" in st.summary()
    assert Request(0, np.zeros(3), 4).pos == 0


def test_batcher_takes_no_reference_only_options():
    cfg, _, _, tparams = _setup(LLAMA)
    for option in ("background", "canary", "donate"):
        with pytest.raises(TypeError):
            ContinuousBatcher(Model(cfg, device="cpu"), tparams,
                              **{option: None})
    # ported since: plan_cache and autotune select the model's set
    b = ContinuousBatcher(Model(cfg, device="cpu"), tparams,
                          plan_cache=None, autotune=False)
    assert b.mdl.plan_cache is None and not b.mdl.autotune
    server = ContinuousBatcher(Model(cfg, device="cpu"), tparams, max_len=32)
    with pytest.raises(ValueError, match="exceeds a slot"):
        server.submit(np.zeros(25, np.int64), max_new=8)


# ---------------------------------------------------------------------------
# the capture module off the card
# ---------------------------------------------------------------------------
def test_cpu_steps_run_eagerly():
    """On the CPU ``graphed`` hands back the step itself, ``generate``
    is the same with and without capture, and ``make_decode_step`` runs
    ``decode_step``."""
    def fn(x):
        return x + 1

    assert capture.graphed(fn, "cpu") is fn
    cfg, _, _, tparams = _setup(LLAMA)
    mdl = Model(cfg, device="cpu")
    prompts = np.stack(_prompts(cfg, (6, 6), seed=8))
    np.testing.assert_array_equal(
        serve.generate(mdl, tparams, prompts, 4),
        serve.generate(mdl, tparams, prompts, 4, capture=False))
    assert serve.generate(mdl, tparams, prompts, 0).shape == (2, 6)
    cache = mdl.init_cache(2, 16)
    mdl.prefill(tparams, torch.from_numpy(prompts), cache)
    tok = torch.tensor([[1], [2]])
    got, _ = make_decode_step(mdl, 16)(tparams, cache, tok, 6)
    want, _ = mdl.decode_step(tparams, cache, tok, 6, kv_len=16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_captured_step_refuses_cpu_inputs():
    step = capture.CapturedStep(lambda x: x)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        step(torch.ones(2))
    with pytest.raises(TypeError, match="a tensor or an int"):
        step(1.5)


def test_launches_recorded_during_a_capture_are_tallied_not_counted():
    def owner():
        pass

    owner.launches = 0
    _build.count(owner, 2)
    assert owner.launches == 2
    _build.capturing = {}
    try:
        _build.count(owner)
        _build.count(owner, 3)
        assert owner.launches == 2
        assert _build.capturing == {owner: 4}
    finally:
        _build.capturing = None
