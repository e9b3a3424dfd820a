"""Decode at a static cache length on the CPU, against the JAX package.

B8's plain version (``flash_decode_plain``) against the reference's
``flash_decode`` Pallas kernel in interpret mode (the same numpy inputs);
the ``repro_torch::flash_decode`` operator's switch, shape rules and
split plan; ``make_decode_step(mdl, kv_len)`` and ``decode_step(...,
kv_len=None)`` on the reduced Llama, Granite and Zamba2 against the
reference's in ``"stitched"`` mode; ``make_prefill_step`` and
``make_encoder_step`` against the reference's; one compiled
``block_post`` per static ``kv_len``; and ``serve.generate_static``
against the reference's prefill and decode step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels.flash_attention import flash_decode as jflash_decode  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

rng = np.random.default_rng(16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _decode_inputs(B, Hq, Hkv, S, D, seed):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, Hq, D)).astype(np.float32)
    k = r.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = r.standard_normal((B, Hkv, S, D)).astype(np.float32)
    return q, k, v


# ---------------------------------------------------------------------------
# B8's plain version against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_len", [None, 96, 70], ids=["none", "S", "ragged"])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_plain_matches_the_pallas_flash_decode(group, kv_len):
    """S 96 over K blocks of 32 on the reference side (three blocks; 70
    leaves a ragged last one)."""
    q, k, v = _decode_inputs(2, 2 * group, 2, 96, 64, seed=group)
    want = jflash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         kv_len=kv_len, block_k=32, interpret=True)
    got = FA.flash_decode_plain(_t(q), _t(k), _t(v), kv_len)
    # float32, an online softmax over 32-key blocks against one pass
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-6)


def test_rows_never_written_are_attended_as_they_stand():
    """Zero rows inside ``kv_len`` are attended, as in the reference: each
    adds exp(-m) to the denominator.  Neither package masks them."""
    q, k, v = _decode_inputs(1, 4, 2, 64, 64, seed=3)
    k[:, :, 40:], v[:, :, 40:] = 0.0, 0.0
    want = jflash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         kv_len=64, block_k=32, interpret=True)
    got = FA.flash_decode_plain(_t(q), _t(k), _t(v), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-6)
    live = FA.flash_decode_plain(_t(q), _t(k), _t(v), 40)
    assert not torch.allclose(got, live, atol=1e-3)


def test_kv_len_rules():
    q, k, v = (_t(a) for a in _decode_inputs(2, 4, 2, 16, 64, seed=4))
    whole = FA.flash_decode_plain(q, k, v, None)
    torch.testing.assert_close(FA.flash_decode_plain(q, k, v, 16), whole,
                               rtol=0, atol=0)
    torch.testing.assert_close(FA.flash_decode_plain(q, k, v, 500), whole,
                               rtol=0, atol=0)
    for bad in (0, -3):
        with pytest.raises(ValueError, match="kv_len"):
            FA.flash_decode_plain(q, k, v, bad)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        FA.flash_decode_plain(q[:, :3], k, v, 4)
    assert FA.live_len(None, 16) == 16 and FA.live_len(7, 16) == 7


def test_operator_switch_and_the_plain_slice():
    """``ops.decode_attention`` with a static or absent ``kv_len`` and
    kernels runs the operator; its CPU path equals the plain slice."""
    q, k, v = (_t(a) for a in _decode_inputs(2, 6, 2, 40, 128, seed=5))
    for n in (None, 40, 17):
        got = ops.decode_attention(q, k, v, kv_len=n)
        want = ops.decode_attention(q, k, v, kv_len=n, use_kernels=False)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    masked = ops.decode_attention(q, k, v, kv_len=torch.tensor(17))
    torch.testing.assert_close(masked, ops.decode_attention(q, k, v,
                                                            kv_len=17),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["fake", "meta"])
def test_operator_is_one_opaque_node(mode):
    dev = "meta" if mode == "meta" else "cpu"
    q = torch.randn(2, 4, 64, device=dev)
    kv = torch.randn(2, 2, 24, 64, device=dev)
    gm = make_fx(lambda a, b, c: ops.decode_attention(a, b, c, kv_len=9) * 2,
                 tracing_mode="fake" if mode == "fake" else "real")(q, kv, kv)
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"
             and str(n.target).startswith("repro_torch.flash_decode")]
    assert len(nodes) == 1 and nodes[0].args[3] == 9


def test_non_cpu_tensors_never_take_the_plain_path(monkeypatch):
    """On a device that is not the CPU the operator launches the kernel
    or raises: here (meta tensors) the wrapper raises, and the operator
    returns its shape without running the plain version."""
    def plain(*a, **k):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(ref, "decode_attention", plain)
    q = torch.empty(2, 4, 64, device="meta")
    kv = torch.empty(2, 2, 24, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        FA.flash_decode_cuda(q, kv, kv, 9)
    out = FA.flash_decode(q, kv, kv, 9)
    assert out.device.type == "meta" and out.shape == q.shape


def test_launch_counter_untouched_by_plain_runs():
    before = FA.flash_decode_cuda.launches
    q, k, v = (_t(a) for a in _decode_inputs(1, 2, 1, 8, 64, seed=6))
    FA.flash_decode(q, k, v, 5)
    assert FA.flash_decode_cuda.launches == before


# ---------------------------------------------------------------------------
# B8 at any head dim and group: the padding and the sub-group plan
# ---------------------------------------------------------------------------
def _plain_launch(qs, k, v, eff, scale, os):
    """A sub-group launch run by the plain version: the [B, Hkv, n, D] view
    of the sub-group's query heads as Hkv n heads of group n."""
    B, Hkv, n, D = qs.shape
    os.copy_(FA.flash_decode_plain(qs.reshape(B, Hkv * n, D), k, v, eff,
                                   scale).view(B, Hkv, n, D))


def _sub_grouped(q, k, v, kv_len, scale=None):
    """The CUDA wrapper's composition (the true D's scale and, for a D
    that is not a multiple of 4, padding; then sub-groups) with the plain
    version in place of each launch."""
    return FA.decode_padded(
        q, k, v, kv_len, scale,
        lambda *a: FA.decode_by_subgroups(*a, _plain_launch))


@pytest.mark.parametrize("D,kv_len", [(80, 70), (256, None), (32, 96),
                                       (30, 50)],
                         ids=["d80-ragged", "d256", "d32", "d30-padded"])
def test_padded_decode_matches_the_pallas_flash_decode(D, kv_len):
    """A head dim without an instance runs on the next (80 on 128, 32 and
    30 on 64), its columns masked at D; one that is not a multiple of 4
    (30) is first zero-padded to the next multiple of 4.  Gemma-7B's 256
    runs on its own.  The scale stays 1/sqrt(D) of the true D, so the
    padded call is the same function."""
    q, k, v = _decode_inputs(2, 4, 2, 96, D, seed=D)
    want = jflash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         kv_len=kv_len, block_k=32, interpret=True)
    seen = []

    def launch(qs, k_, v_, eff, scale, os):
        seen.append(qs.shape[-1])
        _plain_launch(qs, k_, v_, eff, scale, os)

    got = FA.decode_padded(
        _t(q), _t(k), _t(v), kv_len, None,
        lambda *a: FA.decode_by_subgroups(*a, launch))
    assert got.shape == (2, 4, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-6)
    assert seen == [-(-D // 4) * 4]   # padded only up to a multiple of 4
    assert FA.decode_instance(D) == {80: 128, 256: 256, 32: 64, 30: 64}[D]


def test_padded_decode_keeps_the_scale_of_the_true_head_dim():
    """A scale taken from the instance's head dim (1/sqrt(128) at D 80) is
    a different function: that call would not match the reference."""
    q, k, v = (_t(a) for a in _decode_inputs(1, 4, 2, 64, 80, seed=8))
    right = _sub_grouped(q, k, v, None)
    torch.testing.assert_close(right, FA.flash_decode_plain(q, k, v, None),
                               rtol=1e-5, atol=2e-6)
    padded_scale = _sub_grouped(q, k, v, None, scale=1.0 / np.sqrt(128))
    assert not torch.allclose(padded_scale, right, atol=1e-3)


@pytest.mark.parametrize("G", [1, 3, 8, 9, 12, 16, 24])
def test_subgroup_plan_covers_every_head_once(G):
    """Each sub-group has at most 8 heads, the fewest sub-groups, and the
    query heads it runs of KV head j are j G + first .. j G + first + n -
    1: every head once, each on its own KV head."""
    plan = FA.decode_subgroups(G, 128)
    assert FA.decode_max_group(128) == FA.DECODE_MAX_GROUP
    assert len(plan) == -(-G // FA.DECODE_MAX_GROUP)
    assert all(1 <= n <= FA.DECODE_MAX_GROUP for _, n in plan)
    Hkv = 3
    seen = []
    for first, n in plan:
        for j in range(Hkv):
            for i in range(n):
                h = j * G + first + i
                assert h // G == j   # the sub-group's own KV head
                seen.append(h)
    assert sorted(seen) == list(range(Hkv * G))


@pytest.mark.parametrize("kv_len", [None, 50], ids=["whole", "ragged"])
def test_group_16_decode_matches_the_pallas_flash_decode(kv_len):
    """16 query heads a KV head (above one launch's 8): two sub-groups of
    8, through strided views of q and o, against the reference."""
    q, k, v = _decode_inputs(2, 32, 2, 64, 64, seed=17)
    want = jflash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         kv_len=kv_len, block_k=32, interpret=True)
    assert FA.decode_subgroups(16, 64) == [(0, 8), (8, 8)]
    for got in (_sub_grouped(_t(q), _t(k), _t(v), kv_len),
                FA.flash_decode(_t(q), _t(k), _t(v), kv_len)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=2e-6)


def test_decode_above_256_is_one_row_of_flash_attention():
    """Above 256 the decode kernel's own instances run (320 on the 384
    instance, its columns masked), no longer the wide flash kernel; the
    function is still one query row of flash attention over the live
    prefix, non-causal, as the reference builds it."""
    q, k, v = (_t(a) for a in _decode_inputs(1, 4, 2, 40, 320, seed=9))
    assert FA.decode_instance(320) == 384
    row = FA.flash_attention_plain(q[:, :, None], k[:, :, :33],
                                   v[:, :, :33], False)[:, :, 0]
    torch.testing.assert_close(FA.flash_decode_plain(q, k, v, 33), row,
                               rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("D,instance,cap,width", [
    (264, 384, 4, 384), (320, 384, 4, 384), (384, 384, 4, 384),
    (400, 512, 4, 512), (512, 512, 4, 512), (516, None, 4, 1024),
    (640, None, 4, 1024), (1100, None, 4, 1536), (13_000, None, 3, 13_312)])
def test_decode_route_and_group_cap_above_256(D, instance, cap, width):
    """Above 256: the 384 and 512 instances (a warp a row, 3 or 4 float4 a
    lane), then the tiled kernel (None: q in shared memory, 512-column
    output tiles); at most 4 query heads a launch, fewer where one block's
    shared memory cannot hold the tiled kernel's state of 4."""
    assert FA.decode_instance(D) == instance
    assert FA.decode_max_group(D) == cap
    assert FA.decode_width(D) == width
    if instance is None:
        assert FA.decode_tiled_smem_bytes(D, cap) <= FA.DECODE_SMEM_LIMIT
        if cap < FA.DECODE_MAX_GROUP_WIDE:
            assert (FA.decode_tiled_smem_bytes(D, cap + 1)
                    > FA.DECODE_SMEM_LIMIT)
    assert FA.decode_max_group(256) == FA.DECODE_MAX_GROUP == 8
    plan = FA.decode_subgroups(8, D)
    assert len(plan) == -(-8 // cap) and max(n for _, n in plan) <= cap
    with pytest.raises(ValueError, match="shared memory"):
        FA.decode_max_group(60_000)


@pytest.mark.parametrize("D,Hq,kv_len,plan", [
    (320, 8, 70, [(0, 4)]), (512, 8, 70, [(0, 4)]),
    (512, 16, 50, [(0, 4), (4, 4)]), (640, 8, 77, [(0, 4)])],
    ids=["d320-g4-ragged", "d512-g4-ragged", "d512-g8-subgroups-ragged",
         "d640-tiled-ragged"])
def test_wide_decode_matches_the_pallas_flash_decode(D, Hq, kv_len, plan):
    """Head dims above 256 through the CUDA wrapper's composition (the
    plain version in place of each launch) against the reference's
    ``flash_decode`` in interpret mode, over a ragged live prefix: D 320
    and 512 at 4 query heads a KV head (one launch), 512 at 8 (two
    sub-groups of 4), 640 on the tiled kernel."""
    q, k, v = _decode_inputs(2, Hq, 2, 96, D, seed=D + Hq)
    want = jflash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         kv_len=kv_len, block_k=32, interpret=True)
    seen = []

    def launch(qs, k_, v_, eff, scale, os):
        seen.append((qs.shape[2], qs.shape[-1], eff))
        _plain_launch(qs, k_, v_, eff, scale, os)

    got = FA.decode_padded(
        _t(q), _t(k), _t(v), kv_len, None,
        lambda *a: FA.decode_by_subgroups(*a, launch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-6)
    assert FA.decode_subgroups(Hq // 2, D) == plan
    assert seen == [(n, D, kv_len) for _, n in plan]


@pytest.mark.parametrize("pairs,eff", [(32, 32768), (8, 32768),
                                       (32, 524288), (4, 1000), (2, 5),
                                       (1, 1), (1056, 70)])
def test_split_plan_covers_the_live_rows(pairs, eff):
    splits, rows = FA.decode_splits(pairs, eff)
    assert rows % FA.DECODE_ROW_QUANTUM == 0
    assert (splits - 1) * rows < eff <= splits * rows   # no split empty
    if eff >= FA.DECODE_TARGET_BLOCKS * FA.DECODE_ROW_QUANTUM:
        assert pairs * splits >= FA.DECODE_TARGET_BLOCKS // 2


def test_aligned_copies_only_what_float4_loads_cannot_read():
    cache = torch.zeros(3, 2, 4, 16, 64)
    layer = cache[1]
    assert FA._aligned(layer) is layer
    odd = torch.zeros(2 * 4 * 16 * 64 + 1)[1:].view(2, 4, 16, 64)
    assert FA._aligned(odd) is not odd and FA._aligned(odd).is_contiguous()


# ---------------------------------------------------------------------------
# the decode step at a static cache length against the reference's
# ---------------------------------------------------------------------------
ARCHS = ["llama3.2-3b", "granite-moe-1b-a400m", "zamba2-1.2b"]
PROMPT, MAX_LEN = 8, 16


def _reduced(arch):
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jm = build_model(jcfg, "stitched", remat=False)
    jparams = jm.init(jax.random.PRNGKey(9))
    return jcfg, cfg, jm, jparams, from_jax_params(_np(jparams),
                                                   device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_static_decode_matches_the_reference(arch):
    """Both packages prefill 8 tokens into a 16-row cache, then decode
    three steps: ``make_decode_step(kv_len=9)`` at position 8 (the rows
    written), ``make_decode_step(kv_len=16)`` at 9 (the whole cache, six
    rows never written), ``decode_step(kv_len=None)`` at 10.  The
    reference decodes in ``"stitched"`` mode: its ``flash_decode`` in
    interpret mode; the port's operator runs its plain version."""
    jcfg, cfg, jm, jparams, tparams = _reduced(arch)
    jx = build_model(jcfg, "xla", remat=False)   # the same prefill, faster
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                                (2, PROMPT))
    _, jc = jx.prefill(jparams, tokens=jnp.asarray(prompts, jnp.int32),
                       cache=jx.init_cache(2, MAX_LEN))
    mdl = Model(cfg, device="cpu")
    cache = mdl.init_cache(2, MAX_LEN)
    mdl.prefill(tparams, _t(prompts), cache)
    tok = np.array([[3], [7]])
    for pos, n, built in ((8, 9, True), (9, MAX_LEN, True),
                          (10, None, False)):
        if built:
            jl, jc = jsteps.make_decode_step(jm, kv_len=n)(
                jparams, jc, jnp.asarray(tok, jnp.int32), pos)
            tl, _ = steps.make_decode_step(mdl, kv_len=n)(
                tparams, cache, _t(tok), torch.tensor(pos))
        else:
            jl, jc = jm.decode_step(jparams, jc, jnp.asarray(tok, jnp.int32),
                                    pos)
            tl, _ = mdl.decode_step(tparams, cache, _t(tok), pos)
        # float32 through the layers, another summation order
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=2e-4)
        tok = tok + 1
    assert set(mdl.static_posts) == {9, MAX_LEN, None}


def test_one_compiled_post_per_static_kv_len():
    """Each static ``kv_len`` compiles its own ``block_post`` once, reused
    across layers and steps; ``generate`` (a device-valued ``kv_len``)
    still compiles one decode signature per cache bucket, and never a
    static one."""
    _, cfg, _, _, tparams = _reduced("llama3.2-3b")
    mdl = Model(cfg, device="cpu")
    prompts = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 5))
    serve.generate(mdl, tparams, prompts, 6)
    assert (mdl.pre.n_compiled, mdl.post.n_compiled) == (2, 2)
    assert mdl.static_posts == {}
    cache = mdl.init_cache(2, 16)
    tok = torch.tensor([[1], [2]])
    for pos, n in ((8, 9), (9, 9), (10, 12), (11, None), (12, None)):
        mdl.decode_step(tparams, cache, tok, torch.tensor(pos), kv_len=n)
    assert set(mdl.static_posts) == {9, 12, None}
    assert all(p.n_compiled == 1 for p in mdl.static_posts.values())
    comp = mdl.static_posts[9].compiled(
        tparams["blocks"][0], torch.zeros(2, 1, cfg.d_model),
        torch.zeros(2, 4, 1, 32), cache["k"][0], cache["v"][0])
    assert any(n.prim == "repro_torch.flash_decode.default"
               for n in comp.graph.nodes.values())
    serve.generate(mdl, tparams, prompts, 6)
    assert (mdl.pre.n_compiled, mdl.post.n_compiled) == (2, 2)


# ---------------------------------------------------------------------------
# the prefill and encoder steps
# ---------------------------------------------------------------------------
def test_prefill_step_matches_the_reference():
    jcfg, cfg, _, jparams, tparams = _reduced("llama3.2-3b")
    jx = build_model(jcfg, "xla", remat=False)
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 8))
    jl, _ = jsteps.make_prefill_step(jx)(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
        jx.init_cache(2, 16))
    mdl = Model(cfg, device="cpu")
    step = steps.make_prefill_step(mdl)
    cache = mdl.init_cache(2, 16)
    tl, out = step(tparams, {"tokens": _t(tokens)}, cache)
    assert out is cache and cache["k"][:, :, :, :8].abs().sum() > 0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=2e-4)
    # a vision model's batch: its vision_embeds replace the first rows
    # (the reduced InternVL2-26B, 8 of 12 prompt rows)
    jvcfg, vcfg, _, jvparams, tvparams = _reduced("internvl2-26b")
    jv = build_model(jvcfg, "xla", remat=False)
    vtok = np.random.default_rng(10).integers(0, vcfg.vocab_size, (2, 12))
    ve = np.random.default_rng(11).standard_normal(
        (2, vcfg.n_vision_tokens, vcfg.d_model)).astype(np.float32)
    jl, jc = jsteps.make_prefill_step(jv)(
        jvparams, {"tokens": jnp.asarray(vtok, jnp.int32),
                   "vision_embeds": jnp.asarray(ve)}, jv.init_cache(2, 16))
    vm = Model(vcfg, device="cpu")
    vcache = vm.init_cache(2, 16)
    tl, _ = steps.make_prefill_step(vm)(
        tvparams, {"tokens": _t(vtok), "vision_embeds": _t(ve)}, vcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=2e-4)
    np.testing.assert_allclose(vcache["k"].numpy(),
                               np.asarray(jc["attn"]["k"]), rtol=1e-5,
                               atol=1e-5)


def test_encoder_step_matches_the_reference():
    jcfg = jget_config("hubert-xlarge").reduced()
    cfg = get_config("hubert-xlarge").reduced()
    jm = build_model(jcfg, "xla", remat=False)
    jparams = jm.init(jax.random.PRNGKey(10))
    frames = rng.standard_normal((2, 16, cfg.frontend_dim)).astype(np.float32)
    want = jsteps.make_encoder_step(jm)(jparams,
                                        {"frames": jnp.asarray(frames)})
    got = steps.make_encoder_step(Model(cfg, device="cpu"))(
        from_jax_params(_np(jparams), device="cpu"), {"frames": _t(frames)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=2e-4)


def test_generate_static_matches_the_reference_decode_cell():
    """``generate_static``: the prompt prefilled into a cache of kv_len
    rows, then greedy steps of ``make_decode_step(mdl, kv_len)`` -- the
    same tokens as the reference's prefill and decode step, the unwritten
    rows attended as zeros on both sides."""
    jcfg, cfg, jm, jparams, tparams = _reduced("llama3.2-3b")
    jx = build_model(jcfg, "xla", remat=False)
    prompts = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 6))
    jl, jc = jx.prefill(jparams, tokens=jnp.asarray(prompts, jnp.int32),
                        cache=jx.init_cache(2, 24))
    tok = jnp.argmax(jl[:, -1:, :cfg.vocab_size], axis=-1)
    want = [np.asarray(tok)]
    step = jsteps.make_decode_step(jm, kv_len=24)
    for i in range(3):
        jl, jc = step(jparams, jc, tok, 6 + i)
        tok = jnp.argmax(jl[:, -1:, :cfg.vocab_size], axis=-1)
        want.append(np.asarray(tok))
    got = serve.generate_static(Model(cfg, device="cpu"), tparams, prompts,
                                4, kv_len=24)
    np.testing.assert_array_equal(got[:, 6:], np.concatenate(want, axis=1))
    with pytest.raises(ValueError, match="kv_len"):
        serve.generate_static(Model(cfg, device="cpu"), tparams, prompts, 4,
                              kv_len=8)


def test_serve_main_decodes_at_a_static_kv_len(capsys):
    serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                "--prompt-len", "5", "--gen", "3", "--kv-len", "40"])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "kv_len=40" in out
