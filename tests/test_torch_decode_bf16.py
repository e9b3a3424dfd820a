"""The reference's decode cells in bfloat16, against the JAX package.

Both packages build the reduced Llama and Zamba2 with bfloat16 params
(the reference through ``build_model(param_dtype=jnp.bfloat16)``, the
port from the same weights through ``from_jax_params``) and bfloat16
caches, prefill, and run ``make_decode_step(kv_len=...)`` for three
steps, as ``tests/test_torch_decode.py::test_static_decode_matches_the_
reference`` does in float32.  Each step's logits are held to the
bfloat16 path rule (``PERF.md`` §2): the port's distance from the
reference's float32 run of the same weights at most 1.5 times the
reference's bfloat16 run's, plus 1e-3 max(1, max|logits|).

B8's native bfloat16 kernel (``csrc/flash_decode.cu``,
``flash_decode_bf16_kernel``) runs only on the card; its arithmetic in
plain PyTorch (``split_float.bf16_decode``: bfloat16 q . k products
summed in float32, each warp's online softmax over 16 keys of a 64-key
tile, p split into bfloat16 hi and lo, two p . v products, the warps'
and then the splits' merge) is held here against the function in
float64 within the bfloat16 band, and its split plan
(``native_decode_splits``) against the live rows.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels.flash_attention import flash_decode as jflash_decode  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import split_float as SF  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

BF16 = torch.bfloat16
#: the bfloat16 path rule (``PERF.md`` §2)
PATH_FACTOR, PATH_FLOOR = 1.5, 1e-3
#: the reference's bfloat16 band (rtol, atol), and the kernel's distance
#: from float64 at most this times the plain version's
BAND, F64_FACTOR = (2e-2, 2e-2), 2.0
PROMPT, MAX_LEN = 8, 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-1.2b"])
def test_bfloat16_static_decode_matches_the_reference(arch):
    """Three static-length steps: ``kv_len`` 9 at position 8 (the rows
    written), the whole 16-row cache at 9 (six rows never written), 11 at
    10.  The reference decodes in ``"stitched"`` mode (its
    ``flash_decode`` in interpret mode), the port's operator runs its
    plain version; both caches bfloat16."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jm = build_model(jcfg, "stitched", param_dtype=jnp.bfloat16,
                     remat=False)
    jm32 = build_model(jcfg, "stitched", remat=False)
    jp = jm.init(jax.random.PRNGKey(31))
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    tp = from_jax_params(_np(jp), device="cpu")
    prompts = np.random.default_rng(31).integers(0, cfg.vocab_size,
                                                 (2, PROMPT))
    jt = jnp.asarray(prompts, jnp.int32)
    jx = build_model(jcfg, "xla", param_dtype=jnp.bfloat16, remat=False)
    jx32 = build_model(jcfg, "xla", remat=False)
    _, jc = jx.prefill(jp, tokens=jt,
                       cache=jx.init_cache(2, MAX_LEN, jnp.bfloat16))
    _, jc32 = jx32.prefill(jp32, tokens=jt, cache=jx32.init_cache(2, MAX_LEN))
    mdl = Model(cfg, param_dtype=BF16, device="cpu")
    cache = mdl.init_cache(2, MAX_LEN, dtype=BF16)
    kv = cache["attn"] if "attn" in cache else [cache]
    assert all(c[n].dtype == BF16 for c in kv for n in ("k", "v"))
    mdl.prefill(tp, _t(prompts), cache)
    tok = np.array([[3], [7]])
    for pos, n in ((8, 9), (9, MAX_LEN), (10, 11)):
        jtok = jnp.asarray(tok, jnp.int32)
        jl, jc = jsteps.make_decode_step(jm, kv_len=n)(jp, jc, jtok, pos)
        jl32, jc32 = jsteps.make_decode_step(jm32, kv_len=n)(jp32, jc32,
                                                             jtok, pos)
        tl, _ = steps.make_decode_step(mdl, kv_len=n)(tp, cache, _t(tok),
                                                     torch.tensor(pos))
        assert tl.dtype == BF16 and str(jl.dtype) == "bfloat16"
        exact = np.asarray(jl32)
        keep = exact > -1e29                  # the pad columns are -1e30
        port = np.abs(tl.float().numpy()[keep] - exact[keep]).max()
        ref = np.abs(np.asarray(jl.astype(jnp.float32))[keep]
                     - exact[keep]).max()
        limit = (PATH_FACTOR * ref
                 + PATH_FLOOR * max(1.0, np.abs(exact[keep]).max()))
        assert port <= limit, (arch, pos, port, ref, limit)
        tok = tok + 1
    assert set(mdl.static_posts) == {9, MAX_LEN, 11}


def test_bfloat16_decode_plain_matches_the_pallas_kernel():
    """B8's plain version on bfloat16 q and caches against the reference's
    ``flash_decode`` in interpret mode on the same values, within the
    bfloat16 band (both compute in float32; the output rounds to q's
    type)."""
    r = np.random.default_rng(311)
    q = r.standard_normal((2, 6, 64)).astype(np.float32)
    k = r.standard_normal((2, 2, 96, 64)).astype(np.float32)
    v = r.standard_normal((2, 2, 96, 64)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jflash_decode(jq, jk, jv, kv_len=70, block_k=32, interpret=True)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .to(BF16) for a in (jq, jk, jv))
    got = FA.flash_decode_plain(tq, tk, tv, 70)
    assert got.dtype == BF16 and str(want.dtype) == "bfloat16"
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=BAND[0], atol=BAND[1])


@pytest.mark.parametrize("B,Hq,Hkv,S,D,kv_len", [
    (2, 24, 8, 3000, 128, 2900),   # Llama's heads, a ragged live prefix
    (1, 32, 32, 4000, 64, None),   # Zamba2's heads, the whole cache
])
def test_native_bfloat16_decode_arithmetic(B, Hq, Hkv, S, D, kv_len):
    """``split_float.bf16_decode`` (the native kernel's arithmetic) on
    bfloat16 inputs against the function in float64: within the bfloat16
    band of the plain version, and no further from float64 than twice the
    plain version (which widens q, k and v to float32 and rounds its
    output once); its float32 output before that rounding within 1e-5
    max(1, max|o|) of float64."""
    g = torch.Generator().manual_seed(Hq + D)
    q, k, v = (torch.randn(*s, generator=g).to(BF16)
               for s in ((B, Hq, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    eff = FA.live_len(kv_len, S)
    splits, rows = FA.native_decode_splits(B * Hkv, eff, 2 * 132)
    assert splits > 1
    o = SF.bf16_decode(q, k, v, kv_len, rows=rows)
    exact = FA.flash_decode_plain(q.double(), k.double(), v.double(), kv_len)
    plain = FA.flash_decode_plain(q, k, v, kv_len)
    got = o.to(BF16).double()
    rtol, atol = BAND
    assert ((got - plain.double()).abs()
            <= atol + rtol * plain.double().abs()).all()
    kerr = float((got - exact).abs().max())
    perr = float((plain.double() - exact).abs().max())
    assert kerr <= F64_FACTOR * perr
    assert float((o.double() - exact).abs().max()) <= \
        1e-5 * max(1.0, float(exact.abs().max()))


@pytest.mark.parametrize("pairs,eff,resident", [
    (32, 32768, 264), (128, 32768, 264), (32, 524288, 396),
    (8, 1333, 264), (300, 32768, 264), (1, 1, 264), (2, 70, 132),
    (1000, 64, 396)])
def test_native_split_plan_covers_every_live_row_once(pairs, eff, resident):
    """Splits of whole 64-row quanta, none empty, that together cover the
    live rows once; B Hkv splits fills whole resident waves where the
    rows allow (no tail wave)."""
    splits, rows = FA.native_decode_splits(pairs, eff, resident)
    assert rows % FA.DECODE_ROW_QUANTUM == 0
    covered = [min(eff, (i + 1) * rows) - i * rows for i in range(splits)]
    assert all(c > 0 for c in covered) and sum(covered) == eff
    waves = -(-pairs // resident)
    assert pairs * splits <= waves * resident or splits == 1
    if eff >= resident * FA.DECODE_ROW_QUANTUM:
        assert pairs * splits > (waves - 1) * resident
        assert pairs * splits + pairs > waves * resident


def test_native_kernel_is_taken_where_its_instances_are():
    q = torch.zeros(1, 8, 128, dtype=BF16)
    k = torch.zeros(1, 2, 64, 128, dtype=BF16)
    assert FA.native_decode(q, k, k)
    assert not FA.native_decode(q.float(), k, k)      # float32 q
    assert not FA.native_decode(q, k.float(), k.float())
    q80, k80 = torch.zeros(1, 8, 80, dtype=BF16), torch.zeros(
        1, 2, 64, 80, dtype=BF16)
    assert not FA.native_decode(q80, k80, k80)        # a masked head dim
    q384 = torch.zeros(1, 8, 384, dtype=BF16)
    k384 = torch.zeros(1, 2, 64, 384, dtype=BF16)
    assert not FA.native_decode(q384, k384, k384)
