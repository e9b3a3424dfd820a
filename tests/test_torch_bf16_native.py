"""Native bfloat16 products in B3 and B4, and the wide flash kernel in
bfloat16, on the CPU.

Where both operands are bfloat16 the kernels take Hopper's native
products (``csrc/matmul_bf16.cuh``: ``wgmma`` bf16; ``csrc/mma_bf16.cuh``:
``mma.sync.m16n8k16`` bf16): each product of two bfloat16 values is exact
in float32 and summed in float32, and attention's float32 p is split
into bfloat16 hi and lo.  ``kernels/split_float.py`` holds the plain form
of that arithmetic; here it is held to float64 within the bfloat16 rule
of ``chip_smoke.py`` (each element within the anchored band of the plain
version, the largest distance from float64 at most twice the plain
version's).  B3 at Llama's K (3072) and Granite's (1024) with one sum
over all of K, as the native instance takes it, and with a partial sum
each k-tile (the form ``split_float --bf16`` measures beside it), 32
rows and 256 columns (the sum of one element is the full shape's); B4 at a prompt of
512 and the carried head dims, one batch and two heads.

The emitted source picks the native instance for a bfloat16 x bfloat16
chain and the TF32 split for a mixed one; the native tiles' shared memory
is the header's own formula (built with g++) and fits a block; the H100
gate prices a bfloat16 attention group above head dim 256 as the wide
kernel's bfloat16 instance; and the reference's ``flash_attention``
(Pallas in interpret mode) and the port's agree on seeded bfloat16 q, k,
v at D 320, causal, with grouped heads and with a bias ``score_mod``,
within two bfloat16 ulps of 1 (2^-7) plus 2^-7 of the value.
"""
import ctypes
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro_torch.core import OpKind, cost_model, stitched_jit  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import matmul as MM  # noqa: E402
from repro_torch.kernels import split_float as SF  # noqa: E402
from _host_build import gxx  # noqa: E402

BF16 = torch.bfloat16
ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
rng = np.random.default_rng(30)


@pytest.fixture
def anchoring_on(monkeypatch):
    monkeypatch.delenv("REPRO_ANCHOR", raising=False)


def _bf16(*shape, scale=1.0) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            * scale).to(BF16)


def _rule(got, plain, f64) -> float:
    """The worst ratio to the bfloat16 rule (1 at the limit)."""
    return SF.bf16_rule_ratio(got, plain, f64)


def test_the_bf16_rule_is_chip_smokes():
    text = (ROOT / "chip_smoke.py").read_text()
    m = re.search(r"^BF16_BAND, BF16_BAND_ANCHORED, BF16_F64_FACTOR = "
                  r"\(([\d.e-]+), ([\d.e-]+)\), \\\n\s+\(([\d.e-]+), "
                  r"([\d.e-]+)\), ([\d.e-]+)$", text, re.M)
    assert m is not None
    band = (float(m.group(3)), float(m.group(4)))
    assert band == SF.BF16_BAND and float(m.group(5)) == SF.BF16_F64_FACTOR


@pytest.mark.parametrize("K", [1024, 3072])
@pytest.mark.parametrize("chunk", [None, 64])
def test_native_b3_products_hold_the_bf16_rule(K, chunk):
    """silu(x @ wg) * u as the native instance forms it: bfloat16 products
    summed in float32 (one sum, or a partial sum each k-tile), rounded to
    bfloat16 as the anchor's type, against the plain version (float32
    product) and float64."""
    M, N = 32, 256
    x, wg, u = _bf16(M, K), _bf16(K, N, scale=K ** -0.5), _bf16(M, N)

    def epi(h):
        h = h.to(BF16).float()
        return (F.silu(h).to(BF16).float() * u.float()).to(BF16)

    got = epi(SF.bf16_matmul(x, wg, chunk))
    plain = epi(torch.matmul(x.float(), wg.float()))
    h = x.double() @ wg.double()
    f64 = h * torch.sigmoid(h) * u.double()
    assert got.dtype == BF16 and torch.isfinite(got.float()).all()
    assert _rule(got, plain, f64) <= 1.0
    # the products alone are exact: the float32 sum is all that differs
    exact = x.double() @ wg.double()
    err = (SF.bf16_matmul(x, wg, chunk).double() - exact).abs().max()
    assert float(err) <= K * 2.0 ** -24 * float(exact.abs().max())


def test_bf16_pair_keeps_sixteen_bits():
    x = torch.from_numpy(rng.random(4096).astype(np.float32))
    hi, lo = SF.bf16_pair(x)
    assert hi.dtype == lo.dtype == BF16
    err = (hi.double() + lo.double() - x.double()).abs()
    assert float((err / x.double().abs()).max()) <= 2.0 ** -16
    assert torch.equal(hi, x.to(BF16))


@pytest.mark.parametrize("D", [64, 80, 128, 256])
def test_native_b4_products_hold_the_bf16_rule(D):
    """Attention as B4's bfloat16 instances form it: q k^T one bfloat16
    product, p split into hi and lo, p v two, the output rounded to
    bfloat16; causal (the HuBERT head dim 80 too), one batch, two heads,
    a prompt of 512."""
    S = 512
    q, k, v = (_bf16(1, 2, S, D) for _ in range(3))
    got = SF.attention(q, k, v, causal=True,
                       product=lambda a, b: SF.bf16_matmul(
                           a.to(BF16), b.to(BF16)),
                       pv=SF.bf16_pv).to(BF16)
    plain = FA.flash_attention_plain(q, k, v, True)
    f64 = FA.flash_attention_plain(q.double(), k.double(), v.double(), True)
    assert _rule(got, plain, f64) <= 1.0


def _anchored(fn, args):
    comp = stitched_jit(fn, device="cpu").compiled(*args)
    ems = [e for e in comp.emitted if e.kind == "anchored"]
    assert len(ems) == 1, comp.report.schedules
    return ems[0]


def _gate(x, wg, u):
    return F.silu(x @ wg) * u


@pytest.mark.parametrize("lhs,rhs", [(BF16, BF16), (BF16, torch.float32),
                                     (torch.float32, BF16)])
def test_emitted_source_picks_native_for_bf16_and_tf32_for_mixed(
        anchoring_on, lhs, rhs):
    """bfloat16 x bfloat16: the native template; one side float32: the
    TF32 split, with exactly one side marked bfloat16 (``kExact`` for the
    lhs, ``kRhsBf16`` for the rhs), which its template asserts."""
    x, wg = _bf16(64, 96).to(lhs), _bf16(96, 128, scale=0.1).to(rhs)
    u = _bf16(64, 128).to(torch.promote_types(lhs, rhs))
    em = _anchored(_gate, (x, wg, u))
    src = em.fn.entry.source
    native = lhs == rhs == BF16
    assert em.fn.entry.native == native
    if native:
        assert '#include "matmul_bf16.cuh"' in src
        assert "repro_mm::launch_bf16<" in src
        assert "repro_mm::launch<" not in src
        assert "repro_mm::native_smem_bytes(" in src
    else:
        assert '#include "matmul_fused.cuh"' in src
        assert "repro_mm::launch<" in src and "launch_bf16" not in src
        flags = [re.search(rf"static constexpr bool {k} = (\w+);",
                           src).group(1) == "true"
                 for k in ("kExact", "kRhsBf16")]
        assert flags == [lhs == BF16, rhs == BF16]


_SMEM_HARNESS = """#include "matmul_bf16.cuh"
extern "C" int smem(int bm, int bn, int st, int wn, int am, int es,
                    int ps) {
  return repro_mm::native_smem_bytes(bm, bn, st, wn, am, es, ps);
}
"""


def test_native_tile_smem_is_the_headers_and_fits(tmp_path):
    lib = gxx(tmp_path, _SMEM_HARNESS, "native_smem")
    lib.smem.restype = ctypes.c_int
    lib.smem.argtypes = [ctypes.c_int] * 7
    assert len(MM.NATIVE_TILES) == len(MM.TILES)
    for t, f in zip(MM.NATIVE_TILES, MM.TILES):
        # the same role at the same index: rows, warpgroups along N, lhs
        assert t.native and not f.native
        assert (t.bm, t.wn, t.am) == (f.bm, f.wn, f.am)
        for es, ps in ((0, 0), (1, 0), (0, 2), (3, 1)):
            want = lib.smem(t.bm, t.bn, t.stages, t.wn, t.am, es, ps)
            assert t.smem(es, ps) == want <= 232_448


def _attn_graph(dtype, D):
    q, k, v = (torch.randn(1, 2, 16, D).to(dtype) for _ in range(3))
    bias = torch.randn(1, 2, 16, 16).to(dtype)

    def bias_attn(q, k, v, bias):
        s = q @ k.transpose(-1, -2) * (q.shape[-1] ** -0.5) + bias
        return torch.softmax(s, -1) @ v

    g = stitched_jit(bias_attn, dispatch="interpret",
                     device="cpu").compiled(q, k, v, bias).graph
    dots = tuple(n for n in g.nodes if g.node(n).prim == "dot_general")
    body = frozenset(n for n in g.nodes if n not in dots and g.node(n).kind
                     not in (OpKind.INPUT, OpKind.CONST))
    return g, dots, [body]


@pytest.mark.parametrize("D", [320, 384, 512])
def test_gate_prices_wide_bf16_attention(D):
    g, a, parts = _attn_graph(BF16, D)
    got = cost_model._anchor_vmem_gpu(g, a, parts)
    assert got == FA.flash_smem_bytes(D, 2) <= 232_448
    assert got < FA.flash_smem_bytes(D)


def test_wide_bf16_smem_is_the_sources():
    """The bfloat16 shared memory the wrappers price is the bytes the
    sources list for each instance, and the B4 bfloat16 tile constants
    are the source's."""
    wide = " ".join((CSRC / "flash_attention_wide.cuh").read_text()
                    .replace("//", " ").split())
    listed = {320: 89_088, 384: 97_280, 448: 105_472, 512: 113_664}
    for d, nbytes in listed.items():
        assert f"{d}: {nbytes:,}" in wide
        assert FA.flash_smem_bytes(d, 2) == nbytes
    assert "above 512: 74,752" in wide
    assert FA.flash_smem_bytes(1024, 2) == 74_752
    cuh = (CSRC / "flash_attention.cuh").read_text()
    kmax, kbig, ksmall = map(int, re.search(
        r"bf16_kbk\(int d\) \{ return d <= (\d+) \? (\d+) : (\d+);",
        cuh).groups())
    assert kmax == FA.FLASH_BF16_KBK_MAX_D and (kbig, ksmall) == (64, 32)
    warps = int(re.search(r"constexpr int kBf16Warps = (\d+);",
                          cuh).group(1))
    assert 16 * warps == FA.FLASH_BF16_BQ
    text = " ".join(cuh.replace("//", " ").split())
    for d, nbytes in {64: 46_080, 80: 56_320, 128: 52_224,
                      256: 101_376}.items():
        assert f"{d}: {nbytes:,}" in text
        assert FA.flash_smem_bytes(d, 2) == nbytes <= 232_448


def _close_bf16(got: torch.Tensor, want: np.ndarray):
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=2.0 ** -7, atol=2.0 ** -7)


#: (Hq, Hkv, Sq, Skv, causal): causal, grouped heads with a causal offset
#: (Sq < Skv, a ragged last block), non-causal
WIDE_CASES = {"causal": (2, 2, 40, 40, True),
              "gqa-offset": (4, 2, 24, 40, True),
              "noncausal": (2, 2, 24, 40, False)}


@pytest.mark.parametrize("case", sorted(WIDE_CASES))
def test_wide_bf16_matches_the_pallas_kernel(case):
    Hq, Hkv, Sq, Skv, causal = WIDE_CASES[case]
    D = 320
    q = rng.standard_normal((1, Hq, Sq, D)).astype(np.float32)
    k = rng.standard_normal((1, Hkv, Skv, D)).astype(np.float32)
    v = rng.standard_normal((1, Hkv, Skv, D)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(BF16) for a in (q, k, v))
    want = jflash(*(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
                    for t in (tq, tk, tv)),
                  causal=causal, block_q=16, block_k=16, interpret=True)
    got = FA.flash_attention(tq, tk, tv, causal, None)
    assert got.dtype == BF16 and got.shape == (1, Hq, Sq, D)
    _close_bf16(got, np.asarray(want.astype(jnp.float32)))


def test_wide_bf16_score_mod_matches_the_pallas_kernel():
    """A bias folded as the wide kernel's score functor: the plain
    version on the CPU, against the reference's ``score_mod``."""
    B, H, S, D = 1, 2, 40, 320
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, S, D))
                                .astype(np.float32)).to(BF16)
               for _ in range(3))
    bias = torch.from_numpy(rng.standard_normal((1, 1, S, S))
                            .astype(np.float32)).to(BF16)
    scale = 1.0 / math.sqrt(D)
    want = jflash(*(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
                    for t in (q, k, v)),
                  causal=True, scale=scale, block_q=16, block_k=16,
                  interpret=True, score_mod=lambda s, b: s + b,
                  score_args=(jnp.asarray(bias.float().numpy(),
                                          dtype=jnp.bfloat16),))
    mod = FA.ScoreMod(lambda s, b: s + b.float(), entry=None, wide=True)
    got = FA.flash_attention(q, k, v, True, scale, score_mod=mod,
                             score_args=(bias,))
    assert got.dtype == BF16
    _close_bf16(got, np.asarray(want.astype(jnp.float32)))
