"""The hand-written kernels' bfloat16 instances on the card, each against
its plain version on the same bfloat16 inputs.

B6 (RMSNorm, x and the gain each float32 or bfloat16), B8 (flash decode,
q and the caches each float32 or bfloat16), B4 (flash attention at the
tuned head dims, with and without a generated score functor) and B3 (the
fused matmul: gate and up product, decode tile, reducing prologue,
epilogue across a cluster).  Each is held two ways: within the
reference's own bfloat16 band (``src/repro/runtime/guard.py:208-213``
for B6 and B8, the anchored band of :224-226 for B3 and B4), and no
less accurate than the plain version: against float64 of the same
bfloat16 inputs, the kernel's largest error is at most twice the plain
version's.  The kernels that stay float32-only raise ``TypeError`` on
bfloat16.

Marked ``gpu``: on a host without a CUDA card every test here skips (the
decision is made in a fixture, never at import).  Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_bf16_gpu.py
"""
import gc
import math

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro_torch.core import H100, OpKind, stitched_jit  # noqa: E402
from repro_torch.core.codegen import emit_group  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import layernorm as LN  # noqa: E402
from repro_torch.kernels import matmul as MM  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.kernels import softmax as SM  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

pytestmark = pytest.mark.gpu

BF16 = torch.bfloat16
#: the reference's bfloat16 bands (rtol, atol): memory kernels, anchored
BAND = (2e-2, 2e-2)
BAND_ANCHORED = (4e-2, 1.2e-1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.Generator(device="cuda").manual_seed(0)
    # the decode_32k rows hold gigabytes: give them back to the card for
    # the files that run after these
    gc.collect()
    torch.cuda.empty_cache()


def _randn(gen, *shape, scale=1.0, dtype=BF16):
    return (torch.randn(*shape, generator=gen, device="cuda")
            * scale).to(dtype)


def hold(got, plain, exact, band):
    """``got`` within ``band`` of ``plain``, and its largest distance
    from the float64 ``exact`` at most twice ``plain``'s."""
    rtol, atol = band
    g, p, e = got.double(), plain.double(), exact.double()
    assert got.dtype == plain.dtype
    assert bool(((g - p).abs() <= atol + rtol * p.abs()).all()), \
        float((g - p).abs().max())
    err, perr = float((g - e).abs().max()), float((p - e).abs().max())
    assert err <= 2.0 * perr, (err, perr)


@pytest.mark.parametrize("R,C", [(2048, 3072), (4, 3072), (37, 200),
                                 (5, 203), (4096, 3072), (16384, 1024)])
@pytest.mark.parametrize("xd,gd", [(BF16, BF16), (BF16, torch.float32),
                                   (torch.float32, BF16)])
def test_b6_rmsnorm_takes_bfloat16(cuda, R, C, xd, gd):
    """The block path, the scalar path (a width no multiple of 4) and, at
    [4096, 3072] and [16384, 1024], the ring (its rows fill the card's
    resident warps in either type)."""
    x = _randn(cuda, R, C, dtype=xd)
    g = (1.0 + 0.1 * _randn(cuda, C, dtype=torch.float32)).to(gd)
    before = RN.rmsnorm_cuda.launches
    y, rstd = RN.rmsnorm_cuda(x, g, 1e-6)
    assert RN.rmsnorm_cuda.launches == before + 1
    yp, rp = RN.rmsnorm_plain(x, g, 1e-6)
    assert y.dtype == xd and rstd.dtype == torch.float32
    xd64 = x.double()
    exact = xd64 * torch.rsqrt((xd64 ** 2).mean(-1, keepdim=True) + 1e-6) \
        * g.double()
    hold(y, yp, exact, BAND)
    torch.testing.assert_close(rstd, rp, rtol=1e-5, atol=1e-6)


def _decode_exact(q, k, v, scale):
    """The decode in float64, each KV head's query heads grouped (K and V
    widened once, not repeated)."""
    B, Hq, D = q.shape
    Hkv = k.shape[1]
    qg = q.double().reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bkgd,bksd->bkgs", qg, k.double()) * scale
    return torch.einsum("bkgs,bksd->bkgd", torch.softmax(s, -1),
                        v.double()).reshape(B, Hq, D)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,kv_len", [
    (4, 24, 8, 32768, 128, None), (2, 8, 2, 1000, 64, 777),
    (1, 8, 2, 600, 80, 513), (2, 16, 8, 300, 256, None),
    (1, 8, 2, 400, 320, 399), (1, 4, 2, 300, 640, None),
    (1, 8, 2, 300, 512, None), (1, 4, 2, 200, 84, 150)])
@pytest.mark.parametrize("cache", [torch.float32, BF16])
def test_b8_flash_decode_takes_bfloat16(cuda, B, Hq, Hkv, S, D, kv_len,
                                        cache):
    q = _randn(cuda, B, Hq, D)
    k = _randn(cuda, B, Hkv, S, D, dtype=cache)
    v = _randn(cuda, B, Hkv, S, D, dtype=cache)
    before = FA.flash_decode_cuda.launches
    o = FA.flash_decode_cuda(q, k, v, kv_len)
    assert FA.flash_decode_cuda.launches > before
    plain = FA.flash_decode_plain(q, k, v, kv_len)
    assert o.dtype == BF16
    eff = FA.live_len(kv_len, S)
    exact = _decode_exact(q, k[:, :, :eff], v[:, :, :eff], 1 / math.sqrt(D))
    hold(o, plain, exact, BAND)


def test_b8_float32_q_against_a_bfloat16_cache(cuda):
    q = _randn(cuda, 4, 24, 128, dtype=torch.float32)
    k, v = (_randn(cuda, 4, 8, 4096, 128) for _ in range(2))
    o = FA.flash_decode_cuda(q, k, v, 3000)
    assert o.dtype == torch.float32
    exact = _decode_exact(q, k[:, :, :3000], v[:, :, :3000],
                          1 / math.sqrt(128))
    plain = FA.flash_decode_plain(q, k, v, 3000)
    assert float((o.double() - exact).abs().max()) <= 1e-5
    assert float((plain.double() - exact).abs().max()) <= 1e-5


def _attn_exact(q, k, v, causal, bias=None):
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kk = k.double().repeat_interleave(Hq // Hkv, 1)
    vv = v.double().repeat_interleave(Hq // Hkv, 1)
    s = q.double() @ kk.transpose(-1, -2) / math.sqrt(D)
    if bias is not None:
        s = s + bias.double()
    if causal:
        row = torch.arange(Sq, device="cuda")[:, None] + (Skv - Sq)
        s = s.masked_fill(row < torch.arange(Skv, device="cuda"), -1e30)
    return torch.softmax(s, -1) @ vv


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", [
    (4, 24, 8, 512, 512, 128, True), (2, 8, 8, 300, 300, 64, True),
    (2, 8, 2, 200, 333, 80, False), (1, 4, 4, 130, 130, 96, True),
    (2, 8, 4, 256, 256, 256, True), (1, 2, 2, 100, 260, 128, True)])
def test_b4_flash_attention_takes_bfloat16(cuda, B, Hq, Hkv, Sq, Skv, D,
                                           causal):
    q = _randn(cuda, B, Hq, Sq, D)
    k, v = (_randn(cuda, B, Hkv, Skv, D) for _ in range(2))
    before = FA.flash_attention_cuda.launches
    o = FA.flash_attention_cuda(q, k, v, causal)
    assert FA.flash_attention_cuda.launches == before + 1
    plain = FA.flash_attention_plain(q, k, v, causal)
    assert o.dtype == BF16
    hold(o, plain, _attn_exact(q, k, v, causal), BAND_ANCHORED)


def _bias_attn(q, k, v, bias):
    s = q @ k.transpose(-1, -2) * (q.shape[-1] ** -0.5) + bias
    return torch.softmax(s, -1) @ v


@pytest.mark.parametrize("D", [64, 128, 256])
def test_b4_score_mod_takes_bfloat16(cuda, D):
    """Llama's heads with a bias folded as a generated score functor (the
    anchored attention of ``stitched_jit``) in bfloat16."""
    B, H, S = 2, 24, 512
    q, k, v = (_randn(cuda, B, H, S, D) for _ in range(3))
    bias = _randn(cuda, 1, H, S, S, scale=0.5)
    comp = stitched_jit(_bias_attn).compiled(q, k, v, bias)
    em = [e for e in comp.emitted if e.kind == "anchored"]
    assert len(em) == 1 and em[0].fn.score_mod is not None
    em = em[0]
    given = dict(zip(comp.graph.inputs, (q, k, v, bias)))
    vals = [given[i] for i in em.ext_ids]
    before = FA.ScoreMod.launches
    got = em.fn.launch(*vals)[0]
    assert FA.ScoreMod.launches == before + 1
    plain = em.fn.plain(*vals)[0]
    exact = _attn_exact(q, k, v, False, bias)
    assert got.dtype == BF16
    hold(got, plain, exact, BAND_ANCHORED)


def _forced_b3(fn, args):
    """(compiled, B3 group) of ``fn``'s one product with its whole chains,
    emitted for the card whatever the cost model picks."""
    comp = stitched_jit(fn, dispatch="interpret").compiled(*args)
    g = comp.graph
    a = next(n for n in g.nodes if g.node(n).prim == "dot_general")
    _, anc = g.reachability()
    body = [n for n in g.nodes if n != a and g.node(n).kind
            not in (OpKind.INPUT, OpKind.CONST)]
    pro = frozenset(n for n in body if (anc[a] >> n) & 1)
    parts = [p for p in (pro, frozenset({a}), frozenset(body) - pro) if p]
    return comp, emit_group(g, parts, hw=H100, anchors=(a,))


def gate_up(x, wg, u):
    return F.silu(x @ wg) * u


def rms_proj(x, g, w):
    xf = x.float()
    h = (xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + 1e-6)
         * g).to(x.dtype)
    return h @ w


def softmax_proj(x, w):
    return torch.softmax((x @ w).float(), -1)


@pytest.mark.parametrize("form,M,K,N", [
    ("gate_up", 2048, 3072, 8192), ("gate_up", 4, 3072, 8192),
    ("gate_up", 200, 96, 300), ("rms_proj", 2048, 3072, 512),
    ("rms_proj", 5, 3072, 1024), ("softmax_proj", 100, 64, 300),
    ("softmax_proj", 4, 3072, 2000)])
def test_b3_takes_bfloat16(cuda, form, M, K, N):
    fn = {"gate_up": gate_up, "rms_proj": rms_proj,
          "softmax_proj": softmax_proj}[form]
    x = _randn(cuda, M, K)
    w = _randn(cuda, K, N, scale=K ** -0.5)
    args = {"gate_up": (x, w, _randn(cuda, M, N)),
            "rms_proj": (x, (1.0 + 0.1 * _randn(cuda, K)), w),
            "softmax_proj": (x, w)}[form]
    comp, em = _forced_b3(fn, args)
    given = dict(zip(comp.graph.inputs, args))
    vals = [given[i] for i in em.ext_ids]
    before = MM.matmul_fused.launches
    got = em.fn.launch(*vals)
    assert MM.matmul_fused.launches == before + 1
    want = em.fn.plain(*vals)
    exact = fn(*(a.double() for a in args))
    for g, w in zip(got, want):
        hold(g.reshape(exact.shape), w.reshape(exact.shape), exact,
             BAND_ANCHORED)
    torch.testing.assert_close(stitched_jit(fn)(*args), fn(*args),
                               rtol=BAND_ANCHORED[0], atol=BAND_ANCHORED[1])


def test_float32_only_kernels_refuse_bfloat16(cuda):
    """B5/B9, B7/B10, B11 and the wide flash kernel raise on bfloat16:
    none takes a plain version on the card."""
    x = _randn(cuda, 8, 256)
    g = torch.ones(256, device="cuda", dtype=BF16)
    with pytest.raises(TypeError):
        LN.layernorm_cuda(x, g, g, 1e-6)
    with pytest.raises(TypeError):
        SM.softmax_cuda(x)
    q = _randn(cuda, 1, 2, 64, 320)
    with pytest.raises(TypeError):
        FA.flash_attention_cuda(q, q, q, True)
    xs = _randn(cuda, 1, 64, 2, 16)
    dt = torch.full((1, 64, 2), 0.1, device="cuda")
    A = -torch.ones(2, device="cuda")
    Bc = _randn(cuda, 1, 64, 16)
    with pytest.raises(TypeError):
        SSD.ssd_scan_cuda(xs, dt, A, Bc, Bc, 64)


def test_the_plain_versions_compute_in_float32(cuda):
    """The plain versions the kernels are held to widen bfloat16 to
    float32 and round the output once, as the kernels do."""
    q, k, v = (_randn(cuda, 1, 2, 64, 64) for _ in range(3))
    want = ref.attention(q.float(), k.float(), v.float()).to(BF16)
    assert torch.equal(FA.flash_attention_plain(q, k, v), want)
