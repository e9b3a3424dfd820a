"""The anchored kernels' bfloat16 chains on the CPU.

Each generated chain (B3's prologue, plain and reducing; its epilogue,
with the accumulator rounded to the product's type as the reference's
``anchor_dtype``, and one that reduces across N tiles; B4's score
functor) is built for the host with g++ (``tests/_host_build.py``) and
held to the plain row-view evaluator on the same bfloat16 operands.  A
bfloat16 value computes in float32 and rounds to its type at its node in
both, so they differ only where a row reduction sums in another order: a
rounded statistic one ulp apart moves the values it scales by a fraction
of an ulp, and their own rounding by one more, so each output is held
within two bfloat16 ulps of its binade.  The H100 gate admits bfloat16
chains and still refuses float16.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro_torch.core import H100, OpKind, stitched_jit  # noqa: E402
from repro_torch.core import cost_model  # noqa: E402
from repro_torch.core.codegen import emit_group  # noqa: E402
from repro_torch.core.tracer import const_tensor  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import matmul as MM  # noqa: E402
from _host_build import gxx, ptrs  # noqa: E402

BF16 = torch.bfloat16
_ROLE_SHAPE = {"full": lambda R, C: (R, C), "row": lambda R, C: (R, 1),
               "col": lambda R, C: (1, C), "scalar": lambda R, C: ()}


@pytest.fixture
def anchoring_on(monkeypatch):
    monkeypatch.delenv("REPRO_ANCHOR", raising=False)


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as the host harness reads it: bfloat16 as its bits."""
    t = t.contiguous()
    if t.dtype == BF16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def _from_host(a: np.ndarray, dtype) -> torch.Tensor:
    if dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(BF16)
    return torch.from_numpy(a)


def _close(got: torch.Tensor, want: torch.Tensor):
    """Within two bfloat16 ulps of the binade of ``want`` (of 2^-6 at
    least, for values near zero)."""
    g, w = got.double(), want.double()
    assert got.dtype == want.dtype
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2.0 ** -6)))
                     - 7)
    assert bool(((g - w).abs() <= 2 * ulp).all()), \
        float((g - w).abs().max())


def _b3_parts(g):
    """(anchor, parts) of a graph's one product with its whole prologue
    and epilogue chains."""
    a = next(n for n in g.nodes if g.node(n).prim == "dot_general")
    _, anc = g.reachability()
    body = [n for n in g.nodes if n != a and g.node(n).kind
            not in (OpKind.INPUT, OpKind.CONST)]
    pro = frozenset(n for n in body if (anc[a] >> n) & 1)
    return a, [p for p in (pro, frozenset({a}), frozenset(body) - pro) if p]


def _forced_b3(fn, args):
    """(compiled, B3 group) of ``fn``, emitted for the card whatever the
    cost model picks."""
    comp = stitched_jit(fn, dispatch="interpret", device="cpu").compiled(
        *args)
    a, parts = _b3_parts(comp.graph)
    return comp, emit_group(comp.graph, parts, hw=H100, anchors=(a,))


def gate_up(x, w, u):
    return F.silu(x @ w) * u


def rms_proj(x, g, w):
    xf = x.float()
    return (xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + 1e-6)
            * g).to(x.dtype) @ w


def rms_proj_bf16(x, g, w):
    return (x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * g) @ w


def softmax_proj(x, w):
    return torch.softmax(x @ w, -1)


def scaled_proj(x, w):
    return (x @ w) * 0.5


CHAINS = {"gate_up": (gate_up, lambda r: (r(40, 96), r(96, 300, s=0.1),
                                          r(40, 300))),
          "rms_prologue": (rms_proj, lambda r: (r(40, 96), r(96), r(96, 72))),
          "rms_prologue_bf16": (rms_proj_bf16,
                                lambda r: (r(40, 96), r(96), r(96, 72))),
          "softmax_across_tiles": (softmax_proj,
                                   lambda r: (r(24, 64), r(64, 600, s=0.1))),
          "identity_prologue": (scaled_proj,
                                lambda r: (r(8, 64), r(64, 40)))}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_bfloat16_b3_chains_match_the_plain_evaluator(tmp_path, name):
    fn, make = CHAINS[name]
    gen = torch.Generator().manual_seed(7)

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen) * s).to(BF16)

    args = make(r)
    comp, em = _forced_b3(fn, args)
    ch, graph = em.fn.chain, comp.graph
    M, K, N = ch["M"], ch["K"], ch["N"]
    src = em.fn.entry.source
    assert "kRhsBf16 = true" in src
    if name in ("gate_up", "softmax_across_tiles", "identity_prologue"):
        assert "kExact = true" in src and "kStagedBf16 = true" in src
    if name == "softmax_across_tiles":
        assert em.fn.tile == MM.TILES.index(MM.TILE_ROW) and N > 256
    lib = gxx(tmp_path, src, name)
    given = dict(zip(comp.graph.inputs, args))

    pro = [given[i].reshape(_ROLE_SHAPE[r_](M, K)) if i in given else None
           for i, r_ in zip(ch["pro_ops"], ch["pro_roles"])]
    want = (ch["prologue"](*[MM._view(t, r_, M, K) for t, r_ in
                             zip(pro, ch["pro_roles"])])
            if ch["prologue"] else pro[0])
    pro_host = [_host(t) for t in pro]    # alive through the calls
    for entry in (lib.repro_host_pro, lib.repro_host_pro_staged):
        lhs = np.empty((M, K), np.float32)
        entry(ptrs(pro_host),
              lhs.ctypes.data_as(ctypes.c_void_p), ctypes.c_longlong(M),
              ctypes.c_longlong(K))
        _close(torch.from_numpy(lhs).to(want.dtype), want)

    acc = torch.randn(M, N, generator=gen) * 3.0
    epi = [given[i].reshape(_ROLE_SHAPE[r_](M, N))
           for i, r_ in zip(ch["epi_ops"], ch["epi_roles"])]
    outs = [np.zeros(_ROLE_SHAPE[r_](M, N) or (1, 1),
                     np.uint16 if dt == BF16 else np.float32)
            for r_, dt in zip(ch["out_roles"], ch["out_dtypes"])]
    epi_host = [_host(t) for t in epi]
    lib.repro_host_epi(acc.numpy().ctypes.data_as(ctypes.c_void_p),
                       ptrs(epi_host), ptrs(outs),
                       ctypes.c_longlong(M), ctypes.c_longlong(N))
    tepi = [MM._view(t, r_, M, N) for t, r_ in zip(epi, ch["epi_roles"])]
    if ch["epilogue"]:
        wants = ch["epilogue"](acc, *tepi)
    else:       # the product alone, in its type
        wants = (acc.to(ch["out_dtypes"][0]),)
    for o, w, r_, dt in zip(outs, wants, ch["out_roles"], ch["out_dtypes"]):
        shape = _ROLE_SHAPE[r_](M, N) or (1, 1)
        _close(_from_host(o, dt).reshape(shape), w.expand(shape).to(dt))


def test_bfloat16_epilogue_rounds_the_product_first():
    """The plain epilogue and the generated one both take the product in
    its type: a product that bfloat16 cannot hold changes the output."""
    gen = torch.Generator().manual_seed(1)
    x, w, u = (torch.randn(*s, generator=gen).to(BF16)
               for s in ((8, 32), (32, 40), (8, 40)))
    comp, em = _forced_b3(gate_up, (x, w, u))
    assert "repro_chain::round_bf16(acc)" in em.fn.entry.source
    acc = torch.full((8, 40), 1.0 + 2.0 ** -10)
    ch = em.fn.chain
    got = ch["epilogue"](acc, u)[0]
    assert torch.equal(got, F.silu(torch.ones(8, 40, dtype=BF16)) * u)


def _bias_attn(q, k, v, bias):
    s = q @ k.transpose(-1, -2) * (q.shape[-1] ** -0.5) + bias
    return torch.softmax(s, -1) @ v


def test_bfloat16_score_functor_matches_the_plain_evaluator(tmp_path,
                                                            anchoring_on):
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 2, 16, 64, generator=gen).to(BF16)
               for _ in range(3))
    bias = torch.randn(1, 2, 16, 16, generator=gen).to(BF16)
    c = stitched_jit(_bias_attn, device="cpu").compiled(q, k, v, bias)
    em = [e for e in c.emitted if e.kind == "anchored"]
    assert len(em) == 1 and em[0].fn.score_mod is not None
    em = em[0]
    mod = em.fn.score_mod
    assert "run<uint16_t>" in mod.entry.source
    assert "repro_chain::round_bf16(s)" in mod.entry.source
    lib = gxx(tmp_path, mod.entry.source, "score")
    B, H, Sq, Sk = em.fn.extent
    s = torch.randn(B, H, Sq, Sk, generator=gen) * 4.0
    given = dict(zip(c.graph.inputs, (q, k, v, bias)))
    ops = [(given[i] if i in given else const_tensor(c.graph.node(i), "cpu"))
           .reshape(sh).contiguous() for i, sh in em.fn.score_operands]
    st = []
    for a in ops:
        st += [x if d != 1 else 0 for x, d in zip(a.stride(), a.shape)]
    out = np.empty((B, H, Sq, Sk), np.float32)
    ops_host = [_host(a) for a in ops]
    lib.repro_host_score(s.numpy().ctypes.data_as(ctypes.c_void_p),
                         ptrs(ops_host),
                         (ctypes.c_longlong * max(4, len(st)))(*st),
                         out.ctypes.data_as(ctypes.c_void_p), B, H, Sq, Sk)
    want = mod.plain(s, *ops)
    _close(torch.from_numpy(out).to(want.dtype), want)
    torch.testing.assert_close(c.run_schedule(q, k, v, bias)[0],
                               _bias_attn(q, k, v, bias), rtol=4e-2,
                               atol=1.2e-1)


def _gate_graph(dtype):
    args = (torch.randn(8, 64).to(dtype), torch.randn(64, 96).to(dtype),
            torch.randn(8, 96).to(dtype))
    g = stitched_jit(gate_up, dispatch="interpret",
                     device="cpu").compiled(*args).graph
    a, parts = _b3_parts(g)
    return g, (a,), parts


def _attn_graph(dtype, D):
    q, k, v = (torch.randn(1, 2, 16, D).to(dtype) for _ in range(3))
    bias = torch.randn(1, 2, 16, 16).to(dtype)
    g = stitched_jit(_bias_attn, dispatch="interpret",
                     device="cpu").compiled(q, k, v, bias).graph
    dots = tuple(n for n in g.nodes if g.node(n).prim == "dot_general")
    body = frozenset(n for n in g.nodes if n not in dots and g.node(n).kind
                     not in (OpKind.INPUT, OpKind.CONST))
    return g, dots, [body]


def test_h100_gate_admits_bfloat16_and_refuses_float16():
    # a bfloat16 lhs and rhs: the native instance's own decode tile
    g, a, parts = _gate_graph(BF16)
    assert cost_model._anchor_vmem_gpu(g, a, parts) \
        == MM.NATIVE_DECODE.smem(0, 0) != MM.TILE_DECODE.smem(0, 0)
    g, a, parts = _gate_graph(torch.float16)
    assert cost_model._anchor_vmem_gpu(g, a, parts) is None
    g, a, parts = _attn_graph(BF16, 128)
    assert cost_model._anchor_vmem_gpu(g, a, parts) \
        == FA.flash_smem_bytes(128, 2) < FA.flash_smem_bytes(128)
    # above head dim 256 the wide kernel's bfloat16 instance
    g, a, parts = _attn_graph(BF16, 320)
    assert cost_model._anchor_vmem_gpu(g, a, parts) \
        == FA.flash_smem_bytes(320, 2) < FA.flash_smem_bytes(320)
    g, a, parts = _attn_graph(torch.float16, 320)
    assert cost_model._anchor_vmem_gpu(g, a, parts) is None
    g, a, parts = _attn_graph(torch.float32, 320)
    assert cost_model._anchor_vmem_gpu(g, a, parts) \
        == FA.flash_smem_bytes(320)
