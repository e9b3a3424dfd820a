"""The anchored kernels' newer forms and ``stitched_jit(differentiable=True)``
on the card, each against its plain version.

* B3 with a prologue that reduces over K (its row statistics first),
  emitted whatever the cost model picks (it folds such a prologue only
  into a narrow projection);
* B3 with an epilogue that reduces across the N tiles of a thread-block
  cluster (and with more row reductions than the kernel once held);
* the wide flash kernel (head dims above 256) with a generated score
  functor, non-causal through ``stitched_jit`` and causal called directly;
* a differentiable stitched call, forward and backward, against plain
  autograd, and a plain stitched call whose inputs require grad.

Marked ``gpu``: on a host without a CUDA card every test here skips (the
decision is made in a fixture, never at import).  Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_anchor_forms_gpu.py
"""
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro_torch.core import H100, OpKind, stitched_jit  # noqa: E402
from repro_torch.core.codegen import emit_group  # noqa: E402
from repro_torch.core.tracer import const_tensor, run_subgraph  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import matmul as MM  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * scale


def rms_proj(x, g, w):
    return (x * torch.rsqrt((x ** 2).mean(-1, keepdim=True) + 1e-6) * g) @ w


def ln_proj(x, g, b, w):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return ((x - m) * torch.rsqrt(v + 1e-5) * g + b) @ w


def softmax_proj(x, w):
    return torch.softmax(x @ w, -1)


def row_maxima(x, w):
    h = x @ w
    out = h
    for i in range(12):
        out = out - (h * float(i + 1)).amax(-1, keepdim=True)
    return out


def attn(q, k, v, bias):
    s = q @ k.transpose(-1, -2) * (q.shape[-1] ** -0.5) + bias
    return torch.softmax(s, -1) @ v


def _anchored(fn, args):
    comp = stitched_jit(fn).compiled(*args)
    ems = [e for e in comp.emitted if e.kind == "anchored"]
    assert len(ems) == 1, comp.report.schedules
    return comp, ems[0]


def _forced_b3(fn, args):
    """(compiled, B3 group) of ``fn``'s one product with its whole
    prologue and epilogue chains, emitted for the card whatever the cost
    model picks (a reducing prologue that reads more than it saves stays
    memory-only in the plan)."""
    comp = stitched_jit(fn, dispatch="interpret").compiled(*args)
    g = comp.graph
    a = next(n for n in g.nodes if g.node(n).prim == "dot_general")
    _, anc = g.reachability()
    body = [n for n in g.nodes if n != a and g.node(n).kind
            not in (OpKind.INPUT, OpKind.CONST)]
    pro = frozenset(n for n in body if (anc[a] >> n) & 1)
    parts = [p for p in (pro, frozenset({a}), frozenset(body) - pro) if p]
    return comp, emit_group(g, parts, hw=H100, anchors=(a,))


def _hold_b3(fn, args, counter):
    """The B3 instance of ``fn`` against its plain version: within 1e-5
    max(1, max|plain|) plus three times the plain version's own float32
    distance from float64 (``chip_smoke.B3_RTOL``); the form's counter
    moved; the planned call (anchored or not) is the function."""
    comp, em = _forced_b3(fn, args)
    given = dict(zip(comp.graph.inputs, args))
    vals = [given[i] for i in em.ext_ids]
    before = counter.launches
    got = em.fn.launch(*vals)
    want = em.fn.plain(*vals)
    env = {i: given[i].double() for i in em.ext_ids}
    run_subgraph(comp.graph, sorted(n for p in em.parts for n in p), env,
                 "cuda")
    exact = [env[o] for o in em.out_ids]
    for g, w, e in zip(got, want, exact):
        scale = max(1.0, float(w.abs().max()))
        limit = 1e-5 * scale + 3.0 * float((w.double() - e).abs().max())
        assert float((g - w).abs().max()) <= limit
    assert counter.launches == before + 1
    torch.testing.assert_close(stitched_jit(fn)(*args), fn(*args),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("M,K,N", [(200, 96, 300), (2048, 3072, 512),
                                   (5, 3072, 1024), (4, 100, 40)])
def test_b3_rmsnorm_prologue_on_the_card(cuda, M, K, N):
    args = (_randn(cuda, M, K), _randn(cuda, K),
            _randn(cuda, K, N, scale=K ** -0.5))
    _hold_b3(rms_proj, args, MM.PROLOGUE_REDUCE)


def test_b3_layernorm_prologue_two_levels_on_the_card(cuda):
    args = (_randn(cuda, 130, 200), _randn(cuda, 200), _randn(cuda, 200),
            _randn(cuda, 200, 72, scale=200 ** -0.5))
    _hold_b3(ln_proj, args, MM.PROLOGUE_REDUCE)


@pytest.mark.parametrize("M,K,N", [(100, 64, 300), (2048, 3072, 2048),
                                   (4, 3072, 2000)])
def test_b3_softmax_epilogue_across_a_cluster_on_the_card(cuda, M, K, N):
    args = (_randn(cuda, M, K), _randn(cuda, K, N, scale=K ** -0.5))
    _hold_b3(softmax_proj, args, MM.CLUSTER_EPILOGUE)


def test_b3_reducing_prologue_and_epilogue_together_on_the_card(cuda):
    """An RMSNorm feeding the product and a softmax after it: the row
    tile's cluster shares the prologue's statistics and exchanges the
    epilogue's partials."""
    args = (_randn(cuda, 300, 256), _randn(cuda, 256),
            _randn(cuda, 256, 700, scale=1 / 16))
    _hold_b3(lambda x, g, w: torch.softmax(rms_proj(x, g, w), -1), args,
             MM.PROLOGUE_REDUCE)


def test_b3_twelve_row_reductions_on_the_card(cuda):
    args = (_randn(cuda, 300, 256), _randn(cuda, 256, 700, scale=1 / 16))
    _hold_b3(row_maxima, args, MM.CLUSTER_EPILOGUE)


def _attn_reference(q, k, v, mod, sargs, causal):
    s = mod.plain(q.double() @ k.double().transpose(-1, -2),
                  *[a.double() for a in sargs])
    if causal:
        Sq, Sk = s.shape[-2:]
        s = s.masked_fill(torch.ones(Sq, Sk, dtype=torch.bool,
                                     device=s.device).triu(1), -1e30)
    return torch.softmax(s, -1) @ v.double()


@pytest.mark.parametrize("D", [264, 320, 640])
@pytest.mark.parametrize("causal", [False, True])
def test_wide_kernel_with_a_score_functor_on_the_card(cuda, D, causal):
    """The wide kernel's generated instance against the function in
    float64, within B4's limit: 1e-5 |ref| + 1e-5 mean|ref| an element."""
    B, H, S = 1, 2, 100
    args = tuple(_randn(cuda, *sh) for sh in ((B, H, S, D),) * 3
                 + ((1, 1, S, S),))
    comp, em = _anchored(attn, args)
    mod = em.fn.score_mod
    assert mod is not None and mod.wide
    given = dict(zip(comp.graph.inputs, args))
    sargs = [(given[i] if i in given else const_tensor(
        comp.graph.node(i), "cuda")).reshape(sh)
        for i, sh in em.fn.score_operands]
    before = FA.WIDE_SCORE_MOD.launches
    got = FA.flash_attention_cuda(*args[:3], causal, 1.0, score_mod=mod,
                                  score_args=sargs)
    assert FA.WIDE_SCORE_MOD.launches == before + 1
    want = _attn_reference(*args[:3], mod, sargs, causal)
    lim = 1e-5 * want.abs() + 1e-5 * float(want.abs().mean())
    assert bool(((got.double() - want).abs() <= lim).all())
    if not causal:
        torch.testing.assert_close(comp.run_schedule(*args)[0],
                                   attn(*args), rtol=1e-4, atol=1e-5)


def _llama_mlp_input(x, g, w_gate, w_up):
    h = x * torch.rsqrt((x ** 2).mean(-1, keepdim=True) + 1e-6) * g
    return F.silu(h @ w_gate) * (h @ w_up)


def _ln(x, g, b):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + 1e-6) * g + b


@pytest.mark.parametrize("name", ["layernorm", "llama_mlp_input"])
def test_differentiable_stitched_call_on_the_card(cuda, name):
    """Forward and backward on the card's kernels (the backward traced,
    stitched and launched on autograd's thread): each gradient within
    1e-4 max(1, max|g|) of plain autograd of the same function."""
    if name == "layernorm":
        fn, shapes = _ln, [(512, 768), (768,), (768,)]
        args = [_randn(cuda, *s) for s in shapes]
    else:
        fn = _llama_mlp_input
        args = [_randn(cuda, 256, 512), 1.0 + 0.1 * _randn(cuda, 512),
                _randn(cuda, 512, 1024, scale=512 ** -0.5),
                _randn(cuda, 512, 1024, scale=512 ** -0.5)]
    ins = [a.requires_grad_() for a in args]
    wrapped = stitched_jit(fn, differentiable=True)
    y = wrapped(*ins)
    assert y.grad_fn is not None and y.is_cuda
    got = torch.autograd.grad((y ** 2).sum(), ins)
    want = torch.autograd.grad((fn(*ins) ** 2).sum(), ins)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * max(
            1.0, float(w.abs().max()))
    assert wrapped.backward_reports()[0].n_groups >= 1


def test_plain_stitched_call_whose_inputs_require_grad(cuda):
    """Without ``differentiable``, a call on the card whose inputs require
    grad differentiates (as the reference's function does under
    ``jax.grad``), through the same stitched backward."""
    args = [_randn(cuda, 64, 96).requires_grad_(),
            _randn(cuda, 96).requires_grad_(),
            _randn(cuda, 96).requires_grad_()]
    sf = stitched_jit(_ln)
    y = sf(*args)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y.sum(), args)
    want = torch.autograd.grad(_ln(*args).sum(), args)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * max(
            1.0, float(w.abs().max()))
    with torch.no_grad():
        assert sf(*args).grad_fn is None
