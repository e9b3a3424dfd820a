"""Generated kernels on the card: each held against its plain version.

Marked ``gpu``: on a host without a CUDA card every test here skips (the
decision is made in a fixture, never at import).  Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import H100, stitched_jit  # noqa: E402
from repro_torch.core import codegen  # noqa: E402
from repro_torch.core.tracer import TORCH_DTYPES  # noqa: E402
from repro_torch.models.layers import XLA  # noqa: E402
from repro_torch.models.model import Model, block_apply  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def roles(x, rowb, colb, s):
    m = (x * colb).mean(-1, keepdim=True)
    y = (x - m) * colb + rowb * s
    return y, m * s, colb * 2.0 + s, s * 3.0


def fanout(x, g):
    t = x * g + 1.0
    us = [torch.tanh(t * (0.1 * (i + 1))) for i in range(6)]
    acc = x
    for u in us:
        acc = acc + u
    for u in us:
        acc = acc * (u + 0.5)
    return acc * acc.mean(-1, keepdim=True)


def rmsnorm(x, g):
    xf = x.float()
    return (xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + 1e-6)
            * g).to(x.dtype)


def rmsnorm_f32(x, g):
    """``rmsnorm`` with its float32 result, not cast back to x's dtype."""
    xf = x.float()
    return xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + 1e-6) * g


def _check(fn, args, hw, kind, atol=1e-4):
    """Every generated kernel of ``fn`` vs its plain version, then the
    whole stitched call vs the op-by-op replay."""
    comp = stitched_jit(fn, hw=hw).compiled(*args)
    assert kind in comp.report.schedules
    for em in comp.emitted:
        if not em.generated:
            continue
        vals = [torch.randn(comp.graph.node(i).spec.shape, device="cuda")
                .to(TORCH_DTYPES[comp.graph.node(i).spec.dtype])
                for i in em.ext_ids]
        got = em.fn.launch(*vals)
        want = em.fn.plain(torch.device("cuda"), *vals)
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), rtol=atol,
                                       atol=atol)
    out = stitched_jit(fn, hw=hw)(*args)
    ref = stitched_jit(fn, hw=hw, dispatch="interpret")(*args)
    for a, b in zip(torch.utils._pytree.tree_leaves(out),
                    torch.utils._pytree.tree_leaves(ref)):
        torch.testing.assert_close(a.float(), b.float(), rtol=atol,
                                   atol=atol)


def test_onepass_roles_ragged_rows(cuda):
    args = [torch.randn(37, 200, device="cuda"),
            torch.randn(37, 1, device="cuda"),
            torch.randn(200, device="cuda"), torch.randn((), device="cuda")]
    _check(roles, args, H100, "onepass")


def test_streaming_roles_ragged_tail_tile(cuda):
    args = [torch.randn(37, 2500, device="cuda"),
            torch.randn(37, 1, device="cuda"),
            torch.randn(2500, device="cuda"), torch.randn((), device="cuda")]
    # a 2048-element register cap: a 2500-wide row no longer fits one pass
    _check(roles, args, dataclasses.replace(H100, max_block_elems=2048),
           "streaming")


def test_onepass_recompute_flip(cuda):
    args = [torch.randn(64, 512, device="cuda"),
            torch.rand(512, device="cuda") + 0.5]
    tight = dataclasses.replace(H100, vmem_bytes=32 * 1024)
    comp = stitched_jit(fanout, hw=tight).compiled(*args)
    assert comp.report.n_recomputed > 0
    _check(fanout, args, tight, "onepass")


#: name -> (function, input shapes, bfloat16 first input): streaming
#: groups on the cluster kernel -- a row split across eight CTAs, a row
#: longer than eight stages hold, a width that is no multiple of 16 (the
#: stage filled by plain loads), a ragged tail (the last CTA's slice
#: shorter, rows no multiple of the plan's row block), a bfloat16 group
STREAM_CASES = {
    "cluster-8": (lambda v: torch.softmax(v, -1), [(64, 128256)], False),
    "longer-than-a-cluster": (lambda v: torch.softmax(v, -1), [(8, 600000)],
                              False),
    "odd-width": (lambda v: torch.softmax(v, -1), [(37, 30001)], False),
    "ragged-tail": (lambda v: torch.softmax(v, -1), [(37, 100000)], False),
    "bf16-rmsnorm": (rmsnorm, [(300, 30000), (30000,)], True),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_streaming_cluster_kernel_matches_plain(cuda, case):
    """The streaming kernel (one launch a call, counted) against its
    plain version, each element within 1e-5 |plain| + 1e-5 mean|plain|
    (float32 sums in another order).  A bfloat16 output is the same
    group's float32 output, from the same geometry and sum order, rounded
    to nearest even: bit for bit."""
    fn, shapes, bf16 = STREAM_CASES[case]
    args = [torch.randn(sh, device="cuda", generator=cuda) for sh in shapes]
    if bf16:
        args[0] = args[0].bfloat16()

    def streaming(f):
        comp = stitched_jit(f).compiled(*args)
        ems = [e for e in comp.emitted if e.kind == "streaming"]
        assert len(ems) == 1, comp.report.schedules
        given = dict(zip(comp.graph.inputs, args))
        return ems[0].fn, [given[i] for i in ems[0].ext_ids]

    kern, vals = streaming(rmsnorm_f32 if bf16 else fn)
    K, width, staged = kern.cluster()
    if case == "longer-than-a-cluster":
        assert K == 8 and staged < width
    if case == "ragged-tail":
        assert K == 8 and 0 < kern.C - (K - 1) * width < width
        assert kern.R % kern.BR
    before = codegen.StreamingKernel.launches
    got = kern("cuda", *vals)
    assert codegen.StreamingKernel.launches == before + 1
    want = kern.plain(torch.device("cuda"), *vals)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.float32
        limit = 1e-5 * b.abs() + 1e-5 * float(b.abs().mean())
        assert bool(((a - b).abs() <= limit).all())
    if bf16:
        kern16, vals16 = streaming(fn)
        assert kern16.cluster() == (K, width, staged)
        out = kern16("cuda", *vals16)[0]
        assert codegen.StreamingKernel.launches == before + 2
        assert out.dtype == torch.bfloat16
        assert torch.equal(out, got[0].to(torch.bfloat16))


def test_bf16_rmsnorm(cuda):
    args = [torch.randn(300, 3072, device="cuda").bfloat16(),
            torch.randn(3072, device="cuda")]
    # bf16 output: one bf16 ulp at magnitude ~4
    _check(rmsnorm, args, H100, "onepass", atol=3e-2)


def test_reduced_model_on_the_card(cuda):
    cfg = get_config("llama3.2-3b").reduced()
    model = Model(cfg, "xla")
    params = model.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), device="cuda",
                           generator=cuda)
    before = (codegen.OnePassKernel.launches,
              codegen.StreamingKernel.launches)
    logits, probs = model.forward(params, tokens)
    after = (codegen.OnePassKernel.launches,
             codegen.StreamingKernel.launches)
    assert sum(after) > sum(before)
    ref_logits, _ = Model(cfg, "xla", dispatch="interpret").forward(
        params, tokens)
    torch.testing.assert_close(logits, ref_logits, rtol=1e-4, atol=1e-4)
    block = stitched_jit(functools.partial(block_apply, cfg, fm=XLA))
    h = params["embed"][tokens]
    assert block.report(params["blocks"][0], h,
                        torch.arange(16, device="cuda")).n_generated >= 1


# ---------------------------------------------------------------------------
# the hand-written CUDA kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(37, 3072), (4, 3072), (2, 5, 64),
                                   (7, 998), (3, 10000), (2047, 3072),
                                   (1, 3072), (4001, 1024), (1999, 4096),
                                   (301, 8192)],
                         ids=["ragged-rows", "decode", "rank3", "scalar-path",
                              "wide-row", "ragged-prefill", "one-row",
                              "ragged-rows-1024", "ragged-rows-4096",
                              "widest-register-row"])
def test_rmsnorm_kernel_matches_plain(cuda, shape):
    from repro_torch.kernels import rmsnorm as K

    x = torch.randn(shape, device="cuda", generator=cuda)
    g = torch.randn(shape[-1], device="cuda", generator=cuda)
    before = K.rmsnorm_cuda.launches
    y, rstd = K.rmsnorm(x, g, 1e-6)
    assert K.rmsnorm_cuda.launches == before + 1
    y_ref, rstd_ref = K.rmsnorm_plain(x, g, 1e-6)
    assert rstd.shape == (x.numel() // shape[-1], 1)
    # float32, another summation order: a few ulp
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, rstd_ref, rtol=1e-5, atol=1e-6)


FLASH_CASES = {
    "gqa-causal": (2, 8, 2, 200, 200, 128, True),
    "causal-offset": (2, 4, 2, 40, 100, 128, True),
    "noncausal-ragged": (1, 4, 1, 70, 90, 64, False),
    "d32-causal": (2, 4, 2, 65, 65, 32, True),
    "one-row": (3, 6, 3, 1, 129, 128, False),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernel_matches_plain(cuda, case):
    from repro_torch.kernels import flash_attention as K

    B, Hq, Hkv, Sq, Skv, D, causal = FLASH_CASES[case]
    q = torch.randn(B, Hq, Sq, D, device="cuda", generator=cuda)
    # k, v as the model makes them: [B, S, H, D] transposed (strided)
    k = torch.randn(B, Skv, Hkv, D, device="cuda",
                    generator=cuda).transpose(1, 2)
    v = torch.randn(B, Skv, Hkv, D, device="cuda",
                    generator=cuda).transpose(1, 2)
    before = K.flash_attention_cuda.launches
    o = K.flash_attention(q, k, v, causal, None)
    assert K.flash_attention_cuda.launches == before + 1
    want = K.flash_attention_plain(q, k, v, causal, None)
    # float32 with an online softmax over 64-key tiles: a few ulp
    torch.testing.assert_close(o, want, rtol=1e-5, atol=2e-6)


def test_cuda_kernels_refuse_what_they_do_not_take(cuda):
    """What the kernels refuse (another dtype), and what they take since
    head dims above 256 run on the wide kernel: D 264 (read in place by
    its 320 instance), 320, 512 (grouped heads, causal offset), 640 (two
    output tiles) and 330 (zero-padded to 332), held against the function
    in float64, the wide kernel's launches counted."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN

    x = torch.randn(4, 64, device="cuda")
    with pytest.raises(TypeError):
        RN.rmsnorm_cuda(x.double(), torch.ones(64, device="cuda"), 1e-6)
    # float16 is widened to float32 in front of the kernel, y in x's type
    h, gh = x.half(), torch.ones(64, device="cuda").half()
    y, rstd = RN.rmsnorm_cuda(h, gh, 1e-6)
    yp, rp = RN.rmsnorm_plain(h, gh, 1e-6)
    assert y.dtype == torch.float16
    torch.testing.assert_close(y, yp, rtol=2 ** -9, atol=2 ** -14)
    torch.testing.assert_close(rstd, rp, rtol=1e-5, atol=1e-6)
    for D, causal, Sq in ((264, False, 70), (320, True, 70),
                          (512, True, 61), (640, False, 70),
                          (330, True, 70)):
        q = torch.randn(2, 4, Sq, D, device="cuda", generator=cuda)
        k = torch.randn(2, 90, 2, D, device="cuda",
                        generator=cuda).transpose(1, 2)
        v = torch.randn(2, 90, 2, D, device="cuda",
                        generator=cuda).transpose(1, 2)
        before = (FA.flash_attention_cuda.launches,
                  FA.flash_attention_wide_cuda.launches)
        o = FA.flash_attention(q, k, v, causal, None)
        assert (FA.flash_attention_cuda.launches,
                FA.flash_attention_wide_cuda.launches) == (
                    before[0], before[1] + 1)
        want = FA.flash_attention_plain(q.double(), k.double(), v.double(),
                                        causal)
        # the three-way TF32 split on the tensor cores, partial sums of
        # q k^T each 16 of D, against the float64 function
        torch.testing.assert_close(o.double(), want, rtol=1e-5, atol=2e-6)
    with pytest.raises(TypeError):
        FA.flash_attention_wide_cuda(q.double(), k.double(), v.double())


def test_reduced_generate_on_the_card_matches_the_cpu(cuda):
    import numpy as np

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.launch.serve import generate

    cfg = get_config("llama3.2-3b").reduced()
    cpu = Model(cfg, device="cpu")
    params = cpu.init(0)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 13))
    want = generate(cpu, params, prompts, 6)
    gpu = Model(cfg)
    gparams = torch.utils._pytree.tree_map(lambda t: t.cuda(), params)
    before = (RN.rmsnorm_cuda.launches, FA.flash_attention_cuda.launches)
    got = generate(gpu, gparams, prompts, 6)
    assert RN.rmsnorm_cuda.launches > before[0]
    assert FA.flash_attention_cuda.launches > before[1]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the LayerNorm kernels and the train path
# ---------------------------------------------------------------------------
LN_SHAPES = {"hubert": (4096, 1280), "ragged-rows": (4000, 1280),
             "quickstart": (8192, 3072), "scalar-path": (37, 998),
             "wide-row": (3, 10000), "rank3": (2, 5, 64),
             "one-row": (1, 1280), "ragged-wide": (1001, 3072),
             "widest-register-row": (299, 8192),
             "scalar-path-many-rows": (4001, 998)}


@pytest.mark.parametrize("name", sorted(LN_SHAPES))
def test_layernorm_kernels_match_plain(cuda, name):
    from repro_torch.kernels import layernorm as K

    shape = LN_SHAPES[name]
    C = shape[-1]
    x = torch.randn(shape, device="cuda", generator=cuda) * 2.0 + 0.5
    g = torch.randn(C, device="cuda", generator=cuda)
    b = torch.randn(C, device="cuda", generator=cuda)
    dy = torch.randn(shape, device="cuda", generator=cuda)
    before = (K.layernorm_cuda.launches, K.layernorm_bwd_cuda.launches)
    y, mean, rstd = K.layernorm(x, g, b, 1e-6)
    dx, dg, db = K.layernorm_bwd(x, g, mean, rstd, dy)
    assert (K.layernorm_cuda.launches, K.layernorm_bwd_cuda.launches) == (
        before[0] + 1, before[1] + K.BWD_LAUNCHES_PER_CALL)
    want = K.layernorm_plain(x, g, b, 1e-6)
    # float32, another summation order: a few ulp
    for got, w in zip((y, mean, rstd), want):
        torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-5)
    wdx, wdg, wdb = K.layernorm_bwd_plain(x, g, mean, rstd, dy)
    torch.testing.assert_close(dx, wdx, rtol=1e-5, atol=1e-5)
    # dgamma and dbeta sum over up to 8192 rows, in another order
    for got, w in ((dg, wdg), (db, wdb)):
        torch.testing.assert_close(
            got, w, rtol=0, atol=1e-5 * max(1.0, float(w.abs().max())))
    # summed in a fixed order, no atomics: the same bits on a second call
    _, dg2, db2 = K.layernorm_bwd(x, g, mean, rstd, dy)
    assert torch.equal(dg, dg2) and torch.equal(db, db2)


def test_layernorm_kernels_refuse_what_they_do_not_take(cuda):
    from repro_torch.kernels import layernorm as K

    x = torch.randn(4, 64, device="cuda")
    g, b = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    with pytest.raises(TypeError):
        K.layernorm_cuda(x.double(), g, b, 1e-6)
    # float16 is widened to float32 in front of the kernel, y in x's type
    before = K.layernorm_cuda.launches
    y, _, _ = K.layernorm_cuda(x.half(), g.half(), b.half(), 1e-6)
    assert K.layernorm_cuda.launches == before + 1
    assert y.dtype == torch.float16
    torch.testing.assert_close(
        y, K.layernorm_plain(x.half(), g.half(), b.half(), 1e-6)[0],
        rtol=2 ** -9, atol=2 ** -14)
    with pytest.raises(ValueError, match="CUDA device"):
        K.layernorm_cuda(x, g.cpu(), b, 1e-6)
    _, m, r = K.layernorm_plain(x, g, b, 1e-6)
    with pytest.raises(TypeError):
        K.layernorm_bwd_cuda(x, g, m, r, x.double())
    with pytest.raises(ValueError, match="CUDA device"):
        K.layernorm_bwd_cuda(x, g, m.cpu(), r, x)


def test_flash_kernel_at_head_dim_80_non_causal(cuda):
    from repro_torch.kernels import flash_attention as K

    q = torch.randn(2, 16, 200, 80, device="cuda", generator=cuda)
    k = torch.randn(2, 200, 16, 80, device="cuda",
                    generator=cuda).transpose(1, 2)
    v = torch.randn(2, 200, 16, 80, device="cuda",
                    generator=cuda).transpose(1, 2)
    o = K.flash_attention(q, k, v, False, None)
    torch.testing.assert_close(o, K.flash_attention_plain(q, k, v, False),
                               rtol=1e-5, atol=2e-6)


def test_reduced_train_step_on_the_card_matches_the_cpu(cuda):
    from repro_torch import optim
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import layernorm as LN
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import build_trainer

    cfg = get_config("hubert-xlarge").reduced(vocab_size=504)
    data = SyntheticTokens(DataConfig(seed=0, global_batch=2, seq_len=32),
                           cfg)
    results = {}
    for dev in ("cpu", "cuda"):
        mdl, init_state, step = build_trainer(cfg, total_steps=3, device=dev)
        if dev == "cpu":
            params = init_state(0)["params"]
        p = torch.utils._pytree.tree_map(lambda t: t.to(dev), params)
        batch = {k: torch.as_tensor(v).to(dev)
                 for k, v in data.batch_at(0).items()}
        _, grads = loss_and_grads(mdl, p, batch)
        state = {"params": p, "opt": optim.init(optim.AdamWConfig(), p)}
        before = (LN.layernorm_cuda.launches, LN.layernorm_bwd_cuda.launches,
                  FA.flash_attention_cuda.launches)
        losses = []
        for i in range(3):
            state = step(state, data.batch_at(i))
            losses.append(step.last_metrics["loss"])
        launched = (LN.layernorm_cuda.launches - before[0],
                    LN.layernorm_bwd_cuda.launches - before[1],
                    FA.flash_attention_cuda.launches - before[2])
        results[dev] = (losses, grads, launched)
    n = 2 * cfg.n_layers + 1
    assert results["cpu"][2] == (0, 0, 0)
    assert results["cuda"][2] == (3 * n, 3 * n * LN.BWD_LAUNCHES_PER_CALL,
                                  3 * cfg.n_layers)
    # each step's loss; a wrong update would show in the next one.  The
    # parameters themselves are not compared: AdamW turns noise-level
    # differences in near-zero gradients into steps of a sizeable fraction
    # of lr, whatever the kernels' accuracy
    np.testing.assert_allclose(results["cuda"][0], results["cpu"][0],
                               rtol=1e-5)
    # the step-0 gradients, before the optimizer: float32 through 2
    # layers, other summation orders
    for a, b in zip(torch.utils._pytree.tree_leaves(results["cuda"][1]),
                    torch.utils._pytree.tree_leaves(results["cpu"][1])):
        torch.testing.assert_close(
            a.cpu(), b, rtol=0, atol=1e-4 * float(b.abs().max()) + 1e-7)


# ---------------------------------------------------------------------------
# the router's softmax kernels and the MoE path
# ---------------------------------------------------------------------------
#: name -> (shape, the layout csrc/softmax.cu takes): the paths' rows; the
#: float4 layout's edges in C (1 to 32 lanes a row, 36 and 40 with idle
#: lanes, 132 past it) and in R (one row; a ragged last block); C 33, no
#: multiple of 4; rows wider than a warp holds; a rank-3 input
SOFTMAX_SHAPES = {
    "prefill": ((2048, 32), "float4 lanes 8"),
    "decode": ((4, 32), "float4 lanes 8"),
    "train": ((4096, 32), "float4 lanes 8"),
    "ragged-40": ((4095, 40), "float4 lanes 16"),
    "c4": ((1001, 4), "float4 lanes 1"),
    "c8": ((1001, 8), "float4 lanes 2"),
    "c36": ((1001, 36), "float4 lanes 16"),
    "c40": ((1001, 40), "float4 lanes 16"),
    "c64": ((1001, 64), "float4 lanes 16"),
    "c124": ((1001, 124), "float4 lanes 32"),
    "c128": ((1001, 128), "float4 lanes 32"),
    "c132": ((1001, 132), "warp"),
    "c33": ((1001, 33), "warp"),
    "one-row": ((1, 32), "float4 lanes 8"),
    "ragged-rows": ((2047, 32), "float4 lanes 8"),
    "wide-row": ((256, 4096), "block"),
    "rank3": ((2, 5, 4), "float4 lanes 1")}


def _softmax_pair(K, x, dy):
    """B7 on x, then B10 on its output and dy: one launch each, each equal
    to its plain version."""
    before = (K.softmax_cuda.launches, K.softmax_bwd_cuda.launches)
    y = K.softmax(x)
    dx = K.softmax_bwd(y, dy)
    assert (K.softmax_cuda.launches,
            K.softmax_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)
    # float32, the same steps in another summation order: a few ulp
    torch.testing.assert_close(y, K.softmax_plain(x), rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(dx, K.softmax_bwd_plain(y, dy), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", sorted(SOFTMAX_SHAPES))
def test_softmax_kernels_match_plain(cuda, name):
    from repro_torch.kernels import softmax as K

    shape, layout = SOFTMAX_SHAPES[name]
    x = torch.randn(shape, device="cuda", generator=cuda) * 3.0
    dy = torch.randn(shape, device="cuda", generator=cuda)
    assert K.layout(x) == layout and K.layout(x, dy) == layout
    _softmax_pair(K, x, dy)


def test_softmax_kernels_on_misaligned_rows(cuda):
    """Contiguous [2048, 32] rows that start one float into their buffer
    take the warp-a-row layout, and agree with the plain versions."""
    from repro_torch.kernels import softmax as K

    n = 2048 * 32
    buf = torch.randn(n + 1, device="cuda", generator=cuda) * 3.0
    dbuf = torch.randn(n + 1, device="cuda", generator=cuda)
    x, dy = buf[1:1 + n].view(2048, 32), dbuf[1:1 + n].view(2048, 32)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    assert K.layout(x) == "warp" and K.layout(x, dy) == "warp"
    assert K.layout(x.clone(), dy.clone()) == "float4 lanes 8"
    _softmax_pair(K, x, dy)


#: consumer -> the row width it reads a producer's output at: the float4
#: layout (32), the warp-a-row layout (33), a block a row (the producer's
#: own width)
PDL_CONSUMERS = {"float4-lanes": 32, "warp": 33, "block": None}
#: the producer's rows: a block a row, two to an SM, each walking 264 KB
#: three times, so its dependents launch (after its first walk) well
#: before it writes y
PDL_PRODUCER = (264, 33 * 32 * 64)


def test_softmax_kernels_wait_for_the_product_and_the_add(cuda):
    """Each kernel is a programmatic dependent: it launches while its
    producer drains, and must touch no memory before
    ``griddepcontrol.wait``.  Twenty times with fresh inputs: B7 at once
    after the router's product that writes x, B10 at once after the add
    that writes dy, each equal to its plain version on the same inputs."""
    from repro_torch.kernels import softmax as K

    for _ in range(20):
        a = torch.randn(2048, 1024, device="cuda", generator=cuda)
        w = torch.randn(1024, 32, device="cuda", generator=cuda) * 0.1
        g1 = torch.randn(2048, 32, device="cuda", generator=cuda)
        g2 = torch.randn(2048, 32, device="cuda", generator=cuda)
        x = a @ w
        y = K.softmax_cuda(x)
        dy = torch.add(g1, g2)
        dx = K.softmax_bwd_cuda(y, dy)
        torch.testing.assert_close(y, K.softmax_plain(x), rtol=1e-5,
                                   atol=1e-7)
        torch.testing.assert_close(dx, K.softmax_bwd_plain(y, dy),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("consumer", sorted(PDL_CONSUMERS))
def test_softmax_kernels_wait_for_a_producer_that_signals_early(cuda,
                                                                consumer):
    """B7 and B10 at once after a B7 that lets its dependents launch long
    before it stores the y they read (the block layout signals after its
    first walk over the row): a kernel of ``consumer``'s layout that read
    before its wait would read y's old contents.  Twenty times with fresh
    inputs, each result equal to its plain version on the producer's
    output."""
    from repro_torch.kernels import softmax as K

    R, C = PDL_PRODUCER
    width = PDL_CONSUMERS[consumer] or C
    for _ in range(20):
        x = torch.randn(R, C, device="cuda", generator=cuda) * 3.0
        dy = torch.randn(R * C // width, width, device="cuda", generator=cuda)
        y1 = K.softmax_cuda(x)
        z = K.softmax_cuda(y1.view(-1, width))
        y2 = K.softmax_cuda(x * 0.5)
        dx = K.softmax_bwd_cuda(y2.view(-1, width), dy)
        assert K.layout(y1) == "block"
        assert K.layout(y1.view(-1, width), dy) == (
            "float4 lanes 8" if width == 32 else consumer)
        torch.testing.assert_close(y1, K.softmax_plain(x), rtol=1e-5,
                                   atol=1e-7)
        torch.testing.assert_close(z, K.softmax_plain(y1.view(-1, width)),
                                   rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(
            dx, K.softmax_bwd_plain(y2.view(-1, width), dy), rtol=1e-5,
            atol=1e-6)


def test_softmax_kernels_refuse_what_they_do_not_take(cuda):
    from repro_torch.kernels import softmax as K

    x = torch.randn(4, 32, device="cuda")
    with pytest.raises(TypeError):
        K.softmax_cuda(x.double())
    # float16 is widened to float32 in front of the kernel, y in x's type
    before = K.softmax_cuda.launches
    y = K.softmax_cuda(x.half())
    assert K.softmax_cuda.launches == before + 1
    assert y.dtype == torch.float16
    torch.testing.assert_close(y, K.softmax_plain(x.half()), rtol=2 ** -9,
                               atol=2 ** -14)
    with pytest.raises(ValueError, match="CUDA device"):
        K.softmax_bwd_cuda(x, x.cpu())
    with pytest.raises(ValueError, match="one shape"):
        K.softmax_bwd_cuda(x, x[:2])


def test_flash_kernel_at_head_dim_64_gqa_causal(cuda):
    from repro_torch.kernels import flash_attention as K

    q = torch.randn(2, 16, 200, 64, device="cuda", generator=cuda)
    k = torch.randn(2, 200, 8, 64, device="cuda",
                    generator=cuda).transpose(1, 2)
    v = torch.randn(2, 200, 8, 64, device="cuda",
                    generator=cuda).transpose(1, 2)
    o = K.flash_attention(q, k, v, True, None)
    torch.testing.assert_close(o, K.flash_attention_plain(q, k, v, True),
                               rtol=1e-5, atol=2e-6)


def test_reduced_moe_generate_on_the_card_matches_the_cpu(cuda):
    from repro_torch.kernels import softmax as SM
    from repro_torch.launch.serve import generate

    cfg = get_config("granite-moe-1b-a400m").reduced()
    cpu = Model(cfg, device="cpu")
    params = cpu.init(0)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 13))
    want = generate(cpu, params, prompts, 6)
    gpu = Model(cfg)
    gparams = torch.utils._pytree.tree_map(lambda t: t.cuda(), params)
    from repro_torch.core.capture import WARMUP

    before = SM.softmax_cuda.launches
    got = generate(gpu, gparams, prompts, 6)
    # one router softmax a layer, in the prefill and in each of 5 decodes
    # (replays of the captured step), and in the capture's eager warm-up
    assert SM.softmax_cuda.launches - before == (6 + WARMUP) * cfg.n_layers
    np.testing.assert_array_equal(got, want)


def test_reduced_moe_train_step_on_the_card_matches_the_cpu(cuda):
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.kernels import softmax as SM
    from repro_torch.launch.steps import loss_and_grads

    cfg = get_config("granite-moe-1b-a400m").reduced()
    batch = SyntheticTokens(DataConfig(seed=0, global_batch=2, seq_len=32),
                            cfg).batch_at(0)
    params = Model(cfg, device="cpu").init(0)
    results = {}
    for dev in ("cpu", "cuda"):
        p = torch.utils._pytree.tree_map(lambda t: t.to(dev), params)
        b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        before = (SM.softmax_cuda.launches, SM.softmax_bwd_cuda.launches)
        loss, grads = loss_and_grads(Model(cfg, device=dev), p, b)
        results[dev] = (float(loss), grads, (
            SM.softmax_cuda.launches - before[0],
            SM.softmax_bwd_cuda.launches - before[1]))
    assert results["cpu"][2] == (0, 0)
    # the model's default remat runs each layer's router softmax again in
    # the backward; its backward kernel once a layer
    assert results["cuda"][2] == (2 * cfg.n_layers, cfg.n_layers)
    np.testing.assert_allclose(results["cuda"][0], results["cpu"][0],
                               rtol=1e-5)
    # float32 through 2 layers, other summation orders
    for a, b in zip(torch.utils._pytree.tree_leaves(results["cuda"][1]),
                    torch.utils._pytree.tree_leaves(results["cpu"][1])):
        torch.testing.assert_close(
            a.cpu(), b, rtol=0, atol=1e-4 * float(b.abs().max()) + 1e-7)


# ---------------------------------------------------------------------------
# the SSD scan (B11) and the SSM / hybrid paths
# ---------------------------------------------------------------------------
#: name -> (b, L, H, P, N, chunk): Mamba2's and Zamba2's head dim and
#: state at a short sequence, a chunk shorter than the tile's 64 rows, the
#: reduced configs' P 16, N 16, chunk 16, a head dim and state that are
#: no multiple of the tiles, and a sequence of one chunk
SSD_CASES = {"mamba2-N128": (2, 192, 4, 64, 128, 64),
             "zamba2-N64": (2, 128, 6, 64, 64, 64),
             "short-chunk": (1, 60, 3, 64, 128, 20),
             "reduced": (2, 48, 16, 16, 16, 16),
             "odd-P20-N36": (2, 96, 5, 20, 36, 32),
             "one-chunk": (1, 64, 3, 32, 96, 64)}


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_scan_kernel_matches_plain(cuda, case):
    from repro_torch.kernels import ssd_scan as K

    b, L, H, P, N, chunk = SSD_CASES[case]
    # x, B, C as column slices of one activation, as the model passes them
    xbc = torch.randn(b, L, H * P + 2 * N, device="cuda", generator=cuda)
    x = xbc[..., :H * P].reshape(b, L, H, P)
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.nn.functional.softplus(
        torch.randn(b, L, H, device="cuda", generator=cuda) - 2.0)
    A = -torch.exp(0.3 * torch.randn(H, device="cuda", generator=cuda))
    before = K.ssd_scan_cuda.launches
    y, state = K.ssd_scan(x, dt, A, Bm, Cm, chunk)
    assert K.ssd_scan_cuda.launches == before + K.LAUNCHES_PER_CALL
    y_ref, s_ref = K.ssd_scan_plain(x, dt, A, Bm, Cm, chunk)
    # float32 sums over the chunk and the state, in another order
    for got, want in ((y, y_ref), (state, s_ref)):
        torch.testing.assert_close(
            got, want, rtol=0, atol=1e-4 * max(1.0, float(want.abs().max())))


def test_ssd_scan_kernel_refuses_what_it_does_not_take(cuda):
    """What the scan refuses (another dtype), and what it takes since any
    chunk and any P and N run: a chunk of 128 (two of 64 a launch) and P
    = N = 256 (three P slices), each held against the plain version, the
    launches counted; the shared-memory function the slice plan reads is
    the one the CPU tests mirror."""
    from test_torch_ssd_smem import kernel_smem

    from repro_torch.kernels import ssd_scan as K

    x = torch.randn(1, 128, 2, 32, device="cuda")
    dt = torch.rand(1, 128, 2, device="cuda")
    A = -torch.ones(2, device="cuda")
    Bm = torch.randn(1, 128, 128, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        K.ssd_scan_cuda(x.double(), dt, A, Bm, Bm, 64)
    # the library's bytes, the mirror's, and the values the slice plan's
    # CPU tests rely on: Mamba2's shape (one launch), P = N = 256 (above
    # one block's 232,448 bytes) and its 96-wide P slice (within), odd
    # shapes padded to the 32-wide tiles
    for (c, P, N), want in {(64, 64, 128): 103168, (64, 256, 256): 417536,
                            (20, 20, 36): 27008, (64, 96, 256): 210176,
                            (32, 256, 64): 116608}.items():
        assert K._smem()(c, P, N) == kernel_smem(c, P, N) == want
    for b, L, H, P, N, chunk, launches in ((2, 256, 3, 64, 128, 128, 1),
                                           (1, 128, 2, 256, 256, 64, 3)):
        xbc = torch.randn(b, L, H * P + 2 * N, device="cuda", generator=cuda)
        xs = xbc[..., :H * P].reshape(b, L, H, P)
        Bs, Cs = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
        dts = torch.nn.functional.softplus(
            torch.randn(b, L, H, device="cuda", generator=cuda) - 2.0)
        As = -torch.exp(0.3 * torch.randn(H, device="cuda", generator=cuda))
        before = K.ssd_scan_cuda.launches
        y, state = K.ssd_scan(xs, dts, As, Bs, Cs, chunk)
        assert K.ssd_scan_cuda.launches - before == \
            launches * K.LAUNCHES_PER_CALL
        y_ref, s_ref = K.ssd_scan_plain(xs, dts, As, Bs, Cs, chunk)
        for got, want in ((y, y_ref), (state, s_ref)):
            torch.testing.assert_close(
                got, want, rtol=0,
                atol=1e-4 * max(1.0, float(want.abs().max())))


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_reduced_recurrent_generate_on_the_card_matches_the_cpu(cuda, arch):
    from repro_torch.kernels import ssd_scan as K
    from repro_torch.launch.serve import generate

    cfg = get_config(arch).reduced()
    cpu = Model(cfg, device="cpu")
    params = cpu.init(0)
    # 21 tokens: one 16-row chunk and a pad of 11
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 21))
    want = generate(cpu, params, prompts, 6)
    gpu = Model(cfg)
    gparams = torch.utils._pytree.tree_map(lambda t: t.cuda(), params)
    before = K.ssd_scan_cuda.launches
    got = generate(gpu, gparams, prompts, 6)
    # one scan a layer in the prefill, none in the decode steps
    assert K.ssd_scan_cuda.launches - before == \
        cfg.n_layers * K.LAUNCHES_PER_CALL
    np.testing.assert_array_equal(got, want)


#: name -> (B, Hq, Hkv, S, D, kv_len, layers of the cache buffer)
DECODE_CASES = {
    "gqa3-d128-whole": (2, 6, 2, 300, 128, None, 1),
    "gqa2-d64-ragged": (2, 4, 2, 257, 64, 200, 1),
    "mha-d64-long": (1, 4, 4, 5000, 64, 4999, 1),
    "layer-view-prefix": (2, 6, 2, 640, 128, 333, 3),
    "one-row": (3, 8, 1, 64, 128, 1, 1),
    "gqa8": (1, 16, 2, 100, 64, None, 1),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_flash_decode_kernel_matches_plain(cuda, case):
    from repro_torch.kernels import flash_attention as K

    B, Hq, Hkv, S, D, n, layers = DECODE_CASES[case]
    q = torch.randn(B, Hq, D, device="cuda", generator=cuda)
    # the caches as the model passes them: a layer's view of a buffer
    k = torch.randn(layers, B, Hkv, S, D, device="cuda",
                    generator=cuda)[layers - 1]
    v = torch.randn(layers, B, Hkv, S, D, device="cuda",
                    generator=cuda)[layers - 1]
    before = K.flash_decode_cuda.launches
    o = K.flash_decode(q, k, v, n, None)
    assert K.flash_decode_cuda.launches == before + 1
    want = K.flash_decode_plain(q, k, v, n, None)
    # float32, partial softmax states merged by log-sum-exp: a few ulp
    torch.testing.assert_close(o, want, rtol=1e-5, atol=2e-6)


def test_flash_decode_kernel_refuses_what_it_does_not_take(cuda):
    """What the decode kernel refuses (another dtype, a kv_len below 1),
    and what it takes since any head dim and group run: D 32, 80 and 100
    (read in place, the columns masked in the next instance), 30
    (zero-padded to 32), 256 (its own instance), 264 and 320 (the 384
    instance's masked twin), 512 at 8 query heads a KV head (two
    sub-groups of 4), 640 (the tiled kernel) and 16 query heads a KV head
    at D 128 (two sub-groups, two launches), each held against the plain
    version, the launches counted (none of the wide flash kernel)."""
    from repro_torch.kernels import flash_attention as K

    q = torch.randn(1, 32, 64, device="cuda")
    kv = torch.randn(1, 2, 16, 64, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        K.flash_decode_cuda(q[:, :4].double(), kv, kv, None)
    # float16 is widened to float32 in front of the kernel, o in q's type
    o = K.flash_decode_cuda(q[:, :4].half(), kv.half(), kv.half(), None)
    assert o.dtype == torch.float16
    torch.testing.assert_close(
        o, K.flash_decode_plain(q[:, :4].half(), kv.half(), kv.half()),
        rtol=2 ** -9, atol=2 ** -14)
    with pytest.raises(ValueError, match="kv_len"):
        K.flash_decode_cuda(q[:, :4], kv, kv, 0)
    for B, Hq, Hkv, S, D, n, launches, wide in (
            (1, 4, 2, 100, 32, 77, 1, 0), (2, 8, 2, 300, 80, 250, 1, 0),
            (2, 8, 4, 300, 100, 299, 1, 0), (1, 6, 2, 90, 30, 77, 1, 0),
            (2, 16, 16, 700, 256, None, 1, 0), (1, 16, 2, 500, 256, 499, 1, 0),
            (2, 32, 2, 600, 128, 555, 2, 0), (1, 8, 2, 400, 320, 321, 1, 0),
            (2, 8, 2, 300, 264, 250, 1, 0), (1, 16, 2, 400, 512, 399, 2, 0),
            (1, 8, 2, 300, 640, 299, 1, 0)):
        q = torch.randn(B, Hq, D, device="cuda", generator=cuda)
        k = torch.randn(B, Hkv, S, D, device="cuda", generator=cuda)
        v = torch.randn(B, Hkv, S, D, device="cuda", generator=cuda)
        before = (K.flash_decode_cuda.launches,
                  K.flash_attention_wide_cuda.launches)
        o = K.flash_decode(q, k, v, n, None)
        assert (K.flash_decode_cuda.launches - before[0],
                K.flash_attention_wide_cuda.launches - before[1]) == (
                    launches, wide)
        want = K.flash_decode_plain(q.double(), k.double(), v.double(), n)
        # float32, partial softmax states merged by log-sum-exp
        torch.testing.assert_close(o.double(), want, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-1.2b"])
def test_reduced_static_decode_on_the_card_matches_the_cpu(cuda, arch):
    """``make_decode_step`` at a static kv_len (head dim 64: the kernel's
    instance) on the card against the same steps on the CPU."""
    from repro_torch.core.capture import WARMUP
    from repro_torch.kernels import flash_attention as K
    from repro_torch.launch.steps import make_decode_step

    cfg = get_config(arch).reduced(head_dim=64)
    cpu = Model(cfg, device="cpu")
    params = cpu.init(0)
    gpu = Model(cfg)
    gparams = torch.utils._pytree.tree_map(lambda t: t.cuda(), params)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)))
    caches = []
    for mdl, p, dev in ((cpu, params, "cpu"), (gpu, gparams, "cuda")):
        c = mdl.init_cache(2, 32)
        mdl.prefill(p, tokens.to(dev), c)
        caches.append(c)
    n_attn = (len(range(0, cfg.n_layers, cfg.attn_every))
              if cfg.attn_every else cfg.n_layers)
    for pos, kv_len in ((12, 13), (13, None)):
        tok = torch.tensor([[pos], [pos + 1]])
        want, _ = make_decode_step(cpu, kv_len)(params, caches[0], tok, pos)
        before = K.flash_decode_cuda.launches
        step = make_decode_step(gpu, kv_len)
        got, _ = step(gparams, caches[1], tok.cuda(), pos)
        # captured: the warm-up's eager launches, then one replay
        assert step.graph.kernels[K.flash_decode_cuda] == n_attn
        assert K.flash_decode_cuda.launches - before \
            == (WARMUP + 1) * n_attn
        # float32 through the layers on two devices
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# compute-anchored kernels: B3 and flash attention with a score chain
# ---------------------------------------------------------------------------
def _anchored_ems(fn, args):
    comp = stitched_jit(fn).compiled(*args)
    ems = [e for e in comp.emitted if e.kind == "anchored"]
    assert ems, comp.report.schedules
    return comp, ems


def _hold_anchored(comp, ems, cuda, rtol=1e-5):
    """Each anchored kernel on random inputs against its plain version on
    the same inputs (each element within rtol max(1, max|plain|)), then the
    whole stitched call against the op-by-op replay."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import matmul as MM

    for em in ems:
        vals = [torch.randn(comp.graph.node(i).spec.shape, device="cuda",
                            generator=cuda) for i in em.ext_ids]
        before = (MM.matmul_fused.launches, FA.ScoreMod.launches)
        got = em.fn("cuda", *vals)
        after = (MM.matmul_fused.launches, FA.ScoreMod.launches)
        assert sum(after) == sum(before) + 1
        want = em.fn("cpu", *[v.cpu() for v in vals])
        for a, b in zip(got, want):
            lim = rtol * max(1.0, float(b.abs().max()))
            assert float((a.cpu().float() - b.float()).abs().max()) <= lim


def t_gate(x, wg, wu):
    return torch.nn.functional.silu(x @ wg) * (x @ wu)


ANCHOR_CASES = {
    "gate-prefill": (t_gate, [(2048, 512), (512, 1024), (512, 1024)]),
    "gate-decode": (t_gate, [(4, 512), (512, 1024), (512, 1024)]),
    "gate-ragged": (t_gate, [(2000, 512), (512, 1000), (512, 1000)]),
}


@pytest.mark.parametrize("case", sorted(ANCHOR_CASES))
def test_b3_kernel_matches_plain(cuda, case):
    fn, shapes = ANCHOR_CASES[case]
    args = [torch.randn(s, device="cuda", generator=cuda) for s in shapes]
    comp, ems = _anchored_ems(fn, args)
    _hold_anchored(comp, ems, cuda)
    # the whole stitched call against the function in float64, at B3's
    # limit: 1e-5 max(1, max|plain|) + 3 x the float32 eager function's
    # own distance from float64 (the tensor cores sum in another order
    # than cuBLAS, so the float32 eager result is no exact yardstick)
    got, plain = stitched_jit(fn)(*args), fn(*args)
    f64 = fn(*[a.double() for a in args])
    limit = 1e-5 * max(1.0, float(plain.abs().max())) \
        + 3.0 * float((plain.double() - f64).abs().max())
    assert float((got.double() - f64).abs().max()) <= limit


def test_b3_kernel_prologue_roles_and_reducing_epilogue(cuda):
    def fn(x, r, c, w, g):
        h = (x * c + r) @ w
        return (h * torch.rsqrt((h ** 2).mean(-1, keepdim=True) + 1e-6) * g,
                torch.softmax(h, -1))

    args = [torch.randn(s, device="cuda", generator=cuda)
            for s in [(300, 96), (300, 1), (96,), (96, 160), (160,)]]
    comp, ems = _anchored_ems(fn, args)
    _hold_anchored(comp, ems, cuda)


def test_flash_score_mod_matches_plain(cuda):
    def attn(q, k, v, bias):
        s = q @ k.transpose(-1, -2) * 0.125 + bias
        return torch.softmax(s, -1) @ v

    args = [torch.randn(s, device="cuda", generator=cuda)
            for s in [(2, 4, 100, 64)] * 3 + [(1, 1, 100, 100)]]
    comp, ems = _anchored_ems(attn, args)
    assert ems[0].fn.score_mod is not None
    _hold_anchored(comp, ems, cuda)
    torch.testing.assert_close(stitched_jit(attn)(*args), attn(*args),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# one dispatch a step: captured decode waves and steps
# ---------------------------------------------------------------------------
def _on_card(arch):
    cfg = get_config(arch).reduced()
    gpu = Model(cfg)
    params = torch.utils._pytree.tree_map(
        lambda t: t.cuda(), Model(cfg, device="cpu").init(0))
    return cfg, gpu, params


def _served(mdl, params, capture, prompts):
    """The requests through a batcher; every wave's logits kept."""
    from repro_torch.serving import ContinuousBatcher

    b = ContinuousBatcher(mdl, params, n_slots=3, max_len=48,
                          capture=capture)
    wave, logits = b._wave, []

    def keep(toks, poss):
        lg, nxt = wave(toks, poss)
        logits.append(lg.clone())
        return lg, nxt

    b._wave = keep
    ids = [b.submit(p, max_new=6) for p in prompts]
    out = b.run()
    return [out[r] for r in ids], logits, wave


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-1b-a400m",
                                  "zamba2-1.2b"])
def test_replayed_waves_equal_eager_waves(cuda, arch):
    """Five requests through three slots (refills mid-flight), every wave
    one graph replay, against the same waves run eagerly: the same tokens,
    each wave's logits within 1e-4 max(1, max|logits|) (``PERF.md`` §2);
    the hybrid's Mamba states advance once a wave (restored after the
    capture's warm-up)."""
    cfg, gpu, params = _on_card(arch)
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab_size, n)
               for i, n in enumerate((9, 5, 13, 7, 11))]
    got, got_logits, graph = _served(gpu, params, True, prompts)
    want, want_logits, _ = _served(gpu, params, False, prompts)
    assert graph.replays == len(got_logits) > 0
    assert got == want
    for g, w in zip(got_logits, want_logits):
        lim = 1e-4 * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= lim
    cpu = Model(cfg, device="cpu")
    cparams = torch.utils._pytree.tree_map(lambda t: t.cpu(), params)
    assert _served(cpu, cparams, True, prompts)[0] == got


def _kernels(fn):
    """{kernel: launches a call} of three calls of ``fn`` in one profiler
    session, rounded up (the profiler can lose a record of a session's
    first kernels), copies and fills left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1_000_000)
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA and \
                not e.key.startswith(("Memcpy", "Memset")) and \
                "spin_kernel" not in e.key:
            out[e.key] = out.get(e.key, 0) + e.count
    assert out, "the profiler saw no kernel"
    return {k: -(-n // 3) for k, n in out.items()}


def test_a_replayed_wave_makes_no_python_kernel_call(cuda, monkeypatch):
    """After the capture a wave calls no kernel wrapper and compiles
    nothing; the profiler sees the eager wave's kernels, and the launch
    counters rise by the graph's tally."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.serving import ContinuousBatcher

    cfg, gpu, params = _on_card("llama3.2-3b")
    b = ContinuousBatcher(gpu, params, n_slots=2, max_len=32)
    e = ContinuousBatcher(gpu, params, n_slots=2, max_len=32, capture=False)
    toks = torch.tensor([[5], [9]], device="cuda")
    poss = torch.tensor([3, 7], device="cuda")
    b._wave(toks, poss)  # warm-up and capture
    e._wave(toks, poss)
    calls, compiled = [], gpu.n_compiled
    before = RN.rmsnorm_cuda.launches
    monkeypatch.setattr(_build, "count", lambda owner, n=1: calls.append(1))
    replayed = _kernels(lambda: b._wave(toks, poss))
    monkeypatch.undo()
    assert calls == [] and gpu.n_compiled == compiled
    assert RN.rmsnorm_cuda.launches - before \
        == 3 * b._wave.kernels[RN.rmsnorm_cuda] == 3 * (2 * cfg.n_layers + 1)
    assert replayed == _kernels(lambda: e._wave(toks, poss))


def test_generate_and_static_steps_replay_one_graph(cuda):
    """``generate`` on the card (captured) equals ``capture=False``; the
    static step's later calls replay its one graph."""
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_decode_step

    cfg, gpu, params = _on_card("llama3.2-3b")
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 11))
    np.testing.assert_array_equal(
        generate(gpu, params, prompts, 6),
        generate(gpu, params, prompts, 6, capture=False))
    cache = gpu.init_cache(2, 32)
    gpu.prefill(params, torch.from_numpy(prompts).cuda(), cache)
    step = make_decode_step(gpu, 16)
    tok = torch.tensor([[1], [2]], device="cuda")
    for pos in (11, 12, 13):
        got, _ = step(params, cache, tok, pos)
        want, _ = make_decode_step(gpu, 16, capture=False)(params, cache,
                                                           tok, pos)
        lim = 1e-4 * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= lim
    assert step.graph.replays == 3


def test_a_failed_capture_raises(cuda):
    """A step that reads a value back to the host cannot be captured: the
    capture raises, and nothing runs the step eagerly in its place."""
    from repro_torch.core.capture import WARMUP, CapturedStep

    ran = []

    def syncs(x):
        ran.append(1)
        return x * float((x * 2).sum().item())

    step = CapturedStep(syncs)
    with pytest.raises(RuntimeError):
        step(torch.ones(4, device="cuda"))
    assert len(ran) == WARMUP + 1 and step.graph is None
    torch.cuda.synchronize()
    assert float(torch.ones(2, device="cuda").sum()) == 2.0


# ---------------------------------------------------------------------------
# the reference's other configs, and the prompt cell's sizes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["gemma-7b", "mistral-nemo-12b",
                                  "internvl2-26b", "deepseek-67b",
                                  "hubert-xlarge"])
def test_reduced_cell_steps_on_the_card_match_the_cpu(cuda, arch, dtype):
    """``make_prefill_step`` (InternVL's vision rows spliced, HuBERT's
    frames) and, for a decoder, two ``make_decode_step`` steps at a
    static kv_len, on the card against the CPU (head dim 64: the kernels'
    instance).  float32: within 1e-4 / 2e-4; bfloat16 params and cache:
    the card's distance from the CPU's float32 run at most 1.5 times the
    CPU's bfloat16 run's, plus 1e-3 max(1, max|logits|)."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    dt = getattr(torch, dtype)
    cfg = get_config(arch).reduced(head_dim=64)
    r = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(
        r.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32))}
    if cfg.frontend == "vision":
        batch["vision_embeds"] = torch.from_numpy(r.standard_normal(
            (2, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32))
    if cfg.frontend == "audio":
        batch = {"frames": torch.from_numpy(r.standard_normal(
            (2, 12, cfg.frontend_dim)).astype(np.float32))}
    params32 = Model(cfg, device="cpu").init(0)

    def run(dev, pdt):
        mdl = Model(cfg, device=dev, param_dtype=pdt)
        p = torch.utils._pytree.tree_map(
            lambda t: t.to(dev, pdt if t.is_floating_point() else t.dtype),
            params32)
        b = {k: v.to(dev) for k, v in batch.items()}
        cache = mdl.init_cache(2, 16, dtype=pdt)
        lg, _ = make_prefill_step(mdl)(p, b, cache)
        out = [lg[:, :, :cfg.vocab_size].float().cpu()]
        for pos in ((12, 13) if cfg.supports_decode else ()):
            tok = torch.tensor([[pos], [pos + 1]], device=dev)
            lg, _ = make_decode_step(mdl, pos + 1)(p, cache, tok, pos)
            out.append(lg[:, :, :cfg.vocab_size].float().cpu())
        return out

    got = run("cuda", dt)
    if dt == torch.float32:
        for g, w in zip(got, run("cpu", dt)):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=2e-4)
        return
    for g, w, e in zip(got, run("cpu", dt), run("cpu", torch.float32)):
        lim = 1.5 * float((w - e).abs().max()) + 1e-3 * max(
            1.0, float(e.abs().max()))
        assert float((g - e).abs().max()) <= lim


def test_rmsnorm_past_2_31_elements(cuda):
    """B6 over [700000, 3072] (2.15e9 elements, past 2^31), float32 and
    bfloat16: the first and last rows against the plain version."""
    from repro_torch.kernels import rmsnorm as RN

    R, C = 700_000, 3072
    for dt in (torch.bfloat16, torch.float32):
        x = torch.empty(R, C, device="cuda", dtype=dt)
        x[:1024].normal_(generator=cuda)
        x[1024:-1024] = 0.5
        x[-1024:].normal_(generator=cuda)
        g = torch.randn(C, device="cuda", generator=cuda).to(dt)
        y = RN.rmsnorm_cuda(x, g, 1e-6)[0]
        for rows in (slice(0, 1024), slice(R - 1024, R)):
            want = RN.rmsnorm_plain(x[rows], g, 1e-6)[0]
            tol = 2e-2 if dt == torch.bfloat16 else 1e-5
            torch.testing.assert_close(y[rows].float(), want.float(),
                                       rtol=tol, atol=tol)
        assert bool((y[5000].float() - 0.5 * torch.rsqrt(
            torch.tensor(0.25 + 1e-6, device="cuda")) * g.float())
            .abs().max() < 2e-2)
        del x, y
        torch.cuda.empty_cache()


def test_flash_attention_past_2_31_elements(cuda):
    """B4 in bfloat16 at Llama's heads, 22 sequences of 32,768 rows (q:
    2.27e9 elements, past 2^31), causal: query blocks of the last sequence
    and of the first against the plain version computed block by block
    (the first rows, the last rows)."""
    from repro_torch.kernels import flash_attention as FA

    B, Hq, Hkv, S, D, bq = 22, 24, 8, 32768, 128, 128
    bf = torch.bfloat16
    q = torch.randn(B, Hq, S, D, device="cuda", generator=cuda).to(bf)
    k = torch.randn(B, Hkv, S, D, device="cuda", generator=cuda).to(bf)
    v = torch.randn(B, Hkv, S, D, device="cuda", generator=cuda).to(bf)
    o = FA.flash_attention_cuda(q, k, v, True)
    assert q.numel() > 2 ** 31
    for b in (0, B - 1):
        for i in (0, S - bq):
            want = FA.flash_attention_plain(
                q[b:b + 1, :, i:i + bq], k[b:b + 1, :, :i + bq],
                v[b:b + 1, :, :i + bq], True)
            torch.testing.assert_close(o[b:b + 1, :, i:i + bq].float(),
                                       want.float(), rtol=4e-2, atol=1.2e-1)
