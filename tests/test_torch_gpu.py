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
    head dims above 256 run on the wide kernel: D 264 and 320, held
    against the plain version, the wide kernel's launches counted."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN

    x = torch.randn(4, 64, device="cuda")
    with pytest.raises(TypeError):
        RN.rmsnorm_cuda(x.half(), torch.ones(64, device="cuda").half(), 1e-6)
    for D, causal in ((264, False), (320, True)):
        q = torch.randn(2, 4, 70, D, device="cuda", generator=cuda)
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
        # float32 FMA over D in another order than the float64 function
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
        K.layernorm_cuda(x.half(), g.half(), b.half(), 1e-6)
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
SOFTMAX_SHAPES = {"prefill": (2048, 32), "decode": (4, 32),
                  "train": (4096, 32), "ragged-40": (4095, 40),
                  "wide-row": (256, 4096), "rank3": (2, 5, 4)}


@pytest.mark.parametrize("name", sorted(SOFTMAX_SHAPES))
def test_softmax_kernels_match_plain(cuda, name):
    from repro_torch.kernels import softmax as K

    shape = SOFTMAX_SHAPES[name]
    x = torch.randn(shape, device="cuda", generator=cuda) * 3.0
    dy = torch.randn(shape, device="cuda", generator=cuda)
    before = (K.softmax_cuda.launches, K.softmax_bwd_cuda.launches)
    y = K.softmax(x)
    dx = K.softmax_bwd(y, dy)
    assert (K.softmax_cuda.launches,
            K.softmax_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)
    # float32, the same steps in another summation order: a few ulp
    torch.testing.assert_close(y, K.softmax_plain(x), rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(dx, K.softmax_bwd_plain(y, dy), rtol=1e-5,
                               atol=1e-6)


def test_softmax_kernels_refuse_what_they_do_not_take(cuda):
    from repro_torch.kernels import softmax as K

    x = torch.randn(4, 32, device="cuda")
    with pytest.raises(TypeError):
        K.softmax_cuda(x.half())
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
    before = SM.softmax_cuda.launches
    got = generate(gpu, gparams, prompts, 6)
    # one router softmax a layer, in the prefill and in each of 5 decodes
    assert SM.softmax_cuda.launches - before == 6 * cfg.n_layers
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
    assert results["cuda"][2] == (cfg.n_layers, cfg.n_layers)
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
    (zero-padded to 32), 256 (its own instance), 320 (the wide flash
    kernel) and 16 query heads a KV head (two sub-groups, two launches),
    each held against the plain version, the launches counted."""
    from repro_torch.kernels import flash_attention as K

    q = torch.randn(1, 32, 64, device="cuda")
    kv = torch.randn(1, 2, 16, 64, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        K.flash_decode_cuda(q[:, :4].half(), kv.half(), kv.half(), None)
    with pytest.raises(ValueError, match="kv_len"):
        K.flash_decode_cuda(q[:, :4], kv, kv, 0)
    for B, Hq, Hkv, S, D, n, launches, wide in (
            (1, 4, 2, 100, 32, 77, 1, 0), (2, 8, 2, 300, 80, 250, 1, 0),
            (2, 8, 4, 300, 100, 299, 1, 0), (1, 6, 2, 90, 30, 77, 1, 0),
            (2, 16, 16, 700, 256, None, 1, 0), (1, 16, 2, 500, 256, 499, 1, 0),
            (2, 32, 2, 600, 128, 555, 2, 0), (1, 8, 2, 400, 320, 321, 0, 1)):
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
        got, _ = make_decode_step(gpu, kv_len)(gparams, caches[1],
                                               tok.cuda(), pos)
        assert K.flash_decode_cuda.launches - before == n_attn
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
