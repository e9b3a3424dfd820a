"""Generated kernels on the card: each held against its plain version.

Marked ``gpu``: on a host without a CUDA card every test here skips (the
decision is made in a fixture, never at import).  Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import H100, stitched_jit  # noqa: E402
from repro_torch.core import codegen  # noqa: E402
from repro_torch.core.tracer import TORCH_DTYPES  # noqa: E402
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


def test_bf16_rmsnorm(cuda):
    args = [torch.randn(300, 3072, device="cuda").bfloat16(),
            torch.randn(3072, device="cuda")]
    # bf16 output: one bf16 ulp at magnitude ~4
    _check(rmsnorm, args, H100, "onepass", atol=3e-2)


def test_reduced_model_on_the_card(cuda):
    cfg = get_config("llama3.2-3b").reduced()
    model = Model(cfg)
    params = model.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), device="cuda",
                           generator=cuda)
    before = (codegen.OnePassKernel.launches,
              codegen.StreamingKernel.launches)
    logits, probs = model.forward(params, tokens)
    after = (codegen.OnePassKernel.launches,
             codegen.StreamingKernel.launches)
    assert sum(after) > sum(before)
    ref_logits, _ = Model(cfg, dispatch="interpret").forward(params, tokens)
    torch.testing.assert_close(logits, ref_logits, rtol=1e-4, atol=1e-4)
    block = stitched_jit(functools.partial(block_apply, cfg))
    h = params["embed"][tokens]
    assert block.report(params["blocks"][0], h,
                        torch.arange(16, device="cuda")).n_generated >= 1
