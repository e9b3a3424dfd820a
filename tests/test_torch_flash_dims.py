"""Flash attention's head-dim instances (B4: D 64, 80, 128 and 256) and
its wide kernel above 256, against the JAX package.

HuBERT's 80 runs on an instance of its own, and Gemma-7B's 256 on the
largest; a D between two instances is zero-padded up to the next, and a
D above 256 runs on the wide kernel (``csrc/flash_attention_wide.cu``),
as the reference's kernel has no ceiling on D.  On the CPU the operator
runs its plain version: the same inputs, made with numpy from a seed, go
through the reference's ``flash_attention`` (Pallas in interpret mode,
16-row blocks, so Skv 40 leaves a ragged last K block) and the port's.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

rng = np.random.default_rng(31)

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"

#: (D, Sq, Skv, causal, Hq, Hkv): HuBERT's head dim (non-causal, as its
#: encoder), Gemma-7B's (causal; grouped and ungrouped heads), and head
#: dims above the tuned instances (the wide kernel's: two D-tiles each)
CASES = {"d80-noncausal": (80, 24, 40, False, 2, 2),
         "d80-causal-gqa": (80, 40, 40, True, 4, 2),
         "d256-causal": (256, 40, 40, True, 2, 2),
         "d256-causal-offset-gqa": (256, 8, 40, True, 4, 2),
         "d264-causal-gqa": (264, 40, 40, True, 4, 2),
         "d320-noncausal": (320, 24, 40, False, 2, 2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_matches_the_pallas_kernel_at_head_dim(case):
    D, Sq, Skv, causal, Hq, Hkv = CASES[case]
    q = rng.standard_normal((1, Hq, Sq, D)).astype(np.float32)
    k = rng.standard_normal((1, Hkv, Skv, D)).astype(np.float32)
    v = rng.standard_normal((1, Hkv, Skv, D)).astype(np.float32)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, block_q=16, block_k=16, interpret=True)
    before = FA.flash_attention_cuda.launches
    got = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal, None)
    assert FA.flash_attention_cuda.launches == before
    assert got.shape == (1, Hq, Sq, D)
    # float32, one softmax pass against the reference's online one
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_flash_instances_cover_the_carried_head_dims():
    assert FA.MAX_HEAD_DIM == 256
    assert FA.flash_instance(80) == 80
    assert FA.flash_instance(64) == 64 and FA.flash_instance(128) == 128
    assert FA.flash_instance(256) == 256
    # between instances: zero-padded up to the next
    assert FA.flash_instance(32) == 64 and FA.flash_instance(96) == 128
    assert FA.flash_instance(160) == 256
    for d in FA.FLASH_HEAD_DIMS:
        assert d % 16 == 0 and FA.flash_smem_bytes(d) <= 232_448
    # above 256: no tuned instance; the wide kernel runs D as it is
    assert FA.flash_instance(264) is None and FA.flash_instance(1024) is None


@pytest.mark.parametrize("D", [264, 320])
def test_head_dim_above_256_runs_the_wide_kernel(D):
    """The shapes above 256 that raised before: the operator computes them
    on the CPU (plain), the wide kernel's shared memory is its own, and a
    tensor that is not on the card still refuses the CUDA wrappers."""
    q = rng.standard_normal((1, 2, 8, D)).astype(np.float32)
    want = jflash(*(jnp.asarray(q),) * 3, causal=True, block_q=16,
                  block_k=16, interpret=True)
    got = FA.flash_attention(*(torch.from_numpy(q),) * 3, True, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert FA.flash_smem_bytes(D) == FA.flash_smem_bytes(1024) <= 48 * 1024
    assert FA.flash_kbk(D) == FA.WIDE_BK
    meta = torch.empty(1, 2, 8, D, device="meta")
    for fn in (FA.flash_attention_cuda, FA.flash_attention_wide_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(meta, meta, meta, False)


def test_wide_kernel_constants_are_its_own():
    """The wide kernel's tiles mirrored in Python are the ones its source
    uses, and its D-tiles are at most 256 columns."""
    cu = (CSRC / "flash_attention_wide.cu").read_text()
    got = {k: int(re.search(rf"constexpr int {k} = (\d+);", cu).group(1))
           for k in ("kBQ", "kBK", "kDC", "kDT")}
    assert got == {"kBQ": FA.WIDE_BQ, "kBK": FA.WIDE_BK, "kDC": FA.WIDE_DC,
                   "kDT": FA.WIDE_DT}
    for name in ("qs[kBQ][kDC + 1]", "ks[kBK][kDC + 1]",
                 "ps[kBQ][kBK + 1]", "vs[kBK][kDT]"):
        assert name in cu
