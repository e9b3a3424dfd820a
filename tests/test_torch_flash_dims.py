"""Flash attention's head-dim instances (B4: D 64, 80, 128 and 256),
against the JAX package.

HuBERT's 80 runs on an instance of its own, and Gemma-7B's 256 on the
largest; a D between two instances is zero-padded up to the next, and a
D above 256 has none.  On the CPU the operator runs its plain version:
the same inputs, made with numpy from a seed, go through the reference's
``flash_attention`` (Pallas in interpret mode, 16-row blocks, so Skv 40
leaves a ragged last K block) and the port's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

rng = np.random.default_rng(31)

#: (D, Sq, Skv, causal, Hq, Hkv): HuBERT's head dim (non-causal, as its
#: encoder) and Gemma-7B's (causal; grouped and ungrouped heads)
CASES = {"d80-noncausal": (80, 24, 40, False, 2, 2),
         "d80-causal-gqa": (80, 40, 40, True, 4, 2),
         "d256-causal": (256, 40, 40, True, 2, 2),
         "d256-causal-offset-gqa": (256, 8, 40, True, 4, 2)}


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


def test_head_dim_264_raises():
    with pytest.raises(ValueError, match="head dim 264 > 256"):
        FA.flash_instance(264)
    with pytest.raises(ValueError, match="head dim 264 > 256"):
        FA.flash_smem_bytes(264)
    q = torch.empty(1, 2, 8, 264, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_cuda(q, q, q, False)
