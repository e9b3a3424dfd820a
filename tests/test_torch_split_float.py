"""The three-way TF32 split of B3 and B4 (``kernels/split_float.py``), on
the CPU: the design's numerical argument, where there is no card.

* ``tf32_rna`` is ``cvt.rna.tf32.f32``: round to nearest, ties away from
  zero, 10 mantissa bits kept (held to a bit-level numpy reference);
* big + small reproduces x to 2^-22 of |x|;
* the three TF32 products summed in float32 a k-tile at a time (the
  kernels' structure) hold B3's limit against the plain float32 product
  and B4's RTOL limit against float64, over K 3072 and 8192 on a few
  hundred seeded rows at the scales of the chip's shapes;
* the limits restated in the module are ``chip_smoke.py``'s own.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import split_float as SF  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _rna_reference(x: np.ndarray) -> np.ndarray:
    """Round float32 to 10 mantissa bits, to nearest, ties away from zero,
    on the sign-magnitude bits."""
    bits = x.astype(np.float32).view(np.uint32)
    sign, mag = bits & 0x80000000, bits & 0x7FFFFFFF
    low = mag & 0x1FFF
    mag = (mag & ~np.uint32(0x1FFF)) + np.where(low >= 0x1000, 0x2000, 0)
    return (sign | mag.astype(np.uint32)).view(np.float32)


def test_tf32_rna_rounds_to_nearest_ties_away():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000) * 10.0 ** rng.uniform(-6, 6, 20000)) \
        .astype(np.float32)
    one = np.float32(1.0)
    ties = np.array([one + np.float32(2 ** -11), -(one + np.float32(2 ** -11)),
                     one + np.float32(3 * 2 ** -11),
                     np.float32(1.5) + np.float32(2 ** -12)], np.float32)
    x = np.concatenate([x, ties])
    got = SF.tf32_rna(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _rna_reference(x).view(np.uint32))
    assert not (got.view(np.uint32) & 0x1FFF).any()
    # the ties round away from zero
    assert got[-4] == np.float32(1 + 2 ** -10)
    assert got[-3] == -np.float32(1 + 2 ** -10)
    assert got[-2] == np.float32(1 + 2 * 2 ** -10)


def test_big_plus_small_is_x_to_two_pow_minus_22():
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal(100000)
                          * 10.0 ** rng.uniform(-4, 4, 100000))
                         .astype(np.float32))
    big, small = SF.split(x)
    assert not (big.view(torch.int32) & 0x1FFF).any()
    assert not (small.view(torch.int32) & 0x1FFF).any()
    err = (big.double() + small.double() - x.double()).abs()
    assert float((err / x.double().abs()).max()) <= 2.0 ** -22


#: (K, lhs scale, rhs scale, k-tile): the Llama gate (unit activations,
#: weights at K^-0.5, the large tile's 32) and bench_anchor_fusion's
#: second MLP group (GELU outputs of an unscaled product, std ~ 55,
#: unscaled weights, values up to thousands; K 8192)
PRODUCTS = {"llama-gate-K3072": (3072, 1.0, 3072 ** -0.5, 32),
            "bench-mlp-K8192": (8192, 55.0, 1.0, 32)}


@pytest.mark.parametrize("case", sorted(PRODUCTS))
def test_split_product_holds_the_kernels_limits(case):
    K, sa, sb, bk = PRODUCTS[case]
    rng = np.random.default_rng(2)
    a = torch.from_numpy((rng.standard_normal((256, K)) * sa)
                         .astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((K, 48)) * sb)
                         .astype(np.float32))
    f64 = a.double() @ b.double()
    plain = a @ b
    got = SF.split_matmul(a, b, bk)
    assert SF.b3_ratio(got, plain, f64) <= 1.0
    assert SF.b4_ratio(got, f64) <= 1.0
    # the dropped small x small term is the split's only loss: far below
    # the float32 sum's own rounding
    assert float((got.double() - f64).abs().max()) \
        <= 2 * float((plain.double() - f64).abs().max()) + 1e-6


def test_split_attention_holds_b4s_limit():
    """Both products of attention split (q k^T a partial sum each 16 of D,
    p v each 64 keys, as the kernel sums them) at B4's limit against
    float64, at the HuBERT train shape's head dim 80, a few rows."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 128, 80))
                                .astype(np.float32)) for _ in range(3))
    got = SF.attention(q, k, v, causal=False,
                       product=lambda x, y: SF.split_matmul(x, y, 16),
                       pv=lambda x, y: SF.split_matmul(x, y, 64))
    f64 = SF.attention(q.double(), k.double(), v.double(), causal=False)
    assert SF.b4_ratio(got, f64) <= 1.0


def test_limits_are_chip_smokes_own():
    text = (ROOT / "chip_smoke.py").read_text()
    b3 = re.search(r"^B3_RTOL, B3_SUM_FACTOR = ([\d.e-]+), ([\d.e-]+)$",
                   text, re.M)
    rtol = re.search(r"^RTOL, FLOOR = ([\d.e-]+), ([\d.e-]+)$", text, re.M)
    assert (float(b3.group(1)), float(b3.group(2))) == (SF.B3_RTOL,
                                                        SF.B3_SUM_FACTOR)
    assert float(rtol.group(1)) == SF.RTOL == float(rtol.group(2))
