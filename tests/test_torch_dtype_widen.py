"""float16 and mixed operand types, against the JAX package.

The reference's kernels widen every operand to float32 inside the kernel
and store each output in its ref's type (``src/repro/kernels/
flash_attention.py:46-48``, ``rmsnorm.py:13-16``, ``layernorm.py:23-31,
79-87``, ``softmax.py:15-19, 46-47``), so they give a result for
float16 operands and for any mix.  The port's operators do the same: on
the CPU their plain versions widen to float32; on the card the wrappers
widen what the kernels' float32 and bfloat16 instances do not take
(``kernels/widen.py``; ``tests/test_torch_gpu.py`` holds them there).
Here each operator on the CPU meets the reference's kernel in interpret
mode on the same seeded float16 or mixed inputs: the output in the
reference's type, the values within one rounding of that type (both
compute in float32 and round once; sums run in another order, so the
roundings may fall on either side: 2 ulps of float16, 2^-9 relative
plus 2^-14, and of bfloat16, 2^-6 plus 2^-10).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.flash_attention import flash_decode as jdecode  # noqa: E402
from repro.kernels.layernorm import _ln_bwd as jln_bwd  # noqa: E402
from repro.kernels.layernorm import layernorm_fwd as jln_fwd  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_fwd as jrms_fwd  # noqa: E402
from repro.kernels.softmax import softmax_bwd as jsoftmax_bwd  # noqa: E402
from repro.kernels.softmax import softmax_fwd as jsoftmax_fwd  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import layernorm as LN  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.kernels import softmax as SM  # noqa: E402
from repro_torch.kernels import widen  # noqa: E402

F16, BF16, F32 = torch.float16, torch.bfloat16, torch.float32
JAX = {F16: jnp.float16, BF16: jnp.bfloat16, F32: jnp.float32}
#: (rtol, atol) of one rounding, either side, of each output type
TOL = {F16: (2.0 ** -9, 2.0 ** -14), BF16: (2.0 ** -6, 2.0 ** -10),
       F32: (1e-5, 1e-6)}


def _inputs(seed: int, shapes_types) -> list:
    """(torch tensor, jax array) pairs of the same values, each of its
    type: seeded normals rounded to that type first."""
    r = np.random.default_rng(seed)
    out = []
    for shape, dt in shapes_types:
        t = torch.from_numpy(r.standard_normal(shape).astype(np.float32)
                             ).to(dt)
        out.append((t, jnp.asarray(t.float().numpy(), JAX[dt])))
    return out


def _close(got: torch.Tensor, want, dtype) -> None:
    assert got.dtype == dtype, (got.dtype, dtype)
    assert str(want.dtype) == str(dtype).removeprefix("torch."), want.dtype
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("types", [(BF16, F32, F32), (F16, F16, F16),
                                   (F16, BF16, F32), (F32, F16, F16)],
                         ids=["q-bf16-kv-f32", "f16", "f16-bf16-f32",
                              "q-f32-kv-f16"])
def test_b4_flash_attention_widens_mixes(types):
    (q, jq), (k, jk), (v, jv) = _inputs(
        4, [((2, 4, 40, 32), types[0]), ((2, 2, 40, 32), types[1]),
            ((2, 2, 40, 32), types[2])])
    want = jflash(jq, jk, jv, causal=True, block_q=16, block_k=16,
                  interpret=True)
    got = FA.flash_attention(q, k, v, True)
    _close(got, want, types[0])


@pytest.mark.parametrize("types", [(F16, F16), (BF16, F16), (F16, F32)],
                         ids=["f16", "q-bf16-cache-f16", "q-f16-cache-f32"])
def test_b8_flash_decode_widens_mixes(types):
    (q, jq), (k, jk), (v, jv) = _inputs(
        8, [((2, 6, 64), types[0]), ((2, 2, 96, 64), types[1]),
            ((2, 2, 96, 64), types[1])])
    want = jdecode(jq, jk, jv, kv_len=70, block_k=32, interpret=True)
    got = FA.flash_decode(q, k, v, 70)
    _close(got, want, types[0])


@pytest.mark.parametrize("types", [(F16, F16), (F16, F32), (F32, F16),
                                   (BF16, F16)])
def test_b6_rmsnorm_widens_float16(types):
    (x, jx), (g, jg) = _inputs(6, [((33, 96), types[0]), ((96,), types[1])])
    want_y, want_rstd = jrms_fwd(jx, jg, eps=1e-6, block_rows=8,
                                 interpret=True)
    y, rstd = RN.rmsnorm(x, g, 1e-6)
    _close(y, want_y, types[0])
    _close(rstd, want_rstd, F32)


@pytest.mark.parametrize("types", [(F16, F16, F16), (F16, BF16, F32),
                                   (F32, F16, F16)])
def test_b5_layernorm_widens_float16(types):
    (x, jx), (g, jg), (b, jb) = _inputs(
        5, [((33, 96), types[0]), ((96,), types[1]), ((96,), types[2])])
    want_y, (want_mean, want_rstd) = jln_fwd(jx, jg, jb, eps=1e-5,
                                              block_rows=8, interpret=True)
    y, mean, rstd = LN.layernorm(x, g, b, 1e-5)
    _close(y, want_y, types[0])
    _close(mean, want_mean, F32)
    _close(rstd, want_rstd, F32)


@pytest.mark.parametrize("types", [(F16, F16), (F16, F32), (BF16, F16)])
def test_b9_layernorm_bwd_widens_float16(types):
    (x, jx), (dy, jdy), (g, jg) = _inputs(
        9, [((33, 96), types[0]), ((33, 96), types[1]), ((96,), F16)])
    _, mean, rstd = LN.layernorm_plain(x, g, torch.zeros(96, dtype=F16),
                                       1e-5)
    jmean, jrstd = (jnp.asarray(t.numpy()) for t in (mean, rstd))
    want_dx, want_dg, want_db = jln_bwd(jx, jg, jmean, jrstd, jdy,
                                        block_rows=8, interpret=True)
    dx, dg, db = LN.layernorm_bwd(x, g, mean, rstd, dy)
    _close(dx, want_dx, types[0])
    # float32 sums over 33 rows, in another order
    np.testing.assert_allclose(dg.numpy(), np.asarray(want_dg), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(want_db), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dt", [F16, BF16])
def test_b7_softmax_widens_float16(dt):
    (x, jx), = _inputs(7, [((40, 24), dt)])
    _close(SM.softmax(x), jsoftmax_fwd(jx, block_rows=8, interpret=True), dt)


@pytest.mark.parametrize("types", [(F16, F16), (F16, F32), (BF16, F16)])
def test_b10_softmax_bwd_widens_mixes(types):
    (y, jy), (dy, jdy) = _inputs(10, [((40, 24), types[0]),
                                      ((40, 24), types[1])])
    want = jsoftmax_bwd(jy, jdy, block_rows=8, interpret=True)
    _close(SM.softmax_bwd(y, dy), want, types[0])


def test_the_widening_rule():
    """What ``widen`` hands a kernel: a type its instances take as it is,
    float16 and mixes in float32; float64 refused, as the reference runs
    without x64."""
    h, b, f = (torch.zeros(2, dtype=d) for d in (F16, BF16, F32))
    assert widen.own(b) is b and widen.own(f) is f
    assert widen.own(h).dtype == F32
    assert all(t.dtype == BF16 for t in widen.one_type(b, b))
    assert [t.dtype for t in widen.one_type(b, f)] == [F32, F32]
    assert [t.dtype for t in widen.one_type(h, h)] == [F32, F32]
    widen.check("k", {"a": h, "b": b, "c": f})
    with pytest.raises(TypeError, match="float64"):
        widen.check("k", {"a": h, "b": torch.zeros(2, dtype=torch.float64)})
    assert widen.to(f, F32) is f and widen.to(f, F16).dtype == F16
