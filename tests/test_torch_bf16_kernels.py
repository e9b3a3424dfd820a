"""B5/B9 (LayerNorm and its backward), B7/B10 (the row softmax and its
backward) and B11 (the SSD scan) in bfloat16, against the JAX package.

The reference's TPU kernels take bfloat16: they widen it to float32 and
write y, dx in the input's type (``src/repro/kernels/layernorm.py:23-31,
79-87``, ``softmax.py:15-19,46-49``, ``ssd_scan.py:34-38,61``).  Here
the port's plain versions -- what each CUDA wrapper runs on a CPU tensor,
and what the card's checks hold each kernel to -- take the same numpy
inputs rounded to bfloat16 as the Pallas kernels in interpret mode:
every output within the reference's bfloat16 band (rtol = atol = 2e-2,
``src/repro/runtime/guard.py:208-213``) and of the reference's dtype.
The operators' fake registrations give the reference's dtypes (y of the
scan like x; dgamma and dbeta after autograd like gamma), and a reduced
bfloat16 train step of Mamba2 (the scan) and HuBERT (LayerNorm) holds
the reference's by the bfloat16 path rule: the port's loss and each
gradient at most 1.5 times the reference's bfloat16 distance from a
float32 run of the same weights, plus 1e-3 max(1, max|value|).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticTokens as JSyntheticTokens  # noqa: E402
from repro.kernels.layernorm import _ln_bwd as jln_bwd  # noqa: E402
from repro.kernels.layernorm import layernorm as jlayernorm  # noqa: E402
from repro.kernels.layernorm import layernorm_fwd as jln_fwd  # noqa: E402
from repro.kernels.softmax import softmax_bwd as jsoftmax_bwd  # noqa: E402
from repro.kernels.softmax import softmax_fwd as jsoftmax_fwd  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jssd_kernel  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import layernorm as LN  # noqa: E402
from repro_torch.kernels import softmax as SM  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402

BF16 = torch.bfloat16
#: the reference's bfloat16 band (rtol, atol)
BAND = dict(rtol=2e-2, atol=2e-2)


def _bf(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (as float32): both packages
    start from the same bfloat16 inputs."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _pair(a: np.ndarray, dtype=BF16):
    """(the JAX array, the torch tensor) of ``a`` in bfloat16 (or float32)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    j = jnp.asarray(a, jnp.bfloat16 if dtype == BF16 else jnp.float32)
    return j, t


def _hold(got: torch.Tensor, want) -> None:
    """``got`` of the reference's dtype, within the bfloat16 band."""
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype), (
        got.dtype, want.dtype)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want.astype(jnp.float32)), **BAND)


@pytest.mark.parametrize("R,C", [(7, 64), (130, 96), (3, 203)])
def test_b5_b9_plain_match_the_pallas_kernels(R, C):
    """LayerNorm forward and backward in bfloat16 (x, gamma, beta, dy):
    the statistics, dgamma and dbeta float32, y and dx bfloat16 -- at a
    ragged row count (130 rows past the reference's block of 128) and a
    width no multiple of 8."""
    rng = np.random.default_rng(R * C)
    jx, x = _pair(rng.standard_normal((R, C)).astype(np.float32) * 2 + 0.5)
    jg, g = _pair(1 + 0.1 * rng.standard_normal(C).astype(np.float32))
    jb, b = _pair(0.1 * rng.standard_normal(C).astype(np.float32))
    jdy, dy = _pair(rng.standard_normal((R, C)).astype(np.float32))
    jy, (jmean, jrstd) = jln_fwd(jx, jg, jb, eps=1e-5, interpret=True)
    y, mean, rstd = LN.layernorm(x, g, b, 1e-5)
    _hold(y, jy)
    _hold(mean, jmean)
    _hold(rstd, jrstd)
    jdx, jdg, jdb = jln_bwd(jx, jg, jmean, jrstd, jdy, interpret=True)
    dx, dg, db = LN.layernorm_bwd(x, g, mean, rstd, dy)
    _hold(dx, jdx)
    # dgamma and dbeta sum R rows: the band scaled to the sums' size
    for got, want in ((dg, jdg), (db, jdb)):
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        w = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), w, rtol=2e-2,
                                   atol=2e-2 * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("R,C", [(65, 32), (9, 40), (4, 300)])
def test_b7_b10_plain_match_the_pallas_kernels(R, C):
    """The row softmax and its backward in bfloat16: the router's width,
    a ragged row count past the reference's block of 64, a width no
    multiple of 8 and one past the kernels' lanes."""
    rng = np.random.default_rng(R + C)
    jx, x = _pair(3 * rng.standard_normal((R, C)).astype(np.float32))
    jy = jsoftmax_fwd(jx, interpret=True)
    y = SM.softmax(x)
    _hold(y, jy)
    jdy, dy = _pair(rng.standard_normal((R, C)).astype(np.float32))
    # both backward kernels from the same bfloat16 y
    jyy = jnp.asarray(y.to(torch.float32).numpy(), jnp.bfloat16)
    _hold(SM.softmax_bwd(y, dy), jsoftmax_bwd(jyy, jdy, interpret=True))


def _scan_inputs(b, L, H, P, N, seed):
    """x, dt, A, B, C as numpy, x, B and C bfloat16 values (as float32)."""
    rng = np.random.default_rng(seed)
    xbc = _bf(rng.standard_normal((b, L, H * P + 2 * N)).astype(np.float32))
    dt = np.log1p(np.exp(rng.standard_normal((b, L, H)) - 2.0)) \
        .astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    return xbc, dt, A


@pytest.mark.parametrize("chunk", [32, 64])
def test_b11_plain_matches_the_pallas_kernel(chunk):
    """The SSD scan with bfloat16 x, B and C -- column slices of one
    bfloat16 activation, as ``mamba_apply`` passes them -- and float32 dt
    and A: y bfloat16, the state float32, at two chunk lengths."""
    b, L, H, P, N = 2, 128, 3, 16, 32
    xbc, dt, A = _scan_inputs(b, L, H, P, N, seed=chunk)
    t = torch.from_numpy(xbc).to(BF16)
    x = t[..., :H * P].reshape(b, L, H, P)
    Bm, Cm = t[..., H * P:H * P + N], t[..., H * P + N:]
    assert x.stride(-1) == 1 and not x.is_contiguous()
    j = jnp.asarray(xbc, jnp.bfloat16)
    jy, jstate = jssd_kernel(j[..., :H * P].reshape(b, L, H, P),
                             jnp.asarray(dt), jnp.asarray(A),
                             j[..., H * P:H * P + N], j[..., H * P + N:],
                             chunk=chunk, interpret=True)
    y, state = SSD.ssd_scan(x, torch.from_numpy(dt), torch.from_numpy(A),
                            Bm, Cm, chunk)
    _hold(y, jy)
    _hold(state, jstate)


def test_fake_registrations_give_the_references_dtypes():
    """Traced on meta tensors: the scan's y like x (bfloat16) and its
    state float32; LayerNorm's y like x, and after autograd dx like x,
    dgamma and dbeta like gamma -- the dtypes of the reference's
    functions (``jax.eval_shape`` of the scan and of the LayerNorm's
    ``jax.vjp``)."""
    b, L, H, P, N = 1, 64, 2, 16, 16
    meta = dict(device="meta")
    x = torch.empty(b, L, H, P, dtype=BF16, **meta)
    dt = torch.empty(b, L, H, **meta)
    A = torch.empty(H, **meta)
    Bm = torch.empty(b, L, N, dtype=BF16, **meta)
    y, state = torch.ops.repro_torch.ssd_scan(x, dt, A, Bm, Bm, 64)
    sd = jax.ShapeDtypeStruct
    jy, jstate = jax.eval_shape(
        lambda *a: jssd_kernel(*a, chunk=64, interpret=True),
        sd(x.shape, jnp.bfloat16), sd(dt.shape, jnp.float32),
        sd(A.shape, jnp.float32), sd(Bm.shape, jnp.bfloat16),
        sd(Bm.shape, jnp.bfloat16))
    assert (str(y.dtype), str(state.dtype)) == (
        f"torch.{jy.dtype}", f"torch.{jstate.dtype}")
    assert tuple(y.shape) == jy.shape and tuple(state.shape) == jstate.shape

    for gd, jgd in ((BF16, jnp.bfloat16), (torch.float32, jnp.float32)):
        xl = torch.empty(8, 64, dtype=BF16, **meta).requires_grad_()
        g = torch.empty(64, dtype=gd, **meta).requires_grad_()
        bb = torch.empty(64, dtype=gd, **meta).requires_grad_()
        yl = LN.layernorm(xl, g, bb, 1e-5)[0]
        dx, dg, db = torch.autograd.grad(yl, (xl, g, bb),
                                         torch.empty_like(yl))

        def f(a, gg, be):
            return jlayernorm(a, gg, be, 1e-5)

        args = (sd((8, 64), jnp.bfloat16), sd((64,), jgd), sd((64,), jgd))
        jyl = jax.eval_shape(f, *args)
        jgrads = jax.eval_shape(
            lambda *a: jax.vjp(f, *a)[1](jnp.zeros((8, 64), jnp.bfloat16)),
            *args)
        assert str(yl.dtype) == f"torch.{jyl.dtype}"
        assert [str(t.dtype) for t in (dx, dg, db)] == [
            f"torch.{t.dtype}" for t in jgrads]


def _batch(arch):
    return JSyntheticTokens(JDataConfig(seed=1, global_batch=2, seq_len=16),
                            jget_config(arch).reduced()).batch_at(0)


@pytest.mark.parametrize("arch", ["mamba2-370m", "hubert-xlarge"])
def test_bfloat16_train_step_matches_the_reference(arch):
    """A reduced bfloat16 train step's loss and gradients (the scan's
    plain version and its VJP for Mamba2; LayerNorm's plain forward and
    backward for HuBERT) against the reference's, each package's distance
    from the float32 run of the same weights (the bfloat16 values
    widened): the port's at most 1.5 times the reference's, plus 1e-3
    max(1, max|value|)."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jm = jbuild_model(jcfg, param_dtype=jnp.bfloat16, remat=False)
    jm32 = jbuild_model(jcfg, remat=False)
    jp = jm.init(jax.random.PRNGKey(7))
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    batch = _batch(arch)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp, jbatch)
    eloss, egrads = jax.value_and_grad(jm32.loss)(jp32, jbatch)
    mdl = build_model(cfg, param_dtype=BF16, remat=False, device="cpu")
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    assert all(t.dtype == BF16 for t in tree_leaves(tp)
               if t.dtype != torch.float32)
    loss, grads = loss_and_grads(
        mdl, tp, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})

    def rule(got, ref, exact, what):
        e = np.asarray(jnp.asarray(exact, jnp.float32))
        port = np.abs(np.asarray(got, np.float32) - e).max()
        refd = np.abs(np.asarray(jnp.asarray(ref, jnp.float32)) - e).max()
        limit = 1.5 * refd + 1e-3 * max(1.0, float(np.abs(e).max()))
        assert port <= limit, (what, port, refd, limit)

    rule(float(loss), jloss, eloss, "loss")
    jg = jax.tree_util.tree_map(np.asarray, jgrads)
    eg = jax.tree_util.tree_map(np.asarray, egrads)
    pairs = [(k, grads[k], jg[k], eg[k]) for k in grads if k != "blocks"]
    for i, blk in enumerate(grads["blocks"]):
        pairs.append((f"blocks[{i}]", blk,
                      jax.tree_util.tree_map(lambda a: a[i], jg["blocks"]),
                      jax.tree_util.tree_map(lambda a: a[i], eg["blocks"])))
    n = 0
    for what, got, want, exact in pairs:
        gl, wl = tree_leaves(got), jax.tree_util.tree_leaves(want)
        el = jax.tree_util.tree_leaves(exact)
        assert len(gl) == len(wl) == len(el), what
        for a, w, e in zip(gl, wl, el):
            assert str(a.dtype) == f"torch.{w.dtype}", (what, a.dtype, w.dtype)
            rule(a.to(torch.float32).numpy(), w, e, what)
            n += 1
    assert n == len(jax.tree_util.tree_leaves(jgrads)) - len(
        jax.tree_util.tree_leaves(jg["blocks"])) + len(
        jax.tree_util.tree_leaves(jg["blocks"])) * len(grads["blocks"])
