"""The SSD scan (B11) at any chunk and any head dim and state, against the
JAX package.

One launch of the CUDA kernel takes chunks of at most 64 rows and tiles
that fit a block's shared memory.  ``ssd_scan_sliced`` runs a longer
chunk at its largest divisor up to 64 (``kernel_chunk``) and cuts wider
tiles into the fewest slices that fit (``ssd_slices``): over P (y's and
the state's rows of head dim p depend on x's column p alone) and over N
(y sums over N, the state's columns split with B and C).  Here each
launch is the plain version, and the composition is held against the
reference's ``ssd_scan`` (the Pallas kernel in interpret mode) on the same
numpy inputs: each split is exact up to rounding.  The shared-memory
function is the kernel's own formula (``csrc/ssd_scan.cu``: ``dims``,
``smem_a``, ``smem_c``), mirrored in ``test_torch_ssd_smem.py``; a test on the
card holds the mirror to the library's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_scan as jssd_kernel  # noqa: E402
from repro_torch.kernels import ssd_scan as K  # noqa: E402

from test_torch_ssd_smem import kernel_smem  # noqa: E402



def _inputs(b, L, H, P, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, L, H)) - 2.0)) \
        .astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    B = rng.standard_normal((b, L, N)).astype(np.float32)
    C = rng.standard_normal((b, L, N)).astype(np.float32)
    return x, dt, A, B, C


def _sliced(ins, chunk, smem=kernel_smem, limit=K.SMEM_LIMIT):
    """The CUDA wrapper's composition with the plain version as each
    launch, counting the launches and the chunks they ran at."""
    calls = []

    def scan(*a):
        calls.append((a[0].shape[-1], a[3].shape[-1], a[5]))
        return K.ssd_scan_plain(*a)

    y, s = K.ssd_scan_sliced(*map(torch.from_numpy, ins), chunk, scan, smem,
                             limit)
    return y, s, calls


def _hold(got, want):
    # the SSD limit (PERF.md section 2): float32 sums over chunks of
    # another length and the state, in another order; the carry from
    # chunk to chunk compounds the rounding, so each output is held to
    # 1e-4 max(1, max|reference|)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0, atol=1e-4 * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("chunk,want", [(64, 64), (128, 64), (96, 48),
                                        (20, 20), (67, 1), (256, 64)])
def test_kernel_chunk_is_the_largest_divisor_up_to_64(chunk, want):
    assert K.kernel_chunk(chunk) == want
    assert chunk % want == 0


def test_chunk_128_runs_as_chunks_of_64():
    """A config's ``ssd_chunk`` of 128: two chunks of 64 a launch's chunk,
    the state passed between them -- the reference's function."""
    ins = _inputs(2, 256, 3, 16, 32, seed=1)
    jy, js = jssd_kernel(*map(jnp.asarray, ins), chunk=128, interpret=True)
    y, s, calls = _sliced(ins, 128)
    assert calls == [(16, 32, 64)]
    _hold((y, s), (jy, js))


def test_head_dim_and_state_256_run_in_slices():
    """P = N = 256 passes one block's 232,448 bytes at chunk 64: the plan
    cuts it into the fewest slices that fit, and the slices' y and states
    put together are the reference's."""
    assert kernel_smem(64, 256, 256) > K.SMEM_LIMIT
    # two launches cannot hold it; three slices of P (96, 96, 64) can
    assert kernel_smem(64, 128, 256) > K.SMEM_LIMIT
    assert kernel_smem(64, 256, 128) > K.SMEM_LIMIT
    p_slices, n_slices = K.ssd_slices(64, 256, 256, kernel_smem)
    assert (len(p_slices), len(n_slices)) == (3, 1)
    for sp in p_slices:
        for sn in n_slices:
            assert kernel_smem(64, sp.stop - sp.start,
                               sn.stop - sn.start) <= K.SMEM_LIMIT
    ins = _inputs(1, 128, 2, 256, 256, seed=2)
    jy, js = jssd_kernel(*map(jnp.asarray, ins), chunk=64, interpret=True)
    y, s, calls = _sliced(ins, 64)
    assert calls == [(96, 256, 64), (96, 256, 64), (64, 256, 64)]
    _hold((y, s), (jy, js))


@pytest.mark.parametrize("limit,slices", [(1500, (3, 1)), (1100, (3, 2))],
                         ids=["over-P", "over-P-and-N"])
def test_slices_over_p_and_over_n_are_exact(limit, slices):
    """With a toy shared-memory function the plan must cut P alone, then
    P and N: y is the sum of the N slices' y, the state's columns follow
    B's and C's, and both agree with the reference."""
    def toy(chunk, P, N):
        return P * N

    ins = _inputs(2, 96, 3, 80, 40, seed=3)
    p_slices, n_slices = K.ssd_slices(32, 80, 40, toy, limit)
    assert (len(p_slices), len(n_slices)) == slices
    covered = [i for sp in p_slices for i in range(sp.start, sp.stop)]
    assert covered == list(range(80))
    jy, js = jssd_kernel(*map(jnp.asarray, ins), chunk=96, interpret=True)
    y, s, calls = _sliced(ins, 96, toy, limit)
    assert len(calls) == slices[0] * slices[1]
    assert {c for *_, c in calls} == {48}
    _hold((y, s), (jy, js))


def test_a_shape_that_fits_is_one_launch():
    assert K.ssd_slices(64, 64, 128, kernel_smem) == (
        [slice(0, 64)], [slice(0, 128)])
    with pytest.raises(ValueError, match="no slice"):
        K.ssd_slices(64, 64, 64, lambda *a: 10 ** 9)
