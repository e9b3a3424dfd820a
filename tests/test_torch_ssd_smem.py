"""The SSD scan kernel's shared memory a block, mirrored from
``src/repro_torch/csrc/ssd_scan.cu`` for the CPU tests of the slice plan
(``test_torch_ssd_slices.py``); a test on the card holds it to the
library's ``repro_ssd_scan_smem`` (``test_torch_gpu.py``).  This module
imports neither JAX nor the reference, so both can use it."""


def kernel_smem(chunk: int, P: int, N: int) -> int:
    """``repro_ssd_scan_smem`` of ``csrc/ssd_scan.cu``: the larger of the
    chunk pass's and the output pass's (one head) shared memory."""
    def up(v):
        return -(-v // 32) * 32

    c, p, n = up(chunk), up(P), up(N)
    ns, ps, cs = n + 4, p + 4, c + 4
    a = c * ns + c * ps + 32 * ns + 3 * c
    out = c * ns + c * cs + 2 * c + (c * ps + p * ns + c)
    return 4 * max(a, out)
