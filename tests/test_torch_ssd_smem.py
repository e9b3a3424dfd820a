"""The SSD scan kernel's shared memory a block, mirrored from
``src/repro_torch/csrc/ssd_scan.cu`` for the CPU tests of the slice plan
(``test_torch_ssd_slices.py``); a test on the card holds it to the
library's ``repro_ssd_scan_smem`` (``test_torch_gpu.py``).  This module
imports neither JAX nor the reference, so both can use it."""


def kernel_smem(chunk: int, P: int, N: int, xb: int = 4,
                bcb: int = 4) -> int:
    """``repro_ssd_scan_smem`` of ``csrc/ssd_scan.cu``: the larger of the
    chunk pass's and the output pass's (one head) shared memory, with x,
    and B and C, of ``xb`` and ``bcb`` bytes a value (4 float32, 2
    bfloat16; their tiles' rows padded by 16 bytes)."""
    def up(v):
        return -(-v // 32) * 32

    c, p, n = up(chunk), up(P), up(N)
    nb, px = n + 16 // bcb, p + 16 // xb
    ns, cs = n + 4, c + 4
    a = bcb * (c * nb + 32 * nb) + xb * c * px + 4 * 3 * c
    out = bcb * c * nb + 4 * (c * cs + 2 * c) + (xb * c * px
                                                 + 4 * (p * ns + c))
    return max(a, out)
