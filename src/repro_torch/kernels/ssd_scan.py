"""Mamba-2 SSD chunked scan: the hand-written CUDA kernel
(``csrc/ssd_scan.cu``), its plain PyTorch version, and the
``repro_torch::ssd_scan`` operator.

The counterpart of ``ssd_scan`` (the TPU kernel ``_ssd_kernel``,
``src/repro/kernels/ssd_scan.py:25,75``): x [b, L, H, P], dt [b, L, H],
A [H], B and C [b, L, N] (one group, shared by the heads) -> (y
[b, L, H, P] like x, final state [b, H, P, N] float32), the state carried
from chunk to chunk of ``chunk`` rows.  As the reference's, the kernel
takes x, and B and C, float32 or bfloat16 (dt and A float32), float32
inside, y rounded once to x's type.  ``L`` must be a multiple of
``chunk``; the model pads the sequence first.  The kernel takes three
launches a slice (``LAUNCHES_PER_CALL``): every (batch, chunk, head) at
once, the chunk's own state contribution (and C B^T once per (batch,
chunk)); the state passed along the chunks; every (batch, chunk, head)
at once again, the chunk's output from the state entering it
(``split_float.ssd_chunked`` is that decomposition in plain PyTorch).

The scan takes any chunk and any P and N, as the reference does
(``ssd_scan_sliced``): the function does not depend on the chunk length,
so a chunk above ``MAX_CHUNK`` runs at its largest divisor up to it
(``kernel_chunk``); and where one block's tiles would pass the card's
shared memory, the work is cut into the fewest slices that fit
(``ssd_slices``), each the same kernel's launches -- over P, since y and
the state's rows of head dim p depend on x's column p alone, and over N,
since both C B^T and C h^T sum over N: y is the sum of the N-slices' y
(added on the device), and the state's columns split with B and C.

Its autograd formula recomputes ``ref.ssd_scan`` and takes its VJP, as
the reference's ``_ssd_bwd`` does (``src/repro/kernels/ops.py:99-116``):
the JAX package has no backward kernel for the scan, so the backward is
plain ops on the card by the reference's own design.

``ssd_scan(x, dt, A, B, C, chunk)`` is the operator: on CPU tensors it
runs ``ssd_scan_plain``, on CUDA tensors ``ssd_scan_cuda`` (the kernel,
or an error), on fake and meta tensors its shape function -- so
``make_fx`` traces it as one node.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build, ref, widen

def _check_shapes(x, dt, A, B, C, chunk: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, want [b, L, H, P]")
    b, L, H, P = x.shape
    N = B.shape[-1] if B.dim() == 3 else -1
    if (tuple(dt.shape) != (b, L, H) or tuple(A.shape) != (H,)
            or tuple(B.shape) != (b, L, N) or tuple(C.shape) != (b, L, N)):
        raise ValueError(
            f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}; want "
            "[b, L, H, P], [b, L, H], [H], [b, L, N], [b, L, N]")
    if chunk < 1 or L == 0 or L % chunk:
        raise ValueError(f"ssd_scan: L {L} is not a positive multiple of "
                         f"the chunk {chunk}; pad the sequence first")


def ssd_scan_plain(x, dt, A, B, C, chunk: int):
    """The kernel's function in plain PyTorch: the chunk loop as
    ``_ssd_kernel`` computes it, all (batch, head) pairs at once, the
    state [b, H, P, N] carried from chunk to chunk (float32 inside)."""
    _check_shapes(x, dt, A, B, C, chunk)
    b, L, H, P = x.shape
    N = B.shape[-1]
    f32 = torch.float32
    Af = A.to(f32)
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()[:, :, None]
    h = torch.zeros(b, H, P, N, dtype=f32, device=x.device)
    ys = []
    for l0 in range(0, L, chunk):
        rows = slice(l0, l0 + chunk)
        xz = x[:, rows].to(f32)                             # [b, c, H, P]
        dtz = dt[:, rows].to(f32)                           # [b, c, H]
        Bz = B[:, rows].to(f32)                             # [b, c, N]
        Cz = C[:, rows].to(f32)
        cum = torch.cumsum(dtz * Af, dim=1)                 # [b, c, H]
        seg = cum[:, :, None, :] - cum[:, None, :, :]       # [b, c, c, H]
        lmat = torch.exp(torch.where(causal, seg, -math.inf))
        cb = torch.bmm(Cz, Bz.transpose(1, 2))              # [b, c, c]
        w = cb[..., None] * lmat * dtz[:, None, :, :]       # w[b, i, j, h]
        y_intra = torch.einsum("bijh,bjhp->bihp", w, xz)
        c_scaled = Cz[:, :, None, :] * torch.exp(cum)[..., None]
        y_inter = torch.einsum("bihn,bhpn->bihp", c_scaled, h)
        ys.append(y_intra + y_inter)
        decay = torch.exp(cum[:, -1:, :] - cum)             # [b, c, H]
        bw = Bz[:, :, None, :] * (decay * dtz)[..., None]   # [b, c, H, N]
        h = h * torch.exp(cum[:, -1, :])[..., None, None] \
            + torch.einsum("bjhp,bjhn->bhpn", xz, bw)
    return torch.cat(ys, dim=1).to(x.dtype), h


#: The longest chunk one launch takes (its cumulative sum: two rows a
#: lane); a longer chunk runs at its largest divisor up to this
MAX_CHUNK = 64
#: Shared memory one block may use on the card (H100: 227 KB)
SMEM_LIMIT = 232448
#: The kernel's tile: P and N are zero-padded to multiples of it, and a
#: slice of either is a multiple of it
SLICE_TILE = 32


#: Kernel launches of one slice: the chunk, state and output passes
LAUNCHES_PER_CALL = 3


def kernel_chunk(chunk: int) -> int:
    """The chunk a launch runs for a scan of ``chunk``: its largest divisor
    up to ``MAX_CHUNK`` (a chunk of 128 is two of 64, the state passed
    between them; L stays a multiple of it)."""
    return max(d for d in range(1, min(chunk, MAX_CHUNK) + 1)
               if chunk % d == 0)


def _extents(n: int) -> list[int]:
    """Slice extents to try along an axis of ``n``: n, then each multiple
    of ``SLICE_TILE`` below it, largest first."""
    return [n] + list(range(SLICE_TILE * ((n - 1) // SLICE_TILE), 0,
                            -SLICE_TILE))


def ssd_slices(chunk: int, P: int, N: int, smem,
               limit: int = SMEM_LIMIT) -> tuple[list[slice], list[slice]]:
    """(P slices, N slices) of a scan: the fewest launches whose blocks
    each fit ``limit`` bytes of shared memory, ``smem(chunk, p, n)`` the
    bytes a launch at head dim p and state n needs; among as few, the
    fewest N-slices (their y are summed).  One slice each where the whole
    fits."""
    if smem(chunk, P, N) <= limit:
        return [slice(0, P)], [slice(0, N)]
    best = None
    for ep in _extents(P):
        for en in _extents(N):
            n_p, n_n = -(-P // ep), -(-N // en)
            if (best is not None and (n_p * n_n, n_n) >= best[0]) \
                    or smem(chunk, ep, en) > limit:
                continue
            best = ((n_p * n_n, n_n), ep, en)
    if best is None:
        raise ValueError(f"ssd_scan: no slice of P {P}, N {N} fits "
                         f"{limit} bytes at chunk {chunk}")
    _, ep, en = best
    return ([slice(i, min(P, i + ep)) for i in range(0, P, ep)],
            [slice(i, min(N, i + en)) for i in range(0, N, en)])


def ssd_scan_sliced(x, dt, A, B, C, chunk: int, scan, smem,
                    limit: int = SMEM_LIMIT):
    """(y, state) of the scan at ``chunk``, computed by ``scan(x, dt, A, B,
    C, c)`` calls at ``c = kernel_chunk(chunk)``, one a (P slice, N slice)
    of ``ssd_slices``: x's columns and the state's rows by P slice, B's
    and C's columns and the state's columns by N slice, y the sum of its
    N slices' y in slice order."""
    c = kernel_chunk(chunk)
    b, L, H, P = x.shape
    N = B.shape[-1]
    p_slices, n_slices = ssd_slices(c, P, N, smem, limit)
    if len(p_slices) == len(n_slices) == 1:
        return scan(x, dt, A, B, C, c)
    ys = []
    state = torch.empty(b, H, P, N, dtype=torch.float32, device=x.device)
    for sp in p_slices:
        y = None
        for sn in n_slices:
            yi, si = scan(x[..., sp], dt, A, B[..., sn], C[..., sn], c)
            state[:, :, sp, sn] = si
            y = yi if y is None else y.add_(yi)
        ys.append(y)
    return (ys[0] if len(ys) == 1 else torch.cat(ys, dim=-1)), state


#: The types the kernel takes for x and for B and C (B and C of one type,
#: x's their own); dt and A are float32, as the model passes them.
#: float16, B and C of two types, and dt or A of another type are widened
#: to float32 first (``widen``).
CUDA_DTYPES = widen.KERNEL_DTYPES


def _check_types(x, dt, A, B, C) -> None:
    widen.check("ssd_scan_cuda", {"x": x, "dt": dt, "A": A, "B": B,
                                  "C": C})


def ssd_scan_cuda(x, dt, A, B, C, chunk: int):
    """Run the CUDA kernel (on the current stream) at any chunk, head dim
    P and state N (``ssd_scan_sliced``: three launches a slice): x, and B
    and C, float32 or bfloat16, dt and A float32 (float16 and the mixes
    the instances do not take widened to float32 first); y in x's type,
    the state float32.  x, dt, B and C are read with their strides -- the model's x,
    B and C are column slices of one activation -- and only a last
    dimension that is not contiguous is copied (device time).  Where the
    N slices of a bfloat16 scan are summed, each slice writes y in
    float32 and the sum is rounded once."""
    _check_shapes(x, dt, A, B, C, chunk)
    dev = x.device
    ts = {"x": x, "dt": dt, "A": A, "B": B, "C": C}
    if dev.type != "cuda" or any(t.device != dev for t in ts.values()):
        raise ValueError("ssd_scan_cuda: " + ", ".join(
            f"{k} on {t.device}" for k, t in ts.items())
            + "; all must lie on one CUDA device")
    _check_types(x, dt, A, B, C)
    out_dtype = x.dtype
    x = widen.own(x)
    B, C = widen.one_type(B, C)
    dt, A = dt.to(torch.float32), A.to(torch.float32)
    x, B, C = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, B, C))
    smem = _smem(x.dtype == torch.bfloat16, B.dtype == torch.bfloat16)
    _, n_slices = ssd_slices(kernel_chunk(chunk), x.shape[-1], B.shape[-1],
                             smem)
    if len(n_slices) > 1 and x.dtype != torch.float32:
        y, state = ssd_scan_sliced(x, dt, A.contiguous(), B, C, chunk,
                                   functools.partial(_launch, y_f32=True),
                                   smem)
        return y.to(out_dtype), state
    y, state = ssd_scan_sliced(x, dt, A.contiguous(), B, C, chunk, _launch,
                               smem)
    return widen.to(y, out_dtype), state


def _launch(x, dt, A, B, C, chunk: int, y_f32: bool = False):
    """The kernel's three launches on one slice (chunk <= ``MAX_CHUNK``,
    tiles within ``SMEM_LIMIT``): y in x's type, or float32 if
    ``y_f32``."""
    b, L, H, P = x.shape
    N = B.shape[-1]
    dev = x.device
    y = torch.empty(b, L, H, P, device=dev,
                    dtype=torch.float32 if y_f32 else x.dtype)
    state = torch.empty(b, H, P, N, dtype=torch.float32, device=dev)
    # scratch: each chunk's own state contribution and total decay, and
    # C B^T of each (batch, chunk) at the kernel's padded chunk
    nc, cp = L // chunk, _chunk_pad()(chunk)
    f32 = dict(dtype=torch.float32, device=dev)
    S = torch.empty(b, nc, H, P, N, **f32)
    cl = torch.empty(b, nc, H, **f32)
    CB = torch.empty(b, nc, cp, cp, **f32)
    x_bf16 = x.dtype == torch.bfloat16
    bc_bf16 = B.dtype == torch.bfloat16
    _build.check(_entry()(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), state.data_ptr(), S.data_ptr(),
        cl.data_ptr(), CB.data_ptr(), b, L, H, P, N, chunk,
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2],
        int(x_bf16), int(bc_bf16), int(y_f32),
        torch.cuda.current_stream(dev).cuda_stream), "repro_ssd_scan")
    _build.count(ssd_scan_cuda, LAUNCHES_PER_CALL)
    if x_bf16 or bc_bf16:
        _build.count(BF16, LAUNCHES_PER_CALL)
    return y, state


ssd_scan_cuda.launches = 0  # kernel launches (plain runs are not counted)
#: launches of the instances with a bfloat16 x, or B and C (counted in
#: ``ssd_scan_cuda.launches`` too)
BF16 = _build.LaunchCount("ssd_scan_bf16")


@functools.cache
def _lib():
    return _build.library("ssd_scan")


@functools.cache
def _smem(x_bf16: bool = False, bc_bf16: bool = False):
    """``smem(chunk, P, N)``: the shared memory a block of the kernel needs
    with x, and B and C, of these types (float32 unless said)."""
    fn = _lib().repro_ssd_scan_smem
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    xb, bcb = 2 if x_bf16 else 4, 2 if bc_bf16 else 4
    return lambda chunk, P, N: fn(chunk, P, N, xb, bcb)


@functools.cache
def _chunk_pad():
    fn = _lib().repro_ssd_scan_chunk_pad
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _entry():
    fn = _lib().repro_ssd_scan
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 10 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(),
                         device_types="cpu")
def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor,
             chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(y [b, L, H, P] like x, state [b, H, P, N] float32)."""
    return ssd_scan_plain(x, dt, A, B, C, chunk)


@ssd_scan.register_kernel("cuda")
def _(x, dt, A, B, C, chunk):
    return ssd_scan_cuda(x, dt, A, B, C, chunk)


@ssd_scan.register_fake
def _(x, dt, A, B, C, chunk):
    _check_shapes(x, dt, A, B, C, chunk)
    b, L, H, P = x.shape
    return (x.new_empty(x.shape),
            x.new_empty((b, H, P, B.shape[-1]), dtype=torch.float32))


def _setup_context(ctx, inputs, output):
    *tensors, chunk = inputs
    ctx.save_for_backward(*tensors)
    ctx.chunk = chunk


def _backward(ctx, dy, dstate):
    ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
    with torch.enable_grad():
        outs = ref.ssd_scan(*ins, chunk=ctx.chunk)
        pairs = [(o, g) for o, g in zip(outs, (dy, dstate)) if g is not None]
        grads = torch.autograd.grad([o for o, _ in pairs],
                                    ins, [g for _, g in pairs],
                                    allow_unused=True)
    return (*grads, None)


ssd_scan.register_autograd(_backward, setup_context=_setup_context)
