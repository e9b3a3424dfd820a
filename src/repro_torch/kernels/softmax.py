"""Row softmax forward and backward: the hand-written CUDA kernels
(``csrc/softmax.cu``), their plain PyTorch versions, and the
``repro_torch::softmax`` / ``repro_torch::softmax_bwd`` operators.

The counterparts of ``softmax_fwd`` and ``softmax_bwd`` (the TPU kernels
``_softmax_kernel`` and ``_softmax_bwd_kernel``,
``src/repro/kernels/softmax.py``): the softmax over the last axis of
``x``, and ``y * (dy - sum(dy * y))`` per row, over the rows R of the
input flattened to [R, C].

``softmax(x)`` is the forward operator: on CPU tensors it runs
``softmax_plain``, on CUDA tensors ``softmax_cuda`` (the kernel, or an
error), on fake and meta tensors its shape function, so ``make_fx``
traces it as one node.  Its autograd formula (the reference's
``custom_vjp``, ``softmax.py:75-90``) saves y and calls ``softmax_bwd``,
dispatched the same way.

Both kernels launch as programmatic dependents of the work before them
on the stream (``csrc/softmax.cu``), and ``layout`` names the layout a
call takes: rows of up to 128 columns in float4 lanes, a warp a row, or
a block a row.  The wrappers pass a contiguous 2-D input to the kernel
as it is, with no view or copy.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build


def softmax_plain(x: torch.Tensor) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch, step by step as
    ``_softmax_kernel`` computes it: max, exp, sum, divide (float32)."""
    C = x.shape[-1]
    xf = x.reshape(-1, C).to(torch.float32)
    m = xf.amax(-1, keepdim=True)
    e = torch.exp(xf - m)
    s = e.sum(-1, keepdim=True)
    return (e / s).to(x.dtype).reshape(x.shape)


def softmax_bwd_plain(y: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The backward kernel's function in plain PyTorch
    (``_softmax_bwd_kernel``): y * (dy - sum(dy * y)), float32 inside."""
    C = y.shape[-1]
    yf = y.reshape(-1, C).to(torch.float32)
    dyf = dy.reshape(-1, C).to(torch.float32)
    s = (dyf * yf).sum(-1, keepdim=True)
    return (yf * (dyf - s)).to(y.dtype).reshape(y.shape)


def _check(what: str, tensors: dict) -> None:
    first = next(iter(tensors.values()))
    dev = first.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors.values()):
        raise ValueError(f"{what}: " + ", ".join(
            f"{k} on {t.device}" for k, t in tensors.items())
            + "; all must lie on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors.values()):
        raise TypeError(f"{what} takes float32, got " + ", ".join(
            f"{k} {t.dtype}" for k, t in tensors.items()))
    if any(t.shape != first.shape for t in tensors.values()):
        raise ValueError(f"{what}: " + ", ".join(
            f"{k} {tuple(t.shape)}" for k, t in tensors.items())
            + "; want one shape")
    if first.dim() == 0:
        raise ValueError(f"{what}: a 0-d tensor has no rows")


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous rows [R, C]: ``t`` itself where it is a
    contiguous 2-D tensor (no view, no copy), else a reshape, copied only
    where the rows are not contiguous (device time)."""
    if t.dim() == 2 and t.is_contiguous():
        return t
    return t.reshape(-1, t.shape[-1]).contiguous()


def _stream(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device as the raw ``cudaStream_t``
    (no ``torch.cuda.Stream`` object is made)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def softmax_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel (float32, on the current stream)."""
    if not (x.is_cuda and x.dtype == torch.float32 and x.dim()):
        _check("softmax_cuda", {"x": x})  # raises, naming what is wrong
    x2 = _rows(x)
    y = torch.empty_like(x2)
    _build.check(_entry("repro_softmax_fwd_f32")(
        x2.data_ptr(), y.data_ptr(), x2.shape[0], x2.shape[1], _stream(x)),
        "repro_softmax_fwd_f32")
    _build.count(softmax_cuda)
    return y if x2 is x else y.reshape(x.shape)


softmax_cuda.launches = 0  # kernel launches (plain runs are not counted)


def softmax_bwd_cuda(y: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel (float32, on the current stream)."""
    if not (y.is_cuda and dy.device == y.device and y.dtype == torch.float32
            and dy.dtype == torch.float32 and y.shape == dy.shape
            and y.dim()):
        _check("softmax_bwd_cuda", {"y": y, "dy": dy})  # raises
    y2, dy2 = _rows(y), _rows(dy)
    dx = torch.empty_like(y2)
    _build.check(_entry("repro_softmax_bwd_f32")(
        y2.data_ptr(), dy2.data_ptr(), dx.data_ptr(), y2.shape[0],
        y2.shape[1], _stream(y)), "repro_softmax_bwd_f32")
    _build.count(softmax_bwd_cuda)
    return dx if y2 is y else dx.reshape(y.shape)


softmax_bwd_cuda.launches = 0  # kernel launches (plain runs excluded)


def layout(*operands: torch.Tensor) -> str:
    """The layout ``csrc/softmax.cu`` takes for these CUDA operands (x, or
    y and dy; the output the wrapper allocates is always aligned):
    ``"float4 lanes L"`` (L lanes a row, a float4 each), ``"warp"`` (a
    warp a row) or ``"block"`` (a block a row).  A non-contiguous operand
    is copied by the wrapper, so it counts as aligned."""
    ptrs = [t.data_ptr() if t.is_contiguous() else 0 for t in operands]
    lanes = _entry("repro_softmax_lanes")(
        *(ptrs + [0] * (3 - len(ptrs))), operands[0].shape[-1])
    return (f"float4 lanes {lanes}" if lanes > 0
            else "warp" if lanes == 0 else "block")


#: (pointer arguments, int arguments, a stream) of each C entry
_SIGNATURES = {"repro_softmax_fwd_f32": (2, 2, True),
               "repro_softmax_bwd_f32": (3, 2, True),
               "repro_softmax_lanes": (3, 1, False)}


@functools.cache
def _entry(name: str):
    """The C entry ``name`` of ``csrc/softmax.cu``, its argument types set
    (built and loaded on first use; the same object on every call)."""
    fn = getattr(_build.library("softmax"), name)
    n_ptr, n_int, stream = _SIGNATURES[name]
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p] * stream)
    fn.restype = ctypes.c_int
    return fn


@torch.library.custom_op("repro_torch::softmax", mutates_args=(),
                         device_types="cpu")
def softmax(x: torch.Tensor) -> torch.Tensor:
    """The softmax over the last axis, like x."""
    return softmax_plain(x)


@softmax.register_kernel("cuda")
def _(x):
    return softmax_cuda(x)


@softmax.register_fake
def _(x):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::softmax_bwd", mutates_args=(),
                         device_types="cpu")
def softmax_bwd(y: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dx like y, from the softmax's output y and its gradient dy."""
    return softmax_bwd_plain(y, dy)


@softmax_bwd.register_kernel("cuda")
def _(y, dy):
    return softmax_bwd_cuda(y, dy)


@softmax_bwd.register_fake
def _(y, dy):
    return torch.empty_like(y)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(output)


def _backward(ctx, dy):
    (y,) = ctx.saved_tensors
    return softmax_bwd(y, dy)


softmax.register_autograd(_backward, setup_context=_setup_context)
