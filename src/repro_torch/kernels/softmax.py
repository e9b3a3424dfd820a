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


def softmax_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel (float32, on the current stream)."""
    _check("softmax_cuda", {"x": x})
    C = x.shape[-1]
    # a copy only where the rows are not contiguous (device time)
    x2 = x.reshape(-1, C).contiguous()
    y = torch.empty_like(x2)
    _build.check(_entry("repro_softmax_fwd_f32")(
        x2.data_ptr(), y.data_ptr(), x2.shape[0], C,
        torch.cuda.current_stream(x.device).cuda_stream),
        "repro_softmax_fwd_f32")
    softmax_cuda.launches += 1
    return y.reshape(x.shape)


softmax_cuda.launches = 0  # kernel launches (plain runs are not counted)


def softmax_bwd_cuda(y: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel (float32, on the current stream)."""
    _check("softmax_bwd_cuda", {"y": y, "dy": dy})
    C = y.shape[-1]
    y2 = y.reshape(-1, C).contiguous()
    dy2 = dy.reshape(-1, C).contiguous()
    dx = torch.empty_like(y2)
    _build.check(_entry("repro_softmax_bwd_f32")(
        y2.data_ptr(), dy2.data_ptr(), dx.data_ptr(), y2.shape[0], C,
        torch.cuda.current_stream(y.device).cuda_stream),
        "repro_softmax_bwd_f32")
    softmax_bwd_cuda.launches += 1
    return dx.reshape(y.shape)


softmax_bwd_cuda.launches = 0  # kernel launches (plain runs excluded)


@functools.cache
def _entry(name: str):
    fn = getattr(_build.library("softmax"), name)
    n_ptr = 2 if name == "repro_softmax_fwd_f32" else 3
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
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
