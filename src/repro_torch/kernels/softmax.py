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
call takes: short rows in 16-byte unit lanes (a float4, or 8 bfloat16:
up to 128 float32 or 256 bfloat16 columns), a warp a row, or a block a
row.  They take what the reference's take: float32 or bfloat16 (one type
a call: y and dy alike, as autograd gives them), y and dx in the input's
type, float32 inside.  The wrappers pass a contiguous 2-D input to the kernel
as it is, with no view or copy.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, widen


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


#: The types the kernels take (one a call; float16 and a mix of y and dy
#: are widened to float32 first, ``widen``).
CUDA_DTYPES = widen.KERNEL_DTYPES


def _check(what: str, tensors: dict) -> None:
    first = next(iter(tensors.values()))
    dev = first.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors.values()):
        raise ValueError(f"{what}: " + ", ".join(
            f"{k} on {t.device}" for k, t in tensors.items())
            + "; all must lie on one CUDA device")
    widen.check(what, tensors)
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
    """Launch the forward kernel (on the current stream): y in x's type
    (a float16 x widened to float32 first)."""
    if not (x.is_cuda and x.dtype in CUDA_DTYPES and x.dim()):
        _check("softmax_cuda", {"x": x})  # raises, naming what is wrong
        return widen.to(softmax_cuda(x.to(torch.float32)), x.dtype)
    x2 = _rows(x)
    y = torch.empty_like(x2)
    bf16 = x.dtype == torch.bfloat16
    _build.check(_entry("repro_softmax_fwd")(
        x2.data_ptr(), y.data_ptr(), x2.shape[0], x2.shape[1], bf16,
        _stream(x)), "repro_softmax_fwd")
    _build.count(softmax_cuda)
    if bf16:
        _build.count(BF16)
    return y if x2 is x else y.reshape(x.shape)


softmax_cuda.launches = 0  # kernel launches (plain runs are not counted)
#: launches of the forward's bfloat16 instances (counted in
#: ``softmax_cuda.launches`` too)
BF16 = _build.LaunchCount("softmax_bf16")


def softmax_bwd_cuda(y: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel (on the current stream): dx in y's
    type (y and dy widened to float32 first where they are float16 or of
    two types)."""
    if not (y.is_cuda and dy.device == y.device and y.dtype in CUDA_DTYPES
            and dy.dtype == y.dtype and y.shape == dy.shape and y.dim()):
        _check("softmax_bwd_cuda", {"y": y, "dy": dy})  # raises
        return widen.to(softmax_bwd_cuda(*widen.one_type(y, dy)), y.dtype)
    y2, dy2 = _rows(y), _rows(dy)
    dx = torch.empty_like(y2)
    bf16 = y.dtype == torch.bfloat16
    _build.check(_entry("repro_softmax_bwd")(
        y2.data_ptr(), dy2.data_ptr(), dx.data_ptr(), y2.shape[0],
        y2.shape[1], bf16, _stream(y)), "repro_softmax_bwd")
    _build.count(softmax_bwd_cuda)
    if bf16:
        _build.count(BWD_BF16)
    return dx if y2 is y else dx.reshape(y.shape)


softmax_bwd_cuda.launches = 0  # kernel launches (plain runs excluded)
#: launches of the backward's bfloat16 instances
BWD_BF16 = _build.LaunchCount("softmax_bwd_bf16")


def layout(*operands: torch.Tensor) -> str:
    """The layout ``csrc/softmax.cu`` takes for these CUDA operands (x, or
    y and dy; the output the wrapper allocates is always aligned):
    ``"float4 lanes L"`` or ``"bf16x8 lanes L"`` (L lanes a row, a 16-byte
    unit each), ``"warp"`` (a warp a row) or ``"block"`` (a block a row).
    A non-contiguous operand is copied by the wrapper, so it counts as
    aligned."""
    ptrs = [t.data_ptr() if t.is_contiguous() else 0 for t in operands]
    bf16 = operands[0].dtype == torch.bfloat16
    lanes = _entry("repro_softmax_lanes")(
        *(ptrs + [0] * (3 - len(ptrs))), operands[0].shape[-1], bf16)
    unit = "bf16x8" if bf16 else "float4"
    return (f"{unit} lanes {lanes}" if lanes > 0
            else "warp" if lanes == 0 else "block")


#: (pointer arguments, int arguments, a stream) of each C entry
_SIGNATURES = {"repro_softmax_fwd": (2, 3, True),
               "repro_softmax_bwd": (3, 3, True),
               "repro_softmax_lanes": (3, 2, False)}


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
