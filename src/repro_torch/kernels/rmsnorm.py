"""RMSNorm forward: the hand-written CUDA kernel (``csrc/rmsnorm.cu``),
its plain PyTorch version, and the ``repro_torch::rmsnorm`` operator.

The counterpart of ``rmsnorm_fwd`` (the TPU kernel ``_rms_kernel``,
``src/repro/kernels/rmsnorm.py:12,20``): ``(y, rstd)`` with ``rstd``
[R, 1] float32 over the rows R of ``x`` flattened to [R, C].  Its autograd
formula is the reference's plain one (``src/repro/kernels/rmsnorm.py:57-74``):
the JAX package has no RMSNorm backward kernel, so none is ported.

``rmsnorm(x, gamma, eps)`` is the operator: on CPU tensors it runs
``rmsnorm_plain``, on CUDA tensors ``rmsnorm_cuda`` (the kernel, or an
error), on fake and meta tensors its shape function -- so ``make_fx``
traces it as one node, which the port's tracer keeps as one ``OPAQUE``
node (the counterpart of the reference's opaque ``pallas_call``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, widen


def rmsnorm_plain(x: torch.Tensor, gamma: torch.Tensor,
                  eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (the order of ``_rms_kernel``:
    x * rstd * g, float32 inside)."""
    C = x.shape[-1]
    xf = x.reshape(-1, C).to(torch.float32)
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    y = (xf * rstd * gamma.to(torch.float32)).to(x.dtype)
    return y.reshape(x.shape), rstd


#: The types the kernel takes for x and for gamma, each on its own
#: (float16 is widened to float32 first, ``widen``).
CUDA_DTYPES = widen.KERNEL_DTYPES


def rmsnorm_cuda(x: torch.Tensor, gamma: torch.Tensor,
                 eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel (on the current stream): x and gamma each
    float32 or bfloat16 (a float16 one widened to float32 first), y in
    x's type, float32 inside."""
    if x.device.type != "cuda" or gamma.device != x.device:
        raise ValueError(f"rmsnorm_cuda: x on {x.device}, gamma on "
                         f"{gamma.device}; both must lie on one CUDA device")
    widen.check("rmsnorm_cuda", {"x": x, "gamma": gamma})
    C = x.shape[-1]
    if gamma.shape != (C,):
        raise ValueError(f"gamma {tuple(gamma.shape)} for rows of {C}")
    # a copy only where the rows are not contiguous (device time)
    x2 = widen.own(x).reshape(-1, C).contiguous()
    g = widen.own(gamma).contiguous()
    R = x2.shape[0]
    y = torch.empty_like(x2)
    rstd = torch.empty(R, 1, dtype=torch.float32, device=x.device)
    fn = _entry()
    _build.check(fn(x2.data_ptr(), g.data_ptr(), y.data_ptr(),
                    rstd.data_ptr(), R, C, float(eps),
                    int(x2.dtype == torch.bfloat16),
                    int(g.dtype == torch.bfloat16),
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "repro_rmsnorm")
    _build.count(rmsnorm_cuda)
    if torch.bfloat16 in (x2.dtype, g.dtype):
        _build.count(BF16)
    return widen.to(y, x.dtype).reshape(x.shape), rstd


rmsnorm_cuda.launches = 0  # kernel launches (plain runs are not counted)
#: launches of the instances with a bfloat16 x or gain (counted in
#: ``rmsnorm_cuda.launches`` too)
BF16 = _build.LaunchCount("rmsnorm_bf16")


@functools.cache
def _entry():
    fn = _build.library("rmsnorm").repro_rmsnorm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=(),
                         device_types="cpu")
def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, rstd): y like x, rstd [R, 1] float32."""
    return rmsnorm_plain(x, gamma, eps)


@rmsnorm.register_kernel("cuda")
def _(x, gamma, eps):
    return rmsnorm_cuda(x, gamma, eps)


@rmsnorm.register_fake
def _(x, gamma, eps):
    R = x.numel() // x.shape[-1]
    return torch.empty_like(x), x.new_empty((R, 1), dtype=torch.float32)


def rmsnorm_bwd_plain(x, gamma, rstd, dy):
    """The reference's backward (``rmsnorm.py:62-74``) in plain PyTorch:
    dx like x, dgamma [C] float32."""
    C = x.shape[-1]
    xf = x.reshape(-1, C).to(torch.float32)
    dyf = dy.reshape(-1, C).to(torch.float32)
    xhat = xf * rstd
    gdy = dyf * gamma.to(torch.float32)
    m = (gdy * xhat).mean(-1, keepdim=True)
    dx = rstd * (gdy - xhat * m)
    return dx.reshape(x.shape).to(x.dtype), (dyf * xhat).sum(0)


def _setup_context(ctx, inputs, output):
    x, gamma, _ = inputs
    ctx.save_for_backward(x, gamma, output[1])


def _backward(ctx, dy, _drstd):
    x, gamma, rstd = ctx.saved_tensors
    dx, dg = rmsnorm_bwd_plain(x, gamma, rstd, dy)
    return dx, dg.to(gamma.dtype), None


rmsnorm.register_autograd(_backward, setup_context=_setup_context)
