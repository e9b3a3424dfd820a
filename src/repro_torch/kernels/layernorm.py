"""LayerNorm forward and backward: the hand-written CUDA kernels
(``csrc/layernorm.cu``), their plain PyTorch versions, and the
``repro_torch::layernorm`` / ``repro_torch::layernorm_bwd`` operators.

The counterparts of ``layernorm_fwd`` and ``_ln_bwd`` (the TPU kernels
``_ln_kernel`` and ``_ln_bwd_kernel``, ``src/repro/kernels/layernorm.py``):
the forward returns ``(y, mean, rstd)`` with the statistics [R, 1]
float32 over the rows R of ``x`` flattened to [R, C]; the backward takes
them back with ``dy`` and returns ``(dx, dgamma, dbeta)``.

``layernorm(x, gamma, beta, eps)`` is the forward operator: on CPU
tensors it runs ``layernorm_plain``, on CUDA tensors ``layernorm_cuda``
(the kernel, or an error), on fake and meta tensors its shape function,
so ``make_fx`` traces it as one node.  Its autograd formula (the
reference's ``custom_vjp``, ``layernorm.py:140-161``) saves x, gamma and
the statistics and calls ``layernorm_bwd``, dispatched the same way.
The gradients arriving for ``mean`` and ``rstd`` are ignored: they are
statistics, not values the reference differentiates.

The kernels take what the reference's take: x (and dy) and the gain
(and bias) each float32 or bfloat16, y and dx in x's type, the
statistics and dgamma, dbeta float32, float32 inside.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

#: The backward's partial rows of dgamma and dbeta: at most this many a
#: SM (its persistent CTAs, each writing one), summed by its second launch
#: (``csrc/layernorm.cu``'s ``kBwdCtasPerSM``; a bfloat16 row's ring at
#: half the bytes lets a second CTA onto an SM where a float32 one did not)
BWD_PARTS_PER_SM = 2
#: Kernel launches of one backward call: the rows, then the partials' sums
BWD_LAUNCHES_PER_CALL = 2


def layernorm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The forward kernel's function in plain PyTorch (the order of
    ``_ln_kernel``: the mean, then the variance of the centred values,
    float32 inside)."""
    C = x.shape[-1]
    xf = x.reshape(-1, C).to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd * gamma.to(torch.float32) + beta.to(torch.float32)
    return y.to(x.dtype).reshape(x.shape), mean, rstd


def layernorm_bwd_plain(x: torch.Tensor, gamma: torch.Tensor,
                        mean: torch.Tensor, rstd: torch.Tensor,
                        dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                                   torch.Tensor]:
    """The backward kernel's function in plain PyTorch (``_ln_bwd``'s
    formula): dx like x, dgamma and dbeta [C] float32."""
    C = x.shape[-1]
    xf = x.reshape(-1, C).to(torch.float32)
    dyf = dy.reshape(-1, C).to(torch.float32)
    xhat = (xf - mean) * rstd
    gdy = dyf * gamma.to(torch.float32)
    m1 = gdy.mean(-1, keepdim=True)
    m2 = (gdy * xhat).mean(-1, keepdim=True)
    dx = rstd * (gdy - m1 - xhat * m2)
    return (dx.to(x.dtype).reshape(x.shape), (dyf * xhat).sum(0),
            dyf.sum(0))


#: The types the kernels take: x's (dy's) and the gain's (the bias's),
#: each on its own.
CUDA_DTYPES = (torch.float32, torch.bfloat16)


def _check(what: str, tensors: dict, C: int) -> None:
    dev = tensors["x"].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors.values()):
        raise ValueError(f"{what}: " + ", ".join(
            f"{k} on {t.device}" for k, t in tensors.items())
            + "; all must lie on one CUDA device")
    x, g = tensors["x"], tensors["gamma"]
    stats = [tensors[k] for k in ("mean", "rstd") if k in tensors]
    if (x.dtype not in CUDA_DTYPES or g.dtype not in CUDA_DTYPES
            or tensors.get("beta", g).dtype != g.dtype
            or tensors.get("dy", x).dtype != x.dtype
            or any(t.dtype != torch.float32 for t in stats)):
        raise TypeError(
            f"{what} takes x (and dy) float32 or bfloat16, gamma (and beta) "
            "float32 or bfloat16, mean and rstd float32; got " + ", ".join(
                f"{k} {t.dtype}" for k, t in tensors.items()))
    for k in ("gamma", "beta"):
        if k in tensors and tensors[k].shape != (C,):
            raise ValueError(f"{what}: {k} {tuple(tensors[k].shape)} for "
                             f"rows of {C}")


def _flags(x: torch.Tensor, gamma: torch.Tensor) -> tuple[int, int]:
    return int(x.dtype == torch.bfloat16), int(gamma.dtype == torch.bfloat16)


def layernorm_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch the forward kernel (on the current stream): y in x's type."""
    C = x.shape[-1]
    _check("layernorm_cuda", {"x": x, "gamma": gamma, "beta": beta}, C)
    # a copy only where the rows are not contiguous (device time)
    x2 = x.reshape(-1, C).contiguous()
    g, b = gamma.contiguous(), beta.contiguous()
    R = x2.shape[0]
    y = torch.empty_like(x2)
    mean = torch.empty(R, 1, dtype=torch.float32, device=x.device)
    rstd = torch.empty(R, 1, dtype=torch.float32, device=x.device)
    _build.check(_entry("repro_layernorm_fwd")(
        x2.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), R, C, float(eps),
        *_flags(x, gamma), torch.cuda.current_stream(x.device).cuda_stream),
        "repro_layernorm_fwd")
    _build.count(layernorm_cuda)
    if torch.bfloat16 in (x.dtype, gamma.dtype):
        _build.count(BF16)
    return y.reshape(x.shape), mean, rstd


layernorm_cuda.launches = 0  # kernel launches (plain runs are not counted)
#: launches of the forward's instances with a bfloat16 x or gain (counted
#: in ``layernorm_cuda.launches`` too)
BF16 = _build.LaunchCount("layernorm_bf16")


def layernorm_bwd_cuda(x: torch.Tensor, gamma: torch.Tensor,
                       mean: torch.Tensor, rstd: torch.Tensor,
                       dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor]:
    """Launch the backward kernel (on the current stream): the rows,
    writing at most ``BWD_PARTS_PER_SM`` dgamma and dbeta partial rows an
    SM into a workspace, then the partials' sums in a fixed order -- two
    launches, no atomics, the same bits every run.  dx in x's type (dy's
    too), dgamma and dbeta float32."""
    C = x.shape[-1]
    _check("layernorm_bwd_cuda", {"x": x, "gamma": gamma, "mean": mean,
                                  "rstd": rstd, "dy": dy}, C)
    x2 = x.reshape(-1, C).contiguous()
    dy2 = dy.reshape(-1, C).contiguous()
    R = x2.shape[0]
    if dy2.shape[0] != R or mean.numel() != R or rstd.numel() != R:
        raise ValueError(f"layernorm_bwd_cuda: x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}, mean {tuple(mean.shape)}, rstd "
                         f"{tuple(rstd.shape)}: want R = {R} rows each")
    parts = BWD_PARTS_PER_SM * torch.cuda.get_device_properties(
        x.device).multi_processor_count
    dx = torch.empty_like(x2)
    f32 = dict(dtype=torch.float32, device=x.device)
    work = torch.empty(2, parts, C, **f32)  # dgamma, dbeta partial rows
    dg, db = torch.empty(C, **f32), torch.empty(C, **f32)
    _build.check(_entry("repro_layernorm_bwd")(
        x2.data_ptr(), gamma.contiguous().data_ptr(),
        mean.contiguous().data_ptr(), rstd.contiguous().data_ptr(),
        dy2.data_ptr(), dx.data_ptr(), work[0].data_ptr(),
        work[1].data_ptr(), dg.data_ptr(), db.data_ptr(), R, C, parts,
        *_flags(x, gamma), torch.cuda.current_stream(x.device).cuda_stream),
        "repro_layernorm_bwd")
    _build.count(layernorm_bwd_cuda, BWD_LAUNCHES_PER_CALL)
    if torch.bfloat16 in (x.dtype, gamma.dtype):
        _build.count(BWD_BF16, BWD_LAUNCHES_PER_CALL)
    return dx.reshape(x.shape), dg, db


layernorm_bwd_cuda.launches = 0  # kernel launches (plain runs excluded)
#: launches of the backward's instances with a bfloat16 x or gain
BWD_BF16 = _build.LaunchCount("layernorm_bwd_bf16")


@functools.cache
def _entry(name: str):
    fn = getattr(_build.library("layernorm"), name)
    if name == "repro_layernorm_fwd":
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@torch.library.custom_op("repro_torch::layernorm", mutates_args=(),
                         device_types="cpu")
def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, rstd): y like x, mean and rstd [R, 1] float32."""
    return layernorm_plain(x, gamma, beta, eps)


@layernorm.register_kernel("cuda")
def _(x, gamma, beta, eps):
    return layernorm_cuda(x, gamma, beta, eps)


@layernorm.register_fake
def _(x, gamma, beta, eps):
    R = x.numel() // x.shape[-1]
    stat = x.new_empty((R, 1), dtype=torch.float32)
    return torch.empty_like(x), stat, stat.clone()


@torch.library.custom_op("repro_torch::layernorm_bwd", mutates_args=(),
                         device_types="cpu")
def layernorm_bwd(x: torch.Tensor, gamma: torch.Tensor, mean: torch.Tensor,
                  rstd: torch.Tensor,
                  dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """(dx, dgamma, dbeta): dx like x, dgamma and dbeta [C] float32."""
    return layernorm_bwd_plain(x, gamma, mean, rstd, dy)


@layernorm_bwd.register_kernel("cuda")
def _(x, gamma, mean, rstd, dy):
    return layernorm_bwd_cuda(x, gamma, mean, rstd, dy)


@layernorm_bwd.register_fake
def _(x, gamma, mean, rstd, dy):
    C = x.shape[-1]
    return (torch.empty_like(x), x.new_empty((C,), dtype=torch.float32),
            x.new_empty((C,), dtype=torch.float32))


def _setup_context(ctx, inputs, output):
    x, gamma, _, _ = inputs
    _, mean, rstd = output
    ctx.save_for_backward(x, gamma, mean, rstd)


def _backward(ctx, dy, _dmean, _drstd):
    x, gamma, mean, rstd = ctx.saved_tensors
    dx, dg, db = layernorm_bwd(x, gamma, mean, rstd, dy)
    return dx, dg.to(gamma.dtype), db.to(gamma.dtype), None


layernorm.register_autograd(_backward, setup_context=_setup_context)
