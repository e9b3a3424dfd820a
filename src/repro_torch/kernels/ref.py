"""Plain PyTorch oracles: the port's counterparts of ``repro.kernels.ref``
for the normalizations and the softmax.

They are the numerical ground truth of the tests and the building blocks
of the plain model code, which ``stitched_jit`` traces and compiles.
"""
from __future__ import annotations

import torch


def layernorm(x, gamma, beta, eps: float = 1e-6):
    xf = x.to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma + beta).to(x.dtype)


def rmsnorm(x, gamma, eps: float = 1e-6):
    xf = x.to(torch.float32)
    ms = (xf ** 2).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * gamma).to(x.dtype)


def softmax(x, dim: int = -1):
    return torch.softmax(x.to(torch.float32), dim).to(x.dtype)
