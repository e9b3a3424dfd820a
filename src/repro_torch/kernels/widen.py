"""Operand types that the hand-written kernels have no instance for.

The reference's kernels widen every operand to float32 inside the kernel
and store each output in its ref's type
(``src/repro/kernels/flash_attention.py:46-48``, ``rmsnorm.py:13-16``,
``layernorm.py:23-31, 79-87``, ``softmax.py:15-19, 46-47``), so they take
float16 and any mix of float16, bfloat16 and float32.  The port's kernels
have float32 and bfloat16 instances.  A wrapper hands an operand of
another type (float16), or a mix that its instances do not take, to
float32 first -- a copy in front of the same hand-written kernel, not a
plain path (float16 -> float32 is exact) -- and stores the output in the
reference's type.  float64 stays refused: the reference runs without x64.
"""
from __future__ import annotations

import torch

#: The types the hand-written kernels have instances for.
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: The types the wrappers take: the kernels' own, and float16 widened.
TAKEN_DTYPES = KERNEL_DTYPES + (torch.float16,)


def check(what: str, tensors: dict) -> None:
    """Raise ``TypeError`` unless every tensor is float32, bfloat16 or
    float16."""
    if any(t.dtype not in TAKEN_DTYPES for t in tensors.values()):
        raise TypeError(f"{what} takes float32, bfloat16 or float16 "
                        "(float16 and mixes widened to float32), got "
                        + ", ".join(f"{k} {t.dtype}"
                                    for k, t in tensors.items()))


def own(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the kernels take its type on its own, else in float32."""
    return t if t.dtype in KERNEL_DTYPES else t.to(torch.float32)


def one_type(*ts: torch.Tensor) -> tuple:
    """The tensors as they are where they share a type the kernels take,
    else each in float32 (the instances take no mix)."""
    if len({t.dtype for t in ts}) == 1 and ts[0].dtype in KERNEL_DTYPES:
        return ts
    return tuple(t.to(torch.float32) for t in ts)


def to(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype`` (itself where it is in it already): an output
    stored in the reference's type."""
    return t if t.dtype == dtype else t.to(dtype)
