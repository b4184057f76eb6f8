"""Precisions the reference computes in.

``fp64``: float64 throughout (the reference).  ``tf32``: float32 storage
and arithmetic, and every matrix product taken on operands rounded to TF32
(10 explicit mantissa bits, round to nearest even) with float32
accumulation, as a tensor core computes a TF32 product.  The rounding is
done here, so the control computes the same on the card and on the CPU,
whatever ``torch.backends.cuda.matmul.allow_tf32`` says.
"""

from __future__ import annotations

import torch

PRECS = ("fp64", "tf32")


def dtype(prec: str) -> torch.dtype:
    if prec not in PRECS:
        raise ValueError(f"unknown precision {prec!r}; expected one of {PRECS}")
    return torch.float64 if prec == "fp64" else torch.float32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """``a @ b`` in ``prec``."""
    if prec == "tf32":
        return tf32(a) @ tf32(b)
    return a @ b
