"""Matrix products of the reference in a stated precision.

``"f32"`` is IEEE float32: TF32 off on the card. ``"tf32"`` is the control's
precision, the step below float32 that would tempt a later change: on the card
TF32 tensor-core products (``allow_tf32``), on the CPU the same rounding
emulated, each operand cut to TF32's 10 mantissa bits (as the tensor cores
read float32 inputs) before a float32 product."""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("f32", "tf32")


@contextlib.contextmanager
def _card_tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """float32 values with the low 13 mantissa bits cleared."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """``a @ b`` (batched where the operands are 3-D) in ``prec``."""
    if prec not in PRECISIONS:
        raise ValueError(f"unknown precision {prec!r}")
    tf32 = prec == "tf32"
    if a.is_cuda:
        with _card_tf32(tf32):
            return a @ b
    if tf32:
        return tf32_truncate(a) @ tf32_truncate(b)
    return a @ b


def sq_dists(x: torch.Tensor, y: torch.Tensor, prec: str) -> torch.Tensor:
    """(..., M, N) squared distances ``|x|^2 + |y|^2 - 2 x.y``, clamped at 0."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-1, keepdim=True).mT
    return torch.clamp_min(x2 + y2 - 2.0 * matmul(x, y.mT, prec), 0.0)
