"""Squared-L2 distance matrix: the CUDA kernel (``csrc/l2dist.cu``) and its
plain version (:func:`repro_torch.kernels.ref.l2dist_ref`)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import l2dist_ref as l2dist_plain

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

__all__ = ["l2dist_cuda", "l2dist_plain"]


def l2dist_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M, N) float32 distances between rows of x (M, d) and y (N, d),
    both float32, contiguous, on the card."""
    cuda.check_cuda("l2dist", x, y, dtypes=(torch.float32, torch.float32))
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"l2dist: bad shapes {tuple(x.shape)}, {tuple(y.shape)}")
    m, d = x.shape
    n = y.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    cuda.launch("l2dist", "l2dist_f32", _ARGS, cuda.ptr(x), cuda.ptr(y),
                cuda.ptr(out), m, n, d, cuda.stream(x.device))
    return out
