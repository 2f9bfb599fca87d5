"""Squared-L2 distance matrix: the CUDA kernel (``csrc/l2dist.cu``) and its
plain version (:func:`repro_torch.kernels.ref.l2dist_ref`), for one pair of
matrices or for a list of (column slice, centroid set) pairs in one launch."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import l2dist_ref as l2dist_plain

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_PAIRS_ARGS = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
               + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
#: pairs per launch of the batched kernel (2 x the kernels' 16 subspaces)
MAX_PAIRS = 32

__all__ = ["l2dist_cuda", "l2dist_plain", "l2dist_pairs_cuda", "l2dist_pairs_plain"]


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


def _check_pairs(x, slices, y) -> None:
    if x.dim() != 2 or y.dim() != 3 or len(slices) != y.shape[0]:
        raise ValueError(f"l2dist_pairs: x {tuple(x.shape)}, y {tuple(y.shape)}, "
                         f"{len(slices)} pairs disagree")
    for col, dim in slices:
        if col < 0 or dim < 0 or dim > y.shape[2] or col + dim > x.shape[1]:
            raise ValueError(f"l2dist_pairs: slice ({col}, {dim}) outside x "
                             f"{tuple(x.shape)} or y {tuple(y.shape)}")


def l2dist_pairs_plain(x: torch.Tensor, slices, y: torch.Tensor) -> torch.Tensor:
    """(P, M, N) float32: pair p holds the distances between
    ``x[:, col:col + dim]`` and ``y[p, :, :dim]`` for ``slices[p] = (col,
    dim)``; y (P, N, d_max) is zero-padded past each pair's dim. The
    per-pair :func:`l2dist_plain`, stacked."""
    _check_pairs(x, slices, y)
    return torch.stack([l2dist_plain(x[:, col:col + dim], y[p, :, :dim].contiguous())
                        for p, (col, dim) in enumerate(slices)])


def l2dist_pairs_cuda(x: torch.Tensor, slices, y: torch.Tensor) -> torch.Tensor:
    """Kernel launch: :func:`l2dist_pairs_plain`'s result, equal bit for bit
    to one :func:`l2dist_cuda` call per pair. x (M, D) and y (P, N, d_max)
    float32, contiguous, on the card; one launch for up to 32 pairs."""
    cuda.check_cuda("l2dist", x, y, dtypes=(torch.float32, torch.float32))
    _check_pairs(x, slices, y)
    m, ld = x.shape
    n_pairs, n, d_max = y.shape
    out = torch.empty((n_pairs, m, n), dtype=torch.float32, device=x.device)
    for lo in range(0, n_pairs, MAX_PAIRS):
        part = slices[lo:lo + MAX_PAIRS]
        cols = (ctypes.c_int * len(part))(*(int(c) for c, _ in part))
        dims = (ctypes.c_int * len(part))(*(int(d) for _, d in part))
        cuda.launch("l2dist", "l2dist_pairs_f32", _PAIRS_ARGS, cuda.ptr(x), ld, cols, dims,
                    len(part), cuda.ptr(y[lo]), n, d_max, cuda.ptr(out[lo]), m,
                    cuda.stream(x.device))
    return out
