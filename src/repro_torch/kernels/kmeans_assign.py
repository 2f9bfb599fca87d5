"""Fused k-means assignment: the CUDA kernel (``csrc/kmeans_assign.cu``) and
its plain version."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import kmeans_assign_ref

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
MAX_DIM = 128
#: shared memory a block may hold (H100: 227 KB)
MAX_SMEM = 232448


def kmeans_assign_plain(x: torch.Tensor, c: torch.Tensor, chunk: int = 65536):
    """(assignments (n,) int32, min sq dist (n,) f32), in row chunks so the
    (n, k) distance matrix never materializes in full."""
    if x.shape[0] <= chunk:
        return kmeans_assign_ref(x, c)
    parts = [kmeans_assign_ref(x[i:i + chunk], c) for i in range(0, x.shape[0], chunk)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def kmeans_assign_cuda(x: torch.Tensor, c: torch.Tensor):
    """Kernel launch: x (n, d) and c (k, d) float32, contiguous, on the
    card, d <= 128; all k centroids must fit in shared memory."""
    cuda.check_cuda("kmeans_assign", x, c, dtypes=(torch.float32, torch.float32))
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"kmeans_assign: bad shapes {tuple(x.shape)}, {tuple(c.shape)}")
    n, d = x.shape
    k = c.shape[0]
    if not 0 < d <= MAX_DIM or k == 0:
        raise ValueError(f"kmeans_assign: need 0 < d <= {MAX_DIM} and k > 0, got d={d}, k={k}")
    if k * (d + 1) * 4 > MAX_SMEM:
        raise ValueError(f"kmeans_assign: {k} centroids of dim {d} exceed shared memory")
    assign = torch.empty((n,), dtype=torch.int32, device=x.device)
    dmin = torch.empty((n,), dtype=torch.float32, device=x.device)
    cuda.launch("kmeans_assign", "kmeans_assign_f32", _ARGS, cuda.ptr(x),
                cuda.ptr(c), cuda.ptr(assign), cuda.ptr(dmin), n, k, d,
                cuda.stream(x.device))
    return assign, dmin
