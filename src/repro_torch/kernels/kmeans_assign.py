"""Fused k-means assignment: the CUDA kernel (``csrc/kmeans_assign.cu``) and
its plain version, for one (points, centroids) pair or for P independent
pairs zero-padded to one width in one launch.

Centroids that fit in one block's shared memory with their norms
(k (w + 1) floats within :data:`MAX_SMEM`) are staged once a block; past
that (IVF's 1024 lists of 128 dims) the kernel stages them in tiles and
carries each point's running minimum across the tiles, bit for bit the same
answer. :func:`tiled` says which way a shape goes."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import kmeans_assign_ref

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_PAIRS_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
MAX_DIM = 128
#: shared memory a block may hold (H100: 227 KB)
MAX_SMEM = 232448
#: pairs a launch takes (the grid's y extent)
MAX_PAIRS = 65535


def kmeans_assign_plain(x: torch.Tensor, c: torch.Tensor, chunk: int = 65536):
    """(assignments (n,) int32, min sq dist (n,) f32), in row chunks so the
    (n, k) distance matrix never materializes in full."""
    if x.shape[0] <= chunk:
        return kmeans_assign_ref(x, c)
    parts = [kmeans_assign_ref(x[i:i + chunk], c) for i in range(0, x.shape[0], chunk)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def tiled(k: int, w: int) -> bool:
    """Whether k centroids of width w go through the tiled kernel: their
    k (w + 1) floats do not fit in one block's shared memory."""
    return k * (w + 1) * 4 > MAX_SMEM


def _check(x: torch.Tensor, c: torch.Tensor, name: str = "kmeans_assign") -> None:
    """The limits both entries share: 0 < width <= 128 and k > 0."""
    w, k = x.shape[-1], c.shape[-2]
    if not 0 < w <= MAX_DIM or k == 0:
        raise ValueError(f"{name}: need 0 < d <= {MAX_DIM} and k > 0, got d={w}, k={k}")


def kmeans_assign_cuda(x: torch.Tensor, c: torch.Tensor):
    """Kernel launch: x (n, d) and c (k, d) float32, contiguous, on the
    card, d <= 128, any k. The batched kernel with one pair."""
    cuda.check_cuda("kmeans_assign", x, c, dtypes=(torch.float32, torch.float32))
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"kmeans_assign: bad shapes {tuple(x.shape)}, {tuple(c.shape)}")
    _check(x, c)
    n, d = x.shape
    assign = torch.empty((n,), dtype=torch.int32, device=x.device)
    dmin = torch.empty((n,), dtype=torch.float32, device=x.device)
    cuda.launch("kmeans_assign", "kmeans_assign_f32", _ARGS, cuda.ptr(x),
                cuda.ptr(c), cuda.ptr(assign), cuda.ptr(dmin), n, c.shape[0], d,
                cuda.stream(x.device))
    return assign, dmin


def _check_pairs(xs: torch.Tensor, cs: torch.Tensor, dims) -> list[int]:
    if xs.dim() != 3 or cs.dim() != 3 or xs.shape[0] != cs.shape[0] \
            or xs.shape[2] != cs.shape[2]:
        raise ValueError(f"kmeans_assign_pairs: bad shapes {tuple(xs.shape)}, "
                         f"{tuple(cs.shape)}")
    w = xs.shape[2]
    dims = [w] * xs.shape[0] if dims is None else [int(d) for d in dims]
    if len(dims) != xs.shape[0] or any(not 0 < d <= w for d in dims):
        raise ValueError(f"kmeans_assign_pairs: widths {dims} do not fit "
                         f"{xs.shape[0]} pairs of width {w}")
    return dims


def kmeans_assign_pairs_plain(xs: torch.Tensor, cs: torch.Tensor, dims=None):
    """(assignments (P, n) int32, min sq dists (P, n) f32) for P pairs
    zero-padded to one width: pair p is ``xs[p, :, :dims[p]]`` against
    ``cs[p, :, :dims[p]]`` (``dims`` defaults to the full width).

    Each pair goes through :func:`kmeans_assign_plain` at its own width,
    since a product over zero-padded columns may sum in another order."""
    dims = _check_pairs(xs, cs, dims)
    out = [kmeans_assign_plain(xs[p, :, :d].contiguous(), cs[p, :, :d].contiguous())
           for p, d in enumerate(dims)]
    return torch.stack([a for a, _ in out]), torch.stack([m for _, m in out])


def kmeans_assign_pairs_cuda(xs: torch.Tensor, cs: torch.Tensor, dims=None):
    """Kernel launch: :func:`kmeans_assign_pairs_plain`'s result in one
    launch, bit for bit what one :func:`kmeans_assign_cuda` call per pair at
    its own width gives. xs (P, n, w) and cs (P, k, w) float32, contiguous,
    on the card, zero past each pair's width (``dims`` is checked only for
    its shape: the kernel reads the padding, whose zeros change no sum)."""
    cuda.check_cuda("kmeans_assign", xs, cs, dtypes=(torch.float32, torch.float32))
    _check_pairs(xs, cs, dims)
    _check(xs, cs, "kmeans_assign_pairs")
    n_pairs, n, w = xs.shape
    if n_pairs > MAX_PAIRS:
        raise ValueError(f"kmeans_assign_pairs: {n_pairs} pairs exceed {MAX_PAIRS}")
    assign = torch.empty((n_pairs, n), dtype=torch.int32, device=xs.device)
    dmin = torch.empty((n_pairs, n), dtype=torch.float32, device=xs.device)
    cuda.launch("kmeans_assign", "kmeans_assign_pairs_f32", _PAIRS_ARGS, cuda.ptr(xs),
                cuda.ptr(cs), cuda.ptr(assign), cuda.ptr(dmin), n_pairs, n, cs.shape[1], w,
                cuda.stream(xs.device))
    return assign, dmin
