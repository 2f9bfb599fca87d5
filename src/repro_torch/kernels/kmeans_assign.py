"""Fused k-means assignment: the CUDA kernel (``csrc/kmeans_assign.cu``) and
its plain version, for one (points, centroids) pair or for P independent
pairs zero-padded to one width in one launch.

Centroids that fit in one block's shared memory with their norms
(k (w + 1) floats within :data:`MAX_SMEM`) are staged once a block; past
that (IVF's 1024 lists of 128 dims) the tiled path screens every (point,
centroid) pair on the tensor cores in TF32 and rechecks, in the exact f32
arithmetic, every centroid the screen cannot rule out: bit for bit the same
answer (the window's derivation is in ``csrc/kmeans_assign.cu``).
:func:`tiled` says which way a shape goes; :data:`last_tiled` holds the last
tiled launch's recheck count."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import kmeans_assign_ref

_TILED_ARGS = [ctypes.c_float] * 2 + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                      ctypes.c_void_p]
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + _TILED_ARGS
_PAIRS_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + _TILED_ARGS
MAX_DIM = 128
#: shared memory a block may hold (H100: 227 KB)
MAX_SMEM = 232448
#: pairs a launch takes (the grid's y extent)
MAX_PAIRS = 65535
#: the tiled path's points a block and centroids a tile (``tiled::R``, ``N``)
TILE_POINTS = 192
TILE_CENTROIDS = 64
#: the screen's window: |screened - exact| <= 2 G a b + EPS ((a + b)^2 +
#: (p + q)^2), a, b the centred rows' norms, p, q the raw ones (derived in
#: ``csrc/kmeans_assign.cu``); the wrapper passes both to the kernel
SCREEN_GAMMA = 2.0 ** -9 + 2.0 ** -12
SCREEN_EPS = 2.0 ** -16
#: the factor on sqrt of a computed chain that makes it a norm bound (the
#: kernel's ``tiled::KAPPA``; the CPU emulation reads it here)
SCREEN_KAPPA = 1.0 + 2.0 ** -16
#: the last tiled launch: ``rechecks`` (a device int64 tensor of one
#: element, read it after the launch's stream is done), ``points`` (pairs x
#: points) and ``centroids`` (k)
last_tiled: dict = {}


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


def tiled_scratch_floats(n_pairs: int, k: int, w: int) -> int:
    """Floats of scratch a tiled launch needs: each tile of 64 centred
    centroids as its shared-memory image plus a 1 KB record (P, k_pad / 64,
    64 wp + 256), their c2 (P, k_pad) and mu (P, wp), with k_pad = k up to a
    whole tile and wp = w up to a multiple of 32 (``tiled::Scratch``)."""
    k_pad = -(-k // TILE_CENTROIDS) * TILE_CENTROIDS
    wp = -(-w // 32) * 32
    return n_pairs * ((k_pad // TILE_CENTROIDS) * (TILE_CENTROIDS * wp + 256) + k_pad + wp)


def _tiled_args(n_pairs: int, n: int, k: int, w: int, device):
    """The tiled path's trailing C arguments (null for the one-tile path);
    a tiled launch gets its scratch and a zeroed recheck counter, kept in
    :data:`last_tiled`."""
    if not tiled(k, w):
        return (0.0, 0.0, None, 0, None)
    floats = tiled_scratch_floats(n_pairs, k, w)
    scratch = torch.empty((floats,), dtype=torch.float32, device=device)
    rechecks = torch.zeros((1,), dtype=torch.int64, device=device)
    last_tiled.update(rechecks=rechecks, points=n_pairs * n, centroids=k)
    return (SCREEN_GAMMA, SCREEN_EPS, cuda.ptr(scratch), floats, cuda.ptr(rechecks))


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
                *_tiled_args(1, n, c.shape[0], d, x.device), cuda.stream(x.device))
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
                *_tiled_args(n_pairs, n, cs.shape[1], w, xs.device), cuda.stream(xs.device))
    return assign, dmin
