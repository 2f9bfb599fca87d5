"""Fused k-means assignment: the CUDA kernel (``csrc/kmeans_assign.cu``) and
its plain version, for one (points, centroids) pair or for P independent
pairs zero-padded to one width in one launch.

Centroids that fit in one block's shared memory with their norms
(k (w + 1) floats within :data:`MAX_SMEM`), at widths up to
:data:`MAX_ONE_TILE_DIM`, are staged once a block; past that (IVF's 1024
lists of 128 dims, or any width past 128, e.g. GIST's 960) the tiled path
screens every (point, centroid) pair on the tensor cores in TF32 and
rechecks, in the exact f32 arithmetic, every centroid the screen cannot rule
out: bit for bit the same answer (the window's derivation is in
``csrc/kmeans_assign.cu``; :func:`screen_window` gives it at a width). Past
128 dims the points are streamed through the tensor cores in chunks of 64
features from a pre-pass's scratch (``wide`` in the source). :func:`tiled`
says which way a shape goes; :data:`last_tiled` holds the last tiled
launch's recheck count. Any width and any k > 0."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import kmeans_assign_ref

_TILED_ARGS = [ctypes.c_float] * 3 + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                      ctypes.c_void_p]
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + _TILED_ARGS
_PAIRS_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + _TILED_ARGS
#: the widest rows the one-tile kernel and the resident-points tiled kernel
#: take (``tiled::MAX_WP``); wider rows take the wide tiled path
MAX_ONE_TILE_DIM = 128
#: shared memory a block may hold (H100: 227 KB)
MAX_SMEM = 232448
#: pairs a launch takes (the grid's y extent)
MAX_PAIRS = 65535
#: the tiled path's points a block and centroids a tile (``tiled::R``, ``N``)
TILE_POINTS = 192
TILE_CENTROIDS = 64
#: features a chunk of the wide path (``wide::CF``)
WIDE_CHUNK = 64
#: the most bytes of the wide path's points scratch: it holds a run of row
#: blocks, and the launch walks the points in runs
WIDE_RUN_BYTES = 1 << 30
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
    """Whether k centroids of width w go through a tiled kernel: their
    k (w + 1) floats do not fit in one block's shared memory, or the rows
    are wider than :data:`MAX_ONE_TILE_DIM`."""
    return w > MAX_ONE_TILE_DIM or k * (w + 1) * 4 > MAX_SMEM


def screen_window(w: int) -> tuple[float, float, float]:
    """The tiled paths' window at width w, (G, EPS, KAPPA): |screened -
    exact| <= 2 G a b + EPS ((a + b)^2 + (p + q)^2), a, b the centred rows'
    norm bounds, p, q the raw ones, each bound sqrt of a computed chain
    times KAPPA (derived in ``csrc/kmeans_assign.cu``). Each is exact in
    float32 and rounded up; up to w = 239 they are 2^-9 + 2^-12, 2^-16 and
    1 + 2^-16."""
    u = 2.0 ** -24

    def gamma(m):
        return m * u / (1 - m * u)

    g = 2.0 ** -9 + max(256, math.ceil((w + 1) * (1 + 2.0 ** -8) + 2)) * 2.0 ** -20
    eps = max(2.0 ** -16, math.ceil(gamma(w + 16) / (16 * u)) * 16 * u)
    kappa = 1 + math.ceil((gamma(w) / (2 * u) + 3) / 256) * 2.0 ** -16
    return g, eps, kappa


def wide_run_blocks(n_pairs: int, n: int, w: int, sms: int = 132) -> int:
    """Row blocks of TILE_POINTS points a run of the wide path takes: all of
    the pairs' where their scratch fits :data:`WIDE_RUN_BYTES`, else as many
    as fit, in whole waves of ``sms`` blocks (one block an SM) where that
    leaves one, and at least one."""
    wp = -(-w // WIDE_CHUNK) * WIDE_CHUNK
    blocks = -(-n // TILE_POINTS)
    fit = max(1, WIDE_RUN_BYTES // (4 * n_pairs * TILE_POINTS * (wp + 2)))
    if fit >= blocks:
        return blocks
    return fit // sms * sms if fit >= sms else fit


def tiled_scratch_floats(n_pairs: int, k: int, w: int, n: int = 0, sms: int = 132) -> int:
    """Floats of scratch a tiled launch needs: each tile of 64 centred
    centroids as its shared-memory image plus a 1 KB record (P, k_pad / 64,
    64 wp + 256), their c2 (P, k_pad) and mu (P, wp), with k_pad = k up to a
    whole tile and wp = w up to a multiple of 32 (``tiled::Scratch``). Past
    128 dims (the wide path: ``wide::Scratch``) wp is w up to a multiple of
    64, and a run of :func:`wide_run_blocks` row blocks of each pair's
    points follows, centred, as their ring images (P, blocks, wp / 64, 192
    x 64) and their two chains (P, blocks x 192, 2): the kernel walks the n
    points in runs of as many blocks as the scratch holds."""
    k_pad = -(-k // TILE_CENTROIDS) * TILE_CENTROIDS
    step = WIDE_CHUNK if w > MAX_ONE_TILE_DIM else 32
    wp = -(-w // step) * step
    floats = n_pairs * ((k_pad // TILE_CENTROIDS) * (TILE_CENTROIDS * wp + 256) + k_pad + wp)
    if w > MAX_ONE_TILE_DIM:
        rows = wide_run_blocks(n_pairs, n, w, sms) * TILE_POINTS
        floats += n_pairs * rows * (wp + 2)
    return floats


def _tiled_args(n_pairs: int, n: int, k: int, w: int, device):
    """The tiled path's trailing C arguments (null for the one-tile path);
    a tiled launch gets its window, its scratch and a zeroed recheck
    counter, kept in :data:`last_tiled`."""
    if not tiled(k, w):
        return (0.0, 0.0, 0.0, None, 0, None)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    floats = tiled_scratch_floats(n_pairs, k, w, n, sms)
    scratch = torch.empty((floats,), dtype=torch.float32, device=device)
    rechecks = torch.zeros((1,), dtype=torch.int64, device=device)
    last_tiled.update(rechecks=rechecks, points=n_pairs * n, centroids=k)
    return (*screen_window(w), cuda.ptr(scratch), floats, cuda.ptr(rechecks))


def _layout(k: int, w: int) -> str:
    """Which kernel a shape takes, as counted in :data:`cuda.launch_layouts`."""
    if w > MAX_ONE_TILE_DIM:
        return "tiled_wide"
    return "tiled" if tiled(k, w) else "one_tile"


def _check(x: torch.Tensor, c: torch.Tensor, name: str = "kmeans_assign") -> None:
    """What both entries need: a width and a centroid."""
    w, k = x.shape[-1], c.shape[-2]
    if w == 0 or k == 0:
        raise ValueError(f"{name}: need d > 0 and k > 0, got d={w}, k={k}")


def kmeans_assign_cuda(x: torch.Tensor, c: torch.Tensor):
    """Kernel launch: x (n, d) and c (k, d) float32, contiguous, on the
    card, any d and k. The batched kernel with one pair."""
    cuda.check_cuda("kmeans_assign", x, c, dtypes=(torch.float32, torch.float32))
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"kmeans_assign: bad shapes {tuple(x.shape)}, {tuple(c.shape)}")
    _check(x, c)
    n, d = x.shape
    assign = torch.empty((n,), dtype=torch.int32, device=x.device)
    dmin = torch.empty((n,), dtype=torch.float32, device=x.device)
    cuda.launch("kmeans_assign", "kmeans_assign_f32", _ARGS, cuda.ptr(x),
                cuda.ptr(c), cuda.ptr(assign), cuda.ptr(dmin), n, c.shape[0], d,
                *_tiled_args(1, n, c.shape[0], d, x.device), cuda.stream(x.device),
                layout=_layout(c.shape[0], d))
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
                *_tiled_args(n_pairs, n, cs.shape[1], w, xs.device), cuda.stream(xs.device),
                layout=_layout(cs.shape[1], w))
    return assign, dmin
