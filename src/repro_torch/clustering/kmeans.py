"""K-means (Lloyd) — the clustering substrate the IMI index builds on
(``repro.clustering.kmeans``).

Lloyd runs as one Python loop over P independent problems in lockstep (the
build's 2 N_s (subspace, half) pairs, or the one problem of :func:`kmeans`).
Each step assigns every pair with one
:func:`repro_torch.kernels.ops.kmeans_assign_pairs` call (one CUDA kernel
launch on the card) and recomputes all P k means. An empty cluster keeps
its previous centroid.

On the CPU the sums are one ``index_add_`` into P k bins, which adds rows in
order, so each bin sums the same rows in the same order as one loop per pair
would, and P problems in lockstep give bit for bit what P separate runs
give. On the card ``index_add_`` would add floats with atomics in no fixed
order, and two builds of one corpus would differ; there the sums are
products of one-hot assignment segments with the rows (``bmm``, IEEE
float32, segments of a fixed size) reduced in a fixed order, so a build on
the card repeats bit for bit. A compaction is such a build, and
so equals a rebuild over the same live corpus, as in the reference. On
``meta`` tensors (the dry runs) the card's path runs, so that its work is
what they count.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def kmeans_assign(data: torch.Tensor, centroids: torch.Tensor, impl: str = "auto"):
    """Nearest-centroid assignment: (assignments (n,) int32, min_dists (n,))."""
    return ops.kmeans_assign(data, centroids, impl=impl)


def lloyd_step_pairs(xs: torch.Tensor, centroids: torch.Tensor, dims=None,
                     impl: str = "auto"):
    """One Lloyd iteration for P pairs: xs (P, n, w) and centroids (P, k, w),
    zero past each pair's width ``dims[p]``. Returns (new centroids (P, k,
    w), still zero-padded, and assignments (P, n) int32). Empty clusters
    keep their previous centroid."""
    n_pairs, _n, w = xs.shape
    k = centroids.shape[1]
    assign, _ = ops.kmeans_assign_pairs(xs, centroids, dims, impl=impl)
    sums, counts = cluster_sums(xs, assign, k)
    return new_means(sums, counts, centroids), assign


def cluster_sums(xs: torch.Tensor, assign: torch.Tensor, k: int):
    """(sums (P, k, w) float32, counts (P, k) float32) of the rows of xs
    (P, n, w) per cluster of assign (P, n). The same inputs give the same
    bits on either device (see the module docstring)."""
    n_pairs, _n, w = xs.shape
    offsets = torch.arange(n_pairs, device=xs.device)[:, None] * k
    idx = (assign.long() + offsets).reshape(-1)
    if xs.device.type in ("cuda", "meta"):  # meta: count the card's path
        sums = _onehot_sums(xs, assign, k)
    else:
        sums = torch.zeros((n_pairs * k, w), dtype=torch.float32, device=xs.device)
        sums.index_add_(0, idx, xs.reshape(-1, w))
    # counts of 1.0 are exact below 2^24 in any order of addition
    counts = torch.zeros((n_pairs * k,), dtype=torch.float32, device=xs.device)
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    return sums.reshape(n_pairs, k, w), counts.reshape(n_pairs, k)


def new_means(sums: torch.Tensor, counts: torch.Tensor, centroids: torch.Tensor):
    """The Lloyd update from :func:`cluster_sums`: each cluster's mean, or
    its previous centroid where it is empty."""
    return torch.where(counts[..., None] > 0,
                       sums / torch.clamp_min(counts, 1.0)[..., None], centroids)


#: one-hot floats a block of rows takes: P x rows x k stay near 512 MB
_ONEHOT_FLOATS = 1 << 27
#: rows one small product sums; the products' partial sums are then added
#: by a reduction over segments. A single (k, n) x (n, w) product would run
#: on k w / tile blocks and leave the card idle
_SEGMENT = 2048


def _onehot_sums(xs: torch.Tensor, assign: torch.Tensor, k: int) -> torch.Tensor:
    """(P, k, w) per-cluster sums of xs (P, n, w) under assign (P, n): the
    rows in blocks, each block cut into segments of ``_SEGMENT`` rows
    (zero-padded), one batched product of each segment's one-hot
    assignments with its rows, the segments' partial sums reduced in a
    fixed order, the blocks added in order. No atomics, so the same inputs
    give the same bits; the sizes are constants, so the order never depends
    on the card."""
    n_pairs, n, w = xs.shape
    step = max(1, _ONEHOT_FLOATS // (n_pairs * k * _SEGMENT)) * _SEGMENT
    sums = torch.zeros((n_pairs, k, w), dtype=torch.float32, device=xs.device)
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        segs = -(-(hi - lo) // _SEGMENT)
        rows = segs * _SEGMENT
        onehot = torch.zeros((n_pairs, rows, k), dtype=torch.float32, device=xs.device)
        onehot[:, :hi - lo].scatter_(2, assign[:, lo:hi, None].long(), 1.0)
        x = torch.zeros((n_pairs, rows, w), dtype=torch.float32, device=xs.device)
        x[:, :hi - lo] = xs[:, lo:hi]
        part = torch.bmm(onehot.view(n_pairs * segs, _SEGMENT, k).transpose(1, 2),
                         x.view(n_pairs * segs, _SEGMENT, w))
        sums += part.view(n_pairs, segs, k, w).sum(dim=1)
    return sums


def lloyd_step(data: torch.Tensor, centroids: torch.Tensor, impl: str = "auto"):
    """One Lloyd iteration: assign + recompute means. Empty clusters keep
    their previous centroid."""
    new_centroids, assign = lloyd_step_pairs(data[None], centroids[None], impl=impl)
    return new_centroids[0], assign[0]


def _kmeanspp_init(data: torch.Tensor, k: int, generator: torch.Generator | None):
    """k-means++ seeding: sample points one by one with probability
    proportional to the squared distance to the nearest chosen centroid.

    The draws come from the CPU ``generator`` (one index, then k - 1
    uniforms); each pick is a ``searchsorted`` of ``total * (1 - u)`` in the
    running sum of the distances on the data's device, so the seeding is
    repeatable for a seed on one device."""
    n = data.shape[0]
    first = torch.randint(n, (1,), generator=generator).to(data.device)
    uniforms = torch.rand((k - 1,), generator=generator, dtype=torch.float64)
    centroids = torch.zeros((k, data.shape[1]), dtype=torch.float32, device=data.device)
    centroids[0] = data[first[0]]
    dmin = torch.sum((data - centroids[0]) ** 2, dim=1)
    for i in range(1, k):
        cdf = torch.cumsum(dmin, dim=0)
        r = cdf[-1:] * (1.0 - float(uniforms[i - 1]))
        idx = torch.clamp_max(torch.searchsorted(cdf, r), n - 1)
        centroids[i] = data[idx[0]]
        dmin = torch.minimum(dmin, torch.sum((data - centroids[i]) ** 2, dim=1))
    return centroids


def kmeans_pairs(
    xs: torch.Tensor,
    k: int,
    iters: int = 10,
    init: str = "random",
    *,
    dims=None,
    generator: torch.Generator | None = None,
    init_centroids: torch.Tensor | None = None,
    impl: str = "auto",
):
    """K-means on P independent pairs in lockstep: xs (P, n, w) float32,
    zero past each pair's width ``dims[p]`` (default: all w). Returns
    (centroids (P, k, w), zero-padded the same way, assignments (P, n)
    int32): one assignment launch per iteration and one at the end.

    The initial centroids are drawn pair by pair, in order, from the CPU
    ``generator``: k distinct points by ``randperm`` for ``init="random"``,
    the k-means++ draws at the pair's own width for ``init="kmeans++"``;
    so every draw is the one P separate :func:`kmeans` calls would make.
    ``init_centroids`` (P, k, w) replaces the draw."""
    n_pairs, n, w = xs.shape
    dims = [w] * n_pairs if dims is None else [int(d) for d in dims]
    if init_centroids is not None:
        centroids = init_centroids.to(device=xs.device, dtype=torch.float32)
    elif init in ("random", "kmeans++"):
        centroids = torch.zeros((n_pairs, k, w), dtype=torch.float32, device=xs.device)
        for p, d in enumerate(dims):
            if init == "random":
                rows = torch.randperm(n, generator=generator)[:k]
                centroids[p] = xs[p, rows.to(xs.device)]
            else:
                centroids[p, :, :d] = _kmeanspp_init(xs[p, :, :d].contiguous(), k, generator)
    else:
        raise ValueError(f"unknown kmeans init {init!r}")
    for _ in range(iters):
        centroids, _a = lloyd_step_pairs(xs, centroids, dims, impl)
    assign, _ = ops.kmeans_assign_pairs(xs, centroids, dims, impl=impl)
    return centroids, assign


def kmeans(
    data: torch.Tensor,
    k: int,
    iters: int = 10,
    init: str = "random",
    *,
    generator: torch.Generator | None = None,
    init_centroids: torch.Tensor | None = None,
    impl: str = "auto",
):
    """K-means clustering: (centroids (k, d), assignments (n,) int32); the
    one-pair case of :func:`kmeans_pairs`.

    ``init="random"`` takes k distinct points drawn with ``generator`` (a
    CPU ``torch.Generator``), ``init="kmeans++"`` seeds with it;
    ``init_centroids`` replaces the draw."""
    data = data.to(torch.float32).contiguous()
    centroids, assign = kmeans_pairs(
        data[None], k, iters, init, generator=generator, impl=impl,
        init_centroids=None if init_centroids is None else init_centroids[None])
    return centroids[0], assign[0]
