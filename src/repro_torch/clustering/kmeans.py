"""K-means (Lloyd) — the clustering substrate the IMI index builds on
(``repro.clustering.kmeans``).

Lloyd runs as one Python loop over P independent problems in lockstep (the
build's 2 N_s (subspace, half) pairs, or the one problem of :func:`kmeans`).
Each step assigns every pair with one
:func:`repro_torch.kernels.ops.kmeans_assign_pairs` call (one CUDA kernel
launch on the card) and recomputes all P k means with one ``index_add_``
into P k bins. An empty cluster keeps its previous centroid.

On the CPU ``index_add_`` adds rows in order, so each bin sums the same rows
in the same order as one loop per pair would, and P problems in lockstep
give bit for bit what P separate runs give. On the card ``index_add_`` sums
floats with atomics in no fixed order, so a build there is not bitwise
repeatable, with one pair or with many; on integer-valued data, where
float32 sums below 2^24 are exact in any order, it is.
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
    offsets = torch.arange(n_pairs, device=xs.device)[:, None] * k
    idx = (assign.long() + offsets).reshape(-1)
    sums = torch.zeros((n_pairs * k, w), dtype=torch.float32, device=xs.device)
    sums.index_add_(0, idx, xs.reshape(-1, w))
    counts = torch.zeros((n_pairs * k,), dtype=torch.float32, device=xs.device)
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    new_centroids = torch.where(
        counts[:, None] > 0, sums / torch.clamp_min(counts, 1.0)[:, None],
        centroids.reshape(-1, w),
    )
    return new_centroids.reshape(n_pairs, k, w), assign


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
