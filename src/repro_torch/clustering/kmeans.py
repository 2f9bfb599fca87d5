"""K-means (Lloyd) — the clustering substrate the IMI index builds on
(``repro.clustering.kmeans``).

Lloyd runs as a Python loop; each step assigns through
:func:`repro_torch.kernels.ops.kmeans_assign` (the CUDA kernel on the card)
and recomputes the means with ``index_add_``. An empty cluster keeps its
previous centroid. On the card ``index_add_`` sums floats with atomics in
no fixed order, so a build there is not bitwise repeatable.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def kmeans_assign(data: torch.Tensor, centroids: torch.Tensor, impl: str = "auto"):
    """Nearest-centroid assignment: (assignments (n,) int32, min_dists (n,))."""
    return ops.kmeans_assign(data, centroids, impl=impl)


def lloyd_step(data: torch.Tensor, centroids: torch.Tensor, impl: str = "auto"):
    """One Lloyd iteration: assign + recompute means. Empty clusters keep
    their previous centroid."""
    k = centroids.shape[0]
    assign, _ = kmeans_assign(data, centroids, impl)
    idx = assign.long()
    sums = torch.zeros((k, data.shape[1]), dtype=torch.float32, device=data.device)
    sums.index_add_(0, idx, data)
    counts = torch.zeros((k,), dtype=torch.float32, device=data.device)
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    new_centroids = torch.where(
        counts[:, None] > 0, sums / torch.clamp_min(counts, 1.0)[:, None], centroids
    )
    return new_centroids, assign


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
    """K-means clustering: (centroids (k, d), assignments (n,) int32).

    ``init="random"`` takes k distinct points drawn with ``generator`` (a
    CPU ``torch.Generator``), ``init="kmeans++"`` seeds with it;
    ``init_centroids`` replaces the draw."""
    data = data.to(torch.float32).contiguous()
    if init_centroids is not None:
        centroids = init_centroids.to(device=data.device, dtype=torch.float32)
    elif init == "random":
        idx = torch.randperm(data.shape[0], generator=generator)[:k]
        centroids = data[idx.to(data.device)]
    elif init == "kmeans++":
        centroids = _kmeanspp_init(data, k, generator)
    else:
        raise ValueError(f"unknown kmeans init {init!r}")
    for _ in range(iters):
        centroids, _a = lloyd_step(data, centroids, impl)
    assign, _ = kmeans_assign(data, centroids, impl)
    return centroids, assign
