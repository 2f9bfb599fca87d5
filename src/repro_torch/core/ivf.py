"""IVF-Flat, the non-subspace-collision comparator (mirrors
``repro.core.ivf``; paper §5.4, standing in for the IVF/IMI quantization
family): k-means lists over the full space, queried by probing the
``nprobe`` nearest lists with exact distances inside them.

The build is :func:`repro_torch.clustering.kmeans` on the index's device,
which on the card runs its assignments through the ``kmeans_assign`` kernel
(tiled past shared memory at IVF's 1024 lists of 128 dims). The reference
fills the lists with a Python loop over the points; here they come from a
stable sort of the assignments: the same lists, point ids increasing inside
each, -1 padded to the longest.

The query computes each query's answer alone, so it runs in chunks of
queries whose gathered candidates fit ``chunk_bytes``: the reference's one
(Q, nprobe Lmax, d) gather would be tens of GB at 10^6 points.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.clustering import kmeans
from repro_torch.utils import pairwise_sq_dists, resolve_device, topk_smallest

#: bytes of gathered candidate rows (and their differences) a query chunk
#: may hold
CHUNK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True, eq=False)
class IVFIndex:
    centroids: torch.Tensor  # (K, d) float32
    lists: torch.Tensor  # (K, Lmax) int32, -1 padded
    data: torch.Tensor  # (n, d) float32

    @property
    def index_bytes(self) -> int:
        """The centroids and the lists, as the reference counts them."""
        return int(sum(t.numel() * t.element_size() for t in (self.centroids, self.lists)))


def ivf_lists(assign: torch.Tensor, n_lists: int) -> torch.Tensor:
    """(n_lists, Lmax) int32 inverted lists of the assignments (n,): list
    j holds the ids assigned to j in increasing order, -1 past its count;
    Lmax is the largest count."""
    a = assign.long()
    counts = torch.bincount(a, minlength=n_lists)
    lmax = int(counts.max())
    order = torch.sort(a, stable=True).indices
    start = torch.cumsum(counts, 0) - counts
    owner = a[order]
    slot = torch.arange(a.shape[0], device=a.device) - start[owner]
    lists = torch.full((n_lists, lmax), -1, dtype=torch.int32, device=a.device)
    lists[owner, slot] = order.to(torch.int32)
    return lists


def build_ivf(data, n_lists: int, kmeans_iters: int = 10, seed: int = 0, *,
              device: str | torch.device = "cuda") -> IVFIndex:
    """K-means over ``data`` (n, d) on ``device`` (the card by default),
    ``kmeans_iters`` Lloyd steps from ``n_lists`` random points drawn with a
    CPU generator seeded by ``seed``, then the inverted lists."""
    dev = resolve_device(device)
    data = torch.as_tensor(data, dtype=torch.float32).to(dev).contiguous()
    gen = torch.Generator().manual_seed(seed)
    centroids, assign = kmeans(data, n_lists, kmeans_iters, generator=gen)
    return IVFIndex(centroids=centroids, lists=ivf_lists(assign, n_lists), data=data)


def ivf_index_from_arrays(centroids, lists, data, device: str | torch.device = "cuda"):
    """An :class:`IVFIndex` on ``device`` from plain arrays (e.g. a reference
    index's ``np.asarray`` leaves)."""
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype).to(dev).contiguous()

    return IVFIndex(centroids=t(centroids, torch.float32), lists=t(lists, torch.int32),
                    data=t(data, torch.float32))


def _query_chunk(index: IVFIndex, queries: torch.Tensor, nprobe: int, k: int):
    dc = pairwise_sq_dists(queries, index.centroids)  # (Q, K)
    _, probe = topk_smallest(dc, nprobe)  # (Q, nprobe)
    cand = index.lists[probe].reshape(queries.shape[0], -1)
    valid = cand >= 0
    safe = torch.clamp_min(cand, 0)
    diff = index.data[safe.long()] - queries[:, None, :]  # (Q, nprobe*Lmax, d)
    dists = torch.where(valid, torch.sum(diff * diff, dim=-1), torch.inf)
    del diff
    top_d, pos = topk_smallest(dists, k)
    ids = torch.gather(safe, 1, pos)
    ok = torch.isfinite(top_d)
    return torch.where(ok, ids, -1), torch.where(ok, top_d, torch.inf)


def ivf_query(index: IVFIndex, queries, nprobe: int, k: int):
    """Probe the ``nprobe`` nearest lists, exact ``diff . diff`` distances
    inside them, top-k: (ids (Q, k) int32, sq_dists (Q, k) float32), ties to
    the lowest position, -1 / +inf in unfilled slots. Queries run in chunks
    whose gathered rows fit :data:`CHUNK_BYTES`; the result does not depend
    on the chunking."""
    n_lists, lmax = index.lists.shape
    if not 0 < nprobe <= n_lists or not 0 < k <= nprobe * lmax:
        raise ValueError(f"ivf_query: need 0 < nprobe <= {n_lists} and "
                         f"0 < k <= nprobe * Lmax = {nprobe * lmax}, got {nprobe}, {k}")
    queries = torch.as_tensor(queries).to(device=index.data.device, dtype=torch.float32)
    per_query = 2 * nprobe * lmax * index.data.shape[1] * 4
    rows = max(1, CHUNK_BYTES // per_query)
    parts = [_query_chunk(index, queries[lo:lo + rows], nprobe, k)
             for lo in range(0, queries.shape[0], rows)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
