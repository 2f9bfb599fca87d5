"""TaCo — index build (paper Alg. 3) and the k-ANNS query (Alg. 6), as in
``repro.core.taco``.

``build`` and ``query`` read the method (TaCo, SuCo, ablations) from
``SCConfig``. ``cfg.rerank`` picks one of two query pipelines:

  * ``gather`` (the default): the full (Q, n) SC matrix
    (:func:`compute_sc_scores`), up to ``cap`` candidates per query
    (:func:`repro_torch.core.selection.select_candidates`), and an exact
    re-rank of the gathered candidates (:func:`rerank`);
  * ``masked_full``: the streaming two-pass pipeline. Pass 1
    (:func:`repro_torch.kernels.ops.schist`) reduces the SC-scores to a
    per-query histogram, Alg. 5 reads the threshold off it, pass 2
    (:func:`repro_torch.kernels.ops.masked_rerank`) re-ranks every point at
    or above the threshold.

Both read one collision table per batch. ``cfg.use_kernels`` routes the
centroid distances and the SC counting (and pass 2) through the CUDA kernels
when the index is on the card, exactly where the reference routes them
through Pallas.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import transform as T
from repro_torch.core.activation import activation_taus
from repro_torch.core.config import SCConfig, resolve_rerank
from repro_torch.core.imi import IMISubspace, build_imi_subspaces, half_columns
from repro_torch.core.scoring import sc_scores
from repro_torch.core.selection import (
    fixed_threshold_from_hist,
    query_aware_threshold,
    select_candidates,
)
from repro_torch.kernels import ops
from repro_torch.kernels.schist import cell_ids, collision_bits, collision_table
from repro_torch.obs.trace import stage
from repro_torch.utils import resolve_device, round_bf16, topk_smallest


def _nbytes(*tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors if t is not None))


@dataclasses.dataclass(frozen=True, eq=False)
class SCIndex:
    """A built subspace-collision index (TaCo or SuCo family)."""

    transform: T.SubspaceTransform | None  # entropy-averaging transform (TaCo)
    dim_perm: torch.Tensor | None  # raw-dim permutation (SuCo, Def. 4)
    subspaces: tuple[IMISubspace, ...]
    data: torch.Tensor  # (n, d) original data, used for re-ranking
    sub_dims: tuple[int, ...] = ()
    #: (n,) float32 ``||x||^2`` per point, computed once at build time
    data_norms: torch.Tensor | None = None

    @property
    def n(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def index_bytes(self) -> int:
        """Index memory footprint as the reference counts it (excludes the
        dataset, and the derived :attr:`cells` and centroid stacks)."""
        size = sum(
            _nbytes(s.centroids1, s.centroids2, s.assign1, s.assign2, s.cell_sizes)
            for s in self.subspaces
        )
        if self.transform is not None:
            size += _nbytes(self.transform.mean, self.transform.basis,
                            self.transform.eigvals)
        return size + _nbytes(self.dim_perm, self.data_norms)

    @functools.cached_property
    def cells(self) -> torch.Tensor:
        """(N_s, n) int32 combined IMI cell ids, computed once per index."""
        sqrt_k = self.subspaces[0].sqrt_k
        return torch.stack([
            cell_ids(s.assign1, s.assign2, sqrt_k) for s in self.subspaces
        ]).contiguous()

    @functools.cached_property
    def stacked_centroids(self) -> torch.Tensor:
        """(2 N_s, sqrt_k, d_max) float32: every subspace's ``centroids1``,
        then every ``centroids2``, zero-padded to the widest half (the
        batched ``l2dist`` operand, in :func:`_half_slices` order); computed
        once per index."""
        halves = ([s.centroids1 for s in self.subspaces]
                  + [s.centroids2 for s in self.subspaces])
        d_max = max(c.shape[1] for c in halves)
        out = torch.zeros((len(halves), halves[0].shape[0], d_max), dtype=torch.float32,
                          device=self.device)
        for p, c in enumerate(halves):
            out[p, :, :c.shape[1]] = c
        return out

    @functools.cached_property
    def stacked_centroids_bf16(self) -> torch.Tensor:
        """:attr:`stacked_centroids` rounded through bfloat16 once, for
        ``precision="bf16"`` queries."""
        return round_bf16(self.stacked_centroids)

    @functools.cached_property
    def assignments(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(a1s, a2s): the (N_s, n) int32 stacked half-cell assignments."""
        return (torch.stack([s.assign1 for s in self.subspaces]).contiguous(),
                torch.stack([s.assign2 for s in self.subspaces]).contiguous())

    @functools.cached_property
    def cell_sizes(self) -> torch.Tensor:
        """(N_s, sqrt_k, sqrt_k) int32 stacked cell-size grids."""
        return torch.stack([s.cell_sizes for s in self.subspaces])


def _project(index: SCIndex, x: torch.Tensor) -> torch.Tensor:
    if index.transform is not None:
        return T.apply_transform(index.transform, x)
    return x.to(torch.float32)[:, index.dim_perm.long()]


def _sub_slices(sub_dims: tuple[int, ...]) -> list[tuple[int, int]]:
    offs, out = 0, []
    for d in sub_dims:
        out.append((offs, offs + d))
        offs += d
    return out


def _half_slices(sub_dims: tuple[int, ...]) -> tuple[tuple[int, int], ...]:
    """(first column, width) in the projected query of every subspace's
    first half, then of every second half: the pairs of
    :attr:`SCIndex.stacked_centroids`."""
    halves = half_columns(sub_dims)
    return tuple(halves[0::2] + halves[1::2])


def suco_dim_partition(d: int, n_subspaces: int, rng: np.random.Generator):
    """Paper Def. 4 subspace sampling: random dims without replacement,
    N_s-1 subspaces of s = floor(d/N_s) dims, the last takes the rest."""
    s = d // n_subspaces
    perm = rng.permutation(d)
    sub_dims = tuple([s] * (n_subspaces - 1) + [d - s * (n_subspaces - 1)])
    return perm.astype(np.int32), sub_dims


def build(data, cfg: SCConfig, *, device: str | torch.device = "cuda") -> SCIndex:
    """Paper Algorithm 3 (plus Alg. 1/2 when cfg.transform == 'entropy').

    ``data`` (n, d) goes to ``device`` (the card by default). With
    ``cfg.use_kernels`` the k-means assignment runs through the CUDA kernel
    there."""
    dev = resolve_device(device)
    data = torch.as_tensor(data, dtype=torch.float32).to(dev).contiguous()
    n, d = data.shape
    gen = torch.Generator().manual_seed(cfg.seed)
    impl = "auto" if cfg.use_kernels else "torch"

    if cfg.transform == "entropy":
        tr = T.fit_transform(data, cfg.n_subspaces, cfg.subspace_dim)
        projected = T.apply_transform(tr, data)
        perm = None
        sub_dims = (cfg.subspace_dim,) * cfg.n_subspaces
    elif cfg.transform == "none":
        tr = None
        perm_np, sub_dims = suco_dim_partition(d, cfg.n_subspaces, np.random.default_rng(cfg.seed))
        perm = torch.as_tensor(perm_np, device=dev)
        projected = data[:, perm.long()]
    else:
        raise ValueError(f"unknown transform {cfg.transform!r}")

    subspaces = build_imi_subspaces(projected, sub_dims, cfg.sqrt_k, cfg.kmeans_iters,
                                    cfg.kmeans_init, generator=gen, impl=impl)
    return SCIndex(
        transform=tr,
        dim_perm=perm,
        subspaces=subspaces,
        data=data,
        sub_dims=sub_dims,
        data_norms=torch.sum(data * data, dim=1),
    )


def index_from_arrays(arrays: dict, sub_dims, device: str | torch.device = "cuda") -> SCIndex:
    """An index from plain arrays (numpy or tensors), e.g. the leaves of an
    index built by ``repro``. Keys: ``transform.mean``, ``transform.basis``,
    ``transform.eigvals`` (or none of them), ``dim_perm`` (or absent),
    ``subspaces.<i>.{centroids1,centroids2,assign1,assign2,cell_sizes}``,
    ``data`` and ``data_norms``."""
    dev = resolve_device(device)

    def get(name, dtype):
        return torch.as_tensor(np.array(arrays[name]), dtype=dtype).to(dev).contiguous()

    sub_dims = tuple(int(s) for s in sub_dims)
    tr = None
    if "transform.basis" in arrays:
        tr = T.SubspaceTransform(
            mean=get("transform.mean", torch.float32),
            basis=get("transform.basis", torch.float32),
            eigvals=get("transform.eigvals", torch.float32),
            n_subspaces=len(sub_dims),
            subspace_dim=sub_dims[0],
        )
    perm = get("dim_perm", torch.int32) if arrays.get("dim_perm") is not None else None
    subspaces = tuple(
        IMISubspace(
            centroids1=get(f"subspaces.{i}.centroids1", torch.float32),
            centroids2=get(f"subspaces.{i}.centroids2", torch.float32),
            assign1=get(f"subspaces.{i}.assign1", torch.int32),
            assign2=get(f"subspaces.{i}.assign2", torch.int32),
            cell_sizes=get(f"subspaces.{i}.cell_sizes", torch.int32),
        )
        for i in range(len(sub_dims))
    )
    data = get("data", torch.float32)
    norms = (get("data_norms", torch.float32) if arrays.get("data_norms") is not None
             else torch.sum(data * data, dim=1))
    return SCIndex(transform=tr, dim_perm=perm, subspaces=subspaces, data=data,
                   sub_dims=sub_dims, data_norms=norms)


def _centroid_distances(index: SCIndex, queries: torch.Tensor, use_kernels: bool,
                        precision: str = "f32"):
    """Per-subspace distances to both centroid halves: stacked (N_s, Q,
    sqrt_k). ``precision="bf16"`` rounds the projected queries and the
    centroids through bfloat16 first, so both passes read identically
    derived distances. Every (subspace, half) pair goes through one batched
    ``l2dist`` (one kernel launch on the card with ``use_kernels``)."""
    with stage("taco.centroid_dists", queries.device):
        pq = _project(index, queries)
        if precision == "bf16":
            pq = round_bf16(pq)
        cents = index.stacked_centroids_bf16 if precision == "bf16" else index.stacked_centroids
        dists = ops.l2dist_pairs(pq, _half_slices(index.sub_dims), cents,
                                 impl="auto" if use_kernels else "torch")
    n_sub = len(index.subspaces)
    return dists[:n_sub], dists[n_sub:]


def _collision_inputs(index: SCIndex, queries: torch.Tensor, cfg: SCConfig):
    """Alg. 6 lines 3-5 without the SC matrix: centroid distances,
    activation thresholds, the per-index cell ids and the retrieved counts."""
    d1s, d2s = _centroid_distances(index, queries, cfg.use_kernels, cfg.precision)
    with stage("taco.activation", queries.device):
        taus, retrieved = activation_taus(
            d1s, d2s, index.cell_sizes, cfg.alpha * index.n, method=cfg.activation,
            impl="auto" if cfg.use_kernels else "torch")
    return d1s, d2s, index.cells, taus, retrieved


def compute_sc_scores(index: SCIndex, queries: torch.Tensor, cfg: SCConfig):
    """Collision counting (Alg. 6 lines 3-7): SC-scores (Q, n) int32 and
    the activation diagnostics. With ``cfg.use_kernels`` the count runs on
    the packed collision table (the ``scscore`` kernel on the card), else
    through the plain per-subspace gathers of :func:`sc_scores`."""
    d1s, d2s, cells, taus, retrieved = _collision_inputs(index, queries, cfg)
    with stage("taco.collide", queries.device):
        if cfg.use_kernels:
            bits = collision_bits(collision_table(d1s, d2s, taus))
            sc = ops.scscore(bits, cells, q=queries.shape[0])
        else:
            a1s, a2s = index.assignments
            sc = sc_scores(d1s, d2s, a1s, a2s, taus)
    return sc, {"taus": taus, "retrieved": retrieved}


def data_norms_of(index: SCIndex) -> torch.Tensor:
    """``||x||^2`` per point: the index's precomputed norms, or derived
    when it has none."""
    if index.data_norms is not None:
        return index.data_norms
    return torch.sum(index.data * index.data, dim=1)


#: bytes of gathered candidate rows one query chunk of :func:`rerank` may
#: hold; a batch past it runs in query chunks (the main 10^6 x 128 index's
#: 1024 bucket at a cap of 20,000 gathers 10.5 GB in one piece; at 960 dims
#: the same cap would gather 73 GiB)
RERANK_CHUNK_BYTES = 16 << 30


def rerank(data: torch.Tensor, queries: torch.Tensor, cand_ids: torch.Tensor,
           valid: torch.Tensor, k: int, data_norms: torch.Tensor | None = None):
    """Exact distances over the candidates and a masked top-k: (ids (Q, k)
    int32, sq_dists (Q, k) f32), id -1 / +inf where fewer than k candidates
    are valid; ties go to the lowest slot. With the precomputed norms the
    distances are ``max(||q||^2 - 2 q.x + ||x||^2, 0)``, without them
    ``(x - q) . (x - q)``, as in the reference. A batch whose gathered rows
    pass :data:`RERANK_CHUNK_BYTES` runs in query chunks that fit it."""
    per_query = cand_ids.shape[1] * data.shape[1] * 4 * (1 if data_norms is not None else 2)
    rows = max(1, RERANK_CHUNK_BYTES // max(per_query, 1))
    if queries.shape[0] <= rows:
        return _rerank_chunk(data, queries, cand_ids, valid, k, data_norms)
    parts = [_rerank_chunk(data, queries[lo:lo + rows], cand_ids[lo:lo + rows],
                           valid[lo:lo + rows], k, data_norms)
             for lo in range(0, queries.shape[0], rows)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _rerank_chunk(data, queries, cand_ids, valid, k: int, data_norms):
    """:func:`rerank` on one query chunk."""
    cand = cand_ids.long()
    if data_norms is None:
        diff = data[cand] - queries[:, None, :]
        dists = torch.sum(diff * diff, dim=-1)
        del diff
    else:
        cross = torch.bmm(data[cand], queries[:, :, None])[:, :, 0]  # (Q, cap)
        q_norms = torch.sum(queries * queries, dim=1)
        dists = torch.clamp_min(q_norms[:, None] - 2.0 * cross + data_norms[cand], 0.0)
    dists = torch.where(valid, dists, torch.inf)
    top_d, pos = topk_smallest(dists, k)
    top_ids = torch.gather(cand_ids, 1, pos)
    filled = torch.isfinite(top_d)
    return torch.where(filled, top_ids, -1), torch.where(filled, top_d, torch.inf)


def query(index: SCIndex, queries, cfg: SCConfig, *, k: int | None = None):
    """Paper Algorithm 6: returns (ids (Q, k), sq_dists (Q, k))."""
    ids, dists, _stats = query_with_stats(index, queries, cfg, k=k)
    return ids, dists


def query_with_stats(index: SCIndex, queries, cfg: SCConfig, *, k: int | None = None,
                     exclude: torch.Tensor | None = None):
    """Alg. 6 with diagnostics; ``k`` overrides ``cfg.k`` per call.

    ``exclude`` (masked-full only) is an exclusion bitmap
    (:func:`repro_torch.kernels.masked_rerank.pack_exclusion`) on the
    index's device: those points are never returned, while the histogram,
    the threshold and ``candidate_count`` still count them. A mutable
    index passes its tombstones here."""
    k = cfg.k if k is None else int(k)
    queries = torch.as_tensor(queries, dtype=torch.float32).to(index.device)
    if resolve_rerank(cfg) == "masked_full":
        return _query_masked_full(index, queries, cfg, k, exclude)
    if exclude is not None:
        raise ValueError("exclude is supported by the masked_full pipeline only")
    sc, stats = compute_sc_scores(index, queries, cfg)
    # floor the cap at the runtime k so large-k overrides stay servable
    cap = min(index.n, max(cfg.cap_for(index.n), k))
    with stage("taco.select", queries.device):
        cand_ids, valid, thresh, count = select_candidates(
            sc, float(cfg.beta * index.n), cfg.n_subspaces, cap, mode=cfg.selection)
    with stage("taco.rerank", queries.device):
        ids, dists = rerank(index.data, queries, cand_ids, valid, k, data_norms_of(index))
    stats.update(
        sc_threshold=thresh,
        candidate_count=torch.clamp_max(count, cap),  # actually re-ranked
        candidate_demand=count,  # Alg. 5 demand before the clamp
        truncated=count > cap,  # strictly: count == cap drops nothing
        sc=sc,
    )
    return ids, dists, stats


def _query_masked_full(index: SCIndex, queries: torch.Tensor, cfg: SCConfig, k: int,
                       exclude: torch.Tensor | None = None):
    """Streaming two-pass query: pass 1 histograms the SC-scores, Alg. 5
    (or the fixed budget) reads the threshold off the histogram, pass 2
    re-ranks every point at or above it with a running top-k. The
    collision table is built once and read by both passes.

    Stats keys as in ``repro``: taus, retrieved, sc_threshold,
    candidate_count (== candidate_demand, nothing is clamped), truncated."""
    impl = "auto" if cfg.use_kernels else "torch"
    d1s, d2s, cells, taus, retrieved = _collision_inputs(index, queries, cfg)
    dev = queries.device
    with stage("taco.collide", dev):
        bits = collision_bits(collision_table(d1s, d2s, taus))
    q = queries.shape[0]
    with stage("taco.select", dev):
        hist = ops.schist(bits, cells, cfg.n_subspaces + 1, q=q, impl=impl)
        beta_n = float(cfg.beta * index.n)
        if cfg.selection == "query_aware":
            thresh, demand = query_aware_threshold(hist, beta_n, cfg.n_subspaces)
        elif cfg.selection == "fixed":
            thresh, demand = fixed_threshold_from_hist(hist, beta_n, index.n)
        else:
            raise ValueError(f"unknown selection mode {cfg.selection!r}")
    with stage("taco.rerank", dev):
        ids, dists = ops.masked_rerank(
            bits, cells, thresh, index.data, data_norms_of(index), queries, k,
            impl=impl, precision=cfg.precision, exclude=exclude,
        )
    stats = {
        "taus": taus,
        "retrieved": retrieved,
        "sc_threshold": thresh,
        "candidate_count": demand,
        "candidate_demand": demand,
        "truncated": torch.zeros(q, dtype=torch.bool, device=queries.device),
    }
    return ids, dists, stats
