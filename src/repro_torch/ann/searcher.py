"""Searchers: placement and the ``(bucket, k, cfg)`` query-function cache
(mirrors ``repro.ann.searcher``).

A :class:`Searcher` turns a built :class:`SCIndex` into cached query
functions. It owns

  * **the function LRU**: one cache keyed ``(bucket, k, cfg)`` with at most
    ``max_cached_fns`` entries; per-call ``k``/``beta``/``rerank`` overrides
    become new keys, and ``compile_counts`` counts how often each key was
    made;
  * **bucketing**: ``search()`` pads a batch up the searcher's ``buckets``
    (default :data:`~repro_torch.batching.ANN_BATCH_BUCKETS`) by repeating its
    last row (every row of the query path is independent, so padding cannot
    change a real row's result);
  * **the return contract**: numpy ``ids`` (Q, k) int32 and ``dists``
    (Q, k) float32, and only the O(Q) stats ``truncated`` and
    ``candidate_count``; the (Q, n) SC matrix stays on the device.

The serving engine's backends (:mod:`repro_torch.serving.ann_engine`) and
direct :meth:`Searcher.search` calls both run a padded batch through
:meth:`Searcher.run_padded`.

Two placements, as in the reference: :class:`SingleDeviceSearcher`, whose
cached entry is a plain closure over
:func:`repro_torch.core.taco.query_with_stats` (the gather pipeline syncs
the host, so there is no CUDA graph to capture yet), and
:class:`ShardedSearcher`, whose entry is a closure over
:func:`repro_torch.core.distributed.make_distributed_query_with_stats` on
shard views placed once. The function cache counts into the reference's
metric families (``taco_searcher_compiles_total``,
``taco_searcher_fn_cache_hits_total``) on the port's own registry.
``autotune_cache=`` warm-loads a :func:`repro_torch.kernels.autotune.
save_cache` file (of either package) once, at construction, so the first
batch launches ``schist`` and ``masked_rerank`` with the tuned (bq, bn);
``autotune_entries_loaded`` and the gauge
``taco_searcher_autotune_entries_loaded`` count its entries.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.batching import ANN_BATCH_BUCKETS, bucket_size, pad_rows
from repro_torch.core import distributed
from repro_torch.core.config import SCConfig, resolve_rerank
from repro_torch.core.taco import SCIndex, query_with_stats
from repro_torch.kernels import autotune
from repro_torch.obs import metrics as obsm
from repro_torch.obs.trace import settle_stages, stage

# Process-wide searcher metric families (repro_torch.obs registry): the
# function cache's behaviour across every searcher instance.
_M_COMPILES = obsm.counter(
    "taco_searcher_compiles_total",
    "Query executables compiled (one per new (bucket, k, cfg) key)",
)
_M_FN_HITS = obsm.counter(
    "taco_searcher_fn_cache_hits_total",
    "Executable-cache hits (batch reused a compiled query fn)",
)
_M_AUTOTUNE = obsm.gauge(
    "taco_searcher_autotune_entries_loaded",
    "Autotune (bq, bn) winners warm-loaded at searcher construction",
)


@dataclasses.dataclass
class AnnBatchResult:
    """What :meth:`Searcher.run_padded` returns for one padded batch (one
    row per slot, pad slots included)."""

    ids: np.ndarray  # (B, k) int32
    dists: np.ndarray  # (B, k) float32
    truncated: np.ndarray  # (B,) bool
    candidate_count: np.ndarray  # (B,) int32 re-ranked per query
    shard_candidates: np.ndarray | None = None  # (B, S) int32 (sharded placement)
    shard_truncated: np.ndarray | None = None  # (B, S) bool (sharded placement)


def effective_query_params(cfg: SCConfig, k=None, beta=None, rerank=None
                           ) -> tuple[int, SCConfig]:
    """Resolve per-call ``k``/``beta``/``rerank`` overrides to the concrete
    ``(k, cfg)`` pair that keys the cache."""
    if beta is not None and float(beta) != cfg.beta:
        cfg = dataclasses.replace(cfg, beta=float(beta))
    if rerank is not None and rerank != cfg.rerank:
        cfg = dataclasses.replace(cfg, rerank=rerank)
    return cfg.k if k is None else int(k), cfg


def _padded_on(q, bucket: int, device) -> torch.Tensor:
    """(n, d) queries padded to ``bucket`` rows by repeating the last row
    (:func:`pad_rows`' rule), as float32 on ``device``. A tensor is padded on
    its way there, never through the host."""
    with stage("searcher.pad", device):
        if not torch.is_tensor(q):
            return torch.from_numpy(pad_rows(q, bucket)).to(device)
        q = q.to(device, torch.float32)
        return torch.cat([q, q[-1:].expand(bucket - q.shape[0], -1)])


def warm_load_autotune(autotune_cache: str | None) -> int:
    """Seed the process-wide (bq, bn) winner cache from a saved file, so the
    first batch neither searches nor defaults; returns the entries loaded
    (0 without a file) and sets the gauge. Called once, at construction,
    before any lock exists."""
    if autotune_cache is None:
        return 0
    loaded = autotune.load_cache(autotune_cache)
    _M_AUTOTUNE.set(loaded)
    return loaded


def sq_dists_to(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(m,) squared distances of ``rows`` (m, d) to one query ``q`` (d,) in
    the difference form of the reference's recall probe
    (``einsum("md,md->m", diff, diff)``)."""
    diff = rows - q[None, :]
    return torch.sum(diff * diff, dim=1)


def first_by_distance(dist: torch.Tensor, ids: torch.Tensor, k: int) -> np.ndarray:
    """The ``k`` ids of the smallest ``dist`` on the host, ties to the lower
    position: ``np.lexsort((ids, dist))``'s order where ``ids`` ascend."""
    return ids[torch.sort(dist, stable=True).indices[:k]].cpu().numpy()


class Searcher:
    """Cached-query front end over one placement of an :class:`SCIndex`."""

    #: data shards the corpus is split over (1 = no sharding)
    shards: int = 1

    def __init__(self, index: SCIndex, cfg: SCConfig | None = None, *,
                 max_cached_fns: int = 64, buckets=ANN_BATCH_BUCKETS,
                 autotune_cache: str | None = None):
        self.index = index
        self.cfg = cfg
        self.max_cached_fns = int(max_cached_fns)
        self.autotune_entries_loaded = warm_load_autotune(autotune_cache)
        self.buckets = tuple(buckets)
        self._fns: OrderedDict = OrderedDict()  # (bucket, k, cfg) -> callable
        self.compile_counts: dict = {}  # same key -> times made

    def fn_for(self, bucket: int, k: int, cfg: SCConfig):
        """The cached query function for one ``(bucket, k, cfg)`` key (LRU)."""
        key = (bucket, k, cfg)
        if key not in self._fns:
            self._fns[key] = self._compile(bucket, k, cfg)
            self.compile_counts[key] = self.compile_counts.get(key, 0) + 1
            _M_COMPILES.inc()
            while len(self._fns) > self.max_cached_fns:
                self._fns.popitem(last=False)
        else:
            self._fns.move_to_end(key)
            _M_FN_HITS.inc()
        return self._fns[key]

    def _compile(self, bucket: int, k: int, cfg: SCConfig):
        raise NotImplementedError

    def run_padded(self, bucket: int, k: int, cfg: SCConfig,
                   queries: torch.Tensor) -> AnnBatchResult:
        """Run one already-padded ``(bucket, d)`` float32 query batch that
        lies on the index's device."""
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        """Device the padded query batch is placed on."""
        return self.index.device

    @property
    def dim(self) -> int:
        """Query dimensionality this searcher accepts."""
        return self.index.data.shape[1]

    @property
    def max_k(self) -> int:
        """Largest servable per-request ``k``."""
        return self.index.n

    def extra_telemetry(self) -> dict:
        """Searcher-specific keys merged into the engine's telemetry()."""
        return {}

    def probe_corpus(self):
        """(vectors, ids) of the corpus this searcher serves, on the host."""
        data = self.index.data.cpu().numpy()
        return data, np.arange(data.shape[0], dtype=np.int64)

    def probe_topk(self, query, k: int) -> np.ndarray | None:
        """What a recall probe scores against: the ids of the exact top-k of
        one ``query`` (d,) over the corpus this searcher serves, ordered by
        (squared distance, id), or None for an empty corpus. Computed on the
        index's device; only the ids come to the host, never the corpus."""
        data = self.index.data
        if data.shape[0] == 0:
            return None
        q = torch.from_numpy(np.asarray(query, np.float32)).to(data.device)
        ids = torch.arange(data.shape[0], device=data.device)
        return first_by_distance(sq_dists_to(data, q), ids, min(k, data.shape[0]))

    def _effective(self, k, beta, rerank) -> tuple[int, SCConfig]:
        if self.cfg is None:
            raise ValueError(
                "this Searcher was built without a default SCConfig; "
                "construct it with cfg=... (AnnIndex.searcher does)")
        return effective_query_params(self.cfg, k, beta, rerank)

    def search_with_stats(self, queries, *, k=None, beta=None, rerank=None):
        """``(ids (Q, k), sq_dists (Q, k), stats)`` as numpy arrays; ``stats``
        holds ``truncated`` (Q,) and ``candidate_count`` (Q,). A single (d,)
        query returns (k,) results and scalar stats. ``queries`` may be a
        numpy array or a tensor on any device (padded on the way to the
        index's device, not through the host)."""
        k, cfg = self._effective(k, beta, rerank)
        q = queries.detach() if torch.is_tensor(queries) else np.asarray(queries, np.float32)
        single = q.ndim == 1
        if single:
            q = q[None]
        n_rows = q.shape[0]
        bucket = bucket_size(n_rows, self.buckets)
        with stage("searcher.batch", self.device):
            res = self.run_padded(bucket, k, cfg, _padded_on(q, bucket, self.device))
        stats = {"truncated": res.truncated[:n_rows],
                 "candidate_count": res.candidate_count[:n_rows]}
        ids, dists = res.ids[:n_rows], res.dists[:n_rows]
        if single:
            ids, dists = ids[0], dists[0]
            stats = {name: s[0] for name, s in stats.items()}
        return ids, dists, stats

    def search(self, queries, *, k=None, beta=None, rerank=None):
        """``(ids (Q, k), sq_dists (Q, k))``; see :meth:`search_with_stats`."""
        ids, dists, _stats = self.search_with_stats(queries, k=k, beta=beta, rerank=rerank)
        return ids, dists


class SingleDeviceSearcher(Searcher):
    """Execution on the index's device: cached closures over
    :func:`query_with_stats`."""

    def _compile(self, bucket: int, k: int, cfg: SCConfig):
        index = self.index

        def fn(queries, exclude=None):
            ids, dists, stats = query_with_stats(index, queries, cfg, k=k, exclude=exclude)
            # only the O(Q) stats leave: the (Q, n) SC matrix is dropped here
            return ids, dists, stats["truncated"], stats["candidate_count"]

        return fn

    def run_padded_device(self, bucket, k, cfg, queries, *, exclude=None):
        """:meth:`run_padded` with the results left on the index's device:
        (ids, dists, truncated, candidate_count) tensors. ``exclude``: a
        masked-full exclusion bitmap, see
        :func:`repro_torch.core.taco.query_with_stats`."""
        return self.fn_for(bucket, k, cfg)(queries, exclude)

    def run_padded(self, bucket, k, cfg, queries) -> AnnBatchResult:
        ids, dists, truncated, count = self.run_padded_device(bucket, k, cfg, queries)
        with stage("searcher.to_host", self.device):
            res = AnnBatchResult(
                ids=ids.to(torch.int32).cpu().numpy(),
                dists=dists.to(torch.float32).cpu().numpy(),
                truncated=truncated.cpu().numpy(),
                candidate_count=count.to(torch.int32).cpu().numpy(),
            )
        settle_stages(batch=True)
        return res


def _no_axes(data_axes, query_axes) -> None:
    """Refuse mesh axes the port has no counterpart for: the data axis is
    the list of shard devices, and queries are replicated (the reference's
    default). Query sharding changes where rows run, never a result."""
    if data_axes not in (None, ("data",), ["data"]) or tuple(query_axes) != ():
        raise NotImplementedError(
            f"data_axes={data_axes!r} query_axes={query_axes!r}: repro_torch shards "
            "the corpus over one list of devices (data_axes None or ('data',)) and "
            "replicates the queries (query_axes=())")


def _device_count(index: SCIndex) -> int:
    """Devices the ``"auto"`` placement may spread the corpus over: the
    visible cards for an index on the card, 1 for an index on the CPU."""
    return torch.cuda.device_count() if index.device.type == "cuda" else 1


class ShardedSearcher(Searcher):
    """Corpus-sharded execution through :mod:`repro_torch.core.distributed`.

    The built index is placed ONCE as S shard views
    (:func:`~repro_torch.core.distributed.shard_views`); each ``(bucket, k,
    cfg)`` key makes a
    :func:`~repro_torch.core.distributed.make_distributed_query_with_stats`
    closure over them. ``mesh`` is a sequence of torch devices, one per data
    shard (the counterpart of a 1-D data mesh); without it the ``shards``
    views (default: the visible devices, see :func:`make_searcher`) all
    live on the index's device, so on one card they are row views of the
    corpus, not copies. A mesh of several cards takes the same path but is
    unverified (the port has been run on one H100 only). Queries are replicated,
    and the combine moves only (Q, shards*k) id/dist pairs per batch.
    """

    def __init__(self, index: SCIndex, cfg: SCConfig | None = None, *, mesh=None,
                 shards: int | None = None, data_axes=None, query_axes=(),
                 max_cached_fns: int = 64, buckets=ANN_BATCH_BUCKETS,
                 autotune_cache: str | None = None):
        super().__init__(index, cfg, max_cached_fns=max_cached_fns, buckets=buckets,
                         autotune_cache=autotune_cache)
        _no_axes(data_axes, query_axes)
        if mesh is None:
            shards = _device_count(index) if shards is None else int(shards)
            if shards < 1:
                raise ValueError(f"shards={shards} must be >= 1")
            mesh = (index.device,) * shards
        elif shards is not None:
            raise ValueError(
                "pass either mesh or shards, not both: with an explicit mesh "
                "the shard count is its number of devices")
        self.mesh = tuple(torch.device(d) for d in mesh)
        self.data_axes = ("data",)
        self.query_axes = ()
        self.shards = len(self.mesh)
        self.views, _n = distributed.shard_views(index, self.shards, self.mesh)

    def _compile(self, bucket: int, k: int, cfg: SCConfig):
        return distributed.make_distributed_query_with_stats(
            self.views, cfg, self.index, self.index.n, k=k)

    def run_padded(self, bucket, k, cfg, queries) -> AnnBatchResult:
        ids, dists, stats = self.fn_for(bucket, k, cfg)(queries)
        with stage("searcher.to_host", self.device):
            shard_candidates = stats["shard_candidates"].cpu().numpy()
            shard_truncated = stats["shard_truncated"].cpu().numpy()
            ids = ids.to(torch.int32).cpu().numpy()
            dists = dists.to(torch.float32).cpu().numpy()
        settle_stages(batch=True)
        # shard_candidates is the pre-clamp per-shard DEMAND; clamp each
        # shard at its static gather cap so candidate_count keeps the
        # single-device meaning ('actually re-ranked') on either placement.
        # The masked-full pipeline has no cap (count == demand).
        if resolve_rerank(cfg, distributed=True) == "gather":
            cap = distributed.per_shard_cap(cfg, self.index.n // self.shards, k)
            count = np.minimum(shard_candidates, cap).sum(axis=1)
        else:
            count = shard_candidates.sum(axis=1)
        return AnnBatchResult(
            ids=ids,
            dists=dists,
            truncated=shard_truncated.any(axis=1),
            candidate_count=count.astype(np.int32),
            shard_candidates=shard_candidates,
            shard_truncated=shard_truncated,
        )


def make_searcher(index: SCIndex, cfg: SCConfig | None = None, placement: str = "auto", *,
                  mesh=None, shards: int | None = None, data_axes=None, query_axes=(),
                  max_cached_fns: int = 64, autotune_cache: str | None = None) -> Searcher:
    """Placement-resolving :class:`Searcher` factory.

    ``placement``:
      * ``"single"``: the index's device; ``mesh``/``shards`` rejected.
      * ``"sharded"``: corpus-sharded over ``mesh`` (a sequence of devices)
        or into ``shards`` views on the index's device (default: as many as
        there are visible devices).
      * ``"auto"``: ``"sharded"`` when a mesh or a shard count above 1 is
        asked for, or when several devices are visible (the cards, for an
        index on the card; one, for an index on the CPU) and the corpus
        splits evenly over them; ``"single"`` otherwise.
    """
    if placement == "auto":
        if mesh is not None or (shards is not None and shards > 1):
            placement = "sharded"
        else:
            n_dev = _device_count(index)
            placement = ("sharded" if n_dev > 1 and index.n % n_dev == 0 and shards is None
                         else "single")
    if placement == "single":
        if mesh is not None or (shards is not None and shards > 1):
            raise ValueError(
                f"mesh/shards are only consumed by placement='sharded', got "
                f"placement='single' with mesh={mesh!r} shards={shards!r}")
        return SingleDeviceSearcher(index, cfg, max_cached_fns=max_cached_fns,
                                    autotune_cache=autotune_cache)
    if placement == "sharded":
        return ShardedSearcher(index, cfg, mesh=mesh, shards=shards, data_axes=data_axes,
                               query_axes=query_axes, max_cached_fns=max_cached_fns,
                               autotune_cache=autotune_cache)
    raise ValueError(f"unknown placement {placement!r} (want 'single', 'sharded' or 'auto')")
