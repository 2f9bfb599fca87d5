"""Searchers: placement and the ``(bucket, k, cfg)`` query-function cache
(mirrors ``repro.ann.searcher``).

A :class:`Searcher` turns a built :class:`SCIndex` into cached query
functions. It owns

  * **the function LRU**: one cache keyed ``(bucket, k, cfg)`` with at most
    ``max_cached_fns`` entries; per-call ``k``/``beta``/``rerank`` overrides
    become new keys, and ``compile_counts`` counts how often each key was
    made;
  * **bucketing**: ``search()`` pads a batch up the
    :data:`~repro_torch.batching.ANN_BATCH_BUCKETS` ladder by repeating its
    last row (every row of the query path is independent, so padding cannot
    change a real row's result);
  * **the return contract**: numpy ``ids`` (Q, k) int32 and ``dists``
    (Q, k) float32, and only the O(Q) stats ``truncated`` and
    ``candidate_count``; the (Q, n) SC matrix stays on the device.

Only the single-device placement is ported: a cached entry is a plain
closure over :func:`repro_torch.core.taco.query_with_stats` (the gather
pipeline syncs the host, so there is no CUDA graph to capture yet). The
corpus-sharded placement, the searcher's metrics counters and the kernel
autotune cache are not ported yet.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.batching import ANN_BATCH_BUCKETS, bucket_size, pad_rows
from repro_torch.core.config import SCConfig
from repro_torch.core.taco import SCIndex, query_with_stats


@dataclasses.dataclass
class AnnBatchResult:
    """What :meth:`Searcher.run_padded` returns for one padded batch (one
    row per slot, pad slots included)."""

    ids: np.ndarray  # (B, k) int32
    dists: np.ndarray  # (B, k) float32
    truncated: np.ndarray  # (B,) bool
    candidate_count: np.ndarray  # (B,) int32 re-ranked per query


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
    if not torch.is_tensor(q):
        return torch.from_numpy(pad_rows(q, bucket)).to(device)
    q = q.to(device, torch.float32)
    return torch.cat([q, q[-1:].expand(bucket - q.shape[0], -1)])


class Searcher:
    """Cached-query front end over one placement of an :class:`SCIndex`."""

    def __init__(self, index: SCIndex, cfg: SCConfig | None = None, *,
                 max_cached_fns: int = 64):
        self.index = index
        self.cfg = cfg
        self.max_cached_fns = int(max_cached_fns)
        self._fns: OrderedDict = OrderedDict()  # (bucket, k, cfg) -> callable
        self.compile_counts: dict = {}  # same key -> times made

    def fn_for(self, bucket: int, k: int, cfg: SCConfig):
        """The cached query function for one ``(bucket, k, cfg)`` key (LRU)."""
        key = (bucket, k, cfg)
        if key not in self._fns:
            self._fns[key] = self._compile(bucket, k, cfg)
            self.compile_counts[key] = self.compile_counts.get(key, 0) + 1
            while len(self._fns) > self.max_cached_fns:
                self._fns.popitem(last=False)
        else:
            self._fns.move_to_end(key)
        return self._fns[key]

    def _compile(self, bucket: int, k: int, cfg: SCConfig):
        raise NotImplementedError

    def run_padded(self, bucket: int, k: int, cfg: SCConfig,
                   queries: torch.Tensor) -> AnnBatchResult:
        """Run one already-padded ``(bucket, d)`` float32 query batch that
        lies on the index's device."""
        raise NotImplementedError

    @property
    def dim(self) -> int:
        """Query dimensionality this searcher accepts."""
        return self.index.data.shape[1]

    @property
    def max_k(self) -> int:
        """Largest servable per-request ``k``."""
        return self.index.n

    def probe_corpus(self):
        """(vectors, ids) of the corpus this searcher serves, on the host."""
        data = self.index.data.cpu().numpy()
        return data, np.arange(data.shape[0], dtype=np.int64)

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
        bucket = bucket_size(n_rows, ANN_BATCH_BUCKETS)
        res = self.run_padded(bucket, k, cfg, _padded_on(q, bucket, self.index.device))
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

        def fn(queries):
            ids, dists, stats = query_with_stats(index, queries, cfg, k=k)
            # only the O(Q) stats leave: the (Q, n) SC matrix is dropped here
            return ids, dists, stats["truncated"], stats["candidate_count"]

        return fn

    def run_padded(self, bucket, k, cfg, queries) -> AnnBatchResult:
        ids, dists, truncated, count = self.fn_for(bucket, k, cfg)(queries)
        return AnnBatchResult(
            ids=ids.to(torch.int32).cpu().numpy(),
            dists=dists.to(torch.float32).cpu().numpy(),
            truncated=truncated.cpu().numpy(),
            candidate_count=count.to(torch.int32).cpu().numpy(),
        )


def make_searcher(index: SCIndex, cfg: SCConfig | None = None, placement: str = "auto", *,
                  max_cached_fns: int = 64) -> Searcher:
    """Placement-resolving :class:`Searcher` factory. ``"single"`` runs on
    the index's device; ``"auto"`` resolves to it, since it is the only
    placement ported; ``"sharded"`` is not ported yet and raises."""
    if placement in ("auto", "single"):
        return SingleDeviceSearcher(index, cfg, max_cached_fns=max_cached_fns)
    if placement == "sharded":
        raise NotImplementedError(
            "placement='sharded' (the corpus-sharded searcher) is not ported to "
            "repro_torch yet; use 'single'")
    raise ValueError(f"unknown placement {placement!r} (want 'single', 'sharded' or 'auto')")
