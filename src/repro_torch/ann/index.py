"""`AnnIndex` — the ANN facade of the port (``repro.ann.index``)::

    from repro_torch.ann import AnnIndex
    from repro_torch.core.config import taco_config

    index = AnnIndex.build(data, taco_config(k=10))  # on the card
    index.save("idx/")                               # atomic npz + manifest
    index = AnnIndex.load("idx/")                    # bitwise-identical
    ids, dists = index.search(queries)               # gather re-rank
    ids, dists, stats = index.search_with_stats(queries, k=100, rerank="masked_full")
    s = index.searcher()                             # owns the function cache
    s = index.searcher("sharded", shards=4)          # corpus-sharded placement
    engine = index.engine(async_mode=True)           # AnnServingEngine over a searcher
    mutable = index.mutable()                        # inserts, deletes, compaction

The index lives on the card unless ``device="cpu"`` is asked for. Search
returns what the reference returns: numpy ``ids`` (Q, k) int32 and
``dists`` (Q, k) float32, and the stats ``truncated`` and
``candidate_count``; :func:`repro_torch.core.taco.query_with_stats` keeps
every internal stat. The directory format is the reference's, so an index
saved by either package loads in the other. Mutation (delta segment,
tombstones, write-ahead log, compaction) lives in
:mod:`repro_torch.ann.mutable`, serving in
:mod:`repro_torch.serving.ann_engine`, corpus-sharded placement in
:mod:`repro_torch.core.distributed`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.ann.persistence import load_index, save_index
from repro_torch.ann.searcher import Searcher, make_searcher
from repro_torch.core.config import SCConfig
from repro_torch.core.taco import SCIndex
from repro_torch.core.taco import build as _build


@dataclasses.dataclass
class AnnIndex:
    """A built subspace-collision index plus the config it was built with.

    ``cfg`` is the default query configuration; per-call ``k``/``beta``/
    ``rerank`` arguments override it without rebuilding anything."""

    sc_index: SCIndex
    cfg: SCConfig

    @classmethod
    def build(cls, data, cfg: SCConfig, *, device: str | torch.device = "cuda") -> "AnnIndex":
        """Build an index over ``data`` (n, d) on ``device`` — paper
        Algorithm 3 (plus Alg. 1/2 when ``cfg.transform == 'entropy'``)."""
        return cls(sc_index=_build(data, cfg, device=device), cfg=cfg)

    def save(self, path: str) -> str:
        """Persist index + config under directory ``path`` (atomic)."""
        return save_index(self.sc_index, self.cfg, path)

    @classmethod
    def load(cls, path: str, *, device: str | torch.device = "cuda") -> "AnnIndex":
        """Load an index saved by :meth:`save` (or by ``repro``) onto
        ``device``. Search results over the loaded index are bitwise
        identical to the index that was saved."""
        sc_index, cfg = load_index(path, device=device)
        return cls(sc_index=sc_index, cfg=cfg)

    def searcher(self, placement: str = "auto", *, mesh=None, shards: int | None = None,
                 data_axes=None, query_axes=(), max_cached_fns: int = 64,
                 cfg: SCConfig | None = None, autotune_cache: str | None = None) -> Searcher:
        """A :class:`Searcher` over this index that owns device placement
        and the ``(bucket, k, cfg)`` function cache; ``cfg`` replaces the
        index's default config as the searcher's. See
        :func:`repro_torch.ann.searcher.make_searcher` for ``placement``,
        ``mesh`` (a sequence of devices) and ``shards``."""
        return make_searcher(self.sc_index, self.cfg if cfg is None else cfg, placement,
                             mesh=mesh, shards=shards, data_axes=data_axes,
                             query_axes=query_axes, max_cached_fns=max_cached_fns,
                             autotune_cache=autotune_cache)

    def engine(self, placement: str = "auto", *, mesh=None, shards: int | None = None,
               max_cached_fns: int = 64, cfg: SCConfig | None = None, **engine_kwargs):
        """An :class:`~repro_torch.serving.ann_engine.AnnServingEngine`
        serving this index: micro-batching, per-request overrides, result
        cache, telemetry. Its backend is a thin adapter over a
        :meth:`searcher` built here for ``placement`` (same ``"auto"``
        default and resolution as :meth:`searcher`); ``cfg`` replaces the
        index's default config for the engine and its searcher."""
        from repro_torch.serving.ann_engine import AnnServingEngine

        eff_cfg = self.cfg if cfg is None else cfg
        searcher = self.searcher(placement, mesh=mesh, shards=shards,
                                 max_cached_fns=max_cached_fns, cfg=eff_cfg)
        return AnnServingEngine(self.sc_index, eff_cfg, backend=searcher, **engine_kwargs)

    def search_with_stats(self, queries, *, k=None, beta=None, rerank=None):
        """``(ids (Q, k), sq_dists (Q, k), stats)`` on a single-device
        searcher cached on the index; see :meth:`Searcher.search_with_stats`."""
        return self._default_searcher().search_with_stats(queries, k=k, beta=beta,
                                                          rerank=rerank)

    def search(self, queries, *, k=None, beta=None, rerank=None):
        """``(ids (Q, k), sq_dists (Q, k))`` — see :meth:`search_with_stats`."""
        return self._default_searcher().search(queries, k=k, beta=beta, rerank=rerank)

    def _default_searcher(self) -> Searcher:
        s = getattr(self, "_searcher", None)
        if s is None:
            s = self._searcher = self.searcher("single")
        return s

    def mutable(self, *, policy=None, **kwargs):
        """Wrap this (immutable) index as the base segment of a
        :class:`~repro_torch.ann.mutable.MutableAnnIndex` on the index's
        device: delta-segment inserts, tombstone deletes and policy-driven
        compaction back into a fresh base. The built index is shared, not
        copied. Durability kwargs (``durability=``, ``wal_dir=``) pass
        through — see :mod:`repro_torch.ann.wal`."""
        from repro_torch.ann.mutable import MutableAnnIndex

        return MutableAnnIndex(self, policy=policy, **kwargs)

    def replace_cfg(self, **changes) -> "AnnIndex":
        """A view of the same built index with config fields replaced."""
        return AnnIndex(sc_index=self.sc_index, cfg=dataclasses.replace(self.cfg, **changes))

    @property
    def n(self) -> int:
        return self.sc_index.n

    @property
    def d(self) -> int:
        return self.sc_index.data.shape[1]

    @property
    def index_bytes(self) -> int:
        """Index memory footprint, excluding the dataset (paper protocol)."""
        return self.sc_index.index_bytes
