"""`AnnIndex` — the ANN facade of the port (``repro.ann.index``)::

    from repro_torch.ann import AnnIndex
    from repro_torch.core.config import taco_config

    index = AnnIndex.build(data, taco_config(k=10))
    ids, dists = index.search(queries)               # gather re-rank
    ids, dists, stats = index.search_with_stats(queries, k=100, rerank="masked_full")

The index lives on the card unless ``device="cpu"`` is asked for; results
come back as tensors on the index's device. Save/load, the searcher cache,
the serving engine and mutation are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.config import SCConfig
from repro_torch.core.taco import SCIndex
from repro_torch.core.taco import build as _build
from repro_torch.core.taco import query_with_stats


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

    def _effective(self, k, beta, rerank) -> tuple[int, SCConfig]:
        cfg = self.cfg
        if beta is not None and float(beta) != cfg.beta:
            cfg = dataclasses.replace(cfg, beta=float(beta))
        if rerank is not None and rerank != cfg.rerank:
            cfg = dataclasses.replace(cfg, rerank=rerank)
        return cfg.k if k is None else int(k), cfg

    def search_with_stats(self, queries, *, k=None, beta=None, rerank=None):
        """``(ids (Q, k), sq_dists (Q, k), stats)``; a single (d,) query
        returns (k,) results and scalar stats."""
        k, cfg = self._effective(k, beta, rerank)
        q = torch.as_tensor(queries, dtype=torch.float32)
        single = q.dim() == 1
        if single:
            q = q[None]
        ids, dists, stats = query_with_stats(self.sc_index, q, cfg, k=k)
        if single:
            ids, dists = ids[0], dists[0]
            stats = {name: s[..., 0] if name in ("taus", "retrieved") else s[0]
                     for name, s in stats.items()}
        return ids, dists, stats

    def search(self, queries, *, k=None, beta=None, rerank=None):
        """``(ids (Q, k), sq_dists (Q, k))`` — see :meth:`search_with_stats`."""
        ids, dists, _stats = self.search_with_stats(queries, k=k, beta=beta, rerank=rerank)
        return ids, dists

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
