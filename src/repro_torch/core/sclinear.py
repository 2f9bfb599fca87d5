"""SC-Linear (paper §2.3), the index-free subspace-collision baseline
(mirrors ``repro.core.sclinear``).

Collisions are counted from *exact* per-subspace distances (a point
collides iff it is among the query's alpha n nearest inside the subspace),
then the top beta n SC-scorers are re-ranked in the original space. The
alpha n-th smallest distance per query is a value from ``torch.kthvalue``
(the reference's ``lax.top_k(-d, alpha n)[0][:, -1]``, without a sort).

Every (Q, n) matrix is 4 GB at 10^6 points and 1000 queries, so queries run
in chunks of at most :data:`CHUNK_BYTES` of working set; each query's answer is
computed alone, so the chunking changes no result. Plain torch throughout:
the reference reaches no Pallas kernel here either.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.config import SCConfig
from repro_torch.core.selection import select_candidates
from repro_torch.core.taco import _sub_slices, rerank, suco_dim_partition
from repro_torch.utils import pairwise_sq_dists, resolve_device

#: bytes of (chunk, n) score matrices, or of gathered (chunk, cap, d)
#: candidate rows, a query chunk may hold
CHUNK_BYTES = 2 << 30


def sclinear_sc_scores(data: torch.Tensor, queries: torch.Tensor, sub_dims, dim_perm,
                       alpha: float, *, permuted: bool = False) -> torch.Tensor:
    """Exact collision counting: SC (Q, n) int32. ``permuted`` says that
    ``data`` already has its columns in ``dim_perm``'s order."""
    n = data.shape[0]
    alpha_n = max(1, int(round(alpha * n)))
    perm = torch.as_tensor(dim_perm, device=queries.device).long()
    pdata = data if permuted else data[:, perm]
    pq = queries[:, perm]
    sc = torch.zeros((queries.shape[0], n), dtype=torch.int32, device=queries.device)
    for lo, hi in _sub_slices(sub_dims):
        d = pairwise_sq_dists(pq[:, lo:hi], pdata[:, lo:hi])  # (Q, n)
        kth = torch.kthvalue(d, alpha_n, dim=1).values  # the alpha_n-th smallest
        sc += d <= kth[:, None]
        del d
    return sc


class SCLinear:
    """Holds the dataset on ``device`` (the card by default), its columns in
    the SuCo dimension partition's order, and the partition."""

    def __init__(self, data, cfg: SCConfig, *, device: str | torch.device = "cuda"):
        self.cfg = cfg
        dev = resolve_device(device)
        self.data = torch.as_tensor(data, dtype=torch.float32).to(dev).contiguous()
        rng = np.random.default_rng(cfg.seed)
        perm, self.sub_dims = suco_dim_partition(self.data.shape[1], cfg.n_subspaces, rng)
        self.dim_perm = torch.as_tensor(perm, device=dev)
        self._pdata = self.data[:, self.dim_perm.long()].contiguous()

    def _query_chunk(self, queries: torch.Tensor):
        cfg, n = self.cfg, self.data.shape[0]
        sc = sclinear_sc_scores(self._pdata, queries, self.sub_dims, self.dim_perm,
                                cfg.alpha, permuted=True)
        cand_ids, valid, _t, _c = select_candidates(
            sc, float(cfg.beta * n), cfg.n_subspaces, cfg.cap_for(n), mode=cfg.selection)
        del sc
        return rerank(self.data, queries, cand_ids, valid, cfg.k)

    def query(self, queries):
        """(ids (Q, k) int32, sq_dists (Q, k) float32)."""
        queries = torch.as_tensor(queries, dtype=torch.float32).to(self.data.device)
        n, d = self.data.shape
        per_query = max(4 * n * 4, 3 * self.cfg.cap_for(n) * d * 4)
        rows = max(1, CHUNK_BYTES // per_query)
        parts = [self._query_chunk(queries[lo:lo + rows])
                 for lo in range(0, queries.shape[0], rows)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
