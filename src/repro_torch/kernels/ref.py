"""Plain PyTorch specs of every kernel on the main path (mirrors
``repro.kernels.ref``). They materialize what the kernels stream and are
the ground truth the tests hold the port to."""
from __future__ import annotations

import torch

from repro_torch.utils import pairwise_sq_dists, topk_smallest


def l2dist_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances between rows of x (M, d) and y (N, d)."""
    return pairwise_sq_dists(x, y)


def kmeans_assign_ref(x: torch.Tensor, c: torch.Tensor):
    """(assignments (n,) int32, min squared distance (n,) f32); the first
    index wins ties, as ``jnp.argmin``."""
    d = l2dist_ref(x, c)
    arg = torch.argmin(d, dim=1)
    return arg.to(torch.int32), d.gather(1, arg[:, None])[:, 0]


def scscore_ref(d1s, d2s, a1s, a2s, taus) -> torch.Tensor:
    """SC-scores (Q, n) int32: #subspaces s with
    d1s[s,q,a1s[s,p]] + d2s[s,q,a2s[s,p]] <= taus[s,q]."""
    n_sub = d1s.shape[0]
    sc = torch.zeros((d1s.shape[1], a1s.shape[1]), dtype=torch.int32, device=d1s.device)
    for s in range(n_sub):
        sums = d1s[s][:, a1s[s].long()] + d2s[s][:, a2s[s].long()]
        sc = sc + (sums <= taus[s][:, None]).to(torch.int32)
    return sc


def schist_ref(d1s, d2s, a1s, a2s, taus, n_levels: int) -> torch.Tensor:
    """Per-query SC-score histogram (Q, n_levels) int32 over all points."""
    sc = scscore_ref(d1s, d2s, a1s, a2s, taus)
    return torch.stack(
        [torch.sum(sc == lvl, dim=1) for lvl in range(n_levels)], dim=1
    ).to(torch.int32)


def masked_rerank_ref(d1s, d2s, a1s, a2s, taus, thresh, queries, data,
                      data_norms, k: int):
    """Masked full re-rank spec: exact distances of every point with
    SC >= thresh, top-k smallest (distance-major, id-minor; id -1 / +inf
    where fewer than k points pass)."""
    sc = scscore_ref(d1s, d2s, a1s, a2s, taus)
    q = queries.to(torch.float32)
    x = data.to(torch.float32)
    qn = torch.sum(q * q, dim=1, keepdim=True)
    dist = torch.clamp_min(qn - 2.0 * (q @ x.T) + data_norms[None, :], 0.0)
    dist = torch.where(sc >= thresh[:, None], dist, torch.inf)
    top_d, ids = topk_smallest(dist, k)
    ids = torch.where(torch.isfinite(top_d), ids, -1)
    vecs = data[ids.clamp_min(0)]
    diff = vecs - queries[:, None, :]
    exact = torch.where(ids >= 0, torch.sum(diff * diff, dim=-1), torch.inf)
    return ids.to(torch.int32), exact


def flash_attention_ref(q, k, v, causal: bool = True) -> torch.Tensor:
    """Softmax attention oracle, q (BH, S, hd), k/v (BH, T, hd): float32
    scores masked to -1e30 above the diagonal (top-left aligned), softmax,
    P.V in float32, cast back to q's dtype."""
    s = torch.einsum("bsd,btd->bst", q.to(torch.float32), k.to(torch.float32))
    s = s * (q.shape[-1] ** -0.5)
    if causal:
        keep = (torch.arange(k.shape[1], device=q.device)[None, :]
                <= torch.arange(q.shape[1], device=q.device)[:, None])
        s = torch.where(keep, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bst,btd->bsd", p, v.to(torch.float32)).to(q.dtype)
