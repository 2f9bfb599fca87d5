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


def _f32_sort_key(x: torch.Tensor) -> torch.Tensor:
    """Monotone bijection f32 -> [0, 2^32) as int64 (IEEE-754 total order):
    non-negative floats map to ``bits | 0x80000000``, negative ones to
    ``~bits``."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(b >= 0x80000000, 0xFFFFFFFF - b, b | 0x80000000)


def _f32_from_key(key: torch.Tensor) -> torch.Tensor:
    b = torch.where(key >= 0x80000000, key - 0x80000000, 0xFFFFFFFF - key)
    b = torch.where(b >= 0x80000000, b - 0x100000000, b)
    return b.to(torch.int32).view(torch.float32)


def sort_activation_ref(d1, d2, sizes, alpha_n):
    """Sort-order activation (SDA), batched. d1, d2: (..., sqrt_k) centroid
    distances; sizes: (..., sqrt_k, sqrt_k) cell sizes broadcastable to the
    batch. Returns (tau (...,), retrieved (...,)) f32.

    tau is the minimal sum value s with ``W(s) = sum(sizes[sums <= s]) >=
    target``, found by bisection on the key lattice; ``retrieved`` replays
    the stable enumeration of the tie group ``sums == tau`` in index order.
    Every weight sum is of integer counts below 2^24, so it is exact in f32
    whatever the summation order."""
    sums = (d1[..., :, None] + d2[..., None, :]).flatten(-2)  # (..., K2)
    sz = sizes.flatten(-2).to(torch.float32)  # (..., K2)
    alpha = torch.tensor(alpha_n, dtype=torch.float32, device=sums.device)
    target = torch.minimum(alpha, torch.sum(sz, dim=-1))
    target = target.expand(sums.shape[:-1])
    keys = _f32_sort_key(sums)
    lo = torch.amin(keys, dim=-1)
    hi = torch.amax(keys, dim=-1)
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        w = torch.sum(torch.where(keys <= mid[..., None], sz, 0.0), dim=-1)
        ok = w >= target
        lo, hi = torch.where(ok, lo, mid + 1), torch.where(ok, mid, hi)
    tau = _f32_from_key(lo)
    at_tau = sums == tau[..., None]
    below = torch.sum(torch.where(sums < tau[..., None], sz, 0.0), dim=-1)
    csum = below[..., None] + torch.cumsum(torch.where(at_tau, sz, 0.0), dim=-1)
    hit = ((csum >= target[..., None]) & at_tau).to(torch.uint8)
    cut = torch.argmax(hit, dim=-1)
    return tau, torch.gather(csum, -1, cut[..., None])[..., 0]


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
