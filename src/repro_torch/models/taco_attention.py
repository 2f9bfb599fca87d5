"""TaCo retrieval attention (mirrors ``repro.models.taco_attention``): the
paper's technique as sparse long-context decode (RetrievalAttention /
PQCache style, paper §5.4.3).

Per (layer, kv-head), the cached keys are TaCo-indexed in key space
(head_dim): entropy-averaged eigenbasis -> N_s subspaces -> a K-means IMI
over each subspace's two halves. Each decode step:
  1. transforms the query head into the subspaces,
  2. takes per-subspace taus from sort activation
     (:func:`repro_torch.core.activation.sort_activation`, batched over
     (B, Kv, G, N_s) where the reference nests four ``vmap``s),
  3. scores every cached slot by subspace collisions (one cell-id gather
     and compare per subspace),
  4. selects the top C slots by (SC, -distance proxy), the recent window
     forced in by a key boost; ties go to the lower slot, as in
     ``lax.top_k`` (a stable descending sort),
  5. attends exactly over the C gathered K/V rows.

The index build runs at prefill. Its K-means sums are
:func:`repro_torch.clustering.kmeans.cluster_sums`: rows in order on the
CPU, fixed-order one-hot products on the card, so a prefill on the card
repeats bit for bit. Eigenvector signs are whatever ``torch.linalg.eigh``
returns; a sign flip negates a subspace coordinate in data and centroids
alike and changes no cell.

Exactness (tested): with n_retrieve >= the valid cache length the result
equals full decode attention up to accumulation order. Decode takes one
scalar ``pos`` for the whole batch, as the reference's does; a per-slot
(B,) ``pos`` raises. As in :mod:`repro_torch.models.attention`, the caches
and the state's cells and cell sizes are updated in place.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.clustering.kmeans import cluster_sums, new_means
from repro_torch.core.activation import sort_activation
from repro_torch.models.layers import apply_rope, dense, rope_angles
from repro_torch.utils import pairwise_sq_dists

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    n_subspaces: int = 2
    subspace_dim: int = 8  # must be even (split into two IMI halves)
    sqrt_k: int = 64  # sqrt(K) centroids per half
    alpha: float = 0.02  # collision ratio over cached tokens
    n_retrieve: int = 1024  # C — retrieved slots per head
    recent_window: int = 128  # always-attended recency slots
    kmeans_iters: int = 5

    @property
    def m(self) -> int:
        return self.n_subspaces * self.subspace_dim


@dataclasses.dataclass(frozen=True)
class RetrievalState:
    """TaCo index over one layer's KV cache. S = cache capacity. The two
    IMI half-assignments are one cell id, a1 * sqrt_k + a2."""

    mean: torch.Tensor  # (Kv, hd)
    basis: torch.Tensor  # (Kv, hd, m)
    centroids: torch.Tensor  # (Kv, N_s, 2, sqrt_k, s/2)
    cells: torch.Tensor  # (B, Kv, N_s, S) int32: a1 * sqrt_k + a2
    cell_sizes: torch.Tensor  # (B, Kv, N_s, sqrt_k, sqrt_k) int32


def snake_allocation(m: int, n_subspaces: int) -> torch.Tensor:
    """Static boustrophedon allocation: eig ranks -> subspace buckets.
    Returns (m,) int64: position i (descending eigenvalue) maps to column
    order such that bucket j holds columns [j*s, (j+1)*s)."""
    cols = [[] for _ in range(n_subspaces)]
    order = list(range(n_subspaces))
    for rank in range(m):
        rnd, pos = divmod(rank, n_subspaces)
        bucket = order[pos] if rnd % 2 == 0 else order[n_subspaces - 1 - pos]
        cols[bucket].append(rank)
    return torch.tensor([r for bucket in cols for r in bucket], dtype=torch.long)


def _fit_basis(keys_flat: torch.Tensor, rcfg: RetrievalConfig):
    """keys_flat (..., T, hd) -> (mean (..., hd), basis (..., hd, m)): the
    entropy-averaged (snake-allocated) top-m eigenbasis of each key
    covariance."""
    t = keys_flat.shape[-2]
    mean = torch.mean(keys_flat, dim=-2)
    xc = (keys_flat - mean[..., None, :]).to(torch.float32)
    cov = xc.mT @ xc / max(t - 1, 1)
    _eigvals, eigvecs = torch.linalg.eigh(cov)  # ascending
    desc = eigvecs.flip(-1)[..., : rcfg.m]  # (..., hd, m) top-m descending
    alloc = snake_allocation(rcfg.m, rcfg.n_subspaces).to(keys_flat.device)
    return mean, desc[..., alloc]


def _assign(data: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid (lowest index on ties) of each row: data (P, T, sh),
    centroids (P, k, sh) -> (P, T) int64."""
    return torch.argmin(pairwise_sq_dists(data, centroids), dim=-1)


def _lloyd_fixed(data: torch.Tensor, sqrt_k: int, iters: int) -> torch.Tensor:
    """Deterministic K-means over P problems at once: strided-sample init +
    ``iters`` Lloyd steps. data (P, T, sh) -> centroids (P, sqrt_k, sh)."""
    t = data.shape[1]
    stride = max(t // sqrt_k, 1)
    init = (torch.arange(sqrt_k, device=data.device) * stride) % t
    c = data[:, init]
    for _ in range(iters):
        sums, counts = cluster_sums(data, _assign(data, c), sqrt_k)
        c = new_means(sums, counts, c)
    return c


def _subspace_views(tk: torch.Tensor, rcfg: RetrievalConfig) -> torch.Tensor:
    """tk (..., m) -> (..., N_s, 2, s/2) half-split subspace views."""
    return tk.reshape(*tk.shape[:-1], rcfg.n_subspaces, 2, rcfg.subspace_dim // 2)


def build_retrieval_state(keys: torch.Tensor, rcfg: RetrievalConfig) -> RetrievalState:
    """Prefill-time index build. keys (B, S, Kv, hd), all S slots valid."""
    b, s_len, kv, hd = keys.shape
    ns, sqrt_k = rcfg.n_subspaces, rcfg.sqrt_k
    flat = keys.permute(2, 0, 1, 3).reshape(kv, b * s_len, hd)
    mean, basis = _fit_basis(flat, rcfg)

    tk = torch.einsum("ktd,kdm->ktm", flat - mean[:, None, :], basis)  # (Kv, T, m)
    views = _subspace_views(tk, rcfg).permute(0, 2, 3, 1, 4)  # (Kv, N_s, 2, T, sh)
    data = views.reshape(kv * ns * 2, b * s_len, -1)
    centroids = _lloyd_fixed(data, sqrt_k, rcfg.kmeans_iters)  # (Kv*N_s*2, sqrt_k, sh)

    a = _assign(data, centroids).to(torch.int32)
    a = a.reshape(kv, ns, 2, b, s_len).permute(3, 0, 1, 2, 4)  # (B, Kv, N_s, 2, S)
    cell = a[:, :, :, 0] * sqrt_k + a[:, :, :, 1]
    sizes = torch.zeros((b, kv, ns, sqrt_k * sqrt_k), dtype=torch.int32, device=keys.device)
    sizes.scatter_add_(-1, cell.long(), torch.ones_like(cell))
    return RetrievalState(
        mean=mean, basis=basis,
        centroids=centroids.reshape(kv, ns, 2, sqrt_k, -1),
        cells=cell, cell_sizes=sizes.reshape(b, kv, ns, sqrt_k, sqrt_k),
    )


def _transform_heads(x: torch.Tensor, mean: torch.Tensor, basis: torch.Tensor):
    """x (B, Kv, R, hd) with per-kv-head mean/basis -> (B, Kv, R, m)."""
    return torch.einsum("bkrd,kdm->bkrm", x - mean[None, :, None, :], basis)


def _top_c(key: torch.Tensor, c: int) -> torch.Tensor:
    """Indices of the c largest keys along the last axis, largest first,
    ties to the lower index (``lax.top_k``'s order)."""
    return torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :c]


def insert_key(state: RetrievalState, k: torch.Tensor, pos: int, rcfg: RetrievalConfig):
    """Index maintenance, a streaming insert: the new key k (B, 1, Kv, hd)
    assigned to its IMI cell in each subspace, written at ``cells[..., pos]``
    and counted in ``cell_sizes`` (in place)."""
    b, _, n_kv, _ = k.shape
    dev = k.device
    tk_new = _transform_heads(k.transpose(1, 2), state.mean, state.basis)  # (B,Kv,1,m)
    views = _subspace_views(tk_new[:, :, 0], rcfg)  # (B, Kv, N_s, 2, sh)
    d_new = torch.sum(
        (views[:, :, :, :, None, :] - state.centroids[None]) ** 2, dim=-1
    )  # (B, Kv, N_s, 2, sqrt_k)
    a_new = torch.argmin(d_new, dim=-1)  # (B, Kv, N_s, 2)
    a1n, a2n = a_new[..., 0], a_new[..., 1]
    state.cells[..., pos] = (a1n * rcfg.sqrt_k + a2n).to(torch.int32)
    bidx = torch.arange(b, device=dev)[:, None, None]
    kidx = torch.arange(n_kv, device=dev)[None, :, None]
    sidx = torch.arange(rcfg.n_subspaces, device=dev)[None, None, :]
    state.cell_sizes[bidx, kidx, sidx, a1n, a2n] += 1


def select_slots(q: torch.Tensor, state: RetrievalState, pos: int, rcfg: RetrievalConfig,
                 s_max: int):
    """The query-side TaCo over all ``s_max`` cache slots for q (B, 1, H,
    hd): (the top C slots (B, Kv, G, C) by (SC, -distance proxy), the
    recent window forced in, ties to the lower slot; whether each selected
    slot holds a cached token, slot <= pos (B, Kv, G, C))."""
    b, _, n_heads, head_dim = q.shape
    n_kv = state.mean.shape[0]
    g = n_heads // n_kv
    dev = q.device
    # per-subspace centroid distances + activation taus
    tq = _transform_heads(q.reshape(b, n_kv, g, head_dim), state.mean, state.basis)
    qviews = _subspace_views(tq, rcfg)  # (B, Kv, G, N_s, 2, sh)
    dq = torch.sum(
        (qviews[:, :, :, :, :, None, :] - state.centroids[None, :, None]) ** 2, dim=-1
    )  # (B, Kv, G, N_s, 2, sqrt_k)
    d1, d2 = dq[..., 0, :], dq[..., 1, :]  # (B, Kv, G, N_s, sqrt_k)
    # the reference's f32 product alpha * (pos + 1)
    alpha_n = float(np.float32(rcfg.alpha) * (np.float32(pos) + np.float32(1.0)))
    tau, _ = sort_activation(d1, d2, state.cell_sizes[:, :, None], alpha_n)  # (B,Kv,G,N_s)

    # SC-scores + distance-proxy tie-break over all cache slots: one gather
    # against the flattened (sqrt_k^2,) cell-sum table per (head, subspace)
    table = (d1[..., :, None] + d2[..., None, :]).flatten(-2)  # (B, Kv, G, N_s, K)
    cells = state.cells[:, :, None].expand(b, n_kv, g, rcfg.n_subspaces, s_max)
    sums = torch.gather(table, -1, cells.long())  # (B, Kv, G, N_s, S)
    sc = torch.sum(sums <= tau[..., None], dim=3).to(torch.float32)  # (B,Kv,G,S)
    proxy = torch.sum(sums, dim=3)
    proxy = proxy / (torch.amax(proxy, dim=-1, keepdim=True) + 1.0)
    key = sc - proxy
    slot = torch.arange(s_max, device=dev)
    valid = slot <= pos
    recent = slot > (pos - rcfg.recent_window)
    key = torch.where(valid & recent, key + 1e4, key)  # force recency window in
    key = torch.where(valid, key, NEG_INF)
    top_idx = _top_c(key, min(rcfg.n_retrieve, s_max))  # (B, Kv, G, C)
    return top_idx, valid[top_idx]


def taco_decode_attention(
    p,
    x_new: torch.Tensor,  # (B, 1, D)
    cache_k: torch.Tensor,  # (B, S, Kv, hd)
    cache_v: torch.Tensor,
    state: RetrievalState,
    pos,  # one scalar: the number of valid cached tokens
    rcfg: RetrievalConfig,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    use_rope: bool = True,
    rope_theta: float = 10000.0,
):
    """One-token decode with TaCo-retrieved sparse attention. Returns
    (out (B,1,D), cache_k, cache_v, state), the last three updated in
    place."""
    if (pos.dim() if torch.is_tensor(pos) else np.ndim(pos)) > 0:
        raise ValueError(
            "taco_decode_attention takes one scalar pos for the whole batch, as the "
            "reference does; per-slot positions (a (B,) pos, as the slot engine passes) "
            "are not supported")
    pos = int(pos)
    b = x_new.shape[0]
    dev = x_new.device
    s_max = cache_k.shape[1]
    g = n_heads // n_kv
    q = dense(p["wq"], x_new).reshape(b, 1, n_heads, head_dim)
    k = dense(p["wk"], x_new).reshape(b, 1, n_kv, head_dim)
    v = dense(p["wv"], x_new).reshape(b, 1, n_kv, head_dim)
    if use_rope:
        cos, sin = rope_angles(torch.full((1,), pos, device=dev), head_dim, rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    insert_key(state, k, pos, rcfg)
    top_idx, sel_valid = select_slots(q, state, pos, rcfg, s_max)

    # --- gather K/V rows and attend exactly over them (payloads in the cache
    # dtype; the scores accumulate in float32)
    c = top_idx.shape[-1]
    ck = cache_k.transpose(1, 2)[:, :, None].expand(b, n_kv, g, s_max, head_dim)
    cv = cache_v.transpose(1, 2)[:, :, None].expand(b, n_kv, g, s_max, head_dim)
    rows = top_idx[..., None].expand(b, n_kv, g, c, head_dim)
    gk = torch.gather(ck, 3, rows)  # (B, Kv, G, C, hd)
    gv = torch.gather(cv, 3, rows)
    qg = q.reshape(b, 1, n_kv, g, head_dim).permute(0, 2, 3, 1, 4).to(gk.dtype)
    # bf16 x bf16 products are exact in float32: this is the reference's
    # einsum with preferred_element_type=float32
    scores = torch.einsum("bkgsd,bkgcd->bkgsc", qg.to(torch.float32),
                          gk.to(torch.float32)) * (head_dim**-0.5)
    scores = torch.where(sel_valid[..., None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x_new.dtype)
    out = torch.einsum("bkgsc,bkgcd->bkgsd", probs, gv)  # (B,Kv,G,1,hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, n_heads * head_dim)
    return dense(p["wo"], out), cache_k, cache_v, state
