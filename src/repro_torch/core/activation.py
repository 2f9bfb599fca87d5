"""Collision activation (``repro.core.activation``): per subspace and query,
the threshold tau such that the cells with ``d1[i] + d2[j] <= tau`` hold at
least alpha*n points when enumerated in ascending-sum order.

Three formulations, each bitwise-equal to the reference's, ties included:

  * ``sort``   — SDA as a 32-round bisection over the f32 bit lattice (the
    uint32 keys become int64 keys with the same total order);
    ``sort_lax`` is the direct stable sort + prefix sum it replaced;
  * ``heap``   — the paper's Alg. 4, min-heap enumeration (:mod:`.heap`);
  * ``linear`` — SuCo's Dynamic Activation, an argmin over a linear
    activation array per retrieved cell.

The reference's ``vmap`` over queries becomes a batch dimension written out:
:func:`activation_taus` runs all (N_s, Q) problems at once. Its
``while_loop`` becomes one Python loop that runs until every problem is
done, with finished problems frozen.
"""
from __future__ import annotations

import torch

from repro_torch.core.heap import heap_make, heap_pop, heap_push, heap_top


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


def sort_activation(d1, d2, sizes, alpha_n):
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


def _target(sz: torch.Tensor, alpha_n) -> torch.Tensor:
    """min(alpha_n, total size) in float32, per problem."""
    alpha = torch.tensor(alpha_n, dtype=torch.float32, device=sz.device)
    return torch.minimum(alpha, torch.sum(sz.flatten(1), dim=1))


def sort_activation_lax(d1, d2, sizes, alpha_n):
    """Direct stable sort + prefix sum, batched. d1, d2: (B, sqrt_k);
    sizes: (B, sqrt_k, sqrt_k). Returns (tau (B,), retrieved (B,)) f32."""
    sums = (d1[:, :, None] + d2[:, None, :]).flatten(1)
    sz = sizes.flatten(1).to(torch.float32)
    sorted_sums, order = torch.sort(sums, dim=1, stable=True)
    csum = torch.cumsum(torch.gather(sz, 1, order), dim=1)
    target = torch.minimum(torch.tensor(alpha_n, dtype=torch.float32, device=sums.device),
                           csum[:, -1])
    cut = torch.argmax((csum >= target[:, None]).to(torch.uint8), dim=1, keepdim=True)
    return torch.gather(sorted_sums, 1, cut)[:, 0], torch.gather(csum, 1, cut)[:, 0]


def _sorted_problem(d1, d2, sizes):
    """Both distance vectors sorted (stable) and the cell sizes permuted to
    match: (s1, s2 (B, sqrt_k), sizes_sorted (B, sqrt_k, sqrt_k) f32)."""
    sqrt_k = d1.shape[1]
    idx1 = torch.argsort(d1, dim=1, stable=True)
    idx2 = torch.argsort(d2, dim=1, stable=True)
    rows = torch.gather(sizes, 1, idx1[:, :, None].expand(-1, -1, sqrt_k))
    sz = torch.gather(rows, 2, idx2[:, None, :].expand(-1, sqrt_k, -1))
    return torch.gather(d1, 1, idx1), torch.gather(d2, 1, idx2), sz.to(torch.float32)


def _size_at(sz: torch.Tensor, pos: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """sz[b, pos[b], col[b]] with col clamped into range."""
    sqrt_k = sz.shape[1]
    flat = pos.long() * sqrt_k + torch.clamp_max(col, sqrt_k - 1).long()
    return torch.gather(sz.flatten(1), 1, flat[:, None])[:, 0]


def heap_activation(d1, d2, sizes, alpha_n):
    """Paper Algorithm 4 — min-heap Scalable Dynamic Activation, batched.
    d1, d2: (B, sqrt_k); sizes: (B, sqrt_k, sqrt_k). Returns (tau (B,),
    retrieved (B,)) f32."""
    b, sqrt_k = d1.shape
    dev = d1.device
    s1, s2, sz = _sorted_problem(d1, d2, sizes)
    target = _target(sz, alpha_n)
    heap = heap_make(b, sqrt_k + 2, dev)
    every = torch.ones((b,), dtype=torch.bool, device=dev)
    heap_push(heap, s1[:, 0] + s2[:, 0], torch.zeros((b,), dtype=torch.int32, device=dev), every)
    active = torch.zeros((b, sqrt_k), dtype=torch.int32, device=dev)
    retrieved = torch.zeros((b,), dtype=torch.float32, device=dev)
    tau = torch.zeros((b,), dtype=torch.float32, device=dev)
    for _it in range(sqrt_k * sqrt_k):
        run = retrieved < target
        if not bool(run.any()):
            break
        key, pos = heap_top(heap)  # lines 5-6: top of heap
        pos_l = pos.long()
        tau = torch.where(run, key, tau)
        act = torch.gather(active, 1, pos_l[:, None])[:, 0]
        retrieved = torch.where(run, retrieved + _size_at(sz, pos, act), retrieved)  # lines 7-9
        heap_pop(heap, run)  # line 14, before the conditional pushes
        # lines 12-13: the first activation of row pos activates row pos+1
        nxt_row = torch.clamp_max(pos_l + 1, sqrt_k - 1)
        heap_push(heap, torch.gather(s1, 1, nxt_row[:, None])[:, 0] + s2[:, 0],
                  (pos + 1).to(torch.int32), run & (act == 0) & (pos < sqrt_k - 1))
        # lines 15-18: advance this row to its next column, push it back
        can_adv = act < sqrt_k - 1
        nxt = torch.clamp_max(act + 1, sqrt_k - 1)
        heap_push(heap, torch.gather(s1, 1, pos_l[:, None])[:, 0]
                  + torch.gather(s2, 1, nxt.long()[:, None])[:, 0], pos, run & can_adv)
        new_act = torch.where(can_adv, nxt, act + 1)
        active.scatter_(1, pos_l[:, None], torch.where(run, new_act, act)[:, None])
    return tau, retrieved


def linear_activation(d1, d2, sizes, alpha_n):
    """SuCo's Dynamic Activation — linear activation array, an argmin over
    sqrt_k candidates per retrieved cell, batched. d1, d2: (B, sqrt_k);
    sizes: (B, sqrt_k, sqrt_k). Returns (tau (B,), retrieved (B,)) f32."""
    b, sqrt_k = d1.shape
    dev = d1.device
    s1, s2, sz = _sorted_problem(d1, d2, sizes)
    target = _target(sz, alpha_n)
    rows = torch.arange(sqrt_k, device=dev)[None, :]
    r = torch.ones((b,), dtype=torch.int32, device=dev)
    active = torch.zeros((b, sqrt_k), dtype=torch.int32, device=dev)
    retrieved = torch.zeros((b,), dtype=torch.float32, device=dev)
    tau = torch.zeros((b,), dtype=torch.float32, device=dev)
    for _it in range(sqrt_k * sqrt_k):
        run = retrieved < target
        if not bool(run.any()):
            break
        col = torch.clamp_max(active, sqrt_k - 1).long()
        cand = s1 + torch.gather(s2, 1, col)
        cand = torch.where((rows < r[:, None]) & (active < sqrt_k), cand, torch.inf)
        pos = torch.argmin(cand, dim=1)
        tau = torch.where(run, torch.gather(cand, 1, pos[:, None])[:, 0], tau)
        act = torch.gather(active, 1, pos[:, None])[:, 0]
        retrieved = torch.where(run, retrieved + _size_at(sz, pos, act), retrieved)
        grow = run & (act == 0) & (pos < sqrt_k - 1)
        r = torch.where(grow, torch.clamp_max(r + 1, sqrt_k), r)
        active.scatter_(1, pos[:, None], torch.where(run, act + 1, act)[:, None])
    return tau, retrieved


_ACT = {
    "sort": sort_activation,
    "heap": heap_activation,
    "linear": linear_activation,
    # the pre-bisection sort formulation, kept addressable as in the reference
    "sort_lax": sort_activation_lax,
}


def activation_taus(d1s, d2s, sizes, alpha_n, method: str = "sort"):
    """All subspaces and queries at once. d1s, d2s: (N_s, Q, sqrt_k);
    sizes: (N_s, sqrt_k, sqrt_k). Returns (taus (N_s, Q), retrieved (N_s, Q))."""
    if method not in _ACT:
        raise ValueError(f"unknown activation {method!r}")
    if method == "sort":  # broadcasts the sizes over queries
        return sort_activation(d1s, d2s, sizes[:, None], alpha_n)
    n_sub, q, sqrt_k = d1s.shape
    batched_sizes = sizes[:, None].expand(n_sub, q, sqrt_k, sqrt_k).reshape(-1, sqrt_k, sqrt_k)
    tau, ret = _ACT[method](d1s.reshape(-1, sqrt_k), d2s.reshape(-1, sqrt_k),
                           batched_sizes, alpha_n)
    return tau.reshape(n_sub, q), ret.reshape(n_sub, q)
