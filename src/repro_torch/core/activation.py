"""Collision activation (``repro.core.activation``): per subspace and query,
the threshold tau such that the cells with ``d1[i] + d2[j] <= tau`` hold at
least alpha*n points when enumerated in ascending-sum order.

Only the sort formulation (SDA) is ported: a 32-round bisection over the
f32 bit lattice, bitwise-equal to the reference, ties included. The
reference's ``vmap`` over queries becomes a batch dimension written out:
:func:`activation_taus` runs all (N_s, Q) problems at once. The uint32 keys
become int64 keys with the same total order.
"""
from __future__ import annotations

import torch


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


def activation_taus(d1s, d2s, sizes, alpha_n, method: str = "sort"):
    """All subspaces and queries at once. d1s, d2s: (N_s, Q, sqrt_k);
    sizes: (N_s, sqrt_k, sqrt_k). Returns (taus (N_s, Q), retrieved (N_s, Q))."""
    if method != "sort":
        raise NotImplementedError(
            f"activation {method!r} is not ported yet (only 'sort' is)")
    return sort_activation(d1s, d2s, sizes[:, None], alpha_n)
