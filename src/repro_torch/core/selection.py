"""Candidate selection from the SC-score histogram (``repro.core.selection``):
query-aware (paper Alg. 5) and fixed-budget (SuCo). The arithmetic is
float32 where the reference's is, so the thresholds agree bit for bit."""
from __future__ import annotations

import math

import torch


def query_aware_threshold(hist: torch.Tensor, beta_n: float, n_subspaces: int):
    """Vectorized Algorithm 5 lines 5-12. hist: (Q, N_s+1).

    Returns (last_collision (Q,) int32, candidate_num (Q,) int32) where
    candidate_num counts points with SC >= last_collision."""
    q = hist.shape[0]
    dev = hist.device
    budget = torch.tensor(beta_n, dtype=torch.float32, device=dev)
    last = torch.full((q,), n_subspaces, dtype=torch.int32, device=dev)
    cand = torch.zeros((q,), dtype=torch.float32, device=dev)
    broken = torch.zeros((q,), dtype=torch.bool, device=dev)
    for j in range(n_subspaces, -1, -1):
        level = hist[:, j].to(torch.float32)
        new_cand = cand + level
        fits = level <= (budget - new_cand)
        # once broken, state freezes (the sequential loop's `break`)
        last = torch.where((~broken) & fits, last - 1, last)
        cand = torch.where(broken, cand, new_cand)
        broken = broken | (~fits)
    levels = torch.arange(n_subspaces + 1, device=dev)[None, :]
    counted = torch.where(levels >= last[:, None], hist, 0)
    return last, torch.sum(counted, dim=1).to(torch.int32)


def fixed_budget(beta_n: float, n: int) -> int:
    """Fixed-selection re-rank budget: ceil(beta*n), clamped to [1, n]."""
    return int(min(max(1, math.ceil(beta_n)), n))


def fixed_threshold_from_hist(hist: torch.Tensor, beta_n: float, n: int):
    """SuCo fixed-budget threshold from the histogram: the largest level L
    with count(SC >= L) >= budget. Returns (thresh (Q,) int32, demand (Q,)
    int32), where demand counts every point at or above the threshold."""
    budget = fixed_budget(beta_n, n)
    rev = torch.flip(torch.cumsum(torch.flip(hist, dims=[1]), dim=1), dims=[1])
    thresh = torch.sum(rev[:, 1:] >= budget, dim=1)
    demand = torch.gather(rev, 1, thresh[:, None])[:, 0]
    return thresh.to(torch.int32), demand.to(torch.int32)
