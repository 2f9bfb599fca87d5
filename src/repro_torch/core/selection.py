"""Candidate selection (``repro.core.selection``): query-aware (paper Alg. 5)
and fixed-budget (SuCo), from the SC-score histogram (masked-full query) or
from the full SC matrix (gather query). The arithmetic is float32 where the
reference's is, so the thresholds agree bit for bit.

The gather query keeps at most ``cap`` candidates per query. Query-aware
mode compacts the ids at or above the threshold in index order;
fixed mode takes the ``cap`` best SC-scores in the order of the reference's
stable ``lax.top_k`` (higher SC first, lower id first among equals), which
decides both the ties the budget cut keeps and the slot order the re-rank
breaks distance ties by."""
from __future__ import annotations

import math

import torch

from repro_torch.mesh import one_pass


def sc_histogram(sc: torch.Tensor, n_subspaces: int) -> torch.Tensor:
    """Per-query histogram of SC-scores: (Q, N_s+1) int32."""
    levels = [torch.sum(sc == lvl, dim=1) for lvl in range(n_subspaces + 1)]
    return torch.stack(levels, dim=1).to(torch.int32)


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


def _alg5_threshold_reference(hist_row, beta_n: float, n_subspaces: int) -> int:
    """Literal sequential Algorithm 5 (host-side oracle for tests)."""
    last = n_subspaces
    cand = 0
    for j in range(n_subspaces, -1, -1):
        cand += int(hist_row[j])
        if int(hist_row[j]) <= beta_n - cand:
            last -= 1
        else:
            break
    return last


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


def fixed_threshold(sc: torch.Tensor, beta_n: float, n_subspaces: int):
    """SuCo baseline on the SC matrix: the threshold is the SC-score of the
    ceil(beta_n)-th best point; every query re-ranks exactly that budget.
    Returns (thresh (Q,) int32, count (Q,) int32)."""
    q, n = sc.shape
    budget = fixed_budget(beta_n, n)
    kth = torch.topk(sc, budget, dim=1).values[:, -1]
    return kth.to(torch.int32), torch.full((q,), budget, dtype=torch.int32, device=sc.device)


def compact_above_threshold(sc: torch.Tensor, thresh: torch.Tensor, cap: int):
    """Compact the ids with ``sc >= thresh`` into ``cap`` slots in index
    order. Returns (ids (Q, cap) int32, valid (Q, cap) bool, count (Q,)
    int32), ``count`` being the demand before the clamp (``count > cap``
    means truncated); slots past the filled ones hold id 0, as in the
    reference.

    The reference scatters every point into its rank slot or a spare
    column ``cap``; here ``nonzero`` lists the above-threshold points in
    row-major (so index) order and only the first ``cap`` of each row are
    written, so no slot is written twice. ``nonzero`` has no meta kernel
    (its output's size is the data's), so on ``meta`` tensors the outputs
    are made by shape. An op counter
    (:class:`repro_torch.launch.op_analysis.OpCounter`) counts either as one
    pass: ``sc`` and ``thresh`` read, the outputs written."""
    q, _n = sc.shape
    with one_pass() as moves:
        if sc.is_meta:
            ids = torch.empty((q, cap), dtype=torch.int32, device=sc.device)
            valid = torch.empty((q, cap), dtype=torch.bool, device=sc.device)
            count = torch.empty((q,), dtype=torch.int32, device=sc.device)
        else:
            ids, valid, count = _compact(sc, thresh, cap)
        moves(sc, thresh, ids, valid, count)
    return ids, valid, count


def _compact(sc: torch.Tensor, thresh: torch.Tensor, cap: int):
    q, _n = sc.shape
    mask = sc >= thresh[:, None]
    count = torch.sum(mask, dim=1, dtype=torch.int32)
    rows, cols = torch.nonzero(mask, as_tuple=True)
    del mask
    start = torch.cumsum(count, dim=0, dtype=torch.int64) - count
    slot = torch.arange(rows.shape[0], device=sc.device) - start[rows]
    keep = slot < cap
    ids = torch.zeros((q, cap), dtype=torch.int32, device=sc.device)
    ids[rows[keep], slot[keep]] = cols[keep].to(torch.int32)
    valid = torch.arange(cap, device=sc.device)[None, :] < torch.clamp_max(count, cap)[:, None]
    return ids, valid, count


def top_sc_stable(sc: torch.Tensor, cap: int, n_subspaces: int):
    """The ``cap`` highest SC-scores per row and their ids, higher SC first
    and lower id first among equals (the order of the stable
    ``lax.top_k``). The compound key ``(N_s - SC) * n + id`` is unique, so
    any top-k over it gives that one order."""
    n = sc.shape[1]
    ids = torch.arange(n, dtype=torch.int64, device=sc.device)
    key = (n_subspaces - sc).to(torch.int64) * n + ids
    top = torch.topk(key, cap, dim=1, largest=False, sorted=True).values
    return (n_subspaces - top // n).to(torch.int32), (top % n).to(torch.int32)


def select_candidates(sc: torch.Tensor, beta_n: float, n_subspaces: int, cap: int,
                      mode: str = "query_aware"):
    """Up to ``cap`` candidate ids per query: (ids (Q, cap) int32, valid
    (Q, cap) bool, threshold (Q,) int32, count (Q,) int32). ``valid`` masks
    sub-threshold points (query-aware) and beyond-budget points (fixed);
    ``count`` is the demand before the clamp."""
    n = sc.shape[1]
    if mode == "query_aware":
        hist = sc_histogram(sc, n_subspaces)
        thresh, _count = query_aware_threshold(hist, beta_n, n_subspaces)
        ids, valid, count = compact_above_threshold(sc, thresh, cap)
        return ids, valid, thresh, count
    if mode != "fixed":
        raise ValueError(f"unknown selection mode {mode!r}")
    thresh, count = fixed_threshold(sc, beta_n, n_subspaces)
    top_sc, ids = top_sc_stable(sc, cap, n_subspaces)
    valid = top_sc >= thresh[:, None]
    valid &= torch.arange(cap, device=sc.device)[None, :] < fixed_budget(beta_n, n)
    return ids, valid, thresh, count
