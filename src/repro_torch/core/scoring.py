"""SC-score computation (paper Def. 6), as in ``repro.core.scoring``.

A point p collides with query q in subspace i iff its IMI cell's distance
sum ``d1[a1[p]] + d2[a2[p]]`` is within that query's activation threshold
tau_i; SC(p) is the number of subspaces where p collides, in [0, N_s].

This is the plain path (``use_kernels=False``); with kernels the gather
query counts through :func:`repro_torch.kernels.ops.scscore` on the packed
collision table, which compares the same two floats per cell.
"""
from __future__ import annotations

import torch


def collision_sums(d1: torch.Tensor, d2: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor):
    """Per-(query, point) cell distance sums for one subspace. d1, d2:
    (Q, sqrt_k); a1, a2: (n,) cell assignments. Returns (Q, n) float32."""
    return d1[:, a1.long()] + d2[:, a2.long()]


def sc_scores(d1s, d2s, a1s, a2s, taus) -> torch.Tensor:
    """SC-scores (Q, n) int32 accumulated over all subspaces. d1s, d2s:
    (N_s, Q, sqrt_k); a1s, a2s: (N_s, n); taus: (N_s, Q)."""
    sc = torch.zeros((d1s.shape[1], a1s.shape[1]), dtype=torch.int32, device=d1s.device)
    for i in range(d1s.shape[0]):
        sc += collision_sums(d1s[i], d2s[i], a1s[i], a2s[i]) <= taus[i][:, None]
    return sc
