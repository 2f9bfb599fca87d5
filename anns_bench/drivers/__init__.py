"""Traffic drivers, one module a ``driver`` name of ``traffic/<mix>.json``.

A driver has ``setup(ctx)`` (build the program's index, warm the cell's one
shape), ``unit(ctx, i)`` (one unit of the closed loop, synchronised; returns
the work it did), ``outputs(ctx)`` (what the program produced, for the
check) and ``release(ctx)`` (free the program's state)."""
from __future__ import annotations

import torch


def index_state(index) -> dict:
    """The built index's state that the check reads: the transform's
    ``mean`` and ``basis``, each (subspace, half)'s ``centroids`` in
    (subspace, half) order, and ``assign`` (2 N_s, n), subspace s half h at
    row 2 s + h."""
    sc = index.sc_index
    a1s, a2s = sc.assignments
    return {"mean": sc.transform.mean, "basis": sc.transform.basis,
            "centroids": [c for sub in sc.subspaces for c in (sub.centroids1, sub.centroids2)],
            "assign": torch.stack([a1s, a2s], dim=1).reshape(-1, a1s.shape[1])}
