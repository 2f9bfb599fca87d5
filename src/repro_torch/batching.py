"""The query-batch bucket ladder (mirrors ``repro.batching``).

Direct ``search`` calls pad a batch up :data:`ANN_BATCH_BUCKETS`, so
repeated ad-hoc batch sizes share one cached query function. Numpy only.
"""
from __future__ import annotations

import numpy as np

#: Query-batch ladder: starts at 1 so a lone request is not padded 16x.
ANN_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def bucket_size(n: int, buckets=ANN_BATCH_BUCKETS) -> int:
    """Smallest ladder bucket >= n; past the top rung, round up to a
    multiple of it."""
    if n <= 0:
        raise ValueError(f"bucket_size: n must be positive, got {n}")
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return ((n + top - 1) // top) * top


def pad_rows(x: np.ndarray, target: int) -> np.ndarray:
    """Pad a (n, ...) array to (target, ...) rows by repeating the last row,
    so pad rows are numerically typical."""
    n = x.shape[0]
    if n > target:
        raise ValueError(f"pad_rows: {n} rows exceed target {target}")
    if n == target:
        return x
    return np.concatenate([x, np.repeat(x[-1:], target - n, axis=0)], axis=0)
