"""Synthetic high-dimensional vector datasets (numpy copy of
``repro.data.vectors``): the same seeded numpy calls, so the arrays equal
the reference's bit for bit."""
from __future__ import annotations

import numpy as np


def _random_rotation(rng: np.random.Generator, d: int) -> np.ndarray:
    a = rng.standard_normal((d, d))
    q, r = np.linalg.qr(a)
    return q * np.sign(np.diag(r))


def gmm_dataset(
    n: int,
    d: int,
    n_clusters: int = 64,
    cluster_std: float = 0.15,
    rank_frac: float = 0.4,
    noise_decay: float = 1.0,
    seed: int = 0,
) -> np.ndarray:
    """Clustered data on a low-rank manifold + power-law ambient noise."""
    rng = np.random.default_rng(seed)
    r = max(2, int(rank_frac * d))
    basis = _random_rotation(rng, d)[:, :r].astype(np.float32)  # (d, r)
    centers_r = rng.standard_normal((n_clusters, r)).astype(np.float32)
    centers = centers_r @ basis.T
    centers /= np.maximum(np.linalg.norm(centers, axis=1, keepdims=True), 1e-6)
    which = rng.integers(0, n_clusters, size=n)
    scales = (np.arange(1, d + 1, dtype=np.float64) ** (-noise_decay)) + 0.05
    scales = np.sqrt(scales / scales.mean()).astype(np.float32)
    noise = rng.standard_normal((n, d)).astype(np.float32) * scales
    rot = _random_rotation(rng, d).astype(np.float32)
    x = centers[which] + cluster_std * (noise @ rot)
    return x.astype(np.float32)


def even_shard_total(n: int, held_out: int, shards: int) -> int:
    """Largest total dataset size <= n such that after holding out
    ``held_out`` queries (:func:`make_queries`) the corpus splits evenly
    over ``shards`` data shards. No-op for ``shards <= 1``."""
    if shards <= 1:
        return n
    return (n - held_out) // shards * shards + held_out


def make_queries(
    data: np.ndarray, n_queries: int, noise: float = 0.01, seed: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """Hold out n_queries points as queries (with tiny perturbation), return
    (remaining_data, queries) — the paper's protocol."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(data.shape[0], size=n_queries, replace=False)
    queries = data[idx].copy()
    if noise > 0:
        scale = float(np.std(data)) * noise
        queries = queries + rng.standard_normal(queries.shape).astype(np.float32) * scale
    rest = np.delete(data, idx, axis=0)
    return rest, queries.astype(np.float32)
