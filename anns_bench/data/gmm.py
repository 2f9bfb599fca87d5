"""Seeded Gaussian-mixture corpus drawn on the device, and held-out queries.

A frozen torch copy of the mixture the program's own generator
(``repro_torch.data.vectors.gmm_dataset``) draws with numpy on the host:
cluster centres on a random low-rank subspace, normalised to unit norm, plus
power-law ambient noise through a random rotation. Drawing 10^6 x 960 on the
host takes tens of seconds; here every draw is a few large calls of one
``torch.Generator`` on the device, so a run's set-up pays well under a second.

Queries follow the paper's protocol (``make_queries``): Q points of the same
mixture, not in the corpus, each perturbed by Gaussian noise of ``noise``
times the data's standard deviation. The n + Q points are iid, so the last Q
are a held-out sample as good as any random Q of them.
"""
from __future__ import annotations

import torch

#: rows drawn per block: keeps the noise block and its rotation near 1 GB at
#: 960 dims. A constant, so one seed gives the same draws on every device
BLOCK_ROWS = 1 << 18


def random_rotation(g: torch.Generator, d: int, device) -> torch.Tensor:
    """A (d, d) orthogonal matrix: QR of a Gaussian matrix, signs fixed by
    the diagonal of R (``_random_rotation``'s rule)."""
    a = torch.randn((d, d), generator=g, device=device, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    return (q * torch.sign(torch.diagonal(r))).to(torch.float32)


def draw(n: int, d: int, *, n_clusters: int = 64, cluster_std: float = 0.15,
         rank_frac: float = 0.4, noise_decay: float = 1.0, g: torch.Generator,
         device) -> torch.Tensor:
    """(n, d) float32 points of the mixture, drawn in blocks of
    :data:`BLOCK_ROWS` rows."""
    r = max(2, int(rank_frac * d))
    basis = random_rotation(g, d, device)[:, :r]
    centers = torch.randn((n_clusters, r), generator=g, device=device) @ basis.T
    centers /= torch.clamp_min(torch.linalg.vector_norm(centers, dim=1, keepdim=True), 1e-6)
    scales = torch.arange(1, d + 1, dtype=torch.float64, device=device) ** (-noise_decay) + 0.05
    scales = torch.sqrt(scales / scales.mean()).to(torch.float32)
    rot = random_rotation(g, d, device)
    which = torch.randint(0, n_clusters, (n,), generator=g, device=device)
    x = torch.empty((n, d), dtype=torch.float32, device=device)
    for lo in range(0, n, BLOCK_ROWS):
        hi = min(n, lo + BLOCK_ROWS)
        noise = torch.randn((hi - lo, d), generator=g, device=device) * scales
        x[lo:hi] = centers[which[lo:hi]] + cluster_std * (noise @ rot)
    return x


def global_std(x: torch.Tensor) -> float:
    """The population standard deviation of every entry (``np.std``),
    accumulated in float64 a block at a time."""
    total, sq = 0.0, 0.0
    for lo in range(0, x.shape[0], BLOCK_ROWS):
        blk = x[lo:lo + BLOCK_ROWS].to(torch.float64)
        total += float(blk.sum())
        sq += float((blk * blk).sum())
    count = x.numel()
    mean = total / count
    return max(sq / count - mean * mean, 0.0) ** 0.5


def corpus_and_queries(params: dict, n: int, d: int, n_queries: int, seed: int, device):
    """(corpus (n, d), queries (Q, d)) float32 on ``device`` from ``seed``:
    n + Q points drawn, the last Q held out and perturbed by
    ``params["query_noise"]`` times the data's standard deviation."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    mix = {key: params[key] for key in ("n_clusters", "cluster_std", "rank_frac",
                                        "noise_decay") if key in params}
    x = draw(n + n_queries, d, g=g, device=device, **mix)
    scale = global_std(x) * float(params.get("query_noise", 0.01))
    held = x[n:]
    queries = held + torch.randn(held.shape, generator=g, device=device) * scale
    # the corpus is the leading rows: a contiguous view, the held-out rows stay unused
    return x[:n], queries.contiguous()
