"""The plain reference of TaCo: index build (paper Alg. 1-3) and the k-ANNS
query (Alg. 4-6), written out in plain PyTorch.

It follows the paper and the configuration, never the code under test: no
kernels, no packed tables, no streaming. It materialises what the program
streams, query chunk by query chunk: every point's SC-score, the histogram,
the Alg. 5 threshold, the candidate set and the exact distances. Every
matrix product goes through :func:`precision.matmul`, so the whole reference
runs in float32 (the configuration's precision) or, as the control, in TF32.

Build: the sample covariance, ``eigh``, the greedy eigensystem allocation
(Alg. 2), the projection, then one k-means per (subspace, half), initialised
by ``randperm`` of the configuration's seed in (subspace, half) order, with
Lloyd steps whose cluster sums are one-hot products (no atomics, so the
reference repeats bit for bit). Query: the projection, centroid distances,
sort activation (the smallest cell-sum whose ascending prefix holds
``alpha n`` points), collision counts, the SC histogram, Alg. 5's
query-aware threshold, the candidates (all of them on the masked pipeline,
the first ``cap`` in index order on the gather pipeline) and their top-k.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from anns_bench.reference.precision import matmul, sq_dists

#: bytes a (rows x columns) float32 block of the reference may take
BLOCK_BYTES = 1 << 30
#: extra candidates kept past k before the float64 refinement of a top-k
REFINE_MARGIN = 32


@dataclasses.dataclass
class RefIndex:
    mean: torch.Tensor  # (d,)
    basis: torch.Tensor  # (d, N_s s) columns grouped by subspace
    eigvals: torch.Tensor  # (N_s s,) in allocation order
    centroids: torch.Tensor  # (2 N_s, sqrt_k, w): subspace s half h at 2 s + h
    assign: torch.Tensor  # (2 N_s, n) int64
    dims: tuple  # width of each (subspace, half)
    data: torch.Tensor  # (n, d)

    @property
    def n(self) -> int:
        return self.data.shape[0]

    @property
    def sqrt_k(self) -> int:
        return self.centroids.shape[1]


def sqrt_clusters(cfg: dict) -> int:
    r = math.isqrt(int(cfg["n_clusters"]))
    if r * r != int(cfg["n_clusters"]):
        raise ValueError(f"n_clusters={cfg['n_clusters']} is not a perfect square")
    return r


def allocation(eigvals: np.ndarray, n_sub: int, s: int) -> list[list[int]]:
    """Paper Alg. 2: the top ``n_sub s`` eigenvalues in descending order, each
    to the not-yet-full subspace with the smallest running log-product."""
    m = n_sub * s
    if m > len(eigvals):
        raise ValueError(f"{n_sub} x {s} dims exceed the data's {len(eigvals)}")
    order = np.argsort(eigvals)[::-1][:m]
    log_lam = np.log(np.maximum(np.asarray(eigvals, dtype=np.float64)[order], 1e-30))
    log_lam = log_lam - min(log_lam[-1], 0.0)
    buckets: list[list[int]] = [[] for _ in range(n_sub)]
    prod = np.zeros(n_sub)
    for i in range(m):
        j = min((b for b in range(n_sub) if len(buckets[b]) < s), key=lambda b: (prod[b], b))
        buckets[j].append(int(order[i]))
        prod[j] += log_lam[i]
    return buckets


def half_dims(n_sub: int, s: int) -> list[tuple[int, int]]:
    """(first column, width) of every (subspace, half) of the projection."""
    out = []
    for j in range(n_sub):
        out += [(j * s, s // 2), (j * s + s // 2, s - s // 2)]
    return out


def _rows_per_block(cols: int) -> int:
    return max(1, BLOCK_BYTES // (4 * max(cols, 1)))


def assign_pairs(xs: torch.Tensor, cents: torch.Tensor, prec: str) -> torch.Tensor:
    """(P, n) nearest-centroid index of each point of each pair, the first
    index on ties."""
    n_pairs, n, _w = xs.shape
    step = _rows_per_block(n_pairs * cents.shape[1])
    return torch.cat([torch.argmin(sq_dists(xs[:, lo:lo + step], cents, prec), dim=-1)
                      for lo in range(0, n, step)], dim=1)


def lloyd_update(xs: torch.Tensor, assign: torch.Tensor, cents: torch.Tensor,
                 prec: str) -> torch.Tensor:
    """Each cluster's mean by one-hot products a row block at a time (a
    fixed order, so repeatable); an empty cluster keeps its centroid."""
    n_pairs, n, w = xs.shape
    k = cents.shape[1]
    sums = torch.zeros((n_pairs, k, w), dtype=torch.float32, device=xs.device)
    step = _rows_per_block(n_pairs * k)
    for lo in range(0, n, step):
        a = assign[:, lo:lo + step]
        onehot = torch.zeros((n_pairs, a.shape[1], k), dtype=torch.float32, device=xs.device)
        onehot.scatter_(2, a[:, :, None], 1.0)
        sums += matmul(onehot.mT, xs[:, lo:lo + step], prec)
        del onehot
    counts = torch.stack([torch.bincount(a, minlength=k) for a in assign]).to(torch.float32)
    return torch.where(counts[..., None] > 0, sums / torch.clamp_min(counts, 1.0)[..., None],
                       cents)


def build(data: torch.Tensor, cfg: dict, prec: str = "f32") -> RefIndex:
    """Paper Alg. 1-3 over ``data`` (n, d) on its device."""
    if cfg.get("transform", "entropy") != "entropy" or cfg.get("kmeans_init", "random") != "random":
        raise ValueError("the reference builds TaCo: entropy transform, random init")
    n, d = data.shape
    n_sub, s = int(cfg["n_subspaces"]), int(cfg["subspace_dim"])
    k = sqrt_clusters(cfg)
    mean = torch.mean(data, dim=0)
    centered = data - mean
    cov = matmul(centered.T, centered, prec) / max(n - 1, 1)
    del centered
    eigvals, eigvecs = torch.linalg.eigh(cov)
    vals = eigvals.cpu().numpy()
    cols = [i for bucket in allocation(vals, n_sub, s) for i in bucket]
    basis = eigvecs[:, cols].contiguous()
    alloc_vals = eigvals[cols].contiguous()
    projected = matmul(data - mean, basis, prec)
    halves = half_dims(n_sub, s)
    dims = tuple(wd for _c, wd in halves)
    w = -(-max(dims) // 4) * 4
    xs = torch.zeros((len(halves), n, w), dtype=torch.float32, device=data.device)
    for p, (col, wd) in enumerate(halves):
        xs[p, :, :wd] = projected[:, col:col + wd]
    del projected
    gen = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    cents = torch.zeros((len(halves), k, w), dtype=torch.float32, device=data.device)
    for p in range(len(halves)):
        rows = torch.randperm(n, generator=gen)[:k]
        cents[p] = xs[p, rows.to(data.device)]
    for _ in range(int(cfg["kmeans_iters"])):
        cents = lloyd_update(xs, assign_pairs(xs, cents, prec), cents, prec)
    assign = assign_pairs(xs, cents, prec)
    return RefIndex(mean=mean, basis=basis, eigvals=alloc_vals, centroids=cents,
                    assign=assign, dims=dims, data=data)


def alg5_threshold(hist: torch.Tensor, beta_n: float, n_sub: int) -> torch.Tensor:
    """Paper Alg. 5 over a (Q, N_s + 1) histogram: from the top level down,
    a level is taken while it fits the remaining budget; the threshold is
    the last level taken (float32 arithmetic on integer counts, exact)."""
    q = hist.shape[0]
    budget = torch.tensor(beta_n, dtype=torch.float32, device=hist.device)
    last = torch.full((q,), n_sub, dtype=torch.int64, device=hist.device)
    cand = torch.zeros((q,), dtype=torch.float32, device=hist.device)
    broken = torch.zeros((q,), dtype=torch.bool, device=hist.device)
    for j in range(n_sub, -1, -1):
        level = hist[:, j].to(torch.float32)
        fits = level <= budget - (cand + level)
        last = torch.where(~broken & fits, last - 1, last)
        cand = torch.where(broken, cand, cand + level)
        broken = broken | ~fits
    return last


def gather_cap(cfg: dict, n: int, k: int) -> int:
    """The gather pipeline's candidates a query: ``max(4 k, ceil(4 beta n))``
    capped at n, and never below k."""
    cap = int(min(n, max(4 * k, math.ceil(4 * float(cfg["beta"]) * n))))
    return min(n, max(cap, k))


def exact_topk(data: torch.Tensor, queries: torch.Tensor, approx: torch.Tensor, k: int):
    """(ids (Q, k) int64, float64 squared distances (Q, k)): the k smallest
    exact distances among the finite entries of ``approx`` (Q, n), ties to
    the lower id, -1 / inf where fewer are finite. The float32 ``approx``
    picks k + :data:`REFINE_MARGIN` entries, float64 orders them."""
    m = min(approx.shape[1], k + REFINE_MARGIN)
    vals, ids = torch.topk(approx, m, dim=1, largest=False)
    diff = data[ids].to(torch.float64) - queries[:, None, :].to(torch.float64)
    exact = torch.where(torch.isfinite(vals), torch.sum(diff * diff, dim=-1), torch.inf)
    order = torch.argsort(ids, dim=1, stable=True)
    ids, exact = torch.gather(ids, 1, order), torch.gather(exact, 1, order)
    order = torch.argsort(exact, dim=1, stable=True)[:, :k]
    ids, exact = torch.gather(ids, 1, order), torch.gather(exact, 1, order)
    return torch.where(torch.isfinite(exact), ids, -1), exact


def query(index: RefIndex, queries: torch.Tensor, cfg: dict, *, k: int, rerank: str,
          prec: str = "f32", exact: bool = True) -> dict:
    """Paper Alg. 6 over ``queries`` (Q, d) on the index's device, in query
    chunks. Returns ``ids`` (Q, k) int64 and ``dists`` (Q, k) float32 as
    ranked in ``prec`` (ties to the lower id), ``count`` (Q,) the candidates
    re-ranked, ``taus`` (N_s, Q) the activation thresholds, ``thresh`` (Q,)
    the Alg. 5 levels, and with ``exact`` also ``exact_ids`` (the exact top-k of the
    same candidates), ``true_ids`` (the exact top-k of the corpus) and
    ``touched`` (n,) the points some query re-ranked."""
    n_sub, s = int(cfg["n_subspaces"]), int(cfg["subspace_dim"])
    n, k2 = index.n, index.sqrt_k ** 2
    data = index.data
    x_norms = torch.sum(data * data, dim=1)
    cells = index.assign[0::2] * index.sqrt_k + index.assign[1::2]  # (N_s, n)
    sizes = torch.stack([torch.bincount(c, minlength=k2) for c in cells]).to(torch.float32)
    alpha_n = torch.tensor(float(cfg["alpha"]) * n, dtype=torch.float32, device=data.device)
    cap = gather_cap(cfg, n, k) if rerank == "gather" else n
    halves = half_dims(n_sub, s)
    out = {key: [] for key in ("ids", "dists", "count", "taus", "thresh", "exact_ids",
                               "true_ids")}
    touched = torch.zeros((n,), dtype=torch.bool, device=data.device)
    step = _rows_per_block(n)
    for lo in range(0, queries.shape[0], step):
        q = queries[lo:lo + step]
        pq = matmul(q - index.mean, index.basis, prec)
        sc = torch.zeros((q.shape[0], n), dtype=torch.uint8, device=data.device)
        taus = []
        for j in range(n_sub):
            (c1, w1), (c2, w2) = halves[2 * j], halves[2 * j + 1]
            d1 = sq_dists(pq[:, c1:c1 + w1], index.centroids[2 * j, :, :w1], prec)
            d2 = sq_dists(pq[:, c2:c2 + w2], index.centroids[2 * j + 1, :, :w2], prec)
            sums = (d1[:, :, None] + d2[:, None, :]).flatten(1)  # cell a1 * sqrt_k + a2
            ordered, order = torch.sort(sums, dim=1, stable=True)
            csum = torch.cumsum(sizes[j][order], dim=1)
            target = torch.minimum(alpha_n, csum[:, -1])
            cut = torch.argmax((csum >= target[:, None]).to(torch.uint8), dim=1)
            tau = torch.gather(ordered, 1, cut[:, None])
            taus.append(tau[:, 0])
            sc += (sums <= tau)[:, cells[j]]
        hist = torch.stack([torch.sum(sc == lvl, dim=1) for lvl in range(n_sub + 1)], dim=1)
        thresh = alg5_threshold(hist, float(cfg["beta"]) * n, n_sub)
        mask = sc >= thresh[:, None]
        del sc
        count = torch.sum(mask, dim=1)
        if cap < n:
            mask &= torch.cumsum(mask, dim=1, dtype=torch.int32) <= cap
        touched |= mask.any(dim=0)
        q_norms = torch.sum(q * q, dim=1, keepdim=True)
        dist = torch.clamp_min(q_norms + x_norms[None] - 2.0 * matmul(q, data.T, prec), 0.0)
        cand = torch.where(mask, dist, torch.inf)
        del mask
        m = min(n, k + REFINE_MARGIN)
        vals, ids = torch.topk(cand, m, dim=1, largest=False)
        order = torch.argsort(ids, dim=1, stable=True)
        vals, ids = torch.gather(vals, 1, order), torch.gather(ids, 1, order)
        order = torch.argsort(vals, dim=1, stable=True)[:, :k]
        vals, ids = torch.gather(vals, 1, order), torch.gather(ids, 1, order)
        out["ids"].append(torch.where(torch.isfinite(vals), ids, -1))
        out["dists"].append(vals)
        out["count"].append(torch.clamp_max(count, cap))
        out["taus"].append(torch.stack(taus))
        out["thresh"].append(thresh)
        if exact:
            out["exact_ids"].append(exact_topk(data, q, cand, k)[0])
            out["true_ids"].append(exact_topk(data, q, dist, k)[0])
        del dist, cand
    res = {key: torch.cat(val, dim=1 if key == "taus" else 0) for key, val in out.items() if val}
    if exact:
        res["touched"] = touched
    return res
