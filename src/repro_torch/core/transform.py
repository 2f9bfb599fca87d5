"""Subspace-oriented data transformation via entropy averaging (paper Alg. 1
+ 2), as in ``repro.core.transform``.

The covariance and its eigendecomposition run on the data's device
(``torch.linalg.eigh``, float32, TF32 off); the greedy allocation of
eigenvectors to subspaces (Alg. 2) is a tiny sequential loop on host numpy,
copied from the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SubspaceTransform:
    """Fitted transformation. ``basis`` columns are grouped by subspace:
    columns [j*s, (j+1)*s) form B_j."""

    mean: torch.Tensor  # (d,)
    basis: torch.Tensor  # (d, n_subspaces * s)
    eigvals: torch.Tensor  # (n_subspaces * s,) eigenvalues in allocation order
    n_subspaces: int
    subspace_dim: int


def eigensystem_allocation(
    eigvals: np.ndarray, n_subspaces: int, subspace_dim: int
) -> list[list[int]]:
    """Paper Algorithm 2: per subspace, the indices (into the eigen list) of
    the eigenvectors allocated to it. Greedy over the top
    ``n_subspaces * subspace_dim`` eigenvalues in descending order: each goes
    to the not-yet-full bucket with the smallest running log-product."""
    m = n_subspaces * subspace_dim
    if m > len(eigvals):
        raise ValueError(
            f"n_subspaces*subspace_dim={m} exceeds data dimensionality {len(eigvals)}"
        )
    order = np.argsort(eigvals)[::-1][:m]
    lam = np.asarray(eigvals, dtype=np.float64)[order]
    lam = np.maximum(lam, 1e-30)
    log_lam = np.log(lam)
    log_lam = log_lam - min(log_lam[-1], 0.0)  # shift so every log >= 0

    buckets: list[list[int]] = [[] for _ in range(n_subspaces)]
    log_prod = np.zeros(n_subspaces, dtype=np.float64)
    for i in range(m):
        avail = [j for j in range(n_subspaces) if len(buckets[j]) < subspace_dim]
        j = min(avail, key=lambda b: (log_prod[b], b))
        buckets[j].append(int(order[i]))
        log_prod[j] += log_lam[i]
    return buckets


def _cov_eig(data: torch.Tensor):
    """(mean (d,), eigvals (d,) ascending, eigvecs (d, d)) of the sample
    covariance."""
    n = data.shape[0]
    mean = torch.mean(data, dim=0)
    centered = data - mean
    cov = (centered.T @ centered) / max(n - 1, 1)
    eigvals, eigvecs = torch.linalg.eigh(cov)
    return mean, eigvals, eigvecs


def allocate_from_eig(
    mean,
    eigvals: np.ndarray,
    eigvecs: np.ndarray,
    n_subspaces: int,
    subspace_dim: int,
    device: torch.device | str = "cpu",
) -> SubspaceTransform:
    """Build the transform from a precomputed eigensystem."""
    eigvals = np.asarray(eigvals)
    eigvecs = np.asarray(eigvecs)
    buckets = eigensystem_allocation(eigvals, n_subspaces, subspace_dim)
    cols, vals = [], []
    for bucket in buckets:
        for idx in bucket:
            cols.append(eigvecs[:, idx])
            vals.append(float(eigvals[idx]))
    return SubspaceTransform(
        mean=torch.as_tensor(np.array(mean), dtype=torch.float32, device=device),
        basis=torch.as_tensor(np.stack(cols, axis=1), dtype=torch.float32, device=device),
        eigvals=torch.tensor(vals, dtype=torch.float32, device=device),
        n_subspaces=n_subspaces,
        subspace_dim=subspace_dim,
    )


def fit_transform(data: torch.Tensor, n_subspaces: int, subspace_dim: int) -> SubspaceTransform:
    """Paper Algorithm 1 lines 2-5: mean, covariance, eigendecomposition,
    eigensystem allocation."""
    mean, eigvals, eigvecs = _cov_eig(data.to(torch.float32))
    return allocate_from_eig(
        mean.cpu().numpy(), eigvals.cpu().numpy(), eigvecs.cpu().numpy(),
        n_subspaces, subspace_dim, device=data.device,
    )


def apply_transform(t: SubspaceTransform, x: torch.Tensor) -> torch.Tensor:
    """Paper Algorithm 1 lines 6-11: (x - mean) @ B."""
    return (x.to(torch.float32) - t.mean) @ t.basis
