"""Inverted multi-index (IMI) per subspace (paper Alg. 3, lines 4-12), as in
``repro.core.imi``: dense assignment arrays (a1, a2) plus the
(sqrt_k, sqrt_k) cell-size grid, no inverted lists."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.clustering import kmeans_assign, kmeans_pairs


@dataclasses.dataclass(frozen=True)
class IMISubspace:
    centroids1: torch.Tensor  # (sqrt_k, s1)
    centroids2: torch.Tensor  # (sqrt_k, s2)
    assign1: torch.Tensor  # (n,) int32
    assign2: torch.Tensor  # (n,) int32
    cell_sizes: torch.Tensor  # (sqrt_k, sqrt_k) int32

    @property
    def sqrt_k(self) -> int:
        return self.centroids1.shape[0]


def split_halves(dim: int) -> tuple[int, int]:
    """Paper Alg. 3 line 6: split a subspace's dims into two parts."""
    return dim // 2, dim - dim // 2


def half_columns(sub_dims) -> list[tuple[int, int]]:
    """(first column, width) of every (subspace, half) of the projected
    data, in (subspace, half) order."""
    out, col = [], 0
    for d in sub_dims:
        s1, s2 = split_halves(d)
        out += [(col, s1), (col + s1, s2)]
        col += d
    return out


def build_imi_subspaces(
    projected: torch.Tensor,
    sub_dims,
    sqrt_k: int,
    iters: int,
    init: str = "random",
    *,
    generator: torch.Generator | None = None,
    impl: str = "auto",
) -> tuple[IMISubspace, ...]:
    """Cluster both halves of every subspace and record assignments/sizes.

    The 2 N_s halves of ``projected`` (n, sum(sub_dims)) are laid out once
    as a (2 N_s, n, w) stack, zero-padded to the widest half rounded up to
    a multiple of 4 (16-byte rows for the kernel), and clustered by one
    k-means in lockstep (:func:`kmeans_pairs`); the initial centroids are
    drawn in (subspace, half) order, as one k-means per half would draw
    them. The stack is freed on return."""
    halves = half_columns(sub_dims)
    dims = [d for _c, d in halves]
    w = -(-max(dims) // 4) * 4
    xs = torch.zeros((len(halves), projected.shape[0], w), dtype=torch.float32,
                     device=projected.device)
    for p, (col, d) in enumerate(halves):
        xs[p, :, :d] = projected[:, col:col + d]
    cents, assign = kmeans_pairs(xs, sqrt_k, iters, init, dims=dims, generator=generator,
                                 impl=impl)
    del xs
    subspaces = []
    for s in range(len(sub_dims)):
        a1, a2 = assign[2 * s], assign[2 * s + 1]
        subspaces.append(IMISubspace(
            centroids1=cents[2 * s, :, :dims[2 * s]].contiguous(),
            centroids2=cents[2 * s + 1, :, :dims[2 * s + 1]].contiguous(),
            assign1=a1,
            assign2=a2,
            cell_sizes=cell_sizes(a1, a2, sqrt_k),
        ))
    return tuple(subspaces)


def cell_sizes(a1: torch.Tensor, a2: torch.Tensor, sqrt_k: int) -> torch.Tensor:
    cell = a1.long() * sqrt_k + a2.long()
    flat = torch.bincount(cell, minlength=sqrt_k * sqrt_k)
    return flat.to(torch.int32).reshape(sqrt_k, sqrt_k)


def assign_new_points(imi: IMISubspace, sub_data: torch.Tensor, impl: str = "auto"):
    """Assign out-of-index points to IMI cells."""
    s1 = imi.centroids1.shape[1]
    a1, _ = kmeans_assign(sub_data[:, :s1].contiguous(), imi.centroids1, impl)
    a2, _ = kmeans_assign(sub_data[:, s1:].contiguous(), imi.centroids2, impl)
    return a1, a2
