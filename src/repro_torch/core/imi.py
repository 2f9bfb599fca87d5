"""Inverted multi-index (IMI) per subspace (paper Alg. 3, lines 4-12), as in
``repro.core.imi``: dense assignment arrays (a1, a2) plus the
(sqrt_k, sqrt_k) cell-size grid, no inverted lists."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.clustering import kmeans, kmeans_assign


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


def build_imi_subspace(
    sub_data: torch.Tensor,
    sqrt_k: int,
    iters: int,
    init: str = "random",
    *,
    generator: torch.Generator | None = None,
    impl: str = "auto",
) -> IMISubspace:
    """Cluster both halves of one subspace and record assignments/sizes."""
    s1, _s2 = split_halves(sub_data.shape[1])
    c1, a1 = kmeans(sub_data[:, :s1], sqrt_k, iters, init, generator=generator, impl=impl)
    c2, a2 = kmeans(sub_data[:, s1:], sqrt_k, iters, init, generator=generator, impl=impl)
    return IMISubspace(
        centroids1=c1,
        centroids2=c2,
        assign1=a1.to(torch.int32),
        assign2=a2.to(torch.int32),
        cell_sizes=cell_sizes(a1, a2, sqrt_k),
    )


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
