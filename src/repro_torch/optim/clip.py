"""Gradient clipping by global norm (mirrors ``repro.optim.clip``)."""
from __future__ import annotations

import torch

from repro_torch.utils import tree_flatten


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 squares, leaf by leaf in the
    reference's order."""
    total = 0.0
    for leaf in tree_flatten(tree)[0]:
        total = total + torch.sum(leaf.to(torch.float32) ** 2)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / norm), on the norm's device (no host sync)."""
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by :func:`clip_scale`, norm). One ``_foreach_mul``
    applies the scale."""
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    leaves, rebuild = tree_flatten(grads)
    scaled = torch._foreach_mul([g.to(torch.float32) for g in leaves], scale)
    return rebuild([s.to(g.dtype) for s, g in zip(scaled, leaves)]), norm
