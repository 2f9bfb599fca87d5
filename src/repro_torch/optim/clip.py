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


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), norm). The scale stays on
    the norm's device (no host sync); one ``_foreach_mul`` applies it."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    leaves, rebuild = tree_flatten(grads)
    scaled = torch._foreach_mul([g.to(torch.float32) for g in leaves], scale)
    return rebuild([s.to(g.dtype) for s, g in zip(scaled, leaves)]), norm
