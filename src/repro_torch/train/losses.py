"""Training losses (mirrors ``repro.train.losses``)."""
from __future__ import annotations

import torch

IGNORE = -100


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 1e-4):
    """Next-token cross entropy with ignore-index masking and the z-loss.
    logits (B, S, V) float32; labels (B, S) integer (IGNORE = masked)."""
    mask = (labels != IGNORE).to(torch.float32)
    safe = torch.clamp_min(labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (lse - gold) * mask
    denom = torch.clamp_min(torch.sum(mask), 1.0)
    loss = torch.sum(nll) / denom
    if z_loss:
        loss = loss + z_loss * torch.sum((lse * mask) ** 2) / denom
    return loss
