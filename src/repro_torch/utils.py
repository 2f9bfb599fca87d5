"""Shared small utilities of the port: device choice, distances, top-k,
recall."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. The default is the card; without
    one this raises instead of falling back, so a CPU run is always asked
    for (``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distance matrix between rows of x (M,d) and y (N,d)
    in the ``||x||^2 + ||y||^2 - 2 x.y^T`` form, clamped at 0."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    x2 = torch.sum(x * x, dim=-1, keepdim=True)  # (M, 1)
    y2 = torch.sum(y * y, dim=-1, keepdim=True).T  # (1, N)
    d = x2 + y2 - 2.0 * (x @ y.T)
    return torch.clamp_min(d, 0.0)


def topk_smallest(values: torch.Tensor, k: int):
    """(values, positions) of the k smallest entries along the last axis;
    ties go to the lowest position, as in the stable ``lax.top_k``."""
    vals, pos = torch.sort(values, dim=-1, stable=True)
    return vals[..., :k], pos[..., :k]


def recall_at_k(result_ids, gt_ids, k: int) -> float:
    """Mean recall@k over queries: |R ∩ R*| / k."""
    result_ids = np.asarray(result_ids.cpu() if torch.is_tensor(result_ids) else result_ids)
    gt_ids = np.asarray(gt_ids.cpu() if torch.is_tensor(gt_ids) else gt_ids)
    r = 0.0
    for res, gt in zip(result_ids, gt_ids):
        r += len(set(res[:k].tolist()) & set(gt[:k].tolist())) / k
    return r / len(result_ids)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round through bfloat16 and back to float32."""
    return x.to(torch.bfloat16).to(torch.float32)
