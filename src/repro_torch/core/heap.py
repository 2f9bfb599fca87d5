"""Fixed-capacity binary min-heaps, one per row of a batch (``repro.core.heap``).

The structure behind the paper's Scalable Dynamic Activation (Alg. 4): each
heap holds (distance-sum, row-position) pairs. The reference runs one heap
per problem under ``vmap`` with ``while_loop`` sifts; here B heaps are rows
of tensors (keys (B, cap) float32, vals (B, cap) int32, size (B,) int32),
every operation takes a per-row ``active`` mask, and a sift runs a fixed
number of rounds (the heap's depth) with each row stopping where the
reference's loop would. Swaps follow the reference exactly (sift-up on a
strict ``>``, sift-down to the left child on ``kl <= kr``), so equal keys
end in the same slots.
"""
from __future__ import annotations

import dataclasses

import torch

INF = float("inf")


@dataclasses.dataclass
class MinHeaps:
    keys: torch.Tensor  # (B, cap) float32, unused slots = +inf
    vals: torch.Tensor  # (B, cap) int32
    size: torch.Tensor  # (B,) int32

    @property
    def depth(self) -> int:
        return self.keys.shape[1].bit_length()


def heap_make(batch: int, capacity: int, device=None) -> MinHeaps:
    return MinHeaps(
        keys=torch.full((batch, capacity), INF, dtype=torch.float32, device=device),
        vals=torch.zeros((batch, capacity), dtype=torch.int32, device=device),
        size=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def heap_top(h: MinHeaps) -> tuple[torch.Tensor, torch.Tensor]:
    """(key, val) at the top of every heap, as copies: the heaps change in
    place."""
    return h.keys[:, 0].clone(), h.vals[:, 0].clone()


def _at(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return torch.gather(t, 1, i[:, None])[:, 0]


def _swap(h: MinHeaps, i: torch.Tensor, j: torch.Tensor, on: torch.Tensor) -> None:
    """Swap slots i and j of the rows where ``on`` holds (in place)."""
    i, j = i[:, None].long(), j[:, None].long()
    on = on[:, None]
    for t in (h.keys, h.vals):
        ti, tj = torch.gather(t, 1, i), torch.gather(t, 1, j)
        t.scatter_(1, i, torch.where(on, tj, ti))
        t.scatter_(1, j, torch.where(on, ti, tj))


def heap_push(h: MinHeaps, key: torch.Tensor, val: torch.Tensor,
              active: torch.Tensor) -> None:
    """Insert (key, val) in the active rows and sift up (in place). The
    caller guarantees size < capacity there."""
    cap = h.keys.shape[1]
    i = torch.clamp_max(h.size, cap - 1).long()
    h.keys.scatter_(1, i[:, None], torch.where(active, key, _at(h.keys, i))[:, None])
    h.vals.scatter_(1, i[:, None], torch.where(active, val, _at(h.vals, i))[:, None])
    moving = active.clone()
    for _ in range(h.depth):
        p = torch.clamp_min(i - 1, 0) // 2
        moving &= (i > 0) & (_at(h.keys, p) > _at(h.keys, i))
        _swap(h, i, p, moving)
        i = torch.where(moving, p, i)
    h.size += active.to(torch.int32)


def heap_pop(h: MinHeaps, active: torch.Tensor) -> None:
    """Remove the min element of the active rows and sift down (in place);
    a no-op on an empty heap's slots, as in the reference."""
    cap = h.keys.shape[1]
    last = torch.clamp_min(h.size - 1, 0).long()
    zero = torch.zeros_like(last)
    k_last, v_last = _at(h.keys, last), _at(h.vals, last)
    h.keys[:, 0] = torch.where(active, k_last, h.keys[:, 0])
    h.vals[:, 0] = torch.where(active, v_last, h.vals[:, 0])
    h.keys.scatter_(1, last[:, None], torch.where(active, INF, _at(h.keys, last))[:, None])
    new_size = torch.where(active, torch.clamp_min(h.size - 1, 0), h.size)
    i = zero
    moving = active.clone()
    for _ in range(h.depth):
        left, right = 2 * i + 1, 2 * i + 2
        kl = torch.where(left < new_size, _at(h.keys, torch.clamp_max(left, cap - 1)), INF)
        kr = torch.where(right < new_size, _at(h.keys, torch.clamp_max(right, cap - 1)), INF)
        moving &= torch.minimum(kl, kr) < _at(h.keys, i)
        child = torch.clamp_max(torch.where(kl <= kr, left, right), cap - 1)
        _swap(h, i, child, moving)
        i = torch.where(moving, child, i)
    h.size = new_size
