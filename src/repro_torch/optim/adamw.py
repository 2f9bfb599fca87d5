"""AdamW, decoupled weight decay Adam (mirrors ``repro.optim.adamw``).

An optimizer is a pair (init(params) -> state, update(grads, state, params,
lr) -> (updates, state)) over a tree of nested dicts of tensors; the caller
adds the updates to the parameters. The m and v moments are float32
whatever the parameters' dtype, and the arithmetic is the reference's, step
for step: bias correction from the float32 step count, then
``u = -lr (m_hat / (sqrt(v_hat) + eps) + wd p)`` in float32, cast to the
parameter's dtype. ``torch.optim.AdamW`` orders the same terms differently,
so it is not used.

Unlike the reference, ``update`` writes the new moments into the state's
own tensors (a functional update would hold two copies of m and v, 21 GB
at granite-3-2b): the returned state shares them with the given one. The
step count is a host tensor, so the bias corrections and a learning rate
derived from it are host scalars to the card's elementwise kernels (a 0-d
tensor on the card is broadcast through a slower kernel in every pass).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.utils import tree_flatten, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWState:
    step: torch.Tensor  # () int32, on the host
    m: Any
    v: Any


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1):
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          m=tree_map(zeros, params), v=tree_map(zeros, params))

    @torch.no_grad()
    def update(grads, state: AdamWState, params, lr):
        step = state.step + 1
        t = step.to(torch.float32)
        bc1 = 1.0 - b1**t
        bc2 = 1.0 - b2**t
        ps, rebuild = tree_flatten(params)
        updates = []
        for g, m, v, p in zip(tree_flatten(grads)[0], tree_flatten(state.m)[0],
                              tree_flatten(state.v)[0], ps):
            g = g.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            mhat = m / bc1
            vhat = v / bc2
            u = -lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(torch.float32))
            updates.append(u.to(p.dtype))
        return rebuild(updates), AdamWState(step=step, m=state.m, v=state.v)

    return init, update
