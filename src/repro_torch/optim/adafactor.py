"""Adafactor (Shazeer & Stern 2018), factored second moments (mirrors
``repro.optim.adafactor``).

For a parameter of two or more dimensions the (row, column) factors of the
second moment replace the full tensor; a vector keeps the full one. No
first moment, updates clipped at RMS ``clip_threshold``, and the increasing
decay schedule ``beta = 1 - t^-decay``. The arithmetic is the reference's;
as in :mod:`repro_torch.optim.adamw`, ``update`` writes the new factors
into the state's own tensors and the step count lives on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.utils import tree_flatten, tree_map


@dataclasses.dataclass(frozen=True)
class AdafactorState:
    step: torch.Tensor  # () int32, on the host
    vr: Any  # row factors (or the full v of a vector)
    vc: Any  # column factors (or a (1,) zero for a vector)


def _is_factored(p) -> bool:
    return p.dim() >= 2


def adafactor(decay: float = 0.8, eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0):
    def init(params):
        def vr0(p):
            shape = p.shape[:-1] if _is_factored(p) else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def vc0(p):
            shape = (*p.shape[:-2], p.shape[-1]) if _is_factored(p) else (1,)
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return AdafactorState(step=torch.zeros((), dtype=torch.int32),
                              vr=tree_map(vr0, params), vc=tree_map(vc0, params))

    @torch.no_grad()
    def update(grads, state: AdafactorState, params, lr):
        step = state.step + 1
        t = step.to(torch.float32)
        beta = 1.0 - t**-decay  # increasing decay schedule
        ps, rebuild = tree_flatten(params)
        updates = []
        for g, vr, vc, p in zip(tree_flatten(grads)[0], tree_flatten(state.vr)[0],
                                tree_flatten(state.vc)[0], ps):
            g = g.to(torch.float32)
            g2 = g * g + eps
            if _is_factored(p):
                vr.mul_(beta).add_((1 - beta) * torch.mean(g2, dim=-1))
                vc.mul_(beta).add_((1 - beta) * torch.mean(g2, dim=-2))
                r = vr / torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True), eps)
                u = g * torch.rsqrt(r[..., None]) * torch.rsqrt(
                    torch.clamp_min(vc, eps))[..., None, :]
            else:
                vr.mul_(beta).add_((1 - beta) * g2)
                u = g * torch.rsqrt(torch.clamp_min(vr, eps))
            rms_u = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp_min(rms_u / clip_threshold, 1.0)
            u = -lr * (u + weight_decay * p.to(torch.float32))
            updates.append(u.to(p.dtype))
        return rebuild(updates), AdafactorState(step=step, vr=state.vr, vc=state.vc)

    return init, update
