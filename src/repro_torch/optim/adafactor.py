"""Adafactor (Shazeer & Stern 2018), factored second moments (mirrors
``repro.optim.adafactor``).

For a parameter of two or more dimensions the (row, column) factors of the
second moment replace the full tensor; a vector keeps the full one. No
first moment, updates clipped at RMS ``clip_threshold``, and the increasing
decay schedule ``beta = 1 - t^-decay``. The arithmetic is the reference's;
as in :mod:`repro_torch.optim.adamw`, ``update`` writes the new factors
into the state's own tensors and the step count lives on the host.

The arithmetic of one parameter is written once, over a :class:`Leaf`: the
parameter as one or more blocks, with the means over a dimension taken as
the blocks' partial sums added (:meth:`Leaf.add`). On one device a leaf is
one whole block and the sum is its own; a step that splits the parameter
over positions hands leaves whose blocks sit at those positions
(:func:`repro_torch.train.loop.make_sharded_train_step`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.utils import tree_flatten, tree_map


@dataclasses.dataclass(frozen=True)
class AdafactorState:
    step: torch.Tensor  # () int32, on the host
    vr: Any  # row factors (or the full v of a vector)
    vc: Any  # column factors (or a (1,) zero for a vector)


def _is_factored(p) -> bool:
    return p.dim() >= 2


class Leaf:
    """One parameter as the update reads it: gradient ``g``, parameter
    ``p`` and factors ``vr``, ``vc``, whole, as one block. ``update`` holds
    the update to add to ``p`` (in its dtype) once the step has run."""

    def __init__(self, g, p, vr, vc):
        self.g, self.p, self.vr, self.vc = g, p, vr, vc
        self.shape = tuple(p.shape)
        self.update = None

    def each(self, fn: Callable[[int], Any]) -> list:
        """fn of each block index, in order."""
        return [fn(0)]

    def add(self, parts: list, dim: int | None) -> list:
        """The blocks' partial sums over the parameter's dimension ``dim``
        (None: over all of it), each block's the whole sum."""
        return parts

    def grad(self, i: int) -> torch.Tensor:
        """Block i's gradient in float32, a tensor of its own."""
        return self.g.to(torch.float32, copy=True)

    def factors(self, i: int) -> tuple:
        """(vr, vc, whether block i writes vr, whether it writes vc)."""
        return self.vr, self.vc, True, True

    def param(self, i: int) -> torch.Tensor:
        return self.p

    def apply(self, i: int, u: torch.Tensor) -> None:
        """Block i's update ``u`` (float32)."""
        self.update = u.to(self.p.dtype)


def leaf_update(leaf: Leaf, beta, lr, *, eps: float, clip_threshold: float,
                weight_decay: float) -> None:
    """Adafactor's step on one leaf: the factors updated in place, the
    update handed to ``leaf.apply`` block by block. u is recomputed for the
    update rather than kept, so one block's float32 u is alive at a time."""
    shape = leaf.shape
    factored = len(shape) >= 2
    if factored:
        def partials(i):
            g2 = leaf.grad(i).square_().add_(eps)
            return g2.sum(-1), g2.sum(-2)

        sums = leaf.each(partials)
        rows = leaf.add([r for r, _ in sums], -1)
        cols = leaf.add([c for _, c in sums], -2)
        del sums

        def moments(i):
            vr, vc, own_r, own_c = leaf.factors(i)
            if own_r:
                vr.mul_(beta).add_(((1 - beta) * (rows[i] / shape[-1])).to(vr.device))
            if own_c:
                vc.mul_(beta).add_(((1 - beta) * (cols[i] / shape[-2])).to(vc.device))
            return vr.sum(-1, keepdim=True)

        rsum = leaf.add(leaf.each(moments), -2)
        del rows, cols
    else:
        def moments(i):
            vr, _, own, _ = leaf.factors(i)
            if own:
                vr.mul_(beta).add_(((1 - beta) * leaf.grad(i).square_().add_(eps)).to(vr.device))

        leaf.each(moments)

    def u_of(i):
        vr, vc, _, _ = leaf.factors(i)
        u = leaf.grad(i)
        if factored:
            r = vr / torch.clamp_min(rsum[i].to(vr.device) / shape[-2], eps)
            return u.mul_(torch.rsqrt(r[..., None])).mul_(
                torch.rsqrt(torch.clamp_min(vc, eps))[..., None, :])
        return u.mul_(torch.rsqrt(torch.clamp_min(vr, eps)))

    total = leaf.add(leaf.each(lambda i: torch.sum(u_of(i).square_())), None)[0]
    rms_u = torch.sqrt(total / math.prod(shape) + 1e-12)
    shrink = torch.clamp_min(rms_u / clip_threshold, 1.0)

    def apply(i):
        u = u_of(i)
        u.div_(shrink.to(u.device))
        if weight_decay:
            u = u + weight_decay * leaf.param(i).to(torch.float32)
        leaf.apply(i, u.mul_(-lr))

    leaf.each(apply)


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
    def update(grads, state: AdafactorState, params, lr, *, leaves=None):
        """(updates, state). With ``leaves`` (an iterable of :class:`Leaf`,
        for a step that splits the parameters) in place of ``grads`` and
        ``params``, the leaves apply their own updates: (None, state)."""
        step = state.step + 1
        t = step.to(torch.float32)
        beta = 1.0 - t**-decay  # increasing decay schedule
        hp = {"eps": eps, "clip_threshold": clip_threshold, "weight_decay": weight_decay}
        new = AdafactorState(step=step, vr=state.vr, vc=state.vc)
        if leaves is not None:
            for leaf in leaves:
                leaf_update(leaf, beta, lr, **hp)
            return None, new
        ps, rebuild = tree_flatten(params)
        updates = []
        for g, vr, vc, p in zip(tree_flatten(grads)[0], tree_flatten(state.vr)[0],
                                tree_flatten(state.vc)[0], ps):
            leaf = Leaf(g, p, vr, vc)
            leaf_update(leaf, beta, lr, **hp)
            updates.append(leaf.update)
        return rebuild(updates), new

    return init, update
