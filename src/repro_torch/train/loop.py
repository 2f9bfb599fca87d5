"""Training step factory (mirrors ``repro.train.loop.make_train_step``):
loss, gradients, clipping, the optimizer, microbatching.

The parameters are the model's tree of tensors (:mod:`repro_torch.models`);
the step turns on their ``requires_grad``, takes the gradients with
``torch.autograd.grad`` and adds the optimizer's updates to them in place
(the reference returns new arrays; the returned state shares the tensors).
With ``microbatches > 1`` the batch is split along its leading axis and
float32 gradients are summed over the pieces in order, then scaled by
1 / microbatches, as the reference's scan does. ``cfg.remat`` recomputes
each layer group in the backward pass (``torch.utils.checkpoint``, as
``jax.checkpoint`` wraps the reference's scan body). On the card causal
self-attention runs through the flash kernel (``impl``, as in
:mod:`repro_torch.kernels.ops`), whose gradient is that of its plain
version.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models.model import ArchConfig, forward, init_params
from repro_torch.optim import clip_by_global_norm
from repro_torch.train.losses import cross_entropy
from repro_torch.utils import tree_flatten


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor  # () int32, on the host (as the optimizers' step)


def train_state_init(generator: torch.Generator, cfg: ArchConfig, opt_init,
                     device: str | torch.device = "cuda") -> TrainState:
    """Seeded parameters on ``device`` (:func:`init_params`), the
    optimizer's initial state, step 0."""
    params = init_params(generator, cfg, device=device)
    return TrainState(params=params, opt_state=opt_init(params),
                      step=torch.zeros((), dtype=torch.int32))


def loss_fn(params, cfg: ArchConfig, batch: dict, aux_weight: float = 0.01, *,
            impl: str = "auto"):
    """(loss, aux) of a batch {'tokens', 'labels'} (B, S)."""
    logits, aux = forward(params, cfg, batch, impl=impl)
    loss = cross_entropy(logits, batch["labels"]) + aux_weight * aux
    return loss, aux


def _on(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device=device, dtype=torch.long) for k, v in batch.items()}


def make_train_step(cfg: ArchConfig, optimizer, lr_schedule: Callable, *,
                    grad_clip: float = 1.0, microbatches: int = 1, impl: str = "auto"):
    """Returns train_step(state, batch) -> (state, metrics): metrics
    'loss', 'aux_loss', 'grad_norm' and 'lr', 0-d float32 tensors ('lr' on
    the host). ``batch`` holds (B, S) arrays or tensors, B a multiple of
    ``microbatches``."""
    _opt_init, opt_update = optimizer

    def value_and_grad(leaves, rebuild, batch):
        loss, aux = loss_fn(rebuild(leaves), cfg, batch, impl=impl)
        # a leaf the loss does not read (whisper's encoder under a token-only
        # batch) gets a zero gradient, as under jax.grad
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return loss.detach(), torch.as_tensor(aux).detach(), grads

    def grads_of(params, batch):
        leaves, rebuild = tree_flatten(params)
        for p in leaves:
            p.requires_grad_(True)
        if microbatches == 1:
            loss, aux, grads = value_and_grad(leaves, rebuild, batch)
            return loss, aux, rebuild(list(grads))
        size = next(iter(batch.values())).shape[0] // microbatches
        loss_a = aux_a = 0.0
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        for i in range(microbatches):
            part = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            loss, aux, grads = value_and_grad(leaves, rebuild, part)
            for a, g in zip(acc, grads):
                a.add_(g)
            loss_a, aux_a = loss_a + loss, aux_a + aux
            del grads
        inv = 1.0 / microbatches
        return loss_a * inv, aux_a * inv, rebuild([a * inv for a in acc])

    def train_step(state: TrainState, batch: dict):
        dev = tree_flatten(state.params)[0][0].device
        loss, aux, grads = grads_of(state.params, _on(batch, dev))
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        lr = lr_schedule(state.step)
        updates, opt_state = opt_update(grads, state.opt_state, state.params, lr)
        del grads
        with torch.no_grad():
            for p, u in zip(tree_flatten(state.params)[0], tree_flatten(updates)[0]):
                p.add_(u.to(p.dtype))
        metrics = {"loss": loss, "aux_loss": aux, "grad_norm": gnorm,
                   "lr": torch.as_tensor(lr, dtype=torch.float32)}
        return TrainState(params=state.params, opt_state=opt_state, step=state.step + 1), metrics

    return train_step
