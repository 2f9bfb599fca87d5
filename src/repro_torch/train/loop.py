"""Training step factories (mirror ``repro.train.loop``): loss, gradients,
clipping, the optimizer, microbatching, and explicit data parallelism.

The parameters are the model's tree of tensors (:mod:`repro_torch.models`);
a step turns on their ``requires_grad``, takes the gradients with
``torch.autograd.grad`` and adds the optimizer's updates to them in place
(the reference returns new arrays; the returned state shares the tensors).
``cfg.remat`` recomputes each layer group in the backward pass
(``torch.utils.checkpoint``, as ``jax.checkpoint`` wraps the reference's
scan body). On the card causal self-attention runs through the flash kernel
(``impl``, as in :mod:`repro_torch.kernels.ops`), whose gradient is that of
its plain version.

  * :func:`make_train_step` — one device. With ``microbatches > 1`` the
    batch is split along its leading axis and float32 gradients are summed
    over the pieces in order, then scaled by 1 / microbatches, as the
    reference's scan does.
  * :func:`make_shardmap_train_step` — the reference's explicit-DP
    ``shard_map`` step over a :class:`~repro_torch.mesh.DeviceMesh`: the
    batch in S contiguous blocks, one a data shard, each shard's gradients
    of its block with the replicated parameters, the int8-compressed sum
    (:func:`~repro_torch.optim.compression.compressed_psum`), ``/ S``, the
    shard losses' mean, then one replicated optimizer step. The shards run
    one after another in one process (:mod:`repro_torch.mesh`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.mesh import DeviceMesh, walk
from repro_torch.models.model import ArchConfig, forward, init_params
from repro_torch.optim import clip_by_global_norm, compressed_psum
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


def _value_and_grad(cfg: ArchConfig, impl: str, leaves, rebuild, batch):
    """(loss, aux, gradients of the leaves) of one batch; the leaves must
    require gradients."""
    loss, aux = loss_fn(rebuild(leaves), cfg, batch, impl=impl)
    # a leaf the loss does not read (whisper's encoder under a token-only
    # batch) gets a zero gradient, as under jax.grad
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss.detach(), torch.as_tensor(aux).detach(), grads


def _apply(state: TrainState, grads, opt_update, lr_schedule, grad_clip: float):
    """Clip, the optimizer's update added to the parameters in place:
    (new state, grad norm, lr)."""
    grads, gnorm = clip_by_global_norm(grads, grad_clip)
    lr = lr_schedule(state.step)
    updates, opt_state = opt_update(grads, state.opt_state, state.params, lr)
    del grads
    with torch.no_grad():
        for p, u in zip(tree_flatten(state.params)[0], tree_flatten(updates)[0]):
            p.add_(u.to(p.dtype))
    return TrainState(params=state.params, opt_state=opt_state, step=state.step + 1), gnorm, lr


def _metrics(loss, aux, gnorm, lr) -> dict:
    return {"loss": loss, "aux_loss": aux, "grad_norm": gnorm,
            "lr": torch.as_tensor(lr, dtype=torch.float32)}


def make_train_step(cfg: ArchConfig, optimizer, lr_schedule: Callable, *,
                    grad_clip: float = 1.0, microbatches: int = 1, impl: str = "auto"):
    """Returns train_step(state, batch) -> (state, metrics): metrics
    'loss', 'aux_loss', 'grad_norm' and 'lr', 0-d float32 tensors ('lr' on
    the host). ``batch`` holds (B, S) arrays or tensors, B a multiple of
    ``microbatches``."""
    _opt_init, opt_update = optimizer

    def grads_of(params, batch):
        leaves, rebuild = tree_flatten(params)
        for p in leaves:
            p.requires_grad_(True)
        if microbatches == 1:
            loss, aux, grads = _value_and_grad(cfg, impl, leaves, rebuild, batch)
            return loss, aux, rebuild(list(grads))
        size = next(iter(batch.values())).shape[0] // microbatches
        loss_a = aux_a = 0.0
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        for i in range(microbatches):
            part = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            loss, aux, grads = _value_and_grad(cfg, impl, leaves, rebuild, part)
            for a, g in zip(acc, grads):
                a.add_(g)
            loss_a, aux_a = loss_a + loss, aux_a + aux
            del grads
        inv = 1.0 / microbatches
        return loss_a * inv, aux_a * inv, rebuild([a * inv for a in acc])

    def train_step(state: TrainState, batch: dict):
        dev = tree_flatten(state.params)[0][0].device
        loss, aux, grads = grads_of(state.params, _on(batch, dev))
        state, gnorm, lr = _apply(state, grads, opt_update, lr_schedule, grad_clip)
        return state, _metrics(loss, aux, gnorm, lr)

    return train_step


def make_shardmap_train_step(cfg: ArchConfig, optimizer, lr_schedule: Callable,
                             mesh: DeviceMesh, *, data_axes=("data",), grad_clip: float = 1.0,
                             compress_grads: bool = True, impl: str = "auto"):
    """Explicit-DP training step: the batch sharded over ``data_axes`` of
    ``mesh`` (S = the product of their sizes; other axes replicate, so their
    work is done once), the parameters replicated, an int8-compressed
    gradient sum. Returns train_step(state, batch) -> (state, metrics), the
    metrics of :func:`make_train_step` with the loss the mean of the shard
    losses and 'aux_loss' shard 0's (the reference's ``aux`` leaves its
    ``shard_map`` unreduced, and ``out_specs=P()`` returns shard 0's).

    Shard s takes rows [s B/S, (s+1) B/S) of the batch (``P(data_axes)``)
    on its device; on the parameters' device the shards share the
    parameter tensors, elsewhere the step copies them there. Each shard's
    activations are freed before the next shard runs, so at most S
    gradient sets are alive (the shared scale needs every shard's max);
    the sum goes leaf by leaf, each leaf's S copies freed once summed. The
    summed gradients are divided by S in their dtype, then clipped and
    applied once, on the parameters' device. Shard s runs at its position
    of the mesh (:func:`repro_torch.mesh.walk`), for an op counter."""
    _opt_init, opt_update = optimizer
    devices = list(mesh.grid(data_axes).reshape(-1))
    nshards = len(devices)

    def train_step(state: TrainState, batch: dict):
        leaves, rebuild = tree_flatten(state.params)
        home = leaves[0].device
        batch = _on(batch, home)
        rows = next(iter(batch.values())).shape[0]
        if rows % nshards:
            raise ValueError(f"a batch of {rows} rows does not split over {nshards} data shards")
        size = rows // nshards

        def block(s):
            return {k: v[s * size:(s + 1) * size] for k, v in batch.items()}

        def shard(s):
            dev = devices[s]
            local = leaves if dev == home else [p.detach().to(dev) for p in leaves]
            for p in local:
                p.requires_grad_(True)
            part = {k: v.to(dev) for k, v in block(s).items()}
            loss, aux, grads = _value_and_grad(cfg, impl, local, rebuild, part)
            return loss, aux, list(grads)

        results = walk(nshards, lambda s: mesh.coords([data_axes], [s]), shard,
                       lambda s: [*block(s).values(), *leaves])
        losses = [r[0] for r in results]
        auxes = [r[1] for r in results]
        shard_grads = [list(r[2]) for r in results]
        del results
        summed = []
        for j, leaf in enumerate(leaves):
            g = compressed_psum([sg[j] for sg in shard_grads], enabled=compress_grads)
            for sg in shard_grads:
                sg[j] = None
            summed.append((g / nshards).to(leaf.device))
        del shard_grads
        total = losses[0]
        for x in losses[1:]:
            total = total + x.to(total.device)
        state, gnorm, lr = _apply(state, rebuild(summed), opt_update, lr_schedule, grad_clip)
        return state, _metrics(total / nshards, auxes[0], gnorm, lr)

    return train_step
