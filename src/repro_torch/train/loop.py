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
  * :func:`make_sharded_train_step` — the reference's ``jax.jit`` of
    :func:`make_train_step` over ``train_state_pspecs``-sharded state:
    tensor parallelism over 'model' (:mod:`repro_torch.models.sharded`) and
    ZeRO-1 AdamW over the data axes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.mesh import (
    DeviceMesh,
    axis_size,
    backward_pass,
    entry_axes,
    one_pass,
    tally,
    tensor_bytes,
    walk,
)
from repro_torch.models import sharded as SHD
from repro_torch.models.model import ArchConfig, forward, init_params
from repro_torch.models.sharding_utils import reduce_scatter
from repro_torch.optim import AdamWState, clip_by_global_norm, clip_scale, compressed_psum
from repro_torch.train.losses import IGNORE, cross_entropy
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
    """The batch on ``device``: integer inputs (tokens, labels) as int64, a
    frontend's float embeddings in their own dtype."""
    return {k: _input(v, device) for k, v in batch.items()}


def _input(v, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(v).to(device)
    return t if t.is_floating_point() else t.long()


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


def _zero_dim(pl, mp, data_axes: tuple) -> int | None:
    """The dimension ZeRO-1 splits a moment over the data axes along (None
    where no dimension divided), after checking that the moment's layout is
    the parameter's with that one split added."""
    zdim, rest = None, []
    for i, e in enumerate(mp.spec):
        axes = entry_axes(e)
        if any(a in data_axes for a in axes):
            if axes != data_axes or zdim is not None:
                raise ValueError(f"a moment split {mp.spec} over the data axes {data_axes}")
            zdim, e = i, None
        rest.append(e)
    if tuple(rest) != tuple(pl.spec):
        raise ValueError(f"a moment split {mp.spec} does not nest in its parameter's {pl.spec}")
    return zdim


def make_sharded_train_step(cfg: ArchConfig, optimizer, lr_schedule: Callable,
                            mesh: DeviceMesh, *, data_axes=("data",), grad_clip: float = 1.0,
                            impl: str = "auto"):
    """The train step over a state placed by
    :func:`repro_torch.models.sharded.place_train_state` (the parameters in
    'model' blocks, AdamW's moments also split over ``data_axes``: ZeRO-1).
    Returns train_step(state, batch) -> (state, metrics), the metrics of
    :func:`make_train_step` ('aux_loss' 0: the dense stack has no MoE).

    Each data block (B / |dp| rows) runs the sharded forward and backward
    over its row of 'model' positions (:func:`repro_torch.models.sharded.block_loss`,
    its loss divided by the whole batch's label count, so the blocks' losses
    and gradients add up to the batch's); the blocks' gradients are summed
    in float32 in position order and each position keeps its ZeRO-1 slice
    (``reduce_scatter``); the global norm is one small all-reduce of the
    slices' squares (each distinct slice once); AdamW's ``update`` runs
    unchanged on each slice of g, m, v and p (it is elementwise), and the
    updated slices are gathered over the data axes into the parameter's
    block (written in place: on one card the gather is the write). The
    state's tensors are updated in place and returned."""
    _opt_init, opt_update = optimizer
    data_axes = tuple(data_axes)
    n_dp = axis_size(mesh, data_axes)
    SHD.check_dense(cfg)

    def row(d: int) -> dict:
        return mesh.coords([data_axes], [d])

    def train_step(state: TrainState, batch: dict):
        if not isinstance(state.opt_state, AdamWState):
            raise NotImplementedError(
                f"{type(state.opt_state).__name__}: the sharded step runs AdamW (ZeRO-1); "
                "Adafactor's factored moments are not split")
        params, _ = tree_flatten(state.params)
        moments = list(zip(tree_flatten(state.opt_state.m)[0],
                           tree_flatten(state.opt_state.v)[0]))
        home = mesh.devices.flat[0]  # data block 0's first 'model' position
        batch = _on(batch, home)
        rows = next(iter(batch.values())).shape[0]
        if rows % n_dp:
            raise ValueError(f"a batch of {rows} rows does not split over {n_dp} data positions")
        size = rows // n_dp
        denom = torch.clamp_min(torch.sum(batch["labels"] != IGNORE).to(torch.float32), 1.0)
        index = [(j, key) for j, pl in enumerate(params) for key in pl.keys()]
        flat = [params[j].blocks[key] for j, key in index]
        for t in flat:
            t.requires_grad_(True)

        def part(d):
            return {k: v[d * size:(d + 1) * size] for k, v in batch.items()}

        def data_block(d):
            loss = SHD.block_loss(state.params, cfg, part(d), mesh, row(d), denom, impl=impl)
            with backward_pass():
                grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                            materialize_grads=True)
            return loss.detach(), list(grads)

        results = walk(n_dp, row, data_block, lambda d: [*part(d).values(), *flat])
        loss = results[0][0]
        for r in results[1:]:
            loss = loss + r[0].to(loss.device)
        at = {jk: i for i, jk in enumerate(index)}
        zdims = [_zero_dim(pl, mp, data_axes) for pl, (mp, _vp) in zip(params, moments)]

        # the blocks' gradients summed over the data axes: each position's slice
        slices = []
        for j, pl in enumerate(params):
            slices.append(_scatter(pl, moments[j][0], zdims[j], results, at, j, n_dp, row))
            for r in results:
                for key in pl.keys():
                    r[1][at[j, key]] = None
        del results

        # the global norm: each distinct slice's squares, one scalar a position
        total = None
        for j, (mp, _vp) in enumerate(moments):
            keys = mp.keys()
            sq = walk(len(keys), lambda i, mp=mp, keys=keys: mp.coords(keys[i]),
                      lambda i, j=j, keys=keys: torch.sum(slices[j][keys[i]].to(torch.float32)
                                                          ** 2),
                      lambda i, j=j, keys=keys: [slices[j][keys[i]]])
            for x in sq:
                total = x if total is None else total + x.to(total.device)
        tally("all-reduce", 4)
        gnorm = torch.sqrt(total)
        scale = clip_scale(gnorm, grad_clip)
        lr = lr_schedule(state.step)

        new_step = state.opt_state.step + 1
        for j, pl in enumerate(params):
            _update(pl, *moments[j], zdims[j], slices[j], scale, state.opt_state.step, lr,
                    opt_update, data_axes, mesh)
            slices[j] = None
        opt_state = AdamWState(step=new_step, m=state.opt_state.m, v=state.opt_state.v)
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        return (TrainState(params=state.params, opt_state=opt_state, step=state.step + 1),
                _metrics(loss, aux, gnorm, lr))

    return train_step


def _scatter(pl, mp, zdim, results, at, j: int, n_dp: int, row) -> dict:
    """Leaf j's data blocks' gradients reduce-scattered into its moment's
    slices: {moment key: slice in the parameter's dtype}."""
    keys = pl.keys()

    def one(i):
        return reduce_scatter([r[1][at[j, keys[i]]] for r in results], zdim, n_dp)

    per_key = walk(len(keys), lambda i: pl.coords(keys[i]), one,
                   lambda i: [r[1][at[j, keys[i]]] for r in results])
    out = {}
    for key, sl in zip(keys, per_key):
        for d, g in enumerate(sl):
            out[mp.key({**pl.coords(key), **row(d)})] = g.to(pl.dtype)
    return out


def _update(pl, mp, vp, zdim, slices: dict, scale, step, lr, opt_update, data_axes, mesh):
    """AdamW on each distinct slice of leaf pl, at its position; the slice
    of the parameter's block written in place, then gathered over the data
    axes."""
    keys = mp.keys()

    def one(i):
        coords = mp.coords(keys[i])
        with torch.no_grad():
            g = slices[keys[i]]
            g = (g.to(torch.float32) * scale).to(g.dtype)
            p_block = pl.at(coords)
            p = p_block
            if zdim is not None:
                d = int(np.ravel_multi_index([coords[a] for a in data_axes],
                                             [mesh.shape[a] for a in data_axes]))
                width = mp.blocks[keys[i]].shape[zdim]
                p = p_block.narrow(zdim, d * width, width)
            u, _ = opt_update({"g": g}, AdamWState(step=step, m={"g": mp.blocks[keys[i]]},
                                                   v={"g": vp.blocks[keys[i]]}), {"g": p}, lr)
            p.add_(u["g"].to(p.dtype))
            if zdim is not None:
                tally("all-gather", tensor_bytes(p_block))
                with one_pass() as moves:
                    moves(p, p_block)

    walk(len(keys), lambda i: mp.coords(keys[i]), one,
         lambda i: [slices[keys[i]], mp.blocks[keys[i]], vp.blocks[keys[i]],
                    pl.at(mp.coords(keys[i]))])
