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

import contextlib
import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.mesh import (
    DeviceMesh,
    axis_size,
    backward_pass,
    block,
    entry_axes,
    one_pass,
    position_slice,
    set_mesh,
    uncounted,
    tally,
    tensor_bytes,
    walk,
)
from repro_torch.models import sharded as SHD
from repro_torch.models.model import ArchConfig, forward, init_params
from repro_torch.models.sharding_utils import model_sum, reduce_scatter
from repro_torch.optim import (
    AdafactorState,
    AdamWState,
    clip_by_global_norm,
    clip_scale,
    compressed_psum,
)
from repro_torch.optim.adafactor import Leaf
from repro_torch.train.losses import IGNORE, cross_entropy
from repro_torch.utils import tree_flatten

MODEL = "model"


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


#: the MoE aux loss's weight in the train loss (the reference's loss_fn default)
AUX_WEIGHT = 0.01


def loss_fn(params, cfg: ArchConfig, batch: dict, aux_weight: float = AUX_WEIGHT, *,
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
    gradient sum. A shard's MoE takes the shard's rows as one dispatch
    chunk; ``moe_impl="manual"`` runs it over the shard's (1, |model|)
    slice of the grid (:func:`repro_torch.mesh.position_slice` at the
    shard's data coordinates, the ambient mesh while the shard runs). Returns train_step(state, batch) -> (state, metrics), the
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
    # a shard's MoE takes its rows as one dispatch chunk; the manual MoE
    # runs over the shard's (1, |model|) slice of the grid
    shard_cfg = dataclasses.replace(cfg, moe_dispatch_chunks=1)

    def train_step(state: TrainState, batch: dict):
        leaves, rebuild = tree_flatten(state.params)
        home = leaves[0].device
        batch = _on(batch, home)
        rows = next(iter(batch.values())).shape[0]
        if rows % nshards:
            raise ValueError(f"a batch of {rows} rows does not split over {nshards} data shards")
        size = rows // nshards

        def rows_of(s):
            return {k: v[s * size:(s + 1) * size] for k, v in batch.items()}

        def shard(s):
            dev = devices[s]
            local = leaves if dev == home else [p.detach().to(dev) for p in leaves]
            for p in local:
                p.requires_grad_(True)
            part = {k: v.to(dev) for k, v in rows_of(s).items()}
            with set_mesh(position_slice(mesh, data_axes, mesh.coords([data_axes], [s]))):
                loss, aux, grads = _value_and_grad(shard_cfg, impl, local, rebuild, part)
            return loss, aux, list(grads)

        results = walk(nshards, lambda s: mesh.coords([data_axes], [s]), shard,
                       lambda s: [*rows_of(s).values(), *leaves])
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
    'model' blocks; AdamW's moments also split over ``data_axes``, ZeRO-1;
    Adafactor's factored moments split as their parameter is, no ZeRO-1).
    Returns train_step(state, batch) -> (state, metrics), the metrics of
    :func:`make_train_step` ('aux_loss' the MoE's, 0 without one).

    Each data block (B / |dp| rows) runs the sharded forward and backward
    over its row of 'model' positions (:func:`repro_torch.models.sharded.block_loss`,
    its loss divided by the whole batch's label count, so the blocks' losses
    and gradients add up to the batch's). The MoE's aux loss is added once
    for the batch, ``AUX_WEIGHT`` times :func:`~repro_torch.models.sharded.moe_aux`:
    with ``moe_impl="manual"`` each block adds its own share; with
    ``"gspmd"`` the aux needs every block's routing, so every block's
    forward runs first (their graphs kept), the statistics are summed over
    the data axes, and then each block's backward runs with its term. The
    blocks' gradients are added up in block order as the backward passes
    make them (one set alive, in the leaves' dtype: float32 for float32
    leaves; a bf16 leaf's sum rounds to bf16 at each of the |dp| - 1
    additions, as a bf16 all-reduce's does), then each position keeps its
    slice of the sum: under AdamW its ZeRO-1 slice (``reduce_scatter``),
    under Adafactor its whole block (an all-reduce). The global norm is one
    small all-reduce of the slices' squares (each distinct slice once).
    AdamW's ``update`` runs unchanged on each slice of g, m, v and p (it is
    elementwise) and the updated slices are gathered over the data axes
    into the parameter's block (written in place: on one card the gather
    is the write). Adafactor's is not elementwise: the optimizer's own
    arithmetic runs on each leaf's blocks (:class:`_SplitLeaf`), the row,
    column and RMS means' partial sums added over 'model'. The state's
    tensors are updated in place and returned."""
    _opt_init, opt_update = optimizer
    data_axes = tuple(data_axes)
    n_dp = axis_size(mesh, data_axes)
    SHD.check_supported(cfg)

    def row(d: int) -> dict:
        return mesh.coords([data_axes], [d])

    def train_step(state: TrainState, batch: dict):
        factored = isinstance(state.opt_state, AdafactorState)
        if not factored and not isinstance(state.opt_state, AdamWState):
            raise NotImplementedError(
                f"{type(state.opt_state).__name__}: the sharded step runs AdamW or Adafactor")
        params, _ = tree_flatten(state.params)
        home = mesh.devices.flat[0]  # data block 0's first 'model' position
        batch = _on(batch, home)
        rows = next(iter(batch.values())).shape[0]
        if rows % n_dp:
            raise ValueError(f"a batch of {rows} rows does not split over {n_dp} data positions")
        size = rows // n_dp
        tokens = size * batch["tokens"].shape[1]
        denom = torch.clamp_min(torch.sum(batch["labels"] != IGNORE).to(torch.float32), 1.0)
        index = [(j, key) for j, pl in enumerate(params) for key in pl.keys()]
        reads, flat, slots = _grad_leaves(state.params)
        # the blocks' gradients summed so far, one a leaf block (a list of one
        # a layer group for a stacked block), each the first that comes
        stacked = {i for i, g in slots if g is not None}
        acc = [[None] * cfg.n_groups if i in stacked else None for i in range(len(index))]

        def part(d):
            return {k: v[d * size:(d + 1) * size] for k, v in batch.items()}

        def forward(d):
            return SHD.block_loss(reads, cfg, part(d), mesh, row(d), denom, impl=impl)

        def backward(loss, term):
            """The block's cross entropy; its gradients (with its aux
            term's) added into ``acc``."""
            total = loss if term is None else loss + AUX_WEIGHT * term
            with backward_pass(), _accumulating(flat, slots, acc):
                torch.autograd.grad(total, flat, allow_unused=True)
            return loss.detach()

        if SHD.blockwise_aux(cfg):
            def data_block(d):
                loss, stats = forward(d)
                term = None
                if stats is not None:
                    aux, (term,) = SHD.moe_aux(cfg, [stats], tokens, n_dp)
                return backward(loss, term), None if term is None else aux

            results = walk(n_dp, row, data_block, lambda d: [*part(d).values(), *flat])
            losses = [r[0] for r in results]
            auxes = [r[1] for r in results if r[1] is not None]
            aux = auxes[0] if auxes else torch.zeros((), dtype=torch.float32, device=home)
            for a in auxes[1:]:
                aux = aux + a.to(aux.device)
        else:
            outs = walk(n_dp, row, forward, lambda d: [*part(d).values(), *flat])
            aux, terms = SHD.moe_aux(cfg, [o[1] for o in outs], tokens)
            losses = walk(n_dp, row, lambda d: backward(outs[d][0], terms[d]))
            del outs, terms
        loss = losses[0]
        for x in losses[1:]:
            loss = loss + x.to(loss.device)
        aux = aux.to(loss.device)
        loss = loss + AUX_WEIGHT * aux
        at = {jk: i for i, jk in enumerate(index)}
        if factored:
            holders, zdims = params, [None] * len(params)
        else:
            holders = tree_flatten(state.opt_state.m)[0]
            zdims = [_zero_dim(pl, mp, data_axes) for pl, mp in zip(params, holders)]

        # the blocks' gradients summed over the data axes: each position's slice
        slices = []
        for j, pl in enumerate(params):
            slices.append(_scatter(pl, holders[j], zdims[j], acc, at, j, n_dp, row))
            for key in pl.keys():
                acc[at[j, key]] = None

        # the global norm: each distinct slice's squares, one scalar a position
        total = None
        for j, hp in enumerate(holders):
            keys = hp.keys()
            sq = walk(len(keys), lambda i, hp=hp, keys=keys: hp.coords(keys[i]),
                      lambda i, j=j, keys=keys: torch.sum(slices[j][keys[i]].to(torch.float32)
                                                          ** 2),
                      lambda i, j=j, keys=keys: [slices[j][keys[i]]])
            for x in sq:
                total = x if total is None else total + x.to(total.device)
        tally("all-reduce", 4)
        gnorm = torch.sqrt(total)
        scale = clip_scale(gnorm, grad_clip)
        lr = lr_schedule(state.step)

        opt = state.opt_state
        if factored:
            vrs, vcs = tree_flatten(opt.vr)[0], tree_flatten(opt.vc)[0]

            def leaves():
                for j, pl in enumerate(params):
                    leaf = _SplitLeaf(pl, vrs[j], vcs[j], slices[j], scale)
                    yield leaf
                    leaf.gather_kept()
                    slices[j] = None

            _, opt_state = opt_update(None, opt, None, lr, leaves=leaves())
        else:
            vs = tree_flatten(opt.v)[0]
            for j, pl in enumerate(params):
                _update(pl, holders[j], vs[j], zdims[j], slices[j], scale, opt.step, lr,
                        opt_update, data_axes, mesh)
                slices[j] = None
            opt_state = dataclasses.replace(opt, step=opt.step + 1)
        return (TrainState(params=state.params, opt_state=opt_state, step=state.step + 1),
                _metrics(loss, aux, gnorm, lr))

    return train_step


def _scatter(pl, mp, zdim, acc, at, j: int, n_dp: int, row) -> dict:
    """Leaf j's gradient, summed over the data blocks (``acc``, in the
    parameter's dtype; a stacked block's groups stacked, zeros where no
    gradient came), reduce-scattered into its moment's slices: {moment
    key: slice}."""
    keys = pl.keys()

    def one(i):
        held, like = acc[at[j, keys[i]]], pl.blocks[keys[i]]
        if isinstance(held, list):  # a stacked block's groups
            held = torch.stack([torch.zeros_like(like[g]) if h is None else h
                                for g, h in enumerate(held)])
        return reduce_scatter(torch.zeros_like(like) if held is None else held, zdim, n_dp)

    per_key = walk(len(keys), lambda i: pl.coords(keys[i]), one,
                   lambda i: [pl.blocks[keys[i]]])
    out = {}
    for key, sl in zip(keys, per_key):
        for d, g in enumerate(sl):
            out[mp.key({**pl.coords(key), **row(d)})] = g
    return out


def _grad_leaves(tree) -> tuple:
    """The placed parameters as the forward reads them while gradients are
    taken: each block a leaf tensor of its own on the block's storage, and
    a stacked block of the layer groups (under "blocks") one leaf a group.
    Autograd hands a leaf its gradient once the last op that read it has
    run its backward, so each group's gradients are added into the sum and
    freed while the groups below run theirs (the views of a stack, made
    before the forward, would run their backward last and hold every
    group's gradients until then). Returns (the tree to read, the leaves,
    (block index, group or None) of each leaf), the block index in the
    order of ``tree_flatten(tree)``'s leaves and their keys."""
    leaves, rebuild = tree_flatten(tree)
    stacked = {id(pl) for pl in tree_flatten(tree["blocks"])[0]}
    new, flat, slots = [], [], []
    i = 0  # the block's index
    for pl in leaves:
        blocks = {}
        for key in pl.keys():
            b = pl.blocks[key].detach()
            if id(pl) in stacked:
                blocks[key] = tuple(t.requires_grad_(True) for t in b.unbind(0))
                flat.extend(blocks[key])
                slots.extend((i, g) for g in range(len(blocks[key])))
            else:
                blocks[key] = b.requires_grad_(True)
                flat.append(blocks[key])
                slots.append((i, None))
            i += 1
        new.append(SHD.Placed(pl.spec, pl.shape, pl.dtype, pl.mesh, blocks))
    return rebuild(new), flat, slots


@contextlib.contextmanager
def _accumulating(flat, slots, acc: list):
    """While a data block's backward pass runs: each leaf's gradient kept
    as its block's sum in ``acc`` (slot (i, g): ``acc[i]``, or its group
    g) where it is the first to come, else added into it (in the leaf's
    dtype, in block order; uncounted, as the sum is the reduce-scatter's)
    as autograd makes it, and a zero view handed on in its place, so that
    one set of gradients is alive, not one a block."""
    quiet = uncounted()

    def add(i, g):
        def hook(grad):
            with quiet():
                held = acc[i] if g is None else acc[i][g]
                if held is None:
                    held = grad.contiguous()
                    if g is None:
                        acc[i] = held
                    else:
                        acc[i][g] = held
                else:
                    held.add_(grad.to(held.device))
                return torch.zeros((), dtype=grad.dtype, device=grad.device).expand(grad.shape)
        return hook

    handles = [t.register_hook(add(*slot)) for t, slot in zip(flat, slots)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


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


def _moment_blocks(mom, derived, pl) -> tuple[list, list, bool]:
    """Adafactor moment ``mom`` as each position of leaf pl reads it, in
    the layout the parameter's block reduces to (``derived``: its spec
    without the reduced dimension): (the views in position order, whether
    each position writes its view: a block every position holds, the
    first; whether the moment is kept whole where that layout splits it,
    as lm_head's column factor is: the positions update their slices of the
    whole tensor in place, which are then gathered)."""
    ndim = len(mom.shape)
    stored, derived = SHD._full(mom.spec, ndim), SHD._full(derived, ndim)
    kept = stored != derived
    if kept and any(e is not None for e in stored):
        raise NotImplementedError(f"an Adafactor moment split {mom.spec} where its parameter's "
                                  f"block reduces to {derived}")
    keys = pl.keys()
    views = [block(mom.at({}), derived, mom.mesh, pl.coords(k)) if kept
             else mom.at(pl.coords(k)) for k in keys]
    mine = any(MODEL in entry_axes(e) for e in derived)
    return views, [mine or i == 0 for i in range(len(keys))], kept


class _SplitLeaf(Leaf):
    """Leaf pl's 'model' blocks for Adafactor's arithmetic
    (:func:`repro_torch.optim.adafactor.leaf_update`), each block run at its
    position, with ``grads`` the summed gradient of each block, clipped by
    ``scale``. The row mean of g^2 over a split last dimension, the column
    mean over a split second-to-last one and the mean of the new row factor
    over a split dimension are float32 partial sums added over 'model' in
    position order (an all-reduce each); the update's RMS is one over the
    leaf's blocks (4 bytes). The parameter's blocks are updated in place."""

    def __init__(self, pl, vr, vc, grads: dict, scale):
        self.pl, self.grads, self.scale = pl, grads, scale
        self.keys = pl.keys()
        self.n = len(self.keys)
        self.shape = tuple(pl.shape)
        spec = SHD._full(pl.spec, len(pl.shape))
        self.split = [MODEL in entry_axes(e) for e in spec]
        factored = len(pl.shape) >= 2
        self.vr_views, self.vr_own, vr_kept = _moment_blocks(
            vr, spec[:-1] if factored else spec, pl)
        self.vc_views, self.vc_own, vc_kept = (
            _moment_blocks(vc, spec[:-2] + spec[-1:], pl) if factored
            else ([None] * self.n, [False] * self.n, False))
        self.kept = [mom for mom, kept in ((vr, vr_kept), (vc, vc_kept)) if kept]

    def each(self, fn):
        return walk(self.n, lambda i: self.pl.coords(self.keys[i]), fn)

    def add(self, parts, dim):
        if dim is None:
            total = parts[0]
            for x in parts[1:]:
                total = total + x.to(total.device)
            if self.n > 1:
                tally("all-reduce", 4)
            return [total] * self.n
        if not self.split[dim] or self.n == 1:
            return parts
        return [model_sum(parts)] * self.n

    def grad(self, i):
        """The clipped gradient, rounded to its dtype, in float32."""
        g = self.grads[self.keys[i]]
        clipped = g.to(torch.float32) * self.scale.to(g.device)
        return clipped.to(g.dtype).to(torch.float32) if g.dtype != torch.float32 else clipped

    def factors(self, i):
        return self.vr_views[i], self.vc_views[i], self.vr_own[i], self.vc_own[i]

    def param(self, i):
        return self.pl.blocks[self.keys[i]]

    def apply(self, i, u):
        p = self.param(i)
        p.add_(u.to(p.dtype))

    def gather_kept(self):
        """The factors kept whole where the blocks' layout splits them, whose
        slices the positions wrote in place: one all-gather each."""
        for mom in self.kept:
            tally("all-gather", tensor_bytes(mom.at({})))
