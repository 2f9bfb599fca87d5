"""Partition specs for every arch family (mirrors ``repro.launch.sharding``,
name for name).

Megatron-style tensor parallelism over 'model': column-parallel
in-projections, row-parallel out-projections, a vocab-split embedding and
head; experts over 'model'; a decode cache split over 'model' along its
sequence (sequence parallel, which works where the KV heads are fewer than
the 'model' positions, as starcoder2's 2); the batch over the data axes
('pod', 'data'); ZeRO-1: AdamW's moments also split over the data axes on
their first free dimension that divides.

Specs come from each parameter's path (a JAX key-path string, as
:func:`repro_torch.utils.tree_flatten_with_paths` gives it), so the table
is a rule table, not one entry an arch. Every leaf under "blocks" has a
leading group axis, for which a rule gets a leading None.

The trees are of :class:`repro_torch.mesh.P`; a mesh is anything with a
``shape`` mapping axis names to sizes (a :class:`repro_torch.mesh.DeviceMesh`).
:func:`position_bytes` is the bytes one position holds of a tree under its
specs, what XLA's ``memory_analysis`` reports as a device's argument bytes;
the reference's ``to_named`` has no counterpart (the port places blocks
itself: :mod:`repro_torch.models.sharded`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.mesh import P, local_shape
from repro_torch.optim.adafactor import AdafactorState
from repro_torch.optim.adamw import AdamWState
from repro_torch.utils import tree_flatten, tree_flatten_with_paths, tree_map

MODEL = "model"


# ------------------------------------------------------------ param rules
def _param_rule(path: str, ndim: int) -> P:
    """Spec for one parameter, EXCLUDING the leading group axis."""
    p = path  # keystr like "['blocks']['l0']['attn']['wq']['w']"

    def is_(*names):
        return any(f"['{n}']" in p for n in names)

    # --- embeddings / head
    if is_("embed") and is_("table"):
        return P(MODEL, None)
    if is_("lm_head") and is_("w"):
        return P(None, MODEL)
    if is_("pos", "dec_pos"):
        return P()
    # --- attention
    if is_("attn", "cross"):
        if is_("wq", "wk", "wv"):
            return P(None, MODEL) if ndim == 2 else P(MODEL)
        if is_("wo"):
            return P(MODEL, None) if ndim == 2 else P()
    # --- rwkv time mix
    if is_("rwkv"):
        if is_("wr", "wk", "wv", "wg"):
            return P(None, MODEL) if ndim == 2 else P(MODEL)
        if is_("wo"):
            return P(MODEL, None) if ndim == 2 else P()
        if is_("u"):
            return P(MODEL, None)
        return P()  # mu, w0, lora, ln_x — small/replicated
    # --- mamba
    if is_("mamba"):
        if is_("in_proj"):
            return P(None, MODEL) if ndim == 2 else P(MODEL)
        if is_("out_proj", "x_proj"):
            return P(MODEL, None) if ndim == 2 else P()
        if is_("conv_w"):
            return P(None, MODEL)
        if is_("conv_b", "d"):
            return P(MODEL)
        if is_("a_log"):
            return P(MODEL, None)
        if is_("dt_proj"):
            return P(None, MODEL) if ndim == 2 else P(MODEL)
    # --- MoE (expert-parallel over model axis)
    if is_("moe"):
        if is_("router"):
            return P()
        return P(MODEL, None, None)  # gate/up/down (E, ., .)
    # --- dense MLPs (incl. channel mix): column-in, row-out
    if is_("ffn"):
        if is_("gate", "up", "fc", "wk"):
            return P(None, MODEL) if ndim == 2 else P(MODEL)
        if is_("down", "proj", "wv"):
            return P(MODEL, None) if ndim == 2 else P()
        if is_("wr"):
            return P(None, MODEL) if ndim == 2 else P(MODEL)
        return P()
    # --- norms & everything else: replicated
    return P()


def param_pspecs(params_shape: Any) -> Any:
    """The spec tree of a parameter tree (tensors or ``meta`` tensors)."""
    paths, leaves, rebuild = tree_flatten_with_paths(params_shape)
    specs = []
    for pstr, leaf in zip(paths, leaves):
        grouped = "['blocks']" in pstr or "['encoder']['blocks']" in pstr
        ndim = len(leaf.shape) - (1 if grouped else 0)
        spec = _param_rule(pstr, ndim)
        if grouped:
            spec = P(None, *spec)
        # never shard an axis that the leaf doesn't have (scalars etc.)
        if len(spec) > len(leaf.shape):
            spec = P(*spec[: len(leaf.shape)])
        specs.append(spec)
    return rebuild(specs)


# ----------------------------------------------------- optimizer (ZeRO-1)
def _zero1(spec: P, shape, dp: tuple[str, ...], dp_size: int) -> P:
    """Shard an f32 moment over the DP axes on the first free divisible dim."""
    spec_t = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = list(spec_t)
    for i, (s, ax) in enumerate(zip(shape, spec_t)):
        if ax is None and s % dp_size == 0 and s >= dp_size:
            out[i] = dp
            break
    return P(*out)


def opt_pspecs(opt_shape: Any, pspecs: Any, dp: tuple[str, ...], mesh) -> Any:
    dp_size = int(math.prod(mesh.shape[a] for a in dp))
    if isinstance(opt_shape, AdamWState):
        moments = tree_map(lambda leaf, spec: _zero1(spec, leaf.shape, dp, dp_size),
                           opt_shape.m, pspecs)
        return AdamWState(step=P(), m=moments, v=moments)
    if isinstance(opt_shape, AdafactorState):
        def vr_spec(leaf, spec):
            t = tuple(spec) + (None,) * 8
            return P(*t[: len(leaf.shape)])

        vr = tree_map(vr_spec, opt_shape.vr, pspecs)

        def vc_spec(leaf, spec):
            t = tuple(spec) + (None,) * 8
            if len(leaf.shape) >= 2:
                return P(*(t[: len(leaf.shape) - 1] + (t[len(leaf.shape)],)))
            return P()

        vc = tree_map(vc_spec, opt_shape.vc, pspecs)
        return AdafactorState(step=P(), vr=vr, vc=vc)
    raise TypeError(type(opt_shape))


# ------------------------------------------------------------- batch/cache
def batch_pspecs(batch_shape: Any, dp: tuple[str, ...]) -> Any:
    return tree_map(lambda leaf: P(dp, *([None] * (len(leaf.shape) - 1))), batch_shape)


def cache_pspecs(cache_shape: Any, dp: tuple[str, ...]) -> Any:
    """Decode cache (keys as :func:`repro_torch.models.model.init_cache`
    gives them): (group, B, ...) leaves. Batch over DP; KV/assign sequence
    axes over 'model' (SP); SSM inner dims over 'model'.

    Context parallelism: when B == 1 (long_500k) the DP axes are idle on the
    batch dim, so the KV sequence axis shards over (dp..., 'model') — 256/512-
    way context parallel decode."""
    paths, leaves, rebuild = tree_flatten_with_paths(cache_shape)

    def rule(pstr, leaf):
        nd = len(leaf.shape)
        b1 = len(leaf.shape) > 1 and leaf.shape[1] == 1
        seq_ax = (*dp, MODEL) if b1 else (MODEL,)
        bat = None if b1 else dp
        if "'k'" in pstr or "'v'" in pstr or "cross_" in pstr:
            # (g, B, S, Kv, hd): sequence-parallel KV
            return P(None, bat, seq_ax, None, None)
        if "assign1" in pstr or "assign2" in pstr or "cells" in pstr:
            # (g, B, Kv, N_s, S)
            return P(None, bat, None, None, seq_ax)
        if "'h'" in pstr or "'conv'" in pstr:
            # mamba: (g, B, din, N) / (g, B, c, din) — din over model
            return P(None, bat, MODEL, None) if "'h'" in pstr else P(None, bat, None, MODEL)
        if "wkv" in pstr:
            # (g, B, H, hd, hd)
            return P(None, bat, MODEL, None, None)
        return P(*([None] * min(nd, 1)), bat, *([None] * max(nd - 2, 0)))

    return rebuild([rule(p, leaf) for p, leaf in zip(paths, leaves)])


# ------------------------------------------------------------- sanitizing
def sanitize_specs(shapes_tree: Any, specs_tree: Any, mesh) -> Any:
    """Even tiling for every split (jax requires it of input shardings): for
    any axis that does not divide its dim, RELOCATE the mesh axis to
    another (currently replicated) dim that divides — e.g. 40 experts over
    16 shards falls back to sharding the expert FFN width instead of
    replicating 3B of expert weights. If no dim fits, the axis is dropped
    (replicated)."""

    def fix(leaf, spec):
        dims = leaf.shape
        spec_t = list(tuple(spec) + (None,) * (len(dims) - len(spec)))
        for i, (size, ax) in enumerate(zip(dims, list(spec_t))):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            shards = int(math.prod(mesh.shape[a] for a in axes))
            if size % shards == 0:
                continue
            spec_t[i] = None
            # relocate to the rightmost free dim that divides evenly
            for j in range(len(dims) - 1, -1, -1):
                if spec_t[j] is None and j != i and dims[j] % shards == 0 and dims[j] >= shards:
                    spec_t[j] = ax
                    break
        return P(*spec_t)

    return tree_map(fix, shapes_tree, specs_tree)


def train_state_pspecs(state_shape, dp: tuple[str, ...], mesh):
    """The spec tree of a :class:`~repro_torch.train.loop.TrainState`."""
    pspecs = param_pspecs(state_shape.params)
    return dataclasses.replace(
        state_shape,
        params=pspecs,
        opt_state=opt_pspecs(state_shape.opt_state, pspecs, dp, mesh),
        step=P(),
    )


# ---------------------------------------------------------- per position
def position_bytes(tree: Any, specs: Any, mesh) -> int:
    """The bytes one position holds of ``tree`` (tensors or ``meta``
    tensors) split by ``specs`` over ``mesh``: each leaf's
    :func:`~repro_torch.mesh.local_shape` times its element size, summed."""
    leaves = tree_flatten(tree)[0]
    spec_leaves = tree_flatten(specs)[0]
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(leaves)} leaves against {len(spec_leaves)} specs")
    return sum(math.prod(local_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in zip(leaves, spec_leaves))
