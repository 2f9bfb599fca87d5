"""Gradient compression for the cross-shard gradient sum (mirrors
``repro.optim.compression``).

int8 per-tensor symmetric quantization with one scale shared by every
shard: the largest |g| over the shards, / 127. The reference sums the
quantized payloads as int32 inside ``shard_map`` (a ``psum`` over the data
axes). The port takes the S per-shard gradient trees in shard order and
sums the int32 payloads in that order on the first shard's device (the
idiom of :mod:`repro_torch.core.distributed`); integer sums are exact, so
the order is immaterial and the result is the reference's bit for bit.
Used by :func:`repro_torch.train.loop.make_shardmap_train_step`. Error
feedback is omitted, as in the reference (stateless): each shard's
rounding error is at most half a quantum, so the sum over S shards, once
divided by S, is within scale / 2 of the uncompressed mean.

The reference's docstring says the sum moves 1/4 of the bf16 bytes; its
payload is int32, 4 bytes an element, as many as float32.
:func:`payload_bytes` counts what a cross-device sum of a tree would move.
"""
from __future__ import annotations

import torch

from repro_torch.mesh import one_pass, tally
from repro_torch.utils import tree_flatten


def quantize_int8(x: torch.Tensor):
    """-> (q int8, scale float32 0-d)."""
    amax = torch.max(torch.abs(x.to(torch.float32)))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def shared_scale(gs) -> torch.Tensor:
    """The quantum shared by the shards' copies ``gs`` of one leaf: the
    largest |g| over them (the reference's ``pmax``), floored at 1e-12,
    / 127, float32 on the first shard's device."""
    home = gs[0].device
    gmax = torch.stack([torch.max(torch.abs(g.to(torch.float32))).to(home) for g in gs]).max()
    return torch.clamp_min(gmax, 1e-12) / 127.0


def _sum_leaf(gs, enabled: bool) -> torch.Tensor:
    home = gs[0].device
    if not enabled:
        total = gs[0]
        for g in gs[1:]:
            total = total + g.to(home)
        return total
    scale = shared_scale(gs)
    total = None
    for g in gs:
        s = scale.to(g.device)
        q = torch.clamp(torch.round(g.to(torch.float32) / s), -127, 127).to(torch.int32)
        total = q.to(home) if total is None else total + q.to(home)
    return (total.to(torch.float32) * scale).to(gs[0].dtype)


def compressed_psum(trees, *, enabled: bool = True):
    """The sum of S gradient trees (given in shard order; each a tree of
    tensors of one structure, or a single tensor), int8-compressing each
    leaf: the quantized payloads are summed as int32 (exact) and rescaled by
    the shared scale (:func:`shared_scale`), then cast back to the leaf's
    dtype. ``enabled=False`` is the plain sum in shard order. The result is
    on the first shard's device.

    Under an op counter (:mod:`repro_torch.launch.op_analysis`) each leaf's
    sum is one all-reduce of :func:`payload_bytes` (the first shard's
    copy), counted as one pass: the shard's copy read, the sum written."""
    flat = [tree_flatten(t)[0] for t in trees]
    rebuild = tree_flatten(trees[0])[1]
    out = []
    for gs in zip(*flat):
        tally("all-reduce", payload_bytes(gs[0], enabled=enabled))
        with one_pass() as moves:
            out.append(_sum_leaf(gs, enabled))
            moves(gs[0], out[-1])
    return rebuild(out)


def payload_bytes(tree, *, enabled: bool = True) -> int:
    """Bytes one shard hands to a cross-device sum of ``tree``: int32 per
    element and a float32 max per leaf (for the shared scale) when
    compressed, the leaf's own dtype when not."""
    leaves = tree_flatten(tree)[0]
    if enabled:
        return sum(4 * leaf.numel() + 4 for leaf in leaves)
    return sum(leaf.element_size() * leaf.numel() for leaf in leaves)
