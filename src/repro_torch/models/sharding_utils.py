"""Sharding constraints and the collectives of tensor parallelism and ZeRO-1
(mirrors ``repro.models.sharding_utils``).

The reference's ``constrain`` asks GSPMD for a layout; the port places its
blocks itself (:mod:`repro_torch.models.sharded`), so :func:`constrain` is
the identity. The collectives follow :mod:`repro_torch.mesh`: the
positions' parts, given in position order, are combined in that order on
the first part's device. Each reports its kind and the payload one position
sends or receives to :func:`~repro_torch.mesh.tally` and counts as one pass
(:func:`~repro_torch.mesh.one_pass`: the first part read, the result
written), as :func:`repro_torch.optim.compression.compressed_psum` does.
Called outside a position, a collective counts at every position the
enclosing one covers.

Under gradients the backward pass has collectives of its own (Megatron's
f and g): :func:`model_copy` marks a replicated tensor entering the
positions, whose gradient is an all-reduce of the positions' parts, and a
:func:`model_gather`'s gradient is a reduce-scatter; ``model_sum``'s is a
broadcast (no payload). On one card autograd adds and splits those
gradients itself; the marks only report the payloads.
"""
from __future__ import annotations

import torch

from repro_torch.mesh import deferred_tally, one_pass, tally, tensor_bytes


def constrain(x, spec=None):
    """The reference's sharding constraint: here the identity."""
    return x


class _BackwardCollective(torch.autograd.Function):
    """Identity whose backward reports one collective of ``kind`` carrying
    ``nbytes`` (:func:`repro_torch.mesh.deferred_tally`)."""

    @staticmethod
    def forward(ctx, x, report, kind, nbytes):
        ctx.report, ctx.kind, ctx.nbytes = report, kind, nbytes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.report(ctx.kind, ctx.nbytes)
        return grad, None, None, None


def _on_backward(x, kind: str, nbytes: int):
    report = deferred_tally()
    if report is None or not x.requires_grad:
        return x
    return _BackwardCollective.apply(x, report, kind, nbytes)


def model_copy(x) -> torch.Tensor:
    """A replicated tensor handed to the 'model' positions (Megatron's f):
    the identity; its gradient, the positions' parts summed, is an
    all-reduce."""
    return _on_backward(x, "all-reduce", tensor_bytes(x))


def replicated_slice(x, dim: int, m: int, n: int) -> torch.Tensor:
    """Position m's n-th of a replicated tensor along ``dim`` (a view), for
    work each position does on its own part of a replicated parameter;
    each position makes the gradient of its slice only, so the backward
    all-gathers the whole gradient (the payload: all of x)."""
    size = x.shape[dim] // n
    return _on_backward(x.narrow(dim, m * size, size), "all-gather", tensor_bytes(x))


def model_sum(parts, dtype: torch.dtype | None = None) -> torch.Tensor:
    """All-reduce over 'model': the parts added in float32 in position order
    and cast once to ``dtype`` (default the first part's), so that a
    row-parallel product's partial sums round once, as one product does."""
    home = parts[0].device
    tally("all-reduce", tensor_bytes(parts[0]))
    with one_pass() as moves:
        total = parts[0].to(torch.float32)
        for part in parts[1:]:
            total = total + part.to(device=home, dtype=torch.float32)
        out = total.to(dtype or parts[0].dtype)
        moves(parts[0], out)
    return out


def model_max(parts) -> torch.Tensor:
    """All-reduce (max) over 'model' of same-shaped parts."""
    home = parts[0].device
    tally("all-reduce", tensor_bytes(parts[0]))
    with one_pass() as moves:
        out = parts[0]
        for part in parts[1:]:
            out = torch.maximum(out, part.to(home))
        moves(parts[0], out)
    return out


def model_gather(parts, dim: int) -> torch.Tensor:
    """All-gather over 'model': the parts concatenated along ``dim`` in
    position order (its gradient a reduce-scatter)."""
    home = parts[0].device
    with one_pass() as moves:
        out = torch.cat([p.to(home) for p in parts], dim=dim)
        moves(parts[0], out)
    tally("all-gather", tensor_bytes(out))
    return _on_backward(out, "reduce-scatter", tensor_bytes(parts[0]))


def model_all_to_all(parts, dim: int) -> torch.Tensor:
    """All-to-all over 'model': the positions' blocks concatenated along
    ``dim`` in position order, for each position to cut the part it runs
    on (the payload: the block one position sends and receives); its
    gradient is the reverse all-to-all."""
    home = parts[0].device
    nbytes = tensor_bytes(parts[0])
    tally("all-to-all", nbytes)
    with one_pass() as moves:
        out = torch.cat([p.to(home) for p in parts], dim=dim)
        moves(parts[0], out)
    return _on_backward(out, "all-to-all", nbytes)


def reduce_scatter(total: torch.Tensor, dim: int | None, n: int) -> list:
    """Reduce-scatter over the data axes (ZeRO-1) of ``total``, the data
    positions' parts already summed (as the backward passes made them):
    ``n`` equal slices along ``dim`` (views of the sum), slice i for data
    position i. Where the moment has no split dimension (``dim`` None)
    every data position keeps the whole sum, an all-reduce."""
    with one_pass() as moves:
        out = [total] if dim is None else list(torch.chunk(total, n, dim=dim))
        moves(total, out[0])
    tally("all-reduce" if dim is None else "reduce-scatter", tensor_bytes(out[0]))
    return out


def lse_combine(parts) -> torch.Tensor:
    """One all-reduce of the positions' partial attention over their blocks
    of the keys: each part (max, sum, weighted values) — the scores' max
    (..., 1) in float32, the sum of exp(score - max) (..., 1) in float32
    and the exp-weighted sum of the values (..., hd) — merged in position
    order by log-sum-exp. Returns the attention output in float32."""
    home = parts[0][0].device
    tally("all-reduce", tensor_bytes(*parts[0]))
    with one_pass() as moves:
        mx, den, num = (t.to(home, torch.float32) for t in parts[0])
        for part in parts[1:]:
            m2, d2, n2 = (t.to(home, torch.float32) for t in part)
            new = torch.maximum(mx, m2)
            a, b = torch.exp(mx - new), torch.exp(m2 - new)
            den, num, mx = den * a + d2 * b, num * a + n2 * b, new
        out = num / den
        moves(*parts[0], out)
    return out
