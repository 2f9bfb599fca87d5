"""A kernel's share of its roofline in the traced window: the bound of the
work the window's traffic needed (``roofline/<kernel>.py``'s ``work``) over
the device time of the kernel's functions (``KERNELS``) in the trace.

The work is counted from the cell's shapes and the data-dependent counts the
inputs need (the candidates a query), never from what one implementation
happens to read again: each input byte read once, each output byte written
once, in the smallest encoding that holds its values (a collision table as
bits, cell ids and scores as the narrowest integers)."""
from __future__ import annotations

import math

from anns_bench import peaks, spec
from anns_bench import trace as trace_mod


def shapes(ctx) -> dict:
    """The sizes the counts read, from the configuration and the traffic."""
    t, ds = ctx.taco, ctx.config["dataset"]
    sqrt_k = math.isqrt(int(t["n_clusters"]))
    n_sub, s = int(t["n_subspaces"]), int(t["subspace_dim"])
    q = int(ctx.traffic["batch"])
    return {"n": int(ds["n"]), "d": int(ds["d"]), "n_sub": n_sub, "s": s,
            "sqrt_k": sqrt_k, "k2": sqrt_k * sqrt_k, "q": q, "words": -(-q // 32),
            "k": int(ctx.traffic["k"]), "units": ctx.window["units"]}


def collision_inputs(sh: dict) -> float:
    """Bytes of one batch's collision inputs: every point's cell id in each
    subspace and the (query, subspace, cell) table as bits."""
    return (sh["n_sub"] * sh["n"] * peaks.int_bytes(sh["k2"] - 1)
            + sh["q"] * sh["n_sub"] * sh["k2"] / 8)


def share(ctx, kernel: str) -> float | None:
    """100 x bound / device time of ``kernel`` in the traced window, or None
    where the trace holds none of its functions."""
    if ctx.profile is None:
        return None
    mod = spec.load_module(spec.bench_file(ctx.root, "roofline", f"{kernel}.py"))
    secs = trace_mod.kernel_seconds(ctx.profile, mod.KERNELS)
    if not secs:
        return None
    work = mod.work(ctx, shapes(ctx))
    return None if work is None else 100.0 * peaks.bound_seconds(work) / secs
