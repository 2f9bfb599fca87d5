"""Mixture-of-Experts FFN (mirrors ``repro.models.moe``): top-k routing with
capacity-based dispatch (Switch/Mixtral style), on one device.

Dispatch is the scatter-to-buffer formulation: tokens are placed into an
(E, C, D) expert buffer at their position-in-expert (prefix sum of the
routing one-hot, slot-major so that first choices get priority); tokens
beyond capacity C are dropped. The expert FFNs run as batched products over
the expert axis (``torch.bmm``), then each token gathers its k outputs,
gates them and sums over k.

The reference's ``dispatch_chunks`` and sharding specs are 1/None here (one
chunk: the cumsum runs over all B·S tokens). Its ``moe_apply_manual`` (a
``shard_map`` over a mesh) has no counterpart.

The buffer fill is deterministic on the card and needs no host sync: each
kept token is stored at its (expert, position) row, and those rows are
unique; the dropped ones all go to one spare row that is cut off before the
products. A plain indexed store thus replaces the reference's scatter-add
(which adds zeros for the dropped ones). Returns the load-balancing
auxiliary loss (Switch eq. 4) beside the output.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import silu


def route(probs: torch.Tensor, k: int, cap: int):
    """Routing of T tokens from their (T, E) float32 router probabilities:
    (expert ids (T, k), gates (T, k), the dispatch order's expert ids fe
    (k·T,), positions in expert (k·T,), kept (k·T,) bool). Top-k takes the
    lowest expert id first on ties (as ``jax.lax.top_k``; a stable
    descending sort); gates are renormalised over the k; the dispatch order
    is slot-major (all first choices, then all second ones, ...)."""
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, exp_idx = order.values[:, :k], order.indices[:, :k]
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    fe = exp_idx.T.reshape(-1)  # (kT,) slot-major
    # position in expert: the entries before it with the same expert (the
    # reference's cumsum of the (kT, E) one-hot down the entries, run here
    # along the contiguous axis of its (E, kT) transpose)
    oh = fe == torch.arange(probs.shape[-1], device=fe.device)[:, None]  # (E, kT)
    pos = torch.cumsum(oh, dim=1, dtype=torch.int32).gather(0, fe[None])[0] - 1
    return exp_idx, gate_vals, fe, pos, pos < cap


def moe_apply(p, x: torch.Tensor, *, n_experts: int, experts_per_token: int,
              capacity_factor: float = 1.25):
    """Top-k routed MoE over x (B, S, D) -> ((B, S, D), aux float32)."""
    b, s, d = x.shape
    t = b * s
    k = experts_per_token
    cap = max(1, int(t * k * capacity_factor / n_experts))

    x2 = x.reshape(t, d)
    logits = (x2 @ p["router"].to(x.dtype)).to(torch.float32)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    exp_idx, gate_vals, fe, pos, keep = route(probs, k, cap)

    # buffer row of each dispatch entry (entry i is token i % T); the
    # dropped ones share the spare row E * cap
    row = torch.where(keep, fe * cap + pos, n_experts * cap)
    buf = x.new_zeros((n_experts * cap + 1, d))
    buf[row] = x2.repeat(k, 1)
    buf = buf[:-1].view(n_experts, cap, d)

    h = silu(torch.bmm(buf, p["gate"].to(x.dtype))) * torch.bmm(buf, p["up"].to(x.dtype))
    y = torch.bmm(h, p["down"].to(x.dtype))  # (E, cap, D)

    out_flat = y.reshape(n_experts * cap, d)[torch.where(keep, row, 0)]  # (kT, D)
    gates_flat = gate_vals.T.reshape(-1)
    out_flat = torch.where(keep[:, None], out_flat * gates_flat[:, None].to(x.dtype), 0)
    out = out_flat.reshape(k, t, d).sum(dim=0)

    # Switch load-balance aux loss: E * sum_e f_e * p_e
    first = exp_idx[:, 0, None] == torch.arange(n_experts, device=x.device)
    frac_tokens = torch.mean(first.to(torch.float32), dim=0)
    frac_probs = torch.mean(probs, dim=0)
    aux = n_experts * torch.sum(frac_tokens * frac_probs)
    return out.reshape(b, s, d), aux
