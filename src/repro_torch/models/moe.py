"""Mixture-of-Experts FFN (mirrors ``repro.models.moe``): top-k routing with
capacity-based dispatch (Switch/Mixtral style), on one device or expert
parallel over a mesh.

Dispatch is the scatter-to-buffer formulation: tokens are placed into an
(E, C, D) expert buffer at their position-in-expert (prefix sum of the
routing one-hot, slot-major so that first choices get priority); tokens
beyond capacity C are dropped. The expert FFNs run as batched products over
the expert axis (``torch.bmm``), then each token gathers its k outputs,
gates them and sums over k.

:func:`moe_apply` takes the reference's ``dispatch_chunks`` (shard-local
dispatch: a position scan and a capacity per token chunk); its sharding
specs have no counterpart (one device holds the buffer).
:func:`moe_apply_manual` is the reference's ``shard_map`` variant over a
(data, model) grid of a :class:`~repro_torch.mesh.DeviceMesh`: each grid
position dispatches its batch block's tokens to its block of experts, and
the partial outputs are summed over the expert axis.

The buffer fill is deterministic on the card and needs no host sync: each
kept token is stored at its (expert, position) row, and those rows are
unique; the dropped ones all go to one spare row that is cut off before the
products. A plain indexed store thus replaces the reference's scatter-add
(which adds zeros for the dropped ones). Returns the load-balancing
auxiliary loss (Switch eq. 4) beside the output.
"""
from __future__ import annotations

import torch

from repro_torch.mesh import DeviceMesh, counting_active, one_pass, tally, tensor_bytes, walk
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


def _router_probs(router: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """(T, E) float32 router probabilities of the tokens x2 (T, D)."""
    logits = (x2 @ router.to(x2.dtype)).to(torch.float32)
    return torch.softmax(logits, dim=-1)


def _experts(buf: torch.Tensor, gate, up, down) -> torch.Tensor:
    """The expert FFNs over a buffer (E, rows, D): (E, rows, D)."""
    h = silu(torch.bmm(buf, gate.to(buf.dtype))) * torch.bmm(buf, up.to(buf.dtype))
    return torch.bmm(h, down.to(buf.dtype))


def _aux(probs: torch.Tensor, first: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch load-balance aux loss E * sum_e f_e * p_e over the tokens of
    ``probs`` (T, E) with first choices ``first`` (T,)."""
    hot = first[:, None] == torch.arange(n_experts, device=first.device)
    frac_tokens = torch.mean(hot.to(torch.float32), dim=0)
    frac_probs = torch.mean(probs, dim=0)
    return n_experts * torch.sum(frac_tokens * frac_probs)


def _dispatch(x2: torch.Tensor, row: torch.Tensor, keep: torch.Tensor, gates: torch.Tensor,
              rows_per_expert: int, weights, sum_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The routed FFN of the tokens x2 (T, D) over the experts ``weights``
    (gate, up, down, each E' experts long): dispatch entry i (slot-major,
    token i % T) is stored at buffer row ``row[i]`` of the (E' ·
    rows_per_expert + 1, D) buffer, the last row the dropped entries' spare;
    the expert products; each kept entry's output gathered and gated; the
    sum over the k entries of a token, in ``sum_dtype`` (default x2's).
    (T, D)."""
    t, d = x2.shape
    rows = weights[0].shape[0] * rows_per_expert
    buf = x2.new_zeros((rows + 1, d))
    buf[row] = x2.repeat(row.shape[0] // t, 1)
    y = _experts(buf[:-1].view(-1, rows_per_expert, d), *weights)
    out = y.reshape(rows, d)[torch.where(keep, row, 0)]
    out = torch.where(keep[:, None], out * gates[:, None].to(x2.dtype), 0)
    return out.reshape(-1, t, d).sum(dim=0, dtype=sum_dtype)


def moe_apply(p, x: torch.Tensor, *, n_experts: int, experts_per_token: int,
              capacity_factor: float = 1.25, dispatch_chunks: int = 1):
    """Top-k routed MoE over x (B, S, D) -> ((B, S, D), aux float32).

    ``dispatch_chunks`` = tc > 1 is the reference's shard-local dispatch:
    the B·S tokens are viewed as (tc, T/tc), each chunk routed on its own
    (its position scan, its capacity ``max(1, int(T/tc · k · cf / E))``)
    into its own slice of an (E, tc, cap, D) buffer; which tokens are kept
    then depends on tc. A token count that tc does not divide falls back to
    one chunk."""
    b, s, d = x.shape
    t = b * s
    k = experts_per_token
    tc = max(1, dispatch_chunks)
    if t % tc != 0:  # tiny decode batches: fall back to one chunk
        tc = 1
    tl = t // tc
    cap = max(1, int(tl * k * capacity_factor / n_experts))

    x2 = x.reshape(t, d)
    # each chunk routed on its own (its router product too, so that a chunk
    # and moe_apply_manual's batch block of the same tokens route alike bit
    # for bit), then its entries' rows in the (E, tc, cap) buffer; the
    # dropped share the spare row E·tc·cap
    probs, first, rows, keeps, gates = [], [], [], [], []
    for c in range(tc):
        probs.append(_router_probs(p["router"], x2[c * tl:(c + 1) * tl]))
        exp_idx, gate_vals, fe, pos, keep = route(probs[-1], k, cap)
        first.append(exp_idx[:, 0])
        ids = fe if tc == 1 else fe * tc + c  # the (expert, chunk) slice of the buffer
        rows.append(torch.where(keep, ids * cap + pos, n_experts * tc * cap))
        keeps.append(keep)
        gates.append(gate_vals.T.reshape(-1))

    def slot_major(xs):  # the chunks' (k, tl) entries as (k, T)
        if tc == 1:
            return xs[0]
        return torch.stack(xs).view(tc, k, tl).transpose(0, 1).reshape(-1)

    out = _dispatch(x2, slot_major(rows), slot_major(keeps), slot_major(gates), tc * cap,
                    (p["gate"], p["up"], p["down"]))
    aux = _aux(*((xs[0] if tc == 1 else torch.cat(xs)) for xs in (probs, first)), n_experts)
    return out.reshape(b, s, d), aux


def moe_apply_manual(p, x: torch.Tensor, *, n_experts: int, experts_per_token: int,
                     capacity_factor: float = 1.25, mesh: DeviceMesh, dp_axes=("data",),
                     ep_axis: str = "model"):
    """Expert-parallel MoE over a (dp, ep) grid of ``mesh`` (the
    reference's ``shard_map`` variant): x (B, S, D) -> ((B, S, D), aux).

    Grid position (i, j) takes batch block i (B/dp rows) and expert block j
    (E/ep experts) of ``gate``, ``up`` and ``down``; the router is
    replicated. Each position dispatches its block's tokens to its LOCAL
    experts only, with the capacity of the GLOBAL expert count at the local
    token count, ``max(1, int(T_loc · k · cf / E))``, and the partial
    outputs of a batch block are summed over j in order (the reference's
    ``psum`` over ``ep_axis``) on position (i, 0)'s device. The routing of a
    block is the same at every j (the reference computes it at each), so it
    is computed once a block, on position (i, 0)'s device. On one card the
    expert blocks are views of the weights, not copies. aux is the mean
    over the dp blocks of each block's Switch product (the reference's
    ``pmean`` of its per-shard estimator). Raises unless E % ep == 0 and
    B % dp == 0.

    ``dp_axes`` names one mesh axis or a group of them, flattened in the
    order given as one batch axis (the reference's ``act_spec[0]``, e.g.
    ``("pod", "data")``: 32 blocks on the multi-pod mesh). Block i runs at
    its data coordinates and (i, j) at its grid position
    (:func:`repro_torch.mesh.walk`); under an op counter the sum over j is
    counted as one all-reduce of a part. Without one, the coordinates are
    never built and each part is added as it is made."""
    grid = mesh.grid(dp_axes, ep_axis)
    dp, ep = grid.shape
    if n_experts % ep or x.shape[0] % dp:
        raise ValueError(f"moe_apply_manual: {n_experts} experts over {ep} expert shards and "
                         f"a batch of {x.shape[0]} over {dp} data shards must divide evenly")
    b, s, d = x.shape
    k = experts_per_token
    b_loc, e_loc = b // dp, n_experts // ep
    t_loc = b_loc * s
    cap = max(1, int(t_loc * k * capacity_factor / n_experts))
    groups = (dp_axes, ep_axis)

    def experts(j):
        return [p[n][j * e_loc:(j + 1) * e_loc] for n in ("gate", "up", "down")]

    def block(i):
        home = grid[i, 0]
        x2 = x[i * b_loc:(i + 1) * b_loc].reshape(t_loc, d).to(home)
        probs = _router_probs(p["router"].to(home), x2)
        exp_idx, gate_vals, fe, pos, keep = route(probs, k, cap)
        gates_flat = gate_vals.T.reshape(-1)

        def part(j):
            dev = grid[i, j]
            le, kept = fe.to(dev) - j * e_loc, keep.to(dev)
            kept = kept & (le >= 0) & (le < e_loc)
            row = torch.where(kept, le * cap + pos.to(dev), e_loc * cap)
            return _dispatch(x2.to(dev), row, kept, gates_flat.to(dev), cap,
                             [w.to(dev) for w in experts(j)]).to(home)

        if not counting_active():
            # the sum over j as the parts are made, one alive at a time
            total = part(0)
            for j in range(1, ep):
                total = total + part(j)
        else:
            parts = walk(ep, lambda j: mesh.coords(groups, (i, j)), part,
                         lambda j: [x2, *experts(j)])
            # the reference's psum over ep_axis: one all-reduce of a part
            tally("all-reduce", tensor_bytes(parts[0]))
            with one_pass() as moves:
                total = parts[0]
                for pt in parts[1:]:
                    total = total + pt
                moves(parts[0], total)
        return total.to(x.device), _aux(probs, exp_idx[:, 0], n_experts).to(x.device)

    blocks = walk(dp, lambda i: mesh.coords([dp_axes], [i]), block,
                  lambda i: [x[i * b_loc:(i + 1) * b_loc], p["router"]])
    outs = [o for o, _a in blocks]
    auxes = [a for _o, a in blocks]
    aux = auxes[0]
    for a in auxes[1:]:
        aux = aux + a
    return torch.cat(outs).reshape(b, s, d), aux / dp
