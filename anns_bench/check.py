"""Whether what the timed path produced is right: the program's answers held
to the plain reference (:mod:`anns_bench.reference.taco_ref`), which rebuilds
the index from the same corpus and answers the same queries in float32.

The numbers (a cell compares those its ``limits/<workload>.json`` gives a
limit, each against it):

  assign_miss   share of (subspace half, point) IMI assignments of the
                program's index that differ from the reference's build
  id_miss       share of the reference's exact top-k (over its candidate
                set) missing from the program's answer, over the checked rows
  dist_err      largest gap between a returned distance and the float64
                distance of the returned id, over |q|^2 + |x|^2 (the scale
                float32's rounding of the product form works at)
  count_err     mean gap between the program's candidate count and the
                reference's over the reference's, over the checked rows
  id_miss_on_index
                id_miss against the reference's query run on the program's
                own index (its transform, centroids and assignments): the
                query stage alone, without the build's rounding, which moves
                a few assignments and with them many candidate sets (the
                build is held by assign_miss)
  repeat_diff   answers in the window that differ from the first of the same
                batch (the program is deterministic: limit 0)

The control (:func:`control_outputs`) puts the reference itself, computed in
TF32, in the program's place.
"""
from __future__ import annotations

import numpy as np
import torch

from anns_bench import spec
from anns_bench.reference import taco_ref

def limits(ctx) -> dict:
    return spec.read_json(spec.bench_file(ctx.root, "limits", f"{ctx.cell['name']}.json"))


def sample_rows(n_rows: int, want: int, seed: int) -> np.ndarray:
    """``want`` of ``n_rows`` query rows drawn from the seed, ascending."""
    g = torch.Generator().manual_seed(int(seed))
    return np.sort(torch.randperm(n_rows, generator=g)[:min(want, n_rows)].numpy())


def _assign_miss(prog: torch.Tensor, ref: torch.Tensor) -> float:
    return float((prog.to(ref.device).long() != ref).to(torch.float64).mean())


def _row_numbers(ctx, produced: dict, res: dict, q: torch.Tensor) -> dict:
    dev = ctx.corpus.device
    ids = torch.as_tensor(produced["ids"], device=dev).long()
    dists = torch.as_tensor(produced["dists"], device=dev).to(torch.float64)
    exact = res["exact_ids"]
    found = (exact[:, :, None] == ids[:, None, :]).any(dim=2) & (exact >= 0)
    id_miss = 1.0 - float(found.sum()) / max(int((exact >= 0).sum()), 1)
    valid = ids >= 0
    x = ctx.corpus[ids.clamp_min(0)].to(torch.float64)
    q64 = q.to(torch.float64)[:, None, :]
    true = torch.sum((x - q64) ** 2, dim=-1)
    scale = torch.sum(x * x, dim=-1) + torch.sum(q64 * q64, dim=-1)
    gap = torch.where(valid, (dists - true).abs() / scale.clamp_min(1e-30), 0.0)
    count = torch.as_tensor(produced["count"], device=dev).to(torch.float64)
    ref_count = res["count"].to(torch.float64)
    count_err = (count - ref_count).abs() / ref_count.clamp_min(1.0)
    return {"id_miss": id_miss, "dist_err": float(gap.max()), "count_err": float(count_err.mean())}


def _recall(ids, true_ids) -> float:
    ids = torch.as_tensor(ids, device=true_ids.device).long()
    hit = (true_ids[:, :, None] == ids[:, None, :]).any(dim=2) & (true_ids >= 0)
    return float(hit.sum()) / max(int((true_ids >= 0).sum()), 1)


def reference(ctx, rows, prec: str = "f32", exact: bool = True):
    """The reference's build over the corpus and its answers for the query
    ``rows``: (index, answers)."""
    ref = taco_ref.build(ctx.corpus, ctx.taco, prec)
    tr = ctx.traffic
    q = ctx.queries[torch.as_tensor(rows, device=ctx.device)]
    return ref, taco_ref.query(ref, q, ctx.taco, k=int(tr["k"]), rerank=tr["rerank"],
                               prec=prec, exact=exact)


def state_index(ctx, state: dict) -> taco_ref.RefIndex:
    """An index the reference's query reads, made of a built index's state
    (``mean``, ``basis``, each (subspace, half)'s ``centroids`` in that
    order, ``assign`` (2 N_s, n)) over the benchmark's own corpus."""
    dev, cents = ctx.corpus.device, state["centroids"]
    dims = tuple(int(c.shape[1]) for c in cents)
    padded = torch.zeros((len(cents), cents[0].shape[0], max(dims)), dtype=torch.float32,
                         device=dev)
    for p, c in enumerate(cents):
        padded[p, :, :dims[p]] = c.to(dev, torch.float32)
    return taco_ref.RefIndex(mean=state["mean"].to(dev, torch.float32),
                             basis=state["basis"].to(dev, torch.float32),
                             eigvals=torch.empty(0), centroids=padded,
                             assign=state["assign"].to(dev).long(), dims=dims, data=ctx.corpus)


def on_index(ctx, produced: dict) -> dict:
    """The float32 reference's answers for the checked rows, run on the
    index that produced them (``produced["state"]``)."""
    tr = ctx.traffic
    q = ctx.queries[torch.as_tensor(produced["rows"], device=ctx.device)]
    return taco_ref.query(state_index(ctx, produced["state"]), q, ctx.taco, k=int(tr["k"]),
                          rerank=tr["rerank"])


def compare(ctx, produced: dict, ref, res, own=None) -> dict:
    """The numbers of ``produced`` against the float32 reference's build
    ``ref`` and answers ``res`` and, where given, its answers ``own`` on the
    program's own index (:func:`on_index`)."""
    numbers = {"assign_miss": _assign_miss(produced["state"]["assign"], ref.assign)}
    q = ctx.queries[torch.as_tensor(produced["rows"], device=ctx.device)]
    numbers.update(_row_numbers(ctx, produced, res, q))
    if own is not None:
        numbers["id_miss_on_index"] = _row_numbers(ctx, produced, own, q)["id_miss"]
    numbers["repeat_diff"] = float(produced["repeat_diff"])
    return numbers


def run(ctx, produced: dict) -> tuple[dict, list]:
    """The numbers and the lines that show them beside their limits. Also
    leaves in ``ctx.checked`` what readers use: the rows some checked query
    re-ranked."""
    ref, res = reference(ctx, produced["rows"])
    lim = limits(ctx)
    own = on_index(ctx, produced) if "id_miss_on_index" in lim else None
    numbers = {name: v for name, v in compare(ctx, produced, ref, res, own).items()
               if name in lim}
    ctx.checked["touched"] = int(res["touched"].sum())
    ctx.lines.append(
        f"recall@{ctx.traffic['k']} over {res['ids'].shape[0]} checked queries: program "
        f"{_recall(produced['ids'], res['true_ids'])!r}, reference "
        f"{_recall(res['ids'], res['true_ids'])!r}")
    lines = [f"check {name} {value!r} limit {lim[name]!r}" for name, value in numbers.items()]
    return numbers, lines


def judge(numbers: dict, lim: dict) -> bool:
    """Every limit met: each of its numbers at or under it (a number the
    run could not read fails)."""
    return all(name in numbers and numbers[name] <= bound for name, bound in lim.items())


def control_outputs(ctx, rows, prec: str = "tf32") -> dict:
    """What the reference computed in ``prec`` gives in the program's place,
    for the query ``rows``."""
    ref, res = reference(ctx, rows, prec, exact=False)
    state = {"mean": ref.mean, "basis": ref.basis, "assign": ref.assign,
             "centroids": [ref.centroids[p, :, :w] for p, w in enumerate(ref.dims)]}
    return {"rows": rows, "repeat_diff": 0, "state": state,
            "ids": res["ids"].cpu().numpy(), "dists": res["dists"].cpu().numpy(),
            "count": res["count"].cpu().numpy()}
