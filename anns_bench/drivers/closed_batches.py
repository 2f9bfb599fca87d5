"""Closed-loop query batches: one caller sends a batch of ``batch`` queries
to ``SingleDeviceSearcher.search_with_stats`` and the next when it returns.

Traffic keys: ``batch`` (queries a batch; the held-out queries are cut into
slices of this size, sent in turn), ``k``, ``rerank`` (``masked_full`` or
``gather``), ``check_queries`` (rows the check compares, drawn from the
seed). Each batch ends in the numpy ids and distances the API returns, so
it is synchronised. The index is built once in set-up; one batch of the
cell's shape warms it.
"""
from __future__ import annotations

import numpy as np
import torch

from anns_bench import check
from anns_bench.drivers import index_state


def setup(ctx) -> None:
    from repro_torch.ann import AnnIndex
    from repro_torch.core.config import SCConfig

    tr = ctx.traffic
    if ctx.on_card:
        from repro_torch.kernels import cuda

        cuda.build_all()
    batch = int(tr["batch"])
    if ctx.queries.shape[0] % batch:
        raise ValueError(f"{ctx.queries.shape[0]} queries do not cut into batches of {batch}")
    cfg = SCConfig(**ctx.taco, k=int(tr["k"]), rerank=tr["rerank"])
    index = AnnIndex.build(ctx.corpus, cfg, device=ctx.device)
    ctx.program.update(index=index, searcher=index.searcher("single"), batch=batch,
                       slices=ctx.queries.shape[0] // batch, first={}, repeat_diff=0,
                       cand_total=0)
    _search(ctx, 0)


def _search(ctx, s: int):
    b = ctx.program["batch"]
    return ctx.program["searcher"].search_with_stats(ctx.queries[s * b:(s + 1) * b])


def unit(ctx, i: int) -> int:
    """One batch (slice ``i`` mod the slices); returns its real queries."""
    p = ctx.program
    s = i % p["slices"]
    ids, dists, stats = _search(ctx, s)
    count = stats["candidate_count"]
    p["cand_total"] += int(count.sum())
    if s not in p["first"]:
        p["first"][s] = (ids, dists, count)
    else:
        f_ids, f_dists, f_count = p["first"][s]
        if not (np.array_equal(ids, f_ids) and np.array_equal(dists.view(np.int32),
                                                               f_dists.view(np.int32))
                and np.array_equal(count, f_count)):
            p["repeat_diff"] += 1
    return p["batch"]


def outputs(ctx) -> dict:
    """The window's answers of ``check_queries`` rows drawn from the seed
    among the slices the window sent, and the index's state."""
    p = ctx.program
    ctx.window["cand_total"] = p["cand_total"]
    b, done = p["batch"], sorted(p["first"])
    avail = np.concatenate([np.arange(s * b, (s + 1) * b) for s in done])
    pick = check.sample_rows(avail.size, int(ctx.traffic["check_queries"]), ctx.seed)
    ids = np.concatenate([p["first"][s][0] for s in done])[pick]
    dists = np.concatenate([p["first"][s][1] for s in done])[pick]
    count = np.concatenate([p["first"][s][2] for s in done])[pick]
    return {"rows": avail[pick], "ids": ids, "dists": dists, "count": count,
            "state": index_state(p["index"]), "repeat_diff": p["repeat_diff"]}


def release(ctx) -> None:
    ctx.program.clear()
    if ctx.on_card:
        torch.cuda.empty_cache()
