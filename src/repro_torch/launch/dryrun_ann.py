"""Dry run of the paper's own technique at production scale (mirrors
``repro.launch.dryrun_ann``): the corpus-sharded TaCo query and the
distributed build's covariance and Lloyd steps for a billion-point corpus,
on ``meta`` tensors over the single-pod (16x16) or multi-pod (2x16x16)
mesh, counted per position by :mod:`repro_torch.launch.op_analysis`.

    python -m repro_torch.launch.dryrun_ann [--multi-pod] [--n 1e9] [--d 128]
        [--queries 32] [--rerank gather|masked_full|auto] [--out artifacts/torch_dryrun]

Nothing is allocated and nothing runs on a card: a meta tensor has a shape
and no storage. The port's layout is the reference's ``P(da)``: the corpus
in one row block a position over all the mesh's axes (flattened), the
query batch and the rest of the index (transform, centroids, cell sizes)
replicated. A kernel's work is counted as its plain version's (the counter
cannot see into a hand kernel; on meta the wrappers run the plain path).
The shards do equal work on meta tensors, so each shard walk traces one
and gives the others its counts (``represented_positions``).
``compile_s`` is the seconds of the meta run; ``memory_analysis`` holds the
bytes one position takes as arguments, and ``fits_one_card`` compares them
with the H100's 80 GB.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.core import taco_config
from repro_torch.core.distributed import (
    make_distributed_cov,
    make_distributed_lloyd,
    make_distributed_query,
    shard_rows,
    shard_views,
)
from repro_torch.core.imi import IMISubspace, split_halves
from repro_torch.core.taco import SCIndex
from repro_torch.core.transform import SubspaceTransform
from repro_torch.launch.mesh import dp_axes, make_production_mesh
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.mesh import make_mesh, tensor_bytes

#: the H100's device memory, as its name gives it (80 GB)
CARD_BYTES = 80 * 10**9
LAYOUT = ("corpus in one row block a position over every mesh axis (the reference's "
          "P(da)); queries, transform, centroids and cell sizes replicated; kernels "
          "counted as their plain versions")


def ann_config(rerank: str = "gather"):
    """The reference's billion-scale query config (dryrun_ann.py:93-95)."""
    return taco_config(n_subspaces=6, subspace_dim=8, n_clusters=256 * 256, alpha=0.01,
                       beta=0.0005, k=50, candidate_cap=4096, rerank=rerank)


def make_index(n: int, d: int, cfg, device="meta", generator=None) -> SCIndex:
    """An :class:`SCIndex` of an n-point corpus with the config's shapes:
    empty on ``meta`` (the reference's ``abstract_index``), otherwise drawn
    from ``generator`` (normal data and centroids, uniform assignments, the
    cell sizes they give) for a count of the same shapes on a card."""
    s, sk = cfg.subspace_dim, cfg.sqrt_k
    s1, s2 = split_halves(s)
    m = cfg.n_subspaces * s
    meta = torch.device(device).type == "meta"

    def normal(*shape):
        if meta:
            return torch.empty(shape, dtype=torch.float32, device=device)
        return torch.randn(shape, generator=generator, device=device)

    def assign():
        if meta:
            return torch.empty((n,), dtype=torch.int32, device=device)
        return torch.randint(0, sk, (n,), generator=generator, device=device,
                             dtype=torch.int32)

    subs = []
    for _ in range(cfg.n_subspaces):
        a1, a2 = assign(), assign()
        sizes = (torch.empty((sk, sk), dtype=torch.int32, device=device) if meta else
                 torch.bincount(a1.long() * sk + a2.long(), minlength=sk * sk)
                 .to(torch.int32).reshape(sk, sk))
        subs.append(IMISubspace(centroids1=normal(sk, s1), centroids2=normal(sk, s2),
                                assign1=a1, assign2=a2, cell_sizes=sizes))
    data = normal(n, d)
    tr = SubspaceTransform(mean=normal(d), basis=normal(d, m), eigvals=normal(m),
                           n_subspaces=cfg.n_subspaces, subspace_dim=s)
    return SCIndex(transform=tr, dim_perm=None, subspaces=tuple(subs), data=data,
                   sub_dims=(s,) * cfg.n_subspaces, data_norms=torch.sum(data * data, dim=1))


def shard_mesh(mesh):
    """The mesh's positions as one flat axis ``shard`` (the corpus's row
    blocks, over every axis in order, as ``P(da)`` lays them)."""
    return make_mesh((mesh.size,), ("shard",), devices=mesh.grid(mesh.axis_names)
                     .reshape(-1).tolist())


def ann_jobs(shards, index: SCIndex, cfg, queries, x_cov, x_lloyd, centroids) -> dict:
    """name -> (fn, argument bytes of one position): the three jobs over the
    1-D mesh ``shards``, their inputs cut into its row blocks first (no
    counter runs while they are cut)."""
    n_dev, n = shards.size, index.n
    views, _ = shard_views(index, n_dev, devices=list(shards))
    query = make_distributed_query(views, cfg, index, n)
    cov_rows = shard_rows(x_cov, shards)
    lloyd_rows = shard_rows(x_lloyd, shards)
    cov = make_distributed_cov(shards, n)
    lloyd = make_distributed_lloyd(shards)
    v = views[0]
    replicated = [index.transform.mean, index.transform.basis, index.transform.eigvals]
    for sub in index.subspaces:
        replicated += [sub.centroids1, sub.centroids2, sub.cell_sizes]
    return {
        "query": (lambda: query(queries),
                  tensor_bytes(v.data, v.data_norms, v.cells, queries, *replicated)),
        "build_cov": (lambda: cov(cov_rows), tensor_bytes(cov_rows[0])),
        "build_lloyd": (lambda: lloyd(lloyd_rows, centroids),
                        tensor_bytes(lloyd_rows[0], centroids)),
    }


def count_job(shards, fn, represent: bool = True) -> tuple[dict, float]:
    """(per-position analysis, seconds) of ``fn()`` under a counter that,
    on meta tensors, traces one representative shard of the equal ones
    (:func:`repro_torch.mesh.walk`)."""
    t0 = time.perf_counter()
    with OpCounter(shards, represent=represent) as counter:
        fn()
    return counter.analysis(), time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--n", type=float, default=1e9)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--rerank", choices=["gather", "masked_full", "auto"], default="gather",
                    help="re-rank pipeline; 'auto' resolves to gather for the "
                         "corpus-sharded query")
    ap.add_argument("--out", default="artifacts/torch_dryrun")
    args = ap.parse_args(argv)

    n_dev = 512 if args.multi_pod else 256
    mesh = make_production_mesh(multi_pod=args.multi_pod, devices=["meta"] * n_dev)
    shards = shard_mesh(mesh)
    n = int(args.n) // n_dev * n_dev  # even corpus shards
    cfg = ann_config(args.rerank)
    results = {"kind": "ann", "mesh": "2x16x16" if args.multi_pod else "16x16", "n": n,
               "d": args.d, "n_devices": n_dev, "rerank": args.rerank,
               "data_axes": [*dp_axes(args.multi_pod), "model"], "layout": LAYOUT,
               "counter": "repro_torch.launch.op_analysis (meta tensors)"}
    index = make_index(n, args.d, cfg)
    meta = dict(dtype=torch.float32, device="meta")
    jobs = ann_jobs(shards, index, cfg, torch.empty((args.queries, args.d), **meta),
                    torch.empty((n, args.d), **meta), torch.empty((n, 4), **meta),
                    torch.empty((cfg.sqrt_k, 4), **meta))
    for name, (fn, arg_bytes) in jobs.items():
        h, secs = count_job(shards, fn)
        mem = {"argument_size_in_bytes": arg_bytes}
        results[name] = {
            "compile_s": round(secs, 2), "flops": h["flops"], "bytes": h["bytes"],
            "collective_total": h["collective_total"],
            "collective_bytes": h["collective_bytes"],
            "collective_counts": h["collective_counts"], "memory_analysis": mem,
            "fits_one_card": arg_bytes <= CARD_BYTES,
            "represented_positions": h["represented_positions"],
        }
        print(f"[ann/{name}] ok meta={results[name]['compile_s']}s flops={h['flops']:.3e} "
              f"bytes={h['bytes']:.3e} coll={h['collective_total']:.3e} mem={mem} "
              f"fits_one_card={results[name]['fits_one_card']}", flush=True)

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        tag = f"ann_taco__n{n}__{results['mesh'].replace('x', '_')}"
        if args.rerank != "gather":
            tag += f"__{args.rerank}"
        with open(os.path.join(args.out, f"{tag}.json"), "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
