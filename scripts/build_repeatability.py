#!/usr/bin/env python3
"""Whether two builds of one corpus on the card agree, measured.

    python3 scripts/build_repeatability.py [--builds 5] [--n 1000000]

Where the Lloyd update sums each k-means cluster with float atomics
(``index_add_``, which adds in no fixed order), two builds of the same
corpus with the same seed differ in the last bits of a centroid, and a
point near a cell boundary lands in another cell. Compaction is such a
build, and ``chip_smoke.py`` holds a compacted index against a second
build of its live corpus. This script builds the 10^6 x 128 TaCo index of
``chip_smoke.py`` ``--builds`` times and answers its 1000 queries at k = 10
on each build (masked-full and gather, query-aware and fixed selection),
printing for every later build against the first: whether every array is
equal bit for bit, the share of result ids equal position by position, the
number of queries whose result differs, and both recalls@10 against brute
force. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--builds", type=int, default=5)
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.ann import AnnIndex
    from repro_torch.ann.persistence import leaves_of
    from repro_torch.core.config import taco_config
    from repro_torch.data import gmm_dataset, make_queries
    from repro_torch.utils import recall_at_k

    if not torch.cuda.is_available():
        print("build_repeatability: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"device: {chip_smoke.card_line()}", flush=True)
    corpus, queries = make_queries(gmm_dataset(args.n + 1000, 128, seed=0), 1000)
    gt = chip_smoke.brute_force_top10(torch, torch.as_tensor(corpus).cuda(),
                                      torch.as_tensor(queries).cuda())
    cfg = taco_config(n_subspaces=6, subspace_dim=8, n_clusters=1024, alpha=0.05,
                      beta=0.005, k=10, rerank="masked_full", use_kernels=True)
    settings = [(r, sel) for r in ("masked_full", "gather") for sel in ("query_aware", "fixed")]
    first = None
    for b in range(args.builds):
        index = AnnIndex.build(corpus, cfg)
        res = {s: index.replace_cfg(selection=s[1]).search(queries, k=10, rerank=s[0])[0]
               for s in settings}
        if first is None:
            first, first_index = res, index
            continue
        same = all(torch.equal(x, y) for x, y in zip(leaves_of(index.sc_index),
                                                      leaves_of(first_index.sc_index)))
        print(f"repeat: build {b} arrays equal the first build's: {same}", flush=True)
        for (rerank, sel), ids in res.items():
            want = first[(rerank, sel)]
            row = dict(build=b, rerank=rerank, selection=sel,
                       ids_same=float(np.mean(ids == want)),
                       queries_differ=int((ids != want).any(axis=1).sum()),
                       recall_at_10=recall_at_k(ids, gt, 10),
                       first_recall_at_10=recall_at_k(want, gt, 10))
            print(f"repeat: {json.dumps(row)}", flush=True)
        del index
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
