#!/usr/bin/env python3
"""The expert-parallel train steps of one checkout, timed on the card.

    python3 scripts/ep_step_compare.py [--root DIR] [--label NAME] [--profile]

Runs ``chip_smoke.py``'s phase-18 train pieces from the checkout at
``--root`` (default this one): granite-moe-3b-a800m's sharded train step
beside make_train_step (``ep_train``: 16 layers over (data 2, model 4)),
then arctic-480b at 1 layer with one Adafactor step (``ep_arctic``), and
prints one line ``COMPARE {json}`` with each step's ms and peak GiB. To
compare two commits, unpack the other one into a directory that
.gitignore lists (``git archive``) and run both in one call, in the order
A, B, B, A. With ``--profile`` a third sharded granite-moe step runs under
``torch.profiler`` and its tables (by self CPU time and by self CUDA time)
are written to ``chiprun_out/profile_<label>.txt``. Needs a CUDA card and
nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

OUT = Path(__file__).resolve().parents[1] / "chiprun_out"


def profiled(make, label: str):
    """make_sharded_train_step whose third call of a step runs under the
    profiler."""
    import torch

    def build(*args, **kwargs):
        step, calls = make(*args, **kwargs), [0]

        def run(state, batch):
            calls[0] += 1
            if calls[0] != 3:
                return step(state, batch)
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                out = step(state, batch)
                torch.cuda.synchronize()
            OUT.mkdir(exist_ok=True)
            ka = prof.key_averages()
            (OUT / f"profile_{label}.txt").write_text(
                ka.table(sort_by="self_cpu_time_total", row_limit=30)
                + ka.table(sort_by="self_cuda_time_total", row_limit=20))
            return out
        return run
    return build


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="this")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    os.chdir(root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch

    import chip_smoke
    import repro_torch.train as train
    from repro_torch.kernels import cuda

    cuda.build_all()
    if args.profile:
        train.make_sharded_train_step = profiled(train.make_sharded_train_step, args.label)
        chip_smoke.EP_TRAIN_STEPS = 3
    out: dict = {"label": args.label}
    torch.cuda.reset_peak_memory_stats()
    row = chip_smoke.ep_train(torch)
    out["train"] = {k: row[k] for k in ("step_ms_sharded", "step_ms_single", "peak_gib",
                                        "peak_gib_single")}
    out["train"]["sharded_ms"] = [r["ms"] for r in row["sharded"]]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    arctic = chip_smoke.ep_arctic(torch)
    out["arctic_s"] = time.perf_counter() - t0
    out["arctic_train_ms"] = [r["ms"] for r in arctic["train"]]
    out["arctic_train_peak_gib"] = arctic["train_peak_gib"]
    print("COMPARE " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
