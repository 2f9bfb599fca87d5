"""Readings that the limits in ``limits/<workload>.json`` are set from.

    python3 anns_bench/control.py --workload <name> --seeds 11,12,13 [--control tf32,reorder]

For each seed, in one process on the card: the corpus and queries of that
seed; the program's set-up and one pass of the cell's traffic (every slice of
the queries once) through the timed path; the numbers of
:mod:`anns_bench.check` against the float32 reference (all of them, those on
the program's own index too); and the same numbers of each side that
``--control`` names, put in the program's place:

  tf32      the control: the reference computed in TF32
  reorder   the reference in float32 with its sums taken over other row
            blocks (a third of :data:`taco_ref.BLOCK_BYTES`): how far a
            sound reordering of the sums moves each number

Prints one ``readings`` line a seed and side. Not run by the benchmark's own
runs.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SIDES = ("tf32", "reorder")


@contextlib.contextmanager
def _blocks(block_bytes: int):
    from anns_bench.reference import taco_ref

    old = taco_ref.BLOCK_BYTES
    taco_ref.BLOCK_BYTES = block_bytes
    try:
        yield
    finally:
        taco_ref.BLOCK_BYTES = old


def side_outputs(ctx, rows, side: str) -> dict:
    """What ``side`` (one of :data:`SIDES`) gives in the program's place."""
    from anns_bench import check
    from anns_bench.reference import taco_ref

    if side == "reorder":
        with _blocks(taco_ref.BLOCK_BYTES // 3):
            return check.control_outputs(ctx, rows, "f32")
    return check.control_outputs(ctx, rows, side)


def readings(ctx, driver, sides=()) -> dict:
    """{"program": numbers, side: numbers for each of ``sides``} for the
    context's seed."""
    from anns_bench import check
    from anns_bench import harness

    harness.make_data(ctx)
    driver.setup(ctx)
    for i in range(ctx.program["slices"]):
        driver.unit(ctx, i)
    ctx.window.update(units=ctx.program["slices"])
    produced = driver.outputs(ctx)
    driver.release(ctx)
    ref, res = check.reference(ctx, produced["rows"])
    out = {"program": check.compare(ctx, produced, ref, res, check.on_index(ctx, produced))}
    for side in sides:
        got = side_outputs(ctx, produced["rows"], side)
        out[side] = check.compare(ctx, got, ref, res, check.on_index(ctx, got))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", default="", help=f"comma-separated, of {SIDES}")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from anns_bench import harness, spec

    sides = [side for side in args.control.split(",") if side]
    if set(sides) - set(SIDES):
        ap.error(f"--control takes {SIDES}")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = harness.make_context(ROOT, args.workload, seed, 0.0, False, "cuda")
        driver = spec.load_module(spec.bench_file(ROOT, "drivers",
                                                  f"{ctx.traffic['driver']}.py"))
        for side, numbers in readings(ctx, driver, sides).items():
            print(f"readings {args.workload} seed {seed} {side} {json.dumps(numbers)}",
                  flush=True)
        print(f"readings {args.workload} seed {seed} took {time.perf_counter() - t0:.1f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
