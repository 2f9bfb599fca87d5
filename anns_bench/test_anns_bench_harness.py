"""The harness is driven by data, and its check fails what it must fail.

On the CPU, in a temporary copy of the benchmark: a configuration, traffic
mixes and a per-layer metric added as new files (and entries of
``BENCHMARK.json``) are found and run, at a tiny size, with no existing file
edited. Then the rest of a run with the timed path broken underneath (an
answer altered where it is produced, half of each batch left out, a Lloyd
step that returns its state unchanged) comes out not correct, and so does
the control: the reference in (emulated) TF32 put in the program's place.
And ``BENCHMARK.json`` itself keeps to the contract's names and limits."""
from __future__ import annotations

import hashlib
import importlib
import json
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from anns_bench import check, control, harness, spec

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "anns_bench"
TINY = {"n_subspaces": 4, "subspace_dim": 8, "n_clusters": 64, "kmeans_iters": 4,
        "alpha": 0.05, "beta": 0.02, "transform": "entropy", "activation": "sort",
        "selection": "query_aware", "kmeans_init": "random", "seed": 0,
        "use_kernels": True, "precision": "f32"}
#: set from CPU readings of the program (0 on every number but dist_err,
#: ~1e-7) and of the emulated-TF32 control (assign 2.5e-3-4e-3, ids 0.03-0.055,
#: dist_err ~7e-4, counts 0.04-0.07; on its own index ids 0-2e-3)
TINY_LIMITS = {"assign_miss": 1e-3, "id_miss": 0.01, "id_miss_on_index": 0.01,
               "dist_err": 1e-5, "count_err": 0.01, "repeat_diff": 0}
CELLS = {"tiny-masked": {"driver": "closed_batches", "batch": 32, "k": 10,
                         "rerank": "masked_full", "check_queries": 48},
         "tiny-gather": {"driver": "closed_batches", "batch": 32, "k": 10,
                         "rerank": "gather", "check_queries": 48}}
FIXTURE_METRIC = '''"""Units the window ran (a fixture of the harness test)."""


def read(ctx):
    return ctx.window["units"]
'''
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def digests(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "anns_bench").rglob("*")) if p.is_file()}


def write_json(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n", encoding="utf-8")


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A copy of the benchmark with a tiny configuration, two mixes, their
    limits and one per-layer metric added as files and entries; returns
    (root, the digests of the files it had before)."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(BENCH, root / "anns_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*.py"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = digests(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "sift1m-taco.json").read_text())
    cfg.update(name="tiny-taco", taco=TINY)
    cfg["dataset"].update(n=4000, d=32, queries=64)
    write_json(root / "anns_bench" / "configs" / "tiny-taco.json", cfg)
    bench["configs"].append({"name": "tiny-taco", "source": "test", "reduced": [],
                             "file": "anns_bench/configs/tiny-taco.json", "why": "test"})
    for name, traffic in CELLS.items():
        write_json(root / "anns_bench" / "traffic" / f"{name}.json", traffic)
        write_json(root / "anns_bench" / "limits" / f"{name}.json", TINY_LIMITS)
        bench["workloads"].append({"name": name, "config": "tiny-taco", "traffic": name,
                                   "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "qps":
            m["workloads"] += ["tiny-masked", "tiny-gather"]
    (root / "anns_bench" / "layer_metrics" / "fixture_units.py").write_text(FIXTURE_METRIC)
    bench["per_layer"].append({"name": "fixture_units", "unit": "units", "better": "higher",
                               "source": "program_counter", "layer": "test", "moves": "qps",
                               "workloads": list(CELLS)})
    write_json(root / "BENCHMARK.json", bench)
    return root, before


def run(root, cell, trace=False, seed=2**31 + 7):
    result, lines, checks = harness.run_cell(root, cell, seed, 0.2, trace, device="cpu")
    return result


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_added_files_are_found_and_run(checkout, cell, trace):
    root, before = checkout
    result = run(root, cell, trace)
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(json.loads(
        (root / "anns_bench" / "limits" / f"{cell}.json").read_text()))
    if trace:
        assert result["metrics"]["fixture_units"]["value"] == result["attempted"]
        assert "breakdown" in result and result["device"]["window_s"] > 0
    else:
        assert {"qps", "setup_s"} <= set(result["metrics"])
    for rel, digest in before.items():  # nothing the copy had was edited
        assert digests(root)[rel] == digest, rel


def patch_answers(monkeypatch, change):
    from repro_torch.ann import searcher

    orig = searcher.SingleDeviceSearcher.run_padded

    def broken(self, bucket, k, cfg, queries):
        res = orig(self, bucket, k, cfg, queries)
        change(res, self.index.n)
        return res

    monkeypatch.setattr(searcher.SingleDeviceSearcher, "run_padded", broken)


def alter_answers(res, n):
    res.ids = res.ids.copy()
    res.ids[::8, 0] = (res.ids[::8, 0] + 1) % n  # every 8th row's best id, its distance kept


def drop_half(res, n):
    half = res.ids.shape[0] // 2
    res.ids, res.dists = res.ids.copy(), res.dists.copy()
    res.ids[half:], res.dists[half:] = -1, np.inf


@pytest.mark.parametrize("cell", ["tiny-masked", "tiny-gather"])
@pytest.mark.parametrize("fault", [alter_answers, drop_half], ids=["altered", "half"])
def test_broken_answers_are_not_correct(checkout, monkeypatch, cell, fault):
    patch_answers(monkeypatch, fault)
    assert run(checkout[0], cell)["correct"] is False


@pytest.mark.parametrize("cell", list(CELLS))
def test_a_lloyd_step_that_keeps_its_state_is_not_correct(checkout, monkeypatch, cell):
    kmeans = importlib.import_module("repro_torch.clustering.kmeans")
    orig = kmeans.lloyd_step_pairs

    def frozen(xs, centroids, dims=None, impl="auto"):
        _new, assign = orig(xs, centroids, dims, impl)
        return centroids, assign

    monkeypatch.setattr(kmeans, "lloyd_step_pairs", frozen)
    assert run(checkout[0], cell)["correct"] is False


@pytest.mark.parametrize("cell", list(CELLS))
def test_the_control_is_not_correct(checkout, cell):
    root = checkout[0]
    ctx = harness.make_context(root, cell, 2**31 + 11, 0.0, False, "cpu")
    driver = spec.load_module(spec.bench_file(root, "drivers", f"{ctx.traffic['driver']}.py"))
    got = control.readings(ctx, driver, ["tf32"])
    assert check.judge(got["program"], check.limits(ctx)) is True
    assert check.judge(got["tf32"], check.limits(ctx)) is False


def test_the_reordered_reference_is_a_reading_with_its_blocks_restored(checkout):
    from anns_bench.reference import taco_ref

    root = checkout[0]
    ctx = harness.make_context(root, "tiny-masked", 2**31 + 13, 0.0, False, "cpu")
    driver = spec.load_module(spec.bench_file(root, "drivers", "closed_batches.py"))
    blocks = taco_ref.BLOCK_BYTES
    got = control.readings(ctx, driver, ["reorder"])
    assert taco_ref.BLOCK_BYTES == blocks and set(got) == {"program", "reorder"}
    assert set(got["reorder"]) == set(got["program"])
    assert check.judge(got["reorder"], check.limits(ctx)) is True


def test_a_wrong_answer_is_read_on_the_programs_index(checkout):
    """Rows answered with other real ids and their true distances: on the
    program's own index the share of such rows reads as it is, with the
    distances still exact; the build's numbers do not move."""
    root = checkout[0]
    ctx = harness.make_context(root, "tiny-masked", 2**31 + 17, 0.0, False, "cpu")
    harness.make_data(ctx)
    rows = np.arange(ctx.queries.shape[0])
    ref, res = check.reference(ctx, rows)
    own = control.side_outputs(ctx, rows, "reorder")  # a sound stand-in for the program
    clean = check.compare(ctx, own, ref, res, check.on_index(ctx, own))
    assert clean["id_miss_on_index"] == 0.0
    bad = dict(own, ids=own["ids"].copy(), dists=own["dists"].copy())
    wrong = rows[:6]  # one tile of six rows: ids moved by one, distances made true
    bad["ids"][wrong] = (bad["ids"][wrong] + 1) % ctx.corpus.shape[0]
    x = ctx.corpus[torch.as_tensor(bad["ids"][wrong])]
    bad["dists"][wrong] = torch.sum((x - ctx.queries[wrong][:, None]) ** 2, -1).numpy()
    got = check.compare(ctx, bad, ref, res, check.on_index(ctx, bad))
    assert got["id_miss_on_index"] >= 0.9 * len(wrong) / len(rows)
    assert got["dist_err"] < 1e-5 and got["assign_miss"] == clean["assign_miss"]
