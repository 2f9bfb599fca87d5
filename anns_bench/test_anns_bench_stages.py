"""The readers of the program's query stages: ``activation_ms``,
``selection_ms`` and ``device_idle_pct.between_batches``.

In a tiny CPU copy of the benchmark (the harness test's pattern) a traced run
of each mix reports all three, the idle between batches no more than the
whole idle share; an untraced run reports none. A synthetic profile pins the
rule of the between-batches share, and a program without the stage counters
or spans reads None, as the parent of this metric does."""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest

from anns_bench import harness, spec, stages
from anns_bench.test_anns_bench_harness import CELLS, TINY, TINY_LIMITS, write_json

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "anns_bench"
NEW = ("activation_ms", "selection_ms", "device_idle_pct.between_batches")


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A copy of the benchmark with a tiny configuration and two mixes whose
    cells the three stage metrics and ``device_idle_pct.query`` list."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(BENCH, root / "anns_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*.py"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
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
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in NEW + ("qps", "device_idle_pct.query"):
            m["workloads"] += list(CELLS)
    write_json(root / "BENCHMARK.json", bench)
    return root


def test_the_benchmark_lists_the_three_for_every_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = [c["name"] for c in bench["workloads"]]
    got = {m["name"]: m for m in bench["per_layer"] if m["name"] in NEW}
    assert set(got) == set(NEW) and [m["name"] for m in bench["per_layer"][-3:]] == list(NEW)
    for m in got.values():
        assert m["workloads"] == cells and m["moves"] == "qps"
    assert got["activation_ms"]["layer"] == "core.activation"
    assert got["selection_ms"]["layer"] == "core.selection"
    for name in NEW:
        assert spec.bench_file(ROOT, "layer_metrics", f"{name}.py").exists()


@pytest.mark.parametrize("cell", list(CELLS))
def test_a_traced_run_reports_the_stage_metrics(checkout, cell):
    result, _lines, _checks = harness.run_cell(checkout, cell, 2**31 + 19, 0.2, True,
                                               device="cpu")
    assert result["correct"] is True
    got = {name: result["metrics"][name]["value"] for name in NEW}
    assert got["activation_ms"] > 0 and got["selection_ms"] > 0
    idle = result["metrics"]["device_idle_pct.query"]["value"]
    assert 0 <= got["device_idle_pct.between_batches"] <= idle + 1e-9
    assert result["metrics"]["activation_ms"]["unit"] == "ms"


def test_an_untraced_run_reports_none_of_them(checkout):
    result, _lines, _checks = harness.run_cell(checkout, "tiny-masked", 2**31 + 23, 0.2,
                                               False, device="cpu")
    assert not set(NEW) & set(result["metrics"])


def _ctx(profile):
    return SimpleNamespace(profile=profile, traffic={"driver": "closed_batches"})


def test_the_between_batches_rule():
    """Gaps named by where the host was when each began: in ``to_host``
    (counts), in ``taco.activation`` (does not), in no batch (counts), at
    a batch's very start (does not) and at its very end (counts)."""
    host = [(0.0, 100.0, "searcher.batch"), (10.0, 40.0, "taco.activation"),
            (80.0, 100.0, "searcher.to_host"), (150.0, 250.0, "searcher.batch"),
            (230.0, 250.0, "searcher.to_host"), (0.0, 300.0, "bench.closed_batches.unit")]
    gaps = [(3.0, 85.0), (5.0, 20.0), (7.0, 120.0), (11.0, 150.0), (13.0, 250.0)]
    profile = {"window_us": 300.0, "busy_us": 261.0, "host": host, "gaps": gaps,
               "device": []}
    assert stages.between_batches_us(profile) == 3.0 + 7.0 + 13.0
    read = spec.reader(ROOT, "layer_metrics", "device_idle_pct.between_batches")
    assert read(_ctx(profile)) == pytest.approx(100.0 * 23.0 / 300.0)
    no_spans = dict(profile, host=[h for h in host if not h[2].startswith("searcher.")])
    assert stages.between_batches_us(no_spans) is None
    assert read(_ctx(no_spans)) is None
    assert read(_ctx(None)) is None


def test_without_stage_counters_the_readers_read_none(monkeypatch):
    from repro_torch.obs import metrics

    profile = {"window_us": 1.0, "busy_us": 0.0, "host": [], "gaps": [], "device": []}
    monkeypatch.setattr(metrics, "snapshot", lambda: {"taco_searcher_compiles_total": 1.0})
    for name in ("activation_ms", "selection_ms"):
        read = spec.reader(ROOT, "layer_metrics", name)
        assert read(_ctx(profile)) is None
        assert read(_ctx(None)) is None
    monkeypatch.setattr(metrics, "snapshot", lambda: {
        "taco_stage_batches_total": 4.0,
        "taco_stage_seconds_total{stage=taco.activation}": 0.06})
    assert spec.reader(ROOT, "layer_metrics", "activation_ms")(_ctx(profile)) == \
        pytest.approx(15.0)
    assert spec.reader(ROOT, "layer_metrics", "selection_ms")(_ctx(profile)) is None
