"""What ``BENCHMARK.json`` names, found as files under the benchmark's folder.

Everything particular to one configuration, traffic mix or metric sits in a
file of its own, found by the name the cell or the metric gives:

  configs/<config>.json          sizes, generator, index parameters
  traffic/<traffic>.json         a mix's parameters; its ``driver`` names
  drivers/<driver>.py            the general loop that runs such mixes
  data/<generator kind>.py       the corpus and queries from the seed
  limits/<workload>.json         each compared number's limit
  end_to_end/<metric>.py         a ``read(ctx)`` for each end-to-end metric
  layer_metrics/<metric>.py      a ``read(ctx)`` for each per-layer metric
  roofline/<kernel>.py           a kernel's operations and bytes

So a later change adds a cell, a mix or a metric by adding files and
entries, and edits none.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = "anns_bench"


def read_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_benchmark(root: Path) -> dict:
    return read_json(Path(root) / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for cfg in bench["configs"]:
        if cfg["name"] == name:
            return cfg
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def bench_file(root: Path, *parts: str) -> Path:
    path = Path(root) / BENCH_DIR
    for part in parts:
        path = path / part
    if not path.exists():
        raise FileNotFoundError(f"{path} (named by BENCHMARK.json) does not exist")
    return path


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end ones untraced,
    its per-layer ones traced (a metric without ``workloads`` is every
    cell's)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def load_module(path: Path):
    """The module in ``path``, loaded by its path (names such as
    ``device_idle_pct.query`` hold dots, so they are not imported by name)."""
    spec = importlib.util.spec_from_file_location(f"_anns_bench.{Path(path).stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, group: str, name: str):
    """The ``read`` function of metric ``name`` in folder ``group``."""
    return load_module(bench_file(root, group, f"{name}.py")).read
