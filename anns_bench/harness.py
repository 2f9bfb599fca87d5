"""One run of one cell: set-up, the measured window, the check, the metrics.

:func:`run_cell` takes the cell's entry from ``BENCHMARK.json`` and finds its
configuration, traffic mix, driver, generator, limits and metric readers as
files (:mod:`anns_bench.spec`). The driver's ``setup`` builds the program's
index and warms the cell's one shape; the window then calls its ``unit``
back to back (a closed loop: the next unit starts when the last returned,
and each ends synchronised) until ``seconds`` have passed, and runs on to the
end of the unit in flight. With ``trace`` the window runs under
``torch.profiler``. After the window the driver hands over what the program
produced, frees its state, and :mod:`anns_bench.check` holds it to the plain
reference.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import torch

from anns_bench import check, spec
from anns_bench import trace as trace_mod

@dataclasses.dataclass
class Context:
    """Everything a driver, a metric reader or the check reads."""

    root: Path
    bench: dict
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    corpus: torch.Tensor | None = None
    queries: torch.Tensor | None = None
    #: the driver's state: the program's index, searcher, answers
    program: dict = dataclasses.field(default_factory=dict)
    #: the window: seconds, units, work, per-unit records, launches, peak
    window: dict = dataclasses.field(default_factory=dict)
    #: the traced window's summary (:func:`anns_bench.trace.summarize`)
    profile: dict | None = None
    #: what the check learned that readers use (e.g. the rows re-ranked)
    checked: dict = dataclasses.field(default_factory=dict)
    #: lines printed to standard error before the check's
    lines: list = dataclasses.field(default_factory=list)

    @property
    def taco(self) -> dict:
        return self.config["taco"]

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)


def _launch_counts() -> dict:
    from repro_torch.kernels import cuda

    return dict(cuda.launch_counts), {k: dict(v) for k, v in cuda.launch_layouts.items()}


def _launch_delta(before, after) -> tuple[dict, dict]:
    counts = {k: after[0][k] - before[0].get(k, 0) for k in after[0]}
    layouts = {}
    for kernel, lay in after[1].items():
        diff = {name: n - before[1].get(kernel, {}).get(name, 0) for name, n in lay.items()}
        layouts[kernel] = {name: n for name, n in diff.items() if n}
    return ({k: n for k, n in counts.items() if n},
            {k: v for k, v in layouts.items() if v})


def make_context(root: Path, workload: str, seed: int, seconds: float, trace: bool,
                 device) -> Context:
    bench = spec.load_benchmark(root)
    cell = spec.workload(bench, workload)
    cfg_entry = spec.config_entry(bench, cell["config"])
    config = spec.read_json(Path(root) / cfg_entry["file"])
    traffic = spec.read_json(spec.bench_file(root, "traffic", f"{cell['traffic']}.json"))
    return Context(root=Path(root), bench=bench, cell=cell, config=config, traffic=traffic,
                   seed=int(seed), seconds=float(seconds), trace=bool(trace),
                   device=torch.device(device))


def make_data(ctx: Context) -> None:
    """The corpus and the queries, drawn from the seed on the device."""
    ds = ctx.config["dataset"]
    gen = ctx.config["generator"]
    mod = spec.load_module(spec.bench_file(ctx.root, "data", f"{gen['kind']}.py"))
    ctx.corpus, ctx.queries = mod.corpus_and_queries(
        gen, int(ds["n"]), int(ds["d"]), int(ds["queries"]), ctx.seed, ctx.device)
    ctx.sync()


def _window(ctx: Context, driver) -> None:
    """Units back to back until ``seconds`` have passed; the window closes at
    the end of the unit in flight."""
    before = _launch_counts()
    units, work = 0, 0
    name = f"bench.{ctx.traffic['driver']}.unit"
    t0 = time.perf_counter()
    while True:
        if ctx.trace:
            with torch.profiler.record_function(name):
                work += driver.unit(ctx, units)
        else:
            work += driver.unit(ctx, units)
        units += 1
        now = time.perf_counter()
        if now - t0 >= ctx.seconds:
            break
    counts, layouts = _launch_delta(before, _launch_counts())
    ctx.window.update(seconds=now - t0, units=units, work=work, launches=counts,
                      layouts=layouts)
    ctx.lines.append(f"window: {units} units, {now - t0!r} s, kernel launches {counts}, "
                     f"layouts {layouts}")


def measure(ctx: Context, driver) -> None:
    if not ctx.trace:
        _window(ctx, driver)
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if ctx.on_card else [])
    ctx.sync()
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(trace_mod.WINDOW_SPAN):
            _window(ctx, driver)
        ctx.sync()
    ctx.profile = trace_mod.summarize(trace_mod.events_of(prof))


def _metric_values(ctx: Context) -> dict:
    out = {}
    for m in spec.metrics_of(ctx.bench, ctx.cell["name"], ctx.trace):
        group = "layer_metrics" if ctx.trace else "end_to_end"
        value = spec.reader(ctx.root, group, m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None) -> tuple[dict, list, list]:
    """One run. Returns (the result line's object, earlier lines, the check's
    lines); ``t_start`` is the process's start on the host clock."""
    t_start = time.perf_counter() if t_start is None else t_start
    ctx = make_context(root, workload, seed, seconds, trace, device)
    driver = spec.load_module(spec.bench_file(root, "drivers", f"{ctx.traffic['driver']}.py"))
    make_data(ctx)
    if ctx.on_card:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    driver.setup(ctx)
    ctx.sync()
    ctx.window["setup_s"] = time.perf_counter() - t_start
    measure(ctx, driver)
    if ctx.on_card:
        ctx.window["peak_bytes"] = torch.cuda.max_memory_allocated(ctx.device)
    produced = driver.outputs(ctx)
    driver.release(ctx)
    numbers, lines = check.run(ctx, produced)
    lim = check.limits(ctx)
    correct = check.judge(numbers, lim)
    metrics = _metric_values(ctx)
    dev = {"platform": "gpu" if ctx.on_card else ctx.device.type,
           "kind": torch.cuda.get_device_name(ctx.device) if ctx.on_card else "cpu",
           "count": 1,
           "memory_peak_bytes": int(ctx.window.get("peak_bytes", 0))}
    result = {"correct": correct, "attempted": ctx.window["units"],
              "failed": 0 if correct else ctx.window["units"], "metrics": metrics,
              "device": dev}
    if ctx.trace:
        dev["busy_s"] = ctx.profile["busy_us"] / 1e6
        dev["window_s"] = ctx.profile["window_us"] / 1e6
        result["breakdown"] = {"device_ops": trace_mod.device_ops(ctx.profile),
                               "idle_gaps": trace_mod.idle_gaps(ctx.profile)}
    result["checks"] = {name: {"value": v, "limit": lim[name]} for name, v in numbers.items()}
    return result, ctx.lines, lines
