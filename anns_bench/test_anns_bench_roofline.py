"""Each kernel's roofline count pinned against hand arithmetic at the main
path's shapes (Q 1000, n 10^6, N_s 6, K 1024, d 128), and the trace
reduction that the shares and the idle share read."""
from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest

from anns_bench import peaks, rooflines, spec, trace

ROOT = Path(__file__).resolve().parents[1]


def ctx(n_sub=6, s=8, clusters=1024, n=10 ** 6, d=128, batch=1000, k=10, units=1,
        cand_total=0, touched=0):
    return SimpleNamespace(
        root=ROOT, taco={"n_subspaces": n_sub, "subspace_dim": s, "n_clusters": clusters},
        config={"dataset": {"n": n, "d": d}}, traffic={"batch": batch, "k": k},
        window={"units": units, "cand_total": cand_total}, checked={"touched": touched})


def work(kernel, c):
    return spec.load_module(ROOT / "anns_bench" / "roofline" / f"{kernel}.py").work(
        c, rooflines.shapes(c))


def test_int_bytes():
    assert [peaks.int_bytes(v) for v in (0, 6, 255, 256, 4095, 65535, 65536)] == [
        1, 1, 1, 2, 2, 2, 4]


def test_schist_count():
    w = work("schist", ctx())
    # one 32-bit op a (point, subspace, 32 queries): 32 x 10^6 x 6
    assert w["ops"] == {"cuda_core_32bit": 32 * 10 ** 6 * 6}
    # 2-byte cell ids, the table as bits, int32 counts
    assert w["bytes"] == 2 * 6 * 10 ** 6 + 1000 * 6 * 1024 / 8 + 4 * 1000 * 7
    assert peaks.bound_seconds(w) == pytest.approx(12_796_000 / 3.35e12)


def test_masked_rerank_count():
    w = work("masked_rerank", ctx(units=3, cand_total=3 * 5_000_000, touched=600_000))
    assert w["ops"] == {"cuda_core_32bit": 3 * 32 * 10 ** 6 * 6,
                        "tf32_tensor": 2 * 128 * 15_000_000}
    per_batch = (12_000_000 + 768_000 + 1000 + 4 * 1000 * 128 + 4 * 600_000 * 128
                 + 8 * 1000 * 10)
    assert w["bytes"] == 3 * per_batch
    assert peaks.bound_seconds(w) == pytest.approx(3 * per_batch / 3.35e12)


def test_masked_rerank_needs_its_counts():
    c = ctx()
    c.checked = {}
    assert work("masked_rerank", c) is None


def test_scscore_count():
    w = work("scscore", ctx())
    # the (Q, n) scores in one byte each (0..6)
    assert w["bytes"] == 12_000_000 + 768_000 + 10 ** 9
    assert peaks.bound_seconds(w) == pytest.approx(1_012_768_000 / 3.35e12)


def events():
    """A window from 0 to 100 us: kernels at 10-30 and 20-40 (overlapping
    streams), a copy at 60-70, spans that the profiler copies onto the
    device's timeline, host operations around them."""
    return [
        ("bench.window", 0.0, 100.0, "host"),
        ("bench.closed_batches.unit", 0.0, 100.0, "span"),
        ("core.taco.activation", 5.0, 95.0, "span"),
        ("void (anonymous namespace)::schist_kernel<8, 3>(int)", 10.0, 30.0, "device"),
        ("void (anonymous namespace)::rerank_chunk_kernel<5, false>(int)", 20.0, 40.0,
         "device"),
        ("Memcpy DtoH (Device -> Pageable)", 60.0, 70.0, "device"),
        ("void (anonymous namespace)::schist_wide_kernel<5>(int)", 150.0, 160.0, "device"),
        ("aten::sort", 35.0, 58.0, "host"),
        ("cudaMemcpyAsync", 41.0, 71.0, "host"),
        ("aten::copy_", 0.0, 90.0, "host"),
    ]


def test_trace_union_gaps_and_names():
    s = trace.summarize(events())
    assert s["window_us"] == 100.0
    assert s["busy_us"] == 30.0 + 10.0  # 10-40 once, 60-70
    assert len(s["device"]) == 3  # the spans and the kernel past the window are out
    gaps = trace.idle_gaps(s)
    assert [g[1] for g in gaps] == [30e-6, 20e-6, 10e-6]
    assert [g[0] for g in gaps] == ["cudaMemcpyAsync", "aten::sort", "aten::copy_"]
    ops = dict(trace.device_ops(s))
    assert ops["Memcpy DtoH (Device -> Pageable)"] == pytest.approx(10e-6)


class FakeEvent:
    """A raw Kineto event as ``events_of`` reads it."""

    def __init__(self, name, start_us, end_us, device, annotation):
        self._name, self._start, self._end = name, start_us, end_us
        self._device, self._annotation = device, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return int(self._start * 1000)

    def duration_ns(self):
        return int((self._end - self._start) * 1000)

    def device_type(self):
        return SimpleNamespace(name=self._device)

    def is_user_annotation(self):
        return self._annotation


def test_device_spans_are_no_device_operations_whatever_their_names():
    """A span that the profiler copies onto the device's timeline counts as
    no work, whether or not its name is the benchmark's; a kernel counts
    whatever its name."""
    raw = [FakeEvent("bench.window", 0.0, 100.0, "CPU", True),
           FakeEvent("core.taco.activation", 5.0, 95.0, "CUDA", True),
           FakeEvent("bench.closed_batches.unit", 0.0, 100.0, "CUDA", True),
           FakeEvent("core.taco.rerank", 20.0, 30.0, "CUDA", False),
           FakeEvent("Memset (Device)", 50.0, 55.0, "CUDA", False),
           FakeEvent("aten::sort", 10.0, 60.0, "CPU", False)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: raw)))
    got = trace.events_of(prof)
    assert [e[3] for e in got] == ["host", "span", "span", "device", "device", "host"]
    s = trace.summarize(got)
    assert s["busy_us"] == 15.0 and len(s["device"]) == 2
    assert set(dict(trace.device_ops(s))) == {"core.taco.rerank", "Memset (Device)"}
    assert trace.idle_gaps(s)[0] == ["aten::sort", pytest.approx(45e-6)]


def test_events_of_reads_the_profiler_on_the_cpu():
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW_SPAN):
            torch.ones(64).sum()
    got = trace.events_of(prof)
    assert (trace.WINDOW_SPAN, "host") in {(e[0], e[3]) for e in got}
    s = trace.summarize(got)
    assert s["busy_us"] == 0 and s["window_us"] > 0 and s["host"]


def test_kernel_seconds_match_whole_names():
    s = trace.summarize(events())
    assert trace.kernel_seconds(s, ("schist_kernel",)) == pytest.approx(20e-6)
    assert trace.kernel_seconds(s, ("rerank_chunk_kernel", "merge_chunks_kernel")) == \
        pytest.approx(20e-6)
    assert trace.kernel_seconds(s, ("scscore_kernel",)) is None


def test_share_reads_trace_and_count():
    c = ctx(units=1)
    c.profile = trace.summarize(events())
    got = rooflines.share(c, "schist")
    assert got == pytest.approx(100 * (12_796_000 / 3.35e12) / 20e-6)
    c.profile = None
    assert rooflines.share(c, "schist") is None


def test_every_kernel_count_exists_for_each_roofline_metric():
    bench = spec.load_benchmark(ROOT)
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline"):
            mod = spec.load_module(ROOT / "anns_bench" / "roofline"
                                   / f"{m['name'][:-len('_roofline')]}.py")
            assert mod.KERNELS and callable(mod.work)
