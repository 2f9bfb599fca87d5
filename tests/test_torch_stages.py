"""The query path's stage spans (``repro_torch.obs.trace.stage``).

With no ``torch.profiler`` recording a stage is the shared no-op: no
``record_function`` range, no CUDA event, no counter moves. Under the
profiler each batch of a tiny CPU index, on both pipelines, yields the
stages in their order, each leaf inside its ``searcher.batch``, and the
counters advance by one batch and positive seconds; the answers are the same
bit for bit with the profiler on and off. The card's event path is driven
here with stand-in events (settled only once complete, never waited for,
at most ``PENDING_CAP`` of them queued), and once more on a card. The
mutable index's batches open the same stages. The Tracer's spans lie on the
profiler's clock, and ``chip_smoke.py``'s profiles count no stage span as
work of the card.
"""
import importlib.util
import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.ann import AnnIndex
from repro_torch.core.config import taco_config
from repro_torch.obs import metrics as obsm
from repro_torch.obs import trace as obst

#: the stages of one batch, in the order they open
ORDER = ["searcher.batch", "searcher.pad", "taco.centroid_dists", "taco.activation",
         "taco.collide", "taco.select", "taco.rerank", "searcher.to_host"]
LEAVES = ORDER[1:]


def _cfg(rerank: str):
    return taco_config(n_subspaces=2, subspace_dim=4, n_clusters=16, kmeans_iters=2,
                       rerank=rerank)


@pytest.fixture(scope="module", params=["masked_full", "gather"])
def searcher(request):
    data = np.random.default_rng(0).integers(0, 9, (2000, 16)).astype(np.float32)
    index = AnnIndex.build(data, _cfg(request.param), device="cpu")
    return index.searcher("single"), data[:37]


def _counters() -> dict:
    snap = obsm.snapshot()
    out = {name: snap.get(f"taco_stage_seconds_total{{stage={name}}}", 0.0) for name in ORDER}
    out["batches"] = snap.get("taco_stage_batches_total", 0.0)
    return out


def _stage_events(prof) -> list[tuple[str, int, int]]:
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name() in ORDER]
    return sorted(evs, key=lambda e: e[1])


class _Counting:
    """Counts ``record_function`` entries and CUDA events made."""

    def __init__(self, monkeypatch):
        self.ranges = 0
        self.events = 0
        enter = torch.autograd.profiler.record_function.__enter__
        counting = self

        def counted_enter(rf):
            counting.ranges += 1
            return enter(rf)

        class Event(_FakeEvent):
            def __init__(self, *a, **kw):
                counting.events += 1
                super().__init__()

        monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", counted_enter)
        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)


class _FakeEvent:
    """A CUDA event stand-in: complete when ``done``; stamps the host clock
    when recorded. It has no ``synchronize``, so a wait would raise."""

    def __init__(self, *a, **kw):
        self.done = True
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def query(self) -> bool:
        return self.done

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def test_off_stage_is_the_shared_noop_and_nothing_moves(searcher, monkeypatch):
    s, q = searcher
    counting = _Counting(monkeypatch)
    assert not torch._C._autograd._profiler_enabled()
    assert obst.stage("taco.activation", torch.device("cuda")) is obst.NULL_STAGE
    assert obst.stage("searcher.batch", "cpu") is obst.NULL_STAGE
    before = _counters()
    s.search_with_stats(q)
    assert _counters() == before
    assert counting.ranges == 0 and counting.events == 0
    assert len(obst._pending) == 0


def test_on_each_batch_yields_the_stages_in_order(searcher):
    s, q = searcher
    s.search_with_stats(q)  # the key is made outside the trace
    before = _counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.search_with_stats(q)
        s.search_with_stats(q)
    evs = _stage_events(prof)
    assert [e[0] for e in evs] == ORDER * 2
    for b in range(2):
        batch = evs[b * len(ORDER)]
        leaves = evs[b * len(ORDER) + 1:(b + 1) * len(ORDER)]
        for _name, start, end in leaves:
            assert batch[1] <= start <= end <= batch[2]
        for one, two in zip(leaves, leaves[1:]):
            assert one[2] <= two[1]  # leaves do not overlap
    after = _counters()
    assert after["batches"] == before["batches"] + 2
    for name in ORDER:
        assert after[name] > before[name], name


def test_answers_are_bitwise_the_same_with_the_profiler_on(searcher):
    s, q = searcher
    off = s.search_with_stats(q)
    with profile(activities=[ProfilerActivity.CPU]):
        on = s.search_with_stats(q)
    assert np.array_equal(off[0], on[0])
    assert np.array_equal(off[1].view(np.int32), on[1].view(np.int32))
    assert np.array_equal(off[2]["candidate_count"], on[2]["candidate_count"])
    assert np.array_equal(off[2]["truncated"], on[2]["truncated"])


def test_card_stages_wait_as_event_pairs_until_settled(monkeypatch):
    """The card's path with stand-in events: one range and two events a
    stage; the seconds are added only by ``settle_stages`` and only once the
    end event has completed; an incomplete pair stays pending."""
    counting = _Counting(monkeypatch)
    monkeypatch.setattr(obst, "_pending", type(obst._pending)())
    before = _counters()
    with profile(activities=[ProfilerActivity.CPU]):
        with obst.stage("taco.activation", torch.device("cuda")):
            time.sleep(0.002)
        with obst.stage("taco.select", "cuda:0"):
            pass
        assert counting.ranges == 2 and counting.events == 4
        assert _counters() == before  # nothing is read at the stage's exit
        obst._pending[1][2].done = False  # taco.select's end not reached yet
        obst.settle_stages(batch=True)
    mid = _counters()
    assert mid["batches"] == before["batches"] + 1
    assert mid["taco.activation"] - before["taco.activation"] >= 0.002
    assert mid["taco.select"] == before["taco.select"]
    assert [item[0] for item in obst._pending] == ["taco.select"]
    obst._pending[0][2].done = True
    obst.settle_stages()  # after the profiler: settles, counts no batch
    after = _counters()
    assert after["taco.select"] > mid["taco.select"] and after["batches"] == mid["batches"]
    assert len(obst._pending) == 0


def test_unsettled_event_pairs_are_capped(monkeypatch):
    """A profiled caller that settles nothing (``core.taco.query`` called
    directly on the card) keeps at most ``PENDING_CAP`` pairs, the newest."""
    _Counting(monkeypatch)
    monkeypatch.setattr(obst, "_pending", type(obst._pending)(maxlen=obst._pending.maxlen))
    assert obst._pending.maxlen == obst.PENDING_CAP
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(obst.PENDING_CAP + 3):
            with obst.stage(f"s{i}", "cuda"):
                pass
    assert len(obst._pending) == obst.PENDING_CAP
    assert obst._pending[0][0] == "s3" and obst._pending[-1][0] == f"s{obst.PENDING_CAP + 2}"


def test_mutable_batches_open_the_same_stages():
    data = np.random.default_rng(1).integers(0, 9, (2000, 16)).astype(np.float32)
    m = AnnIndex.build(data, _cfg("masked_full"), device="cpu").mutable()
    m.insert(data[:50] + 1.0)
    s = m.searcher()
    s.search_with_stats(data[:37])
    before = _counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.search_with_stats(data[:37])
    assert [e[0] for e in _stage_events(prof)] == ORDER
    after = _counters()
    assert after["batches"] == before["batches"] + 1
    assert after["searcher.to_host"] > before["searcher.to_host"]


def _avg(device_type, key, us, annotation=False, count=1):
    return SimpleNamespace(device_type=device_type, key=key, count=count,
                           is_user_annotation=annotation, self_device_time_total=us,
                           self_cpu_time_total=us)


def test_chip_smoke_profiles_count_no_stage_span_as_device_work():
    """A ``record_function`` range copied onto the card's timeline reports
    its whole length as device time; ``profile_rows`` leaves it out of the
    device rows that ``profile_call`` and ``profile_build`` sum."""
    averages = [
        _avg(DeviceType.CUDA, "schist_kernel", 40.0, count=2),
        _avg(DeviceType.CUDA, "searcher.batch", 900.0, annotation=True),
        _avg(DeviceType.CUDA, "taco.select", 300.0, annotation=True),
        _avg(DeviceType.CUDA, "Memcpy DtoH", 5.0),
        _avg(DeviceType.CUDA, "idle", 0.0),
        _avg(DeviceType.CPU, "aten::where", 12.0, count=3),
        _avg(DeviceType.CPU, "searcher.batch", 7.0),
    ]
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    device, host = chip_smoke.profile_rows(averages)
    assert device == [(40.0, 2, "schist_kernel"), (5.0, 1, "Memcpy DtoH")]
    assert host == [(12.0, 3, "aten::where"), (7.0, 1, "searcher.batch")]


def test_tracer_spans_lie_on_the_profilers_clock(tmp_path):
    tr = obst.Tracer(sample_rate=1.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.start_trace("work"), torch.profiler.record_function("work"):
            time.sleep(0.02)
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = doc["baseTimeNanoseconds"]
    ref = next(e for e in doc["traceEvents"]
               if e.get("name") == "work" and e.get("ph") == "X")
    own = tr.to_chrome()
    assert own["baseTimeNanoseconds"] == tr.epoch_unix_ns
    x = next(e for e in own["traceEvents"] if e["ph"] == "X")
    # nanoseconds on the Unix-epoch axis: within 1 ms
    assert abs((own["baseTimeNanoseconds"] + x["ts"] * 1e3)
               - (base + ref["ts"] * 1e3)) < 1e6
    assert abs(x["dur"] - ref["dur"]) < 1000.0  # microseconds


@pytest.mark.cuda
def test_a_batchs_stage_seconds_fit_in_its_wall_time():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    data = torch.randn(100_000, 64, device="cuda", generator=g)
    for rerank in ("masked_full", "gather"):
        index = AnnIndex.build(data, taco_config(n_subspaces=4, subspace_dim=16,
                                                 n_clusters=256, kmeans_iters=4,
                                                 rerank=rerank), device="cuda")
        s = index.searcher("single")
        q = data[:1000]
        s.search_with_stats(q)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            obst.settle_stages()
            before = _counters()
            t0 = time.perf_counter()
            s.search_with_stats(q)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            obst.settle_stages()
        after = _counters()
        assert after["batches"] == before["batches"] + 1
        leaves = [after[name] - before[name] for name in LEAVES]
        assert all(sec > 0 for sec in leaves), dict(zip(LEAVES, leaves))
        assert sum(leaves) <= wall, (rerank, dict(zip(LEAVES, leaves)), wall)
        assert after["searcher.batch"] - before["searcher.batch"] <= wall
