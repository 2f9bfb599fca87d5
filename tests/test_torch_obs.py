"""The port's own observability package (``repro_torch.obs``): the stdlib
cases of ``tests/test_obs_metrics.py`` and ``tests/test_obs_trace.py`` run
on the copy — counter/gauge/histogram semantics, per-thread shard
exactness, the percentile error bound, Prometheus text,
the HTTP export surface, sampling, the bounded ring and Chrome export —
plus the port's own contract: its registry is a separate object from the
reference's, the metric families the port's modules register carry the
reference's names, and the port's WAL traces its group commits.
"""
import json
import math
import threading
import urllib.request

import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.obs import ObsServer, metrics as obsm
from repro_torch.obs import trace as obst
from repro_torch.obs.metrics import (
    NBUCKETS,
    RELATIVE_ERROR_BOUND,
    Histogram,
    MetricsRegistry,
    bucket_index,
    bucket_mid,
    bucket_upper,
)


# ----------------------------------------------------------- counters --
def test_counter_inc_value_reset():
    reg = MetricsRegistry()
    c = reg.counter("t_requests_total", "help text")
    assert c.value == 0.0
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    c.reset()
    assert c.value == 0.0


def test_counter_registration_is_idempotent():
    reg = MetricsRegistry()
    a = reg.counter("t_total")
    b = reg.counter("t_total")
    assert a is b
    a.inc()
    assert b.value == 1.0


def test_family_kind_conflict_raises():
    reg = MetricsRegistry()
    reg.counter("t_total")
    with pytest.raises(ValueError, match="re-registered"):
        reg.gauge("t_total")


def test_labeled_family_children():
    reg = MetricsRegistry()
    fam = reg.counter("t_tasks_total", labelnames=("outcome",))
    ok, failed = fam.labels(outcome="ok"), fam.labels(outcome="failed")
    assert ok is not failed
    assert fam.labels(outcome="ok") is ok
    ok.inc(3)
    failed.inc()
    assert {lv: ch.value for lv, ch in fam.children()} == {
        ("failed",): 1.0, ("ok",): 3.0,
    }
    with pytest.raises(ValueError, match="labels"):
        fam.labels(nope="x")


def test_gauge_last_write_wins():
    reg = MetricsRegistry()
    g = reg.gauge("t_depth")
    g.set(7)
    g.set(3)
    assert g.value == 3.0
    g.reset()
    assert g.value == 0.0


# --------------------------------------------------------- histograms --
def test_bucket_geometry():
    # boundaries are geometric with SUBDIV steps per octave; the midpoint
    # sits strictly inside its bucket
    for i in (0, 1, NBUCKETS // 2, NBUCKETS - 1):
        lo = bucket_upper(i - 1) if i else 0.0
        assert lo < bucket_mid(i) < bucket_upper(i)
    assert bucket_index(1e-12) == 0  # below-range clamps to the edge
    assert bucket_index(1e12) == NBUCKETS - 1


def test_histogram_zero_latency_is_exact():
    h = Histogram("t")
    for _ in range(10):
        h.observe(0.0)
    h.observe(1.0)
    assert h.count == 11
    assert h.percentile(50) == 0.0  # rank falls among the exact zeros
    assert h.percentile(99) > 0.0


def test_histogram_percentile_error_bound_simple():
    h = Histogram("t")
    vals = [0.001 * (i + 1) for i in range(100)]
    for v in vals:
        h.observe(v)
    vals.sort()
    for q in (50, 90, 99):
        want = vals[max(1, math.ceil(q / 100 * len(vals))) - 1]
        got = h.percentile(q)
        assert abs(got - want) <= RELATIVE_ERROR_BOUND * want


def test_histogram_summary_and_sum():
    h = Histogram("t")
    for v in (0.5, 1.0, 2.0):
        h.observe(v)
    s = h.summary()
    assert s["count"] == 3
    assert s["sum"] == pytest.approx(3.5)
    assert s["min"] == 0.5 and s["max"] == 2.0
    assert s["p50"] == h.percentile(50)
    assert h.percentile(0) <= s["p50"] <= s["p99"]


def test_histogram_empty():
    h = Histogram("t")
    assert h.count == 0
    assert h.percentile(50) == 0.0
    assert h.summary()["p99"] == 0.0
    assert h.cumulative_buckets() == []


def test_histogram_reset():
    h = Histogram("t")
    h.observe(1.0)
    h.reset()
    assert h.count == 0
    assert h.percentile(50) == 0.0


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(min_value=1e-6, max_value=100.0),
                min_size=1, max_size=200))
def test_histogram_percentile_property(values):
    """Satellite acceptance: for any in-range sample, reported p50/p99
    stay within the documented RELATIVE_ERROR_BOUND of the exact
    rank-order statistic."""
    h = Histogram("t")
    for v in values:
        h.observe(v)
    ordered = sorted(values)
    for q in (50, 99):
        rank = max(1, math.ceil(q / 100 * len(ordered)))
        want = ordered[rank - 1]
        got = h.percentile(q)
        assert abs(got - want) <= RELATIVE_ERROR_BOUND * want + 1e-12


def test_timed_context_manager():
    h = Histogram("t")
    with obsm.timed(h):
        pass
    assert h.count == 1
    assert h.sum >= 0.0


# -------------------------------------------------------- concurrency --
def test_counter_concurrent_exactness():
    """Per-thread shards: N threads x M increments merge to exactly N*M
    (no lost updates, no locks on the hot path)."""
    reg = MetricsRegistry()
    c = reg.counter("t_total")
    n_threads, per = 8, 5000

    def work():
        for _ in range(per):
            c.inc()

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == n_threads * per
    assert len(c._shards) == n_threads


def test_histogram_concurrent_exactness():
    h = Histogram("t")
    n_threads, per = 8, 2000

    def work(i):
        for j in range(per):
            h.observe(0.001 * (i + 1))

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert h.count == n_threads * per
    assert len(h._shards) == n_threads  # fixed memory: one cell per thread


# ----------------------------------------------------------- exports --
def _mk_registry():
    reg = MetricsRegistry()
    reg.counter("t_requests_total", "requests").inc(5)
    fam = reg.counter("t_tasks_total", "tasks", labelnames=("outcome",))
    fam.labels(outcome="ok").inc(2)
    h = reg.histogram("t_latency_seconds", "latency")
    for v in (0.0, 0.01, 0.02, 0.5):
        h.observe(v)
    reg.gauge("t_depth", "queue depth").set(3)
    return reg


def test_render_prometheus_text():
    text = _mk_registry().render_prometheus()
    lines = text.strip().splitlines()
    assert "# TYPE t_requests_total counter" in lines
    assert "t_requests_total 5" in lines
    assert 't_tasks_total{outcome="ok"} 2' in lines
    assert "# TYPE t_latency_seconds histogram" in lines
    assert 't_latency_seconds_bucket{le="+Inf"} 4' in lines
    assert "t_latency_seconds_count 4" in lines
    assert "t_depth 3" in lines
    # cumulative bucket counts are monotone and end at the total count
    cums = [int(ln.rsplit(" ", 1)[1]) for ln in lines
            if ln.startswith("t_latency_seconds_bucket")]
    assert cums == sorted(cums) and cums[-1] == 4
    # every sample line parses as "name{labels} value"
    for ln in lines:
        if not ln.startswith("#"):
            name, val = ln.rsplit(" ", 1)
            float(val)
            assert name


def test_label_escaping():
    reg = MetricsRegistry()
    fam = reg.counter("t_total", labelnames=("path",))
    fam.labels(path='a"b\\c\nd').inc()
    text = reg.render_prometheus()
    assert '\\"' in text and "\\\\" in text and "\\n" in text


def test_snapshot_shapes():
    snap = _mk_registry().snapshot()
    assert snap["t_requests_total"] == 5.0
    assert snap["t_tasks_total{outcome=ok}"] == 2.0
    assert snap["t_latency_seconds"]["count"] == 4
    assert snap["t_depth"] == 3.0


def test_default_registry_module_helpers():
    c = obsm.counter("t_module_helper_total", "x")
    c.inc()
    assert obsm.snapshot()["t_module_helper_total"] >= 1.0
    assert "t_module_helper_total" in obsm.render_prometheus()


# -------------------------------------------------------- HTTP surface --
def _get(url):
    with urllib.request.urlopen(url, timeout=5.0) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_obs_server_endpoints():
    reg = _mk_registry()
    tracer = obst.Tracer(sample_rate=1.0, capacity=64)
    with tracer.start_trace("unit") as root:
        root.child("stage").finish()
    srv = ObsServer(port=0, registry=reg, tracer=tracer,
                    telemetry_fn=lambda: {"queries_per_sec": 12.5})
    try:
        status, ctype, body = _get(srv.url + "/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        assert "version=0.0.4" in ctype
        assert b"t_requests_total 5" in body

        status, ctype, body = _get(srv.url + "/telemetry")
        assert status == 200 and ctype == "application/json"
        doc = json.loads(body)
        assert doc["queries_per_sec"] == 12.5
        assert doc["metrics"]["t_requests_total"] == 5.0

        status, ctype, body = _get(srv.url + "/trace")
        doc = json.loads(body)
        names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
        assert {"unit", "stage"} <= names

        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.url + "/nope")
        assert ei.value.code == 404
    finally:
        srv.close()


def test_obs_server_provider_error_returns_500():
    def boom():
        raise RuntimeError("engine gone")

    srv = ObsServer(port=0, registry=MetricsRegistry(), telemetry_fn=boom)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.url + "/telemetry")
        assert ei.value.code == 500
    finally:
        srv.close()


# ------------------------------------------------------------- tracing --
# ------------------------------------------------------------ sampling --
def test_sample_rate_zero_returns_null_span():
    tr = obst.Tracer(sample_rate=0.0)
    span = tr.start_trace("x")
    assert span is obst.NULL_SPAN
    assert not span  # falsy: call sites can skip optional work
    assert span.child("y") is span  # children are itself
    span.annotate(a=1)
    span.finish()  # no-op, records nothing
    assert tr.spans() == []
    assert tr.dropped == 1


def test_sample_rate_one_records():
    tr = obst.Tracer(sample_rate=1.0)
    with tr.start_trace("root") as root:
        assert root  # truthy
        root.child("stage").finish(ok=True)
    spans = tr.spans()
    assert [s["name"] for s in spans] == ["stage", "root"]
    stage, rootrec = spans
    assert stage["trace_id"] == rootrec["trace_id"]
    assert stage["parent_id"] == rootrec["span_id"]
    assert rootrec["parent_id"] is None
    assert stage["attrs"] == {"ok": True}


def test_sampling_is_seed_deterministic():
    a = obst.Tracer(sample_rate=0.5, seed=42)
    b = obst.Tracer(sample_rate=0.5, seed=42)
    kept_a = [bool(a.start_trace("x")) for _ in range(64)]
    kept_b = [bool(b.start_trace("x")) for _ in range(64)]
    assert kept_a == kept_b
    assert 0 < sum(kept_a) < 64  # genuinely probabilistic, not all/none


def test_bad_sample_rate_raises():
    with pytest.raises(ValueError):
        obst.Tracer(sample_rate=1.5)


def test_ring_is_bounded():
    tr = obst.Tracer(sample_rate=1.0, capacity=8)
    for i in range(50):
        tr.start_trace("t", i=i).finish()
    spans = tr.spans()
    assert len(spans) == 8
    assert [s["attrs"]["i"] for s in spans] == list(range(42, 50))
    tr.clear()
    assert tr.spans() == []


# ------------------------------------------------------ chrome export --
def test_to_chrome_structure(tmp_path):
    tr = obst.Tracer(sample_rate=1.0)
    with tr.start_trace("root"):
        pass
    doc = tr.to_chrome()
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    ms = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert len(xs) == 1 and xs[0]["name"] == "root"
    for field in ("ts", "dur", "pid", "tid", "args"):
        assert field in xs[0]
    assert ms and ms[0]["name"] == "thread_name"
    out = tmp_path / "trace.json"
    assert tr.dump_chrome(str(out)) == 1
    assert out.exists()


def test_set_default_tracer_roundtrip():
    mine = obst.Tracer(sample_rate=1.0)
    prev = obst.set_default_tracer(mine)
    try:
        assert obst.default_tracer() is mine
    finally:
        obst.set_default_tracer(prev)
    assert obst.default_tracer() is prev


# ------------------------------------------------------- port contract --
def test_the_two_registries_are_separate_objects():
    from repro.obs import metrics as jobsm

    assert obsm.default_registry() is not jobsm.default_registry()
    c = obsm.counter("t_port_only_total", "port-side counter")
    c.inc(3)
    assert "t_port_only_total" in obsm.snapshot()
    assert "t_port_only_total" not in jobsm.snapshot()
    # the bucket geometry, and so the error bound, is the reference's
    assert obsm.NBUCKETS == jobsm.NBUCKETS
    assert obsm.RELATIVE_ERROR_BOUND == jobsm.RELATIVE_ERROR_BOUND


def test_port_metric_families_carry_the_reference_names():
    import repro.ann  # noqa: F401 - registers the reference's families
    import repro.serving.scheduler  # noqa: F401
    import repro_torch.ann  # noqa: F401 - registers the port's families
    import repro_torch.serving  # noqa: F401
    from repro.obs import metrics as jobsm

    names = {"taco_mutable_rows_total", "taco_mutable_live_rows", "taco_wal_appends_total",
             "taco_wal_append_bytes_total", "taco_wal_fsyncs_total", "taco_wal_fsync_seconds",
             "taco_wal_flush_seconds", "taco_wal_group_commit_records",
             "taco_compaction_total", "taco_compaction_seconds", "taco_pool_queue_depth",
             "taco_pool_tasks_total", "taco_pool_task_seconds", "taco_pool_task_wait_seconds",
             "taco_searcher_compiles_total", "taco_searcher_fn_cache_hits_total"}
    port_text = obsm.render_prometheus()
    ref_text = jobsm.render_prometheus()
    for name in names:
        assert f"# TYPE {name} " in port_text, name
        assert f"# TYPE {name} " in ref_text, name


def test_port_searcher_counts_compiles_and_hits():
    import numpy as np

    from repro_torch.ann import AnnIndex
    from repro_torch.core.config import taco_config

    data = np.random.default_rng(0).integers(0, 9, (256, 16)).astype(np.float32)
    index = AnnIndex.build(data, taco_config(n_subspaces=2, subspace_dim=4, n_clusters=16,
                                             kmeans_iters=2), device="cpu")
    compiles = obsm.snapshot()["taco_searcher_compiles_total"]
    hits = obsm.snapshot()["taco_searcher_fn_cache_hits_total"]
    index.search(data[:3])
    index.search(data[:3])
    assert obsm.snapshot()["taco_searcher_compiles_total"] == compiles + 1
    assert obsm.snapshot()["taco_searcher_fn_cache_hits_total"] == hits + 1


def test_port_wal_group_commit_spans(tmp_path):
    """Durability path on the port: WAL flushes trace as their own roots
    with an fsync child; mutations trace wal-append under the insert span."""
    import numpy as np

    from repro_torch.ann import MutableAnnIndex
    from repro_torch.core.config import taco_config

    tracer = obst.Tracer(sample_rate=1.0)
    prev = obst.set_default_tracer(tracer)
    try:
        m = MutableAnnIndex(cfg=taco_config(), dim=8, device="cpu",
                            wal_dir=str(tmp_path / "wal"), durability="sync")
        m.insert(np.random.default_rng(2).integers(0, 30, (4, 8)).astype(np.float32))
        m.delete([0, 1])
        m.close()
    finally:
        obst.set_default_tracer(prev)
    spans = tracer.spans()
    names = {s["name"] for s in spans}
    assert {"insert", "delete", "wal-append", "wal-commit", "wal-flush", "fsync"} <= names
    flush_ids = {s["span_id"] for s in spans if s["name"] == "wal-flush"}
    fsyncs = [s for s in spans if s["name"] == "fsync"]
    assert flush_ids and fsyncs and all(s["parent_id"] in flush_ids for s in fsyncs)
