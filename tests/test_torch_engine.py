"""The port's serving engine (``repro_torch.serving.ann_engine``) against
``repro.serving.ann_engine``, on the CPU.

The same integer-valued index runs in both packages (built by ``repro``,
carried across with ``index_from_arrays``), so every f32 sum on the query
path is exact and the port's engine must hand each request the reference
engine's ids and dists bit for bit, for a seeded stream of mixed
k / beta / rerank overrides, synchronously and through the async drain
worker; the counters that do not depend on the clock must be equal
(served, batches, compiles per bucket, cache hits and misses, admission,
deadline misses, generation, swaps, invalidations, probe count and live
recall). Then the reference's engine cases (``tests/test_ann_serving.py``,
``tests/test_async_serving.py``, ``tests/test_obs_trace.py`` and the
mutable engine cases of ``tests/test_mutable_index.py``) run on the port,
and the execution baton is held to its guarantees: a swap waits for the
batch in flight, ``submit()`` and ``telemetry()`` do not.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest

from repro.ann import AnnIndex as JAnnIndex
from repro.ann.searcher import make_searcher as j_make_searcher
from repro.core import taco as jtaco
from repro.core.config import taco_config as j_taco_config
from repro.serving import AdmissionError as JAdmissionError
from repro.serving import AnnRequest as JRequest
from repro.serving import AnnServingEngine as JEngine
from repro_torch.ann import AnnIndex, CompactionPolicy, MutableAnnIndex
from repro_torch.ann.mutable import churn_wave
from repro_torch.ann.searcher import SingleDeviceSearcher
from repro_torch.core import taco
from repro_torch.core.config import taco_config
from repro_torch.obs import trace as obst
from repro_torch.obs.metrics import NBUCKETS
from repro_torch.serving import (
    AdmissionError,
    AnnBackend,
    AnnFuture,
    AnnRequest,
    AnnServingEngine,
    WorkerPool,
    get_shared_pool,
)
from tests.test_torch_mutable import _pair, corpus, exhaustive_cfg, oracle_search  # noqa: F401
from tests.test_torch_query import integer_valued, reference_arrays

TIMEOUT = 120.0
D = 24
CFG = dict(n_subspaces=3, subspace_dim=6, n_clusters=64, alpha=0.05, beta=0.02, k=10)
#: telemetry counters that do not depend on the clock or on thread timing
EXACT = ("requests_served", "batches", "compiles_total", "compiles_per_bucket",
         "truncation_rate", "result_cache_hits", "result_cache_misses",
         "result_cache_entries", "index_generation", "index_swaps",
         "result_cache_invalidations", "queue_depth", "queue_depth_peak", "shed",
         "degraded", "cache_only_served", "deadline_misses", "batches_closed_early",
         "shards", "async")
#: "probe_recall_sum" is :func:`probe_recall_sum`, not a telemetry key
PROBE = ("recall_probe_count", "recall_probe_skipped", "probe_recall_sum")
#: the streams' k are 5 and 10, so each probe's recall is a multiple of 1/10
PROBE_LCM_K = 10
NO_COMPILES = tuple(k for k in EXACT if not k.startswith("compiles"))


@dataclasses.dataclass
class Pair:
    ref: object  # repro SCIndex, integer-valued
    port: object  # repro_torch SCIndex over the same arrays, on the CPU
    jcfg: object
    cfg: object
    queries: np.ndarray
    data: np.ndarray

    def engines(self, **kw):
        """(reference engine, port engine) with the same arguments."""
        return JEngine(self.ref, self.jcfg, **kw), AnnServingEngine(self.port, self.cfg, **kw)


def _carry(data, jcfg):
    ref = integer_valued(jtaco.build(data, jcfg))
    return ref, taco.index_from_arrays(reference_arrays(ref), ref.sub_dims, device="cpu")


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(11)
    data = rng.integers(-10, 11, (2000, D)).astype(np.float32)
    queries = rng.integers(-10, 11, (16, D)).astype(np.float32)
    ref, port = _carry(data, j_taco_config(**CFG))
    return Pair(ref, port, j_taco_config(**CFG), taco_config(**CFG), queries, data)


@pytest.fixture(scope="module")
def shared_ref_searcher(pair):
    """One reference searcher for the tests that compare results only, so
    their engines share its compiled executables."""
    return j_make_searcher(pair.ref, pair.jcfg, "single")


def mixed_stream(queries, n, seed=0):
    """Seeded request fields: every third k=5, every third beta x 2, about
    a third masked-full."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append(dict(query=queries[i % len(queries)],
                        k=5 if i % 3 == 1 else None,
                        beta=CFG["beta"] * 2 if i % 3 == 2 else None,
                        rerank="masked_full" if rng.random() < 0.35 else None))
    return out


def reqs(cls, stream):
    return [cls(**r) for r in stream]


def assert_same(want, got):
    """Per request: ids and dists bitwise, and the flags, equal."""
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.ids, np.asarray(w.ids))
        np.testing.assert_array_equal(np.asarray(g.dists).view(np.uint32),
                                      np.asarray(w.dists, np.float32).view(np.uint32))
        assert (g.truncated, g.cached, g.index_generation) == (
            w.truncated, w.cached, w.index_generation)


def probe_recall_sum(t: dict) -> int:
    """The probes' summed recall in units of 1/PROBE_LCM_K: an integer that
    does not depend on the order the worker pool finished the probes in
    (the float mean does, in its last bit)."""
    mean = t["live_recall_at_k"]
    total = 0.0 if mean is None else mean * t["recall_probe_count"] * PROBE_LCM_K
    assert abs(total - round(total)) < 1e-6, total
    return round(total)


def assert_counters(jeng, eng, keys=EXACT):
    """Each key equal, "probe_recall_sum" in :func:`probe_recall_sum`'s
    integer form."""
    want, got = jeng.telemetry(), eng.telemetry()
    for key in keys:
        if key == "probe_recall_sum":
            assert probe_recall_sum(got) == probe_recall_sum(want), key
        else:
            assert got[key] == want[key], key
    return want, got


# -------------------------------------------------- against the reference --
@pytest.mark.parametrize("max_batch", [4, 16])
def test_sync_engine_bitwise_equals_reference(pair, max_batch):
    jeng, eng = pair.engines(max_batch=max_batch)
    stream = mixed_stream(pair.queries, 24, seed=max_batch)
    assert_same(jeng.search(reqs(JRequest, stream)), eng.search(reqs(AnnRequest, stream)))
    assert_counters(jeng, eng)
    assert eng.telemetry()["backend"] == "SingleDeviceAnnBackend"


def test_telemetry_keys_are_the_references_less_the_jax_counters(pair, shared_ref_searcher):
    jeng = JEngine(pair.ref, pair.jcfg, backend=shared_ref_searcher, recall_probe_every=2)
    eng = AnnServingEngine(pair.port, pair.cfg, recall_probe_every=2)
    stream = mixed_stream(pair.queries, 4)
    jeng.search(reqs(JRequest, stream))
    eng.search(reqs(AnnRequest, stream))
    want = set(jeng.telemetry()) - {"jax_dispatch_under_lock", "jax_seconds_under_lock"}
    got = eng.telemetry()
    assert set(got) == want
    assert not any(key.startswith("jax_") for key in got)


def test_async_engine_bitwise_equals_reference_and_sync(pair, shared_ref_searcher):
    stream = mixed_stream(pair.queries, 32, seed=3)
    jeng = JEngine(pair.ref, pair.jcfg, backend=shared_ref_searcher, max_batch=8)
    want = jeng.search(reqs(JRequest, stream))
    sync = AnnServingEngine(pair.port, pair.cfg, max_batch=8).search(reqs(AnnRequest, stream))
    with AnnServingEngine(pair.port, pair.cfg, max_batch=8, async_mode=True) as eng:
        assert eng.running
        futures = [eng.submit(r) for r in reqs(AnnRequest, stream)]
        got = [f.result(timeout=TIMEOUT) for f in futures]
    assert not eng.running
    assert_same(want, got)
    assert_same(sync, got)
    t = eng.telemetry()
    assert t["requests_served"] == len(stream) and t["queue_depth"] == 0


def test_result_cache_counters_equal_the_reference(pair):
    jeng, eng = pair.engines(max_batch=8, result_cache_size=64)
    stream = mixed_stream(pair.queries, 20, seed=5)
    for _round in range(2):
        assert_same(jeng.search(reqs(JRequest, stream)), eng.search(reqs(AnnRequest, stream)))
    want, got = assert_counters(jeng, eng)
    # no (query, k, cfg) repeats within a round: the second round all hits
    assert got["result_cache_hits"] == want["result_cache_hits"] == len(stream)
    assert got["requests_served"] == got["result_cache_hits"] + got["result_cache_misses"]


@pytest.mark.parametrize("policy", ["reject", "cache_only", "degrade"])
def test_admission_policies_equal_the_reference(pair, policy):
    jeng, eng = pair.engines(max_batch=8, result_cache_size=16, max_queue_depth=2,
                             admission_policy=policy)
    q = pair.queries
    outcomes = []
    for e, Req, Err in ((jeng, JRequest, JAdmissionError), (eng, AnnRequest, AdmissionError)):
        e.search([Req(query=q[0])])  # primes the cache
        seen = []
        for i in (1, 2, 0, 3, 4):  # two fill the queue, then the watermark applies
            try:
                fut = e.submit(Req(query=q[i]))
                seen.append(("ok", fut.done()))
            except Err:
                seen.append(("shed", None))
        out = e.drain(timeout=TIMEOUT)
        outcomes.append((seen, [out[rid] for rid in sorted(out)]))
    (jseen, jres), (seen, res) = outcomes
    assert seen == jseen
    assert_same(jres, res)
    want, got = assert_counters(jeng, eng)
    assert got[{"reject": "shed", "cache_only": "cache_only_served",
                "degrade": "degraded"}[policy]] > 0


def test_deadline_miss_and_priority_equal_the_reference(pair, shared_ref_searcher):
    jeng = JEngine(pair.ref, pair.jcfg, backend=shared_ref_searcher, max_batch=8)
    eng = AnnServingEngine(pair.port, pair.cfg, max_batch=8)
    q = pair.queries
    for e, Req in ((jeng, JRequest), (eng, AnnRequest)):
        e.submit(Req(query=q[0], deadline_s=1e-4))  # expires before the drain
        e.submit(Req(query=q[1]))
        e.submit(Req(query=q[2], beta=CFG["beta"] * 2, priority=5))
        with e._lock:
            _k, picked = e._pick_group_locked()
        assert picked.beta == pytest.approx(CFG["beta"] * 2)
        time.sleep(0.01)
        e.drain(timeout=TIMEOUT)
    # the reference engine shares a searcher with other tests: its compile
    # counts are not this engine's alone
    want, got = assert_counters(jeng, eng, NO_COMPILES)
    assert got["deadline_misses"] == 1 and got["batches"] == 2


def test_swap_and_mutation_notice_equal_the_reference(pair):
    jeng, eng = pair.engines(max_batch=8, result_cache_size=16)
    q = pair.queries
    new_ref, new_port = _carry(pair.data[32:], pair.jcfg)
    results = []
    for e, Req, new in ((jeng, JRequest, JAnnIndex(sc_index=new_ref, cfg=pair.jcfg)),
                        (eng, AnnRequest, AnnIndex(sc_index=new_port, cfg=pair.cfg))):
        r = e.search([Req(query=x) for x in q[:4]])
        r += e.search([Req(query=x) for x in q[:4]])  # cache hits
        assert e.swap_index(new) == 1
        r += e.search([Req(query=x) for x in q[:4]])  # new index, no stale hit
        rid = e.submit(Req(query=q[5]))
        assert e.notify_index_mutated() == 2
        r.append(e.drain(timeout=TIMEOUT)[rid])
        r += e.search([Req(query=x) for x in q[:2]])
        results.append(r)
    assert_same(*results)
    assert all(x.cached for x in results[1][4:8])
    assert not any(x.cached for x in results[1][8:12])
    assert_counters(jeng, eng)
    with pytest.raises(TypeError):
        eng.swap_index(42)


def test_recall_probes_equal_the_reference(pair):
    jeng, eng = pair.engines(max_batch=8, recall_probe_every=3, result_cache_size=32)
    stream = mixed_stream(pair.queries, 24, seed=7)
    assert_same(jeng.search(reqs(JRequest, stream)), eng.search(reqs(AnnRequest, stream)))
    want, got = assert_counters(jeng, eng, EXACT + PROBE)
    assert got["recall_probe_count"] == 8 and 0.0 < got["live_recall_at_k"] <= 1.0
    # cache hits never reach the backend, so they are never probed
    eng.search(reqs(AnnRequest, stream))
    assert eng.telemetry()["recall_probe_count"] == 8
    me = threading.current_thread().name
    assert eng.probe_thread_names and all(n != me and "worker" in n
                                          for n in eng.probe_thread_names)
    eng.reset_telemetry()
    assert eng.telemetry()["recall_probe_count"] == 0


def test_probe_topk_equals_the_references_host_probe(pair):
    """The device-side probe (``Searcher.probe_topk``) orders by (distance,
    id) as the reference's numpy ``lexsort`` over ``probe_corpus()`` does,
    including the ties of an integer corpus; so does an explicit
    ``recall_probe_corpus`` callable, scored on the host."""
    searcher = SingleDeviceSearcher(pair.port)
    corpus, ids = searcher.probe_corpus()
    for q in pair.queries[:6]:
        diff = corpus - q[None, :]
        dist = np.einsum("md,md->m", diff, diff)
        for k in (1, 10, 50):
            want = ids[np.lexsort((ids, dist))[:k]]
            np.testing.assert_array_equal(searcher.probe_topk(q, k), want)
    eng = AnnServingEngine(pair.port, pair.cfg, recall_probe_corpus=searcher.probe_corpus)
    np.testing.assert_array_equal(eng._probe_exact(pair.queries[0], 10),
                                  searcher.probe_topk(pair.queries[0], 10))


def test_mutable_engine_bitwise_equals_reference_under_churn():
    """A churned mutable index served through both packages' engines:
    per request bitwise and exact counters while the churn runs; then a
    compaction swapped into each engine (each package's own build, so from
    there each is held to its own rebuild oracle) moves the counters alike."""
    jm, m, rng, data = _pair(1500, 21)
    queries = rng.integers(-10, 11, (12, 24)).astype(np.float32)
    jeng = jm.engine(max_batch=8, result_cache_size=32, recall_probe_every=2)
    eng = m.engine(max_batch=8, result_cache_size=32, recall_probe_every=2)
    stream = mixed_stream(queries, 16, seed=9)
    fresh = rng.integers(-10, 11, (40, 24)).astype(np.float32)
    results = []
    for mm, e, Req in ((jm, jeng, JRequest), (m, eng, AnnRequest)):
        r = e.search(reqs(Req, stream))
        # telemetry() joins the recall probes in flight, so each lands on the
        # generation it was taken at (and is counted, not skipped) whatever
        # the worker pool's timing; the mutations below move the generation
        e.telemetry()
        new = mm.insert(fresh)
        mm.delete([3, 5, 8, int(new[0]), int(new[7])])
        r += e.search(reqs(Req, stream))
        e.telemetry()
        results.append(r)
    assert_same(*results)
    # the compile keys differ by design: a masked-full batch asks the port's
    # base for k (the tombstones are the kernel's exclusion bitmap), the
    # reference's for k + next_pow2(#tombstones)
    keys = NO_COMPILES
    assert_counters(jeng, eng, keys + PROBE)
    for mm, e, Req in ((jm, jeng, JRequest), (m, eng, AnnRequest)):
        mm.compact(engine=e)
        e.search(reqs(Req, stream))
        e.telemetry()
    keys = tuple(k for k in keys if k != "truncation_rate") + ("recall_probe_count",)
    want, got = assert_counters(jeng, eng, keys)
    assert got["index_swaps"] == 1 and got["result_cache_invalidations"] >= 3
    assert got["mutable"]["compactions"] == want["mutable"]["compactions"] == 1
    res = eng.search([AnnRequest(query=q) for q in queries])
    want_i, want_d = oracle_search(m, queries)
    np.testing.assert_array_equal(np.stack([r.ids for r in res]), want_i)
    np.testing.assert_array_equal(np.stack([r.dists for r in res]), want_d)


# ------------------------------------------------ the reference's engine cases --
def test_engine_matches_direct_query_and_padding(pair):
    port = AnnIndex(sc_index=pair.port, cfg=pair.cfg)
    eng = port.engine(max_batch=16)
    got = eng.search([AnnRequest(query=q) for q in pair.queries[:5]])
    assert eng.telemetry()["compiles_per_bucket"] == {8: 1}  # padded shape
    want_i, want_d = port.search(pair.queries[:5])
    np.testing.assert_array_equal(np.stack([r.ids for r in got]), want_i)
    np.testing.assert_array_equal(np.stack([r.dists for r in got]), want_d)
    # the engine's searcher and the facade's share nothing but the index
    assert eng.searcher is not port._default_searcher()
    # the sharded placement serves the same requests (masked-full never
    # truncates, so bit for bit)
    batch = [AnnRequest(query=q, rerank="masked_full") for q in pair.queries[:5]]
    sharded = port.engine("sharded", shards=4, max_batch=16)
    assert sharded.telemetry()["shards"] == 4
    assert_same(eng.search(batch), sharded.search(batch))


def test_function_cache_reuse_bound_and_validation(pair):
    eng = AnnServingEngine(pair.port, pair.cfg, max_batch=8)
    for _ in range(3):
        eng.search([AnnRequest(query=q) for q in pair.queries[:8]])
    t = eng.telemetry()
    assert t["compiles_total"] == 1 and t["batches"] == 3
    eng.search([AnnRequest(query=q) for q in pair.queries[:2]])
    assert eng.telemetry()["compiles_per_bucket"] == {8: 1, 2: 1}
    small = AnnServingEngine(pair.port, pair.cfg, max_batch=1, max_cached_fns=2)
    for i in range(4):  # 4 distinct beta groups -> 4 compiles, 2 retained
        small.search([AnnRequest(query=pair.queries[0], beta=0.01 + 0.001 * i)])
    assert small.telemetry()["compiles_total"] == 4 and len(small._fns) == 2
    good = eng.submit(AnnRequest(query=pair.queries[0]))
    for bad in (dict(query=pair.queries[0][:-1]), dict(query=pair.queries[0], k=0),
                dict(query=pair.queries[0], k=pair.port.n + 1),
                dict(query=pair.queries[0], beta=0.0),
                dict(query=pair.queries[0], rerank="bogus"),
                dict(query=pair.queries[0], deadline_s=0.0)):
        with pytest.raises(ValueError):
            eng.submit(AnnRequest(**bad))
    assert set(eng.drain(timeout=TIMEOUT)) == {good}


def test_engine_rejects_what_is_not_ported_and_stray_arguments(pair, tmp_path):
    with pytest.raises(ValueError):
        AnnServingEngine(pair.port, pair.cfg, shards=4)
    with pytest.raises(ValueError):
        AnnServingEngine(pair.port, pair.cfg, backend="bogus")
    with pytest.raises(ValueError, match="prebuilt Searcher"):
        AnnServingEngine(pair.port, pair.cfg, backend=SingleDeviceSearcher(pair.port),
                         max_cached_fns=4)
    sharded = AnnServingEngine(pair.port, pair.cfg, backend="sharded", shards=2)
    batch = [AnnRequest(query=q, rerank="masked_full") for q in pair.queries[:4]]
    assert_same(AnnServingEngine(pair.port, pair.cfg).search(batch), sharded.search(batch))
    with pytest.raises(ValueError, match="divisible"):
        AnnServingEngine(pair.port, pair.cfg, backend="sharded", shards=3)
    # an autotune cache warm-loads at construction (a missing file raises)
    from repro_torch.kernels import autotune

    winners = tmp_path / "winners.json"
    autotune.clear_cache()
    autotune.set_blocks("masked_rerank", (16, 8192), q=4, n=pair.port.n, backend="cpu")
    autotune.save_cache(str(winners))
    autotune.clear_cache()
    try:
        tuned = AnnServingEngine(pair.port, pair.cfg, autotune_cache=str(winners))
        assert tuned.autotune_entries_loaded == 1
        assert tuned.telemetry()["autotune_entries_loaded"] == 1
        searcher = AnnIndex(sc_index=pair.port, cfg=pair.cfg).searcher(
            autotune_cache=str(winners))
        assert searcher.autotune_entries_loaded == 1
        assert autotune.get_blocks("masked_rerank", q=4, n=pair.port.n,
                                   backend="cpu") == (16, 8192)
        assert_same(AnnServingEngine(pair.port, pair.cfg).search(batch), tuned.search(batch))
        with pytest.raises(FileNotFoundError):
            AnnServingEngine(pair.port, pair.cfg, autotune_cache=str(tmp_path / "none.json"))
    finally:
        autotune.clear_cache()
    with pytest.raises(ValueError):
        AnnServingEngine(pair.port, pair.cfg, admission_policy="bogus")
    with pytest.raises(ValueError):
        AnnServingEngine(pair.port, pair.cfg, degrade_beta_scale=0.0)
    assert AnnServingEngine(pair.port, pair.cfg).autotune_entries_loaded == 0


def test_future_int_compat_callbacks_and_timeout(pair):
    eng = AnnServingEngine(pair.port, pair.cfg, max_batch=4)
    fut = eng.submit(AnnRequest(query=pair.queries[0]))
    assert isinstance(fut, AnnFuture) and not fut.done()
    with pytest.raises(TimeoutError):
        fut.result(timeout=0.01)  # nothing drains: still pending
    seen = []
    fut.add_done_callback(lambda f: seen.append(f.request_id))
    out = eng.drain(timeout=TIMEOUT)
    assert set(out) == {fut} and out[fut.request_id].ids.shape == (CFG["k"],)
    assert fut.done() and seen == [fut.request_id] and int(fut) == fut.request_id
    late = []
    fut.add_done_callback(lambda f: late.append(True))
    assert late == [True]


def test_search_preserves_other_callers_queued_requests(pair):
    eng = AnnServingEngine(pair.port, pair.cfg, max_batch=8)
    early = eng.submit(AnnRequest(query=pair.queries[0]))
    assert len(eng.search([AnnRequest(query=q) for q in pair.queries[1:3]])) == 2
    assert early.done()
    out = eng.drain(timeout=TIMEOUT)
    assert set(out) == {early}
    want, _ = AnnIndex(sc_index=pair.port, cfg=pair.cfg).search(pair.queries[:1])
    np.testing.assert_array_equal(out[early.request_id].ids, want[0])


def test_async_search_adapter_and_close_drains(pair):
    eng = AnnServingEngine(pair.port, pair.cfg, max_batch=4, async_mode=True)
    try:
        res = eng.search([AnnRequest(query=q) for q in pair.queries[:4]], timeout=TIMEOUT)
        assert len(res) == 4
        tail = eng.submit(AnnRequest(query=pair.queries[5]))
    finally:
        eng.close()
    assert tail.done()


def test_multi_producer_stress_no_lost_or_duplicated_requests(pair):
    want = AnnServingEngine(pair.port, pair.cfg, max_batch=16).search(
        [AnnRequest(query=q) for q in pair.queries])
    n_threads, per_thread = 6, 12
    results = {i: [] for i in range(n_threads)}
    errors = []
    with AnnServingEngine(pair.port, pair.cfg, max_batch=16, async_mode=True) as eng:
        def producer(tid):
            try:
                futs = [((tid * per_thread + j) % 16,
                         eng.submit(AnnRequest(query=pair.queries[(tid * per_thread + j) % 16])))
                        for j in range(per_thread)]
                results[tid] = [(qi, f.result(timeout=TIMEOUT)) for qi, f in futs]
            except BaseException as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=producer, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not errors and all(not t.is_alive() for t in threads)
        t = eng.telemetry()
    assert t["requests_served"] == n_threads * per_thread and t["queue_depth"] == 0
    for tid in range(n_threads):
        assert len(results[tid]) == per_thread
        assert_same([want[qi] for qi, _r in results[tid]], [r for _qi, r in results[tid]])


def test_concurrent_submit_cache_counters_exact(pair):
    eng = AnnServingEngine(pair.port, pair.cfg, max_batch=64, result_cache_size=64)

    def run_round():
        threads = [threading.Thread(target=lambda: [eng.submit(AnnRequest(query=q))
                                                    for q in pair.queries[:8]])
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert all(not t.is_alive() for t in threads)
        return eng.drain(timeout=TIMEOUT)

    assert len(run_round()) == 32
    assert (eng.telemetry()["result_cache_hits"], eng.telemetry()["result_cache_misses"]) == (0, 32)
    assert len(run_round()) == 32
    t = eng.telemetry()
    assert (t["result_cache_hits"], t["result_cache_misses"], t["requests_served"]) == (32, 32, 64)


def test_near_deadline_closes_batch_early(pair):
    eng = AnnServingEngine(pair.port, pair.cfg, max_batch=64, async_mode=True,
                           linger_s=30.0, deadline_margin_s=0.005)
    try:
        eng.search([AnnRequest(query=pair.queries[0], deadline_s=0.25)], timeout=TIMEOUT)
        eng.reset_telemetry()
        t0 = time.monotonic()
        eng.submit(AnnRequest(query=pair.queries[1], deadline_s=0.25)).result(timeout=TIMEOUT)
        elapsed = time.monotonic() - t0
    finally:
        eng.close()
    assert elapsed < 5.0, f"batch waited the linger, not the SLO ({elapsed=})"
    t = eng.telemetry()
    assert t["batches_closed_early"] == 1 and t["requests_served"] == 1


# ------------------------------------------------------------ the pool --
def test_worker_pool_tasks_exceptions_and_shared_pool():
    pool = WorkerPool(workers=2, name="t-pool")
    me = threading.current_thread().name
    tasks = [pool.submit(lambda i=i: i * i, label=f"sq{i}") for i in range(8)]
    assert [t.result(timeout=10.0) for t in tasks] == [i * i for i in range(8)]
    assert all(t.thread_name != me and t.thread_name.startswith("t-pool-worker") for t in tasks)

    def boom():
        raise RuntimeError("kapow")

    with pytest.raises(RuntimeError, match="kapow"):
        pool.submit(boom).result(timeout=10.0)
    assert pool.submit(lambda: 42).result(timeout=10.0) == 42
    assert pool.join(timeout=10.0) and pool.stats()["failed"] == 1
    pool.shutdown(wait=True, timeout=10.0)
    with pytest.raises(RuntimeError):
        pool.submit(lambda: None)
    a = get_shared_pool()
    assert get_shared_pool() is a and a.alive


def test_churn_compaction_and_probes_on_pool_across_live_swap():
    """Concurrent producers drive an async mutable engine while churn waves
    mutate and background-compact (a live swap_index()); every future
    resolves, and compaction and probes ran on the shared WorkerPool."""
    rng = np.random.default_rng(0)
    data = rng.integers(-8, 8, size=(512, 32)).astype(np.float32)
    cfg = taco_config(n_subspaces=3, subspace_dim=8, n_clusters=64, kmeans_iters=4,
                      alpha=0.1, beta=1.0, selection="fixed", k=10)
    mutable = MutableAnnIndex.build(data, cfg, policy=CompactionPolicy(max_delta_rows=24),
                                    device="cpu")
    queries = rng.standard_normal((8, 32)).astype(np.float32) * 4
    engine = mutable.engine(max_batch=8, async_mode=True, recall_probe_every=2)
    caller_threads = {threading.current_thread().name}
    resolved, errors, handles = [], [], []
    try:
        engine.search([AnnRequest(query=q) for q in queries], timeout=TIMEOUT)

        def producer():
            caller_threads.add(threading.current_thread().name)
            try:
                futs = [engine.submit(AnnRequest(query=q)) for q in queries]
                resolved.extend(f.result(timeout=TIMEOUT) for f in futs)
            except BaseException as e:
                errors.append(e)

        threads = [threading.Thread(target=producer) for _ in range(3)]
        for t in threads:
            t.start()
        live_ids: list = []
        for _ in range(4):
            h = churn_wave(mutable, rng, live_ids, 16, engine=engine, background=True)
            if h is not None:
                handles.append(h)
                h.result(timeout=TIMEOUT)
        for t in threads:
            t.join(TIMEOUT)
        assert not errors and all(not t.is_alive() for t in threads)
    finally:
        engine.close()
    assert len(resolved) == 3 * len(queries) and all(np.all(r.ids >= 0) for r in resolved)
    assert handles
    t = engine.telemetry()
    assert t["index_swaps"] >= 1 and t["index_generation"] > 0
    for h in handles:
        assert h.report is not None and h.error is None
        assert h.thread_name not in caller_threads and "worker" in h.thread_name
    assert engine.probe_thread_names and not (engine.probe_thread_names & caller_threads)


# ------------------------------------------------------------ tracing --
def test_async_request_spans_form_one_rooted_tree(pair):
    tracer = obst.Tracer(sample_rate=1.0, capacity=4096)
    eng = AnnServingEngine(pair.port, pair.cfg, async_mode=True, tracer=tracer,
                           recall_probe_every=2, max_batch=8)
    try:
        futures = [eng.submit(AnnRequest(query=pair.queries[i % 16] + i // 16))
                   for i in range(24)]
        for f in futures:
            f.result(timeout=TIMEOUT)
        eng.telemetry()  # joins the probes
    finally:
        eng.close()
    assert get_shared_pool().join(timeout=30.0)
    spans = tracer.spans()
    assert {"ann-request", "queue-wait", "batch-form", "kernel", "recall-probe"} <= {
        s["name"] for s in spans}
    roots = [s for s in spans if s["parent_id"] is None and s["name"] == "ann-request"]
    assert len(roots) == 24
    by_trace: dict = {}
    for s in spans:
        by_trace.setdefault(s["trace_id"], []).append(s)
    for group in by_trace.values():
        ids = {s["span_id"] for s in group}
        assert sum(s["parent_id"] is None for s in group) == 1
        assert all(s["parent_id"] in ids for s in group if s["parent_id"] is not None)
    assert len({s["tid"] for s in spans}) >= 2


def test_latency_accounting_is_flat_memory_and_cache_hits_report_zero(pair):
    eng = AnnServingEngine(pair.port, pair.cfg, result_cache_size=8, max_batch=8)
    r = [AnnRequest(query=pair.queries[0])] * 100
    eng.search(r[:1])
    eng.reset_telemetry()
    for _ in range(100):  # 10,000 requests, all cache hits
        eng.search(r)
    assert len(eng._lat_hist._shards) <= 4
    assert all(len(sh.counts) == NBUCKETS for sh in eng._lat_hist._shards)
    t = eng.telemetry()
    assert t["requests_served"] == 10_000 and t["latency_p50_s"] == 0.0


# ------------------------------------------------ the mutable index's engine --
def test_mutable_engine_parity_across_atomic_swap(corpus):
    data, extra, queries = corpus
    m = MutableAnnIndex.build(data, exhaustive_cfg(), device="cpu")
    engine = m.engine(max_batch=8, result_cache_size=32)

    def engine_ids(rerank=None):
        res = engine.search([AnnRequest(query=q, rerank=rerank) for q in queries])
        return np.stack([r.ids for r in res]), np.stack([r.dists for r in res]), res

    ids = m.insert(extra)
    m.delete(list(range(6)) + [int(ids[0])])
    for rerank in (None, "masked_full"):
        got_i, got_d, _res = engine_ids(rerank)
        want_i, want_d = oracle_search(m, queries, rerank=rerank)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_d, want_d)
    gen_before = engine.index_generation
    assert all(r.cached for r in engine_ids()[2])
    report = m.compact(engine=engine)
    assert engine.telemetry()["index_swaps"] == 1 and engine.index_generation > gen_before
    for rerank in (None, "masked_full"):
        got_i, got_d, res = engine_ids(rerank)
        assert not any(r.cached for r in res)
        assert all(r.index_generation == engine.index_generation for r in res)
        want_i, want_d = oracle_search(m, queries, rerank=rerank)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_d, want_d)
    assert report.generation == m.generation
    handle = m.compact_async(engine=engine)  # the background form swaps too
    handle.result(timeout=TIMEOUT)
    assert engine.telemetry()["index_swaps"] == 2


def test_mutable_engine_mutation_invalidates_cache_and_serves_fresh(corpus):
    data, _extra, queries = corpus
    m = MutableAnnIndex.build(data, exhaustive_cfg(), device="cpu")
    engine = m.engine(max_batch=8, result_cache_size=32)
    engine.search([AnnRequest(query=queries[0])])
    assert engine.search([AnnRequest(query=queries[0])])[0].cached
    gen = engine.index_generation
    (new_id,) = m.insert(queries[0])  # an exact duplicate of the query
    r = engine.search([AnnRequest(query=queries[0])])[0]
    assert not r.cached and r.index_generation > gen
    assert r.ids[0] == new_id and r.dists[0] == 0.0
    t = engine.telemetry()
    assert t["result_cache_invalidations"] >= 1 and t["mutable"]["n_delta_live"] == 1


def test_mutable_engine_probes_follow_the_live_corpus_and_the_swap(corpus):
    data, extra, queries = corpus
    m = MutableAnnIndex.build(data, exhaustive_cfg(), device="cpu")
    m.insert(extra[:8])
    m.delete([1, 2])
    engine = m.engine(max_batch=8, recall_probe_every=1)
    engine.search([AnnRequest(query=q) for q in queries])
    t = engine.telemetry()
    # exhaustive selection + exact delta scan: live recall is exactly 1
    assert t["recall_probe_count"] == len(queries) and t["live_recall_at_k"] == 1.0
    # the device probe over base - tombstones + delta equals the host one
    corpus_v, ids = m.searcher().probe_corpus()
    for q in queries:
        diff = corpus_v - q[None, :]
        dist = np.einsum("md,md->m", diff, diff)
        np.testing.assert_array_equal(m.searcher().probe_topk(q, 10),
                                      ids[np.lexsort((ids, dist))[:10]])
    engine.swap_index(AnnIndex.build(extra, exhaustive_cfg(), device="cpu"))
    engine.reset_telemetry()
    engine.search([AnnRequest(query=q) for q in queries])
    t = engine.telemetry()
    assert t["recall_probe_count"] == len(queries) and t["live_recall_at_k"] == 1.0
    with pytest.raises(ValueError, match="single"):
        m.searcher("sharded")


# ------------------------------------------------------ the execution baton --
class _BlockingBackend(AnnBackend):
    """A backend whose batches wait for ``release`` after setting ``started``."""

    def __init__(self, searcher):
        super().__init__(searcher.index, searcher=searcher)
        self.started, self.release = threading.Event(), threading.Event()
        self.calls = 0

    def run(self, bucket, k, cfg, queries):
        self.calls += 1
        self.started.set()
        assert self.release.wait(TIMEOUT)
        return super().run(bucket, k, cfg, queries)


def test_baton_swap_waits_for_the_batch_and_nothing_else_does(pair):
    old = _BlockingBackend(SingleDeviceSearcher(pair.port))
    new = _BlockingBackend(SingleDeviceSearcher(pair.port))
    new.release.set()
    eng = AnnServingEngine(pair.port, pair.cfg, backend=old, max_batch=4, async_mode=True)
    try:
        first = eng.submit(AnnRequest(query=pair.queries[0]))
        assert old.started.wait(TIMEOUT)  # the batch is on the card
        t0 = time.monotonic()
        second = eng.submit(AnnRequest(query=pair.queries[1]))
        tel = eng.telemetry()
        assert eng.notify_index_mutated() == 1
        assert time.monotonic() - t0 < 5.0 and tel["batches"] == 0
        swapped, calls_at_swap = threading.Event(), []

        def swap():
            assert eng.swap_index(new) == 2
            calls_at_swap.append(old.calls)
            swapped.set()

        th = threading.Thread(target=swap)
        th.start()
        assert not swapped.wait(0.3), "swap_index landed mid-batch"
        assert eng.telemetry()["index_swaps"] == 0
        old.release.set()
        assert swapped.wait(TIMEOUT)
        th.join(TIMEOUT)
        assert not th.is_alive()
        r1 = first.result(timeout=TIMEOUT)
        assert r1.index_generation == 0  # claimed before the notice
        r2 = second.result(timeout=TIMEOUT)
        r3 = eng.submit(AnnRequest(query=pair.queries[2])).result(timeout=TIMEOUT)
    finally:
        old.release.set()
        eng.close()
    assert r3.index_generation == 2 and new.calls >= 1
    assert old.calls == calls_at_swap[0], "a batch ran on the replaced index"
    assert r2.index_generation in (1, 2)
    want, _ = AnnIndex(sc_index=pair.port, cfg=pair.cfg).search(pair.queries[:3])
    for r, w in zip((r1, r2, r3), want):
        np.testing.assert_array_equal(r.ids, w)


def test_baton_serializes_batches_from_many_threads(pair):
    """Sync callers on several threads: no two batches overlap in the
    backend (the searcher's function cache is not thread-safe)."""
    inside, overlaps = [0], []
    lock = threading.Lock()

    class Counting(AnnBackend):
        def run(self, bucket, k, cfg, queries):
            with lock:
                inside[0] += 1
                overlaps.append(inside[0])
            time.sleep(0.002)
            out = super().run(bucket, k, cfg, queries)
            with lock:
                inside[0] -= 1
            return out

    s = SingleDeviceSearcher(pair.port)
    eng = AnnServingEngine(pair.port, pair.cfg, backend=Counting(pair.port, searcher=s),
                           max_batch=2)
    errors = []

    def caller(i):
        try:
            for j in range(6):
                eng.search([AnnRequest(query=pair.queries[(i + j) % 16])], timeout=TIMEOUT)
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert not errors and all(not t.is_alive() for t in threads)
    assert overlaps and max(overlaps) == 1
    assert eng.telemetry()["requests_served"] == 36
