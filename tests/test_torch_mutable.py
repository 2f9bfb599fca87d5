"""The port's mutable index (``repro_torch.ann.mutable``, compaction and
mutable persistence) against ``repro.ann``, on the CPU.

Two protocols, as in ``tests/test_mutable_index.py``:

  * cross-package: the same integer-valued index carried into the port
    (``index_from_arrays``) and one seeded numpy mutation schedule through
    both packages must give bitwise-equal ids and dists for both re-rank
    pipelines — including a state with more than 512 tombstones, where the
    reference over-fetches past k = 1024 and the port's masked-full path
    passes the tombstones to the masked re-rank as an exclusion bitmap;
  * rebuild oracle: with exhaustive selection (``selection="fixed",
    beta=1.0``) an uncompacted mutable search must equal
    ``AnnIndex.build(live_corpus)`` bit for bit, and after ``compact()`` it
    must for any config.

Mutable saves cross the packages both ways; the locks of the port's
mutable index, WAL and worker pool join the session's lock-order checker.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.ann import AnnIndex as JAnnIndex
from repro.ann import MutableAnnIndex as JMutable
from repro.core import taco as jtaco
from repro.core.config import taco_config as j_taco_config
from repro_torch.ann import AnnIndex, CompactionPolicy, MutableAnnIndex
from repro_torch.ann import compaction
from repro_torch.ann.mutable import _pow2ceil, base_fetch_k
from repro_torch.core import taco
from repro_torch.core.config import taco_config
from repro_torch.kernels import ops
from tests.test_torch_query import integer_valued, reference_arrays

D = 32
K = 10
CPU = "cpu"


def int_vectors(n, seed, d=D):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 30, (n, d)).astype(np.float32)


def exhaustive_cfg(**kw):
    """Every point is a candidate: fixed selection with a beta*n == n
    budget re-ranks the whole corpus exactly, for both pipelines."""
    base = dict(n_subspaces=3, subspace_dim=8, n_clusters=64, kmeans_iters=4,
                alpha=0.1, beta=1.0, selection="fixed", k=K)
    return taco_config(**{**base, **kw})


def oracle_search(mutable, queries, *, k=None, rerank=None):
    """From-scratch rebuild over the live corpus; row ids translated to the
    mutable index's stable external ids."""
    oracle, id_map = mutable.rebuild_oracle()
    if rerank is not None:
        oracle = oracle.replace_cfg(rerank=rerank)
    ids, dists = oracle.search(queries, k=k)
    return np.where(ids >= 0, id_map[np.maximum(ids, 0)], -1), dists


def assert_parity(mutable, queries, *, k=None, rerank=None):
    got_i, got_d = mutable.search(queries, k=k, rerank=rerank)
    want_i, want_d = oracle_search(mutable, queries, k=k, rerank=rerank)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)  # bitwise
    return got_i


@pytest.fixture(scope="module")
def corpus():
    return int_vectors(512, 0), int_vectors(48, 1), int_vectors(8, 2)


@pytest.fixture()
def churned(corpus):
    """A mutable index with inserts + deletes in flight (uncompacted)."""
    data, extra, _q = corpus
    m = MutableAnnIndex.build(data, exhaustive_cfg(), device=CPU)
    new_ids = m.insert(extra)
    m.delete(list(range(0, 12)) + [int(new_ids[3])])
    return m, new_ids


# -------------------------------------------------------- rebuild oracle --
@pytest.mark.parametrize("rerank", ["gather", "masked_full"])
def test_churned_search_bitwise_equals_rebuild_oracle(churned, corpus, rerank):
    m, new_ids = churned
    ids = assert_parity(m, corpus[2], rerank=rerank)
    dead = set(range(0, 12)) | {int(new_ids[3])}
    assert not (dead & set(ids.ravel().tolist()))


def test_empty_delta_query_equals_base(corpus):
    data, _extra, queries = corpus
    cfg = exhaustive_cfg()
    m = MutableAnnIndex.build(data, cfg, device=CPU)
    want_i, want_d = AnnIndex.build(data, cfg, device=CPU).search(queries)
    got_i, got_d, stats = m.search_with_stats(queries)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)
    assert stats["truncated"].shape == (queries.shape[0],)


def test_delete_then_reinsert_same_vector(corpus):
    data, _extra, queries = corpus
    m = MutableAnnIndex.build(data, exhaustive_cfg(), device=CPU)
    v = data[7].copy()
    m.delete([7])
    (rid,) = m.insert(torch.from_numpy(v))  # a tensor is accepted too
    ids, dists = m.search(v[None], k=3)
    assert ids[0, 0] == rid and dists[0, 0] == 0.0 and 7 not in ids[0]
    assert_parity(m, queries)


def test_compaction_installs_rebuild_for_realistic_config(corpus):
    data, extra, queries = corpus
    cfg = taco_config(n_subspaces=3, subspace_dim=8, n_clusters=64,
                      kmeans_iters=4, alpha=0.1, beta=0.05, k=K)
    m = MutableAnnIndex.build(data, cfg, device=CPU)
    ids = m.insert(extra)
    m.delete(list(range(20)) + [int(i) for i in ids[:5]])
    report = m.compact()
    assert not report.delta_only and report.reclaimed == 25 and not m.dirty
    assert_parity(m, queries)
    assert_parity(m, queries, rerank="masked_full")


def test_compact_to_empty_and_grow_back(corpus):
    data, _extra, queries = corpus
    m = MutableAnnIndex.build(data[:64], exhaustive_cfg(n_clusters=16), device=CPU)
    m.delete(list(range(64)))
    ids, dists = m.search(queries, k=4)
    assert (ids == -1).all() and np.isinf(dists).all()
    report = m.compact()
    assert report.delta_only and m.n_live == 0 and m.stats()["n_base"] == 0
    new = m.insert(data[:5])
    ids, dists = m.search(data[:1], k=2)
    assert ids[0, 0] == new[0] and dists[0, 0] == 0.0
    assert_parity(m, queries, k=4)


@pytest.mark.parametrize("rerank", ["gather", "masked_full"])
def test_k_larger_than_live_pads_with_minus_one(corpus, rerank):
    data, _extra, _q = corpus
    m = MutableAnnIndex.build(data[:64], exhaustive_cfg(n_clusters=16), device=CPU)
    m.delete(list(range(60)))
    ids, dists = m.search(data[:2], k=8, rerank=rerank)
    assert (ids >= 0).sum(axis=1).tolist() == [4, 4]
    assert np.isinf(dists[:, 4:]).all()


def test_delete_unknown_or_dead_id_raises_and_mutates_nothing(churned):
    m, new_ids = churned
    before = m.stats()
    with pytest.raises(KeyError, match="not a live vector"):
        m.delete([10 ** 6])  # never existed
    with pytest.raises(KeyError, match="already deleted"):
        m.delete([3])  # already tombstoned
    with pytest.raises(KeyError, match="not a live vector"):
        m.delete([int(new_ids[3])])  # dead delta row
    with pytest.raises(KeyError, match="id 3 "):
        m.delete([int(new_ids[5]), 3])  # partial batch: all-or-nothing
    with pytest.raises(KeyError, match="id 20 was already deleted"):
        m.delete([20, 20])  # a repeat in one batch finds it dead
    with pytest.raises(KeyError, match=f"id {int(new_ids[6])} is not"):
        m.delete([int(new_ids[6])] * 2)
    assert m.stats() == before


def _reference_state(st):
    from repro.ann.mutable import _State as JState

    return JState(None, st.base_ids, st.tombstones, st.delta, st.delta_ids, st.delta_live)


@pytest.mark.parametrize("ids", [
    "mixed", [3, 999_999], [20, 20], "delta_twice", [], "dead_delta", [5, 3],
])
def test_vectorised_delete_equals_the_reference_loop(corpus, ids):
    """The port's vectorised ``_state_delete`` tombstones exactly what the
    reference's per-id loop does, and raises the same KeyError (the first
    offending id in the order given) where the loop raises."""
    from repro.ann.mutable import _state_delete as j_state_delete
    from repro_torch.ann.mutable import _state_delete

    data, extra, _q = corpus
    m = MutableAnnIndex.build(data, exhaustive_cfg(), device=CPU)
    new = m.insert(extra)
    m.delete([3, int(new[2])])
    if isinstance(ids, str):
        ids = {"mixed": np.random.default_rng(3).permutation(
                   np.setdiff1d(np.concatenate([np.arange(512), new]), [3, new[2]]))[:200],
               "delta_twice": [int(new[6])] * 2, "dead_delta": [int(new[2])]}[ids]
    st, jst = m._state, _reference_state(m._state)
    try:
        want = j_state_delete(jst, np.asarray(ids, np.int64))
    except KeyError as e:
        with pytest.raises(KeyError) as got:
            _state_delete(st, np.asarray(ids, np.int64))
        assert str(got.value) == str(e)
        return
    got = _state_delete(st, np.asarray(ids, np.int64))
    np.testing.assert_array_equal(got.tombstones, want.tombstones)
    np.testing.assert_array_equal(got.delta_live, want.delta_live)


def test_concurrent_mutation_keeps_every_update():
    """16 threads insert and delete at once under a short switch interval:
    every insert gets a distinct id, every delete lands, and the live
    count is what the operations add up to (a lost update would break
    one of these)."""
    import sys
    import threading

    data = int_vectors(256, 4)
    m = MutableAnnIndex.build(data, exhaustive_cfg(n_clusters=16), device=CPU)
    got_ids, errors = [], []

    def worker(w):
        try:
            rng = np.random.default_rng(w)
            for i in range(16):
                ids = m.insert(rng.integers(0, 30, (3, D)).astype(np.float32))
                got_ids.extend(int(x) for x in ids)
                m.delete([int(ids[0])])
                m.delete([16 * i + w])  # each base id by exactly one thread
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(w,), daemon=True) for w in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert len(got_ids) == len(set(got_ids)) == 16 * 16 * 3
    st = m.stats()
    assert st["n_tombstones"] == 256 and st["n_delta_dead"] == 256
    assert m.n_live == 16 * 16 * 2 and st["mutations"] == 16 * 16 * 3


def test_insert_validates_dim(churned):
    m, _ = churned
    with pytest.raises(ValueError):
        m.insert(np.zeros((2, D + 1), np.float32))


def test_ids_are_monotonic_and_never_reused(corpus):
    data, extra, _q = corpus
    m = MutableAnnIndex.build(data, exhaustive_cfg(), device=CPU)
    a = m.insert(extra[:4])
    m.delete([int(a[-1])])
    b = m.insert(extra[:4])
    assert b.min() > a.max()
    m.compact()
    c = m.insert(extra[:2])
    assert c.min() > b.max(), "compaction must not reset the id counter"


def test_policy_defaults_and_reasons():
    assert CompactionPolicy() == CompactionPolicy(4096, 0.25, 0.25)
    pol = CompactionPolicy(max_delta_rows=8, max_delta_frac=0.5, max_tombstone_frac=0.25)
    base = dict(n_base=100, n_tombstones=0, n_delta_live=0, n_delta_dead=0, n_live=100)
    assert pol.reason(base) is None
    assert "delta_rows" in pol.reason({**base, "n_delta_live": 8})
    assert "tombstone_frac" in pol.reason({**base, "n_tombstones": 26, "n_live": 74})
    few = dict(base, n_base=4, n_live=6, n_delta_live=3)
    assert "delta_frac" in CompactionPolicy(
        max_delta_rows=None, max_delta_frac=0.25, max_tombstone_frac=None).reason(few)


def test_maybe_compact_triggers_on_policy(corpus):
    data, extra, _q = corpus
    m = MutableAnnIndex.build(data, exhaustive_cfg(),
                              policy=CompactionPolicy(max_delta_rows=16), device=CPU)
    m.insert(extra[:8])
    assert m.maybe_compact() is None
    m.insert(extra[8:16])
    report = m.maybe_compact()
    assert report is not None and "delta_rows" in report.reason
    assert not m.dirty and m.stats()["compactions"] == 1


def test_background_compaction_replays_concurrent_mutations(corpus):
    data, extra, queries = corpus
    m = MutableAnnIndex.build(data, exhaustive_cfg(), device=CPU)
    m.insert(extra[:8])
    # deterministic version of the race: snapshot, then mutate mid-build
    snap, vecs, ids = m._begin_compaction()
    assert torch.is_tensor(vecs) and vecs.device.type == "cpu"
    mid = m.insert(extra[8:12])
    m.delete([int(mid[0]), 40])
    with pytest.raises(RuntimeError):
        m.compact()  # one compaction at a time
    report = compaction._run_to_install(m, snap, vecs, ids, engine=None, reason="t", t0=0.0)
    assert report.replayed == 2 and report.reclaimed == 0
    st = m.stats()
    assert st["n_delta_live"] == 3 and st["n_tombstones"] == 1
    assert_parity(m, queries)
    # the async wrapper runs on a pool worker while the caller keeps mutating
    handle = m.compact_async()
    late = m.insert(extra[12:14])
    m.delete([int(late[0])])
    report = handle.result(timeout=120)
    assert handle.thread_name and handle.thread_name.startswith("taco-shared")
    assert report.generation <= m.generation
    assert_parity(m, queries)
    assert_parity(m, queries, rerank="masked_full")


def test_engine_is_not_ported_yet(churned, corpus):
    """Once a gap, now a gate: ``engine()`` serves the mutable index and
    ``compact(engine=...)`` swaps the install into it (the engine cases are
    in tests/test_torch_engine.py); sharded placement still raises."""
    from repro_torch.serving import AnnRequest, AnnServingEngine

    m, _ = churned
    engine = m.engine(max_batch=8)
    assert isinstance(engine, AnnServingEngine)
    queries = corpus[2]
    res = engine.search([AnnRequest(query=q) for q in queries])
    want_i, want_d = oracle_search(m, queries)
    np.testing.assert_array_equal(np.stack([r.ids for r in res]), want_i)
    np.testing.assert_array_equal(np.stack([r.dists for r in res]), want_d)
    m.compact(engine=engine)
    assert engine.telemetry()["index_swaps"] == 1
    with pytest.raises(ValueError, match="placement='single'"):
        m.searcher("sharded")


# --------------------------------------------------------- cross-package --
CROSS_CFG = dict(n_subspaces=3, subspace_dim=6, n_clusters=64, alpha=0.05, beta=0.02, k=K)


def _pair(n, seed, **cfg):
    """(reference MutableAnnIndex, port MutableAnnIndex, rng) over the same
    integer-valued index."""
    rng = np.random.default_rng(seed)
    data = rng.integers(-10, 11, (n, 24)).astype(np.float32)
    jcfg = j_taco_config(**{**CROSS_CFG, **cfg})
    ref = integer_valued(jtaco.build(data, jcfg))
    port = taco.index_from_arrays(reference_arrays(ref), ref.sub_dims, device=CPU)
    return (JMutable(JAnnIndex(sc_index=ref, cfg=jcfg)),
            MutableAnnIndex(AnnIndex(sc_index=port, cfg=taco_config(**{**CROSS_CFG, **cfg}))),
            rng, data)


def _schedule(rng, data, n_waves, n_ins, n_del, base_ids):
    """A seeded mutation schedule: inserts (half of them exact copies of
    live rows, to make cross-stream distance ties) and deletes of live
    base and delta ids. Returns a list of ("insert", rows) / ("delete", ids)."""
    ops_, live, next_id = [], list(base_ids), len(base_ids)
    for _ in range(n_waves):
        rows = rng.integers(-10, 11, (n_ins, data.shape[1])).astype(np.float32)
        rows[: n_ins // 2] = data[rng.integers(0, len(data), n_ins // 2)]
        ops_.append(("insert", rows))
        live += list(range(next_id, next_id + n_ins))
        next_id += n_ins
        kill = rng.choice(len(live), n_del, replace=False)
        ops_.append(("delete", np.asarray([live[i] for i in kill], np.int64)))
        live = [x for i, x in enumerate(live) if i not in set(kill.tolist())]
    return ops_


def _apply(mutable, schedule):
    for kind, arg in schedule:
        if kind == "insert":
            mutable.insert(arg)
        else:
            mutable.delete(arg)


def _assert_same(a, b):
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


@pytest.mark.parametrize("selection", ["query_aware", "fixed"])
def test_port_equals_reference_bitwise_under_churn(selection):
    jm, pm, rng, data = _pair(1500, 21, selection=selection)
    sched = _schedule(rng, data, 3, 40, 30, range(1500))
    _apply(jm, sched)
    _apply(pm, sched)
    assert pm.stats()["n_tombstones"] == jm.stats()["n_tombstones"] > 0
    queries = np.concatenate([data[:6], rng.integers(-10, 11, (6, 24)).astype(np.float32)])
    for rerank in ("gather", "masked_full"):
        for k in (K, 37):
            _assert_same(pm.search(queries, k=k, rerank=rerank),
                         jm.search(queries, k=k, rerank=rerank))
        gi, gd, gs = pm.search_with_stats(queries, rerank=rerank)
        wi, wd, ws = jm.search_with_stats(queries, rerank=rerank)
        np.testing.assert_array_equal(gs["candidate_count"], np.asarray(ws["candidate_count"]))
        np.testing.assert_array_equal(gs["truncated"], np.asarray(ws["truncated"]))


def test_port_equals_reference_with_k_over_the_live_count():
    jm, pm, rng, data = _pair(300, 5, n_clusters=16, selection="fixed", beta=1.0)
    sched = [("insert", data[:4] + 1), ("delete", np.arange(0, 296, dtype=np.int64))]
    _apply(jm, sched)
    _apply(pm, sched)
    assert pm.n_live == jm.n_live == 8
    for rerank in ("gather", "masked_full"):
        got = pm.search(data[:3], k=20, rerank=rerank)
        _assert_same(got, jm.search(data[:3], k=20, rerank=rerank))
        assert (got[0] >= 0).sum(axis=1).tolist() == [8, 8, 8]


def test_exclusion_past_the_kernel_k_equals_the_reference_overfetch():
    """600 tombstones: the reference asks its base for k + 1024 rows; the
    port asks for k and excludes the tombstones in the masked re-rank. Both
    return the same rows bit for bit, and no tombstone comes back."""
    jm, pm, rng, data = _pair(4096, 8)
    queries = data[rng.integers(0, 4096, 16)]
    # the exact top-16 of every query among the tombstones: they outrank
    # every live row, so an exclusion that missed one would show
    order = np.argsort(((queries[:, None, :] - data[None]) ** 2).sum(-1), axis=1,
                       kind="stable")
    kill = np.unique(np.concatenate([order[:, :16].ravel(),
                                     rng.choice(4096, 600, replace=False)]))
    sched = [("insert", rng.integers(-10, 11, (50, 24)).astype(np.float32)),
             ("delete", kill.astype(np.int64))]
    _apply(jm, sched)
    _apply(pm, sched)
    st = pm._state
    assert st.n_tombstones > 512
    assert _pow2ceil(st.n_tombstones) + K > 1024  # the reference's base_k
    assert base_fetch_k(st, K, dataclasses.replace(pm.cfg, rerank="masked_full")) == K
    assert base_fetch_k(st, K, dataclasses.replace(pm.cfg, rerank="gather")) == K + 1024
    for k in (K, 100):
        got = pm.search(queries, k=k, rerank="masked_full")
        _assert_same(got, jm.search(queries, k=k, rerank="masked_full"))
        assert not (set(kill.tolist()) & set(got[0].ravel().tolist()))


def test_exclusion_bitmap_matches_the_tombstones():
    _jm, pm, rng, _data = _pair(1000, 2)
    assert pm._state.exclusion() is None  # nothing tombstoned: no bitmap
    kill = rng.choice(1000, 77, replace=False)
    pm.delete(kill)
    words = pm._state.exclusion()
    assert words.dtype == torch.int32 and words.shape == (32,)
    from repro_torch.kernels.masked_rerank import unpack_exclusion

    np.testing.assert_array_equal(unpack_exclusion(words, 1000).numpy(),
                                  pm._state.tombstones)
    assert pm._state.exclusion() is words  # cached per snapshot
    pm.insert(np.zeros((1, 24), np.float32))
    assert pm._state.exclusion() is words  # an insert keeps the tombstones


def test_masked_rerank_plain_exclusion_equals_masking_afterwards():
    """The plain version with an exclusion bitmap returns exactly the
    unexcluded rows of a larger-k call (no cap, k-independent distances)."""
    from repro_torch.kernels.masked_rerank import pack_exclusion
    from repro_torch.kernels.schist import collision_bits, collision_table

    _jm, pm, rng, data = _pair(2000, 4)
    sc = pm._state.base.sc_index
    queries = torch.from_numpy(data[:9])
    d1s, d2s, cells, taus, _ = taco._collision_inputs(sc, queries, pm.cfg)
    bits = collision_bits(collision_table(d1s, d2s, taus))
    thresh = torch.full((9,), 1, dtype=torch.int32)
    excluded = np.zeros(2000, bool)
    excluded[rng.choice(2000, 300, replace=False)] = True
    words = pack_exclusion(excluded)
    got_i, got_d = ops.masked_rerank(bits, cells, thresh, sc.data, sc.data_norms, queries,
                                     K, exclude=words)
    big_i, big_d = ops.masked_rerank(bits, cells, thresh, sc.data, sc.data_norms, queries,
                                     K + 300)
    for row in range(9):
        keep = [j for j, i in enumerate(big_i[row].tolist()) if i < 0 or not excluded[i]]
        np.testing.assert_array_equal(got_i[row].numpy(), big_i[row, keep[:K]].numpy())
        np.testing.assert_array_equal(got_d[row].numpy(), big_d[row, keep[:K]].numpy())


# --------------------------------------------------------- persistence --
def _persisted(stats):  # 'mutations' counts this process's ops, not state
    return {k: v for k, v in stats.items() if k != "mutations"}


def test_save_load_dirty_state_bitwise(churned, corpus, tmp_path):
    m, _ = churned
    _data, extra, queries = corpus
    path = str(tmp_path / "mutable")
    m.save(path)
    loaded = MutableAnnIndex.load(path, device=CPU)
    assert _persisted(loaded.stats()) == _persisted(m.stats())
    for rerank in ("gather", "masked_full"):
        _assert_same(m.search(queries, rerank=rerank), loaded.search(queries, rerank=rerank))
    got = loaded.insert(extra[:1])
    assert got[0] == m.stats()["next_id"]


def test_save_load_delta_only_state(corpus, tmp_path):
    data, _extra, _q = corpus
    m = MutableAnnIndex(cfg=exhaustive_cfg(), dim=D, device=CPU)
    m.insert(data[:6])
    m.delete([2])
    path = str(tmp_path / "delta_only")
    m.save(path)
    loaded = MutableAnnIndex.load(path, device=CPU)
    assert loaded.n_live == m.n_live and loaded.generation == m.generation
    _assert_same(m.search(data[:3], k=3), loaded.search(data[:3], k=3))


def test_cross_format_loads_fail_with_hint(corpus, tmp_path):
    data, _extra, _q = corpus
    cfg = exhaustive_cfg()
    AnnIndex.build(data[:64], cfg, device=CPU).save(str(tmp_path / "imm"))
    with pytest.raises(ValueError, match="use AnnIndex.load"):
        MutableAnnIndex.load(str(tmp_path / "imm"), device=CPU)
    MutableAnnIndex.build(data[:64], cfg, device=CPU).save(str(tmp_path / "mut"))
    with pytest.raises(ValueError, match="use MutableAnnIndex.load"):
        AnnIndex.load(str(tmp_path / "mut"), device=CPU)


def _state_arrays(m):
    st = m._state
    return [np.asarray(st.base_ids), np.asarray(st.tombstones), np.asarray(st.delta),
            np.asarray(st.delta_ids), np.asarray(st.delta_live)]


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_mutable_saves_cross_packages(direction, tmp_path):
    jm, pm, rng, data = _pair(1200, 13)
    sched = _schedule(rng, data, 2, 30, 25, range(1200))
    _apply(jm, sched)
    _apply(pm, sched)
    path = str(tmp_path / "mut")
    if direction == "port_to_reference":
        pm.save(path)
        loaded, other = JMutable.load(path), pm
    else:
        jm.save(path)
        loaded, other = MutableAnnIndex.load(path, device=CPU), jm
    for a, b in zip(_state_arrays(loaded), _state_arrays(other)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert _persisted(loaded.stats()) == _persisted(other.stats())
    queries = data[:8]
    for rerank in ("gather", "masked_full"):
        _assert_same(loaded.search(queries, rerank=rerank), other.search(queries, rerank=rerank))


def test_save_copies_outside_the_lock(churned, tmp_path, monkeypatch):
    """The base is copied to the host after the index lock is released: a
    writer on another thread takes the lock while the copy runs."""
    import threading

    from repro_torch.ann import persistence

    m, _ = churned
    real, seen = persistence.leaves_of, []

    def try_lock():
        got = m._lock.acquire(timeout=5)
        if got:
            m._lock.release()
        seen.append(got)

    def spy(index):
        t = threading.Thread(target=try_lock, daemon=True)
        t.start()
        t.join(10)
        return real(index)

    monkeypatch.setattr(persistence, "leaves_of", spy)
    m.save(str(tmp_path / "m"))
    assert seen == [True]


# ------------------------------------------------------------ lock order --
lockcheck_on = pytest.mark.skipif(
    os.environ.get("REPRO_LOCKCHECK", "1") == "0",
    reason="needs the instrumented stack (REPRO_LOCKCHECK=0 set)",
)


@lockcheck_on
def test_port_locks_join_the_lock_order_checker(corpus, tmp_path, monkeypatch):
    """The port's locks are instrumented by pointing the ``threading`` of
    its mutable index, WAL, scheduler and serving engine at the checker's
    proxy (the session fixture's registry then records their edges); async
    group commit, an async engine with recall probes and a background
    compaction swapped into it under concurrent mutation record the
    index-lock -> WAL-mutex and engine-lock -> WAL-mutex edges (telemetry
    reads the WAL's stats), never the index lock held while an engine's is
    taken (engines are notified after the index lock is released), and no
    violation."""
    from repro.analysis import lockcheck
    from repro_torch.ann import mutable as mmod
    from repro_torch.ann import wal as wmod
    from repro_torch.serving import AnnRequest
    from repro_torch.serving import ann_engine as emod
    from repro_torch.serving import scheduler as smod

    proxy = lockcheck._ThreadingProxy()
    for mod in (mmod, wmod, smod, emod):
        monkeypatch.setattr(mod, "threading", proxy)
    monkeypatch.setattr(smod, "_shared", None)  # a fresh, instrumented pool
    reg = lockcheck.registry()
    data, extra, queries = corpus
    m = AnnIndex.build(data, exhaustive_cfg(), device=CPU).mutable(
        durability="async", wal_dir=str(tmp_path / "wal"))
    assert isinstance(m._lock, lockcheck._InstrumentedLock)
    engine = m.engine(max_batch=4, async_mode=True, recall_probe_every=2,
                      result_cache_size=8)
    assert isinstance(engine._lock, lockcheck._InstrumentedLock)
    futures = [engine.submit(AnnRequest(query=q)) for q in queries]
    handle = m.compact_async(engine=engine)
    new = m.insert(extra[:6])
    m.delete([int(new[0]), 5])
    handle.result(timeout=120)
    futures += [engine.submit(AnnRequest(query=q)) for q in queries]
    assert all(f.result(timeout=120).ids.shape == (K,) for f in futures)
    t = engine.telemetry()
    engine.close()
    m.close()
    assert t["index_swaps"] == 1 and "wal" in t
    assert (m._lock.site, m._wal._mu.site) in reg.edges
    assert (engine._lock.site, m._wal._mu.site) in reg.edges
    assert (m._lock.site, engine._lock.site) not in reg.edges
    assert reg.violations == []
    assert_parity(m, queries)
    smod.get_shared_pool().shutdown()
