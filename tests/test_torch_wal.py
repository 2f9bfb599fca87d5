"""The port's write-ahead log (``repro_torch.ann.wal``): codec, torn-tail
recovery, fault injection, group commit on the port's ``WorkerPool``, and
crash-equivalent round-trips of the port's mutable index — the cases of
``tests/test_wal.py`` run on the port (on the CPU) — plus byte-for-byte
compatibility with ``repro.ann.wal``: the same record sequence writes
identical segment files, and a log written by either package replays in
the other.

Parity protocol: integer-valued vectors + exhaustive candidate selection
(``selection="fixed", beta=1.0``) make an uncompacted mutable search
bitwise-equal to a from-scratch ``AnnIndex.build`` oracle over the live
corpus, so a recovered index is checked against ground truth.
"""
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.ann import MutableAnnIndex
from repro_torch.ann.wal import (
    KIND_COMPACT,
    KIND_DELETE,
    KIND_INSERT,
    SEGMENT_MAGIC,
    FaultInjectingFile,
    WalError,
    WriteAheadLog,
    decode_record,
    encode_compact,
    encode_delete,
    encode_insert,
    frame,
    list_segments,
    read_wal,
    scan_segment,
    segment_path,
)
from repro_torch.core.config import taco_config

D = 32
K = 5
CPU = "cpu"


def int_vectors(n, seed, d=D):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 30, (n, d)).astype(np.float32)


def exhaustive_cfg(**kw):
    base = dict(n_subspaces=4, subspace_dim=8, n_clusters=16, kmeans_iters=2,
                alpha=0.1, beta=1.0, selection="fixed", k=K)
    return taco_config(**{**base, **kw})


def oracle_search(mutable, queries, *, k=None, rerank=None):
    oracle, id_map = mutable.rebuild_oracle()
    if rerank is not None:
        oracle = oracle.replace_cfg(rerank=rerank)
    ids, dists = oracle.search(queries, k=k)
    ids, dists = np.asarray(ids), np.asarray(dists)
    return np.where(ids >= 0, id_map[np.maximum(ids, 0)], -1), dists


def assert_parity(mutable, queries, *, rerank=None):
    got_i, got_d = mutable.search(queries, rerank=rerank)
    want_i, want_d = oracle_search(mutable, queries, rerank=rerank)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)  # bitwise


# ------------------------------------------------------------------- codec --
def test_record_codec_roundtrip():
    ids = np.array([3, 7, 11], np.int32)
    vecs = int_vectors(3, 0)
    rec = decode_record(encode_insert(5, 2, ids, vecs))
    assert (rec.kind, rec.lsn, rec.generation) == (KIND_INSERT, 5, 2)
    np.testing.assert_array_equal(rec.ids, ids)
    np.testing.assert_array_equal(rec.vectors, vecs)  # bitwise f32

    rec = decode_record(encode_delete(6, 3, np.array([1, 2], np.int64)))
    assert (rec.kind, rec.lsn, rec.generation) == (KIND_DELETE, 6, 3)
    np.testing.assert_array_equal(rec.ids, [1, 2])

    rec = decode_record(encode_compact(7, 4, n_live=120, next_id=130))
    assert (rec.kind, rec.lsn, rec.n_live, rec.next_id) == (KIND_COMPACT, 7, 120, 130)


def test_decode_rejects_malformed_bodies():
    good = encode_delete(0, 0, np.array([1], np.int64))
    with pytest.raises(ValueError):
        decode_record(good[:-3])  # truncated body
    with pytest.raises(ValueError):
        decode_record(b"\x09" + good[1:])  # unknown kind
    with pytest.raises(ValueError):
        decode_record(b"\x01")  # shorter than the fixed head


def _write_segment(path, payloads):
    with open(path, "wb") as f:
        f.write(SEGMENT_MAGIC)
        for p in payloads:
            f.write(frame(p))


def test_scan_detects_bitflip_torn_tail_and_lsn_gap(tmp_path):
    p0 = encode_delete(0, 0, np.array([1], np.int64))
    p1 = encode_delete(1, 0, np.array([2], np.int64))
    path = str(tmp_path / "seg.log")

    _write_segment(path, [p0, p1])
    recs, valid, damaged = scan_segment(path)
    assert [r.lsn for r in recs] == [0, 1] and not damaged
    good_end = valid

    # flip one payload byte under a valid length prefix
    with open(path, "rb") as f:
        blob = bytearray(f.read())
    blob[-1] ^= 1
    with open(path, "wb") as f:
        f.write(bytes(blob))
    recs, valid, damaged = scan_segment(path)
    assert [r.lsn for r in recs] == [0] and damaged
    assert valid == good_end - len(frame(p1))

    # torn tail: drop the last 3 bytes of a valid file
    _write_segment(path, [p0, p1])
    os.truncate(path, good_end - 3)
    recs, valid, damaged = scan_segment(path)
    assert [r.lsn for r in recs] == [0] and damaged

    # LSN gap (a lost middle write): everything from the gap is untrusted
    _write_segment(path, [p0, encode_delete(2, 0, np.array([9], np.int64))])
    recs, valid, damaged = scan_segment(path)
    assert [r.lsn for r in recs] == [0] and damaged


# ------------------------------------------------------------ append/reopen --
def test_append_flush_reopen_resumes_lsn(tmp_path):
    wal_dir = str(tmp_path / "wal")
    with WriteAheadLog(wal_dir, fsync=False) as wal:
        assert wal.append_insert([0, 1], int_vectors(2, 1), generation=1) == 0
        assert wal.append_delete([0], generation=2) == 1
        wal.flush()
        assert wal.durable_lsn == 1

    wal2 = WriteAheadLog(wal_dir, fsync=False)
    recs = wal2.take_recovered()
    assert [(r.kind, r.lsn) for r in recs] == [(KIND_INSERT, 0), (KIND_DELETE, 1)]
    assert wal2.take_recovered() == []  # consumed once
    assert wal2.append_compact(generation=3, n_live=2, next_id=2) == 2
    wal2.flush()
    wal2.close()
    assert [r.lsn for r in read_wal(wal_dir)] == [0, 1, 2]


def test_reopen_truncates_torn_tail_and_appends_resume(tmp_path):
    wal_dir = str(tmp_path / "wal")
    with WriteAheadLog(wal_dir, fsync=False) as wal:
        for i in range(4):
            wal.append_delete([i], generation=0)
        wal.flush()
    seg0 = segment_path(wal_dir, 0)
    good = os.path.getsize(seg0)
    with open(seg0, "ab") as f:
        f.write(b"\x99\x01garbage")  # torn append past the last commit

    wal = WriteAheadLog(wal_dir, fsync=False)
    assert [r.lsn for r in wal.take_recovered()] == [0, 1, 2, 3]
    assert os.path.getsize(seg0) == good  # tail cut exactly at last record
    assert wal.append_delete([9], generation=0) == 4
    wal.flush()
    wal.close()
    assert [r.lsn for r in read_wal(wal_dir)] == [0, 1, 2, 3, 4]


def test_damaged_magic_resets_segment(tmp_path):
    wal_dir = str(tmp_path / "wal")
    with WriteAheadLog(wal_dir, fsync=False) as wal:
        wal.append_delete([1], generation=0)
        wal.flush()
    seg0 = segment_path(wal_dir, 0)
    with open(seg0, "rb") as f:
        blob = bytearray(f.read())
    blob[0] ^= 0xFF
    with open(seg0, "wb") as f:
        f.write(bytes(blob))

    wal = WriteAheadLog(wal_dir, fsync=False)
    assert wal.take_recovered() == []  # nothing trustworthy survives
    assert wal.append_delete([2], generation=0) == 0  # LSNs restart
    wal.flush()
    wal.close()
    assert [r.lsn for r in read_wal(wal_dir)] == [0]


def test_rotation_and_checkpoint_retirement(tmp_path):
    wal_dir = str(tmp_path / "wal")
    wal = WriteAheadLog(wal_dir, fsync=False, segment_bytes=256)
    for i in range(12):
        wal.append_delete([i], generation=0)
        wal.flush()
    assert wal.segments_created > 1
    segs_before = list_segments(wal_dir)
    assert len(segs_before) > 1

    retired = wal.checkpoint(wal.durable_lsn)  # snapshot covers everything
    assert retired >= 1
    assert wal.stats()["segments_retired"] == retired
    # only the fresh active segment remains, and it holds no records
    assert list_segments(wal_dir) == [wal.stats()["segment"]]
    assert read_wal(wal_dir) == []

    # post-checkpoint appends land in the new segment and survive reopen
    nxt = wal.append_delete([99], generation=0)
    wal.flush()
    wal.close()
    assert [r.lsn for r in read_wal(wal_dir)] == [nxt]


def test_partial_checkpoint_keeps_uncovered_segments(tmp_path):
    wal_dir = str(tmp_path / "wal")
    wal = WriteAheadLog(wal_dir, fsync=False, segment_bytes=256)
    for i in range(12):
        wal.append_delete([i], generation=0)
        wal.flush()
    # watermark in the middle: whole segments are the retirement unit, so
    # every record past the watermark survives as a contiguous run (some
    # covered records may ride along in a partially-covered segment)
    wal.checkpoint(5)
    wal.close()
    survivors = [r.lsn for r in read_wal(wal_dir)]
    assert survivors == list(range(survivors[0], 12))
    assert survivors[0] <= 6


def test_closed_wal_refuses_appends(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal"), fsync=False)
    wal.close()
    with pytest.raises(WalError):
        wal.append_delete([0], generation=0)


# ------------------------------------------------------------ group commit --
def test_group_commit_batches_appends(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal"), fsync=False)
    for i in range(8):
        wal.append_delete([i], generation=0)
    wal.flush()
    s = wal.stats()
    assert s["appends"] == 8
    assert s["group_commits"] == 1  # one write+sync covered all eight
    assert s["max_group"] == 8
    wal.close()


def test_async_kick_drains_through_pool(tmp_path):
    from repro_torch.serving.scheduler import WorkerPool

    pool = WorkerPool(workers=2, name="wal-test")
    wal = WriteAheadLog(str(tmp_path / "wal"), fsync=False)
    try:
        for i in range(16):
            wal.append_delete([i], generation=0)
            wal.kick(pool)
        assert pool.join(timeout=10.0)
        wal.flush()  # cover any append that raced the last started task
        assert wal.durable_lsn == 15
        assert wal.stats()["pending"] == 0
    finally:
        wal.close()
        pool.shutdown()


def test_coalesced_submit_dedupes_queued_tasks():
    import threading

    from repro_torch.serving.scheduler import WorkerPool

    pool = WorkerPool(workers=1, name="coalesce-test")
    gate = threading.Event()
    ran = []
    try:
        blocker = pool.submit(gate.wait, label="blocker")
        t1 = pool.submit_coalesced(ran.append, 1, key="k")
        t2 = pool.submit_coalesced(ran.append, 2, key="k")
        assert t1 is t2  # queued task absorbed the second submit
        gate.set()
        blocker.result(timeout=5.0)
        t1.result(timeout=5.0)
        assert pool.join(timeout=5.0)
        assert ran == [1]
    finally:
        pool.shutdown()


# ---------------------------------------------------------- fault injection --
@pytest.mark.parametrize("mode", ["truncate", "drop", "bitflip"])
def test_fault_injection_recovers_valid_prefix(tmp_path, mode):
    """A fault at a byte offset mid-log loses records from the damaged
    point on — never an exception, never a partially-applied record."""
    wal_dir = str(tmp_path / f"wal-{mode}")
    # aim inside record 2 (records 0 and 1 stay intact); the log is all
    # single-id delete records, so every frame has the same size
    rec_bytes = len(frame(encode_delete(0, 0, np.array([0], np.int64))))
    fault_at = len(SEGMENT_MAGIC) + 2 * rec_bytes + 5

    faults = []

    def factory(path):
        raw = open(path, "ab", buffering=0)
        f = FaultInjectingFile(raw, mode=mode, offset=fault_at)
        faults.append(f)
        return f

    wal = WriteAheadLog(wal_dir, fsync=False, file_factory=factory)
    for i in range(6):
        wal.append_delete([i], generation=0)
        wal.flush()  # one write per record: the fault hits record ~1
    assert sum(f.faults_applied for f in faults) >= 1
    wal.close()

    recovered = WriteAheadLog(wal_dir, fsync=False)
    recs = recovered.take_recovered()
    lsns = [r.lsn for r in recs]
    assert lsns == [0, 1]  # the intact prefix, nothing past the fault
    # post-recovery appends continue the sequence and survive a reopen
    nxt = recovered.append_delete([99], generation=0)
    assert nxt == len(lsns)
    recovered.flush()
    recovered.close()
    assert [r.lsn for r in read_wal(wal_dir)] == list(range(nxt + 1))


# ------------------------------------------------- durable mutable parity --
@pytest.fixture(scope="module")
def corpus():
    return int_vectors(96, 0), int_vectors(24, 1), int_vectors(6, 2)


@pytest.mark.parametrize("rerank", ["gather", "masked_full"])
def test_crash_replay_matches_oracle(tmp_path, corpus, rerank):
    """Snapshot, churn WITHOUT saving, drop the index (the crash), reload
    from snapshot + WAL: recovered search is bitwise-equal to a
    from-scratch build over the pre-crash live corpus."""
    data, extra, queries = corpus
    snap, wal_dir = str(tmp_path / "snap"), str(tmp_path / "wal")

    m = MutableAnnIndex(
        None, cfg=exhaustive_cfg(rerank=rerank), dim=D, device=CPU,
        durability="sync", wal_dir=wal_dir,
    )
    base_ids = m.insert(data)
    m.save(snap)  # snapshot watermark; WAL checkpoints behind it

    new_ids = m.insert(extra)  # post-snapshot churn: replay must cover it
    m.delete(np.concatenate([base_ids[:7], new_ids[:3]]))
    want_i, want_d = m.search(queries)
    live_before = m.stats()["n_live"]
    # crash: no save, no close — durability="sync" already fsynced all of it

    r = MutableAnnIndex.load(snap, wal_dir=wal_dir, device=CPU)
    assert r.durability == "sync"  # snapshot's recorded mode sticks
    assert r._wal.records_replayed == 2
    assert r.stats()["n_live"] == live_before
    got_i, got_d = r.search(queries)
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    np.testing.assert_array_equal(got_d, np.asarray(want_d))
    assert_parity(r, queries, rerank=rerank)

    # recovered index keeps logging: another churn + reload still agrees
    r.delete(new_ids[3:5])
    want2 = r.search(queries)
    r.close()
    m.close()
    r2 = MutableAnnIndex.load(snap, wal_dir=wal_dir, device=CPU)
    got2 = r2.search(queries)
    np.testing.assert_array_equal(np.asarray(got2[0]), np.asarray(want2[0]))
    assert_parity(r2, queries, rerank=rerank)
    r2.close()


def test_compaction_marker_checkpoints_wal(tmp_path, corpus):
    data, extra, queries = corpus
    snap, wal_dir = str(tmp_path / "snap"), str(tmp_path / "wal")
    m = MutableAnnIndex(
        None, cfg=exhaustive_cfg(), dim=D, device=CPU, durability="sync", wal_dir=wal_dir,
    )
    ids = m.insert(data)
    m.save(snap)
    m.delete(ids[:5])
    m.insert(extra)
    m.compact()  # writes the marker and (checkpoint path known) re-snapshots
    # the log is bounded: everything up to the marker was retired
    assert read_wal(wal_dir) == []
    post = m.insert(int_vectors(2, 9))
    m.close()

    r = MutableAnnIndex.load(snap, wal_dir=wal_dir, device=CPU)
    assert r.stats()["n_live"] == m.stats()["n_live"]
    assert r.generation == m.generation
    assert_parity(r, queries)
    assert np.all(np.isin(post, r.live_corpus()[1]))
    r.close()


def test_durability_mode_validation(tmp_path):
    with pytest.raises(ValueError, match="requires wal_dir"):
        MutableAnnIndex(None, cfg=exhaustive_cfg(), dim=D, device=CPU, durability="sync")
    with pytest.raises(ValueError, match="durability='none'"):
        MutableAnnIndex(None, cfg=exhaustive_cfg(), dim=D, device=CPU,
                        wal_dir=str(tmp_path / "w"))
    with pytest.raises(ValueError, match="durability"):
        MutableAnnIndex(None, cfg=exhaustive_cfg(), dim=D, device=CPU, durability="fsync")


def test_async_durability_flushes_in_background(tmp_path, corpus):
    data, _extra, _q = corpus
    wal_dir = str(tmp_path / "wal")
    m = MutableAnnIndex(
        None, cfg=exhaustive_cfg(), dim=D, device=CPU, durability="async", wal_dir=wal_dir,
    )
    ids = m.insert(data)
    m.delete(ids[:4])
    from repro_torch.serving.scheduler import get_shared_pool

    get_shared_pool().join(timeout=10.0)
    m._wal.flush()  # cover a kick that raced the join
    assert m._wal.durable_lsn == 1
    m.close()
    assert len(read_wal(wal_dir)) == 2


# --------------------------------------------------- truncation property --
_REFERENCE_LOG: tuple[bytes, list] | None = None


def _reference_log():
    """A mixed 10-record WAL as raw segment bytes plus each record's end
    offset (cached: every property example cuts the same valid log)."""
    global _REFERENCE_LOG
    if _REFERENCE_LOG is not None:
        return _REFERENCE_LOG
    import struct
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        wal_dir = os.path.join(root, "ref")
        wal = WriteAheadLog(wal_dir, fsync=False)
        rng = np.random.default_rng(7)
        for i in range(10):
            if i % 3 == 2:
                wal.append_delete([i], generation=0)
            else:
                wal.append_insert(
                    np.arange(2, dtype=np.int32) + 2 * i,
                    rng.integers(0, 9, (2, 4)).astype(np.float32),
                    generation=0,
                )
            wal.flush()
        wal.close()
        with open(segment_path(wal_dir, 0), "rb") as f:
            blob = f.read()
    ends, off = [], len(SEGMENT_MAGIC)
    while off < len(blob):
        (length,) = struct.unpack_from("<I", blob, off)
        off += 8 + length  # u32 length + u32 crc + payload
        ends.append(off)
    assert len(ends) == 10 and ends[-1] == len(blob)
    _REFERENCE_LOG = (blob, ends)
    return _REFERENCE_LOG


@settings(max_examples=40, deadline=None)
@given(st.integers(min_value=0, max_value=600))
def test_any_byte_prefix_recovers_cleanly(cut):
    """Satellite property: for ANY byte-prefix truncation of a valid log,
    recovery yields exactly the records whose frames fit the prefix —
    never an exception, never a partially-decoded record — and the log
    accepts appends afterwards."""
    import tempfile

    blob, ends = _reference_log()
    cut = min(cut, len(blob))
    want = sum(1 for e in ends if e <= cut)

    with tempfile.TemporaryDirectory() as root:
        wal_dir = os.path.join(root, "cut")
        os.makedirs(wal_dir)
        with open(segment_path(wal_dir, 0), "wb") as f:
            f.write(blob[:cut])

        wal = WriteAheadLog(wal_dir, fsync=False)
        recs = wal.take_recovered()
        assert [r.lsn for r in recs] == list(range(want))
        assert wal.append_delete([0], generation=0) == want
        wal.flush()
        wal.close()
        assert [r.lsn for r in read_wal(wal_dir)] == list(range(want + 1))


# ------------------------------------------------------- cross-package --
def _write_both(root, writer):
    """Run ``writer(WriteAheadLog)`` against both packages' logs; returns
    the two directories."""
    from repro.ann import wal as jwal

    dirs = []
    for name, cls in (("ref", jwal.WriteAheadLog), ("port", WriteAheadLog)):
        d = os.path.join(root, name)
        writer(cls, d)
        dirs.append(d)
    return dirs


def _mixed_log(cls, directory):
    rng = np.random.default_rng(5)
    wal = cls(directory, fsync=False, segment_bytes=512)
    for i in range(14):
        if i % 4 == 3:
            wal.append_delete(np.arange(i, i + 3), generation=i)
        elif i == 9:
            wal.append_compact(generation=i, n_live=40 + i, next_id=100 + i)
        else:
            wal.append_insert(np.arange(2, dtype=np.int32) + 2 * i,
                              rng.integers(0, 9, (2, 6)).astype(np.float32), generation=i)
        wal.flush()
        if i == 10:
            wal.checkpoint(6)  # rotation + retirement of covered segments
    wal.close()


def test_segment_files_byte_identical_to_reference(tmp_path):
    ref, port = _write_both(str(tmp_path), _mixed_log)
    assert list_segments(ref) == list_segments(port) and len(list_segments(port)) > 1
    for seg in list_segments(port):
        with open(segment_path(ref, seg), "rb") as a, open(segment_path(port, seg), "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_log_replays_in_the_other_package(tmp_path, writer):
    """A snapshot + WAL written by one package (churn past the snapshot,
    then a crash: no save, no close) recovers in the other to the same
    state arrays and the same search results, bit for bit."""
    from repro.ann import MutableAnnIndex as JMutable
    from tests.test_torch_mutable import _apply, _pair, _schedule, _state_arrays

    jm, pm, rng, data = _pair(600, 17, selection="fixed", beta=1.0)
    snap, wal_dir = str(tmp_path / "snap"), str(tmp_path / "wal")
    first = _schedule(rng, data, 1, 20, 10, range(600))
    src_base = jm if writer == "reference" else pm
    src = (JMutable if writer == "reference" else MutableAnnIndex)(
        src_base._state.base, durability="sync", wal_dir=wal_dir)
    _apply(src, first)
    src.save(snap)
    live = [int(i) for i in src.live_corpus()[1]]
    second = [("insert", data[:5] + 1),
              ("delete", np.asarray(live[::7][:9], np.int64)),
              ("insert", rng.integers(-10, 11, (7, data.shape[1])).astype(np.float32))]
    _apply(src, second)
    want = src.search(data[:6])
    if writer == "reference":
        got_index = MutableAnnIndex.load(snap, wal_dir=wal_dir, device=CPU)
    else:
        got_index = JMutable.load(snap, wal_dir=wal_dir)
    assert got_index._wal.records_replayed == len(second)
    for a, b in zip(_state_arrays(got_index), _state_arrays(src)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got_index.stats()["next_id"] == src.stats()["next_id"]
    assert got_index.generation == src.generation
    got = got_index.search(data[:6])
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    got_index.close()
    src.close()
