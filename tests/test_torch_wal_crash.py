"""kill -9 crash recovery of the port's mutable index (``repro_torch``, on
the CPU), end to end — ``tests/test_wal_crash.py`` run on the port: a child
process churns a mutable index under ``durability="sync"``, the parent SIGKILLs it mid-wave, then
recovers from snapshot + WAL and proves the recovered state is EXACTLY a
prefix of the child's deterministic mutation schedule — nothing torn,
nothing acked-then-lost, bitwise-equal search results.

Both sides regenerate the schedule from the same seed (this module is
imported by the child via ``python -m test_torch_wal_crash --child``), so the
parent can rebuild the expected state for whatever record prefix
survived the kill without any coordination beyond an atomically-written
ack file.

Three tie-immune assertions:

* live-corpus equality — recovered (vectors, ids) bitwise-equal to the
  regenerated prefix state;
* uncompacted search parity — recovered and regenerated mutables share
  the same base/delta/tombstone structure, so both re-rank pipelines
  must agree bitwise (identical scan order resolves distance ties
  identically);
* compacted oracle parity — ``compact()`` installs exactly
  ``AnnIndex.build(live_corpus)``; the regenerated side's
  ``rebuild_oracle()`` builds the same corpus, and identical indexes
  give identical answers.
"""
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

D = 32
K = 5
N_BASE = 96
WAVES = 48  # 2 base-id deletes per wave; 48 waves never exhaust the base
WAVE_INSERTS = 6
WAVE_DELETES = 2
SEED = 7


def exhaustive_cfg(rerank="gather"):
    from repro_torch.core.config import taco_config

    return taco_config(n_subspaces=4, subspace_dim=8, n_clusters=16,
                       kmeans_iters=2, alpha=0.1, beta=1.0,
                       selection="fixed", k=K, rerank=rerank)


def int_vectors(n, seed, d=D):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 30, (n, d)).astype(np.float32)


def base_corpus():
    return int_vectors(N_BASE, SEED)


def wave_ops(w):
    """Wave ``w``'s two WAL records: (insert vectors, delete external ids).

    External ids are assigned sequentially, so both sides know them
    without talking: base = 0..N_BASE-1, wave w inserts N_BASE + 6w ..
    N_BASE + 6w + 5, wave w deletes base ids 2w and 2w+1 (each base id
    is deleted at most once across all waves)."""
    ins = int_vectors(WAVE_INSERTS, SEED * 1000 + w)
    dels = np.array([2 * w, 2 * w + 1], dtype=np.int64)
    return ins, dels


def fresh_mutable(wal_dir=None, durability="none"):
    from repro_torch.ann import MutableAnnIndex

    return MutableAnnIndex(None, cfg=exhaustive_cfg(), dim=D, device="cpu",
                           durability=durability, wal_dir=wal_dir)


def apply_record_prefix(mutable, n_records):
    """Apply the first ``n_records`` post-snapshot schedule records (wave
    w is records 2w (insert) and 2w+1 (delete))."""
    for r in range(n_records):
        ins, dels = wave_ops(r // 2)
        if r % 2 == 0:
            mutable.insert(ins)
        else:
            mutable.delete(dels)


def ack_wave(ack_path):
    try:
        with open(ack_path) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return -1


def run_child(wal_dir, snap_dir, ack_path):
    """The crashing side: build, snapshot, churn forever under sync
    durability, acking each completed wave via atomic rename (by the
    time an ack is visible, every record of that wave is fsynced)."""
    m = fresh_mutable(wal_dir=wal_dir, durability="sync")
    m.insert(base_corpus())  # WAL record 0
    m.save(snap_dir)  # watermark covers the base insert
    for w in range(WAVES):
        ins, dels = wave_ops(w)
        m.insert(ins)
        m.delete(dels)
        tmp = ack_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(w))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, ack_path)
    # survived every wave without being killed: still a valid run — the
    # parent then recovers the complete schedule instead of a prefix
    m.close()


def test_sigkill_mid_churn_recovers_bitwise(tmp_path):
    wal_dir = str(tmp_path / "wal")
    snap_dir = str(tmp_path / "snap")
    ack_path = str(tmp_path / "ack")

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    child = subprocess.Popen(
        [sys.executable, "-m", "test_torch_wal_crash", "--child",
         wal_dir, snap_dir, ack_path],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
    )
    try:
        # let it get past the snapshot and a few waves, then pull the plug
        deadline = time.monotonic() + 120.0
        while ack_wave(ack_path) < 3 and child.poll() is None:
            if time.monotonic() > deadline:
                raise AssertionError("child never reached wave 3")
            time.sleep(0.01)
        if child.poll() is None:
            os.kill(child.pid, signal.SIGKILL)
        child.wait(timeout=60.0)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=60.0)
    acked = ack_wave(ack_path)
    assert acked >= 3

    from repro_torch.ann import MutableAnnIndex

    recovered = MutableAnnIndex.load(snap_dir, wal_dir=wal_dir, device="cpu")
    replayed = recovered._wal.records_replayed
    # sync durability: every acked wave's 2 records must have survived;
    # at most one trailing wave can be partially present (torn mid-wave)
    assert 2 * (acked + 1) <= replayed <= 2 * WAVES

    expected = fresh_mutable()
    expected.insert(base_corpus())
    apply_record_prefix(expected, replayed)

    # 1) the recovered corpus IS the prefix state, bitwise
    got_vecs, got_ids = recovered.live_corpus()
    want_vecs, want_ids = expected.live_corpus()
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_vecs, want_vecs)
    assert recovered.n_live == expected.n_live

    # 2) uncompacted search parity, both re-rank pipelines
    queries = int_vectors(8, 999)
    for rerank in ("gather", "masked_full"):
        gi, gd = recovered.search(queries, rerank=rerank)
        wi, wd = expected.search(queries, rerank=rerank)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gd, wd)

    # 3) compaction == from-scratch oracle over the recovered corpus
    recovered.compact()
    oracle, id_map = expected.rebuild_oracle()
    for rerank in ("gather", "masked_full"):
        gi, gd = recovered.search(queries, rerank=rerank)
        oi, od = oracle.replace_cfg(rerank=rerank).search(queries)
        oi, od = np.asarray(oi), np.asarray(od)
        np.testing.assert_array_equal(
            gi, np.where(oi >= 0, id_map[np.maximum(oi, 0)], -1))
        np.testing.assert_array_equal(gd, od)
    recovered.close()


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--child":
        run_child(sys.argv[2], sys.argv[3], sys.argv[4])
    else:
        sys.exit(f"usage: {sys.argv[0]} --child WAL_DIR SNAP_DIR ACK_PATH")
