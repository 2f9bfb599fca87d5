"""Durable write-ahead log for the mutable ANN index (mirrors
``repro.ann.wal`` byte for byte: a log written by either package replays in
the other).

TaCo's cheap-indexing headline makes *rebuilds* affordable; this module
makes *restarts* affordable. Without it a mutable index loses every
insert/delete since the last manifest rename on a ``kill -9`` — here every
mutation first lands in a segmented, append-only binary log, so recovery
is "load the last snapshot, replay a few thousand records" instead of
re-ingesting a corpus. Host-side only: the records hold numpy arrays, and
the index copies inserted rows to the card after the append.

On-disk format
--------------
A WAL directory holds numbered segment files ``wal_00000000.log``,
``wal_00000001.log``, ... Each segment starts with an 8-byte magic and
then carries length-prefixed records::

    <u32 payload_len> <u32 crc32(payload)> <payload>
    payload := <u8 kind> <u64 lsn> <u64 generation> <kind-specific body>

Kinds: insert batch (ids int32 + rows float32), delete batch (ids int64),
compaction-install marker (live-row count + next id). LSNs are assigned
monotonically under the owner's lock in apply order, so the log is a
total order over mutations; all integers are little-endian, so a segment
is portable across hosts.

Durability modes (selected by ``MutableAnnIndex(durability=...)``):

* ``"sync"``  — the mutating caller flushes and ``fsync``\\ s *on its own
  path* before returning: an acknowledged mutation survives kill -9.
* ``"async"`` — appends are enqueued in memory and a **group-commit**
  flusher task on the shared :class:`~repro_torch.serving.scheduler.WorkerPool`
  coalesces everything pending into one ``write`` + one ``fsync``. The
  window between apply and flush is the only data at risk.
* ``"none"``  — no WAL at all.

Lock discipline: appends only touch memory (LSN assignment + a pending
list) and may run under the index lock; **all file I/O happens with no
lock held** — :meth:`WriteAheadLog.flush` claims a single-flusher baton
under the log's mutex, releases it, and only then writes and fsyncs.
The static lint's B001 file-I/O rule machine-checks exactly
that: ``os.fsync``/``.write()``/``.flush()`` under any ``repro_torch.ann`` /
``repro_torch.serving`` lock is a lint error, and this module passes with no
``noqa``.

Recovery (:meth:`WriteAheadLog.open` → :func:`replay_records`): segments
are scanned in order, every record CRC-checked; a torn tail (short
header, short payload, bad checksum, undecodable body, non-monotonic
LSN) truncates the log at the last good record — the valid prefix is a
consistent mutation history because records are framed individually and
appended in apply order. The snapshot's manifest carries a (segment,
LSN) watermark; replay applies only records past it. A snapshot save
(:func:`repro_torch.ann.persistence.save_mutable_index`) then *checkpoints*
the log: the active segment rotates and every segment fully covered by
the watermark is deleted, so the log stays bounded across compactions.

:class:`FaultInjectingFile` is the deterministic crash harness for the
tests: it wraps a segment file and drops, truncates, or bit-flips the
byte stream at a chosen offset, simulating the torn writes a real power
cut produces.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import threading
import zlib

import numpy as np

from repro_torch.obs import metrics as obsm
from repro_torch.obs import trace as obst
from repro_torch.serving.scheduler import get_shared_pool

# Process-wide durability metric families (repro_torch.obs registry). Updated
# at the same sites as the per-log counters below; the registry is the
# cross-log aggregate ``/metrics`` exports.
_M_APPENDS = obsm.counter(
    "taco_wal_appends_total", "Records appended to any write-ahead log"
)
_M_APPEND_BYTES = obsm.counter(
    "taco_wal_append_bytes_total", "Framed bytes written to WAL segments"
)
_M_FSYNCS = obsm.counter(
    "taco_wal_fsyncs_total", "fsync() calls on WAL segment files"
)
_M_FSYNC_SECONDS = obsm.histogram(
    "taco_wal_fsync_seconds", "WAL fsync() wall time"
)
_M_FLUSH_SECONDS = obsm.histogram(
    "taco_wal_flush_seconds", "One WAL group commit (write + fsync + rotate)"
)
_M_GROUP_RECORDS = obsm.histogram(
    "taco_wal_group_commit_records", "Records absorbed per WAL group commit"
)

SEGMENT_MAGIC = b"TACOWAL\x01"
SEGMENT_PREFIX = "wal_"
SEGMENT_SUFFIX = ".log"
#: default rotate threshold — small enough that churn workloads exercise
#: rotation, large enough that a segment holds thousands of records
DEFAULT_SEGMENT_BYTES = 4 << 20

_HEADER = struct.Struct("<II")  # payload_len, crc32(payload)
_PAYLOAD_HEAD = struct.Struct("<BQQ")  # kind, lsn, generation
_INSERT_HEAD = struct.Struct("<II")  # m rows, d dims
_DELETE_HEAD = struct.Struct("<I")  # m ids
_COMPACT_BODY = struct.Struct("<QQ")  # n_live, next_id

KIND_INSERT = 1
KIND_DELETE = 2
KIND_COMPACT = 3
KIND_NAMES = {KIND_INSERT: "insert", KIND_DELETE: "delete",
              KIND_COMPACT: "compact"}

#: framing sanity bound — a length prefix above this is treated as tail
#: damage, not an instruction to allocate garbage gigabytes
MAX_RECORD_BYTES = 1 << 30

DURABILITY_MODES = ("none", "async", "sync")


class WalError(RuntimeError):
    """A WAL write failed; the log refuses further appends."""


@dataclasses.dataclass
class WalRecord:
    """One decoded log record."""

    kind: int
    lsn: int
    generation: int
    ids: np.ndarray | None = None  # insert: int32, delete: int64
    vectors: np.ndarray | None = None  # insert only: (m, d) float32
    n_live: int = 0  # compact marker only
    next_id: int = 0  # compact marker only

    @property
    def kind_name(self) -> str:
        return KIND_NAMES.get(self.kind, f"kind{self.kind}")


# ------------------------------------------------------------ encoding --
def encode_insert(lsn: int, generation: int, ids, vectors) -> bytes:
    ids = np.ascontiguousarray(np.asarray(ids, "<i4"))
    vectors = np.ascontiguousarray(np.asarray(vectors, "<f4"))
    m, d = vectors.shape
    if ids.shape != (m,):
        raise ValueError(f"ids shape {ids.shape} != ({m},)")
    return (
        _PAYLOAD_HEAD.pack(KIND_INSERT, lsn, generation)
        + _INSERT_HEAD.pack(m, d)
        + ids.tobytes()
        + vectors.tobytes()
    )


def encode_delete(lsn: int, generation: int, ids) -> bytes:
    ids = np.ascontiguousarray(np.asarray(ids, "<i8").ravel())
    return (
        _PAYLOAD_HEAD.pack(KIND_DELETE, lsn, generation)
        + _DELETE_HEAD.pack(ids.shape[0])
        + ids.tobytes()
    )


def encode_compact(lsn: int, generation: int, n_live: int, next_id: int) -> bytes:
    return _PAYLOAD_HEAD.pack(KIND_COMPACT, lsn, generation) + _COMPACT_BODY.pack(
        n_live, next_id
    )


def frame(payload: bytes) -> bytes:
    """Length-prefix + checksum one encoded payload."""
    return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def decode_record(payload: bytes) -> WalRecord:
    """Strict inverse of the encoders; raises ``ValueError`` on any
    malformed body (callers treat that as tail damage)."""
    if len(payload) < _PAYLOAD_HEAD.size:
        raise ValueError("payload shorter than its fixed head")
    kind, lsn, generation = _PAYLOAD_HEAD.unpack_from(payload, 0)
    body = payload[_PAYLOAD_HEAD.size:]
    if kind == KIND_INSERT:
        if len(body) < _INSERT_HEAD.size:
            raise ValueError("insert record missing its (m, d) head")
        m, d = _INSERT_HEAD.unpack_from(body, 0)
        want = _INSERT_HEAD.size + 4 * m + 4 * m * d
        if len(body) != want:
            raise ValueError(f"insert record body {len(body)}B != {want}B")
        ids = np.frombuffer(body, "<i4", count=m, offset=_INSERT_HEAD.size)
        vecs = np.frombuffer(
            body, "<f4", count=m * d, offset=_INSERT_HEAD.size + 4 * m
        ).reshape(m, d)
        return WalRecord(KIND_INSERT, lsn, generation,
                         ids=ids.astype(np.int32, copy=True),
                         vectors=vecs.astype(np.float32, copy=True))
    if kind == KIND_DELETE:
        if len(body) < _DELETE_HEAD.size:
            raise ValueError("delete record missing its count head")
        (m,) = _DELETE_HEAD.unpack_from(body, 0)
        if len(body) != _DELETE_HEAD.size + 8 * m:
            raise ValueError("delete record body length mismatch")
        ids = np.frombuffer(body, "<i8", count=m, offset=_DELETE_HEAD.size)
        return WalRecord(KIND_DELETE, lsn, generation,
                         ids=ids.astype(np.int64, copy=True))
    if kind == KIND_COMPACT:
        if len(body) != _COMPACT_BODY.size:
            raise ValueError("compact marker body length mismatch")
        n_live, next_id = _COMPACT_BODY.unpack(body)
        return WalRecord(KIND_COMPACT, lsn, generation,
                         n_live=int(n_live), next_id=int(next_id))
    raise ValueError(f"unknown record kind {kind}")


# ------------------------------------------------------------- reading --
def segment_path(directory: str, seg: int) -> str:
    return os.path.join(directory, f"{SEGMENT_PREFIX}{seg:08d}{SEGMENT_SUFFIX}")


def list_segments(directory: str) -> list[int]:
    """Segment indexes present under ``directory``, ascending."""
    out = []
    for name in os.listdir(directory):
        if name.startswith(SEGMENT_PREFIX) and name.endswith(SEGMENT_SUFFIX):
            digits = name[len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)]
            if digits.isdigit():
                out.append(int(digits))
    return sorted(out)


def scan_segment(path: str) -> tuple[list[WalRecord], int, bool]:
    """Parse one segment: ``(records, valid_prefix_bytes, damaged)``.

    ``valid_prefix_bytes`` is where appends may safely resume (end of the
    last good record); ``damaged`` is True when the file holds bytes past
    that point — a torn tail or bit rot. Never raises on corruption: the
    valid prefix is the answer.
    """
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < len(SEGMENT_MAGIC) or blob[: len(SEGMENT_MAGIC)] != SEGMENT_MAGIC:
        return [], 0, len(blob) > 0
    records: list[WalRecord] = []
    off = len(SEGMENT_MAGIC)
    last_lsn = -1
    while off < len(blob):
        if off + _HEADER.size > len(blob):
            return records, off, True  # torn header
        length, crc = _HEADER.unpack_from(blob, off)
        if length > MAX_RECORD_BYTES or off + _HEADER.size + length > len(blob):
            return records, off, True  # insane length or torn payload
        payload = blob[off + _HEADER.size: off + _HEADER.size + length]
        if zlib.crc32(payload) != crc:
            return records, off, True  # checksum mismatch
        try:
            rec = decode_record(payload)
        except ValueError:
            return records, off, True  # framed but undecodable
        if last_lsn >= 0 and rec.lsn != last_lsn + 1:
            # LSNs are assigned and written contiguously, so a gap means a
            # lost write in the middle (e.g. a dropped sector), not a tail:
            # everything from the gap on is untrusted history
            return records, off, True
        last_lsn = rec.lsn
        records.append(rec)
        off += _HEADER.size + length
    return records, off, False


def read_wal(directory: str) -> list[WalRecord]:
    """All records recoverable from ``directory`` in LSN order, stopping
    at the first damaged point (everything after a torn record is
    untrusted, including later segments)."""
    records: list[WalRecord] = []
    last_lsn = -1
    for seg in list_segments(directory):
        recs, _valid, damaged = scan_segment(segment_path(directory, seg))
        for rec in recs:
            if last_lsn >= 0 and rec.lsn != last_lsn + 1:
                return records  # cross-segment LSN gap: stop trusting
            last_lsn = rec.lsn
            records.append(rec)
        if damaged:
            break
    return records


# ------------------------------------------------------------- writing --
class FaultInjectingFile:
    """Crash-harness wrapper around a binary segment file.

    Applies one fault at an absolute byte ``offset`` of the stream
    written *through this wrapper*:

    * ``"truncate"`` — bytes from ``offset`` on are silently discarded
      forever (a power cut mid-write: the prefix hit the platter, the
      tail did not);
    * ``"drop"`` — the single ``write()`` call whose range covers
      ``offset`` is discarded, later writes go through (a lost sector);
    * ``"bitflip"`` — the byte at ``offset`` has its low bit flipped
      (media rot under a valid length prefix).

    ``fsync`` on the wrapped fileno still works, so the WAL's durability
    path is exercised unchanged.
    """

    def __init__(self, raw, *, mode: str, offset: int):
        if mode not in ("truncate", "drop", "bitflip"):
            raise ValueError(f"unknown fault mode {mode!r}")
        self._raw = raw
        self._mode = mode
        self._offset = int(offset)
        self._written = 0
        self.faults_applied = 0

    def write(self, data: bytes) -> int:
        lo, hi = self._written, self._written + len(data)
        self._written = hi
        covers = lo <= self._offset < hi
        if self._mode == "truncate":
            if hi <= self._offset:
                self._raw.write(data)
            elif lo >= self._offset:
                self.faults_applied += 1
            else:
                self._raw.write(data[: self._offset - lo])
                self.faults_applied += 1
            return len(data)
        if self._mode == "drop":
            if covers:
                self.faults_applied += 1
                return len(data)
            self._raw.write(data)
            return len(data)
        if covers:  # bitflip
            buf = bytearray(data)
            buf[self._offset - lo] ^= 1
            data = bytes(buf)
            self.faults_applied += 1
        self._raw.write(data)
        return len(data)

    def fileno(self) -> int:
        return self._raw.fileno()

    def close(self) -> None:
        self._raw.close()


def _default_file_factory(path: str):
    # unbuffered: write() hands bytes to the kernel, fsync makes them
    # durable — no hidden userspace buffer to lose on its own schedule
    return open(path, "ab", buffering=0)


class WriteAheadLog:
    """Segmented append-only log with group commit.

    Thread model: any number of appenders; at most one *flusher* at a
    time (a baton guarded by ``_mu``). ``append_*`` assigns the LSN and
    queues encoded bytes under ``_mu`` — memory only, safe under the
    index lock. :meth:`flush` claims the baton, swaps out the pending
    batch, **releases the lock**, then writes + fsyncs; waiters park on
    the condition until ``durable_lsn`` covers them. Rotation and
    retirement run on whichever thread holds the baton.
    """

    def __init__(
        self,
        directory: str,
        *,
        segment_bytes: int = DEFAULT_SEGMENT_BYTES,
        fsync: bool = True,
        file_factory=None,
    ):
        self.directory = str(directory)
        self.segment_bytes = int(segment_bytes)
        self.fsync_enabled = bool(fsync)
        self._file_factory = file_factory or _default_file_factory
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._pending: list[tuple[int, bytes]] = []
        self._flushing = False
        self._closed = False
        self._error: BaseException | None = None
        self._file = None
        # counters (all guarded by _mu)
        self.appends = 0
        self.fsyncs = 0
        self.group_commits = 0
        self.group_records = 0
        self.max_group = 0
        self.bytes_appended = 0
        self.segments_created = 0
        self.segments_retired = 0
        self.records_recovered = 0
        self.records_replayed = 0  # set by persistence after replay
        os.makedirs(self.directory, exist_ok=True)
        self._recovered: list[WalRecord] = []
        self._segment_last: dict[int, int] = {}  # seg -> last LSN written
        self._open_for_append()

    # ------------------------------------------------------------ open --
    def _open_for_append(self) -> None:
        """Scan existing segments, truncate any torn tail, and resume the
        LSN counter after the last good record."""
        segs = list_segments(self.directory)
        last_lsn = -1
        damaged_at = None
        for seg in segs:
            recs, valid, damaged = scan_segment(segment_path(self.directory, seg))
            if recs and last_lsn >= 0 and recs[0].lsn != last_lsn + 1:
                # LSN discontinuity across the segment boundary: the
                # earlier history is authoritative, this segment is not
                damaged_at = (seg, len(SEGMENT_MAGIC))
                break
            if recs:
                last_lsn = recs[-1].lsn
                self._segment_last[seg] = last_lsn
            self._recovered.extend(recs)
            if damaged:
                damaged_at = (seg, valid)
                break
        if damaged_at is not None:
            seg, valid = damaged_at
            # drop everything past the damage: the torn segment is cut at
            # its last good record, later segments are untrusted history
            os.truncate(segment_path(self.directory, seg),
                        max(valid, len(SEGMENT_MAGIC)) if valid else 0)
            for later in segs:
                if later > seg:
                    os.unlink(segment_path(self.directory, later))
                    self._segment_last.pop(later, None)
            if valid == 0:
                # magic itself was torn: rewrite the header in place
                with open(segment_path(self.directory, seg), "wb") as f:
                    f.write(SEGMENT_MAGIC)
            segs = [s for s in segs if s <= seg]
        self.records_recovered = len(self._recovered)
        self._next_lsn = last_lsn + 1
        self._durable_lsn = last_lsn
        self._last_enqueued = last_lsn
        if segs:
            self._segment = segs[-1]
            path = segment_path(self.directory, self._segment)
            self._segment_written = os.path.getsize(path)
            self._file = self._file_factory(path)
            if self._segment_written < len(SEGMENT_MAGIC):
                # a crash between segment creation and the magic write
                # leaves an empty file; finish the header before appending
                self._file.write(SEGMENT_MAGIC[self._segment_written:])
                self._segment_written = len(SEGMENT_MAGIC)
        else:
            self._segment = 0
            self._file = self._new_segment_file(0)
            self._segment_written = len(SEGMENT_MAGIC)

    def _new_segment_file(self, seg: int):
        path = segment_path(self.directory, seg)
        f = self._file_factory(path)
        f.write(SEGMENT_MAGIC)
        if self.fsync_enabled:
            os.fsync(f.fileno())
        self.segments_created += 1
        return f

    def take_recovered(self) -> list[WalRecord]:
        """The records found on open (consumed once; replay then frees
        the memory — insert records carry their vectors)."""
        recs, self._recovered = self._recovered, []
        return recs

    # ---------------------------------------------------------- append --
    def _enqueue(self, encode, *args) -> int:
        with self._mu:
            if self._closed:
                raise WalError("write-ahead log is closed")
            if self._error is not None:
                raise WalError("write-ahead log failed") from self._error
            lsn = self._next_lsn
            self._next_lsn += 1
            payload = encode(lsn, *args)
            self._pending.append((lsn, frame(payload)))
            self._last_enqueued = lsn
            self.appends += 1
            _M_APPENDS.inc()
        return lsn

    def append_insert(self, ids, vectors, *, generation: int) -> int:
        """Queue an insert-batch record; returns its LSN. Memory only —
        call :meth:`flush`/:meth:`kick` (outside any index lock) to make
        it durable."""
        return self._enqueue(
            lambda lsn, g, i, v: encode_insert(lsn, g, i, v),
            generation, ids, vectors,
        )

    def append_delete(self, ids, *, generation: int) -> int:
        return self._enqueue(
            lambda lsn, g, i: encode_delete(lsn, g, i), generation, ids
        )

    def append_compact(self, *, generation: int, n_live: int, next_id: int) -> int:
        return self._enqueue(
            lambda lsn, g, n, x: encode_compact(lsn, g, n, x),
            generation, n_live, next_id,
        )

    # ----------------------------------------------------------- flush --
    def flush(self, wait_lsn: int | None = None) -> int:
        """Make every record up to ``wait_lsn`` (default: everything
        enqueued so far) durable; returns the durable LSN. The calling
        thread performs the write + fsync itself when the baton is free
        — ``durability="sync"`` callers pay their own fsync — otherwise
        it parks until the in-flight group commit covers it."""
        while True:
            with self._mu:
                if wait_lsn is None:
                    wait_lsn = self._last_enqueued
                if self._error is not None:
                    raise WalError("write-ahead log failed") from self._error
                if self._durable_lsn >= wait_lsn:
                    return self._durable_lsn
                if self._flushing:
                    self._cv.wait(timeout=1.0)
                    continue
                batch = self._pending
                self._pending = []
                self._flushing = True
                f = self._file
                seg_written = self._segment_written
            self._write_batch(f, batch, seg_written)

    def _write_batch(self, f, batch: list[tuple[int, bytes]], seg_written: int):
        """One group commit (baton held, no lock): write, fsync, rotate."""
        data = b"".join(b for _, b in batch)
        new_file = None
        err = None
        t0 = obsm.now()
        span = obst.default_tracer().start_trace(
            "wal-flush", records=len(batch), bytes=len(data)
        ) if batch else obst.NULL_SPAN
        try:
            if data:
                f.write(data)
                if self.fsync_enabled:
                    with span.child("fsync"), obsm.timed(_M_FSYNC_SECONDS):
                        os.fsync(f.fileno())
            if seg_written + len(data) >= self.segment_bytes:
                new_file = self._new_segment_file(self._segment + 1)
        except BaseException as e:  # noqa: BLE001 - recorded, re-raised below
            err = e
        span.finish(error=err is not None)
        if batch:
            _M_FLUSH_SECONDS.observe(obsm.now() - t0)
            _M_GROUP_RECORDS.observe(len(batch))
        old_file = None
        with self._mu:
            if err is not None:
                self._error = err
            else:
                if batch:
                    self._durable_lsn = batch[-1][0]
                    self._segment_last[self._segment] = batch[-1][0]
                self._segment_written = seg_written + len(data)
                self.bytes_appended += len(data)
                _M_APPEND_BYTES.inc(len(data))
                if self.fsync_enabled and data:
                    self.fsyncs += 1
                    _M_FSYNCS.inc()
                if batch:
                    self.group_commits += 1
                    self.group_records += len(batch)
                    self.max_group = max(self.max_group, len(batch))
                if new_file is not None:
                    old_file = self._file
                    self._file = new_file
                    self._segment += 1
                    self._segment_written = len(SEGMENT_MAGIC)
            self._flushing = False
            self._cv.notify_all()
        if old_file is not None:
            old_file.close()
        if err is not None:
            raise WalError("write-ahead log write failed") from err

    def kick(self, pool=None) -> None:
        """Schedule a group commit on the shared WorkerPool (coalesced:
        at most one queued flush task per log). ``durability="async"``."""
        if pool is None:
            pool = get_shared_pool()
        pool.submit_coalesced(self._flush_task, key=("wal-flush", id(self)),
                              label="wal-flush")

    def _flush_task(self) -> None:
        try:
            self.flush()
        except WalError:
            pass  # recorded in _error; surfaces on the next append/flush

    # ------------------------------------------------------ checkpoint --
    def position(self) -> tuple[int, int]:
        """(active segment, last enqueued LSN) — the snapshot watermark.
        Called under the owning index's lock, so the watermark is exactly
        the mutation history the snapshot reflects (memory only)."""
        with self._mu:
            return self._segment, self._last_enqueued

    @property
    def durable_lsn(self) -> int:
        with self._mu:
            return self._durable_lsn

    def checkpoint(self, watermark_lsn: int) -> int:
        """A snapshot covering ``watermark_lsn`` is durable: rotate the
        active segment and delete every segment whose records are all
        covered. Returns the number of segments retired."""
        self.flush()
        retire = []
        with self._mu:
            while self._flushing:  # claim the baton like flush() does
                self._cv.wait(timeout=1.0)
            self._flushing = True
            seg = self._segment
        new_file = None
        try:
            new_file = self._new_segment_file(seg + 1)
        finally:
            old_file = None
            with self._mu:
                if new_file is not None:
                    old_file = self._file
                    self._file = new_file
                    self._segment = seg + 1
                    self._segment_written = len(SEGMENT_MAGIC)
                for s, last in list(self._segment_last.items()):
                    if s < self._segment and last <= watermark_lsn:
                        retire.append(s)
                        del self._segment_last[s]
                self._flushing = False
                self._cv.notify_all()
            if old_file is not None:
                old_file.close()
        for s in retire:
            # an empty rotated-away segment (magic only) also retires
            try:
                os.unlink(segment_path(self.directory, s))
            except FileNotFoundError:
                pass
        with self._mu:
            self.segments_retired += len(retire)
        # magic-only segments below the active one carry no records and
        # never enter _segment_last; sweep them too so the dir stays tidy
        for s in list_segments(self.directory):
            if s < self._segment and s not in self._segment_last:
                path = segment_path(self.directory, s)
                try:
                    if os.path.getsize(path) <= len(SEGMENT_MAGIC):
                        os.unlink(path)
                except OSError:
                    pass
        return len(retire)

    # ----------------------------------------------------------- close --
    def close(self) -> None:
        """Flush everything pending and close the active segment."""
        with self._mu:
            if self._closed:
                return
        try:
            self.flush()
        except WalError:
            pass
        with self._mu:
            self._closed = True
            f, self._file = self._file, None
        if f is not None:
            f.close()

    def __enter__(self) -> "WriteAheadLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------------- stats --
    def stats(self) -> dict:
        with self._mu:
            return {
                "appends": self.appends,
                "fsyncs": self.fsyncs,
                "group_commits": self.group_commits,
                "mean_group": (
                    self.group_records / self.group_commits
                    if self.group_commits else 0.0
                ),
                "max_group": self.max_group,
                "bytes_appended": self.bytes_appended,
                "segment": self._segment,
                "segments_created": self.segments_created,
                "segments_retired": self.segments_retired,
                "pending": len(self._pending),
                "durable_lsn": self._durable_lsn,
                "last_lsn": self._last_enqueued,
                "records_recovered": self.records_recovered,
                "records_replayed": self.records_replayed,
            }

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        s = self.stats()
        return (f"WriteAheadLog({self.directory!r}, segment={s['segment']}, "
                f"lsn={s['last_lsn']}, durable={s['durable_lsn']})")
