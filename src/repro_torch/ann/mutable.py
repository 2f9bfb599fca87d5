"""Mutable ANN index — a log-structured delta segment over an immutable base
(mirrors ``repro.ann.mutable``).

Production corpora churn. The index serves mutations from a small
append-only **delta segment** (brute-force-scanned per query, which is
*exact*) plus a **tombstone bitmap** over the immutable base, and folds
both back into a fresh :class:`~repro_torch.ann.AnnIndex` build whenever a
:class:`~repro_torch.ann.compaction.CompactionPolicy` says the churn has
earned a rebuild.

Search semantics
----------------
``search()`` fans out to the base searcher and an exact top-k scan of the
live delta rows, then merges the two streams distance-major / id-minor —
the order both re-rank pipelines produce. How the base leaves tombstones
out depends on the pipeline:

  * ``masked_full``: the base is asked for ``k`` and handed the tombstones
    as an exclusion bitmap (``ceil(n/32)`` words, packed once per
    snapshot and kept on the index's device); the masked re-rank never
    scores a tombstoned row. The reference over-fetches ``k +
    next_pow2(#tombstones)`` and masks afterwards, which the kernel's
    ``k <= 1024`` could not serve past 512 tombstones. Both return the same
    rows: masked-full has no candidate cap, a row's distance does not
    depend on k, and the histogram (so the threshold and
    ``candidate_count``) still counts tombstoned rows either way.
  * ``gather``: the reference's over-fetch as it is, since there ``base_k``
    also raises the candidate cap and so changes which candidates are
    selected. Above 16,384 tombstones the cap (and the (Q, cap, d)
    candidate gather) grows with the over-fetch.

The delta scan and the tombstone exclusion are exact, so a mutable search
differs from a from-scratch rebuild over the live corpus only through the
base segment's subspace-collision approximation: immediately after
:meth:`compact` the results are those of ``AnnIndex.build(live_corpus)``
(compaction IS that build, modulo the stable-external-id translation), and
before compaction they equal it whenever candidate selection is exhaustive
(``selection="fixed", beta=1.0``).

External ids are stable and never reused: base rows keep their build-time
row ids, inserts are numbered monotonically from there, and compaction
re-maps the fresh build's rows back to the surviving external ids.

Placement: the base index and every per-snapshot device array (delta rows
and norms, the exclusion bitmap) live on the index's device, the card
unless ``device="cpu"`` is asked for; the id maps, tombstones and delta
rows of record stay on the host as numpy arrays, which is what the
write-ahead log, persistence and the merge read.

Concurrency: every mutation replaces ``self._state`` (an immutable
snapshot) under a lock, so a concurrent search sees either the old or the
new state, never a torn one. No device work and no host-device copy runs
under the lock. Background compaction builds from a snapshot while a
mutation log accumulates, then replays the log onto the fresh state at
install time (see :mod:`repro_torch.ann.compaction`).

Durability (:mod:`repro_torch.ann.wal`): with ``durability="sync"`` or
``"async"`` every mutation appends a checksummed record to a durable
write-ahead log *before* the state snapshot is installed — the append is
memory-only under the lock, the fsync happens on the caller's path (sync)
or via a group-commit flusher task on the shared WorkerPool (async). A
kill -9 mid-churn replays the log past the last snapshot's watermark back
to the pre-crash state (see
:func:`repro_torch.ann.persistence.load_mutable_index`).

Serving: :meth:`MutableAnnIndex.engine` wraps a :class:`MutableSearcher`
in an :class:`~repro_torch.serving.ann_engine.AnnServingEngine` wired for
churn — every mutation bumps the engine's ``index_generation`` and drops
its result cache, and the engine's recall probes sample the live corpus.
"""
from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

from repro_torch.ann.compaction import CompactionPolicy, CompactionReport  # noqa: F401
from repro_torch.ann.index import AnnIndex
from repro_torch.ann.searcher import AnnBatchResult, Searcher, first_by_distance, sq_dists_to
from repro_torch.batching import ANN_BATCH_BUCKETS
from repro_torch.core.config import SCConfig, resolve_rerank
from repro_torch.kernels.masked_rerank import pack_exclusion
from repro_torch.obs import metrics as obsm
from repro_torch.obs import trace as obst
from repro_torch.utils import resolve_device, topk_smallest

# Process-wide mutation metric families (repro_torch.obs registry).
_M_MUTATIONS = obsm.counter(
    "taco_mutable_rows_total", "Rows mutated on any mutable index, by kind",
    labelnames=("kind",),
)
_M_ROWS_INSERTED = _M_MUTATIONS.labels(kind="insert")
_M_ROWS_DELETED = _M_MUTATIONS.labels(kind="delete")
_M_LIVE_ROWS = obsm.gauge(
    "taco_mutable_live_rows", "Live rows (base - tombstones + delta live)"
)


def _pow2ceil(x: int) -> int:
    """0 -> 0, else the next power of two >= x (buckets the gather
    pipeline's tombstone over-fetch and the delta pad)."""
    return 0 if x <= 0 else 1 << (int(x) - 1).bit_length()


class _State:
    """One immutable snapshot of the mutable index.

    Mutations never modify a snapshot's arrays in place — they build a new
    snapshot and atomically replace the owner's ``_state`` reference, so a
    search that grabbed a snapshot keeps computing against a consistent
    view. ``base_ids`` is sorted ascending (build order, preserved by
    compaction), which makes id lookup a searchsorted and means the live
    corpus enumerated base-then-delta is in external-id order. The device
    arrays (:meth:`delta_padded`, :meth:`exclusion`, :meth:`base_ids_on_device`,
    :meth:`tombstones_on_device`) are made at first use, outside any lock,
    and cached per snapshot; a snapshot that shares an array with its
    predecessor shares its device copy too.
    """

    __slots__ = (
        "base", "base_ids", "tombstones", "n_tombstones",
        "delta", "delta_ids", "delta_live", "device",
        "_delta_pad", "_base_data_np", "_exclusion", "_base_ids_t", "_tombstones_t",
    )

    def __init__(self, base, base_ids, tombstones, delta, delta_ids, delta_live, device,
                 n_tombstones: int | None = None):
        self.base: AnnIndex | None = base
        self.base_ids: np.ndarray = base_ids  # (n_base,) int32, ascending
        self.tombstones: np.ndarray = tombstones  # (n_base,) bool
        # counted once per tombstone mask, not per snapshot: a pass over
        # n_base bools would cost every insert O(n_base)
        self.n_tombstones = int(tombstones.sum()) if n_tombstones is None else n_tombstones
        self.delta: np.ndarray = delta  # (m, d) float32, insertion order
        self.delta_ids: np.ndarray = delta_ids  # (m,) int32, ascending
        self.delta_live: np.ndarray = delta_live  # (m,) bool
        self.device: torch.device = device
        self._delta_pad = None
        self._base_data_np = None
        self._exclusion = None
        self._base_ids_t = None
        self._tombstones_t = None

    # ------------------------------------------------------------- views --
    @property
    def n_base(self) -> int:
        return int(self.base_ids.shape[0])

    @property
    def n_delta_rows(self) -> int:
        return int(self.delta.shape[0])

    @property
    def n_delta_live(self) -> int:
        return int(self.delta_live.sum())

    @property
    def n_live(self) -> int:
        return self.n_base - self.n_tombstones + self.n_delta_live

    def base_data(self) -> np.ndarray:
        """Host copy of the base corpus (cached per snapshot)."""
        if self._base_data_np is None:
            self._base_data_np = self.base.sc_index.data.cpu().numpy()
        return self._base_data_np

    def live_corpus(self) -> tuple[np.ndarray, np.ndarray]:
        """(vectors (L, d), external ids (L,)) in external-id order, on the
        host."""
        parts_v, parts_i = [], []
        if self.base is not None and self.n_base:
            alive = ~self.tombstones
            parts_v.append(self.base_data()[alive])
            parts_i.append(self.base_ids[alive])
        if self.n_delta_rows:
            parts_v.append(self.delta[self.delta_live])
            parts_i.append(self.delta_ids[self.delta_live])
        if not parts_v:
            d = self.delta.shape[1]
            return np.empty((0, d), np.float32), np.empty((0,), np.int32)
        return (
            np.ascontiguousarray(np.concatenate(parts_v)),
            np.concatenate(parts_i),
        )

    def live_corpus_on_device(self) -> tuple[torch.Tensor, np.ndarray]:
        """:meth:`live_corpus` with the vectors gathered on the index's
        device (the base rows never visit the host): what compaction
        builds from."""
        parts_v, parts_i = [], []
        if self.base is not None and self.n_base:
            alive = ~self.tombstones
            keep = torch.from_numpy(np.flatnonzero(alive)).to(self.device)
            parts_v.append(self.base.sc_index.data[keep])
            parts_i.append(self.base_ids[alive])
        if self.n_delta_rows:
            parts_v.append(torch.from_numpy(self.delta[self.delta_live]).to(self.device))
            parts_i.append(self.delta_ids[self.delta_live])
        if not parts_v:
            d = self.delta.shape[1]
            return (torch.empty((0, d), dtype=torch.float32, device=self.device),
                    np.empty((0,), np.int32))
        return torch.cat(parts_v).contiguous(), np.concatenate(parts_i)

    def delta_padded(self):
        """Delta rows padded up a power-of-two ladder, on the index's
        device: (rows (m_pad, d), ``||x||^2`` norms (m_pad,), live mask
        (m_pad,), ids (m_pad,) int32) — cached per snapshot so repeated
        queries share one copy + norm pass. Pad rows are zero vectors with
        ``live=False``: the scan masks them to +inf, so they can never
        enter a top-k."""
        if self._delta_pad is None:
            m = self.n_delta_rows
            m_pad = max(8, _pow2ceil(m))
            rows = np.zeros((m_pad, self.delta.shape[1]), np.float32)
            rows[:m] = self.delta
            live = np.zeros((m_pad,), bool)
            live[:m] = self.delta_live
            ids = np.full((m_pad,), -1, np.int32)
            ids[:m] = self.delta_ids
            rows_t = torch.from_numpy(rows).to(self.device)
            norms = torch.sum(rows_t * rows_t, dim=1)
            self._delta_pad = (rows_t, norms, torch.from_numpy(live).to(self.device),
                               torch.from_numpy(ids).to(self.device))
        return self._delta_pad

    def base_ids_on_device(self) -> torch.Tensor:
        """``base_ids`` on the index's device (maps the base's rows to
        external ids where the search merges)."""
        if self._base_ids_t is None:
            self._base_ids_t = torch.from_numpy(self.base_ids).to(self.device)
        return self._base_ids_t

    def tombstones_on_device(self) -> torch.Tensor:
        """``tombstones`` on the index's device (masks the gather
        pipeline's over-fetched rows)."""
        if self._tombstones_t is None:
            self._tombstones_t = torch.from_numpy(self.tombstones).to(self.device)
        return self._tombstones_t

    def exclusion(self) -> torch.Tensor | None:
        """The tombstones as the masked re-rank's exclusion bitmap
        (``ceil(n_base/32)`` int32 words) on the index's device, or None
        when nothing is tombstoned (the kernel then reads no bitmap).
        Cached per snapshot."""
        if self.n_tombstones == 0:
            return None
        if self._exclusion is None:
            self._exclusion = pack_exclusion(self.tombstones).to(self.device)
        return self._exclusion

    def replace(self, **kw) -> "_State":
        fields = dict(
            base=self.base, base_ids=self.base_ids, tombstones=self.tombstones,
            delta=self.delta, delta_ids=self.delta_ids, delta_live=self.delta_live,
            device=self.device,
        )
        fields.update(kw)
        same_tombs = fields["tombstones"] is self.tombstones
        if same_tombs and "n_tombstones" not in kw:
            fields["n_tombstones"] = self.n_tombstones
        st = _State(**fields)
        if fields["base"] is self.base:
            st._base_data_np = self._base_data_np  # host copy survives
            if fields["base_ids"] is self.base_ids:
                st._base_ids_t = self._base_ids_t
            if same_tombs:  # same tombstones, same bitmap and mask
                st._exclusion, st._tombstones_t = self._exclusion, self._tombstones_t
        return st


def _state_insert(st: _State, vectors: np.ndarray, ids: np.ndarray) -> _State:
    return st.replace(
        delta=np.concatenate([st.delta, vectors]),
        delta_ids=np.concatenate([st.delta_ids, ids]),
        delta_live=np.concatenate([st.delta_live, np.ones(len(ids), bool)]),
    )


def _state_delete(st: _State, ids: np.ndarray) -> _State:
    """Tombstone each id (base row or delta row); KeyError on a dead or
    unknown id — a delete must name a live vector. The ids are looked up
    together (both id maps are ascending); the error names the first
    offending id in the order given, as deleting them one by one would.
    A mask that no id touches is shared with the old snapshot, not copied
    (a batch of delta ids leaves the n_base tombstones as they are)."""
    arr = np.asarray(ids, np.int64).ravel()
    tomb, dlive = st.tombstones, st.delta_live
    # a repeat of an id earlier in the same batch finds it already dead
    _, first = np.unique(arr, return_index=True)
    repeat = np.ones(arr.size, bool)
    repeat[first] = False
    in_base = dead_base = live_delta = np.zeros(arr.size, bool)
    bpos = dpos = np.zeros(arr.size, np.int64)
    if st.n_base:
        bpos = np.minimum(np.searchsorted(st.base_ids, arr), st.n_base - 1)
        in_base = st.base_ids[bpos] == arr
        dead_base = tomb[bpos]
    if st.n_delta_rows:
        dpos = np.minimum(np.searchsorted(st.delta_ids, arr), st.n_delta_rows - 1)
        live_delta = (st.delta_ids[dpos] == arr) & dlive[dpos] & ~in_base
    bad_base = in_base & (dead_base | repeat)
    bad_other = ~in_base & ~(live_delta & ~repeat)
    bad = np.flatnonzero(bad_base | bad_other)
    if bad.size:
        j = int(bad[0])
        if in_base[j]:
            raise KeyError(f"id {int(arr[j])} was already deleted")
        raise KeyError(
            f"id {int(arr[j])} is not a live vector (already deleted or never "
            f"inserted)"
        )
    kw = {}
    if in_base.any():
        tomb = tomb.copy()
        tomb[bpos[in_base]] = True
        kw.update(tombstones=tomb, n_tombstones=st.n_tombstones + int(in_base.sum()))
    if live_delta.any():
        dlive = dlive.copy()
        dlive[dpos[live_delta]] = False
        kw.update(delta_live=dlive)
    return st.replace(**kw)


def _delta_topk(queries: torch.Tensor, rows: torch.Tensor, norms: torch.Tensor,
                live: torch.Tensor, k: int):
    """Exact top-k over the (padded) delta segment.

    The reference's exact re-rank (``repro.core.taco.rerank``) over every
    delta row: ``max(||q||^2 - 2 q.x + ||x||^2, 0)`` against the cached
    norms, so a delta hit's squared distance is the number a rebuilt index
    would report for that row — computed as one (Q, m_pad) product over
    the padded delta, never gathered per query. Returns (row ids (Q, k)
    into the padded delta, dists (Q, k)); dead/pad rows are masked to
    -1/inf, ties go to the lowest row.
    """
    q_norms = torch.sum(queries * queries, dim=1)
    dists = torch.clamp_min(q_norms[:, None] - 2.0 * (queries @ rows.T) + norms[None, :], 0.0)
    dists = torch.where(live[None, :], dists, torch.inf)
    top_d, pos = topk_smallest(dists, k)
    filled = torch.isfinite(top_d)
    return (torch.where(filled, pos.to(torch.int32), -1),
            torch.where(filled, top_d, torch.inf))


def _merge_topk(streams, k: int, bucket: int, device):
    """Merge per-query (ids, dists) streams into one canonical top-k.

    Two stable sorts (id-minor, then distance-major) — the order
    :func:`repro_torch.kernels.masked_rerank.finalize_topk` and the gather
    pipeline's stable top-k over id-ordered candidates produce, so the
    merged stream breaks distance ties the way a from-scratch rebuild over
    the id-ordered live corpus would. Dead entries ride in as (id -1, dist
    inf) and sink. The streams are tensors on ``device``, where the merge
    runs (the reference merges on the host with numpy's stable argsorts;
    the order is the same). Returns (ids (bucket, k) int32, dists (bucket,
    k) float32) on ``device``.
    """
    if not streams:
        return (
            torch.full((bucket, k), -1, dtype=torch.int32, device=device),
            torch.full((bucket, k), torch.inf, dtype=torch.float32, device=device),
        )
    all_i = torch.cat([s[0] for s in streams], dim=1)
    all_d = torch.cat([s[1] for s in streams], dim=1)
    if all_i.shape[1] < k:  # fewer total slots than k: pad before selecting
        pad = k - all_i.shape[1]
        all_i = torch.cat([all_i, all_i.new_full((bucket, pad), -1)], dim=1)
        all_d = torch.cat([all_d, all_d.new_full((bucket, pad), torch.inf)], dim=1)
    i1, o1 = torch.sort(all_i, dim=1, stable=True)
    d1 = torch.gather(all_d, 1, o1)
    d2, o2 = torch.sort(d1, dim=1, stable=True)
    ids = torch.gather(i1, 1, o2)[:, :k]
    dists = d2[:, :k]
    ids = torch.where(torch.isfinite(dists), ids, -1)
    return ids, dists


def base_fetch_k(st: _State, k: int, cfg: SCConfig) -> int:
    """How many rows a batch asks the base for: ``k`` for masked-full (the
    tombstones are excluded in the kernel), the reference's
    ``k + next_pow2(#tombstones)`` over-fetch for gather. At most the base
    size."""
    if resolve_rerank(cfg) == "masked_full":
        return min(st.n_base, k)
    return min(st.n_base, k + _pow2ceil(st.n_tombstones))


class MutableSearcher(Searcher):
    """Fan-out searcher over (base − tombstones) ∪ delta.

    Reads the owning :class:`MutableAnnIndex`'s current state snapshot per
    padded batch, so one searcher (and the engine built on it) stays valid
    across mutations AND compactions — the base query functions live on
    each base index's own single-device searcher and survive for as long as
    that base does. Single-device placement only.
    """

    shards = 1

    def __init__(self, mutable: "MutableAnnIndex", *, buckets=ANN_BATCH_BUCKETS):
        # deliberately NOT calling Searcher.__init__: there is no single
        # immutable index to bind; everything routes through `mutable`
        self.mutable = mutable
        self.cfg = mutable.cfg
        self.buckets = tuple(buckets)

    # ------------------------------------------------------------- shims --
    @property
    def index(self):
        """The CURRENT base SCIndex (None while running delta-only)."""
        st = self.mutable._state
        return None if st.base is None else st.base.sc_index

    def _base_searcher(self, st: _State):
        return None if st.base is None else st.base._default_searcher()

    @property
    def _fns(self):
        s = self._base_searcher(self.mutable._state)
        return s._fns if s is not None else {}

    @property
    def compile_counts(self):
        s = self._base_searcher(self.mutable._state)
        return s.compile_counts if s is not None else {}

    @property
    def device(self) -> torch.device:
        return self.mutable.device

    @property
    def dim(self) -> int:
        return self.mutable.d

    @property
    def max_k(self) -> int:
        return max(1, self.mutable._state.n_live)

    def extra_telemetry(self) -> dict:
        return {"mutable": self.mutable.stats()}

    def probe_corpus(self):
        return self.mutable.live_corpus()

    def probe_topk(self, query, k: int) -> np.ndarray | None:
        """:meth:`Searcher.probe_topk` over the live corpus of one snapshot,
        on the index's device: the base rows with the tombstones masked
        (the base is never gathered or copied) and the live delta rows.
        Base rows then delta rows run in ascending external id (see
        :class:`_State`), so a stable sort by distance orders by (distance,
        id)."""
        st = self.mutable._state
        if st.n_live == 0:
            return None
        q = torch.from_numpy(np.asarray(query, np.float32)).to(st.device)
        dists, ids = [], []
        if st.base is not None and st.n_base:
            d = sq_dists_to(st.base.sc_index.data, q)
            if st.n_tombstones:
                d = torch.where(st.tombstones_on_device(), torch.inf, d)
            dists.append(d)
            ids.append(st.base_ids_on_device())
        if st.n_delta_rows:
            rows, _norms, live, delta_ids = st.delta_padded()
            dists.append(torch.where(live, sq_dists_to(rows, q), torch.inf))
            ids.append(delta_ids)
        return first_by_distance(torch.cat(dists), torch.cat(ids), min(k, st.n_live))

    # -------------------------------------------------------------- run --
    def run_padded(self, bucket, k, cfg: SCConfig, queries) -> AnnBatchResult:
        """One padded batch: the base's rows mapped to external ids, the
        delta scan and the merge all run on the index's device; the
        (bucket, k) result and the O(bucket) stats are copied to the host
        once, at the end."""
        st = self.mutable._state  # one atomic snapshot for the whole batch
        dev = self.mutable.device
        streams = []
        truncated = torch.zeros((bucket,), dtype=torch.bool, device=dev)
        count = torch.zeros((bucket,), dtype=torch.int32, device=dev)

        if st.base is not None and st.n_base:
            masked = resolve_rerank(cfg) == "masked_full"
            rows, dists, truncated, base_count = st.base._default_searcher().run_padded_device(
                bucket, base_fetch_k(st, k, cfg), cfg, queries,
                exclude=st.exclusion() if masked else None)
            rows = rows.long()
            safe = rows.clamp_min(0)
            dead = rows < 0  # masked-full: tombstoned rows never come back
            if not masked:
                dead = dead | st.tombstones_on_device()[safe]
            streams.append((
                torch.where(dead, -1, st.base_ids_on_device()[safe]),
                torch.where(dead, torch.inf, dists.to(torch.float32)),
            ))
            count = count + base_count.to(torch.int32)

        if st.n_delta_rows:
            rows, norms, live, ids = st.delta_padded()
            d_rows, d_dists = _delta_topk(queries, rows, norms, live, min(k, rows.shape[0]))
            dead = d_rows < 0
            streams.append((
                torch.where(dead, -1, ids[d_rows.long().clamp_min(0)]),
                torch.where(dead, torch.inf, d_dists),
            ))
            count = count + st.n_delta_live  # exact scan, per query

        ids, dists = _merge_topk(streams, k, bucket, dev)
        with obst.stage("searcher.to_host", dev):
            res = AnnBatchResult(
                ids=ids.cpu().numpy(), dists=dists.cpu().numpy(),
                truncated=truncated.cpu().numpy(), candidate_count=count.cpu().numpy(),
            )
        obst.settle_stages(batch=True)
        return res


def churn_wave(mutable, rng, live_ids, n_inserts: int, *, engine=None,
               background: bool = False):
    """One synthetic mutation wave for churn drivers and benchmarks: insert
    ``n_inserts`` Gaussian rows, delete ``n_inserts // 2`` random earlier
    inserts (tracked in ``live_ids``, mutated in place), then let the
    policy decide on compaction. Returns the
    :class:`~repro_torch.ann.compaction.CompactionReport` (or, with
    ``background=True``, the in-flight
    :class:`~repro_torch.ann.compaction.CompactionHandle`) or None."""
    fresh = rng.standard_normal((n_inserts, mutable.d)).astype(np.float32)
    live_ids.extend(int(i) for i in mutable.insert(fresh))
    kill = [live_ids.pop(rng.integers(len(live_ids)))
            for _ in range(min(n_inserts // 2, len(live_ids)))]
    if kill:
        mutable.delete(kill)
    return mutable.maybe_compact(engine=engine, background=background)


class MutableAnnIndex:
    """An :class:`AnnIndex` that accepts inserts and deletes.

    See the module docstring for semantics. Typical use::

        mutable = AnnIndex.build(data, cfg).mutable()   # on the card
        new_ids = mutable.insert(fresh_vectors)
        mutable.delete([3, 17])
        ids, dists = mutable.search(queries)
        report = mutable.maybe_compact()        # policy-driven rebuild
        mutable.save(path); MutableAnnIndex.load(path)  # mid-churn restart
    """

    def __init__(
        self,
        base: AnnIndex | None = None,
        *,
        cfg: SCConfig | None = None,
        dim: int | None = None,
        policy: CompactionPolicy | None = None,
        durability: str = "none",
        wal_dir: str | None = None,
        wal=None,
        wal_segment_bytes: int | None = None,
        device: str | torch.device = "cuda",
    ):
        if base is not None:
            cfg = base.cfg if cfg is None else cfg
            dim = base.d
            self.device = base.sc_index.device  # the base decides
        else:
            self.device = resolve_device(device)
        if cfg is None:
            raise ValueError("cfg is required when no base index is given")
        if dim is None:
            raise ValueError("dim is required when no base index is given")
        from repro_torch.ann.wal import DURABILITY_MODES, WriteAheadLog

        if durability not in DURABILITY_MODES:
            raise ValueError(
                f"durability={durability!r} (want one of {DURABILITY_MODES})"
            )
        if durability != "none" and wal is None and wal_dir is None:
            raise ValueError(f"durability={durability!r} requires wal_dir")
        if durability == "none" and (wal is not None or wal_dir is not None):
            raise ValueError("a WAL was given but durability='none'")
        self.durability = durability
        if wal is not None:
            self._wal = wal
        elif wal_dir is not None:
            kw = {} if wal_segment_bytes is None else {
                "segment_bytes": wal_segment_bytes
            }
            self._wal = WriteAheadLog(wal_dir, **kw)
        else:
            self._wal = None
        self._checkpoint_path: str | None = None
        self.cfg = cfg
        self.d = int(dim)
        self.policy = CompactionPolicy() if policy is None else policy
        n_base = base.n if base is not None else 0
        self._lock = threading.RLock()
        self._state = _State(
            base=base,
            base_ids=np.arange(n_base, dtype=np.int32),
            tombstones=np.zeros(n_base, bool),
            delta=np.empty((0, self.d), np.float32),
            delta_ids=np.empty((0,), np.int32),
            delta_live=np.empty((0,), bool),
            device=self.device,
        )
        self._next_id = n_base
        self.generation = 0  # bumps on every mutation and compaction install
        self._mutations = 0
        self._compactions = 0
        self._last_compaction_s: float | None = None
        self._log: list | None = None  # mutation log while compacting
        self._searcher: MutableSearcher | None = None
        self._engines: list = []  # weakrefs to attached serving engines

    # -------------------------------------------------------- construction --
    @classmethod
    def build(cls, data, cfg: SCConfig, *, policy=None,
              device: str | torch.device = "cuda") -> "MutableAnnIndex":
        """Build the immutable base over ``data`` on ``device`` and wrap it
        mutable."""
        return cls(AnnIndex.build(data, cfg, device=device), policy=policy)

    def _new_state(self, **fields) -> _State:
        return _State(device=self.device, **fields)

    # ------------------------------------------------------------ mutation --
    def insert(self, vectors) -> np.ndarray:
        """Append vectors to the delta segment; returns their new external
        ids (monotonic, never reused — a deleted-then-reinserted vector
        gets a fresh id). Accepts one (d,) vector or a (m, d) batch, as a
        numpy array or a tensor on any device."""
        if torch.is_tensor(vectors):
            vectors = vectors.detach().cpu().numpy()
        v = np.ascontiguousarray(np.asarray(vectors, np.float32))
        if v.ndim == 1:
            v = v[None]
        if v.ndim != 2 or v.shape[1] != self.d:
            raise ValueError(f"vectors shape {v.shape} != (m, {self.d})")
        span = obst.default_tracer().start_trace("insert", rows=int(v.shape[0]))
        with self._lock:
            ids = np.arange(self._next_id, self._next_id + v.shape[0],
                            dtype=np.int32)
            self._next_id += v.shape[0]
            lsn = None
            if self._wal is not None:
                # append BEFORE apply (memory only under the lock) so the
                # log order is exactly the apply order
                with span.child("wal-append"):
                    lsn = self._wal.append_insert(
                        ids, v, generation=self.generation + 1
                    )
            if self._log is not None:
                self._log.append(("insert", v, ids))
            engines = self._install(_state_insert(self._state, v, ids))
        _M_ROWS_INSERTED.inc(v.shape[0])
        with span.child("wal-commit", durability=self.durability):
            self._wal_commit(lsn)
        self._notify_engines(engines)
        span.finish()
        return ids

    def delete(self, ids) -> int:
        """Tombstone live vectors by external id; returns the count.
        Raises KeyError (mutating nothing) if any id is unknown or already
        deleted."""
        if torch.is_tensor(ids):
            ids = ids.detach().cpu().numpy()
        arr = np.atleast_1d(np.asarray(ids, np.int64))
        span = obst.default_tracer().start_trace("delete", rows=int(arr.size))
        with self._lock:
            new = _state_delete(self._state, arr)  # raises before any change
            lsn = None
            if self._wal is not None:
                with span.child("wal-append"):
                    lsn = self._wal.append_delete(
                        arr, generation=self.generation + 1
                    )
            if self._log is not None:
                self._log.append(("delete", arr.copy()))
            engines = self._install(new)
        _M_ROWS_DELETED.inc(arr.size)
        with span.child("wal-commit", durability=self.durability):
            self._wal_commit(lsn)
        self._notify_engines(engines)
        span.finish()
        return int(arr.size)

    def _wal_commit(self, lsn) -> None:
        """Durability step for one appended record, run AFTER the index
        lock is released: ``sync`` flushes + fsyncs on this (the caller's)
        thread, ``async`` schedules a coalesced group commit on the shared
        WorkerPool. File I/O never happens under ``self._lock``."""
        if lsn is None or self._wal is None:
            return
        if self.durability == "sync":
            self._wal.flush(lsn)
        else:
            self._wal.kick()

    def _install(self, st: _State) -> list:
        """Atomically publish a new state snapshot (callers hold the lock)
        and return the attached live engines; the CALLER must pass them to
        :meth:`_notify_engines` after releasing the lock.

        Notifying outside the lock keeps the lock order one-way (mutable
        lock -> engine lock would otherwise nest here, while the engine's
        drain worker holds its own lock for batch formation). The cost is
        a tiny window where a request can observe the new state before the
        engine's result cache is invalidated — such a hit serves a
        pre-install answer stamped with its (old) ``index_generation``, so
        the consumer can tell; the engine's own generation guard still
        prevents a result computed against the old state from entering the
        cache after the notify lands."""
        self._state = st
        self.generation += 1
        self._mutations += 1
        _M_LIVE_ROWS.set(st.n_live)
        alive, engines = [], []
        for ref in self._engines:
            eng = ref()
            if eng is None:
                continue
            alive.append(ref)
            engines.append(eng)
        self._engines = alive
        return engines

    @staticmethod
    def _notify_engines(engines: list) -> None:
        """Invalidate attached engines (generation bump + cache drop);
        called WITHOUT the mutable index's lock held."""
        for eng in engines:
            eng.notify_index_mutated()

    # -------------------------------------------------------------- query --
    def searcher(self, placement: str = "single") -> MutableSearcher:
        """The fan-out searcher (cached). Only single-device placement is
        supported."""
        if placement != "single":
            raise ValueError(
                f"MutableAnnIndex only supports placement='single' "
                f"(got {placement!r}); compact first to serve sharded"
            )
        if self._searcher is None:
            self._searcher = MutableSearcher(self)
        return self._searcher

    def search(self, queries, *, k=None, beta=None, rerank=None):
        return self.searcher().search(queries, k=k, beta=beta, rerank=rerank)

    def search_with_stats(self, queries, *, k=None, beta=None, rerank=None):
        return self.searcher().search_with_stats(
            queries, k=k, beta=beta, rerank=rerank
        )

    def engine(self, **engine_kwargs):
        """An :class:`~repro_torch.serving.ann_engine.AnnServingEngine`
        serving this mutable index. Mutations and compactions bump the
        engine's ``index_generation`` and drop its result cache; recall
        probes (``recall_probe_every=N``) run against the live corpus."""
        from repro_torch.serving.ann_engine import AnnServingEngine

        st = self._state
        eng = AnnServingEngine(
            None if st.base is None else st.base.sc_index,
            self.cfg,
            backend=self.searcher(),
            **engine_kwargs,
        )
        with self._lock:
            self._engines.append(weakref.ref(eng))
        return eng

    # ----------------------------------------------------------- lifecycle --
    def live_corpus(self) -> tuple[np.ndarray, np.ndarray]:
        """(vectors (L, d), external ids (L,)) on the host — the corpus a
        from-scratch rebuild would index, in external-id order."""
        return self._state.live_corpus()

    def rebuild_oracle(self) -> tuple[AnnIndex, np.ndarray]:
        """A from-scratch ``AnnIndex.build`` over the live corpus on the
        index's device plus the row -> external-id map; the parity oracle
        (compaction installs exactly this build)."""
        vecs, ids = self._state.live_corpus_on_device()
        return AnnIndex.build(vecs, self.cfg, device=self.device), ids

    def compact(self, *, engine=None, reason: str = "manual"):
        """Rebuild base+delta−tombstones into a fresh index and install it
        atomically; see :func:`repro_torch.ann.compaction.compact`."""
        from repro_torch.ann import compaction

        return compaction.compact(self, engine=engine, reason=reason)

    def compact_async(self, *, engine=None, reason: str = "background"):
        """:func:`repro_torch.ann.compaction.compact` on the shared
        WorkerPool; returns a
        :class:`~repro_torch.ann.compaction.CompactionHandle`."""
        from repro_torch.ann import compaction

        return compaction.compact_async(self, engine=engine, reason=reason)

    def maybe_compact(self, *, engine=None, background: bool = False):
        """Compact iff the policy's thresholds say the churn earned it.
        Returns the report (or handle when ``background``), else None."""
        reason = self.policy.reason(self.stats())
        if reason is None:
            return None
        if background:
            return self.compact_async(engine=engine, reason=reason)
        return self.compact(engine=engine, reason=reason)

    # Private compaction hooks (driven by repro_torch.ann.compaction) ------
    def _begin_compaction(self):
        """Start the mutation log; returns (snapshot, live vectors on the
        device, their external ids). The gather runs after the lock is
        released."""
        with self._lock:
            if self._log is not None:
                raise RuntimeError("a compaction is already in progress")
            self._log = []
            st = self._state
        vecs, ids = st.live_corpus_on_device()
        return st, vecs, ids

    def _abort_compaction(self):
        with self._lock:
            self._log = None

    def _finish_compaction(self, base, vecs, ids, *, engine=None, snapshot=None):
        """Install the freshly built base (None => delta-only state: the
        live corpus was too small to cluster; ``vecs`` is then a host
        array), replaying any mutations logged while the build ran.
        Returns (rows reclaimed, ops replayed)."""
        with self._lock:
            # reclaimed counts what the rebuild dropped from the SNAPSHOT it
            # was built over — rows inserted mid-build are replayed into the
            # fresh delta, not reclaimed
            snap = self._state if snapshot is None else snapshot
            reclaimed = (snap.n_base + snap.n_delta_rows) - len(ids)
            if base is not None:
                st = self._new_state(
                    base=base,
                    base_ids=np.asarray(ids, np.int32),
                    tombstones=np.zeros(len(ids), bool),
                    delta=np.empty((0, self.d), np.float32),
                    delta_ids=np.empty((0,), np.int32),
                    delta_live=np.empty((0,), bool),
                )
            else:
                st = self._new_state(
                    base=None,
                    base_ids=np.empty((0,), np.int32),
                    tombstones=np.empty((0,), bool),
                    delta=np.asarray(vecs, np.float32),
                    delta_ids=np.asarray(ids, np.int32),
                    delta_live=np.ones(len(ids), bool),
                )
            replayed = len(self._log)
            for op in self._log:
                if op[0] == "insert":
                    st = _state_insert(st, op[1], op[2])
                else:
                    st = _state_delete(st, op[1])
            self._log = None
            self._compactions += 1
            engines = self._install(st)
            lsn = None
            if self._wal is not None:
                # the marker records that the live corpus up to this LSN is
                # now base layout — replay treats it as a no-op, checkpoint
                # uses it to bound the log
                lsn = self._wal.append_compact(
                    generation=self.generation, n_live=st.n_live,
                    next_id=self._next_id,
                )
        # outside the lock: engine invalidation takes each engine's own
        # lock (see _install); swap_index below additionally records the
        # swap and re-binds an engine that was serving a DIFFERENT backend.
        self._wal_commit(lsn)
        self._notify_engines(engines)
        if engine is not None:
            engine.swap_index(self.searcher(), cfg=self.cfg)
        return reclaimed, replayed

    # -------------------------------------------------------- persistence --
    def save(self, path: str) -> str:
        """Persist base + delta + tombstones in ONE atomic manifest commit
        (:func:`repro_torch.ann.persistence.save_mutable_index`), in the
        reference's format. With a WAL attached the manifest records the
        (segment, LSN) watermark and the log checkpoints afterwards."""
        from repro_torch.ann.persistence import save_mutable_index

        return save_mutable_index(self, path)

    def checkpoint(self, path: str | None = None) -> str:
        """Snapshot to ``path`` (default: the last save/load directory)
        and bound the WAL there; compaction calls this when a checkpoint
        directory is known so the log never outgrows one churn epoch."""
        path = self._checkpoint_path if path is None else path
        if path is None:
            raise ValueError(
                "no checkpoint path: pass one or save()/load() first"
            )
        return self.save(path)

    @classmethod
    def load(cls, path: str, *, policy=None, wal_dir=None, durability=None,
             device: str | torch.device = "cuda") -> "MutableAnnIndex":
        """Load a snapshot (saved by either package) onto ``device``; with
        ``wal_dir`` also replay records past the snapshot's watermark
        (crash recovery) and keep logging there."""
        from repro_torch.ann.persistence import load_mutable_index

        return load_mutable_index(
            path, policy=policy, wal_dir=wal_dir, durability=durability, device=device
        )

    def close(self) -> None:
        """Flush and close the WAL (if any); the index stays queryable
        but further mutations in a durable mode will fail."""
        if self._wal is not None:
            self._wal.close()

    # --------------------------------------------------------------- info --
    @property
    def n_live(self) -> int:
        return self._state.n_live

    @property
    def dirty(self) -> bool:
        """True when the state diverged from the last built base (a
        compaction would change the on-disk/base layout)."""
        st = self._state
        return bool(st.n_delta_rows or st.n_tombstones)

    def stats(self) -> dict:
        st = self._state
        out = {
            "n_base": st.n_base,
            "n_tombstones": st.n_tombstones,
            "n_delta_live": st.n_delta_live,
            "n_delta_dead": st.n_delta_rows - st.n_delta_live,
            "n_live": st.n_live,
            "generation": self.generation,
            "mutations": self._mutations,
            "compactions": self._compactions,
            "last_compaction_s": self._last_compaction_s,
            "next_id": self._next_id,
            "dirty": self.dirty,
            "durability": self.durability,
        }
        if self._wal is not None:
            out["wal"] = self._wal.stats()
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        s = self.stats()
        return (
            f"MutableAnnIndex(live={s['n_live']}, base={s['n_base']}, "
            f"tombstones={s['n_tombstones']}, delta={s['n_delta_live']}, "
            f"generation={s['generation']})"
        )
