"""Compaction — fold a mutable index's delta + tombstones into a fresh base
(mirrors ``repro.ann.compaction``).

The policy decides *when* churn has earned a rebuild (delta-size and
tombstone-ratio thresholds — the paper's 8x-cheaper indexing is what makes
this affordable as a steady-state background cost); :func:`compact` decides
*how*: snapshot the live corpus (gathered on the index's device: the base
rows never visit the host), run the ordinary
:class:`~repro_torch.ann.AnnIndex` build there outside any lock, then
atomically install the result — replaying whatever mutations landed while
the build ran (a small in-memory log). Searches never block on a
compaction; they keep serving the pre-compaction snapshot until the install
instant, and with ``engine=`` the install is then swapped atomically into a
live :class:`~repro_torch.serving.ann_engine.AnnServingEngine`
(``swap_index``).

Because the install IS ``AnnIndex.build(live_corpus)`` plus an external-id
remap, post-compaction search results are bitwise-identical to a
from-scratch rebuild oracle by construction — the invariant the tests pin.

A live corpus smaller than ``cfg.sqrt_k`` (k-means needs at least one
point per centroid) compacts into a *delta-only* state: every row moves to
the brute-force-scanned delta segment and the base drops to None. That is
also how "compact to empty" behaves.
"""
from __future__ import annotations

import dataclasses

from repro_torch.ann.index import AnnIndex
from repro_torch.obs import metrics as obsm
from repro_torch.obs import trace as obst
from repro_torch.serving.scheduler import get_shared_pool

# Process-wide compaction metric families (repro_torch.obs registry).
_M_COMPACTIONS = obsm.counter(
    "taco_compaction_total", "Compactions installed (manual + background)"
)
_M_COMPACTION_SECONDS = obsm.histogram(
    "taco_compaction_seconds", "Compaction wall time (rebuild + install)"
)


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """Thresholds for :meth:`repro_torch.ann.MutableAnnIndex.maybe_compact`.

    A ``None`` field disables that trigger. Defaults are deliberately lax —
    serving workloads tune them to their churn/latency trade-off.
    """

    #: compact when the delta segment holds this many rows (live + dead)
    max_delta_rows: int | None = 4096
    #: ... or when delta rows exceed this fraction of the live corpus
    max_delta_frac: float | None = 0.25
    #: ... or when this fraction of base rows are tombstoned
    max_tombstone_frac: float | None = 0.25

    def reason(self, stats: dict) -> str | None:
        """The human-readable trigger that fired, or None."""
        delta_rows = stats["n_delta_live"] + stats["n_delta_dead"]
        if self.max_delta_rows is not None and delta_rows >= self.max_delta_rows:
            return f"delta_rows {delta_rows} >= {self.max_delta_rows}"
        if (
            self.max_delta_frac is not None
            and stats["n_live"] > 0
            and delta_rows / stats["n_live"] > self.max_delta_frac
        ):
            return (
                f"delta_frac {delta_rows / stats['n_live']:.3f} > "
                f"{self.max_delta_frac}"
            )
        if (
            self.max_tombstone_frac is not None
            and stats["n_base"] > 0
            and stats["n_tombstones"] / stats["n_base"] > self.max_tombstone_frac
        ):
            return (
                f"tombstone_frac "
                f"{stats['n_tombstones'] / stats['n_base']:.3f} > "
                f"{self.max_tombstone_frac}"
            )
        return None


@dataclasses.dataclass
class CompactionReport:
    """What one compaction did."""

    reason: str  # policy trigger (or "manual"/"background")
    duration_s: float  # wall time incl. the index build
    n_live: int  # rows in the rebuilt corpus
    reclaimed: int  # (base + delta) rows the rebuild dropped
    replayed: int  # mutations logged during the build and replayed
    generation: int  # mutable index generation after the install
    delta_only: bool  # corpus too small to cluster: no base was built


def compact(mutable, *, engine=None, reason: str = "manual") -> CompactionReport:
    """Rebuild ``base + delta − tombstones`` into a fresh base and install
    it atomically on ``mutable``.

    The build runs on the caller's thread but outside the mutable index's
    lock: concurrent searches serve the old snapshot, concurrent mutations
    are logged and replayed onto the fresh state at install time. With
    ``engine`` the installed index is atomically swapped into that live
    :class:`~repro_torch.serving.ann_engine.AnnServingEngine`. Raises
    RuntimeError if another compaction is already in progress.
    """
    t0 = obsm.now()
    snap, vecs, ids = mutable._begin_compaction()
    return _run_to_install(mutable, snap, vecs, ids, engine=engine,
                           reason=reason, t0=t0)


def _run_to_install(mutable, snap, vecs, ids, *, engine, reason, t0) -> CompactionReport:
    """Build + install + report (the log was already started)."""
    span = obst.default_tracer().start_trace(
        "compaction", reason=reason, n_live=int(vecs.shape[0])
    )
    try:
        base = None
        if vecs.shape[0] >= mutable.cfg.sqrt_k:
            with span.child("rebuild"):
                base = AnnIndex.build(vecs, mutable.cfg, device=mutable.device)
        else:
            vecs = vecs.cpu().numpy()  # delta-only: the rows go to the host
    except BaseException:
        mutable._abort_compaction()
        span.finish(error=True)
        raise
    with span.child("install"):
        reclaimed, replayed = mutable._finish_compaction(
            base, vecs, ids, engine=engine, snapshot=snap
        )
    if mutable._wal is not None and mutable._checkpoint_path is not None:
        # the install marker is in the log; persisting the post-install
        # snapshot moves the watermark past it, so checkpoint() rotates
        # the active segment and retires everything the snapshot covers —
        # the log stays bounded to one churn epoch
        mutable.checkpoint()
    duration = obsm.now() - t0
    mutable._last_compaction_s = duration
    _M_COMPACTIONS.inc()
    _M_COMPACTION_SECONDS.observe(duration)
    span.finish(duration_s=duration, replayed=replayed)
    return CompactionReport(
        reason=reason,
        duration_s=duration,
        n_live=int(vecs.shape[0]),
        reclaimed=reclaimed,
        replayed=replayed,
        generation=mutable.generation,
        delta_only=base is None,
    )


class CompactionHandle:
    """A background compaction in flight: ``result()`` joins and returns
    the :class:`CompactionReport` (re-raising any build failure).

    ``thread_name`` (once done) names the worker-pool thread the rebuild
    ran on — the test surface for "compaction never runs on a caller's
    thread"."""

    def __init__(self):
        self.report: CompactionReport | None = None
        self.error: BaseException | None = None
        self._task = None  # repro_torch.serving.scheduler.WorkTask

    @property
    def thread_name(self) -> str | None:
        return None if self._task is None else self._task.thread_name

    def running(self) -> bool:
        return self._task is not None and not self._task.done()

    def result(self, timeout: float | None = None) -> CompactionReport:
        try:
            self._task.result(timeout)
        except TimeoutError:
            raise TimeoutError("compaction still running") from None
        except BaseException:
            pass  # surfaced via self.error below, like the old API
        if self.error is not None:
            raise self.error
        return self.report


def compact_async(mutable, *, engine=None, reason: str = "background",
                  pool=None) -> CompactionHandle:
    """:func:`compact` as a task on a :class:`~repro_torch.serving.scheduler.
    WorkerPool` (default: the process-shared pool, which the write-ahead
    log's group commits also use, so an application gets one bounded set of
    maintenance threads and the rebuild never runs on a caller's thread). The mutation log starts synchronously
    (before this returns), so every mutation from now until the install is
    replayed onto the fresh base — callers keep inserting, deleting and
    searching while the rebuild runs."""
    handle = CompactionHandle()
    t0 = obsm.now()
    snap, vecs, ids = mutable._begin_compaction()  # sync: log starts NOW

    def work():
        try:
            handle.report = _run_to_install(
                mutable, snap, vecs, ids, engine=engine, reason=reason, t0=t0
            )
        except BaseException as e:  # surface via result(), don't kill the app
            handle.error = e
            raise

    handle._task = (pool or get_shared_pool()).submit(work, label="compaction")
    return handle
