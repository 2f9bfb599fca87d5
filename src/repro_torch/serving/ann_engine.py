"""Batched, query-aware ANN serving engine over a built :class:`SCIndex`
(mirrors ``repro.serving.ann_engine``).

The TaCo query (paper Alg. 6) is a pure function of (index, queries, cfg),
which makes serving a batching problem: the request path here turns a
stream of independent :class:`AnnRequest`\\ s into a small number of padded
query executions on the index's device.

Request path
------------
``submit()`` validates, applies **admission control**, enqueues, and
returns an :class:`AnnFuture` (``result(timeout=)`` / ``done()`` /
``add_done_callback()``). Requests are served either by a background
**drain worker** (``async_mode=True`` — a service thread on the engine's
:class:`~repro_torch.serving.scheduler.WorkerPool` forms micro-batches
continuously, so producers never block on each other) or synchronously by
whichever caller invokes ``drain()``/``search()`` (the default). Either
way, serving one batch means:

  1. answer repeats from the optional LRU **result cache** keyed on the
     quantized query bytes + effective ``(k, cfg)`` (``result_cache_size``;
     hit/miss counts in ``telemetry()`` next to the compile counts);
  2. group remaining requests by their *effective* ``(k, cfg)`` —
     per-request ``beta`` / ``rerank`` overrides become
     ``dataclasses.replace(cfg, ...)``, so overrides (including switching
     between the gather and the streaming masked-full re-rank pipelines)
     are first-class while steady-state traffic with default parameters
     shares one cached query function. Higher ``priority`` requests pick
     the group;
  3. micro-batch up to ``max_batch`` requests of the group, padded up a
     shape bucket (:mod:`repro_torch.serving.batching` — every row of the
     TaCo query path is independent, so padding cannot change real-row
     results). **Deadline-aware close**: the async worker lingers up to
     ``linger_s`` hoping to fill the batch, but closes it early the moment
     the oldest member's ``deadline_s`` comes within ``deadline_margin_s``
     of expiring — a near-SLO request never waits for stragglers;
  4. hand the padded batch to the engine's :class:`AnnBackend`, a thin
     adapter over a :class:`repro_torch.ann.Searcher` — the layer that owns
     device placement and the LRU of query functions keyed ``(bucket, k,
     cfg)``. The backend copies the padded ``(bucket, d)`` batch to the
     index's device once; the searcher's host copies of the results at the
     end synchronize the stream, so the batch time the engine measures is
     the card's, not the launch's;
  5. demux per-request ids/dists (+ the ``truncated`` stat) into each
     request's future and record telemetry: p50/p99 latency, queries/sec,
     candidate-truncation rate, per-bucket compile counts, cache
     hits/misses, queue depth, deadline misses, shed/degraded counts, and,
     for a sharded backend, the per-shard candidate/truncation stats and
     the combine's id/dist pairs per query.

Admission control
-----------------
Past ``max_queue_depth`` queued requests, ``submit()`` stops accepting
work at face value (``admission_policy``):

  * ``"reject"`` (default) — raise :class:`AdmissionError`; the caller
    sheds load (``shed`` count in telemetry).
  * ``"cache_only"`` — serve the request iff it hits the result cache
    (zero backend work); otherwise raise :class:`AdmissionError`.
  * ``"degrade"`` — accept, but scale the request's re-rank budget
    ``beta`` by ``degrade_beta_scale``: a cheaper, lower-recall fast path
    (``degraded`` count in telemetry).

Background maintenance
----------------------
Recall probes (``recall_probe_every=N``) and background compaction
(:mod:`repro_torch.ann.compaction`) run as tasks on the same
:class:`~repro_torch.serving.scheduler.WorkerPool` that hosts the drain
worker — maintenance work never runs on a caller's serving thread.
``telemetry()`` joins in-flight probes first, so its counts are
consistent. A probe whose ``index_generation`` was swapped out mid-flight
is skipped — probes never score a result against a replaced corpus. A
probe computes its exact top-k on the index's device
(:meth:`~repro_torch.ann.Searcher.probe_topk`, ordered by (distance, id)
as the reference's ``lexsort``) and brings only the k ids to the host, so
it never moves the corpus; an explicit ``recall_probe_corpus`` callable is
scored on the host as in the reference.

Index lifecycle on a live engine
--------------------------------
``swap_index()`` atomically replaces the served index between batches
under a monotonic ``index_generation`` (every :class:`AnnResult` is
stamped with the generation it was computed at) and drops the result
cache; a batch that raced the swap skips the cache store when its
generation went stale, so a result computed against the old index is
never cached after a swap. :class:`repro_torch.ann.MutableAnnIndex` drives
the same machinery for in-place mutation (``notify_index_mutated``) and
background compaction.

**Batch versus swap: the execution baton.** The reference runs each batch
under an execution lock that ``swap_index`` also takes. Here no lock is
held across device work. Instead one flag, ``_executing`` (the *baton*),
is claimed and returned under ``_lock`` and waited for on the condition
``_baton``: ``_execute`` claims it (waiting while another batch or a swap
holds it), snapshots the backend and the generation, releases ``_lock``,
runs the batch, then returns the baton under ``_lock`` and notifies.
``swap_index`` waits for the baton under ``_lock`` and installs before it
releases the lock. So a swap never lands mid-batch, no batch claims the
replaced backend once ``swap_index`` returns, and batches are serialized
(the searcher's function LRU is not thread-safe), while ``submit()``,
``telemetry()`` and ``notify_index_mutated()`` never wait for the card.
A backend must not call ``swap_index`` from inside its own ``run``.

``drain()`` and ``search()`` stay thin synchronous adapters over the
futures: ``search()`` waits on exactly the futures of the requests it
submitted (another caller's already-queued requests keep their results —
their futures resolve and a later ``drain()`` returns them), ``drain()``
collects every undelivered result as ``{request_id: AnnResult}``.

``telemetry()`` has every key of the reference's but
``jax_dispatch_under_lock`` and ``jax_seconds_under_lock``: those come
from the reference's runtime shim of JAX dispatch, and the port runs no
JAX. Its lock discipline is checked statically
(``tests/test_torch_lock_discipline.py``). ``autotune_cache=`` warm-loads
the kernels' (bq, bn) winners once, at construction, before any lock
exists; the drain worker only reads them (``telemetry()`` reports
``autotune_entries_loaded`` when it is non-zero).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque

import numpy as np

from repro_torch.ann.searcher import (
    AnnBatchResult,
    Searcher,
    ShardedSearcher,
    SingleDeviceSearcher,
    _padded_on,
    effective_query_params,
    warm_load_autotune,
)
from repro_torch.core.config import SCConfig
from repro_torch.core.taco import SCIndex
from repro_torch.obs import metrics as obsm
from repro_torch.obs import trace as obst
from repro_torch.serving.batching import ANN_BATCH_BUCKETS, bucket_size, pad_rows
from repro_torch.serving.scheduler import WorkerPool, get_shared_pool

__all__ = [
    "AdmissionError",
    "AnnBackend",
    "AnnBatchResult",
    "AnnFuture",
    "AnnRequest",
    "AnnResult",
    "AnnServingEngine",
    "ShardedAnnBackend",
    "SingleDeviceAnnBackend",
]

# Process-wide engine metric families (repro_torch.obs registry), under the
# reference's names: telemetry(), benchmarks and `/metrics` read the same
# numbers (the O001 lint rule keeps stage timing on this registry).
_M_REQUESTS = obsm.counter(
    "taco_engine_requests_total", "Requests resolved, by outcome",
    labelnames=("outcome",),
)
_M_REQ_EXECUTED = _M_REQUESTS.labels(outcome="executed")
_M_REQ_CACHE_HIT = _M_REQUESTS.labels(outcome="cache_hit")
_M_REQ_SHED = _M_REQUESTS.labels(outcome="shed")
_M_BATCHES = obsm.counter(
    "taco_engine_batches_total", "Padded micro-batches executed"
)
_M_BATCHES_EARLY = obsm.counter(
    "taco_engine_batches_closed_early_total",
    "Batches a member's deadline closed before linger/full",
)
_M_DEGRADED = obsm.counter(
    "taco_engine_degraded_admissions_total",
    "Requests admitted with a degraded (scaled-down) re-rank budget",
)
_M_CACHE_ONLY = obsm.counter(
    "taco_engine_cache_only_served_total",
    "Over-watermark requests served purely from the result cache",
)
_M_DEADLINE_MISSES = obsm.counter(
    "taco_engine_deadline_misses_total", "Results delivered past their SLO"
)
_M_SWAPS = obsm.counter(
    "taco_engine_index_swaps_total", "Atomic index swaps on live engines"
)
_M_INVALIDATIONS = obsm.counter(
    "taco_engine_cache_invalidations_total",
    "Result-cache drops from mutations/compaction installs",
)
_M_QUEUE_DEPTH = obsm.gauge(
    "taco_engine_queue_depth", "Requests waiting in the engine queue"
)
_M_REQ_LATENCY = obsm.histogram(
    "taco_engine_request_latency_seconds",
    "Per-request serve latency (batch wall time; 0 for cache hits)",
)
_M_QUEUE_WAIT = obsm.histogram(
    "taco_engine_queue_wait_seconds",
    "Submit-to-batch-formation wait per executed request",
)
_M_EXEC_SECONDS = obsm.histogram(
    "taco_engine_batch_exec_seconds",
    "Backend execution (kernel stage) wall time per batch",
)


class AdmissionError(RuntimeError):
    """Request refused by admission control (queue past the watermark)."""


@dataclasses.dataclass
class AnnRequest:
    """One k-ANNS query: vector + optional per-request parameter overrides."""

    query: np.ndarray  # (d,) float32
    k: int | None = None  # result count; default cfg.k
    beta: float | None = None  # re-rank budget ratio; default cfg.beta
    #: re-rank strategy override ('gather' | 'masked_full' | 'auto');
    #: default cfg.rerank. masked_full requests can never report truncated.
    rerank: str | None = None
    #: SLO in seconds from submit: the batch carrying this request closes
    #: early when the deadline nears (async mode), and a result delivered
    #: past it counts as a deadline miss in telemetry(). None = engine
    #: default (default_deadline_s), which may also be None (no deadline).
    deadline_s: float | None = None
    #: scheduling priority (higher = sooner): the drain worker forms the
    #: next batch around the highest-priority oldest request.
    priority: int = 0


@dataclasses.dataclass
class AnnResult:
    ids: np.ndarray  # (k,) int32; -1 where fewer than k neighbors
    dists: np.ndarray  # (k,) float32 squared distances; inf on -1 slots
    truncated: bool  # candidate set hit a static cap for this query
    latency_s: float  # wall time of the batch that served this request
    shard_candidates: np.ndarray | None = None  # (S,) per-shard demand (sharded)
    cached: bool = False  # served from the result cache, no device work
    #: engine's index generation when this result was computed; bumped by
    #: swap_index() and by mutable-index mutations, so a consumer can tell
    #: which version of the corpus a (possibly cached) answer describes
    index_generation: int = 0


class AnnFuture:
    """Handle to one submitted :class:`AnnRequest`.

    ``result(timeout=)`` blocks until the drain worker (or a synchronous
    ``drain()``/``search()`` call) serves the request; ``done()`` polls;
    ``add_done_callback(fn)`` runs ``fn(future)`` on the serving thread
    when the result lands (immediately, on the calling thread, if already
    done).

    A future compares and hashes equal to its integer ``request_id``, so
    call sites that key ``drain()``'s result dict by the id keep working:
    the future IS that key.
    """

    __slots__ = ("request_id", "_cond", "_done", "_result", "_callbacks")

    def __init__(self, request_id: int):
        self.request_id = request_id
        self._cond = threading.Condition(threading.Lock())
        self._done = False
        self._result: AnnResult | None = None
        self._callbacks: list = []

    def done(self) -> bool:
        with self._cond:
            return self._done

    def result(self, timeout: float | None = None) -> AnnResult:
        """The request's :class:`AnnResult`; raises TimeoutError if not
        served within ``timeout`` seconds (None = wait forever)."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._done, timeout):
                raise TimeoutError(
                    f"request {self.request_id} not served within {timeout}s"
                )
            return self._result

    def add_done_callback(self, fn) -> None:
        with self._cond:
            if not self._done:
                self._callbacks.append(fn)
                return
        fn(self)

    def _resolve(self, result: AnnResult) -> None:
        with self._cond:
            self._result = result
            self._done = True
            callbacks, self._callbacks = self._callbacks, []
            self._cond.notify_all()
        for fn in callbacks:
            try:
                fn(self)
            except Exception:  # user callback must not kill the serving path
                pass

    # int-compat identity: hash/eq by request id (see class docstring)
    def __hash__(self) -> int:
        return hash(self.request_id)

    def __eq__(self, other) -> bool:
        if isinstance(other, AnnFuture):
            return other.request_id == self.request_id
        if isinstance(other, (int, np.integer)):
            return int(other) == self.request_id
        return NotImplemented

    def __int__(self) -> int:
        return self.request_id

    def __index__(self) -> int:
        return self.request_id

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        state = "done" if self.done() else "pending"
        return f"AnnFuture(request_id={self.request_id}, {state})"


@dataclasses.dataclass
class _Pending:
    """A queued request: the submit-time facts batch formation needs."""

    rid: int
    req: AnnRequest
    future: AnnFuture
    t_submit: float  # monotonic
    deadline: float | None  # absolute monotonic, or None
    degraded: bool  # admission degraded this request to a lower beta
    # Tracing (repro_torch.obs.trace): the root span crosses from the
    # submitting thread to the drain worker to the probe pool EXPLICITLY, by
    # riding this record — no implicit thread-local context. NULL_SPAN when
    # the request was not sampled.
    span: object = obst.NULL_SPAN  # root "ann-request" span
    qspan: object = obst.NULL_SPAN  # open "queue-wait" child
    fspan: object = None  # "batch-form" child once taken into a batch
    t_taken: float | None = None  # monotonic, first taken into a batch


def _copied_arrays(r: AnnResult) -> dict:
    """Fresh copies of an AnnResult's array fields (cache isolation)."""
    return {
        "ids": r.ids.copy(),
        "dists": r.dists.copy(),
        "shard_candidates": None
        if r.shard_candidates is None
        else r.shard_candidates.copy(),
    }


class AnnBackend:
    """Adapts a :class:`~repro_torch.ann.searcher.Searcher` to the engine's
    padded-batch loop.

    The engine owns queueing, caching, grouping, bucketing, demux and
    telemetry; the searcher owns device placement and the ``(bucket, k,
    cfg)`` -> query-function LRU. A backend is the shim between them:
    ``run()`` places one padded batch on the searcher's device and forwards
    it to :meth:`~repro_torch.ann.searcher.Searcher.run_padded`.
    """

    def __init__(self, index: SCIndex, *, searcher: Searcher):
        self.index = index
        self.searcher = searcher

    @property
    def shards(self) -> int:
        """Data shards the corpus is split over (1 = no sharding)."""
        return self.searcher.shards

    @property
    def dim(self) -> int:
        """Query dimensionality (request validation delegates here)."""
        return self.searcher.dim

    @property
    def max_k(self) -> int:
        """Largest servable per-request ``k``."""
        return self.searcher.max_k

    def extra_telemetry(self) -> dict:
        """Backend-specific keys merged into the engine's telemetry()."""
        return self.searcher.extra_telemetry()

    # The function cache lives on the searcher; these views keep the
    # engine's telemetry surface the reference's.
    @property
    def _fns(self) -> OrderedDict:
        return self.searcher._fns

    @property
    def compile_counts(self) -> dict:
        return self.searcher.compile_counts

    def run(self, bucket: int, k: int, cfg: SCConfig, queries: np.ndarray) -> AnnBatchResult:
        """Execute one padded ``(bucket, d)`` host query batch: one copy to
        the searcher's device, then its ``run_padded``, which returns numpy
        results (so the call ends when the card is done)."""
        return self.searcher.run_padded(
            bucket, k, cfg, _padded_on(queries, bucket, self.searcher.device))


class SingleDeviceAnnBackend(AnnBackend):
    """One-device execution (:class:`SingleDeviceSearcher` adapter)."""

    def __init__(self, index: SCIndex, *, max_cached_fns: int = 64, searcher=None):
        if searcher is None:
            searcher = SingleDeviceSearcher(index, max_cached_fns=max_cached_fns)
        super().__init__(index, searcher=searcher)


class ShardedAnnBackend(AnnBackend):
    """Corpus-sharded execution (:class:`ShardedSearcher` adapter): the
    index is placed ONCE as shard views over ``mesh`` (a sequence of
    devices) or ``shards`` views on the index's device; every ``(bucket, k,
    cfg)`` key makes a sharded query function. Same queue, same
    function-cache policy, per-shard telemetry."""

    def __init__(self, index: SCIndex, *, mesh=None, shards: int | None = None,
                 data_axes=None, query_axes=(), max_cached_fns: int = 64, searcher=None):
        if searcher is None:
            searcher = ShardedSearcher(index, mesh=mesh, shards=shards, data_axes=data_axes,
                                       query_axes=query_axes, max_cached_fns=max_cached_fns)
        super().__init__(index, searcher=searcher)

    @property
    def mesh(self):
        return self.searcher.mesh

    @property
    def data_axes(self):
        return self.searcher.data_axes

    @property
    def query_axes(self):
        return self.searcher.query_axes


def _make_backend(backend, index, *, mesh, shards, max_cached_fns) -> AnnBackend:
    if isinstance(backend, Searcher):
        if mesh is not None or shards is not None or max_cached_fns is not None:
            raise ValueError(
                "a prebuilt Searcher already owns its placement and "
                "query-function cache; don't also pass mesh/shards/"
                "max_cached_fns (set them when building the searcher)"
            )
        cls = ShardedAnnBackend if isinstance(backend, ShardedSearcher) else SingleDeviceAnnBackend
        return cls(backend.index, searcher=backend)
    max_cached_fns = 64 if max_cached_fns is None else int(max_cached_fns)
    if backend == "sharded":
        return ShardedAnnBackend(
            index, mesh=mesh, shards=shards, max_cached_fns=max_cached_fns
        )
    if mesh is not None or shards is not None:
        # would be silently ignored — a forgotten backend="sharded" must
        # not degrade to single-device serving without a sound
        raise ValueError(
            f"mesh/shards are only consumed by backend='sharded', got "
            f"backend={backend!r}"
        )
    if isinstance(backend, AnnBackend):
        return backend
    if backend == "single":
        return SingleDeviceAnnBackend(index, max_cached_fns=max_cached_fns)
    raise ValueError(f"unknown backend {backend!r} (want 'single' or 'sharded')")


_ADMISSION_POLICIES = ("reject", "cache_only", "degrade")


class AnnServingEngine:
    """Micro-batching ANN server; see module docstring for the request path."""

    def __init__(
        self,
        index: SCIndex,
        cfg: SCConfig,
        *,
        max_batch: int = 64,
        buckets=ANN_BATCH_BUCKETS,
        max_cached_fns: int | None = None,  # query-function LRU size; default 64
        backend: str | AnnBackend | Searcher = "single",
        mesh=None,
        shards: int | None = None,
        result_cache_size: int = 0,
        recall_probe_every: int = 0,
        recall_probe_corpus=None,
        async_mode: bool = False,
        pool: WorkerPool | None = None,
        linger_s: float = 0.002,
        default_deadline_s: float | None = None,
        deadline_margin_s: float = 0.002,
        max_queue_depth: int = 0,  # 0 = unbounded (no admission control)
        admission_policy: str = "reject",
        degrade_beta_scale: float = 0.5,
        autotune_cache: str | None = None,
        tracer: obst.Tracer | None = None,  # None = the process default
    ):
        self.index = index
        self.cfg = cfg
        self.max_batch = int(max_batch)
        # Kernel autotune warm-load: seed the process-wide (bq, bn) winner
        # cache from a prior save_cache file so the first batch never pays
        # a search. Loaded once, here, before any lock exists.
        self.autotune_entries_loaded = warm_load_autotune(autotune_cache)
        self.buckets = tuple(b for b in buckets if b <= self.max_batch) or (
            self.max_batch,
        )
        self.backend = _make_backend(
            backend, index, mesh=mesh, shards=shards, max_cached_fns=max_cached_fns
        )
        if admission_policy not in _ADMISSION_POLICIES:
            raise ValueError(
                f"admission_policy={admission_policy!r} (want one of "
                f"{_ADMISSION_POLICIES})"
            )
        if not 0.0 < float(degrade_beta_scale) <= 1.0:
            raise ValueError(
                f"degrade_beta_scale={degrade_beta_scale} out of range (0, 1]"
            )
        # _lock guards every mutable engine field (queue, caches, counters,
        # the baton); _work is its condition for producers -> drain worker,
        # _baton its condition for the execution baton (module docstring).
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._baton = threading.Condition(self._lock)
        self._executing = False
        self._queue: deque[_Pending] = deque()
        self._next_id = 0
        #: futures not yet handed back by drain()/search(); drain() is the
        #: collector, so a producer that only submit()s can still find its
        #: results later — and another caller's search() cannot discard them.
        self._undelivered: OrderedDict[int, AnnFuture] = OrderedDict()
        # Per-request latencies live in a bounded log-bucketed histogram, so
        # a long-running serve holds flat memory. This private instance backs
        # the engine's resettable telemetry() view; the same observations
        # also land in the process registry.
        self._lat_hist = obsm.Histogram(
            "engine_request_latency_seconds", "per-engine telemetry view"
        )
        self._tracer = tracer
        self._served = 0
        self._executed = 0  # requests that reached the backend (not cache hits)
        self._batches = 0
        self._truncated = 0
        self._busy_s = 0.0
        self._combine_pairs = 0
        self._shard_candidates = np.zeros(self.backend.shards, np.int64)
        self._shard_truncated = np.zeros(self.backend.shards, np.int64)
        # Result cache: LRU on (quantized query bytes, k, cfg) in front of
        # the batch path. 0 disables. Queries are quantized to float16 for
        # the key, so "the same vector again" hits even across float32 noise
        # below half precision — by construction a hit may serve a result
        # computed for a query within f16 rounding.
        self.result_cache_size = int(result_cache_size)
        self._result_cache: OrderedDict = OrderedDict()  # key -> AnnResult
        self._cache_hits = 0
        self._cache_misses = 0
        # Index lifecycle: the generation is a monotonic version of the
        # corpus view this engine serves; swap_index() and mutable-index
        # mutations bump it and drop the result cache, so a stale-generation
        # cached result is never served across a swap. Every AnnResult is
        # stamped with it.
        self.index_generation = 0
        self._swaps = 0
        self._invalidations = 0
        # Live recall probes: every Nth EXECUTED request is re-answered by
        # exact kNN over the current corpus and compared to what was served
        # — as a WorkerPool task, never on the serving thread. By default
        # the probe asks the backend's searcher (a mutable searcher serves
        # its live base − tombstones + delta view), so probes follow
        # swap_index(); an explicit recall_probe_corpus callable overrides
        # it until the next swap. A probe whose generation went stale
        # mid-flight is dropped.
        self.recall_probe_every = int(recall_probe_every)
        self._recall_probe_corpus = recall_probe_corpus
        self._probe_tick = 0
        self._probe_recall_sum = 0.0
        self._probe_count = 0
        self._probe_skipped = 0  # samples dropped: generation went stale
        self._probe_tasks: deque = deque()
        #: thread names that executed recall probes (the test surface for
        #: the "maintenance never runs on a caller's thread" contract)
        self.probe_thread_names: set[str] = set()
        # Async pipeline + admission control
        self.linger_s = float(linger_s)
        self.default_deadline_s = default_deadline_s
        self.deadline_margin_s = float(deadline_margin_s)
        self.max_queue_depth = int(max_queue_depth)
        self.admission_policy = admission_policy
        self.degrade_beta_scale = float(degrade_beta_scale)
        self._pool = pool
        self._worker: threading.Thread | None = None
        self._stop = threading.Event()
        self._shed = 0
        self._degraded = 0
        self._cache_only_served = 0
        self._deadline_misses = 0
        self._early_closes = 0
        self._queue_peak = 0
        if async_mode:
            self.start()

    # ---------------------------------------------------------- lifecycle --
    @property
    def pool(self) -> WorkerPool:
        """The engine's worker pool (drain worker, compaction, probes);
        defaults to the process-shared pool, created lazily."""
        if self._pool is None:
            self._pool = get_shared_pool()
        return self._pool

    @property
    def running(self) -> bool:
        """True while the background drain worker serves the queue."""
        return self._worker is not None and self._worker.is_alive()

    def start(self) -> None:
        """Start the background drain worker (idempotent). From now on
        ``submit()`` is fire-and-forget: batches form continuously off the
        callers' threads, results land in the futures."""
        with self._lock:
            if self.running:
                return
            self._stop.clear()
            self._worker = self.pool.spawn(
                self._drain_loop, name=f"{self.pool.name}-drain-{id(self):x}"
            )

    def close(self, timeout: float | None = 10.0) -> None:
        """Stop the drain worker after it empties the queue (no-op when
        not started). Queued requests are still served; new submits after
        close() queue up for a synchronous drain() or a restart()."""
        worker = self._worker
        if worker is None:
            return
        self._stop.set()
        with self._work:
            self._work.notify_all()
        worker.join(timeout)
        self._worker = None

    def __enter__(self) -> "AnnServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def searcher(self) -> Searcher:
        """The placement + query-function-cache layer this engine serves from."""
        return self.backend.searcher

    # Views of the function cache, which lives on the searcher.
    @property
    def _fns(self) -> OrderedDict:
        return self.backend._fns

    @property
    def compile_counts(self) -> dict:
        return self.backend.compile_counts

    # ------------------------------------------------------------- queue --
    def submit(self, request: AnnRequest) -> AnnFuture:
        """Admit + enqueue a request; returns its :class:`AnnFuture` (which
        also compares equal to the integer request id keying ``drain()``'s
        dict).

        Validates eagerly: a malformed request must fail here, at its own
        call site, not crash a later batch that also carries other
        callers' requests. Raises :class:`AdmissionError` when the queue is
        past ``max_queue_depth`` and the policy sheds (see module
        docstring)."""
        d = self.backend.dim
        q = np.asarray(request.query, np.float32)
        if q.shape != (d,):
            raise ValueError(f"query shape {q.shape} != ({d},)")
        if request.k is not None:
            k = int(request.k)
            max_k = self.backend.max_k
            if not 0 < k <= max_k:
                raise ValueError(f"k={request.k} out of range (0, {max_k}]")
        if request.beta is not None and not 0.0 < float(request.beta) <= 1.0:
            raise ValueError(f"beta={request.beta} out of range (0, 1]")
        if request.rerank is not None and request.rerank not in (
            "gather", "masked_full", "auto",
        ):
            raise ValueError(f"unknown rerank override {request.rerank!r}")
        deadline_s = (
            self.default_deadline_s
            if request.deadline_s is None
            else request.deadline_s
        )
        if deadline_s is not None and not float(deadline_s) > 0.0:
            raise ValueError(f"deadline_s={deadline_s} must be > 0")
        now = time.monotonic()
        # root span + open queue-wait child; NULL_SPAN when unsampled (the
        # common case: every stage below is then an attribute no-op)
        tracer = self._tracer if self._tracer is not None else obst.default_tracer()
        span = tracer.start_trace("ann-request", k=request.k, priority=request.priority)
        qspan = span.child("queue-wait")
        cache_hit: tuple[AnnFuture, AnnResult] | None = None
        with self._work:
            degraded = False
            if self.max_queue_depth and len(self._queue) >= self.max_queue_depth:
                if self.admission_policy == "degrade":
                    degraded = True
                    self._degraded += 1
                    _M_DEGRADED.inc()
                elif self.admission_policy == "cache_only":
                    hit = None
                    if self.result_cache_size > 0:
                        hit = self._cache_lookup_locked(
                            request, self._effective(request)
                        )
                    if hit is None:
                        self._shed += 1
                        _M_REQ_SHED.inc()
                        span.finish(outcome="shed")
                        raise AdmissionError(
                            f"queue depth {len(self._queue)} >= "
                            f"{self.max_queue_depth} and no cached result "
                            f"(policy=cache_only)"
                        )
                    self._cache_only_served += 1
                    _M_CACHE_ONLY.inc()
                    fut = AnnFuture(self._next_id)
                    self._next_id += 1
                    self._undelivered[fut.request_id] = fut
                    cache_hit = (fut, hit)
                else:  # reject
                    self._shed += 1
                    _M_REQ_SHED.inc()
                    span.finish(outcome="shed")
                    raise AdmissionError(
                        f"queue depth {len(self._queue)} >= "
                        f"{self.max_queue_depth} (policy=reject)"
                    )
            if cache_hit is None:
                fut = AnnFuture(self._next_id)
                self._next_id += 1
                self._queue.append(_Pending(
                    rid=fut.request_id,
                    req=request,
                    future=fut,
                    t_submit=now,
                    deadline=None if deadline_s is None else now + float(deadline_s),
                    degraded=degraded,
                    span=span,
                    qspan=qspan,
                ))
                self._undelivered[fut.request_id] = fut
                self._queue_peak = max(self._queue_peak, len(self._queue))
                _M_QUEUE_DEPTH.set(len(self._queue))
                self._work.notify_all()
        if cache_hit is not None:
            fut, hit = cache_hit
            fut._resolve(hit)  # outside the lock: callbacks are user code
            qspan.finish()
            span.finish(outcome="cache_only")
        return fut

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def drain(self, timeout: float | None = None) -> dict[int, AnnResult]:
        """Collect every undelivered result as ``{request_id: AnnResult}``.

        Without a drain worker this serves the whole queue on the calling
        thread (the synchronous path); with one it just waits for the worker
        to resolve the outstanding futures. Either way the dict covers ALL
        undelivered requests — including ones other callers submitted and
        never collected — so results are never lost."""
        if not self.running:
            self._drain_queue_sync()
            with self._lock:
                ready = [f for f in self._undelivered.values() if f.done()]
        else:
            with self._lock:
                ready = list(self._undelivered.values())
        out = {}
        for fut in ready:
            out[fut.request_id] = fut.result(timeout)
        with self._lock:
            for fut in ready:
                self._undelivered.pop(fut.request_id, None)
        return out

    def search(self, requests, timeout: float | None = None) -> list[AnnResult]:
        """Synchronous convenience: serve ``requests``, results in order.

        Waits on exactly its own futures — other callers' already-queued
        requests are served along the way (synchronous mode drains the
        shared queue) but their results stay claimable via their futures
        or a later ``drain()``, never discarded."""
        futures = [self.submit(r) for r in requests]
        if not self.running:
            self._drain_queue_sync()
        results = [f.result(timeout) for f in futures]
        with self._lock:
            for f in futures:
                self._undelivered.pop(f.request_id, None)
        return results

    # ------------------------------------------------------ batch forming --
    def _drain_queue_sync(self) -> None:
        """Serve everything queued, on the calling thread (sync mode)."""
        while True:
            resolved: list = []
            batch = None
            group_key = None
            with self._work:
                if self.result_cache_size > 0:
                    resolved = self._serve_cache_locked()
                if self._queue:
                    group_key, batch = self._take_group_locked()
            for p, r in resolved:
                p.future._resolve(r)
                p.qspan.finish()
                p.span.finish(outcome="cache_hit")
            if batch is None:
                return
            self._execute(group_key, batch)

    def _drain_loop(self) -> None:
        """Background drain worker: continuous deadline-aware micro-batch
        formation (runs as a WorkerPool service thread)."""
        while True:
            resolved: list = []
            batch = None
            group_key = None
            early = False
            with self._work:
                while not self._queue and not self._stop.is_set():
                    self._work.wait(0.05)
                if self._stop.is_set() and not self._queue:
                    return
                if self.result_cache_size > 0:
                    resolved = self._serve_cache_locked()
                if self._queue:
                    group_key, batch, early = self._form_batch_locked()
            for p, r in resolved:
                p.future._resolve(r)
                p.qspan.finish()
                p.span.finish(outcome="cache_hit")
            if batch:
                if early:
                    with self._lock:
                        self._early_closes += 1
                    _M_BATCHES_EARLY.inc()
                self._execute(group_key, batch)

    def _take_matching_locked(self, group_key, batch: list) -> None:
        """Move queued requests matching ``group_key`` into ``batch``
        (up to max_batch), preserving the rest's order."""
        if len(batch) >= self.max_batch:
            return
        rest: deque = deque()
        for p in self._queue:
            if (
                len(batch) < self.max_batch
                and self._effective(p.req, p.degraded) == group_key
            ):
                batch.append(p)
                if p.t_taken is None:
                    p.t_taken = time.monotonic()
                    # stage transition: queue wait is over, batch forming
                    p.qspan.finish()
                    p.fspan = p.span.child("batch-form") if p.span else None
            else:
                rest.append(p)
        self._queue = rest
        _M_QUEUE_DEPTH.set(len(rest))

    def _pick_group_locked(self):
        """The next batch's (k, cfg): highest-priority oldest request."""
        head = max(self._queue, key=lambda p: p.req.priority)
        return self._effective(head.req, head.degraded)

    def _take_group_locked(self):
        group_key = self._pick_group_locked()
        batch: list = []
        self._take_matching_locked(group_key, batch)
        return group_key, batch

    def _form_batch_locked(self):
        """Async batch formation: linger up to ``linger_s`` for the batch
        to fill, but close it the moment the oldest member's deadline
        comes within ``deadline_margin_s``. Returns (group_key, batch,
        closed_early) — closed_early means the deadline, not the linger or
        a full batch, closed it."""
        group_key = self._pick_group_locked()
        batch: list = []
        self._take_matching_locked(group_key, batch)
        t_close = time.monotonic() + self.linger_s
        early = False
        while len(batch) < self.max_batch and not self._stop.is_set():
            now = time.monotonic()
            deadline = min(
                (p.deadline for p in batch if p.deadline is not None),
                default=None,
            )
            if deadline is not None and deadline - self.deadline_margin_s <= now:
                early = now < t_close  # linger budget remained: SLO closed it
                break
            until = t_close if deadline is None else min(
                t_close, deadline - self.deadline_margin_s
            )
            if until <= now:
                break
            # wait() releases the lock: producers keep submitting; wake on
            # notify or in small slices so a new earliest deadline is seen
            self._work.wait(min(until - now, 0.05))
            self._take_matching_locked(group_key, batch)
        return group_key, batch, early

    # ------------------------------------------------------ result cache --
    def _cache_key(self, req: AnnRequest, effective=None):
        k, cfg = self._effective(req) if effective is None else effective
        # Scale-normalized float16 quantization: dividing by max|q| before
        # the f16 cast keeps the key collision-free for large-magnitude
        # queries (a plain f16 cast saturates >65504 coordinates to inf,
        # colliding unrelated queries) while near-duplicate queries still
        # share a key — both direction and f16-rounded scale must match.
        # (A scale beyond f16 range saturates to inf: only same-direction
        # queries that BOTH exceed it can still collide.)
        q = np.asarray(req.query, np.float32)
        scale = float(np.max(np.abs(q))) or 1.0
        with np.errstate(over="ignore"):
            q16 = (q / scale).astype(np.float16)
            scale16 = np.float16(scale)
        return (q16.tobytes(), scale16.tobytes(), k, cfg)

    def _cache_lookup_locked(self, req: AnnRequest, effective) -> AnnResult | None:
        """A served-ready copy of the cached result for ``req`` (None on
        miss). Counts the hit and the serve; the MISS count is _execute's
        (a request that misses here goes on to execute, once)."""
        key = self._cache_key(req, effective)
        hit = self._result_cache.get(key)
        if hit is None:
            return None
        self._result_cache.move_to_end(key)
        self._cache_hits += 1
        # stamp the CURRENT generation: swaps/mutations clear the cache,
        # so a surviving entry describes the live corpus view
        out = dataclasses.replace(hit, latency_s=0.0, cached=True,
                                  index_generation=self.index_generation,
                                  **_copied_arrays(hit))
        self._lat_hist.observe(0.0)
        _M_REQ_LATENCY.observe(0.0)
        _M_REQ_CACHE_HIT.inc()
        self._truncated += int(hit.truncated)
        self._served += 1
        return out

    def _serve_cache_locked(self) -> list:
        """Resolve queued repeats from the result cache; returns
        [(pending, result)] for the caller to resolve OUTSIDE the lock
        (done-callbacks are user code)."""
        resolved: list = []
        rest: deque = deque()
        for p in self._queue:
            r = self._cache_lookup_locked(p.req, self._effective(p.req, p.degraded))
            if r is None:
                # NOT a miss yet: a request can survive several drain passes
                # (queue deeper than max_batch) and must count exactly once —
                # the miss is recorded when it finally executes.
                rest.append(p)
            else:
                resolved.append((p, r))
        self._queue = rest
        return resolved

    def _cache_store(self, req: AnnRequest, effective, result: AnnResult) -> None:
        # store an isolated copy: `result` shares its arrays with the
        # response just handed to the requester, and cached entries outlive
        # that response — a caller mutating its result must not poison the
        # cache (hits hand out copies for the same reason)
        key = self._cache_key(req, effective)
        self._result_cache[key] = dataclasses.replace(
            result, **_copied_arrays(result)
        )
        self._result_cache.move_to_end(key)
        while len(self._result_cache) > self.result_cache_size:
            self._result_cache.popitem(last=False)

    def clear_result_cache(self) -> None:
        """Drop all cached results (e.g. after a warm-up pass whose queries
        overlap the traffic you are about to measure)."""
        with self._lock:
            self._result_cache.clear()

    # ------------------------------------------------------ index lifecycle --
    def swap_index(self, new, *, cfg: SCConfig | None = None) -> int:
        """Atomically swap the served index while the engine stays live.

        ``new``: a :class:`~repro_torch.ann.searcher.Searcher` (owns
        placement + query functions for the replacement index), an
        :class:`AnnBackend`, or an ``AnnIndex``/``MutableAnnIndex`` facade (a
        single-device searcher is built from it). ``cfg`` replaces the
        engine's default config (defaults to a facade's own cfg).

        The swap is atomic at batch granularity: it waits for the execution
        baton (never lands mid-batch; see the module docstring) and
        installs under the engine lock, bumps the monotonic
        ``index_generation``, and drops the result cache — a cached result
        computed against the old index is never served after the swap, and
        a batch that raced the swap skips its cache store (its generation
        went stale). Queued-but-undrained requests are served by the NEW
        index. Per-shard telemetry counters reset; scalar traffic counters
        are kept. Returns the new generation.
        """
        # An index facade (AnnIndex or MutableAnnIndex): take its config and
        # a single-device searcher over it.
        if not isinstance(new, (Searcher, AnnBackend)) and callable(
            getattr(new, "searcher", None)
        ):
            if cfg is None:
                cfg = new.cfg
            new = new.searcher("single")
        if isinstance(new, Searcher):
            backend = _make_backend(
                new, None, mesh=None, shards=None, max_cached_fns=None
            )
        elif isinstance(new, AnnBackend):
            backend = new
        else:
            raise TypeError(
                f"swap_index wants a Searcher, AnnBackend or AnnIndex, got "
                f"{type(new).__name__}"
            )
        with self._lock:
            while self._executing:  # the batch in flight finishes first
                self._baton.wait()
            self.backend = backend
            self.index = getattr(backend.searcher, "index", None)
            if cfg is not None:
                self.cfg = cfg
            # probes must score against the corpus now being served, not a
            # callable bound to the replaced index
            self._recall_probe_corpus = None
            self._shard_candidates = np.zeros(self.backend.shards, np.int64)
            self._shard_truncated = np.zeros(self.backend.shards, np.int64)
            self.index_generation += 1
            self._swaps += 1
            _M_SWAPS.inc()
            self._result_cache.clear()
            return self.index_generation

    def notify_index_mutated(self) -> int:
        """The corpus behind the backend changed in place (mutable-index
        insert/delete/compaction install): cached results are stale. Bumps
        ``index_generation`` and drops the result cache; the backend itself
        is untouched (a mutable searcher reads the live state per batch).
        Returns the new generation."""
        with self._lock:
            self.index_generation += 1
            self._invalidations += 1
            _M_INVALIDATIONS.inc()
            self._result_cache.clear()
            return self.index_generation

    # ------------------------------------------------------- recall probes --
    def _probe_exact(self, query: np.ndarray, k: int):
        """Ids of the exact top-min(k, m) of ``query`` over the m-row corpus
        being served, ordered by (distance, id); None for an empty corpus.
        On the index's device by default; an explicit
        ``recall_probe_corpus`` is scored on the host."""
        if self._recall_probe_corpus is None:
            return self.backend.searcher.probe_topk(query, k)
        corpus, ids = self._recall_probe_corpus()
        m = int(np.asarray(corpus).shape[0])
        if m == 0:
            return None
        diff = np.asarray(corpus, np.float32) - query[None, :]
        dist = np.einsum("md,md->m", diff, diff)
        return np.asarray(ids)[np.lexsort((ids, dist))[:min(k, m)]]

    def _probe_task(self, query: np.ndarray, served_ids: np.ndarray,
                    k: int, generation: int, span=obst.NULL_SPAN) -> None:
        """One recall probe (a WorkerPool task): re-answer a served request
        with exact kNN over the live corpus and record recall@k of what was
        actually served. Skipped (and counted skipped) when the generation
        went stale — a result must never be scored against a corpus it
        wasn't computed on. ``span`` is the originating request's root span
        (explicit cross-thread propagation): the probe's span joins that
        request's tree even though the request already resolved."""
        with span.child("recall-probe"):
            if self.index_generation != generation:
                with self._lock:
                    self._probe_skipped += 1
                    self.probe_thread_names.add(threading.current_thread().name)
                return
            exact_ids = self._probe_exact(query, k)
            if exact_ids is None:
                return  # nothing live: recall undefined, skip the sample
            exact = set(exact_ids.tolist())
            served = {int(i) for i in served_ids[:k] if i >= 0}
            recall = len(served & exact) / len(exact_ids)
            with self._lock:
                self.probe_thread_names.add(threading.current_thread().name)
                if self.index_generation != generation:
                    self._probe_skipped += 1  # swapped while we scored
                    return
                self._probe_recall_sum += recall
                self._probe_count += 1

    def _flush_probes(self) -> None:
        """Join in-flight probe tasks so telemetry counts are consistent.
        Never called with the engine lock held (the tasks need it)."""
        while True:
            with self._lock:
                if not self._probe_tasks:
                    return
                task = self._probe_tasks.popleft()
            try:
                task.result()
            except Exception:
                pass  # a failed probe loses one sample, nothing else

    # ---------------------------------------------------------- execution --
    def _effective(self, req: AnnRequest, degraded: bool = False) -> tuple[int, SCConfig]:
        k, cfg = effective_query_params(self.cfg, req.k, req.beta, req.rerank)
        if degraded:
            # admission degrade: scale the re-rank budget down — a cheaper,
            # lower-recall fast path under pressure
            cfg = dataclasses.replace(
                cfg, beta=cfg.beta * self.degrade_beta_scale
            )
        return k, cfg

    def _claim_baton(self):
        """Wait for the execution baton and take it; returns the backend
        and generation the batch runs on (module docstring)."""
        with self._lock:
            while self._executing:
                self._baton.wait()
            self._executing = True
            return self.backend, self.index_generation

    def _return_baton(self) -> None:
        with self._lock:
            self._executing = False
            self._baton.notify_all()

    def _execute(self, group_key, batch: list) -> None:
        """Run one formed batch on the backend and resolve its futures."""
        k, cfg = group_key
        queries = np.stack([np.asarray(p.req.query, np.float32) for p in batch])
        bucket = bucket_size(len(batch), self.buckets)
        # batch formation is over for every member; the kernel stage spans
        # start now, on this (the executing) thread
        kspans = []
        for p in batch:
            if p.span:
                if p.fspan is not None:
                    p.fspan.finish()
                    p.fspan = None
                kspans.append(p.span.child("kernel", bucket=bucket, k=k))
        backend, generation = self._claim_baton()
        try:
            t0 = obsm.now()
            res = backend.run(bucket, k, cfg, pad_rows(queries, bucket))
            dt = obsm.now() - t0
        finally:
            self._return_baton()
        for ks in kspans:
            ks.finish()
        _M_EXEC_SECONDS.observe(dt)
        _M_BATCHES.inc()
        _M_REQ_EXECUTED.inc(len(batch))
        now = time.monotonic()
        served: list = []
        probes: list = []
        with self._lock:
            self._batches += 1
            self._busy_s += dt
            # a swap or mutation between the run and this bookkeeping makes
            # the generation stale: results are still valid to HAND OUT
            # (they honestly describe the generation they are stamped with),
            # but must not enter the cache or the per-shard counters
            fresh = generation == self.index_generation
            for i, p in enumerate(batch):
                result = AnnResult(
                    ids=res.ids[i],
                    dists=res.dists[i],
                    truncated=bool(res.truncated[i]),
                    latency_s=dt,
                    shard_candidates=None
                    if res.shard_candidates is None
                    else res.shard_candidates[i],
                    index_generation=generation,
                )
                if self.result_cache_size > 0:
                    # every executed request is exactly one cache miss (it
                    # would have been resolved by _serve_cache_locked
                    # otherwise), so hits + misses == served stays exact
                    self._cache_misses += 1
                    if fresh:
                        self._cache_store(p.req, group_key, result)
                self._lat_hist.observe(dt)
                _M_REQ_LATENCY.observe(dt)
                if p.t_taken is not None:
                    _M_QUEUE_WAIT.observe(p.t_taken - p.t_submit)
                self._truncated += int(result.truncated)
                self._served += 1
                self._executed += 1
                self._combine_pairs += backend.shards * k
                if res.shard_candidates is not None and fresh:
                    self._shard_candidates += res.shard_candidates[i]
                    self._shard_truncated += res.shard_truncated[i]
                if p.deadline is not None and now > p.deadline:
                    self._deadline_misses += 1
                    _M_DEADLINE_MISSES.inc()
                if self.recall_probe_every > 0:
                    self._probe_tick += 1
                    if self._probe_tick % self.recall_probe_every == 0:
                        probes.append((queries[i].copy(), np.asarray(result.ids).copy(),
                                       p.span))
                served.append((p, result))
        if probes:
            # handed to the pool outside the engine lock (the pool takes its
            # own), and before the futures resolve, so a caller that awaited
            # its result and then reads telemetry() counts its probe
            tasks = [self.pool.submit(self._probe_task, q, ids, k, generation,
                                      label="recall-probe", span=span)
                     for q, ids, span in probes]
            with self._lock:
                self._probe_tasks.extend(tasks)
        for p, result in served:  # outside the lock: callbacks are user code
            p.future._resolve(result)
            p.span.finish(outcome="served", latency_s=result.latency_s)

    # --------------------------------------------------------- telemetry --
    def reset_telemetry(self) -> None:
        """Zero the traffic counters (e.g. after warm-up); the function cache
        and its compile counts describe the engine's lifetime and are kept,
        as are the result cache's entries (its hit/miss counters reset)."""
        if self.recall_probe_every > 0:
            self._flush_probes()  # in-flight samples land pre-reset
        with self._lock:
            self._lat_hist.reset()
            self._served = 0
            self._executed = 0
            self._batches = 0
            self._truncated = 0
            self._busy_s = 0.0
            self._combine_pairs = 0
            self._shard_candidates = np.zeros(self.backend.shards, np.int64)
            self._shard_truncated = np.zeros(self.backend.shards, np.int64)
            self._cache_hits = 0
            self._cache_misses = 0
            # probes are traffic stats; the generation/swap/invalidation
            # counters describe the engine's lifetime (like compile counts)
            self._probe_tick = 0
            self._probe_recall_sum = 0.0
            self._probe_count = 0
            self._probe_skipped = 0
            self._shed = 0
            self._degraded = 0
            self._cache_only_served = 0
            self._deadline_misses = 0
            self._early_closes = 0
            self._queue_peak = 0

    def telemetry(self) -> dict:
        """The reference's telemetry keys (less ``jax_dispatch_under_lock``
        and ``jax_seconds_under_lock``: see the module docstring)."""
        if self.recall_probe_every > 0:
            self._flush_probes()  # counts must cover everything served
        with self._lock:
            per_bucket: dict[int, int] = {}
            for (bucket, _k, _cfg), c in self.compile_counts.items():
                per_bucket[bucket] = per_bucket.get(bucket, 0) + c
            out = {
                "backend": type(self.backend).__name__,
                "shards": self.backend.shards,
                "requests_served": self._served,
                "batches": self._batches,
                "queries_per_sec": self._served / self._busy_s if self._busy_s else 0.0,
                # a view over the bounded histogram (relative error <=
                # obsm.RELATIVE_ERROR_BOUND, ~9%)
                "latency_p50_s": self._lat_hist.percentile(50),
                "latency_p99_s": self._lat_hist.percentile(99),
                "truncation_rate": self._truncated / self._served if self._served else 0.0,
                "compiles_total": sum(self.compile_counts.values()),
                "compiles_per_bucket": per_bucket,
                "result_cache_hits": self._cache_hits,
                "result_cache_misses": self._cache_misses,
                "result_cache_entries": len(self._result_cache),
                "index_generation": self.index_generation,
                "index_swaps": self._swaps,
                "result_cache_invalidations": self._invalidations,
                # async pipeline / admission control
                "async": self.running,
                "queue_depth": len(self._queue),
                "queue_depth_peak": self._queue_peak,
                "shed": self._shed,
                "degraded": self._degraded,
                "cache_only_served": self._cache_only_served,
                "deadline_misses": self._deadline_misses,
                "batches_closed_early": self._early_closes,
            }
            if self.recall_probe_every > 0:
                out["recall_probe_count"] = self._probe_count
                out["recall_probe_skipped"] = self._probe_skipped
                out["live_recall_at_k"] = (
                    self._probe_recall_sum / self._probe_count
                    if self._probe_count
                    else None
                )
            out.update(self.backend.extra_telemetry())
            # WAL telemetry hoist: a mutable backend reports durability
            # stats nested under its own block; surface them top-level so
            # operators see append/fsync/group-commit rates next to QPS.
            mut = out.get("mutable")
            if isinstance(mut, dict) and isinstance(mut.get("wal"), dict):
                out["wal"] = mut["wal"]
            if self.autotune_entries_loaded:
                out["autotune_entries_loaded"] = self.autotune_entries_loaded
            if self.backend.shards > 1:
                # per-shard candidate demand + truncation, and the size of the
                # all-gather combine (id/dist pairs moved per query: shards*k).
                # Means are per EXECUTED query — result-cache hits never touch
                # the backend, so counting them would understate shard load.
                executed = max(self._executed, 1)
                out["shard_candidates_mean"] = (self._shard_candidates / executed).tolist()
                out["shard_truncation_rate"] = (self._shard_truncated / executed).tolist()
                out["combine_pairs_per_query"] = self._combine_pairs / executed
        if self._pool is not None:
            out["worker_pool"] = self._pool.stats()
        return out
