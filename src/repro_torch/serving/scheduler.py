"""Shared background worker pool for the serving stack (mirrors
``repro.serving.scheduler``; threading only).

Serving wants exactly one place where background work runs: the engine's
drain worker (continuous micro-batch formation), background compaction
(:mod:`repro_torch.ann.compaction`), and recall probes all compete for the same
spare cycles, and none of them may ever run on a caller's serving thread.
A :class:`WorkerPool` hosts both kinds of work:

  * **tasks** — one-shot jobs (:meth:`submit` -> :class:`WorkTask`): a
    compaction build, one recall probe. Executed FIFO by a small fixed set
    of daemon worker threads, started lazily on first submit.
  * **services** — long-running loops (:meth:`spawn`): an engine's drain
    worker. Each gets its own dedicated daemon thread (a loop would
    otherwise starve the task queue), tracked by the pool for stats and
    shutdown accounting; the owner stops the loop (the engine's ``close()``)
    — the pool only observes it.

Every :class:`WorkTask` records the name of the thread that executed it
(``thread_name``), which is how the tests pin the "never on a caller's
thread" contract.

Process-wide default: :func:`get_shared_pool` lazily creates one shared
pool that engines, compaction and probes default to, so an application gets
a single bounded set of maintenance threads instead of one per component.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque

from repro_torch.obs import metrics as obsm

# Process-wide pool metric families (repro_torch.obs registry). Shared across
# pools: an application's maintenance load is one bounded set of threads,
# so the aggregate is the number an operator wants.
_M_QUEUE_DEPTH = obsm.gauge(
    "taco_pool_queue_depth", "Tasks waiting in the worker-pool queue"
)
_M_TASKS = obsm.counter(
    "taco_pool_tasks_total", "Worker-pool tasks completed, by outcome",
    labelnames=("outcome",),
)
_M_TASKS_OK = _M_TASKS.labels(outcome="ok")
_M_TASKS_FAILED = _M_TASKS.labels(outcome="failed")
_M_TASK_SECONDS = obsm.histogram(
    "taco_pool_task_seconds", "Worker-pool task execution wall time"
)
_M_TASK_WAIT = obsm.histogram(
    "taco_pool_task_wait_seconds", "Queue wait from submit to task start"
)


class WorkTask:
    """Handle to one submitted unit of work.

    The future third of the scheduler: ``result(timeout=)`` joins (re-raising
    the task's exception), ``done()`` polls, ``add_done_callback(fn)`` runs
    ``fn(task)`` on the executing worker thread (immediately, on the calling
    thread, if already done). ``thread_name`` names the worker that ran it.
    """

    __slots__ = ("label", "thread_name", "_cond", "_done", "_result",
                 "_exc", "_callbacks")

    def __init__(self, label: str | None = None):
        self.label = label
        self.thread_name: str | None = None
        self._cond = threading.Condition(threading.Lock())
        self._done = False
        self._result = None
        self._exc: BaseException | None = None
        self._callbacks: list = []

    def done(self) -> bool:
        with self._cond:
            return self._done

    def result(self, timeout: float | None = None):
        """Wait for completion; returns the task's return value or re-raises
        its exception. TimeoutError if still running after ``timeout``."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._done, timeout):
                raise TimeoutError(
                    f"task {self.label or '<unnamed>'} still running"
                )
            if self._exc is not None:
                raise self._exc
            return self._result

    def exception(self, timeout: float | None = None) -> BaseException | None:
        with self._cond:
            if not self._cond.wait_for(lambda: self._done, timeout):
                raise TimeoutError(
                    f"task {self.label or '<unnamed>'} still running"
                )
            return self._exc

    def add_done_callback(self, fn) -> None:
        with self._cond:
            if not self._done:
                self._callbacks.append(fn)
                return
        fn(self)

    def _resolve(self, result=None, exc: BaseException | None = None) -> None:
        with self._cond:
            self.thread_name = threading.current_thread().name
            self._result = result
            self._exc = exc
            self._done = True
            callbacks, self._callbacks = self._callbacks, []
            self._cond.notify_all()
        for fn in callbacks:
            try:
                fn(self)
            except Exception:  # a bad callback must not kill the worker
                pass


def _default_workers() -> int:
    # at least 2 so a long compaction build cannot starve recall probes;
    # capped — maintenance work should never oversubscribe the host
    return max(2, min(4, os.cpu_count() or 1))


class WorkerPool:
    """A small fixed pool of daemon task workers + tracked service threads.

    See the module docstring for the task/service split. The pool never
    executes anything on the submitting thread.
    """

    def __init__(self, workers: int | None = None, *, name: str = "taco-pool"):
        self.name = name
        self.workers = _default_workers() if workers is None else max(1, int(workers))
        self._cond = threading.Condition(threading.Lock())
        # (task, fn, args, kwargs, coalesce_key-or-None, t_submit)
        self._tasks: deque[tuple] = deque()
        self._threads: list[threading.Thread] = []
        self._services: list[threading.Thread] = []
        self._active = 0
        self._completed = 0
        self._failed = 0
        self._coalesced: dict = {}  # coalesce key -> queued (not started) task
        self._shutdown = False

    # --------------------------------------------------------------- tasks --
    def submit(self, fn, *args, label: str | None = None, **kwargs) -> WorkTask:
        """Queue ``fn(*args, **kwargs)`` for a pool worker; returns its
        :class:`WorkTask`. FIFO order; never runs on the calling thread."""
        task = WorkTask(label)
        with self._cond:
            if self._shutdown:
                raise RuntimeError(f"WorkerPool {self.name!r} is shut down")
            self._tasks.append((task, fn, args, kwargs, None, obsm.now()))
            _M_QUEUE_DEPTH.set(len(self._tasks))
            if len(self._threads) < self.workers:
                t = threading.Thread(
                    target=self._worker,
                    name=f"{self.name}-worker-{len(self._threads)}",
                    daemon=True,
                )
                self._threads.append(t)
                t.start()
            self._cond.notify()
        return task

    def submit_coalesced(self, fn, *args, key, label: str | None = None,
                         **kwargs) -> WorkTask:
        """Like :meth:`submit`, but at most one task per ``key`` sits in
        the queue: while one is queued (not yet started), further submits
        return it instead of enqueueing another. A task that has *started*
        no longer coalesces — the next submit queues a fresh one, so a
        caller that saw its work enqueued is always covered by a run that
        begins afterwards. This is the group-commit shape: N appenders
        kick the WAL flusher, one queued flush absorbs them all."""
        with self._cond:
            if self._shutdown:
                raise RuntimeError(f"WorkerPool {self.name!r} is shut down")
            queued = self._coalesced.get(key)
            if queued is not None:
                return queued
            task = WorkTask(label)
            self._coalesced[key] = task
            self._tasks.append((task, fn, args, kwargs, key, obsm.now()))
            _M_QUEUE_DEPTH.set(len(self._tasks))
            if len(self._threads) < self.workers:
                t = threading.Thread(
                    target=self._worker,
                    name=f"{self.name}-worker-{len(self._threads)}",
                    daemon=True,
                )
                self._threads.append(t)
                t.start()
            self._cond.notify()
        return task

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._tasks and not self._shutdown:
                    self._cond.wait()
                if self._shutdown and not self._tasks:
                    return
                task, fn, args, kwargs, key, t_submit = self._tasks.popleft()
                if key is not None and self._coalesced.get(key) is task:
                    del self._coalesced[key]  # started: stop coalescing
                self._active += 1
                _M_QUEUE_DEPTH.set(len(self._tasks))
            t0 = obsm.now()
            _M_TASK_WAIT.observe(t0 - t_submit)
            try:
                task._resolve(result=fn(*args, **kwargs))
                ok = True
            except BaseException as e:  # surface via result(), keep the worker
                task._resolve(exc=e)
                ok = False
            _M_TASK_SECONDS.observe(obsm.now() - t0)
            (_M_TASKS_OK if ok else _M_TASKS_FAILED).inc()
            with self._cond:
                self._active -= 1
                self._completed += 1
                self._failed += 0 if ok else 1
                self._cond.notify_all()

    # ------------------------------------------------------------ services --
    def spawn(self, fn, *args, name: str | None = None) -> threading.Thread:
        """Start ``fn(*args)`` on a dedicated daemon thread (a long-running
        service loop, e.g. an engine's drain worker). The pool tracks it for
        stats; the OWNER is responsible for making the loop return (the
        thread is a daemon, so it never blocks interpreter exit)."""
        with self._cond:
            if self._shutdown:
                raise RuntimeError(f"WorkerPool {self.name!r} is shut down")
            self._services = [t for t in self._services if t.is_alive()]
            t = threading.Thread(
                target=fn, args=args,
                name=name or f"{self.name}-service-{len(self._services)}",
                daemon=True,
            )
            self._services.append(t)
        t.start()
        return t

    # ----------------------------------------------------------- lifecycle --
    def join(self, timeout: float | None = None) -> bool:
        """Wait until the task queue is empty and no task is executing
        (services keep running). True if drained within ``timeout``."""
        with self._cond:
            return self._cond.wait_for(
                lambda: not self._tasks and self._active == 0, timeout
            )

    def shutdown(self, wait: bool = True, timeout: float | None = None) -> None:
        """Stop accepting tasks; optionally wait for queued ones to finish.
        Service threads are owner-stopped, not joined here."""
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
        if wait:
            deadline = None if timeout is None else time.monotonic() + timeout
            for t in list(self._threads):
                left = None if deadline is None else max(0.0, deadline - time.monotonic())
                t.join(left)

    @property
    def alive(self) -> bool:
        return not self._shutdown

    def stats(self) -> dict:
        with self._cond:
            return {
                "name": self.name,
                "workers": len(self._threads),
                "services": sum(t.is_alive() for t in self._services),
                "queued": len(self._tasks),
                "active": self._active,
                "completed": self._completed,
                "failed": self._failed,
            }

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        s = self.stats()
        return (f"WorkerPool({s['name']!r}, workers={s['workers']}, "
                f"queued={s['queued']}, active={s['active']}, "
                f"completed={s['completed']})")


# -------------------------------------------------------- process default --
_shared_lock = threading.Lock()
_shared: WorkerPool | None = None


def get_shared_pool() -> WorkerPool:
    """The process-wide default :class:`WorkerPool` (created lazily).

    Engines, background compaction and recall probes all default here, so
    one application gets one bounded set of maintenance threads. A pool
    that was shut down is replaced by a fresh one on next use."""
    global _shared
    with _shared_lock:
        if _shared is None or not _shared.alive:
            _shared = WorkerPool(name="taco-shared")
        return _shared
