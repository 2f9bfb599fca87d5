"""Structured per-request tracing with Chrome ``trace_event`` export.

One sampled request becomes a **span tree**: a root span opened at
``submit()`` and children for each stage it passes through — queue wait,
batch formation, the kernel execution, a recall probe on the worker
pool — plus separate root traces for the durability path (WAL group
commits, compactions, mutations). Spans cross threads **explicitly**:
the engine stores the root :class:`Span` on its ``_Pending`` entry, the
drain worker opens children from it, and pool tasks receive it as an
argument — there is no implicit thread-local context to lose at an
``AnnFuture``/drain-worker/``WorkerPool`` boundary.

Sampling and memory: :meth:`Tracer.start_trace` keeps a trace with
probability ``sample_rate`` and otherwise hands back :data:`NULL_SPAN`,
a falsy no-op whose children are itself — unsampled requests pay an
attribute check per stage, nothing more. Finished spans land in a
bounded ring (``deque(maxlen=capacity)``; old spans fall out), so a
long-running server holds a fixed-size window of recent traces.

Lock discipline: the tracer takes **no locks at all** — span ids come
from an atomic counter, finished spans are single ``deque.append``
calls — so spans may be opened and finished while holding any
serving-stack lock without creating lock-order edges.

Export: :meth:`Tracer.to_chrome` renders the ring as a Chrome
``trace_event`` JSON object (``{"traceEvents": [...]}`` of ``"ph": "X"``
complete events) that loads directly in ``chrome://tracing`` or
https://ui.perfetto.dev; :meth:`Tracer.dump_chrome` writes it to a file
(a server's trace output). Durations come from the process-monotonic
clock (:func:`~repro_torch.obs.metrics.now`); each span's start is placed
on the Unix-epoch clock that ``torch.profiler`` (Kineto) stamps its events
with, through the pair of readings the tracer takes at creation. So
``to_chrome`` writes ``ts`` in microseconds after a ``baseTimeNanoseconds``
on that clock, as the profiler's own export does: base + ts places a span
of either trace of one process on one axis.

Query stages: :func:`stage` opens the named stages of the port's query
path (``searcher.batch``, ``taco.activation``, ...). With no
``torch.profiler`` recording it is one check of the profiler's flag and
returns a shared no-op. While a profiler records it opens a
``torch.profiler.record_function`` range (the trace's clock), times the
stage on its device (a CUDA event pair on the current stream on the card,
the host clock on the CPU) and adds the seconds to the counter
``taco_stage_seconds_total{stage=...}``. An event pair spans the stream's
time from the stage's first launch to its last op's end, so it holds the
dispatch gaps between the stage's ops as well as their device time. Event
pairs wait in a bounded queue until :func:`settle_stages` finds them
complete, which the searchers' ``run_padded`` call where a batch's results
have reached the host; it also counts the timed batch in
``taco_stage_batches_total``. Nothing here waits for the card. The leaf
stages of a batch settle in that batch; ``searcher.batch`` ends after its
settle and ``searcher.to_host`` just before it, so their seconds may come
at a later settle. A caller of ``core.taco.query`` that settles nothing leaves at
most :data:`PENDING_CAP` pairs queued, the oldest falling out unread.
"""
from __future__ import annotations

import itertools
import json
import random
import threading
import time
from collections import deque

from repro_torch.obs import metrics as _metrics
from repro_torch.obs.metrics import now

__all__ = ["Span", "Tracer", "NULL_SPAN", "default_tracer", "set_default_tracer",
           "NULL_STAGE", "PENDING_CAP", "stage", "settle_stages"]


class Span:
    """One timed stage of a trace; children may start on other threads."""

    __slots__ = ("_tracer", "trace_id", "span_id", "parent_id", "name",
                 "t0", "attrs")

    def __init__(self, tracer: "Tracer", trace_id: int, span_id: int,
                 parent_id: int | None, name: str, attrs: dict):
        self._tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = now()
        self.attrs = attrs

    def child(self, name: str, **attrs) -> "Span":
        """Open a child span (starts now, on the calling thread). Valid
        even after this span finished — a probe task may still attach."""
        return self._tracer._start(self.trace_id, self.span_id, name, attrs)

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def finish(self, **attrs) -> None:
        if attrs:
            self.attrs.update(attrs)
        self._tracer._record(self, now() - self.t0)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.finish()

    def __bool__(self) -> bool:
        return True

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"id={self.span_id}, parent={self.parent_id})")


class _NullSpan:
    """Falsy no-op stand-in for unsampled traces; its children are itself,
    so call sites never branch on whether a request was sampled."""

    __slots__ = ()

    def child(self, name: str, **attrs) -> "_NullSpan":
        return self

    def annotate(self, **attrs) -> None:
        pass

    def finish(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass

    def __bool__(self) -> bool:
        return False

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return "NULL_SPAN"


NULL_SPAN = _NullSpan()


class Tracer:
    """Sampling span factory + bounded ring of finished spans."""

    def __init__(self, sample_rate: float = 0.0, capacity: int = 4096,
                 seed: int | None = None):
        if not 0.0 <= float(sample_rate) <= 1.0:
            raise ValueError(f"sample_rate={sample_rate} out of [0, 1]")
        self.sample_rate = float(sample_rate)
        self.capacity = int(capacity)
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self._ids = itertools.count(1)  # C-level next(): atomic under GIL
        self._rand = random.Random(seed)
        self._epoch = now()
        #: the Unix-epoch nanoseconds of ``_epoch`` (Kineto's clock)
        self.epoch_unix_ns = time.time_ns()
        self.started = 0  # sampled roots (informational, approximate)
        self.dropped = 0  # unsampled roots

    # ---------------------------------------------------------- produce --
    def start_trace(self, name: str, **attrs):
        """Root span of a new trace, or :data:`NULL_SPAN` when the
        sampling coin says skip."""
        if self.sample_rate <= 0.0 or (
            self.sample_rate < 1.0 and self._rand.random() >= self.sample_rate
        ):
            self.dropped += 1
            return NULL_SPAN
        self.started += 1
        tid = next(self._ids)
        return Span(self, tid, next(self._ids), None, name, attrs)

    def _start(self, trace_id: int, parent_id: int, name: str, attrs: dict) -> Span:
        return Span(self, trace_id, next(self._ids), parent_id, name, attrs)

    def _record(self, span: Span, dur: float) -> None:
        t = threading.current_thread()
        self._ring.append({
            "name": span.name,
            "trace_id": span.trace_id,
            "span_id": span.span_id,
            "parent_id": span.parent_id,
            "t0": span.t0 - self._epoch,
            "dur": dur,
            "tid": t.ident,
            "thread": t.name,
            "attrs": dict(span.attrs),
        })

    # ---------------------------------------------------------- consume --
    def spans(self) -> list[dict]:
        """Finished spans currently in the ring (oldest first)."""
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def to_chrome(self) -> dict:
        """The ring as a Chrome ``trace_event`` JSON object (Perfetto /
        ``chrome://tracing`` load it directly). ``ts`` is microseconds after
        ``baseTimeNanoseconds``, the tracer's creation on the Unix-epoch
        clock of a ``torch.profiler`` export."""
        events = []
        threads: dict[int, str] = {}
        for s in self.spans():
            threads.setdefault(s["tid"], s["thread"])
            args = {
                "trace_id": s["trace_id"],
                "span_id": s["span_id"],
                "parent_id": s["parent_id"],
            }
            args.update(s["attrs"])
            events.append({
                "name": s["name"],
                "cat": "taco",
                "ph": "X",
                "ts": s["t0"] * 1e6,
                "dur": s["dur"] * 1e6,
                "pid": 1,
                "tid": s["tid"],
                "args": args,
            })
        for tid, tname in threads.items():
            events.append({
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "args": {"name": tname},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "baseTimeNanoseconds": self.epoch_unix_ns}

    def dump_chrome(self, path: str) -> int:
        """Write :meth:`to_chrome` JSON to ``path``; returns the number of
        span events written."""
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
        return sum(1 for e in doc["traceEvents"] if e["ph"] == "X")


# ---------------------------------------------------- process default --
# Rate 0 by default: the stack is instrumented everywhere, but records
# nothing until a server (or a test) installs a sampling tracer.
_default = Tracer(sample_rate=0.0)


def default_tracer() -> Tracer:
    """The process-wide tracer instrumented modules open spans on."""
    return _default


def set_default_tracer(tracer: Tracer) -> Tracer:
    """Replace the process tracer (a server's sampling rate); returns
    the previous one so tests can restore it."""
    global _default
    prev = _default
    _default = tracer
    return prev


# ------------------------------------------------------------ stages --
_M_STAGE_SECONDS = _metrics.counter(
    "taco_stage_seconds_total",
    "Seconds of each query stage on its device's stream, dispatch gaps "
    "included, while a torch.profiler records",
    labelnames=("stage",),
)
_M_STAGE_BATCHES = _metrics.counter(
    "taco_stage_batches_total",
    "Query batches whose stages were timed (while a torch.profiler records)",
)
#: event pairs that may wait unread (the oldest fall out past it)
PENDING_CAP = 1024
#: (stage, start event, end event) on the card, not yet read
_pending: deque = deque(maxlen=PENDING_CAP)


def _first_check() -> bool:
    """Import torch once and put its profiler flag in ``_profiling``'s
    place, so every later check is one C call."""
    global _profiling
    import torch

    _profiling = torch._C._autograd._profiler_enabled
    return _profiling()


#: whether a ``torch.profiler`` records (torch's own flag after the first call)
_profiling = _first_check


class _NullStage:
    """The shared no-op :func:`stage` returns when no profiler records."""

    __slots__ = ()

    def __enter__(self) -> "_NullStage":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


NULL_STAGE = _NullStage()


class _Stage:
    """One timed stage: a ``record_function`` range around a CUDA event
    pair on the device's current stream (a card) or two host-clock
    readings (the CPU, where the work is done when the host returns)."""

    __slots__ = ("name", "device", "_range", "_t0", "_start")

    def __init__(self, name: str, device):
        self.name = name
        self.device = device
        self._range = self._t0 = self._start = None

    def __enter__(self) -> "_Stage":
        import torch

        if self.device is not None:
            self.device = torch.device(self.device)
            if self.device.type != "cuda":
                self.device = None
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if self.device is None:
            self._t0 = now()
        else:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.device is None:
            _M_STAGE_SECONDS.labels(stage=self.name).inc(now() - self._t0)
        else:
            import torch

            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            _pending.append((self.name, self._start, end))
        self._range.__exit__(exc_type, exc, tb)


def stage(name: str, device=None):
    """A context around one stage of the query path. While a
    ``torch.profiler`` records: a ``record_function(name)`` range, and the
    stage's time on ``device`` (the host clock unless it is a card) added
    to ``taco_stage_seconds_total{stage=name}``. Otherwise the shared
    no-op :data:`NULL_STAGE`, after one check of the profiler's flag."""
    if not _profiling():
        return NULL_STAGE
    return _Stage(name, device)


def settle_stages(batch: bool = False) -> None:
    """Add each pending stage whose end event has completed to
    ``taco_stage_seconds_total``; the others stay for a later call
    (``Event.query``: this never waits for the card). Called where a
    batch's results have reached the host; with ``batch`` it also counts
    that batch in ``taco_stage_batches_total`` if a profiler records."""
    if batch and _profiling():
        _M_STAGE_BATCHES.inc()
    for _ in range(len(_pending)):
        try:
            item = _pending.popleft()
        except IndexError:  # another thread settled the rest
            return
        name, start, end = item
        if end.query():
            _M_STAGE_SECONDS.labels(stage=name).inc(start.elapsed_time(end) / 1e3)
        else:
            _pending.append(item)
