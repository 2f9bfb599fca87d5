"""Process-wide metrics registry: counters, gauges, log-bucketed histograms.

The serving stack emits its operational numbers here — one registry per
process, scraped by :mod:`repro_torch.obs.export` (``/metrics``), folded into
a serving engine's telemetry, and read back by benchmarks for their
stage-percentile rows. Three metric kinds:

* :class:`Counter` — monotone float/int accumulator (``inc``).
* :class:`Gauge` — last-write-wins instantaneous value (``set``).
* :class:`Histogram` — log-bucketed latency/size distribution with
  **bounded memory** and a **documented relative-error bound** on the
  percentiles it reports (below).

Hot-path contract (the lint and lock-order gates)
-------------------------------------------------
``inc()``/``observe()`` may be called while holding any serving-stack
lock, so they must never block and never take a lock themselves on the
steady-state path. Every metric therefore keeps **per-thread shards**:
a thread's first update allocates its private cell (one short-lived
acquisition of the metric's creation mutex — the only lock in this
module), and every later update touches only that cell (pure list/int
arithmetic under the GIL). Readers (``value``/``percentile``/scrapes)
merge the shards under the creation mutex; shard cells are append-only,
so a reader sees each shard at-or-before its latest update — scrapes are
eventually consistent, never torn. A thread that exits leaves its cell
behind: memory is bounded by *threads ever observed*, which the serving
stack bounds by design (fixed pool + one drain worker per engine).

Histogram buckets and the percentile error bound
------------------------------------------------
Buckets are geometric: boundaries at ``2**(LOG2_LO + i / SUBDIV)`` with
``SUBDIV = 8`` sub-buckets per octave spanning ``2**LOG2_LO`` (~1 µs)
to ``2**LOG2_HI`` (~17 min). A reported percentile is the geometric
midpoint of the bucket containing that rank, so for any value inside
the covered range the relative error is at most

    ``RELATIVE_ERROR_BOUND = 2**(1 / SUBDIV) - 1  ≈ 9.05%``

(one full bucket width; the typical error is half that). Values at or
below zero are counted exactly (a zero-latency cache hit reports 0.0,
not a bucket midpoint); values beyond the last boundary clamp into the
edge buckets, where only the ordering — not the bound — is guaranteed.
Memory per histogram shard is one fixed ``(LOG2_HI - LOG2_LO) * SUBDIV``
-slot integer list, independent of the number of observations.

Timing helpers
--------------
:func:`now` (monotonic seconds) and :func:`timed` (context manager that
observes a duration into a histogram) are the blessed route for stage
timing in ``repro_torch.serving`` / ``repro_torch.ann`` — the O001 lint rule rejects
direct ``time.perf_counter()`` pairs there so stage timings cannot fork
from the registry again.
"""
from __future__ import annotations

import math
import threading
import time
from contextlib import contextmanager

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "counter", "gauge", "histogram", "default_registry",
    "render_prometheus", "snapshot",
    "now", "timed", "RELATIVE_ERROR_BOUND",
]

# --------------------------------------------------------------- clock --
def now() -> float:
    """Monotonic high-resolution timestamp in seconds (the blessed
    serving-stack clock: O001 points direct perf_counter users here)."""
    return time.perf_counter()


# ------------------------------------------------------------- metrics --
class Counter:
    """Monotone accumulator; per-thread shards, merged on read."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._mu = threading.Lock()  # shard-list creation + merge only
        self._shards: list[list[float]] = []
        self._tls = threading.local()

    def _new_cell(self) -> list[float]:
        cell = [0.0]
        with self._mu:
            self._shards.append(cell)
        self._tls.cell = cell
        return cell

    def inc(self, n: float = 1.0) -> None:
        try:
            cell = self._tls.cell
        except AttributeError:
            cell = self._new_cell()
        cell[0] += n

    @property
    def value(self) -> float:
        with self._mu:
            return float(sum(c[0] for c in self._shards))

    def reset(self) -> None:
        with self._mu:
            for c in self._shards:
                c[0] = 0.0


class Gauge:
    """Last-write-wins instantaneous value (queue depth, live rows)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0  # single attribute store: atomic under the GIL

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        self._value = 0.0


#: geometric bucket layout — see module docstring for the error bound
LOG2_LO = -20  # ~9.5e-7: finest latency the buckets resolve
LOG2_HI = 10  # 1024 s: slowest stage the buckets resolve
SUBDIV = 8  # sub-buckets per octave
NBUCKETS = (LOG2_HI - LOG2_LO) * SUBDIV
#: worst-case relative error of a reported percentile for in-range values
RELATIVE_ERROR_BOUND = 2.0 ** (1.0 / SUBDIV) - 1.0


def bucket_index(v: float) -> int:
    """Bucket slot for a positive value (clamped into the edge slots)."""
    i = int((math.log2(v) - LOG2_LO) * SUBDIV)
    if i < 0:
        return 0
    if i >= NBUCKETS:
        return NBUCKETS - 1
    return i


def bucket_upper(i: int) -> float:
    """Exclusive upper boundary of bucket ``i``."""
    return 2.0 ** (LOG2_LO + (i + 1) / SUBDIV)


def bucket_mid(i: int) -> float:
    """Geometric midpoint of bucket ``i`` (the reported percentile)."""
    return 2.0 ** (LOG2_LO + (i + 0.5) / SUBDIV)


class _HistShard:
    """One thread's private accumulation cell."""

    __slots__ = ("counts", "zeros", "count", "sum", "vmin", "vmax")

    def __init__(self):
        self.counts = [0] * NBUCKETS
        self.zeros = 0  # observations <= 0 (exact, outside the log grid)
        self.count = 0
        self.sum = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf


class Histogram:
    """Log-bucketed distribution; fixed memory, documented error bound.

    Usable standalone (an engine's private latency view) or registered
    (the process families ``/metrics`` exports) — same object either way.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._mu = threading.Lock()  # shard-list creation + merge only
        self._shards: list[_HistShard] = []
        self._tls = threading.local()

    def _new_shard(self) -> _HistShard:
        sh = _HistShard()
        with self._mu:
            self._shards.append(sh)
        self._tls.shard = sh
        return sh

    def observe(self, v: float) -> None:
        try:
            sh = self._tls.shard
        except AttributeError:
            sh = self._new_shard()
        v = float(v)
        if v > 0.0:
            sh.counts[bucket_index(v)] += 1
        else:
            sh.zeros += 1
        sh.count += 1
        sh.sum += v
        if v < sh.vmin:
            sh.vmin = v
        if v > sh.vmax:
            sh.vmax = v

    # ------------------------------------------------------------ reads --
    def _merged(self) -> tuple[list[int], int, int, float, float, float]:
        with self._mu:
            shards = list(self._shards)
        counts = [0] * NBUCKETS
        zeros = count = 0
        total = 0.0
        vmin, vmax = math.inf, -math.inf
        for sh in shards:
            sc = sh.counts
            for i in range(NBUCKETS):
                counts[i] += sc[i]
            zeros += sh.zeros
            count += sh.count
            total += sh.sum
            vmin = min(vmin, sh.vmin)
            vmax = max(vmax, sh.vmax)
        return counts, zeros, count, total, vmin, vmax

    @property
    def count(self) -> int:
        return self._merged()[2]

    @property
    def sum(self) -> float:
        return self._merged()[3]

    def percentile(self, q: float) -> float:
        """The q-th percentile (q in [0, 100]) as a bucket midpoint; see
        the module docstring for the relative-error bound. 0.0 when empty
        (or when the rank falls among the <= 0 observations)."""
        counts, zeros, count, _total, _vmin, _vmax = self._merged()
        if count == 0:
            return 0.0
        rank = max(1, math.ceil(q / 100.0 * count))
        if rank <= zeros:
            return 0.0
        cum = zeros
        for i in range(NBUCKETS):
            cum += counts[i]
            if cum >= rank:
                return bucket_mid(i)
        return bucket_mid(NBUCKETS - 1)

    def summary(self) -> dict:
        """count/sum/min/max plus p50/p90/p99 in one merged pass."""
        counts, zeros, count, total, vmin, vmax = self._merged()
        out = {
            "count": count,
            "sum": total,
            "min": vmin if count else 0.0,
            "max": vmax if count else 0.0,
        }
        for q in (50, 90, 99):
            key = f"p{q}"
            if count == 0:
                out[key] = 0.0
                continue
            rank = max(1, math.ceil(q / 100.0 * count))
            if rank <= zeros:
                out[key] = 0.0
                continue
            cum = zeros
            val = bucket_mid(NBUCKETS - 1)
            for i in range(NBUCKETS):
                cum += counts[i]
                if cum >= rank:
                    val = bucket_mid(i)
                    break
            out[key] = val
        return out

    def cumulative_buckets(self) -> list[tuple[float, int]]:
        """Nonempty ``(upper_bound, cumulative_count)`` pairs (Prometheus
        ``le`` semantics; <= 0 observations count under every bound)."""
        counts, zeros, count, _total, _vmin, _vmax = self._merged()
        out: list[tuple[float, int]] = []
        cum = zeros
        for i in range(NBUCKETS):
            if counts[i]:
                cum += counts[i]
                out.append((bucket_upper(i), cum))
        if not out and count:
            out.append((bucket_upper(0), count))
        return out

    def reset(self) -> None:
        with self._mu:
            shards = list(self._shards)
        for sh in shards:
            sh.counts = [0] * NBUCKETS
            sh.zeros = 0
            sh.count = 0
            sh.sum = 0.0
            sh.vmin = math.inf
            sh.vmax = -math.inf


@contextmanager
def timed(hist: Histogram):
    """Observe the wall time of the ``with`` body into ``hist`` — the
    blessed stage-timing shape (O001)."""
    t0 = now()
    try:
        yield
    finally:
        hist.observe(now() - t0)


# ------------------------------------------------------------ registry --
class _Family:
    """One registered metric name: label-set -> child metric."""

    def __init__(self, name: str, help: str, cls, labelnames: tuple):
        self.name = name
        self.help = help
        self.cls = cls
        self.labelnames = labelnames
        self._mu = threading.Lock()
        self._children: dict[tuple, object] = {}

    def labels(self, **labelvalues):
        if tuple(sorted(labelvalues)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"{self.name}: labels {sorted(labelvalues)} != declared "
                f"{sorted(self.labelnames)}"
            )
        key = tuple(str(labelvalues[k]) for k in self.labelnames)
        with self._mu:
            child = self._children.get(key)
            if child is None:
                child = self.cls(self.name, self.help)
                self._children[key] = child
            return child

    def children(self) -> list[tuple[tuple, object]]:
        with self._mu:
            return sorted(self._children.items())


class MetricsRegistry:
    """The process registry: idempotent family registration + scraping."""

    def __init__(self):
        self._mu = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _family(self, name: str, help: str, cls, labelnames) -> _Family:
        labelnames = tuple(labelnames)
        with self._mu:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, help, cls, labelnames)
                self._families[name] = fam
        if fam.cls is not cls or fam.labelnames != labelnames:
            raise ValueError(
                f"metric {name!r} re-registered as {cls.__name__}"
                f"{labelnames} (was {fam.cls.__name__}{fam.labelnames})"
            )
        return fam

    def counter(self, name: str, help: str = "", labelnames=()):
        """A :class:`Counter` family; with no labels, the single child."""
        fam = self._family(name, help, Counter, labelnames)
        return fam if labelnames else fam.labels()

    def gauge(self, name: str, help: str = "", labelnames=()):
        fam = self._family(name, help, Gauge, labelnames)
        return fam if labelnames else fam.labels()

    def histogram(self, name: str, help: str = "", labelnames=()):
        fam = self._family(name, help, Histogram, labelnames)
        return fam if labelnames else fam.labels()

    def families(self) -> list[_Family]:
        with self._mu:
            return [f for _, f in sorted(self._families.items())]

    def reset(self) -> None:
        """Zero every metric (bench warm-up / test isolation)."""
        for fam in self.families():
            for _lv, child in fam.children():
                child.reset()

    # ---------------------------------------------------------- export --
    def snapshot(self) -> dict:
        """JSON-ready view: ``{name{labels}: value | histogram summary}``."""
        out: dict = {}
        for fam in self.families():
            for lv, child in fam.children():
                key = fam.name
                if fam.labelnames:
                    inner = ",".join(
                        f"{k}={v}" for k, v in zip(fam.labelnames, lv)
                    )
                    key = f"{fam.name}{{{inner}}}"
                out[key] = (
                    child.summary() if fam.cls is Histogram else child.value
                )
        return out

    def render_prometheus(self) -> str:
        """The registry in Prometheus text exposition format 0.0.4."""
        lines: list[str] = []
        for fam in self.families():
            lines.append(f"# HELP {fam.name} {_esc_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.cls.kind}")
            for lv, child in fam.children():
                base = list(zip(fam.labelnames, lv))
                if fam.cls is Histogram:
                    _c, _z, count, total, _lo, _hi = child._merged()
                    for ub, cum in child.cumulative_buckets():
                        lines.append(
                            f"{fam.name}_bucket"
                            f"{_labels(base + [('le', _fmt(ub))])} {cum}"
                        )
                    lines.append(
                        f"{fam.name}_bucket{_labels(base + [('le', '+Inf')])}"
                        f" {count}"
                    )
                    lines.append(f"{fam.name}_sum{_labels(base)} {_fmt(total)}")
                    lines.append(f"{fam.name}_count{_labels(base)} {count}")
                else:
                    lines.append(f"{fam.name}{_labels(base)} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"


def _esc_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _esc_label(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels(pairs) -> str:
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_esc_label(str(v))}"' for k, v in pairs)
    return "{" + inner + "}"


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


# ---------------------------------------------------- process default --
_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every instrumented module records into."""
    return _DEFAULT


def counter(name: str, help: str = "", labelnames=()):
    return _DEFAULT.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames=()):
    return _DEFAULT.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames=()):
    return _DEFAULT.histogram(name, help, labelnames)


def render_prometheus() -> str:
    return _DEFAULT.render_prometheus()


def snapshot() -> dict:
    return _DEFAULT.snapshot()
