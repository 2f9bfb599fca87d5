"""Reading the traced window: ``torch.profiler`` events reduced to the
device's busy time, its idle gaps and each kernel's device time.

A device operation is an event on the device's timeline that is no user
annotation: a kernel, a copy or a fill. The spans that the profiler copies
onto the device's timeline (``record_function`` ranges, the benchmark's or
the program's, Kineto's ``gpu_user_annotation``) are no operations and are
left out, whatever their names. Busy time is the union
of the operations' intervals inside the window, so operations that overlap
on several streams count once. An idle gap is named by the innermost host
operation that was running when it began: what the host was doing while
the device waited."""
from __future__ import annotations

import re

import numpy as np

#: the marker span around the measured window in a traced run
WINDOW_SPAN = "bench.window"
#: entries of each list of ``breakdown``
TOP = 10


def kind_of(event) -> str:
    """``host`` for an event on the host, ``span`` for a user annotation on
    the device's timeline, ``device`` for a device operation."""
    if event.device_type().name == "CPU":
        return "host"
    return "span" if event.is_user_annotation() else "device"


def events_of(prof) -> list[tuple]:
    """(name, start us, end us, :func:`kind_of`) of every event of a
    finished ``torch.profiler.profile``, read from the raw Kineto results
    (building the profiler's ``FunctionEvent`` tree takes twenty times as
    long)."""
    return [(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3, kind_of(e))
            for e in prof.profiler.kineto_results.events()]


def summarize(events) -> dict:
    """From :func:`events_of`: the window (from its marker span), the device
    operations inside it, their busy union, the gaps between them, and the
    host operations (to name the gaps)."""
    marks = [e for e in events if e[3] == "host" and e[0] == WINDOW_SPAN]
    if not marks:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN!r} span")
    w0, w1 = marks[0][1], marks[0][2]
    dev = []
    host = []
    for name, start, end, kind in events:
        if kind == "host" and name != WINDOW_SPAN:
            host.append((start, end, name))
        elif kind == "device" and end > w0 and start < w1:
            dev.append((max(start, w0), min(end, w1), name))
    dev.sort()
    merged: list[list[float]] = []
    for start, end, _name in dev:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    busy_us = sum(end - start for start, end in merged)
    edges = [w0] + [x for seg in merged for x in seg] + [w1]
    gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    return {"window_us": w1 - w0, "busy_us": busy_us, "device": dev, "gaps": gaps,
            "host": host}


def device_ops(summary: dict) -> list:
    """[[name, seconds], ...]: the device operations that took most time."""
    total: dict[str, float] = {}
    for start, end, name in summary["device"]:
        total[name] = total.get(name, 0.0) + (end - start)
    top = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:160], us / 1e6] for name, us in top]


def idle_gaps(summary: dict) -> list:
    """[[host operation, seconds], ...]: the longest idle gaps, each named by
    the innermost host operation running where it began."""
    host = summary["host"]
    if host:
        starts = np.array([h[0] for h in host])
        ends = np.array([h[1] for h in host])
    out = []
    for length, at in sorted(summary["gaps"], key=lambda g: -g[0])[:TOP]:
        name = "no host operation"
        if host:
            inside = np.nonzero((starts <= at) & (ends > at))[0]
            if inside.size:
                name = host[inside[np.argmax(starts[inside])]][2]
        out.append([name[:160], length / 1e6])
    return out


def kernel_seconds(summary: dict, patterns) -> float | None:
    """Device seconds of the operations whose name holds one of the kernel
    function names in ``patterns`` (as a whole word), or None if none ran."""
    rx = re.compile(r"\b(" + "|".join(re.escape(p) for p in patterns) + r")\b")
    hits = [end - start for start, end, name in summary["device"] if rx.search(name)]
    return sum(hits) / 1e6 if hits else None
