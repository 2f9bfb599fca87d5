"""Reading the program's query stages: the device time its stage counters
hold, and the idle gaps of the traced window placed by its stage spans.

While a ``torch.profiler`` records, the program (``repro_torch.obs.trace``)
opens a ``record_function`` range around each stage of a batch (the root
``searcher.batch``; ``searcher.pad``, ``taco.centroid_dists``,
``taco.activation``, ``taco.collide``, ``taco.select``, ``taco.rerank``,
``searcher.to_host``), adds each stage's device seconds to
``taco_stage_seconds_total{stage=...}`` and counts the timed batches in
``taco_stage_batches_total``. A program without them reads None here."""
from __future__ import annotations

import numpy as np

#: the root span of one batch, and the span of its copies to the host
BATCH_SPAN = "searcher.batch"
TO_HOST_SPAN = "searcher.to_host"


def stage_ms(ctx, name: str) -> float | None:
    """Device milliseconds a timed batch spent in stage ``name``, from the
    program's registry after the traced window (its counters move only
    while a profiler records), or None."""
    if ctx.profile is None or ctx.traffic["driver"] != "closed_batches":
        return None
    from repro_torch.obs import metrics

    snap = metrics.snapshot()
    batches = snap.get("taco_stage_batches_total")
    seconds = snap.get(f"taco_stage_seconds_total{{stage={name}}}")
    if not batches or seconds is None:
        return None
    return 1e3 * seconds / batches


def _spans(host, name: str) -> tuple[np.ndarray, np.ndarray]:
    """(starts, ends) of the host spans called ``name``, by start."""
    rows = sorted((start, end) for start, end, n in host if n == name)
    arr = np.array(rows, dtype=np.float64).reshape(-1, 2)
    return arr[:, 0], arr[:, 1]


def _inside(at: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Whether each instant of ``at`` lies in one of the spans, which do not
    overlap one another (one caller's batches, one after the other)."""
    if starts.size == 0:
        return np.zeros(at.shape, dtype=bool)
    last = np.searchsorted(starts, at, side="right") - 1
    return (last >= 0) & (at < ends[np.maximum(last, 0)])


def between_batches_us(summary: dict) -> float | None:
    """Microseconds of the idle gaps (:func:`anns_bench.trace.summarize`)
    whose start finds the host inside ``searcher.to_host`` or inside no
    ``searcher.batch``: the device waiting on the hand-off of one batch and
    the start of the next. None where the trace has no ``searcher.batch``."""
    b_starts, b_ends = _spans(summary["host"], BATCH_SPAN)
    if b_starts.size == 0:
        return None
    h_starts, h_ends = _spans(summary["host"], TO_HOST_SPAN)
    gaps = np.array(summary["gaps"], dtype=np.float64).reshape(-1, 2)
    length, at = gaps[:, 0], gaps[:, 1]
    between = _inside(at, h_starts, h_ends) | ~_inside(at, b_starts, b_ends)
    return float(length[between].sum())
