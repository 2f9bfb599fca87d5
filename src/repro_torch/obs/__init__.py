"""Unified observability for the serving stack: metrics, tracing, export.

Three modules, layered so the hot path stays cheap:

* :mod:`repro_torch.obs.metrics` — process registry of counters, gauges and
  log-bucketed histograms (per-thread shards merged on read; documented
  percentile error bound), plus the blessed timing helpers
  (:func:`~repro_torch.obs.metrics.now` / :func:`~repro_torch.obs.metrics.timed`)
  the O001 lint rule steers ``repro_torch.serving`` / ``repro_torch.ann`` stage
  timing through.
* :mod:`repro_torch.obs.trace` — per-request span trees with explicit
  cross-thread propagation, probabilistic sampling, a bounded ring, and
  Chrome ``trace_event`` export for Perfetto / ``chrome://tracing`` on
  ``torch.profiler``'s clock; and :func:`~repro_torch.obs.trace.stage`, the
  query path's stage spans, timed on the device while a profiler records.
* :mod:`repro_torch.obs.export` — a stdlib HTTP thread serving ``/metrics``
  (Prometheus text), ``/telemetry`` (JSON) and ``/trace`` (Chrome JSON)
  for an operator's scrape.

Stdlib only on the hot path (no torch/numpy imports), so any layer of the
port may import it. The one part that reaches torch is the stage helper:
the first :func:`~repro_torch.obs.trace.stage` or
:func:`~repro_torch.obs.trace.settle_stages` call imports torch to read the
profiler's flag, and only while a ``torch.profiler`` records does a stage
open a ``record_function`` range and CUDA events, or settle read them.

It is the port's own copy of the reference's ``obs`` package: the metric
family names are the reference's (the stage counters,
``taco_stage_seconds_total`` and ``taco_stage_batches_total``, are the
port's own), and its registry is a separate object.
"""
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    RELATIVE_ERROR_BOUND,
    counter,
    default_registry,
    gauge,
    histogram,
    now,
    render_prometheus,
    snapshot,
    timed,
)
from repro_torch.obs.trace import (
    NULL_SPAN,
    NULL_STAGE,
    Span,
    Tracer,
    default_tracer,
    set_default_tracer,
    settle_stages,
    stage,
)
from repro_torch.obs.export import ObsServer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "RELATIVE_ERROR_BOUND", "counter", "default_registry", "gauge",
    "histogram", "now", "render_prometheus", "snapshot",
    "timed", "NULL_SPAN", "Span", "Tracer", "default_tracer",
    "set_default_tracer", "NULL_STAGE", "stage", "settle_stages",
    "ObsServer",
]
