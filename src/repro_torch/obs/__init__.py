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
  Chrome ``trace_event`` export for Perfetto / ``chrome://tracing``.
* :mod:`repro_torch.obs.export` — a stdlib HTTP thread serving ``/metrics``
  (Prometheus text), ``/telemetry`` (JSON) and ``/trace`` (Chrome JSON)
  for an operator's scrape.

Deliberately dependency-free (stdlib only, no torch/numpy imports on the
metrics/trace hot path) so any layer of the port may import it. It is the
port's own copy of the reference's ``obs`` package: the metric family names
are the reference's, and its registry is a separate object.
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
    set_enabled,
    snapshot,
    timed,
)
from repro_torch.obs.trace import (
    NULL_SPAN,
    Span,
    Tracer,
    default_tracer,
    set_default_tracer,
)
from repro_torch.obs.export import ObsServer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "RELATIVE_ERROR_BOUND", "counter", "default_registry", "gauge",
    "histogram", "now", "render_prometheus", "set_enabled", "snapshot",
    "timed", "NULL_SPAN", "Span", "Tracer", "default_tracer",
    "set_default_tracer", "ObsServer",
]
