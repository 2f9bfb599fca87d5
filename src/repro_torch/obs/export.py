"""Stdlib-only HTTP export surface for the observability layer.

A server process (and the tests) start one
:class:`ObsServer`: a ``ThreadingHTTPServer`` on a daemon thread serving

* ``GET /metrics``   — the process registry in Prometheus text format
  0.0.4 (``Content-Type: text/plain; version=0.0.4``), scrapeable by a
  stock Prometheus;
* ``GET /telemetry`` — a JSON snapshot: the engine's ``telemetry()``
  dict (when a provider callable was wired) plus the raw registry
  snapshot under ``"metrics"``;
* ``GET /trace``     — the tracer's ring as Chrome ``trace_event`` JSON
  (save the response body and load it in Perfetto / chrome://tracing).

The handler only *reads* — registry merges and ring copies — so a
scrape never blocks the serving path; a provider exception returns 500
with the error text instead of killing the listener. Binds localhost by
default: this is an operator port, not a public API.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

__all__ = ["ObsServer"]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class ObsServer:
    """Live export endpoint over a registry + tracer (daemon thread).

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    ``telemetry_fn`` is an optional zero-arg callable returning a
    JSON-serializable dict (the engine's ``telemetry``), merged into
    ``/telemetry`` next to the registry snapshot.
    """

    def __init__(self, port: int = 0, *, host: str = "127.0.0.1",
                 registry: _metrics.MetricsRegistry | None = None,
                 tracer: _trace.Tracer | None = None,
                 telemetry_fn=None):
        self.registry = registry or _metrics.default_registry()
        self.tracer = tracer  # None: resolve the default at request time
        self.telemetry_fn = telemetry_fn
        server = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # silence per-request stderr
                pass

            def do_GET(self):
                try:
                    body, ctype = server._render(self.path)
                except KeyError:
                    self.send_error(404, "unknown path (want /metrics, "
                                         "/telemetry or /trace)")
                    return
                except Exception as e:
                    payload = f"export error: {e!r}".encode()
                    self.send_response(500)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-export", daemon=True
        )
        self._thread.start()

    # --------------------------------------------------------- rendering --
    def _render(self, path: str) -> tuple[bytes, str]:
        path = path.split("?", 1)[0]
        if path == "/metrics":
            return (self.registry.render_prometheus().encode(),
                    PROMETHEUS_CONTENT_TYPE)
        if path == "/telemetry":
            doc: dict = {"metrics": self.registry.snapshot()}
            if self.telemetry_fn is not None:
                doc.update(self.telemetry_fn())
            return json.dumps(doc, default=_jsonify).encode(), "application/json"
        if path == "/trace":
            tracer = self.tracer or _trace.default_tracer()
            return (json.dumps(tracer.to_chrome()).encode(),
                    "application/json")
        raise KeyError(path)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self, timeout: float = 2.0) -> None:
        """Stop serving and release the port (idempotent)."""
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout)


def _jsonify(obj):
    """Fallback for numpy scalars/arrays inside telemetry dicts."""
    if hasattr(obj, "tolist"):
        return obj.tolist()
    if hasattr(obj, "item"):
        return obj.item()
    return repr(obj)
