"""HTTP pull endpoint for the metric registry — the port of
``ddl_tpu/obs/export.py``: ``GET /metrics`` serves
``MetricRegistry.prometheus_text()`` byte for byte and ``GET /healthz`` a
liveness JSON carrying the goodput digest (``obs.goodput.goodput_summary``,
``fleet_summary``), from a stdlib ``ThreadingHTTPServer`` in a daemon
thread; CLI flag ``--prom-port``.

The handler thread reads registry state the run loop mutates. Iterating a
dict while the loop inserts a new series raises ``RuntimeError: dictionary
changed size``; the handler retries the snapshot a few times and degrades
to 503 rather than ever crashing the serving thread. Port 0 binds an
ephemeral port, exposed as ``.port``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .registry import MetricRegistry

_SNAPSHOT_RETRIES = 5
_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsExporter:
    """Serve ``registry`` at ``http://{host}:{port}``. ``start()``
    launches the daemon thread and returns self; ``close()`` shuts the
    server down (idempotent). Context-manager friendly."""

    def __init__(self, registry: MetricRegistry, port: int = 0,
                 host: str = "127.0.0.1"):
        if registry is None:
            raise ValueError("MetricsExporter needs a MetricRegistry")
        self.registry = registry
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: D102 — silence
                pass  # no stray stdout from the handler thread

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    for attempt in range(_SNAPSHOT_RETRIES):
                        try:
                            body = exporter.registry.prometheus_text() \
                                .encode("utf-8")
                            break
                        except RuntimeError:
                            # The run loop inserted a series mid-walk;
                            # re-snapshot (module docstring).
                            if attempt == _SNAPSHOT_RETRIES - 1:
                                self._send(
                                    503,
                                    b"snapshot raced registry mutation\n",
                                    "text/plain",
                                )
                                return
                    self._send(200, body, _CONTENT_TYPE)
                elif path == "/healthz":
                    # Compact goodput/degradation digest + the fleet
                    # digest (replicas active/draining, last scale tick,
                    # preemptions):
                    # probes see degradation AND fleet churn without
                    # scraping /metrics. Read NON-creatingly
                    # (registry.get) with the same mutation-race
                    # retry discipline as /metrics.
                    from .goodput import fleet_summary, goodput_summary

                    body = {"status": "ok"}
                    for attempt in range(_SNAPSHOT_RETRIES):
                        try:
                            body.update(goodput_summary(exporter.registry))
                            body.update(fleet_summary(exporter.registry))
                            break
                        except RuntimeError:
                            if attempt == _SNAPSHOT_RETRIES - 1:
                                body = {"status": "degraded",
                                        "error": "snapshot raced registry "
                                                 "mutation"}
                    self._send(
                        200,
                        json.dumps(body).encode() + b"\n",
                        "application/json",
                    )
                else:
                    self._send(404, b"not found\n", "text/plain")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = int(self._server.server_port)
        self._thread: threading.Thread | None = None

    def start(self) -> "MetricsExporter":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever,
                name="ddl-tpu-torch-metrics-exporter", daemon=True,
            )
            self._thread.start()
        return self

    def url(self, path: str = "/metrics") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def close(self) -> None:
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._server.server_close()

    def __enter__(self) -> "MetricsExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
