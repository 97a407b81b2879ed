"""Operator-visible metrics export: /metrics HTTP endpoint + SIGUSR1 dump.

Capability parity and beyond: the reference exports tensorboardX scalars
(``Apps/LiveTranslator/LTActor.py:82-85``) and relies on the Ray dashboard/
prometheus exporters for anything an operator can see on a running daemon.
Here the in-process registry (:mod:`.metrics`) is served directly:

- ``MetricsServer``: a daemon-thread HTTP server; ``GET /metrics`` returns
  the registry snapshot in Prometheus text exposition format, ``GET
  /metrics.json`` as JSON.  Extra collectors (e.g. per-call RTCP peer
  stats) can be registered and are merged into every scrape.
- ``install_sigusr1_dump()``: SIGUSR1 logs the full snapshot, for operators
  without a scraper.
"""

from __future__ import annotations

import json
import re
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional

from .logging import get_logger
from .metrics import Metrics, metrics as global_metrics

log = get_logger("utils.metrics_export")

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def render_prometheus(snap: Dict[str, float]) -> str:
    lines: List[str] = []
    for key in sorted(snap):
        val = snap[key]
        lines.append(f"infernos_{_prom_name(key)} {float(val):.9g}")
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Serve ``/metrics`` (Prometheus text) and ``/metrics.json``."""

    def __init__(self, port: int = 9464, host: str = "0.0.0.0",
                 registry: Optional[Metrics] = None):
        self.registry = registry or global_metrics
        self._collectors: List[Callable[[], Dict[str, float]]] = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                if self.path.split("?")[0] not in ("/metrics",
                                                   "/metrics.json", "/"):
                    self.send_response(404)
                    self.end_headers()
                    return
                snap = outer.collect()
                if self.path.startswith("/metrics.json"):
                    body = json.dumps(snap, indent=2).encode()
                    ctype = "application/json"
                else:
                    body = render_prometheus(snap).encode()
                    ctype = "text/plain; version=0.0.4"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet scrapes
                pass

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="metrics-http", daemon=True)

    def add_collector(self, fn: Callable[[], Dict[str, float]]) -> None:
        """Register an extra snapshot source (merged at scrape time)."""
        self._collectors.append(fn)

    def collect(self) -> Dict[str, float]:
        snap = dict(self.registry.snapshot())
        for fn in list(self._collectors):
            try:
                snap.update(fn())
            except Exception:
                log.exception("metrics collector failed")
        return snap

    def start(self) -> "MetricsServer":
        self._thread.start()
        log.info("metrics endpoint on :%d/metrics", self.port)
        return self

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def install_sigusr1_dump(registry: Optional[Metrics] = None) -> None:
    """SIGUSR1 -> log the full metrics snapshot (main thread only)."""
    reg = registry or global_metrics

    def _dump(signum, frame):
        snap = reg.snapshot()
        log.info("metrics dump (SIGUSR1): %s",
                 json.dumps(snap, sort_keys=True))

    signal.signal(signal.SIGUSR1, _dump)
