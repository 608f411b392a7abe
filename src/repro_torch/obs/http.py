"""Live metrics endpoint: scrape a running fleet instead of autopsying it.

Port of ``repro/obs/http.py``; the families and their names are the
reference's, so one scraper reads both packages.

A stdlib-only (``http.server``) threaded HTTP server exposing, at
``GET /metrics``, the full Prometheus text snapshot: the tracer's span /
event / counter families (:func:`repro_torch.obs.trace.prometheus_snapshot`)
plus the calibration, memory-margin (:mod:`repro_torch.obs.calibration`) and
SLO (:mod:`repro_torch.obs.slo`) families derived live from the same ring
buffer.  ``recon --metrics-port N`` starts one around a reconstruction;
a serving process (:class:`~repro_torch.serve.driver.MultiPodDriver`) can hold
one for its whole lifetime — every request re-reads the tracer, so the
scrape always reflects the current ring buffer.

The server binds ``127.0.0.1`` by default and port 0 picks a free port
(the bound port is returned by :meth:`MetricsServer.start` — handy for
tests).  Request handling runs on daemon threads; :meth:`stop` shuts the
listener down and joins the serve thread.
"""

from __future__ import annotations

import http.server
import threading
from typing import Optional

from .calibration import CalibrationLedger, calibration_prometheus, \
    memory_calibration
from .slo import slo_prometheus
from .trace import prometheus_snapshot

__all__ = ["MetricsServer", "metrics_text"]


def metrics_text() -> str:
    """The full Prometheus exposition: tracer + calibration + SLO
    families, rebuilt from the live tracer on every call."""
    return (prometheus_snapshot()
            + calibration_prometheus(CalibrationLedger.from_events(),
                                     memory_calibration())
            + slo_prometheus())


class _Handler(http.server.BaseHTTPRequestHandler):
    # quiet: scrapes every few seconds would otherwise spam stderr
    def log_message(self, fmt, *args):  # noqa: A003 - stdlib signature
        pass

    def do_GET(self):  # noqa: N802 - stdlib naming
        if self.path.split("?", 1)[0] not in ("/", "/metrics"):
            self.send_error(404, "try /metrics")
            return
        try:
            body = metrics_text().encode("utf-8")
        except Exception as e:   # a scrape must never kill the server
            self.send_error(500, f"metrics snapshot failed: {e!r}")
            return
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class MetricsServer:
    """Threaded live metrics endpoint; usable as a context manager.

    >>> from repro_torch.obs.http import MetricsServer
    >>> srv = MetricsServer(port=0)
    >>> port = srv.start()
    >>> port > 0
    True
    >>> srv.stop()
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1") -> None:
        self.host = host
        self.port = port
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        """Bind and serve in a daemon thread; returns the bound port."""
        if self._httpd is not None:
            return self.port
        self._httpd = http.server.ThreadingHTTPServer(
            (self.host, self.port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="repro-metrics",
                                        daemon=True)
        self._thread.start()
        return self.port

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._httpd, self._thread = None, None

    def __enter__(self) -> "MetricsServer":
        self.start()
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
