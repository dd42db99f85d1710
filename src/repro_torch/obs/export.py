"""Metric exposition: Prometheus text format, JSON snapshots, and the
stdlib HTTP ``/metrics`` endpoint (port of ``repro.obs.export``).

* :func:`render_prometheus` -- text-format exposition (version 0.0.4:
  ``# HELP`` / ``# TYPE`` headers, labeled samples, histogram
  ``_bucket``/``_sum``/``_count`` expansion with cumulative ``le``
  buckets) of a :class:`repro_torch.obs.metrics.Registry`.
  Golden-tested.
* :func:`snapshot` -- the same data as a JSON-able dict.
* :class:`MetricsServer` / :func:`start_metrics_server` -- a
  ``ThreadingHTTPServer`` on a daemon thread serving

      /metrics        Prometheus text (scrape target)
      /metrics.json   JSON snapshot
      /trace.json     Chrome trace-event export of the span ring

  wired into ``launch/serve.py --metrics-port`` (port 0 picks a free
  ephemeral port; ``server.port`` reports it).  The server starts when
  called, never at import.

No third-party client library: the text format is a few lines of string
building, and the stdlib server adds no dependency.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .metrics import REGISTRY, Counter, Gauge, Histogram, Registry
from .trace import TRACER, Tracer

__all__ = ["render_prometheus", "snapshot", "MetricsServer",
           "start_metrics_server", "CONTENT_TYPE"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labelstr(names: tuple, values: tuple, extra: tuple = ()) -> str:
    pairs = list(zip(names, values)) + list(extra)
    if not pairs:
        return ""
    inner = ",".join(
        '{}="{}"'.format(n, str(v).replace("\\", r"\\").replace('"', r"\""))
        for n, v in pairs)
    return "{" + inner + "}"


def render_prometheus(registry: Registry | None = None) -> str:
    """Prometheus text-format exposition of ``registry`` (default: the
    process registry)."""
    reg = REGISTRY if registry is None else registry
    lines: list[str] = []
    for fam in reg.families():
        lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for lv, child in fam.samples():
            ls = _labelstr(fam.labelnames, lv)
            if isinstance(fam, (Counter, Gauge)):
                lines.append(f"{fam.name}{ls} {_fmt(child.value)}")
            elif isinstance(fam, Histogram):
                cum = 0
                for i, b in enumerate(fam.buckets):
                    cum += child.counts[i]
                    bls = _labelstr(fam.labelnames, lv, (("le", _fmt(b)),))
                    lines.append(f"{fam.name}_bucket{bls} {cum}")
                cum += child.counts[-1]
                bls = _labelstr(fam.labelnames, lv, (("le", "+Inf"),))
                lines.append(f"{fam.name}_bucket{bls} {cum}")
                lines.append(f"{fam.name}_sum{ls} {_fmt(child.sum)}")
                lines.append(f"{fam.name}_count{ls} {child.count}")
    return "\n".join(lines) + "\n"


def snapshot(registry: Registry | None = None) -> dict:
    """JSON-able snapshot: {name: {kind, help, samples: [{labels, ...}]}}."""
    reg = REGISTRY if registry is None else registry
    out: dict = {}
    for fam in reg.families():
        samples = []
        for lv, child in fam.samples():
            labels = dict(zip(fam.labelnames, lv))
            if isinstance(fam, Histogram):
                samples.append({"labels": labels, "sum": child.sum,
                                "count": child.count,
                                "buckets": dict(zip(
                                    [_fmt(b) for b in fam.buckets],
                                    child.counts[:-1])),
                                "overflow": child.counts[-1]})
            else:
                samples.append({"labels": labels, "value": child.value})
        out[fam.name] = {"kind": fam.kind, "help": fam.help,
                         "samples": samples}
    return out


class _Handler(BaseHTTPRequestHandler):
    server_version = "repro-obs/1"

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802  (stdlib handler naming)
        reg = self.server.registry          # type: ignore[attr-defined]
        tracer = self.server.tracer         # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            self._send(200, render_prometheus(reg).encode(), CONTENT_TYPE)
        elif path == "/metrics.json":
            body = json.dumps(snapshot(reg), indent=1).encode()
            self._send(200, body, "application/json")
        elif path == "/trace.json":
            body = json.dumps({"traceEvents": tracer.chrome_trace()}).encode()
            self._send(200, body, "application/json")
        else:
            self._send(404, b"not found: /metrics /metrics.json /trace.json\n",
                       "text/plain")

    def log_message(self, fmt, *args):      # silence per-request stderr spam
        pass


class MetricsServer:
    """The ``/metrics`` endpoint on a daemon thread.  ``port=0`` binds an
    ephemeral port (read it back from ``self.port``)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Registry | None = None,
                 tracer: Tracer | None = None):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.registry = REGISTRY if registry is None else registry
        self._httpd.tracer = TRACER if tracer is None else tracer
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="repro-obs-metrics",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def start_metrics_server(port: int = 0, host: str = "127.0.0.1",
                         registry: Registry | None = None,
                         tracer: Tracer | None = None) -> MetricsServer:
    """Start (and return) the metrics endpoint; ``.close()`` to stop."""
    return MetricsServer(port=port, host=host, registry=registry,
                         tracer=tracer)
