"""``repro_torch.obs`` -- observability of the port: metrics, tracing,
exposition (port of ``repro.obs``, the same families and text).

All host-side: an instrumented solve is bitwise identical to a bare one
(``obs.disabled()``), since nothing here enters a plan's captured graph
or adds a device sync.

* :mod:`repro_torch.obs.metrics` -- process-local registry
  (:data:`REGISTRY`) of labeled counters, gauges and log-bucket
  histograms, with :func:`set_enabled` / :func:`disabled` as the kill
  switch.
* :mod:`repro_torch.obs.trace` -- span ring buffer (:data:`TRACER`):
  solve / chunk / plan-build / tick spans, Chrome trace-event export,
  NVTX ranges where CUDA is initialized, and an optional
  ``torch.profiler`` bridge (:func:`set_torch_bridge`).
* :mod:`repro_torch.obs.export` -- Prometheus text exposition, JSON
  snapshots, and the stdlib HTTP ``/metrics`` endpoint
  (``launch/serve.py --metrics-port``).

Plus :mod:`repro_torch.obs.clock`: the one injectable monotonic clock
every host-side timing path reads; a :class:`~repro_torch.obs.clock.FakeClock`
makes deadline and straggler logic deterministic in tests.

Quickstart::

    from repro_torch import obs
    obs.REGISTRY.counter("my_events_total", "things that happened").inc()
    with obs.span("phase", kind="solve", matrix="lap2d_32"):
        ...
    print(obs.render_prometheus())          # or serve it:
    srv = obs.start_metrics_server(port=9100)
"""

from . import clock
from .export import (
    MetricsServer,
    render_prometheus,
    snapshot,
    start_metrics_server,
)
from .metrics import (
    DEFAULT_LATENCY_BUCKETS,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
    disabled,
    enabled,
    log_buckets,
    set_enabled,
)
from .trace import TRACER, Span, Tracer, set_torch_bridge, span

__all__ = [
    "clock",
    # metrics
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "log_buckets", "DEFAULT_LATENCY_BUCKETS",
    "enabled", "set_enabled", "disabled",
    # tracing
    "Span", "Tracer", "TRACER", "span", "set_torch_bridge",
    # exposition
    "render_prometheus", "snapshot", "MetricsServer", "start_metrics_server",
]
