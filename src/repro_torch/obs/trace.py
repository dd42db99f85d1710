"""Span-based tracing into a bounded ring buffer (port of
``repro.obs.trace``).

Metrics say HOW MUCH (counts, latency distributions), spans say WHEN and
INSIDE WHAT.  Instrumented layers open spans around the phases that
matter:

    kind            opened by
    ----            ---------
    plan_build      ``PlanCache`` miss (the plan's lowering)
    solve           every ``SolvePlan.__call__``
    tick            ``SolveService.tick``
    chunk           one continuous-batching chunk execution

Spans land in a process-global bounded ring (:data:`TRACER`, default
4096 spans -- old spans fall off, memory stays bounded on an always-on
service) and export as Chrome trace-event JSON (``chrome://tracing`` /
Perfetto: :meth:`Tracer.chrome_trace`).  Recording is host-side (a span
never enters a captured graph and adds no device sync) and honors
:func:`repro_torch.obs.metrics.set_enabled`.

Profiler bridges: where the process has initialized CUDA, every span also
opens an NVTX range of its name (``torch.cuda.nvtx``, never called on a
CPU-only run), and ``set_torch_bridge(True)`` additionally opens a
``torch.profiler.record_function`` of the same name, so spans show up in a
``torch.profiler`` timeline.  A plan's solve loop is one CUDA graph whose
steps sit inside a WHILE node, where ``torch.profiler`` sees no kernel:
seen from the host, a solve stays one span.
"""

from __future__ import annotations

import json
import threading
from collections import Counter as _TallyCounter
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from . import clock as _clock
from .metrics import enabled as _enabled

__all__ = ["Span", "Tracer", "TRACER", "span", "set_torch_bridge"]

_TORCH_BRIDGE = False


def set_torch_bridge(flag: bool) -> bool:
    """Also open every span as a ``torch.profiler.record_function``
    (visible in a ``torch.profiler`` trace).  Off by default; returns the
    previous state."""
    global _TORCH_BRIDGE
    prev, _TORCH_BRIDGE = _TORCH_BRIDGE, bool(flag)
    return prev


@dataclass
class Span:
    name: str
    kind: str
    start: float                    # obs-clock seconds
    end: float = 0.0
    attrs: dict = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end - self.start


class Tracer:
    """Bounded span ring + Chrome trace-event export."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._spans: deque[Span] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.dropped = 0                 # spans that fell off the ring

    @contextmanager
    def span(self, name: str, kind: str | None = None, **attrs):
        """Record one span around the with-block (no-op while obs is
        disabled).  ``kind`` defaults to ``name``."""
        if not _enabled():
            yield None
            return
        s = Span(name=name, kind=kind or name, start=_clock.now(),
                 attrs=attrs)
        nvtx = torch.cuda.is_initialized()
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        bridge = None
        if _TORCH_BRIDGE:
            bridge = torch.profiler.record_function(name)
            bridge.__enter__()
        try:
            yield s
        finally:
            if bridge is not None:
                bridge.__exit__(None, None, None)
            if nvtx:
                torch.cuda.nvtx.range_pop()
            s.end = _clock.now()
            with self._lock:
                if len(self._spans) == self.capacity:
                    self.dropped += 1
                self._spans.append(s)

    def spans(self, kind: str | None = None) -> list[Span]:
        with self._lock:
            out = list(self._spans)
        return out if kind is None else [s for s in out if s.kind == kind]

    def counts(self) -> dict[str, int]:
        """{kind: spans currently in the ring} (sorted keys)."""
        tally = _TallyCounter(s.kind for s in self.spans())
        return dict(sorted(tally.items()))

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def chrome_trace(self) -> list[dict]:
        """Chrome trace-event list (load in chrome://tracing / Perfetto):
        one complete ('X') event per span, microsecond timestamps on the
        obs clock."""
        return [{
            "name": s.name, "cat": s.kind, "ph": "X",
            "ts": s.start * 1e6, "dur": max(s.duration, 0.0) * 1e6,
            "pid": 0, "tid": 0, "args": dict(s.attrs),
        } for s in self.spans()]

    def export_chrome(self, path: str) -> int:
        """Write the Chrome trace JSON to ``path``; returns span count."""
        events = self.chrome_trace()
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)
        return len(events)


#: the process-global tracer instrumented modules record into
TRACER = Tracer()


def span(name: str, kind: str | None = None, **attrs):
    """``TRACER.span(...)`` -- the convenience most call sites use."""
    return TRACER.span(name, kind=kind, **attrs)
