"""Process-local metrics registry: labeled counters, gauges, histograms.

Port of ``repro.obs.metrics`` (pure Python, the same families, text and
semantics).  The serving plane, the plan cache and the straggler
watchdog all report through it.  Design constraints, in order:

1. **Host-side only.**  Nothing here ever enters a captured CUDA graph or
   adds a device sync: an instrumented solve is bitwise identical to a
   bare one (asserted in ``tests/test_torch_obs.py`` and on the card by
   ``chip_smoke.py``).
2. **Cheap enough to leave always-on.**  An increment is a dict lookup
   and a float add under one lock; histograms are fixed-bucket
   (log-spaced latency buckets by default) so ``observe`` is a bisect.
3. **One process-global registry** (:data:`REGISTRY`), mirroring the
   one-clock design of :mod:`repro_torch.obs.clock`: instrumented modules
   call ``REGISTRY.counter(...)`` at import/construction time and hold
   the child handles.  Tests that need isolation construct their own
   :class:`Registry`.

``set_enabled(False)`` (or the :func:`disabled` context manager) turns
every mutation into a no-op: the bare arm of an instrumented-vs-bare
comparison.

Exposition lives in :mod:`repro_torch.obs.export` (Prometheus text, JSON
snapshots and the ``/metrics`` endpoint).
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from contextlib import contextmanager

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
           "log_buckets", "DEFAULT_LATENCY_BUCKETS",
           "enabled", "set_enabled", "disabled"]

_ENABLED = True


def enabled() -> bool:
    """Whether metric/trace recording is on (default True)."""
    return _ENABLED


def set_enabled(flag: bool) -> bool:
    """Flip recording on/off; returns the previous state.  Off turns
    every ``inc``/``set``/``observe``/span into a no-op -- the 'bare'
    arm of the obs-overhead benchmark."""
    global _ENABLED
    prev, _ENABLED = _ENABLED, bool(flag)
    return prev


@contextmanager
def disabled():
    """Scoped ``set_enabled(False)``."""
    prev = set_enabled(False)
    try:
        yield
    finally:
        set_enabled(prev)


def log_buckets(lo: float, hi: float, per_decade: int = 3) -> tuple:
    """Log-spaced histogram bucket upper bounds from ``lo`` to >= ``hi``
    at ``per_decade`` buckets per decade (deterministic, no float drift
    surprises: bounds are computed as 10**(k/per_decade) rounded to 12
    significant digits)."""
    if not (lo > 0 and hi > lo and per_decade >= 1):
        raise ValueError(f"bad bucket range ({lo}, {hi}, {per_decade})")
    import math

    k0 = math.floor(math.log10(lo) * per_decade + 0.5)
    out = []
    k = k0
    while True:
        b = float(f"{10.0 ** (k / per_decade):.12g}")
        out.append(b)
        if b >= hi:
            break
        k += 1
    return tuple(out)


#: 10 us .. 100 s, 3 buckets per decade -- covers a warm chunk (ms)
#: through a cold plan build and capture (seconds)
DEFAULT_LATENCY_BUCKETS = log_buckets(1e-5, 100.0, per_decade=3)


class _Metric:
    """Shared family machinery: labeled children keyed by label values."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple,
                 lock: threading.RLock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._children: dict[tuple, object] = {}
        if not self.labelnames:
            self._children[()] = self._make_child()

    def _make_child(self):
        raise NotImplementedError

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.labelnames)}")
        key = tuple(str(kv[ln]) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
        return child

    def _default(self):
        """The unlabeled child (only valid for label-less families)."""
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled {self.labelnames}; "
                             "use .labels(...)")
        return self._children[()]

    def samples(self) -> list:
        """[(label_values_tuple, child), ...] sorted by labels."""
        with self._lock:
            return sorted(self._children.items())


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not _ENABLED:
            return
        if amount < 0:
            raise ValueError(f"counters only go up (inc {amount})")
        self.value += amount


class Counter(_Metric):
    kind = "counter"

    def _make_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0, **labels) -> None:
        (self.labels(**labels) if labels else self._default()).inc(amount)

    def value(self, **labels) -> float:
        return (self.labels(**labels) if labels else self._default()).value


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        if _ENABLED:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if _ENABLED:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class Gauge(_Metric):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, value: float, **labels) -> None:
        (self.labels(**labels) if labels else self._default()).set(value)

    def value(self, **labels) -> float:
        return (self.labels(**labels) if labels else self._default()).value


class _HistogramChild:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: tuple):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)   # +inf overflow bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        if not _ENABLED:
            return
        v = float(value)
        self.counts[bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate (upper bound of the bucket
        the q-th observation falls in; -1.0 when empty).  The scrape-side
        equivalent of PromQL ``histogram_quantile``."""
        if self.count == 0:
            return -1.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c:
                return (self.buckets[i] if i < len(self.buckets)
                        else float("inf"))
        return float("inf")


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets: tuple = DEFAULT_LATENCY_BUCKETS):
        self.buckets = tuple(sorted(set(float(b) for b in buckets)))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket")
        super().__init__(name, help, labelnames, lock)

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float, **labels) -> None:
        (self.labels(**labels) if labels else self._default()).observe(value)

    def quantile(self, q: float, **labels) -> float:
        child = self.labels(**labels) if labels else self._default()
        return child.quantile(q)


class Registry:
    """Named metric families, create-or-fetch semantics.

    ``counter``/``gauge``/``histogram`` are idempotent per name (the
    existing family is returned; a kind or label mismatch raises), so
    modules can declare their metrics at import time without ordering
    concerns."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: dict[str, _Metric] = {}

    def _get_or_make(self, cls, name, help, labelnames, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) \
                        or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}")
                return fam
            fam = cls(name, help, tuple(labelnames), self._lock, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: tuple = ()) -> Counter:
        return self._get_or_make(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames: tuple = (),
                  buckets: tuple = DEFAULT_LATENCY_BUCKETS) -> Histogram:
        return self._get_or_make(Histogram, name, help, labelnames,
                                 buckets=buckets)

    def families(self) -> list:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def get(self, name: str):
        return self._families.get(name)

    def reset(self) -> None:
        """Drop every family (tests).  Child handles held by live objects
        keep working but stop being exported."""
        with self._lock:
            self._families.clear()


#: the process-global registry every instrumented module reports into
REGISTRY = Registry()
