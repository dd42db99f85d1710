"""The one clock every host-side timing path of the port reads.

Port of ``repro.obs.clock``.  The plan, the loop's capture timer, the
service, the load generator and the straggler watchdog all read THIS
module:

* :func:`now` -- monotonic seconds (``time.perf_counter`` underneath,
  never wall-clock time).
* :func:`sleep` -- cooperative wait on the same clock.
* :class:`FakeClock` + :func:`override` -- tests install a manual clock
  (``fake.advance(0.2)``) and deadline/straggler logic becomes exactly
  deterministic; ``sleep`` on a fake clock advances it instead of
  blocking.

The clock is process-global (one seam, like the metrics registry):
instrumented code calls ``clock.now()`` and never threads a clock object
through its API.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

__all__ = ["Clock", "FakeClock", "now", "sleep", "get_clock", "set_clock",
           "override"]


class Clock:
    """Real monotonic clock (the default)."""

    def now(self) -> float:
        return time.perf_counter()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class FakeClock(Clock):
    """Manually advanced clock for deterministic tests.

    ``now()`` returns the internal time; ``sleep`` and ``advance`` move
    it forward -- nothing ever blocks, so deadline and straggler paths
    are testable without real waiting."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def sleep(self, seconds: float) -> None:
        self.advance(max(0.0, seconds))

    def advance(self, seconds: float) -> float:
        self._t += float(seconds)
        return self._t


_CLOCK: Clock = Clock()


def get_clock() -> Clock:
    return _CLOCK


def set_clock(clock: Clock) -> Clock:
    """Install ``clock`` as the process clock; returns the previous one."""
    global _CLOCK
    prev, _CLOCK = _CLOCK, clock
    return prev


@contextmanager
def override(clock: Clock):
    """Scoped clock swap (tests): ``with override(FakeClock()) as fake:``."""
    prev = set_clock(clock)
    try:
        yield clock
    finally:
        set_clock(prev)


def now() -> float:
    """Monotonic seconds from the current process clock."""
    return _CLOCK.now()


def sleep(seconds: float) -> None:
    """Sleep on the current process clock (a FakeClock just advances)."""
    _CLOCK.sleep(seconds)
