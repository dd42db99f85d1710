"""The one clock every host-side timing path of the port reads.

``now()`` is ``time.perf_counter`` underneath: monotonic seconds, never
wall-clock time.  The JAX package's injectable clock (``FakeClock``,
``override``) arrives with the observability slice.
"""

from __future__ import annotations

import time

__all__ = ["now"]


def now() -> float:
    """Monotonic seconds (``time.perf_counter``)."""
    return time.perf_counter()
