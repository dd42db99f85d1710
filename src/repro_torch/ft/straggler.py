"""Straggler detection: the step/chunk watchdog (port of
``repro.ft.straggler``).

``StepTimer`` keeps a robust (median/MAD) model of step time and flags
outliers: a step longer than ``deadline_factor`` x the median (and six
MADs above it), once five steps are in the window.  The solve service
feeds it one chunk wall per tick (``SolveService.timer``) and lists the
flagged chunks in ``stats["straggler_chunks"]``; each flag also counts in
``repro_ft_straggler_flags_total``.  ``shed_advice`` says how many
microbatches a training loop would shed from its next step.  It reads
the obs clock, so a ``FakeClock`` makes detection deterministic.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np

from ..obs import REGISTRY as _OBS
from ..obs import clock as _clock

__all__ = ["StepTimer", "StragglerReport"]

_M_FLAGS = _OBS.counter(
    "repro_ft_straggler_flags_total",
    "steps/chunks the StepTimer watchdog flagged as stragglers")


@dataclass
class StragglerReport:
    step: int
    duration: float
    median: float
    is_straggler: bool
    shed_advice: int  # microbatches to shed next step (0 = none)


@dataclass
class StepTimer:
    window: int = 50
    deadline_factor: float = 2.0
    max_shed: int = 1
    _times: list = field(default_factory=list)
    last_report: StragglerReport | None = None

    def observe(self, step: int, duration: float) -> StragglerReport:
        self._times.append(duration)
        hist = np.asarray(self._times[-self.window :])
        med = float(np.median(hist))
        mad = float(np.median(np.abs(hist - med))) + 1e-9
        slow = duration > max(self.deadline_factor * med, med + 6 * mad)
        flagged = bool(slow and len(hist) >= 5)
        shed = self.max_shed if flagged else 0
        if flagged:
            _M_FLAGS.inc()
        self.last_report = StragglerReport(step, duration, med, flagged, shed)
        return self.last_report

    @contextmanager
    def timing(self, step: int):
        """Time the with-block on the obs clock and feed it to
        ``observe`` -- the report lands in ``self.last_report``.  Under a
        :class:`repro_torch.obs.clock.FakeClock` this makes straggler detection
        fully deterministic in tests."""
        t0 = _clock.now()
        try:
            yield self
        finally:
            self.observe(step, _clock.now() - t0)
