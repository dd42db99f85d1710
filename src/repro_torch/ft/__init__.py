"""Fault tolerance of the port: the straggler watchdog the solve service
reads (``StepTimer``).  Fault injection and the restart manager are
ROADMAP Queue 1 item 8."""

from .straggler import StepTimer, StragglerReport

__all__ = ["StepTimer", "StragglerReport"]
