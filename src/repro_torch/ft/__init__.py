"""Fault tolerance of the port: the training loop's restart manager and
the chunked restart manager for solves (``restart``), deterministic fault
injection for solves (``inject``) and the straggler watchdog
(``straggler``).  The exports are the JAX package's ``repro.ft``
(``TrainLoopResult`` stays in ``ft.restart``, as there)."""

from .inject import FaultInjector, FaultSpec, corrupt_vals
from .restart import FTSolveReport, RestartManager, SolveRestartManager
from .straggler import StepTimer

__all__ = ["FaultInjector", "FaultSpec", "corrupt_vals", "FTSolveReport",
           "RestartManager", "SolveRestartManager", "StepTimer"]
