"""Fault tolerance of the port: deterministic fault injection for solves
(``inject``), the chunked restart driver (``restart``) and the straggler
watchdog (``straggler``).  The exports are the JAX package's ``repro.ft``
less the training loop (``RestartManager``, ``TrainLoopResult``: ROADMAP
Queue 1 item 11)."""

from .inject import FaultInjector, FaultSpec, corrupt_vals
from .restart import FTSolveReport, SolveRestartManager
from .straggler import StepTimer

__all__ = ["FaultInjector", "FaultSpec", "corrupt_vals", "FTSolveReport",
           "SolveRestartManager", "StepTimer"]
