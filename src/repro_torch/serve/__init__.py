"""Serving: the management plane over the plans (port of
``repro.serve``).

Public surface, the JAX package's:

* :class:`SolveService` -- the always-on, multi-tenant solve service
  (operator registry, admission control, continuous batching).
* :func:`run_load` -- open/closed-loop load generator for the service.
* :class:`SolveServer` -- DEPRECATED synchronous coalescer, a thin shim
  over ``SolveService``.
* ``SolveOutcome`` / ``SolveRequest`` / ``SolveRequestError`` /
  ``OperatorInfo`` -- the request/response records.
* :func:`generate` / :class:`SlotServer` -- the LM generation loop and
  its slot-based continuous batching.
"""

from .engine import SlotServer, generate
from .loadgen import run_load
from .service import (
    OperatorInfo,
    SolveOutcome,
    SolveRequest,
    SolveRequestError,
    SolveService,
)
from .solve_server import SolveServer

__all__ = [
    "OperatorInfo",
    "SlotServer",
    "SolveOutcome",
    "SolveRequest",
    "SolveRequestError",
    "SolveServer",
    "SolveService",
    "generate",
    "run_load",
]
