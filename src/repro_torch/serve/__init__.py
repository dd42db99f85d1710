"""Serving: the management plane over the plans (port of
``repro.serve``).

Public surface, the JAX package's less the LM generation demo
(``generate``, ``SlotServer``: ROADMAP Queue 1 item 11):

* :class:`SolveService` -- the always-on, multi-tenant solve service
  (operator registry, admission control, continuous batching).
* :func:`run_load` -- open/closed-loop load generator for the service.
* :class:`SolveServer` -- DEPRECATED synchronous coalescer, a thin shim
  over ``SolveService``.
* ``SolveOutcome`` / ``SolveRequest`` / ``SolveRequestError`` /
  ``OperatorInfo`` -- the request/response records.
"""

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
    "SolveOutcome",
    "SolveRequest",
    "SolveRequestError",
    "SolveServer",
    "SolveService",
    "run_load",
]
