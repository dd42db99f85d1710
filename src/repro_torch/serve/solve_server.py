"""DEPRECATED request-coalescing server -- a thin shim over
:class:`repro_torch.serve.SolveService` (port of
``repro.serve.solve_server``).

``SolveServer`` was the synchronous single-matrix coalescer: clients
``submit`` individual (n,) RHS, ``step`` coalesces up to ``max_batch`` of
them into one full-budget batched plan execution.  The always-on,
multi-tenant :class:`~repro_torch.serve.service.SolveService` replaced it
(continuous batching at chunk boundaries, operator registry, admission
control).

This class keeps the old surface alive, bit-identically, by delegating to
a private single-operator service on the engine's device:

* ``submit``/validation, the stats dict, the per-bucket plan pools
  (``_plans``/``_ref_plans``/``_chunk_plans``) and the degradation/
  deadline machinery are all the service's -- the shim binds them.
* ``step``/``drain`` run the service's legacy execution path: FIFO
  dequeue, one full-budget plan call per coalesced batch (or real-
  tolerance ``deadline_chunk`` chunks when a deadline rides along).

New code should use ``SolveService`` directly.  Constructing a
``SolveServer`` emits one DeprecationWarning per process.
"""

from __future__ import annotations

import numpy as np

from ..core.plan import SolveSpec, warn_deprecated
from ..ft.straggler import StepTimer
from .service import (  # noqa: F401  (re-exported legacy surface)
    SolveOutcome,
    SolveRequest,
    SolveRequestError,
    SolveService,
)

__all__ = ["SolveRequest", "SolveOutcome", "SolveServer",
           "SolveRequestError"]


class SolveServer:
    """Coalesce single-RHS solve requests into batched plan executions.

    DEPRECATED: use :class:`repro_torch.serve.SolveService` (this class is a
    compatibility shim over it -- same validation, same plan pools, same
    outcomes, bit for bit).

    Parameters
    ----------
    engine : AzulEngine        the (already-built) solver engine
    max_batch : int            coalescing window: max RHS per batched solve
    spec : SolveSpec | None    the solve configuration; per-bucket plans are
                               built from it with ``batch`` filled in
    method / iters / tol / max_iters :
                               legacy knobs assembled into a spec when
                               ``spec`` is not given (``max_iters`` defaults
                               to ``iters`` for tolerance methods)
    deadline_chunk : int       iterations per compiled chunk on the
                               deadline path (deadline granularity)
    timer : StepTimer | None   per-chunk straggler watchdog (None builds a
                               default ``StepTimer()``)
    """

    def __init__(self, engine, max_batch: int = 16, method: str = "pcg",
                 iters: int = 200, tol: float = 1e-8,
                 max_iters: int | None = None,
                 spec: SolveSpec | None = None,
                 deadline_chunk: int = 25,
                 timer: StepTimer | None = None):
        warn_deprecated(
            "serve.SolveServer",
            "SolveServer is deprecated: use repro_torch.serve.SolveService "
            "(register_operator + submit + tick; see README 'Serving').",
        )
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if deadline_chunk < 1:
            raise ValueError("deadline_chunk must be >= 1")
        if spec is None:
            spec = SolveSpec(method=method, iters=iters, tol=tol,
                             max_iters=max_iters)
        svc = self._service = SolveService(
            max_batch=max_batch, queue_max=None,
            deadline_chunk=deadline_chunk, timer=timer,
            device=engine.device)
        svc.register_operator("default", engine=engine, spec=spec)
        op = self._op = svc._operators["default"]
        self.engine = engine
        self.max_batch = int(max_batch)
        self.spec = spec
        self.method = spec.method                    # legacy attribute
        self._tolerance = op.tolerance
        self.deadline_chunk = int(deadline_chunk)
        self.timer = svc.timer
        # the legacy pool attributes ARE the service's pools (mutations --
        # test doubles, cache pokes -- land in the real lookup path)
        self._plans = op.pools["full"]               # bucket k -> SolvePlan
        self._ref_plans = op.pools["ref"]            # degraded (unfused)
        self._chunk_plans = op.pools["chunk"]        # deadline path
        self.stats = svc.stats

    # -- client side --------------------------------------------------------

    def submit(self, b, deadline: float | None = None) -> int:
        """Queue one (n,) RHS; returns a request id resolved by ``step``.

        ``deadline``: optional solve-time budget in seconds for this
        request, measured from the start of the batched solve it rides.
        Raises :class:`SolveRequestError` (shape / dtype / non-finite /
        bad deadline) WITHOUT enqueueing.
        """
        return self._service.submit(b, "default", deadline=deadline)

    def pending(self) -> int:
        return self._service.pending()

    # -- serving side -------------------------------------------------------

    def plan_for(self, k_pad: int):
        """The compiled per-bucket plan (built on first use, reused for
        every later batch of the same bucket -- this is where dispatch
        resolves, NOT per step)."""
        return self._service.plan_for("default", k_pad)

    def step(self) -> dict[int, SolveOutcome]:
        """Run ONE coalesced batched solve over up to max_batch pending
        requests; returns {req_id: outcome}.  No-op ({}) when idle."""
        return self._service._legacy_step(self._op, self.max_batch,
                                          self.plan_for)

    def drain(self) -> dict[int, SolveOutcome]:
        """Step until the queue is empty; returns all outcomes."""
        out: dict[int, SolveOutcome] = {}
        while self._service.pending():
            out.update(self.step())
        return out

    # kept for any external callers of the old helper surface
    @staticmethod
    def _rel(trace: np.ndarray, it: int, b: np.ndarray) -> float:
        return SolveService._rel(trace, it, b)
