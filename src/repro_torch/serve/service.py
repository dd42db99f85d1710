"""Always-on solve service: the management plane of the serving stack
(port of ``repro.serve.service``, the same API, stats and metric
families).

The serving layer is split into two planes:

* **compute plane** -- ``core/plan.py``: frozen ``SolveSpec`` -> built
  ``SolvePlan``, spec-keyed cache, zero rebuilds in steady state.  On the
  card a plan captures its solve loop once as one CUDA graph and replays
  it on every later call.  Plans know nothing about requests, queues, or
  tenants.
* **management plane** -- this module: :class:`SolveService` owns the
  operator registry, admission control, scheduling, and the continuous-
  batching event loop.  It never builds programs itself; it only decides
  WHICH warm plan to execute on WHOSE right-hand sides next.

Continuous batching
-------------------
``tick()`` runs every active operator for one fixed-length *chunk*:
``chunk`` iterations of its tolerance method built with ``tol=0.0``
(see :func:`repro_torch.core.plan.chunk_spec`), warm-started from each
lane's running iterate.  Because every lane executes exactly ``chunk``
iterations per call whoever shares the batch, and the batched kernels
keep lane j's bits independent of the batch width, a lane's trajectory
is **bitwise independent of its cohort** -- a request that arrives
mid-solve joins at the next chunk boundary and still produces the exact
bits a solo solve would.  The service always passes a ``(k_pad, n)``
batch, ``k_pad`` a power of two up to ``max_batch``, even for one
request.  Convergence is detected host-side at chunk boundaries from the
residual trace (``trace[0]`` of the first chunk is the device's own
``||b||``, so host and device agree on the relative-residual test bit for
bit).  Per-request ``tol`` / ``max_iters`` / ``deadline`` therefore never
enter a plan: the warm pool stays keyed by ``(operator, flavor,
bucket)`` and re-entry is capture-free (asserted --
``SolvePlan.assert_steady``).

Each chunk stages ``b`` and ``x0`` from numpy into the engine's device
layout and copies ``x`` back, as the JAX service does; the lanes' state
lives on the host between chunks.

Multi-tenant operators
----------------------
``register_operator(name, a, ...)`` builds the operator once (engine
build: ELL packing, preconditioner) and holds it resident.  The registry
charges each operator's device footprint (``engine.device_bytes()``)
against ``memory_limit`` and evicts least-recently-used *idle* operators
to admit new ones; an evicted operator re-materializes from its host
matrix on next use.  The plans' captured graphs and memory pools are not
charged to the budget (the JAX service charges no compiled program
either); an eviction frees them with the engine, and a reload captures
each plan again on its first call.  Operators registered from a live
engine (no host matrix) cannot be rebuilt and are never auto-evicted.

Admission control and backpressure
----------------------------------
``submit`` validates against a bounded queue and the registry and raises
structured :class:`SolveRequestError` rejects (``queue_full``,
``operator_unknown``, ``over_memory``, plus the per-RHS validation
reasons) without enqueueing.  Queued requests are admitted to lanes in
effective-priority order: ``priority + waited/aging`` (+1 for deadline
requests), so old low-priority work ages up instead of starving.

The legacy ``SolveServer`` surface survives as a thin shim over this
class (see ``serve/solve_server.py``): same validation, same pools, same
stats dict, bit-identical outcomes.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import NamedTuple

import numpy as np

from ..core.plan import SolveSpec, canonicalize, chunk_spec
from ..core.registry import get_solver
from ..device import DEFAULT_DEVICE, resolve_device
from ..ft.straggler import StepTimer
from ..obs import REGISTRY as _OBS
from ..obs import clock as _clock
from ..obs import span as _span

__all__ = ["SolveService", "SolveRequest", "SolveOutcome",
           "SolveRequestError", "OperatorInfo"]

# -- observability (host-side only; see repro_torch.obs) ---------------------
#
# Each SolveService instance reports under a unique service="s<N>" label so
# multiple services in one process (tests build dozens) never alias counters.
# The legacy ``stats`` dict mirrors every scalar bump into
# ``repro_serve_events_total`` via :class:`_StatsView`; the first-class
# metrics below carry what a dict of totals cannot (distributions, gauges).
_SVC_SEQ = itertools.count(1)
_M_EVENTS = _OBS.counter(
    "repro_serve_events_total",
    "legacy SolveService.stats counter bumps by event name",
    ("service", "event"))
_M_REJECTS = _OBS.counter(
    "repro_serve_rejects_total", "admission rejections by structured reason",
    ("service", "reason"))
_M_OUTCOMES = _OBS.counter(
    "repro_serve_outcomes_total", "completed requests by final status",
    ("service", "status"))
_M_STRAGGLERS = _OBS.counter(
    "repro_serve_straggler_chunks_total",
    "chunks the StepTimer watchdog flagged as stragglers", ("service",))
_M_QUEUE_DEPTH = _OBS.gauge(
    "repro_serve_queue_depth", "requests currently queued (pre-admission)",
    ("service",))
_M_QUEUE_PEAK = _OBS.gauge(
    "repro_serve_queue_peak", "high-water mark of the admission queue",
    ("service",))
_M_RESIDENT_BYTES = _OBS.gauge(
    "repro_serve_resident_bytes",
    "device bytes of resident operators charged to the memory budget",
    ("service",))
_M_OPERATORS = _OBS.gauge(
    "repro_serve_operators_resident", "registered operators currently "
    "resident on device", ("service",))
_M_TICK_S = _OBS.histogram(
    "repro_serve_tick_seconds", "wall time of one serving-loop tick",
    ("service",))
_M_CHUNK_S = _OBS.histogram(
    "repro_serve_chunk_seconds",
    "wall time of one continuous-batching (or legacy deadline) chunk",
    ("service",))
_M_LATENCY_S = _OBS.histogram(
    "repro_serve_request_seconds",
    "submit-to-completion latency of continuous-batching requests",
    ("service",))


class _RejectsView(dict):
    """``stats['rejects']``: a plain dict to readers, write-through to
    ``repro_serve_rejects_total{service,reason}`` on every bump."""

    def __init__(self, service: str, *a, **kw):
        super().__init__(*a, **kw)
        self._svc = service

    def __setitem__(self, reason, value):
        delta = value - self.get(reason, 0)
        if isinstance(delta, (int, float)) and delta > 0:
            _M_REJECTS.inc(delta, service=self._svc, reason=reason)
        super().__setitem__(reason, value)


class _StatsView(dict):
    """The legacy ``SolveService.stats`` dict, kept bit-for-bit (same keys,
    same values, same mutability -- the ``SolveServer`` shim binds this very
    object) but write-through: every scalar counter bump also lands in the
    obs registry as ``repro_serve_events_total{service,event}``.  The
    non-scalar members keep their legacy types (``straggler_chunks`` a
    list, ``rejects`` a dict) -- their registry mirrors are maintained at
    the mutation sites / by :class:`_RejectsView`."""

    def __init__(self, service: str, init: dict):
        super().__init__(init)
        self._svc = service

    def __setitem__(self, key, value):
        old = self.get(key)
        if isinstance(value, (int, float)) and isinstance(old, (int, float)):
            if key == "queue_peak":
                _M_QUEUE_PEAK.set(value, service=self._svc)
            else:
                delta = value - old
                if delta > 0:
                    _M_EVENTS.inc(delta, service=self._svc, event=key)
        super().__setitem__(key, value)

# device statuses that mean "the recurrence is healthy" -- anything else
# is a guard fault (breakdown / diverged / stagnated) and terminal
_HEALTHY = ("converged", "maxiter", "unguarded")
_FAULT_RETRY = ("breakdown", "diverged")


def _assert_steady(plan) -> None:
    """Duck-typed steady-state check (``SolvePlan.assert_steady`` for any
    object exposing ``traces`` -- test doubles included)."""
    if plan.traces > 1:
        raise RuntimeError(
            f"plan retraced ({plan.traces} traces): the compile-free "
            "steady-state contract broke"
        )


class SolveRequestError(ValueError):
    """A submission was rejected by admission control or RHS validation.

    Structured so the serving layer can map it to a client error response:
    ``reason`` is a stable machine-readable tag (``queue_full`` |
    ``operator_unknown`` | ``over_memory`` | ``rhs_not_array`` |
    ``rhs_shape`` | ``rhs_dtype`` | ``rhs_nonfinite`` | ``deadline`` |
    ``tol`` | ``max_iters`` | ``priority``), ``expected``/``got`` describe
    the mismatch.  A rejected request is never enqueued.
    """

    def __init__(self, reason: str, expected, got):
        self.reason = reason
        self.expected = expected
        self.got = got
        super().__init__(f"{reason}: expected {expected}, got {got}")


class SolveRequest(NamedTuple):
    req_id: int
    b: np.ndarray                 # (n,) right-hand side
    deadline: float | None = None  # seconds of solve time; None = no limit


class SolveOutcome(NamedTuple):
    req_id: int
    x: np.ndarray                 # (n,) solution, in the request's dtype
    res_norms: np.ndarray         # this request's residual trace (bounded
                                  # max_iters ring for one-shot tolerance
                                  # solves; concatenated chunk trace on the
                                  # continuous/deadline paths)
    batch_size: int               # how many RHS shared the solve: the
                                  # bucketed batch width k_pad, zero pad
                                  # RHS included (batch_size - requests
                                  # is this solve's padding overhead)
    iters: int = -1               # iterations spent on THIS request
                                  # (tolerance mode; -1 = fixed-iter solve)
    requests: int = -1            # real (un-padded) requests coalesced
                                  # into the solve this outcome rode
    status: str = ""              # structured per-request solve status:
                                  # converged | maxiter | breakdown |
                                  # diverged | stagnated | unguarded |
                                  # deadline_exceeded
    rel_residual: float = -1.0    # achieved ||b - A x|| / ||b|| claim from
                                  # the recurrence trace (-1 = unavailable)
    operator: str = ""            # registered operator this solve ran on


class OperatorInfo(NamedTuple):
    """Public registry snapshot of one resident operator."""

    name: str
    n: int
    method: str
    dtype: str
    bytes: int                    # device footprint charged to the budget
    resident: bool                # False = evicted (host matrix kept)
    plans: int                    # warm-pool plans built so far
    lanes: int                    # requests currently in flight
    evictable: bool               # has a host matrix to rebuild from


@dataclass
class _Pending:
    """One queued request (post-validation, pre-admission)."""

    rid: int
    op: str
    b: np.ndarray
    tol: float | None
    max_iters: int | None
    deadline: float | None
    priority: float
    t_submit: float


@dataclass
class _Lane:
    """One admitted request riding an operator's batch."""

    req: _Pending
    budget: int                     # iteration cap for THIS request
    tol: float | None               # completion tolerance (None: fixed-iter)
    t_start: float                  # admission time (deadline clock)
    x: np.ndarray | None = None     # running iterate, engine dtype
    trace: list = field(default_factory=list)
    done_iters: int = 0
    bnorm: float = 0.0              # device ||r0|| from the first chunk


@dataclass
class _Operator:
    """Registry entry: one factored matrix + its warm plan pools."""

    name: str
    engine: object                  # AzulEngine, or None while evicted
    spec: SolveSpec                 # as registered (raw)
    cspec: SolveSpec                # canonicalized against the engine
    tolerance: bool
    max_batch: int
    chunk: int
    n: int
    dtype: np.dtype                 # engine staging dtype
    bytes: int
    matrix: object = None           # host CSR (rebuild source); None = pinned
    build_kwargs: dict = field(default_factory=dict)
    pools: dict = field(default_factory=lambda: {
        "full": {}, "ref": {}, "chunk": {}, "cb": {}, "cb_ref": {}})
    lanes: list = field(default_factory=list)
    last_used: int = 0
    last_cohort: tuple = ()

    @property
    def resident(self) -> bool:
        return self.engine is not None

    def plan_count(self) -> int:
        return sum(len(p) for p in self.pools.values())


class SolveService:
    """Always-on multi-tenant solve service (management plane).

    Parameters
    ----------
    max_batch : int            default per-operator lane count (batch
                               bucket ceiling); ``register_operator`` may
                               override per operator
    chunk : int                iterations per continuous-batching chunk
                               (re-bucket granularity; keep < 100, the
                               solver stall window -- see ``chunk_spec``)
    queue_max : int | None     admission bound: pending requests beyond
                               this are rejected ``queue_full``
                               (None = unbounded)
    memory_limit : int | None  device-byte budget for resident operators
                               (None = unlimited); exceeding it evicts
                               LRU idle operators, else ``over_memory``
    aging : float | None       seconds of queue wait worth +1 effective
                               priority (None disables aging)
    deadline_chunk : int       iterations per chunk on the LEGACY deadline
                               path (the ``SolveServer`` shim)
    timer : StepTimer | None   per-chunk straggler watchdog
    device : "cuda" (default) | "cpu"
                               where the operators registered from a host
                               matrix are built (a CUDA request without a
                               card raises)
    """

    def __init__(self, max_batch: int = 16, chunk: int = 32,
                 queue_max: int | None = 256,
                 memory_limit: int | None = None,
                 aging: float | None = 0.5,
                 deadline_chunk: int = 25,
                 timer: StepTimer | None = None,
                 device=DEFAULT_DEVICE):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if deadline_chunk < 1:
            raise ValueError("deadline_chunk must be >= 1")
        if queue_max is not None and queue_max < 1:
            raise ValueError("queue_max must be None or >= 1")
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.chunk = int(chunk)
        self.queue_max = queue_max
        self.memory_limit = memory_limit
        self.aging = aging
        self.deadline_chunk = int(deadline_chunk)
        self.timer = timer if timer is not None else StepTimer()
        self._operators: dict[str, _Operator] = {}
        self._queue: list[_Pending] = []
        self._next_id = 0
        self._chunk_seq = 0             # StepTimer step index
        self._use_seq = 0               # LRU clock
        self._obs_label = f"s{next(_SVC_SEQ)}"
        # one stats dict serves both surfaces: the legacy keys keep their
        # exact legacy meaning (the SolveServer shim binds this dict), the
        # continuous loop adds its own counters alongside.  It is a
        # _StatsView: reads/equality are plain dict, writes mirror into the
        # obs registry under this instance's service label.
        self.stats = _StatsView(self._obs_label, {
            # legacy (SolveServer) counters
            "requests": 0, "batches": 0, "padded_rhs": 0, "plans": 0,
            "rejected": 0, "degraded_batches": 0, "deadline_batches": 0,
            "deadline_exceeded": 0, "straggler_chunks": [],
            # continuous-batching counters
            "ticks": 0, "chunks": 0, "admitted": 0, "completed": 0,
            "rebuckets": 0, "padded_lanes": 0, "queue_peak": 0,
            # registry counters
            "evictions": 0, "reloads": 0,
        })
        # reason -> count (write-through to repro_serve_rejects_total)
        self.stats["rejects"] = _RejectsView(self._obs_label)

    # -- operator registry --------------------------------------------------

    def register_operator(self, name: str, a=None, *, engine=None,
                          spec: SolveSpec | None = None,
                          method: str = "pcg_tol", iters: int = 200,
                          tol: float = 1e-8, max_iters: int | None = None,
                          precond: str = "jacobi", dtype=np.float64,
                          layout: str = "auto", reorder: str = "none",
                          mesh=None, max_batch: int | None = None,
                          chunk: int | None = None) -> OperatorInfo:
        """Make operator ``name`` resident and serveable.

        Either hand over a host CSR matrix ``a`` (the service builds the
        engine and can later evict/rebuild it under memory pressure) or a
        live ``engine`` (pinned: never auto-evicted).  ``spec`` -- or the
        ``method``/``iters``/``tol``/``max_iters`` knobs -- fixes the
        solve configuration; per-request ``tol``/``max_iters`` overrides
        at ``submit`` time are host-side only and never add plans.

        Raises ``SolveRequestError('over_memory', ...)`` when the operator
        does not fit the memory budget even after evicting every idle
        evictable operator.
        """
        if name in self._operators:
            raise ValueError(f"operator {name!r} already registered")
        if engine is None and a is None:
            raise ValueError("register_operator needs a matrix or an engine")
        if spec is None:
            spec = SolveSpec(method=method, iters=iters, tol=tol,
                             max_iters=max_iters)
        build_kwargs = dict(precond=precond, dtype=dtype, layout=layout,
                            reorder=reorder, mesh=mesh, device=self.device)
        if engine is None:
            engine = self._build_engine(a, build_kwargs)
        cspec = canonicalize(replace(spec, batch=None), engine)
        op = _Operator(
            name=name, engine=engine, spec=spec, cspec=cspec,
            tolerance=get_solver(cspec.method).tolerance,
            max_batch=self.max_batch if max_batch is None else int(max_batch),
            chunk=self.chunk if chunk is None else int(chunk),
            n=engine.n, dtype=np.dtype(engine.dtype),
            bytes=int(engine.device_bytes()),
            matrix=a, build_kwargs=build_kwargs,
        )
        if op.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._fit_memory(op.bytes)      # may evict; raises over_memory
        self._operators[name] = op
        self._touch(op)
        self._obs_residency()
        return self._info(op)

    def unregister_operator(self, name: str) -> None:
        """Drop ``name`` from the registry (frees its device footprint).
        Refuses while the operator has queued or in-flight requests."""
        op = self._op(name)
        if op.lanes or any(p.op == name for p in self._queue):
            raise ValueError(
                f"operator {name!r} is busy ({len(op.lanes)} in flight)")
        del self._operators[name]
        self._obs_residency()

    def operators(self) -> dict[str, OperatorInfo]:
        """Registry snapshot: {name: OperatorInfo}."""
        return {name: self._info(op) for name, op in self._operators.items()}

    def resident_bytes(self) -> int:
        return sum(op.bytes for op in self._operators.values()
                   if op.resident)

    def _obs_residency(self) -> None:
        """Refresh the registry-backed residency gauges (called on every
        register/unregister/evict/reload)."""
        _M_RESIDENT_BYTES.set(self.resident_bytes(), service=self._obs_label)
        _M_OPERATORS.set(
            sum(1 for op in self._operators.values() if op.resident),
            service=self._obs_label)

    @staticmethod
    def _build_engine(a, build_kwargs):
        from ..core.engine import AzulEngine
        return AzulEngine(a, mesh=build_kwargs["mesh"],
                          precond=build_kwargs["precond"],
                          dtype=build_kwargs["dtype"],
                          layout=build_kwargs["layout"],
                          reorder=build_kwargs["reorder"],
                          device=build_kwargs["device"])

    def _info(self, op: _Operator) -> OperatorInfo:
        return OperatorInfo(
            name=op.name, n=op.n, method=op.cspec.method,
            dtype=str(op.dtype), bytes=op.bytes, resident=op.resident,
            plans=op.plan_count(), lanes=len(op.lanes),
            evictable=op.matrix is not None)

    def _op(self, name) -> _Operator:
        if isinstance(name, _Operator):
            return name
        op = self._operators.get(name)
        if op is None:
            raise SolveRequestError(
                "operator_unknown", tuple(sorted(self._operators)), name)
        return op

    def _touch(self, op: _Operator) -> None:
        self._use_seq += 1
        op.last_used = self._use_seq

    def _fit_memory(self, need: int, keep: str | None = None) -> None:
        """Evict LRU idle evictable operators until ``need`` extra bytes
        fit the budget; raise ``over_memory`` if they cannot."""
        if self.memory_limit is None:
            return
        def over():
            return self.resident_bytes() + need > self.memory_limit
        while over():
            victims = [op for op in self._operators.values()
                       if op.resident and op.matrix is not None
                       and not op.lanes and op.name != keep
                       and not any(p.op == op.name for p in self._queue)]
            if not victims:
                raise SolveRequestError(
                    "over_memory", f"<= {self.memory_limit} resident bytes",
                    self.resident_bytes() + need)
            self._evict(min(victims, key=lambda op: op.last_used))

    def _evict(self, op: _Operator) -> None:
        # the engine's plan cache and the pools below hold the only
        # references to its plans: dropping both frees every captured
        # graph with its memory pool, as the JAX service drops its
        # executables
        op.engine.plans.clear()
        op.engine = None
        for pool in op.pools.values():
            pool.clear()
        op.last_cohort = ()
        self.stats["evictions"] += 1
        self._obs_residency()

    def _ensure_resident(self, op: _Operator) -> None:
        """Re-materialize an evicted operator from its host matrix (plans
        rebuild lazily on first use -- re-entry warms back up)."""
        if op.resident:
            return
        self._fit_memory(op.bytes, keep=op.name)
        op.engine = self._build_engine(op.matrix, op.build_kwargs)
        self.stats["reloads"] += 1
        self._obs_residency()

    # -- client side --------------------------------------------------------

    def _reject(self, reason: str, expected, got):
        self.stats["rejected"] += 1
        self.stats["rejects"][reason] = self.stats["rejects"].get(reason, 0) + 1
        raise SolveRequestError(reason, expected, got)

    def submit(self, b, operator: str | None = None, *,
               tol: float | None = None, max_iters: int | None = None,
               deadline: float | None = None,
               priority: float = 0.0) -> int:
        """Queue one (n,) RHS against ``operator``; returns a request id
        resolved by a later ``tick``.

        ``operator`` may be omitted when exactly one operator is
        registered.  ``tol`` / ``max_iters`` override the operator's
        completion target for THIS request (host-side: no new plans);
        ``deadline`` is seconds of solve time from admission;
        ``priority`` breaks admission ties (higher first, aged -- see
        class docstring).  Raises :class:`SolveRequestError` WITHOUT
        enqueueing on any rejection.
        """
        if operator is None:
            if len(self._operators) == 1:
                operator = next(iter(self._operators))
            else:
                self._reject("operator_unknown",
                             tuple(sorted(self._operators)), None)
        if operator not in self._operators:
            self._reject("operator_unknown",
                         tuple(sorted(self._operators)), operator)
        op = self._operators[operator]
        if self.queue_max is not None and len(self._queue) >= self.queue_max:
            self._reject("queue_full", f"<= {self.queue_max} queued",
                         len(self._queue) + 1)
        try:
            b = np.asarray(b)
        except Exception:
            b = None
        if b is None or b.dtype == object:   # numpy wraps arbitrary objects
            self._reject(                    # into 0-d object arrays rather
                "rhs_not_array", "numeric array-like", "non-numeric object")
        if b.shape != (op.n,):
            self._reject("rhs_shape", (op.n,), b.shape)
        if not (np.issubdtype(b.dtype, np.floating)
                or np.issubdtype(b.dtype, np.integer)):
            self._reject("rhs_dtype", "real floating/integer", str(b.dtype))
        if not np.all(np.isfinite(b)):
            self._reject("rhs_nonfinite", "finite entries",
                         f"{int(np.sum(~np.isfinite(b)))} non-finite")
        if deadline is not None and not (float(deadline) >= 0):
            self._reject("deadline", ">= 0 seconds", deadline)
        if tol is not None and not (float(tol) >= 0):
            self._reject("tol", ">= 0", tol)
        if max_iters is not None and (not isinstance(max_iters, int)
                                      or max_iters < 1):
            self._reject("max_iters", "positive int", max_iters)
        try:
            priority = float(priority)
        except (TypeError, ValueError):
            self._reject("priority", "a real number", priority)
        rid = self._next_id
        self._next_id += 1
        self._queue.append(_Pending(
            rid=rid, op=operator, b=b,
            tol=None if tol is None else float(tol), max_iters=max_iters,
            deadline=None if deadline is None else float(deadline),
            priority=priority, t_submit=_clock.now()))
        self.stats["requests"] += 1
        self.stats["queue_peak"] = max(self.stats["queue_peak"],
                                       len(self._queue))
        _M_QUEUE_DEPTH.set(len(self._queue), service=self._obs_label)
        return rid

    def pending(self) -> int:
        return len(self._queue)

    def active(self) -> int:
        return sum(len(op.lanes) for op in self._operators.values())

    # -- scheduling ---------------------------------------------------------

    @staticmethod
    def _bucket(k: int, cap: int) -> int:
        p = 1
        while p < k:
            p *= 2
        return min(p, cap)

    @staticmethod
    def _admission_order(queue: list, now: float, aging: float | None
                         ) -> list:
        """Queued requests by descending effective priority (FIFO ties).

        ``effective = priority + waited/aging`` (+1.0 for deadline
        requests) -- waiting ages a request up so high-priority streams
        cannot starve old low-priority work.
        """
        def eff(p: _Pending) -> float:
            e = p.priority + (0.0 if p.deadline is None else 1.0)
            if aging is not None:
                e += max(0.0, now - p.t_submit) / aging
            return e

        return sorted(queue, key=lambda p: (-eff(p), p.rid))

    def _admit(self, now: float) -> None:
        """Move queued requests into operator lanes, priority-aged order,
        as far as each operator's lane budget allows."""
        if not self._queue:
            return
        admitted = []
        for p in self._admission_order(self._queue, now, self.aging):
            op = self._operators[p.op]
            if len(op.lanes) >= op.max_batch:
                continue
            self._ensure_resident(op)
            budget = (p.max_iters if p.max_iters is not None
                      else (op.cspec.max_iters if op.tolerance
                            else op.cspec.iters))
            op.lanes.append(_Lane(
                req=p, budget=int(budget),
                tol=(p.tol if p.tol is not None else op.cspec.tol)
                if op.tolerance else None,
                t_start=now))
            admitted.append(p)
            self.stats["admitted"] += 1
        if admitted:
            taken = {id(p) for p in admitted}
            self._queue = [p for p in self._queue if id(p) not in taken]
        _M_QUEUE_DEPTH.set(len(self._queue), service=self._obs_label)

    # -- plan warm pool -----------------------------------------------------

    def plan_for(self, operator, k_pad: int, flavor: str = "full"):
        """The plan for ``(operator, flavor, bucket)`` -- built on
        first use, reused for every later chunk/batch of the same bucket
        (dispatch resolves here, never per tick).

        Flavors: ``full`` (one-shot full-budget solve -- the legacy step
        path), ``ref`` (its unfused degradation target, CPU only), ``chunk``
        (legacy deadline chunks: real tolerance), ``cb`` (continuous-
        batching fixed-length chunk, ``tol=0``), ``cb_ref`` (its unfused CPU
        degradation target).
        """
        op = self._op(operator)
        self._ensure_resident(op)
        pool = op.pools[flavor]
        plan = pool.get(k_pad)
        if plan is None:
            base = op.cspec
            if flavor == "full":
                spec = replace(base, batch=k_pad)
            elif flavor == "ref":
                spec = replace(base, batch=k_pad, fused=False)
            elif flavor == "chunk":
                spec = chunk_spec(base, self.deadline_chunk, batch=k_pad,
                                  fixed_length=False)
            elif flavor == "cb":
                spec = chunk_spec(base, op.chunk, batch=k_pad)
            elif flavor == "cb_ref":
                spec = replace(chunk_spec(base, op.chunk, batch=k_pad),
                               fused=False)
            else:
                raise ValueError(f"unknown plan flavor {flavor!r}")
            plan = op.engine.plan(spec)
            pool[k_pad] = plan
            self.stats["plans"] += 1
        return plan

    def _statuses(self, plan, k_pad: int) -> list[str]:
        names = plan.last_status_names
        return [names] * k_pad if isinstance(names, str) else list(names)

    def _run_degradable(self, op: _Operator, plan, k_pad: int, batch,
                        x0=None, ref_flavor: str = "ref"):
        """Execute ``plan``; on the CPU, a fused-path failure (raise, or
        guards reporting breakdown on any lane) is retried ONCE on the
        reference substrate, as in the JAX service.  On the card the
        reference substrate is the plain PyTorch version of the kernels,
        so there is no retry: a kernel that fails raises to the caller and
        a lane its guards fault keeps that status -- a kernel fault is
        never answered by the plain path.  Returns (x, norms, plan_used)."""
        degradable = (bool(plan.info.get("fused"))
                      and op.engine.device.type == "cpu")
        try:
            x, norms = plan(batch) if x0 is None else plan(batch, x0=x0)
            bad = any(s in _FAULT_RETRY
                      for s in self._statuses(plan, k_pad))
            if not (degradable and bad):
                return x, norms, plan
        except Exception:
            if not degradable:
                raise
        # one retry on the reference substrate: if the failure was the
        # fused kernels' (a build/runtime bug, a kernel-only numerical
        # breakdown), the reference path answers; if the INPUT is bad the
        # reference guards re-report it and that status stands
        self.stats["degraded_batches"] += 1
        ref = self.plan_for(op, k_pad, ref_flavor)
        x, norms = ref(batch) if x0 is None else ref(batch, x0=x0)
        _assert_steady(ref)
        return x, norms, ref

    # -- the event loop -----------------------------------------------------

    def tick(self) -> dict[int, SolveOutcome]:
        """One turn of the serving loop: admit queued requests to free
        lanes, then run every active operator for ONE fixed-length chunk
        and retire the lanes that finished.  Returns the outcomes of the
        requests that completed this tick ({} when idle).

        Lanes re-bucket between chunks: a request admitted while others
        are mid-solve simply appears in the next chunk's batch (the warm
        pool already holds the plan for the new bucket, or builds it
        once).  Completion -- convergence, budget, deadline, guard fault
        -- is decided host-side at the boundary; surviving lanes carry
        their iterate into the next chunk.
        """
        self.stats["ticks"] += 1
        now = _clock.now()
        with _span("tick", kind="tick", service=self._obs_label):
            self._admit(now)
            out: dict[int, SolveOutcome] = {}
            for op in list(self._operators.values()):
                if op.lanes:
                    out.update(self._run_op_chunk(op))
        _M_TICK_S.observe(_clock.now() - now, service=self._obs_label)
        self.stats["completed"] += len(out)
        return out

    def drain(self) -> dict[int, SolveOutcome]:
        """Tick until no request is queued or in flight; returns all
        outcomes."""
        out: dict[int, SolveOutcome] = {}
        while self._queue or self.active():
            out.update(self.tick())
        return out

    def _run_op_chunk(self, op: _Operator) -> dict[int, SolveOutcome]:
        """Run ``op``'s cohort for one fixed-length chunk and retire
        finished lanes."""
        self._touch(op)
        k = len(op.lanes)
        k_pad = self._bucket(k, op.max_batch)
        cohort = tuple(lane.req.rid for lane in op.lanes)
        if op.last_cohort and cohort != op.last_cohort:
            self.stats["rebuckets"] += 1
        # stage in the ENGINE dtype: the operand enters the plan exactly as
        # built -- no downcast on the device, no new signature to build
        batch = np.zeros((k_pad, op.n), dtype=op.dtype)
        x0 = np.zeros_like(batch)
        for i, lane in enumerate(op.lanes):
            batch[i] = lane.req.b
            if lane.x is not None:
                x0[i] = lane.x
        plan = self.plan_for(op, k_pad, "cb")
        t0 = _clock.now()
        with _span("chunk", kind="chunk", service=self._obs_label,
                   operator=op.name, k_pad=k_pad):
            x, norms, used = self._run_degradable(op, plan, k_pad, batch,
                                                  x0=x0, ref_flavor="cb_ref")
        dt = _clock.now() - t0
        _M_CHUNK_S.observe(dt, service=self._obs_label)
        _assert_steady(self.plan_for(op, k_pad, "cb"))
        self._chunk_seq += 1
        rep = self.timer.observe(self._chunk_seq, dt)
        if rep.is_straggler:
            self.stats["straggler_chunks"].append(self._chunk_seq)
            _M_STRAGGLERS.inc(service=self._obs_label)
        self.stats["chunks"] += 1
        self.stats["padded_lanes"] += k_pad - k
        x = np.asarray(x)
        norms = np.asarray(norms)
        its = (np.atleast_1d(np.asarray(used.last_iters)).astype(np.int64)
               if op.tolerance else np.full(k_pad, op.chunk, np.int64))
        statuses = self._statuses(used, k_pad)
        now = _clock.now()
        survivors: list[_Lane] = []
        out: dict[int, SolveOutcome] = {}
        for i, lane in enumerate(op.lanes):
            first = lane.x is None
            lane.x = x[i].copy()
            col = norms[: int(its[i]) + 1, i]
            prev_done = lane.done_iters
            lane.trace.append(col if first else col[1:])
            lane.done_iters += int(its[i])
            if first:
                # trace[0] is the device's own ||r0|| = ||b|| (x0 = 0), so
                # the host-side convergence test below agrees with the
                # device's relative-residual test bit-for-bit
                lane.bnorm = float(col[0])
            status, it_final = self._lane_status(
                op, lane, col, prev_done, statuses[i], first, now)
            if status is None:
                survivors.append(lane)
                continue
            out[lane.req.rid] = self._finish_lane(
                op, lane, status, it_final, k_pad, k)
        op.lanes = survivors
        op.last_cohort = tuple(lane.req.rid for lane in survivors)
        return out

    def _lane_status(self, op: _Operator, lane: _Lane, col: np.ndarray,
                     prev_done: int, device_status: str, first: bool,
                     now: float):
        """Decide a lane's fate at the chunk boundary.  Returns
        ``(status, iters)``, with ``status=None`` meaning the lane keeps
        riding.  Precedence: convergence > guard fault > budget >
        deadline."""
        if lane.tol is not None:
            # host-side convergence scan over this chunk's trace: col[j]
            # is the residual after global iteration prev_done + j (j=0
            # duplicates the previous boundary except on the first chunk)
            bn = lane.bnorm if lane.bnorm > 0 else 1.0
            start = 0 if first else 1
            hit = np.nonzero(col[start:] <= lane.tol * bn)[0]
            if hit.size:
                return "converged", prev_done + start + int(hit[0])
        if device_status not in _HEALTHY:
            return device_status, lane.done_iters
        if lane.done_iters >= lane.budget:
            return "maxiter", lane.done_iters
        if (lane.req.deadline is not None
                and now - lane.t_start > lane.req.deadline):
            self.stats["deadline_exceeded"] += 1
            return "deadline_exceeded", lane.done_iters
        return None, lane.done_iters

    def _finish_lane(self, op: _Operator, lane: _Lane, status: str,
                     it_final: int, k_pad: int, k: int) -> SolveOutcome:
        trace = np.concatenate(lane.trace)
        if status == "converged":
            trace = trace[: it_final + 1]
        xi = lane.x
        if np.issubdtype(lane.req.b.dtype, np.floating):
            xi = xi.astype(lane.req.b.dtype, copy=False)
        bn = lane.bnorm if lane.bnorm > 0 else 1.0
        rel = float(trace[min(it_final, trace.shape[0] - 1)]) / bn
        _M_OUTCOMES.inc(service=self._obs_label, status=status)
        _M_LATENCY_S.observe(_clock.now() - lane.req.t_submit,
                             service=self._obs_label)
        return SolveOutcome(
            lane.req.rid, xi, trace, batch_size=k_pad,
            iters=it_final if op.tolerance else -1, requests=k,
            status=status, rel_residual=rel, operator=op.name)

    # -- legacy execution (the SolveServer shim's step/drain) ---------------

    def _legacy_take(self, max_batch: int) -> list[_Pending]:
        take, self._queue = (self._queue[:max_batch],
                             self._queue[max_batch:])
        return take

    def _legacy_step(self, op: _Operator, max_batch: int,
                     plan_for) -> dict[int, SolveOutcome]:
        """One legacy coalesced batch: FIFO-dequeue up to ``max_batch``
        requests and run them as ONE full-budget plan execution (or the
        chunked deadline path).  ``plan_for`` is the shim's late-bound
        ``plan_for(k_pad)`` hook so instance monkeypatches keep working.
        Bit-identical to the pre-service ``SolveServer.step``."""
        if not self._queue:
            return {}
        take = self._legacy_take(max_batch)
        k = len(take)
        k_pad = self._bucket(k, max_batch)
        batch = np.zeros((k_pad, op.n), dtype=op.dtype)
        for i, p in enumerate(take):
            batch[i] = p.b
        if any(p.deadline is not None for p in take):
            return self._legacy_step_deadline(op, take, batch, k, k_pad)
        plan = plan_for(k_pad)
        x, norms, plan = self._run_degradable(op, plan, k_pad, batch)
        _assert_steady(plan_for(k_pad))
        self.stats["batches"] += 1
        self.stats["padded_rhs"] += k_pad - k
        its = np.full(k_pad, -1, np.int64)
        if op.tolerance:
            its = np.atleast_1d(np.asarray(plan.last_iters)).astype(np.int64)
        statuses = self._statuses(plan, k_pad)

        # norms: (iters + 1, k_pad) -- hand each request its own column;
        # solutions go back in the request's (floating) dtype, so a
        # float64 client of a float32 engine round-trips its own type
        def _x_out(i, p):
            xi = np.asarray(x[i])
            if np.issubdtype(p.b.dtype, np.floating):
                return xi.astype(p.b.dtype, copy=False)
            return xi

        norms = np.asarray(norms)
        return {
            p.rid: SolveOutcome(
                p.rid, _x_out(i, p), norms[:, i],
                batch_size=k_pad, iters=int(its[i]), requests=k,
                status=statuses[i],
                rel_residual=self._rel(norms[:, i], its[i], p.b),
                operator=op.name)
            for i, p in enumerate(take)
        }

    @staticmethod
    def _rel(trace: np.ndarray, it: int, b: np.ndarray) -> float:
        bn = float(np.linalg.norm(b))
        last = float(trace[it] if 0 <= it < trace.shape[0] else trace[-1])
        return last / bn if bn > 0 else last

    def _legacy_step_deadline(self, op: _Operator, take, batch, k: int,
                              k_pad: int) -> dict[int, SolveOutcome]:
        """Chunked execution with per-request wall-clock deadlines (the
        legacy path: real-tolerance ``deadline_chunk`` chunks, expired
        lanes snapshot and keep riding)."""
        plan = self.plan_for(op, k_pad, "chunk")
        self.stats["batches"] += 1
        self.stats["deadline_batches"] += 1
        self.stats["padded_rhs"] += k_pad - k
        budget = int(op.cspec.max_iters
                     if (op.tolerance and op.cspec.max_iters is not None)
                     else op.cspec.iters)
        x = np.zeros_like(batch)
        done = np.zeros(k_pad, bool)
        done[k:] = True                       # pad lanes: nothing to report
        snap_x = [None] * k_pad
        snap = [("maxiter", -1.0, 0)] * k_pad   # (status, rel, iters)
        total_iters = np.zeros(k_pad, np.int64)
        traces = [[] for _ in range(k_pad)]
        t0 = _clock.now()
        it_done = 0
        while it_done < budget and not done.all():
            tc = _clock.now()
            with _span("chunk", kind="chunk", service=self._obs_label,
                       operator=op.name, k_pad=k_pad, legacy=True):
                x2, norms = plan(batch, x0=x)
            dt = _clock.now() - tc
            _M_CHUNK_S.observe(dt, service=self._obs_label)
            plan.assert_steady()
            self._chunk_seq += 1
            rep = self.timer.observe(self._chunk_seq, dt)
            if rep.is_straggler:
                self.stats["straggler_chunks"].append(self._chunk_seq)
                _M_STRAGGLERS.inc(service=self._obs_label)
            norms = np.asarray(norms)
            its = (np.atleast_1d(np.asarray(plan.last_iters))
                   .astype(np.int64) if op.tolerance
                   else np.full(k_pad, self.deadline_chunk, np.int64))
            statuses = self._statuses(plan, k_pad)
            x = np.asarray(x2)
            it_done += self.deadline_chunk
            elapsed = _clock.now() - t0
            for i, p in enumerate(take):
                if done[i]:
                    continue
                total_iters[i] += int(its[i])
                traces[i].append(norms[: int(its[i]) + 1, i])
                rel = self._rel(norms[:, i], int(its[i]), p.b)
                s = statuses[i]
                finished = (s not in ("maxiter", "unguarded")
                            or it_done >= budget)
                expired = (p.deadline is not None and elapsed > p.deadline)
                if finished or expired:
                    done[i] = True
                    snap_x[i] = x[i].copy()
                    if not finished and expired:
                        s = "deadline_exceeded"
                        self.stats["deadline_exceeded"] += 1
                    snap[i] = (s, rel, int(total_iters[i]))
        out = {}
        for i, p in enumerate(take):
            if snap_x[i] is None:             # budget ran out mid-flight
                snap_x[i] = x[i].copy()
            xi = snap_x[i]
            if np.issubdtype(p.b.dtype, np.floating):
                xi = xi.astype(p.b.dtype, copy=False)
            s, rel, iters = snap[i]
            trace = (np.concatenate(traces[i]) if traces[i]
                     else np.zeros(1, batch.dtype))
            out[p.rid] = SolveOutcome(
                p.rid, xi, trace, batch_size=k_pad,
                iters=iters if op.tolerance else -1, requests=k,
                status=s, rel_residual=rel, operator=op.name)
        return out
