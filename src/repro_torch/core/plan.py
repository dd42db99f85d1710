"""Plan/execute API: a frozen ``SolveSpec`` lowered once into a
``SolvePlan`` (port of ``repro.core.plan``).

* :class:`SolveSpec` -- the frozen, hashable description of one solve
  configuration.  ``AzulEngine.plan(spec)`` canonicalizes it (registry
  names, engine preconditioner, resolved fused bool, tolerance fields
  nulled on fixed-iteration methods) so equal configurations share one
  plan.
* :class:`SolvePlan` -- the callable result: ``x, norms = plan(b)``.  It
  owns its substrate selection and the device operands it closes over.
* :class:`PlanCache` -- the engine's spec-keyed plan store: one build per
  canonical spec.

"Build once" is the JAX package's contract: a plan's program is built
once per input signature and every later call reuses it.  On the card the
build captures the solve loop as one CUDA graph (``core.loop``) and every
call after it replays the graph; on the CPU it is the one build of the
loop program, which runs eagerly.  ``SolvePlan.traces`` counts the
builds and ``assert_steady`` raises once there are two, as in JAX.

Observability (``repro_torch.obs``, the JAX package's families): plan
cache hits and misses, build time (a ``plan_build`` span), executions,
and a ``solve`` span around every call, whose wall goes to
``repro_plan_compile_seconds`` when the call built (on the card: captured
the loop) and to ``repro_solve_seconds`` otherwise.  A build beyond a
plan's first counts in ``repro_plan_retraces_total``.  The timing adds no
device sync and nothing to the captured graph: the call already waits
for the device where it copies the results to numpy, and the span closes
after that copy.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable

import warnings

import numpy as np
import torch

from . import registry
from ..obs import REGISTRY as _OBS
from ..obs import clock as _clock
from ..obs import span as _span
from ..obs.metrics import enabled as _obs_enabled

__all__ = ["SolveSpec", "SolvePlan", "PlanCache", "canonicalize",
           "chunk_spec", "warn_deprecated"]

# -- observability (host-side only: never enters a captured graph) ----------
_M_CACHE_HITS = _OBS.counter(
    "repro_plan_cache_hits_total", "PlanCache lookups served by a warm plan")
_M_CACHE_MISSES = _OBS.counter(
    "repro_plan_cache_misses_total", "PlanCache lookups that lowered a plan")
_M_RETRACES = _OBS.counter(
    "repro_plan_retraces_total",
    "jit retraces beyond a plan's first trace (steady-state violations)")
_M_BUILD_S = _OBS.histogram(
    "repro_plan_build_seconds", "plan lowering wall time on a cache miss")
_M_EXECUTIONS = _OBS.counter(
    "repro_solve_executions_total", "SolvePlan executions", ("method",))
_M_COMPILE_S = _OBS.histogram(
    "repro_plan_compile_seconds",
    "wall time of executions that (re)traced: trace + compile + run",
    ("method",))
_M_SOLVE_S = _OBS.histogram(
    "repro_solve_seconds",
    "steady-state execution wall time (block_until_ready)", ("method",))


@dataclass(frozen=True)
class SolveSpec:
    """Frozen description of one solve configuration.

    method     registered solver name or alias (``pcg`` | ``pcg_tol`` |
               ``cg`` | ``pcg_pipelined`` (``pcg_pipe``) |
               ``pcg_pipelined_tol`` | ``jacobi``); an alias canonicalizes
               to its solver's name, so both spellings share one plan
    precond    None = the engine's; a different name is rejected (the
               preconditioner is built with the engine)
    iters      fixed iteration count (fixed-iteration methods)
    tol        relative residual target (tolerance methods; None means
               1e-8, forced to None on fixed-iteration methods)
    max_iters  iteration cap for tolerance methods (None -> ``iters``)
    batch      None for one (n,) RHS; k for a stacked (k, n) batch that
               shares the matrix stream (every lane its own alpha/beta,
               iteration count and status)
    fused      None/'auto' (engine knob) | True | False
    layout     communication layout: None/'auto' (the engine's knob) |
               'halo' | 'dense'; a tile-grid engine's 'auto' takes the
               compiled halo schedule where its comm plan moves fewer
               bytes; a local engine has no NoC, so it resolves to
               'dense' and 'halo' raises
    reorder    row/column reordering; None = the engine's (the matrix is
               packed under the permutation at engine build, so a spec
               naming another reorder than the engine's is rejected)
    guard      in-loop numerical health guards (default True)
    injectable the matrix values become a per-call operand:
               ``plan(b, vals=...)`` substitutes a (corrupted) value buffer
               for one call with no new build -- the fault-injection
               surface (``repro_torch.ft.inject``).  The plan owns a copy
               of the packed values that its program reads, and each call
               copies the operand into it.  Pins the format to 'ell'.
               Default False.
    format     None/'auto' (the engine's format) | 'ell' | 'sell' |
               'hyb' | 'bcsr' | 'stencil' (a stencil engine's only one);
               injectable plans are 'ell'
    """

    method: str = "pcg"
    precond: str | None = None
    iters: int = 200
    tol: float | None = None
    max_iters: int | None = None
    batch: int | None = None
    fused: Any = "auto"
    layout: str | None = None
    reorder: str | None = None
    guard: bool = True
    injectable: bool = False
    format: str | None = None


def canonicalize(spec: SolveSpec, engine) -> SolveSpec:
    """Resolve a user spec against an engine into the canonical cache key."""
    sdef = registry.get_solver(spec.method)
    pdef = registry.get_precond(engine.precond)
    local = engine.mode == "local"
    if spec.precond is not None:
        want = registry.get_precond(spec.precond)
        if want.name != pdef.name:
            raise ValueError(
                f"spec precond {want.name!r} != engine precond {pdef.name!r}"
                " (the preconditioner is built with the engine -- build an"
                " engine with precond=...)")
    if spec.batch is not None and (not isinstance(spec.batch, int)
                                   or spec.batch < 1):
        raise ValueError(f"batch must be None or a positive int, got {spec.batch!r}")
    if spec.batch is not None and not sdef.batched:
        raise ValueError(f"solver {sdef.name!r} does not support batched RHS")
    fused_knob = engine.fused if spec.fused in (None, "auto") else spec.fused
    fused = registry.resolve_fused(sdef, pdef, fused_knob, engine.device,
                                   local=local)
    if spec.reorder is not None and spec.reorder != engine.reorder:
        raise ValueError(
            f"spec reorder {spec.reorder!r} != engine reorder "
            f"{engine.reorder!r} (the matrix is packed under the permutation"
            " at engine build -- build an engine with reorder=...)")
    # None and 'auto' defer to the engine's knob; only then does the
    # compiled comm plan decide profitability
    layout = registry.resolve_layout(
        engine.layout if spec.layout in (None, "auto") else spec.layout,
        sdef, pdef, local,
        halo_profitable=engine.comm_plan is not None
        and engine.comm_plan.use_halo)
    if sdef.tolerance:
        tol = 1e-8 if spec.tol is None else float(spec.tol)
        max_iters = spec.iters if spec.max_iters is None else int(spec.max_iters)
        iters = max_iters          # one budget field: iters mirrors the cap
    else:
        tol, max_iters, iters = None, None, int(spec.iters)
    if spec.guard not in (True, False):
        raise ValueError(f"guard must be True or False, got {spec.guard!r}")
    if spec.injectable not in (True, False):
        raise ValueError(
            f"injectable must be True or False, got {spec.injectable!r}")
    guard = bool(spec.guard) and sdef.guarded
    # None and 'auto' defer to the engine's format knob, which (when
    # itself 'auto') resolved to the per-matrix choice at engine build;
    # an engine's knob yields to injectable plans (ELL by construction),
    # only an explicit spec-level format conflicts
    fmt_knob = spec.format
    if fmt_knob in (None, "auto"):
        fmt_knob = (None if engine.format == "auto" or spec.injectable
                    else engine.format)
    fmt = registry.resolve_format(sdef, fmt_knob,
                                  engine_choice=engine.format_choice,
                                  stencil=engine.stencil is not None,
                                  injectable=bool(spec.injectable),
                                  local=local)
    return replace(spec, method=sdef.name, precond=pdef.name, iters=iters,
                   tol=tol, max_iters=max_iters, fused=fused, layout=layout,
                   reorder=engine.reorder, guard=guard,
                   injectable=bool(spec.injectable), format=fmt)


def chunk_spec(spec: SolveSpec, chunk: int, batch: int | None = None,
               fixed_length: bool = True) -> SolveSpec:
    """Derive the chunk spec continuous serving ticks between re-buckets.

    A chunk is ``spec`` cut down to ``chunk`` iterations so a serving loop
    can warm-start it repeatedly (``plan(b, x0=x)``) and re-bucket the
    cohort at every boundary.  With ``fixed_length=True`` tolerance methods
    run with ``tol=0.0``, so EVERY lane executes exactly ``chunk``
    iterations whoever shares the batch -- a lane's trajectory then does
    not depend on its cohort; with ``fixed_length=False`` the chunk keeps
    the real tolerance and stops once every lane converges.
    Fixed-iteration methods just get ``iters=chunk``.  Keep ``chunk`` under
    the stall window (100): a converged lane riding a fixed-length chunk
    replays a flat residual."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    sdef = registry.get_solver(spec.method)
    if sdef.tolerance:
        return replace(spec, batch=batch, iters=int(chunk),
                       max_iters=int(chunk),
                       tol=0.0 if fixed_length else spec.tol)
    return replace(spec, batch=batch, iters=int(chunk), max_iters=None,
                   tol=None)


class SolvePlan:
    """A lowered solve: spec + program + operand buffers + info.

    Built by ``AzulEngine.plan(spec)``; execute with ``plan(b, x0=None)``.

    Attributes
    ----------
    spec        the canonical :class:`SolveSpec`
    info        {"method", "precond", "fused", "substrate", "batch",
                 "layout", "reorder", "format"}
    context     the ``registry.SolveContext`` the program hands the solver
                (``SolverDef.run(plan.context, b, x0)`` outside the plan
                runs the same solve eagerly)
    executions  times the plan was called
    traces      builds of the plan's program (module docstring): 1 in the
                steady state however often the plan runs
    last_iters  per-RHS iteration counts of the most recent execution
    last_status per-RHS structured status codes (int32 STATUS_*) of the
                most recent execution; ``last_status_names`` spells them
    last_bad_iter  per-RHS first guard-tripped iteration (-1 = none)
    vals        the plan's own value buffer, the one its program reads
                (injectable plans; None otherwise): (n_pad, w) locally,
                (tiles, rows_p, w) on a tile grid
    """

    def __init__(self, engine, spec: SolveSpec, fn: Callable, info: dict,
                 cell, context, vals=None, trace_fn: Callable | None = None):
        self.engine = engine
        self.spec = spec
        self._fn = fn
        self._trace_fn = trace_fn
        self._cell = cell
        self.context = context
        self.info = info
        self.vals = vals
        self._vals_clean = True
        self.executions = 0
        self.last_iters = None
        self.last_status = None
        self.last_bad_iter = None

    @property
    def fn(self):
        """The program ``fn(b_dev, x0_dev) -> SolveResult`` in the engine's
        padded device layout; a call with a new input signature builds it
        again (and counts in ``traces``)."""
        return self._fn

    @property
    def cell(self):
        """The :class:`loop.ProgramCell` of the program: its builds, its
        captured loops (``captures``, ``capture_s``) and ``replays``."""
        return self._cell

    @property
    def traces(self) -> int:
        return self._cell.traces

    def assert_steady(self) -> None:
        """Raise RuntimeError if this plan ever retraced.

        The compile-free steady-state contract: a built plan traces exactly
        once, however many times serving re-enters it (warm starts, cohort
        changes, value substitution).  A violation is a real serving bug
        (per-step recompiles), so fail loudly -- RuntimeError survives
        ``python -O``, unlike ``assert``."""
        if self.traces > 1:
            raise RuntimeError(
                f"plan for spec {self.spec} retraced ({self.traces} traces):"
                " the compile-free steady-state contract broke"
            )

    @property
    def last_status_names(self):
        """``last_status`` spelled via ``solvers.status_name`` (str for a
        single RHS, list of str for a batch); None before any execution."""
        if self.last_status is None:
            return None
        from . import solvers

        st = np.asarray(self.last_status)
        if st.ndim == 0:
            return solvers.status_name(int(st))
        return [solvers.status_name(int(c)) for c in st]

    def _check(self, b: np.ndarray) -> None:
        n = self.engine.n
        want = (n,) if self.spec.batch is None else (self.spec.batch, n)
        if b.shape != want:
            raise ValueError(
                f"plan built for RHS shape {want}, got {b.shape} -- plans "
                "are shape-specialized; build a spec with the matching batch")

    def __call__(self, b, x0=None, vals=None):
        """Execute: returns (x, res_norms) as numpy, mirroring the RHS
        shape; the per-RHS iteration counts, status and bad_iter land in
        ``last_*`` and in ``engine.last_solve_info``.  A shared (n,) ``x0``
        is broadcast over a (k, n) batch.

        ``vals`` (injectable plans only) substitutes the matrix value
        buffer for THIS call -- the engine's packed shape, as a host array;
        None runs the clean operator."""
        b = np.asarray(b)
        self._check(b)
        if self.spec.injectable:
            self._load_vals(vals)
        elif vals is not None:
            raise ValueError(
                "this plan closes over the matrix values as constants; "
                "build the spec with injectable=True to pass vals per call")
        eng = self.engine
        b_dev = eng.to_device_vec(b)
        if x0 is None:
            x0_dev = torch.zeros_like(b_dev)
        else:
            x0 = np.asarray(x0)
            if b.ndim == 2 and x0.ndim == 1:
                x0 = np.broadcast_to(x0, b.shape)
            x0_dev = eng.to_device_vec(x0)
        if _obs_enabled():
            tr0 = self.traces
            t0 = _clock.now()
            with _span("solve", kind="solve", method=self.spec.method):
                out = self._run(b_dev, x0_dev)
            dt = _clock.now() - t0
            built = self.traces - tr0
            _M_EXECUTIONS.inc(method=self.spec.method)
            if built:
                _M_COMPILE_S.observe(dt, method=self.spec.method)
                retraces = built - (1 if tr0 == 0 else 0)
                if retraces > 0:
                    _M_RETRACES.inc(retraces)
            else:
                _M_SOLVE_S.observe(dt, method=self.spec.method)
            return out
        return self._run(b_dev, x0_dev)

    def _load_vals(self, vals) -> None:
        """Copy this call's value operand into the plan's buffer, in place
        and on the current stream, so the program (on the card, the
        captured graph, which holds the buffer's address) reads it after
        the copy: the engine's clean values, skipped where the buffer
        already holds them, or the caller's host array, uploaded."""
        if vals is None:
            if not self._vals_clean:
                self.vals.copy_(self.engine.vals_operand(None))
                self._vals_clean = True
            return
        host = self.engine._host_vals(vals)
        self._vals_clean = False
        self.vals.copy_(torch.from_numpy(host))

    def _run(self, b_dev, x0_dev):
        """One execution and its bookkeeping; the results as numpy (the
        copy waits for the device)."""
        res = self._fn(b_dev, x0_dev)
        self.executions += 1
        self.last_iters = res.iters
        self.last_status = res.status
        self.last_bad_iter = res.bad_iter
        info = dict(self.info)
        info["iters"] = self.last_iters
        info["status"] = self.last_status
        info["status_names"] = self.last_status_names
        info["bad_iter"] = self.last_bad_iter
        eng = self.engine
        eng.last_solve_info = info
        return eng.from_device_vec(res.x), res.res_norms

    def hlo_summary(self, refresh: bool = False) -> dict:
        """Collective summary of the plan's program, as the JAX package's
        (``count_by_op`` by collective name, ``total_count``), cached in
        ``info["hlo"]``.

        A tile-grid plan runs its program once on a zero right-hand side
        with the NoC recording (``noc.recording``) and each solve loop
        taking one pass of its body (``loop.tracing``): the collectives
        of the set-up, one loop body and the tail, the way the JAX
        package's lowered program holds a ``scan`` or ``while`` body once
        -- not the 32 steps of a captured round.  That run is eager and
        outside the plan's cell, so it does not count in ``traces`` (its
        kernels launch once each).  A local plan has no collectives:
        ``{"count_by_op": {}, "total_count": 0.0}``."""
        if refresh or "hlo" not in self.info:
            if self._trace_fn is None:
                self.info["hlo"] = {"count_by_op": {}, "total_count": 0.0}
            else:
                from . import loop, noc

                eng = self.engine
                shape = ((eng.n,) if self.spec.batch is None
                         else (self.spec.batch, eng.n))
                b = eng.to_device_vec(np.zeros(shape))
                if self.spec.injectable:
                    self._load_vals(None)
                with noc.recording() as rec, loop.tracing():
                    self._trace_fn(b, torch.zeros_like(b))
                self.info["hlo"] = rec.summary()
        return self.info["hlo"]

    def __repr__(self) -> str:
        s = self.spec
        return (f"SolvePlan({s.method}, precond={s.precond}, "
                f"substrate={self.info['substrate']}, batch={s.batch}, "
                f"traces={self.traces}, executions={self.executions})")


class PlanCache:
    """Spec-keyed store of lowered plans (the engine's ``plans``).

    Keys are (canonical SolveSpec, env), ``env`` being the global state a
    build depends on besides the spec (the JAX package keys its kernel
    dispatch mode there; the port's engines pass ``()``): equal keys hit,
    anything else misses and builds exactly once.  Membership tests take
    a canonical spec."""

    def __init__(self):
        self._plans: dict = {}
        self.hits = 0
        self.misses = 0

    def get(self, spec: SolveSpec, build: Callable, env: tuple = ()):
        key = (spec, env)
        plan = self._plans.get(key)
        if plan is None:
            self.misses += 1
            _M_CACHE_MISSES.inc()
            t0 = _clock.now()
            with _span("plan_build", kind="plan_build", method=spec.method):
                plan = build(spec)
            _M_BUILD_S.observe(_clock.now() - t0)
            self._plans[key] = plan
        else:
            self.hits += 1
            _M_CACHE_HITS.inc()
        return plan

    def __len__(self) -> int:
        return len(self._plans)

    def __contains__(self, spec: SolveSpec) -> bool:
        return any(k[0] == spec for k in self._plans)

    def specs(self) -> list:
        return [k[0] for k in self._plans]

    def clear(self) -> None:
        """Drop every plan; a plan no one else holds is freed with its
        captured graph and its memory pool."""
        self._plans.clear()


# ---------------------------------------------------------------------------
# deprecation bookkeeping for the legacy surfaces
# ---------------------------------------------------------------------------

_WARNED: set = set()


def warn_deprecated(key: str, message: str) -> None:
    """Emit ``message`` as a DeprecationWarning ONCE per process per key
    (legacy call sites keep working; they just say so, once)."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=3)


def _reset_deprecation_warnings() -> None:
    """Test hook: make the next legacy call warn again."""
    _WARNED.clear()
