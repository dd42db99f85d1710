"""Plan/execute API: a frozen ``SolveSpec`` lowered once into a
``SolvePlan`` (port of ``repro.core.plan`` for local solves).

* :class:`SolveSpec` -- the frozen, hashable description of one solve
  configuration.  ``AzulEngine.plan(spec)`` canonicalizes it (registry
  names, engine preconditioner, resolved fused bool, tolerance fields
  nulled on fixed-iteration methods) so equal configurations share one
  plan.
* :class:`SolvePlan` -- the callable result: ``x, norms = plan(b)``.  It
  owns its substrate selection and the device operands it closes over.
* :class:`PlanCache` -- the engine's spec-keyed plan store: one build per
  canonical spec.

PyTorch runs eagerly, so there is no compile step to count; "build once"
is the cache's miss count.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable

import numpy as np

from . import registry

__all__ = ["SolveSpec", "SolvePlan", "PlanCache", "canonicalize",
           "chunk_spec"]


@dataclass(frozen=True)
class SolveSpec:
    """Frozen description of one solve configuration.

    method     registered solver name (``pcg`` | ``pcg_tol``)
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
    guard      in-loop numerical health guards (default True)
    format     None/'auto' (the engine's format) | 'ell' | 'sell' |
               'hyb' | 'bcsr' | 'stencil' (a stencil engine's only one)
    """

    method: str = "pcg"
    precond: str | None = None
    iters: int = 200
    tol: float | None = None
    max_iters: int | None = None
    batch: int | None = None
    fused: Any = "auto"
    guard: bool = True
    format: str | None = None


def canonicalize(spec: SolveSpec, engine) -> SolveSpec:
    """Resolve a user spec against an engine into the canonical cache key."""
    sdef = registry.get_solver(spec.method)
    pdef = registry.get_precond(engine.precond)
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
    fused = registry.resolve_fused(sdef, pdef, fused_knob, engine.device)
    if sdef.tolerance:
        tol = 1e-8 if spec.tol is None else float(spec.tol)
        max_iters = spec.iters if spec.max_iters is None else int(spec.max_iters)
        iters = max_iters          # one budget field: iters mirrors the cap
    else:
        tol, max_iters, iters = None, None, int(spec.iters)
    if spec.guard not in (True, False):
        raise ValueError(f"guard must be True or False, got {spec.guard!r}")
    guard = bool(spec.guard) and sdef.guarded
    # None and 'auto' defer to the engine's format knob, which (when
    # itself 'auto') resolved to the per-matrix choice at engine build
    fmt_knob = spec.format
    if fmt_knob in (None, "auto"):
        fmt_knob = None if engine.format == "auto" else engine.format
    fmt = registry.resolve_format(sdef, fmt_knob,
                                  engine_choice=engine.format_choice,
                                  stencil=engine.stencil is not None)
    return replace(spec, method=sdef.name, precond=pdef.name, iters=iters,
                   tol=tol, max_iters=max_iters, fused=fused, guard=guard,
                   format=fmt)


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
    executions  times the plan was called
    last_iters  per-RHS iteration counts of the most recent execution
    last_status per-RHS structured status codes (int32 STATUS_*) of the
                most recent execution; ``last_status_names`` spells them
    last_bad_iter  per-RHS first guard-tripped iteration (-1 = none)
    """

    def __init__(self, engine, spec: SolveSpec, fn: Callable, info: dict):
        self.engine = engine
        self.spec = spec
        self._fn = fn
        self.info = info
        self.executions = 0
        self.last_iters = None
        self.last_status = None
        self.last_bad_iter = None

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

    def __call__(self, b, x0=None):
        """Execute: returns (x, res_norms) as numpy, mirroring the RHS
        shape; the per-RHS iteration counts, status and bad_iter land in
        ``last_*`` and in ``engine.last_solve_info``.  A shared (n,) ``x0``
        is broadcast over a (k, n) batch."""
        b = np.asarray(b)
        self._check(b)
        if x0 is None:
            x0 = np.zeros(b.shape)
        else:
            x0 = np.asarray(x0)
            if b.ndim == 2 and x0.ndim == 1:
                x0 = np.broadcast_to(x0, b.shape)
        eng = self.engine
        res = self._fn(eng.to_device_vec(b), eng.to_device_vec(x0))
        self.executions += 1
        self.last_iters = res.iters
        self.last_status = res.status
        self.last_bad_iter = res.bad_iter
        info = dict(self.info)
        info["iters"] = self.last_iters
        info["status"] = self.last_status
        info["status_names"] = self.last_status_names
        info["bad_iter"] = self.last_bad_iter
        eng.last_solve_info = info
        return eng.from_device_vec(res.x), res.res_norms


class PlanCache:
    """Spec-keyed store of lowered plans (the engine's ``plans``): equal
    canonical specs hit, anything else misses and builds exactly once."""

    def __init__(self):
        self._plans: dict = {}
        self.hits = 0
        self.misses = 0

    def get(self, spec: SolveSpec, build: Callable):
        plan = self._plans.get(spec)
        if plan is None:
            self.misses += 1
            plan = self._plans[spec] = build(spec)
        else:
            self.hits += 1
        return plan

    def __len__(self) -> int:
        return len(self._plans)
