"""Solver / preconditioner registry: capability metadata driving plan
lowering (port of ``repro.core.registry`` for local solves).

A :class:`SolverDef` names an iteration and declares what it supports; a
:class:`PrecondDef` names a preconditioner and how its local apply is
built.  ``canonicalize`` and the engine's lowering read these instead of
branching on names.  The first slice registers ``pcg`` and ``pcg_tol``
with the ``jacobi`` and ``identity`` (alias ``none``) preconditioners.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

__all__ = ["SolverDef", "PrecondDef", "SolveContext", "get_solver",
           "get_precond", "resolve_fused", "substrate_kind"]


@dataclass
class SolveContext:
    """The operator bundle plan lowering hands a solver's ``run``."""

    matvec: Callable
    psolve: Callable
    substrate: Any = None             # SolverSubstrate or None (reference)
    iters: int = 0
    tol: float | None = None
    max_iters: int | None = None
    guard: bool = True


@dataclass(frozen=True)
class SolverDef:
    """Capability metadata + adapter for one iterative method.

    ``fused_local`` lists the preconditioner names the method runs a fused
    substrate with; ``tolerance`` marks methods that read ``tol``/
    ``max_iters``; ``batched`` marks methods that take a stacked (k, n)
    RHS; ``guarded`` marks methods with in-loop health guards."""

    name: str
    run: Callable[[SolveContext, Any, Any], Any]   # (ctx, b, x0) -> SolveResult
    tolerance: bool = False
    batched: bool = True
    fused_local: frozenset = frozenset()
    guarded: bool = False


@dataclass(frozen=True)
class PrecondDef:
    """Capability metadata + local apply builder for one preconditioner.
    ``local_apply(engine)`` returns the ``psolve`` closure over the
    engine's device operands; ``uses_dinv`` marks the ones the fused
    update applies in-stream from the inverse diagonal."""

    name: str
    local_apply: Callable
    aliases: tuple = ()
    uses_dinv: bool = False


_SOLVERS: dict[str, SolverDef] = {}
_PRECONDS: dict[str, PrecondDef] = {}
_PRECOND_ALIASES: dict[str, str] = {}


def _register_solver(sdef: SolverDef) -> None:
    _SOLVERS[sdef.name] = sdef


def _register_precond(pdef: PrecondDef) -> None:
    _PRECONDS[pdef.name] = pdef
    for a in pdef.aliases:
        _PRECOND_ALIASES[a] = pdef.name


def get_solver(name: str) -> SolverDef:
    try:
        return _SOLVERS[name]
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; registered: {', '.join(sorted(_SOLVERS))}"
        ) from None


def get_precond(name: str) -> PrecondDef:
    name = _PRECOND_ALIASES.get(name, name)
    try:
        return _PRECONDS[name]
    except KeyError:
        raise ValueError(
            f"unknown preconditioner {name!r}; "
            f"registered: {', '.join(sorted(_PRECONDS))}"
        ) from None


def resolve_fused(sdef: SolverDef, pdef: PrecondDef, knob) -> bool:
    """Map the tri-state fused knob ('auto' | True | False) to a bool:
    'auto' and True mean "fused wherever this (method, precond) pair
    supports it" -- a capability lookup, not a name ladder."""
    if knob not in ("auto", True, False):
        raise ValueError(f"fused must be 'auto', True or False, got {knob!r}")
    return pdef.name in sdef.fused_local if knob in ("auto", True) else False


def substrate_kind(fused: bool) -> str:
    """The substrate a local plan with this resolved fused flag lowers to:
    "fused" (the hand-written kernels) or "reference" (plain PyTorch).
    The fused IC(0) kind arrives with the block-IC(0) slice."""
    return "fused" if fused else "reference"


# ---------------------------------------------------------------------------
# built-in solvers (adapters over repro_torch.core.solvers)
# ---------------------------------------------------------------------------

_LOCAL_PRECONDS = frozenset({"identity", "jacobi"})


def _run_pcg(c: SolveContext, b, x0):
    from . import solvers

    return solvers.pcg(c.matvec, b, psolve=c.psolve, x0=x0, iters=c.iters,
                       substrate=c.substrate, guard=c.guard)


def _run_pcg_tol(c: SolveContext, b, x0):
    from . import solvers

    return solvers.pcg_tol(c.matvec, b, psolve=c.psolve, x0=x0, tol=c.tol,
                           max_iters=c.max_iters, substrate=c.substrate,
                           guard=c.guard)


_register_solver(SolverDef(name="pcg", run=_run_pcg,
                           fused_local=_LOCAL_PRECONDS, guarded=True))
_register_solver(SolverDef(name="pcg_tol", run=_run_pcg_tol, tolerance=True,
                           fused_local=_LOCAL_PRECONDS, guarded=True))


# ---------------------------------------------------------------------------
# built-in preconditioners
# ---------------------------------------------------------------------------


def _identity_apply(engine):
    return lambda r: r


def _jacobi_apply(engine):
    dinv = engine._dinv_pad
    return lambda r: r * dinv


_register_precond(PrecondDef(name="identity", local_apply=_identity_apply,
                             aliases=("none",)))
_register_precond(PrecondDef(name="jacobi", local_apply=_jacobi_apply,
                             uses_dinv=True))
