"""Solver / preconditioner registry: capability metadata driving plan
lowering (port of ``repro.core.registry`` for local solves).

A :class:`SolverDef` names an iteration and declares what it supports; a
:class:`PrecondDef` names a preconditioner and how its local apply is
built.  ``canonicalize`` and the engine's lowering read these instead of
branching on names.  Registered: ``pcg`` and ``pcg_tol`` with the
``jacobi``, ``identity`` (alias ``none``) and ``block_ic0``
preconditioners.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

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
    substrate with; ``fused_precond_apply`` marks methods whose fused
    update applies M^-1 in-stream (so a factorized preconditioner reaches
    its own fused kind); ``tolerance`` marks methods that read ``tol``/
    ``max_iters``; ``batched`` marks methods that take a stacked (k, n)
    RHS; ``guarded`` marks methods with in-loop health guards."""

    name: str
    run: Callable[[SolveContext, Any, Any], Any]   # (ctx, b, x0) -> SolveResult
    tolerance: bool = False
    batched: bool = True
    fused_local: frozenset = frozenset()
    fused_precond_apply: bool = False
    guarded: bool = False


@dataclass(frozen=True)
class PrecondDef:
    """Capability metadata + local apply builder for one preconditioner.
    ``local_apply(engine)`` returns the ``psolve`` closure over the
    engine's device operands; ``uses_dinv`` marks the ones the fused
    update applies in-stream from the inverse diagonal; ``factorized``
    the ones built from host factors, whose fused substrate is
    ``fused_local_kind``.  ``fused_local_needs_kernels`` marks those whose
    fused substrate pays only where the kernels launch: there "auto"
    picks it on a CUDA engine only (``fused=True`` still forces it)."""

    name: str
    local_apply: Callable
    aliases: tuple = ()
    uses_dinv: bool = False
    factorized: bool = False
    fused_local_kind: str = "fused"
    fused_local_needs_kernels: bool = False


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


def resolve_fused(sdef: SolverDef, pdef: PrecondDef, knob,
                  device: torch.device) -> bool:
    """Map the tri-state fused knob ('auto' | True | False) to a bool:
    'auto' and True mean "fused wherever this (method, precond) pair
    supports it" -- a capability lookup, not a name ladder.  'auto' also
    defers to the engine's ``device`` for preconditioners marked
    ``fused_local_needs_kernels``: their fused substrate on a CUDA device,
    where the kernels launch, the reference one on the CPU."""
    if knob not in ("auto", True, False):
        raise ValueError(f"fused must be 'auto', True or False, got {knob!r}")
    supported = pdef.name in sdef.fused_local
    if (knob == "auto" and supported and sdef.fused_precond_apply
            and pdef.fused_local_needs_kernels):
        supported = device.type == "cuda"
    return supported if knob in ("auto", True) else False


def substrate_kind(sdef: SolverDef, pdef: PrecondDef, fused: bool) -> str:
    """The substrate a local plan with this resolved fused flag lowers to:
    "reference" (plain PyTorch), or the hand-written kernels' "fused" or
    "fused_ic0".  A factorized preconditioner reaches its own kind only
    through methods whose fused update applies M^-1 in-stream."""
    if not fused:
        return "reference"
    return pdef.fused_local_kind if sdef.fused_precond_apply else "fused"


# ---------------------------------------------------------------------------
# built-in solvers (adapters over repro_torch.core.solvers)
# ---------------------------------------------------------------------------

_LOCAL_PRECONDS = frozenset({"identity", "jacobi", "block_ic0"})


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
                           fused_local=_LOCAL_PRECONDS,
                           fused_precond_apply=True, guarded=True))
_register_solver(SolverDef(name="pcg_tol", run=_run_pcg_tol, tolerance=True,
                           fused_local=_LOCAL_PRECONDS,
                           fused_precond_apply=True, guarded=True))


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


def _block_ic0_apply(engine):
    from .precond import apply_ic0

    f = engine._ic0
    n, n_pad = engine.n, engine.n_pad

    def ps1(r):
        z = torch.zeros(n_pad, dtype=r.dtype, device=r.device)
        z[:n] = apply_ic0(f, r[:n])
        return z

    def ps(r):
        return torch.stack([ps1(v) for v in r]) if r.dim() == 2 else ps1(r)

    return ps


_register_precond(PrecondDef(
    name="block_ic0", local_apply=_block_ic0_apply, factorized=True,
    fused_local_kind="fused_ic0",
    # "auto" takes the fused substrate where its kernel launches, as the
    # JAX package takes it where its Pallas kernels dispatch
    fused_local_needs_kernels=True,
))
