"""Solver / preconditioner registry: capability metadata driving plan
lowering (port of ``repro.core.registry`` for local solves).

A :class:`SolverDef` names an iteration and declares what it supports; a
:class:`PrecondDef` names a preconditioner and how its local apply is
built.  ``canonicalize`` and the engine's lowering read these instead of
branching on names; ``register_solver`` / ``register_precond`` add
entries (``unregister_solver`` / ``unregister_precond`` take one out)
with the JAX package's signatures.  Registered: the solvers ``pcg``, ``pcg_tol``,
``cg``, ``pcg_pipelined`` (alias ``pcg_pipe``), ``pcg_pipelined_tol``
and ``jacobi``; the preconditioners ``jacobi``, ``identity`` (alias
``none``) and ``block_ic0``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

__all__ = ["SolverDef", "PrecondDef", "SolveContext", "register_solver",
           "register_precond", "unregister_solver", "unregister_precond",
           "get_solver", "get_precond", "solver_names", "precond_names",
           "resolve_fused", "resolve_layout", "resolve_format",
           "substrate_kind", "effective_precond"]

# Storage formats a solver's substrate can stream the operator from: the
# substrate-phrased methods take any (matvec, fold) pair.
_ALL_FORMATS = frozenset({"ell", "sell", "hyb", "bcsr", "stencil"})


@dataclass
class SolveContext:
    """The operator bundle plan lowering hands a solver's ``run``."""

    matvec: Callable
    psolve: Callable
    dinv: Any = None                  # padded inverse diagonal (jacobi)
    substrate: Any = None             # SolverSubstrate or None (reference)
    iters: int = 0
    tol: float | None = None
    max_iters: int | None = None
    guard: bool = True
    cell: Any = None                  # the plan's loop.ProgramCell


@dataclass(frozen=True)
class SolverDef:
    """Capability metadata + adapter for one iterative method.

    ``fused_local`` lists the preconditioner names the method runs a fused
    substrate with; ``fused_precond_apply`` marks methods whose fused
    update applies M^-1 in-stream (so a factorized preconditioner reaches
    its own fused kind); ``tolerance`` marks methods that read ``tol``/
    ``max_iters``; ``batched`` marks methods that take a stacked (k, n)
    RHS; ``preconditioned`` marks methods that consume the engine's
    preconditioner at all (``cg`` does not); ``needs_dinv`` marks methods
    whose iteration itself reads the inverse diagonal (the ``jacobi``
    smoother); ``guarded`` marks methods with in-loop health guards;
    ``formats`` lists the storage formats the method streams; ``aliases``
    are other spellings :func:`get_solver` resolves to this entry (and
    ``canonicalize`` rewrites, so they share one plan)."""

    name: str
    run: Callable[[SolveContext, Any, Any], Any]   # (ctx, b, x0) -> SolveResult
    tolerance: bool = False
    batched: bool = True
    preconditioned: bool = True
    needs_dinv: bool = False
    fused_local: frozenset = frozenset()
    fused_precond_apply: bool = False
    guarded: bool = False
    formats: frozenset = _ALL_FORMATS
    aliases: tuple = ()


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
_SOLVER_ALIASES: dict[str, str] = {}
_PRECONDS: dict[str, PrecondDef] = {}
_PRECOND_ALIASES: dict[str, str] = {}


def register_solver(sdef: SolverDef) -> SolverDef:
    _SOLVERS[sdef.name] = sdef
    for a in sdef.aliases:
        _SOLVER_ALIASES[a] = sdef.name
    return sdef


def register_precond(pdef: PrecondDef) -> PrecondDef:
    _PRECONDS[pdef.name] = pdef
    for a in pdef.aliases:
        _PRECOND_ALIASES[a] = pdef.name
    return pdef


def unregister_solver(name: str) -> None:
    sdef = _SOLVERS.pop(name, None)
    if sdef is not None:
        for a in sdef.aliases:
            _SOLVER_ALIASES.pop(a, None)


def unregister_precond(name: str) -> None:
    pdef = _PRECONDS.pop(name, None)
    if pdef is not None:
        for a in pdef.aliases:
            _PRECOND_ALIASES.pop(a, None)


def get_solver(name: str) -> SolverDef:
    name = _SOLVER_ALIASES.get(name, name)
    try:
        return _SOLVERS[name]
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; registered: {', '.join(sorted(_SOLVERS))}"
        ) from None


def solver_names() -> tuple:
    """Every spelling :func:`get_solver` takes: the registered names, then
    their aliases, each sorted."""
    return tuple(sorted(_SOLVERS) + sorted(_SOLVER_ALIASES))


def get_precond(name: str) -> PrecondDef:
    name = _PRECOND_ALIASES.get(name, name)
    try:
        return _PRECONDS[name]
    except KeyError:
        raise ValueError(
            f"unknown preconditioner {name!r}; "
            f"registered: {', '.join(precond_names())}"
        ) from None


def precond_names() -> tuple:
    return tuple(sorted(_PRECONDS))


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


def resolve_layout(knob) -> str:
    """Resolve the communication-layout knob (None/'auto' | 'halo' |
    'dense') for a local engine: one device has no NoC, so every plan
    lowers 'dense', and 'halo' raises, as the JAX package's local rule
    does.  The distributed rule arrives with the tile grid (ROADMAP
    Queue 1 item 10)."""
    if knob not in (None, "auto", "halo", "dense"):
        raise ValueError(
            f"layout must be 'auto', 'halo' or 'dense', got {knob!r}")
    if knob == "halo":
        raise ValueError("layout='halo' needs a distributed engine "
                         "(single-device engines have no NoC)")
    return "dense"


def resolve_format(sdef: SolverDef, knob, engine_choice: str = "ell", *,
                   stencil: bool = False) -> str:
    """Resolve the storage-format knob (None/'auto' | a format name) to the
    format a local plan streams the operator from: 'auto' takes the
    engine's per-matrix choice (``engine_choice``, from
    ``kernels.autotune.choose_format``).  A stencil engine has no stored
    nonzeros, so 'stencil' is its only format; 'stencil' needs one."""
    if knob not in (None, "auto") and knob not in _ALL_FORMATS:
        raise ValueError(
            f"format must be 'auto' or one of "
            f"{', '.join(sorted(_ALL_FORMATS))}, got {knob!r}")
    if stencil:
        if knob not in (None, "auto", "stencil"):
            raise ValueError(
                f"format={knob!r} conflicts with a matrix-free stencil "
                "engine (no stored nonzeros to re-lay-out)")
        return "stencil"
    if knob == "stencil":
        raise ValueError("format='stencil' needs a stencil operator engine")
    fmt = engine_choice if knob in (None, "auto") else knob
    if fmt not in sdef.formats:
        raise ValueError(
            f"solver {sdef.name!r} does not support format {fmt!r}")
    return fmt


def substrate_kind(sdef: SolverDef, pdef: PrecondDef, fused: bool) -> str:
    """The substrate a local plan with this resolved fused flag lowers to:
    "reference" (plain PyTorch), or the hand-written kernels' "fused" or
    "fused_ic0".  A factorized preconditioner reaches its own kind only
    through methods whose fused update applies M^-1 in-stream."""
    if not fused:
        return "reference"
    return pdef.fused_local_kind if sdef.fused_precond_apply else "fused"


def effective_precond(sdef: SolverDef, engine_precond: str) -> PrecondDef:
    """The preconditioner a solver's ``psolve`` is built from: the
    engine's, except that an unpreconditioned method gets identity, or
    jacobi when the iteration itself needs the diagonal."""
    if not sdef.preconditioned:
        return get_precond("jacobi" if sdef.needs_dinv else "identity")
    return get_precond(engine_precond)


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


def _run_cg(c: SolveContext, b, x0):
    from . import solvers

    return solvers.cg(c.matvec, b, x0=x0, iters=c.iters,
                      substrate=c.substrate, guard=c.guard)


def _run_pcg_pipelined(c: SolveContext, b, x0):
    from . import solvers

    return solvers.pcg_pipelined(c.matvec, b, psolve=c.psolve, x0=x0,
                                 iters=c.iters, substrate=c.substrate,
                                 guard=c.guard)


def _run_pcg_pipelined_tol(c: SolveContext, b, x0):
    from . import solvers

    return solvers.pcg_pipelined_tol(c.matvec, b, psolve=c.psolve, x0=x0,
                                     tol=c.tol, max_iters=c.max_iters,
                                     substrate=c.substrate, guard=c.guard)


def _run_jacobi(c: SolveContext, b, x0):
    from . import solvers

    return solvers.jacobi(c.matvec, c.dinv, b, x0=x0, iters=c.iters)


register_solver(SolverDef(name="pcg", run=_run_pcg,
                           fused_local=_LOCAL_PRECONDS,
                           fused_precond_apply=True, guarded=True))
register_solver(SolverDef(name="pcg_tol", run=_run_pcg_tol, tolerance=True,
                           fused_local=_LOCAL_PRECONDS,
                           fused_precond_apply=True, guarded=True))
register_solver(SolverDef(name="cg", run=_run_cg, preconditioned=False,
                           fused_local=_LOCAL_PRECONDS, guarded=True))
register_solver(SolverDef(name="pcg_pipelined", run=_run_pcg_pipelined,
                           fused_local=_LOCAL_PRECONDS,
                           fused_precond_apply=True, guarded=True,
                           aliases=("pcg_pipe",)))
register_solver(SolverDef(name="pcg_pipelined_tol",
                           run=_run_pcg_pipelined_tol, tolerance=True,
                           fused_local=_LOCAL_PRECONDS,
                           fused_precond_apply=True, guarded=True))
register_solver(SolverDef(name="jacobi", run=_run_jacobi,
                           preconditioned=False, needs_dinv=True))


# ---------------------------------------------------------------------------
# built-in preconditioners
# ---------------------------------------------------------------------------


def _identity_apply(engine):
    return lambda r: r


def _jacobi_apply(engine):
    dinv = engine._dinv_pad
    return lambda r: r * dinv


register_precond(PrecondDef(name="identity", local_apply=_identity_apply,
                             aliases=("none",)))
register_precond(PrecondDef(name="jacobi", local_apply=_jacobi_apply,
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


register_precond(PrecondDef(
    name="block_ic0", local_apply=_block_ic0_apply, factorized=True,
    fused_local_kind="fused_ic0",
    # "auto" takes the fused substrate where its kernel launches, as the
    # JAX package takes it where its Pallas kernels dispatch
    fused_local_needs_kernels=True,
))
