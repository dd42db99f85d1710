"""Solver / preconditioner registry: capability metadata driving plan
lowering (port of ``repro.core.registry``).

A :class:`SolverDef` names an iteration and declares what it supports; a
:class:`PrecondDef` names a preconditioner and how its local apply is
built.  ``canonicalize`` and the engine's lowering read these instead of
branching on names; ``register_solver`` / ``register_precond`` add
entries (``unregister_solver`` / ``unregister_precond`` take one out)
with the JAX package's signatures.  Registered: the solvers ``pcg``, ``pcg_tol``,
``cg``, ``pcg_pipelined`` (alias ``pcg_pipe``), ``pcg_pipelined_tol``
and ``jacobi``; the preconditioners ``jacobi``, ``identity`` (alias
``none``) and ``block_ic0``.  The resolution rules take ``local=False``
for a distributed (tile-grid) engine, as the JAX package's take its
``local`` flag: ``fused_dist`` capabilities, the halo layout where the
engine's comm plan says it pays, padded ELL pinned, and the shard
substrate kinds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
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
    dot: Callable | None = None       # the tile grid's reducing dot
    dot2: Callable | None = None      # ... and its stacked reduction


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
    ``canonicalize`` rewrites, so they share one plan).  On a tile grid:
    ``fused_dist`` lists the preconditioners the method runs a shard
    substrate with, ``halo_dist`` those it may run on the compiled halo
    schedule, ``comm_overlap`` marks methods whose recurrence consumes
    the split communication-hiding matvec, and ``*_precond_override``
    remap the preconditioner ``psolve`` is built from, per mode."""

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
    fused_dist: frozenset = frozenset()
    halo_dist: frozenset = frozenset()
    comm_overlap: bool = False
    local_precond_override: dict = field(default_factory=dict)
    dist_precond_override: dict = field(default_factory=dict)


@dataclass(frozen=True)
class PrecondDef:
    """Capability metadata + local apply builder for one preconditioner.
    ``local_apply(engine)`` returns the ``psolve`` closure over the
    engine's device operands; ``uses_dinv`` marks the ones the fused
    update applies in-stream from the inverse diagonal; ``factorized``
    the ones built from host factors, whose fused substrate is
    ``fused_local_kind``.  ``fused_local_needs_kernels`` marks those whose
    fused substrate pays only where the kernels launch: there "auto"
    picks it on a CUDA engine only (``fused=True`` still forces it).
    ``fused_shard_kind`` is its substrate on a tile grid."""

    name: str
    local_apply: Callable
    aliases: tuple = ()
    uses_dinv: bool = False
    factorized: bool = False
    fused_local_kind: str = "fused"
    fused_local_needs_kernels: bool = False
    fused_shard_kind: str = "fused_shard"


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
                  device: torch.device, local: bool = True) -> bool:
    """Map the tri-state fused knob ('auto' | True | False) to a bool:
    'auto' and True mean "fused wherever this (method, precond, mode)
    supports it" -- a capability lookup, not a name ladder.  'auto' also
    defers to the engine's ``device`` for preconditioners marked
    ``fused_local_needs_kernels``, on a local engine: their fused
    substrate on a CUDA device, where the kernels launch, the reference
    one on the CPU."""
    if knob not in ("auto", True, False):
        raise ValueError(f"fused must be 'auto', True or False, got {knob!r}")
    supported = pdef.name in (sdef.fused_local if local else sdef.fused_dist)
    if (knob == "auto" and supported and local and sdef.fused_precond_apply
            and pdef.fused_local_needs_kernels):
        supported = device.type == "cuda"
    return supported if knob in ("auto", True) else False


def resolve_layout(knob, sdef: SolverDef | None = None,
                   pdef: PrecondDef | None = None, local: bool = True,
                   halo_profitable: bool = False) -> str:
    """Resolve the communication-layout knob (None/'auto' | 'halo' |
    'dense') to the layout a plan lowers with.  A local engine has no
    NoC: every plan lowers 'dense' and 'halo' raises.  On a tile grid
    'auto' picks 'halo' where the (method, preconditioner) pair declares
    halo support and the engine's comm plan moves fewer bytes with it
    (``halo_profitable``); an explicit 'halo' forces the schedule,
    capability permitting."""
    if knob not in (None, "auto", "halo", "dense"):
        raise ValueError(
            f"layout must be 'auto', 'halo' or 'dense', got {knob!r}")
    if local:
        if knob == "halo":
            raise ValueError("layout='halo' needs a distributed engine "
                             "(single-device engines have no NoC)")
        return "dense"
    supported = pdef.name in sdef.halo_dist
    if knob in (None, "auto"):
        return "halo" if (supported and halo_profitable) else "dense"
    if knob == "halo" and not supported:
        raise ValueError(
            f"solver {sdef.name!r} does not support halo communication "
            f"plans with preconditioner {pdef.name!r}")
    return knob


def resolve_format(sdef: SolverDef, knob, engine_choice: str = "ell", *,
                   stencil: bool = False, injectable: bool = False,
                   local: bool = True) -> str:
    """Resolve the storage-format knob (None/'auto' | a format name) to the
    format a local plan streams the operator from: 'auto' takes the
    engine's per-matrix choice (``engine_choice``, from
    ``kernels.autotune.choose_format``).  Two modes pin the format and
    reject a conflicting explicit request: a stencil engine has no stored
    nonzeros, so 'stencil' is its only format (and 'stencil' needs one),
    and an injectable plan takes the values as an ELL-shaped per-call
    operand, so it is 'ell'.  A tile grid (``local=False``) shards and
    remaps padded ELL, so it pins 'ell' too."""
    if knob not in (None, "auto") and knob not in _ALL_FORMATS:
        raise ValueError(
            f"format must be 'auto' or one of "
            f"{', '.join(sorted(_ALL_FORMATS))}, got {knob!r}")
    if stencil:
        if knob not in (None, "auto", "stencil"):
            raise ValueError(
                f"format={knob!r} conflicts with a matrix-free stencil "
                "engine (no stored nonzeros to re-lay-out)")
        if injectable:
            raise ValueError(
                "injectable=True needs stored matrix values; a stencil "
                "operator generates its coefficients in-kernel")
        return "stencil"
    if knob == "stencil":
        raise ValueError("format='stencil' needs a stencil operator engine")
    if injectable:
        if knob not in (None, "auto", "ell"):
            raise ValueError(
                f"format={knob!r} conflicts with injectable=True "
                "(injected values are an ELL-shaped runtime operand)")
        return "ell"
    if not local:
        if knob not in (None, "auto", "ell"):
            raise ValueError(
                f"format={knob!r} is not supported in distributed mode "
                "(sharding and halo remap are phrased over padded ELL)")
        return "ell"
    fmt = engine_choice if knob in (None, "auto") else knob
    if fmt not in sdef.formats:
        raise ValueError(
            f"solver {sdef.name!r} does not support format {fmt!r}")
    return fmt


def substrate_kind(sdef: SolverDef, pdef: PrecondDef, fused: bool,
                   local: bool = True) -> str:
    """The substrate a plan with this resolved fused flag lowers to:
    "reference" (plain PyTorch), or the hand-written kernels' "fused" or
    "fused_ic0" locally and "fused_shard" or "fused_shard_ic0" on a tile
    grid.  A factorized preconditioner reaches its own kind only through
    methods whose fused update applies M^-1 in-stream."""
    if not fused:
        return "reference"
    if sdef.fused_precond_apply:
        return pdef.fused_local_kind if local else pdef.fused_shard_kind
    return "fused" if local else "fused_shard"


def effective_precond(sdef: SolverDef, engine_precond: str,
                      local: bool = True) -> PrecondDef:
    """The preconditioner a solver's ``psolve`` is built from: the
    engine's, except that an unpreconditioned method gets identity, or
    jacobi when the iteration itself needs the diagonal, and that the
    method's per-mode override applies."""
    if not sdef.preconditioned:
        return get_precond("jacobi" if sdef.needs_dinv else "identity")
    ov = sdef.local_precond_override if local else sdef.dist_precond_override
    name = _PRECOND_ALIASES.get(engine_precond, engine_precond)
    return get_precond(ov.get(name, name))


# ---------------------------------------------------------------------------
# built-in solvers (adapters over repro_torch.core.solvers)
# ---------------------------------------------------------------------------

_ALL_PRECONDS = frozenset({"identity", "jacobi", "block_ic0"})


def _dot_kw(c: SolveContext) -> dict:
    return {"dot": c.dot} if c.dot is not None else {}


def _pipe_kw(c: SolveContext) -> dict:
    kw = _dot_kw(c)
    if c.dot2 is not None:
        kw["dot2"] = c.dot2
    return kw


def _run_pcg(c: SolveContext, b, x0):
    from . import solvers

    return solvers.pcg(c.matvec, b, psolve=c.psolve, x0=x0, iters=c.iters,
                       substrate=c.substrate, guard=c.guard, **_dot_kw(c))


def _run_pcg_tol(c: SolveContext, b, x0):
    from . import solvers

    return solvers.pcg_tol(c.matvec, b, psolve=c.psolve, x0=x0, tol=c.tol,
                           max_iters=c.max_iters, substrate=c.substrate,
                           guard=c.guard, **_dot_kw(c))


def _run_cg(c: SolveContext, b, x0):
    from . import solvers

    return solvers.cg(c.matvec, b, x0=x0, iters=c.iters,
                      substrate=c.substrate, guard=c.guard, **_dot_kw(c))


def _run_pcg_pipelined(c: SolveContext, b, x0):
    from . import solvers

    return solvers.pcg_pipelined(c.matvec, b, psolve=c.psolve, x0=x0,
                                 iters=c.iters, substrate=c.substrate,
                                 guard=c.guard, **_pipe_kw(c))


def _run_pcg_pipelined_tol(c: SolveContext, b, x0):
    from . import solvers

    return solvers.pcg_pipelined_tol(c.matvec, b, psolve=c.psolve, x0=x0,
                                     tol=c.tol, max_iters=c.max_iters,
                                     substrate=c.substrate, guard=c.guard,
                                     **_pipe_kw(c))


def _run_jacobi(c: SolveContext, b, x0):
    from . import solvers

    return solvers.jacobi(c.matvec, c.dinv, b, x0=x0, iters=c.iters,
                          **_dot_kw(c))


_CAPS = dict(fused_local=_ALL_PRECONDS, fused_dist=_ALL_PRECONDS,
             halo_dist=_ALL_PRECONDS, guarded=True)
register_solver(SolverDef(name="pcg", run=_run_pcg,
                           fused_precond_apply=True, **_CAPS))
register_solver(SolverDef(name="pcg_tol", run=_run_pcg_tol, tolerance=True,
                           fused_precond_apply=True, **_CAPS))
register_solver(SolverDef(name="cg", run=_run_cg, preconditioned=False,
                           **_CAPS))
register_solver(SolverDef(name="pcg_pipelined", run=_run_pcg_pipelined,
                           fused_precond_apply=True, comm_overlap=True,
                           aliases=("pcg_pipe",), **_CAPS))
register_solver(SolverDef(name="pcg_pipelined_tol",
                           run=_run_pcg_pipelined_tol, tolerance=True,
                           fused_precond_apply=True, comm_overlap=True,
                           **_CAPS))
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
    fused_local_kind="fused_ic0", fused_shard_kind="fused_shard_ic0",
    # "auto" takes the fused substrate where its kernel launches, as the
    # JAX package takes it where its Pallas kernels dispatch
    fused_local_needs_kernels=True,
))
