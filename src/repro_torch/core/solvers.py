"""Preconditioned CG with fixed-iteration and tolerance stopping.

Port of ``repro.core.solvers`` (``pcg`` and ``pcg_tol``, guarded and
unguarded) for one (n,) right-hand side.  The recurrence is the JAX
package's folded, substrate-phrased one: ``p = z + beta*p`` runs at the top
of each step inside ``fold_matvec_dot``, and ``update`` returns x, r, z and
both dots from one pass.

``lax.scan``/``lax.while_loop`` become Python loops.  The vectors and the
recurrence scalars (alpha, beta, rz and the dots) stay 0-d tensors on the
vectors' device -- the kernels read alpha and beta through pointers.  Each
iteration makes ONE device-to-host copy, of the dots the step already
reduced (``[pAp, rr, rz]``); the stopping test, the guards and the
residual trace then run on the host in numpy scalars of the vectors'
dtype, with the JAX package's arithmetic (its float32 casts included), so
the iteration count, ``status``, ``bad_iter`` and the ``(max_iters + 1,)``
trace ring equal the JAX package's.  A faulted step keeps the pre-step
state, as ``solvers._sel`` does on the TPU.

Results: ``x`` is a tensor on the vectors' device; ``res_norms``,
``iters``, ``status`` and ``bad_iter`` are host numpy values.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..device import resolve_dtype
from .substrate import SolverSubstrate, reference_substrate

__all__ = ["SolveResult", "pcg", "pcg_tol", "status_name", "ensure_status",
           "STATUS_CONVERGED", "STATUS_MAXITER", "STATUS_BREAKDOWN",
           "STATUS_DIVERGED", "STATUS_STAGNATED", "STATUS_UNGUARDED",
           "DIVERGENCE_FACTOR", "STALL_WINDOW", "SIGN_GUARD_FLOOR"]

# Structured per-RHS solve status (the JAX package's codes).  Fixed-
# iteration methods report ``maxiter`` on clean completion; tolerance
# methods distinguish converged from maxiter.
STATUS_CONVERGED = 0     # tolerance met
STATUS_MAXITER = 1       # iteration budget exhausted (or fixed-iter run)
STATUS_BREAKDOWN = 2     # NaN/Inf or indefinite M / A (rho or pAp <= 0)
STATUS_DIVERGED = 3      # residual grew past DIVERGENCE_FACTOR * |r0|
STATUS_STAGNATED = 4     # no new best residual for STALL_WINDOW iterations
STATUS_UNGUARDED = -1    # method ran without guards (guard=False)

_STATUS_NAMES = {
    STATUS_CONVERGED: "converged",
    STATUS_MAXITER: "maxiter",
    STATUS_BREAKDOWN: "breakdown",
    STATUS_DIVERGED: "diverged",
    STATUS_STAGNATED: "stagnated",
    STATUS_UNGUARDED: "unguarded",
}

# Residual growth treated as divergence: 8 orders of magnitude never
# happens on a converging SPD solve.
DIVERGENCE_FACTOR = 1e8

# Tolerance mode: an active solve with no new best residual for this many
# consecutive iterations is stagnated.
STALL_WINDOW = 100

# Sign-based breakdown tests apply only while the pre-step residual exceeds
# this many dtype eps relative to ||r0||: below it the recurrence scalars
# are cancellation noise and their signs flip benignly.
SIGN_GUARD_FLOOR = 1e3

Vec = torch.Tensor


def status_name(code: int) -> str:
    """Human-readable name for a status code (``'breakdown'``, ...)."""
    return _STATUS_NAMES.get(int(code), f"unknown({int(code)})")


class SolveResult(NamedTuple):
    x: Vec                      # (n,) tensor on the vectors' device
    res_norms: np.ndarray       # (iters + 1,) or (max_iters + 1,) trace
    iters: np.ndarray           # int32 () -- iterations applied
    status: np.ndarray | None = None   # int32 () STATUS_*
    bad_iter: np.ndarray | None = None  # int32 () first faulted step, -1


def _i32(v: int) -> np.ndarray:
    return np.asarray(v, dtype=np.int32)


def ensure_status(res: SolveResult, b: Vec) -> SolveResult:
    """Fill a missing status/bad_iter with UNGUARDED / -1."""
    if res.status is not None and res.bad_iter is not None:
        return res
    status = res.status if res.status is not None else _i32(STATUS_UNGUARDED)
    bad = res.bad_iter if res.bad_iter is not None else _i32(-1)
    return SolveResult(res.x, res.res_norms, res.iters, status, bad)


def _default_dot(u: Vec, v: Vec) -> Vec:
    return torch.sum(u * v)


def _fetch(*scalars: Vec) -> np.ndarray:
    """One device-to-host copy of several 0-d tensors."""
    return torch.stack(scalars).cpu().numpy()


def _safe_div(num: Vec, den: Vec) -> Vec:
    """num / den with a zero denominator replaced by 1 (converged or zero
    RHS: the step freezes instead of emitting NaN)."""
    return num / torch.where(den == 0, 1.0, den)


def _nonfinite(*vals) -> bool:
    return not all(np.isfinite(v) for v in vals)


def _sign_live(rn_prev, r0, dt) -> bool:
    """Whether the pre-step residual is above the sign-guard floor."""
    return bool(rn_prev > (dt(SIGN_GUARD_FLOOR) * np.finfo(dt).eps) * r0)


def _fault_code(breakdown: bool, diverged: bool, stalled: bool = False) -> int:
    """Priority breakdown > diverged > stagnated; 0 where no fault."""
    if breakdown:
        return STATUS_BREAKDOWN
    if diverged:
        return STATUS_DIVERGED
    return STATUS_STAGNATED if stalled else 0


def _step(sub: SolverSubstrate, x, r, z, p, rz, beta):
    """One folded PCG step -> (x', r', z', p', rz', beta', pAp, rr)."""
    p2, ap, denom = sub.fold_matvec_dot(z, p, beta)
    alpha = _safe_div(rz, denom)
    x2, r2, z2, rr, rz2 = sub.update(alpha, x, r, p2, ap)
    beta2 = _safe_div(rz2, rz)
    return x2, r2, z2, p2, rz2, beta2, denom, rr


def _breakdown(rn, denom, rz_prev, rz_new, rn_prev, r0, dt) -> bool:
    """NaN/Inf in a reduced slot, or (above the sign floor) pAp < 0 with
    rz > 0, or rz' < 0: an indefinite A or M."""
    sign_bad = (denom < 0 and rz_prev > 0) or rz_new < 0
    return (_nonfinite(rn, denom, rz_new)
            or (_sign_live(rn_prev, r0, dt) and sign_bad))


def _start(sub, b, x0):
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - sub.matvec(x)
    z = sub.psolve(r)
    rz = sub.dot(r, z)
    return x, r, z, rz, torch.zeros_like(b), torch.zeros_like(rz)


def pcg(
    matvec: Callable,
    b: Vec,
    psolve: Callable,
    x0: Vec | None = None,
    iters: int = 100,
    dot: Callable = _default_dot,
    substrate: SolverSubstrate | None = None,
    guard: bool = True,
) -> SolveResult:
    """Preconditioned CG for a fixed number of iterations.

    With ``substrate=None`` a reference substrate wraps ``matvec``/
    ``psolve``/``dot``.  With ``guard=True`` each step checks the dots it
    already reduced (NaN/Inf, ``pAp < 0`` with ``rz > 0`` or ``rz' < 0`` =>
    breakdown; residual blow-up => diverged) and freezes the solve at its
    last good iterate; a clean run equals ``guard=False``."""
    sub = substrate if substrate is not None else reference_substrate(
        matvec, psolve, dot)
    dt = resolve_dtype(b.dtype)[0].type
    x, r, z, rz, p, beta = _start(sub, b, x0)
    r0 = torch.sqrt(sub.dot(r, r))

    if not guard:
        norms = [r0]
        for _ in range(iters):
            x, r, z, p, rz, beta, _, rr = _step(sub, x, r, z, p, rz, beta)
            norms.append(torch.sqrt(rr))
        return SolveResult(x, torch.stack(norms).cpu().numpy(), _i32(iters),
                           _i32(STATUS_UNGUARDED), _i32(-1))

    r0_h, rz_h = _fetch(r0, rz)
    fault = STATUS_BREAKDOWN if _nonfinite(r0_h, rz_h) else 0
    bad = 0 if fault else -1
    trace = np.empty(iters + 1, dt)
    trace[0] = r0_h
    rn_prev = r0_h
    with np.errstate(all="ignore"):
        for i in range(iters):
            if fault:                       # frozen for the rest of the run
                trace[i + 1:] = rn_prev
                break
            new = _step(sub, x, r, z, p, rz, beta)
            denom_h, rr_h, rzn_h = _fetch(new[6], new[7], new[4])
            rn = np.sqrt(rr_h)
            breakdown = _breakdown(rn, denom_h, rz_h, rzn_h, rn_prev, r0_h, dt)
            diverged = bool(rn > dt(DIVERGENCE_FACTOR) * r0_h)
            if breakdown or diverged:
                fault, bad = _fault_code(breakdown, diverged), i + 1
            else:
                x, r, z, p, rz, beta = new[:6]
                rz_h, rn_prev = rzn_h, rn
            trace[i + 1] = rn_prev
    status = fault if fault else STATUS_MAXITER
    return SolveResult(x, trace, _i32(iters), _i32(status), _i32(bad))


def pcg_tol(
    matvec: Callable,
    b: Vec,
    psolve: Callable,
    x0: Vec | None = None,
    tol: float = 1e-8,
    max_iters: int = 1000,
    dot: Callable = _default_dot,
    substrate: SolverSubstrate | None = None,
    guard: bool = True,
) -> SolveResult:
    """PCG stopped at ``||r|| / ||b|| <= tol`` or ``max_iters``.

    Same folded recurrence as :func:`pcg`; the stopping test reuses the
    ``rr`` the update already produced.  The residual trace is a
    ``(max_iters + 1,)`` ring: slot i holds the residual norm after
    iteration i, and slots past the stop hold the final residual.

    Guards (``guard=True``): breakdown/divergence as in :func:`pcg`, plus
    stagnation -- no new best residual for ``STALL_WINDOW`` iterations.  A
    faulted solve stops and keeps its last good iterate."""
    sub = substrate if substrate is not None else reference_substrate(
        matvec, psolve, dot)
    dt = resolve_dtype(b.dtype)[0].type
    x, r, z, rz, p, beta = _start(sub, b, x0)
    bnorm = torch.sqrt(sub.dot(b, b))
    r0n = torch.sqrt(sub.dot(r, r))
    rz_h, bnorm_h, r0n_h = _fetch(rz, bnorm, r0n)
    if bnorm_h == 0:
        bnorm_h = dt(1.0)
    tol_h = dt(tol)
    trace = np.zeros(max_iters + 1, dt)
    trace[0] = r0n_h
    it = k = 0

    with np.errstate(all="ignore"):
        act = bool(r0n_h / bnorm_h > tol_h)
        if not guard:
            while act and k < max_iters:
                it += 1
                x, r, z, p, rz, beta, _, rr = _step(sub, x, r, z, p, rz, beta)
                rn = np.sqrt(_fetch(rr)[0])
                trace[k + 1] = rn
                act = bool(rn / bnorm_h > tol_h)
                k += 1
            trace[k + 1:] = trace[k]
            return SolveResult(x, trace, _i32(it), _i32(STATUS_UNGUARDED),
                               _i32(-1))

        init_bad = _nonfinite(r0n_h, rz_h, bnorm_h)
        fault = STATUS_BREAKDOWN if init_bad else 0
        bad = 0 if init_bad else -1
        act = act and not fault
        best, since, rn_prev = r0n_h, 0, r0n_h
        while act and k < max_iters:
            it += 1
            new = _step(sub, x, r, z, p, rz, beta)
            denom_h, rr_h, rzn_h = _fetch(new[6], new[7], new[4])
            rn = np.sqrt(rr_h)
            breakdown = _breakdown(rn, denom_h, rz_h, rzn_h, rn_prev, r0n_h, dt)
            diverged = bool(rn > dt(DIVERGENCE_FACTOR) * r0n_h)
            improved = bool(rn < best)
            best = np.minimum(rn, best)
            since = 0 if improved else since + 1
            stalled = since >= STALL_WINDOW
            if breakdown or diverged or stalled:
                fault, bad = _fault_code(breakdown, diverged, stalled), k + 1
            good = fault == 0
            if good:
                x, r, z, p, rz, beta = new[:6]
                rz_h, rn_prev = rzn_h, rn
            trace[k + 1] = rn_prev
            act = good and bool(rn / bnorm_h > tol_h)
            k += 1
        trace[k + 1:] = trace[k]
    if fault:
        status = fault
    else:
        status = STATUS_MAXITER if act else STATUS_CONVERGED
    return SolveResult(x, trace, _i32(it), _i32(status), _i32(bad))
