"""Iterative solvers: CG, PCG, pipelined PCG and Jacobi, with fixed-
iteration and tolerance stopping.

Port of ``repro.core.solvers`` (``cg``, ``pcg``, ``pcg_tol``,
``pcg_pipelined``, ``pcg_pipelined_tol`` and ``jacobi``, guarded and
unguarded) for one (n,) right-hand side or a stacked (k, n) batch.  The
PCG recurrence is the JAX package's folded, substrate-phrased one: ``p =
z + beta*p`` runs at the top of each step inside ``fold_matvec_dot``, and
``update`` returns x, r, z and both dots from one pass.  The pipelined
recurrence (Chronopoulos-Gear) runs ``pipe_update`` and ONE stacked
reduction ``pipe_dots`` = [gamma, delta, rr] a step.  Batched vector
updates broadcast over the leading axis; ``dot`` reduces the last axis to
(k, 1), so the per-RHS alpha and beta broadcast back.

``lax.scan``/``lax.while_loop`` become Python loops.  The vectors and the
recurrence scalars (alpha, beta, rz and the dots) stay tensors on the
vectors' device -- the kernels read alpha and beta through pointers.  Each
iteration makes ONE device-to-host copy, of the dots the step already
reduced (``[pAp, rr, rz]``, or the pipelined ``[gamma, delta, rr]``, one
slot per lane); the stopping test, the guards and the residual trace then
run on the host in numpy arrays of the vectors' dtype, one entry per
lane, with the JAX package's per-lane arithmetic (its float32 casts
included), so the iteration counts, ``status``, ``bad_iter`` and the
trace ring equal the JAX package's.  The unguarded fixed-iteration
methods and ``jacobi`` keep their trace on the device and copy it once.

A faulted lane keeps its pre-step state, as ``solvers._sel`` does on the
TPU.  ``_sel`` is a full select over the carried vectors every
iteration; here nothing is selected while no lane has faulted (a select
on an all-true mask returns the new values bit for bit), and afterwards
only the faulted lanes' rows are copied back.

Results: ``x`` is a tensor on the vectors' device; ``res_norms``
((T,) or (T, k)), ``iters``, ``status`` and ``bad_iter`` (() or (k,)) are
host numpy values.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..device import resolve_dtype
from .substrate import SolverSubstrate, reference_substrate
from .substrate import _dot as _default_dot   # () for (n,), (k, 1) for (k, n)

__all__ = ["SolveResult", "cg", "pcg", "pcg_tol", "pcg_pipelined",
           "pcg_pipelined_tol", "jacobi", "status_name", "ensure_status",
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
STATUS_UNGUARDED = -1    # method ran without guards (jacobi, guard=False)

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
    x: Vec                      # (n,) or (k, n) tensor on the vectors' device
    res_norms: np.ndarray       # (T,) or (T, k) trace, T = iters + 1
    iters: np.ndarray           # int32 () or (k,) -- iterations applied
    status: np.ndarray | None = None   # int32 () or (k,) STATUS_*
    bad_iter: np.ndarray | None = None  # int32 () or (k,) first faulted step


def _per_rhs(b: Vec, v) -> np.ndarray:
    """int32 per-RHS values: shape () for (n,) b, (k,) for (k, n) b; ``v``
    is one value for every RHS or one per lane."""
    lanes = tuple(b.shape[:-1])
    v = np.asarray(v, np.int32)
    return np.broadcast_to(v.reshape(lanes) if v.ndim else v, lanes).copy()


def ensure_status(res: SolveResult, b: Vec) -> SolveResult:
    """Fill a missing status/bad_iter with UNGUARDED / -1."""
    if res.status is not None and res.bad_iter is not None:
        return res
    status = (res.status if res.status is not None
              else _per_rhs(b, STATUS_UNGUARDED))
    bad = res.bad_iter if res.bad_iter is not None else _per_rhs(b, -1)
    return SolveResult(res.x, res.res_norms, res.iters, status, bad)


def _fetch(*dots: Vec) -> np.ndarray:
    """One device-to-host copy of several dot results: (len(dots), lanes)
    with one lane for an (n,) solve."""
    return torch.stack([d.reshape(-1) for d in dots]).cpu().numpy()


def _safe_div(num: Vec, den: Vec) -> Vec:
    """num / den with a zero denominator replaced by 1 (converged or zero
    RHS: the step freezes instead of emitting NaN)."""
    return num / torch.where(den == 0, 1.0, den)


def _nonfinite(*vals) -> np.ndarray:
    bad = ~np.isfinite(vals[0])
    for v in vals[1:]:
        bad = bad | ~np.isfinite(v)
    return bad


def _sign_live(rn_prev, r0, dt) -> np.ndarray:
    """Lanes whose pre-step residual is above the sign-guard floor."""
    return rn_prev > (dt(SIGN_GUARD_FLOOR) * np.finfo(dt).eps) * r0


def _fault_code(breakdown, diverged, stalled=False) -> np.ndarray:
    """Priority breakdown > diverged > stagnated; 0 where no fault."""
    code = np.where(stalled, STATUS_STAGNATED, 0)
    code = np.where(diverged, STATUS_DIVERGED, code)
    return np.where(breakdown, STATUS_BREAKDOWN, code).astype(np.int32)


def _step(sub: SolverSubstrate, x, r, z, p, rz, beta):
    """One folded PCG step -> (x', r', z', p', rz', beta', pAp, rr)."""
    p2, ap, denom = sub.fold_matvec_dot(z, p, beta)
    alpha = _safe_div(rz, denom)
    x2, r2, z2, rr, rz2 = sub.update(alpha, x, r, p2, ap)
    beta2 = _safe_div(rz2, rz)
    return x2, r2, z2, p2, rz2, beta2, denom, rr


def _breakdown(rn, denom, rz_prev, rz_new, rn_prev, r0, dt) -> np.ndarray:
    """Per lane: NaN/Inf in a reduced slot, or (above the sign floor)
    pAp < 0 with rz > 0, or rz' < 0: an indefinite A or M."""
    sign_bad = ((denom < 0) & (rz_prev > 0)) | (rz_new < 0)
    return (_nonfinite(rn, denom, rz_new)
            | (_sign_live(rn_prev, r0, dt) & sign_bad))


def _freeze(good: np.ndarray, new: tuple, old: tuple) -> tuple:
    """The step's state with every faulted lane (``~good``) put back to its
    pre-step values: ``new`` untouched while all lanes are good, else the
    faulted rows copied from ``old`` in place (``new`` holds fresh tensors
    the step made; for an (n,) solve, ``old`` itself)."""
    if good.all():
        return new
    if new[0].dim() == 1:
        return old
    rows = torch.from_numpy(np.flatnonzero(~good)).to(new[0].device)
    for n_, o in zip(new, old):
        n_[rows] = o[rows]
    return new


def _start(sub, b, x0):
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - sub.matvec(x)
    z = sub.psolve(r)
    rz = sub.dot(r, z)
    return x, r, z, rz, torch.zeros_like(b), torch.zeros_like(rz)


def _result(b, x, trace, iters, status, bad) -> SolveResult:
    """Per-RHS host arrays shaped for ``b``: (T,) and () for an (n,) b."""
    lanes = tuple(b.shape[:-1])
    return SolveResult(x, trace.reshape(trace.shape[:1] + lanes),
                       _per_rhs(b, iters), _per_rhs(b, status),
                       _per_rhs(b, bad))


def cg(
    matvec: Callable,
    b: Vec,
    x0: Vec | None = None,
    iters: int = 100,
    dot: Callable = _default_dot,
    substrate: SolverSubstrate | None = None,
    guard: bool = True,
) -> SolveResult:
    """Conjugate gradients, fixed iteration count: :func:`pcg` with the
    identity preconditioner."""
    return pcg(matvec, b, psolve=lambda r: r, x0=x0, iters=iters, dot=dot,
               substrate=substrate, guard=guard)


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
    breakdown; residual blow-up => diverged) and freezes a faulted lane at
    its last good iterate while the others go on; a clean run equals
    ``guard=False``."""
    sub = substrate if substrate is not None else reference_substrate(
        matvec, psolve, dot)
    dt = resolve_dtype(b.dtype)[0].type
    x, r, z, rz, p, beta = _start(sub, b, x0)

    if not guard:
        # rr stays on the device; its square root is taken on the host,
        # as the guarded loop takes it, so that both give the same bits
        rrs = [sub.dot(r, r).reshape(-1)]
        for _ in range(iters):
            x, r, z, p, rz, beta, _, rr = _step(sub, x, r, z, p, rz, beta)
            rrs.append(rr.reshape(-1))
        return _result(b, x, np.sqrt(torch.stack(rrs).cpu().numpy()), iters,
                       STATUS_UNGUARDED, -1)

    rr0_h, rz_h = _fetch(sub.dot(r, r), rz)
    r0_h = np.sqrt(rr0_h)
    fault = np.where(_nonfinite(r0_h, rz_h), STATUS_BREAKDOWN, 0)
    bad = np.where(fault != 0, 0, -1)
    trace = np.empty((iters + 1,) + r0_h.shape, dt)
    trace[0] = r0_h
    rn_prev = r0_h
    state = (x, r, z, p, rz, beta)
    with np.errstate(all="ignore"):
        for i in range(iters):
            if fault.all():                 # every lane frozen for good
                trace[i + 1:] = rn_prev
                break
            new = _step(sub, *state)
            denom_h, rr_h, rzn_h = _fetch(new[6], new[7], new[4])
            rn = np.sqrt(rr_h)
            breakdown = _breakdown(rn, denom_h, rz_h, rzn_h, rn_prev, r0_h, dt)
            diverged = rn > dt(DIVERGENCE_FACTOR) * r0_h
            newly = (fault == 0) & (breakdown | diverged)
            fault = np.where(newly, _fault_code(breakdown, diverged), fault)
            bad = np.where(newly, i + 1, bad)
            good = fault == 0
            state = _freeze(good, new[:6], state)
            rz_h = np.where(good, rzn_h, rz_h)
            rn_prev = np.where(good, rn, rn_prev)
            trace[i + 1] = rn_prev
    status = np.where(fault != 0, fault, STATUS_MAXITER)
    return _result(b, state[0], trace, iters, status, bad)


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
    ``(max_iters + 1,)`` ring (``(max_iters + 1, k)`` batched): slot i
    holds the residual norm after iteration i, and slots past the stop hold
    the final residual.

    Batched: the loop runs while any lane is active and under
    ``max_iters``; lanes that have converged keep stepping, and ``iters``
    counts, per lane, the steps it was active.

    Guards (``guard=True``): breakdown/divergence as in :func:`pcg`, plus
    stagnation -- an active lane with no new best residual for
    ``STALL_WINDOW`` iterations.  A faulted lane deactivates and keeps its
    last good iterate."""
    sub = substrate if substrate is not None else reference_substrate(
        matvec, psolve, dot)
    dt = resolve_dtype(b.dtype)[0].type
    x, r, z, rz, p, beta = _start(sub, b, x0)
    bnorm = torch.sqrt(sub.dot(b, b))
    r0n = torch.sqrt(sub.dot(r, r))
    rz_h, bnorm_h, r0n_h = _fetch(rz, bnorm, r0n)
    bnorm_h = np.where(bnorm_h == 0, dt(1.0), bnorm_h)
    tol_h = dt(tol)
    trace = np.zeros((max_iters + 1,) + r0n_h.shape, dt)
    trace[0] = r0n_h
    it = np.zeros(r0n_h.shape, np.int32)
    k = 0
    state = (x, r, z, p, rz, beta)

    with np.errstate(all="ignore"):
        act = r0n_h / bnorm_h > tol_h
        if not guard:
            while act.any() and k < max_iters:
                it += act
                *state, _, rr = _step(sub, *state)
                rn = np.sqrt(_fetch(rr)[0])
                trace[k + 1] = rn
                act = rn / bnorm_h > tol_h
                k += 1
            trace[k + 1:] = trace[k]
            return _result(b, state[0], trace, it, STATUS_UNGUARDED, -1)

        init_bad = _nonfinite(r0n_h, rz_h, bnorm_h)
        fault = np.where(init_bad, STATUS_BREAKDOWN, 0)
        bad = np.where(init_bad, 0, -1)
        act = act & (fault == 0)
        best, since, rn_prev = r0n_h, np.zeros_like(it), r0n_h
        while act.any() and k < max_iters:
            it += act
            new = _step(sub, *state)
            denom_h, rr_h, rzn_h = _fetch(new[6], new[7], new[4])
            rn = np.sqrt(rr_h)
            breakdown = _breakdown(rn, denom_h, rz_h, rzn_h, rn_prev, r0n_h, dt)
            diverged = rn > dt(DIVERGENCE_FACTOR) * r0n_h
            improved = rn < best
            best = np.minimum(rn, best)
            since = np.where(improved, 0, since + 1)
            stalled = act & (since >= STALL_WINDOW)
            newly = (fault == 0) & (breakdown | diverged | stalled)
            fault = np.where(newly, _fault_code(breakdown, diverged, stalled),
                             fault)
            bad = np.where(newly, k + 1, bad)
            good = fault == 0
            state = _freeze(good, new[:6], state)
            rz_h = np.where(good, rzn_h, rz_h)
            rn_prev = np.where(good, rn, rn_prev)
            trace[k + 1] = rn_prev
            act = good & (rn / bnorm_h > tol_h)
            k += 1
        trace[k + 1:] = trace[k]
    status = np.where(fault != 0, fault,
                      np.where(act, STATUS_MAXITER, STATUS_CONVERGED))
    return _result(b, state[0], trace, it, status, bad)


# -- pipelined PCG (Chronopoulos-Gear) ---------------------------------------


def _pipe_start(sub, b, x0):
    """The pre-loop state (x, r, u, w, z, q, s, p, m, gamma, delta,
    gamma_old, alpha_old) and its stacked reduction [gamma, delta, rr]."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - sub.matvec(x)
    u = sub.psolve(r)
    w = sub.matvec(u)
    gd = sub.pipe_dots(r, u, w)
    m = sub.psolve(w)              # the first step's matvec operand
    zv = torch.zeros_like(b)
    one = torch.ones_like(gd[0])
    return (x, r, u, w, zv, zv, zv, zv, m, gd[0], gd[1], one, one), gd


def _pipe_step(sub, first: bool, state):
    """One pipelined step -> (state', [gamma', delta', rr']).  The scalar
    recurrence: beta = gamma/gamma_old (0 on the first step), alpha =
    gamma / (delta - beta*gamma/alpha_old); a zero denominator gives the
    step a 0 instead of a NaN."""
    x, r, u, w, z, q, s, p, m, gamma, delta, gamma_old, alpha_old = state
    nv = sub.matvec(m)
    beta = (torch.zeros_like(gamma) if first
            else _safe_div(gamma, gamma_old))
    alpha = _safe_div(gamma, delta - _safe_div(beta * gamma, alpha_old))
    x, r, u, w, z, q, s, p = sub.pipe_update(beta, alpha, x, r, u, w, z, q,
                                             s, p, m, nv)
    gd = sub.pipe_dots(r, u, w)    # the iteration's ONE stacked reduction
    m = sub.psolve(w)
    return (x, r, u, w, z, q, s, p, m, gd[0], gd[1], gamma, alpha), gd


def _pipe_guard(gd_h, rn, rn_prev, r0, dt):
    """Per lane, from the one stacked reduction: NaN/Inf, or (above the
    sign floor) gamma = (r, M^-1 r) < 0 (M indefinite) or delta < 0 with
    gamma > 0 (A indefinite) => breakdown; residual blow-up => diverged."""
    gq, dq = gd_h[0], gd_h[1]
    sign_bad = (gq < 0) | ((dq < 0) & (gq > 0))
    breakdown = (_nonfinite(rn, gq, dq)
                 | (_sign_live(rn_prev, r0, dt) & sign_bad))
    return breakdown, rn > dt(DIVERGENCE_FACTOR) * r0


def _pipe_freeze(good: np.ndarray, new: tuple, old: tuple) -> tuple:
    """:func:`_freeze` over the pipelined state.  The new gamma_old is the
    old gamma tensor itself, which the row copy would overwrite while the
    old state still holds it: copy it first."""
    if not good.all():
        new = new[:11] + (new[11].clone(),) + new[12:]
    return _freeze(good, new, old)


def pcg_pipelined(
    matvec: Callable,
    b: Vec,
    psolve: Callable,
    x0: Vec | None = None,
    iters: int = 100,
    dot: Callable = _default_dot,
    substrate: SolverSubstrate | None = None,
    guard: bool = True,
) -> SolveResult:
    """Chronopoulos-Gear pipelined PCG, fixed iteration count: ONE stacked
    reduction [gamma, delta, rr] an iteration, where PCG has three dots.
    rr makes the trace the TRUE residual norm, comparable with
    :func:`pcg`'s.  Guards (``guard=True``) read the same reduction:
    NaN/Inf, gamma < 0, delta < 0 with gamma > 0, divergence; a faulted
    lane freezes at its last good iterate."""
    sub = substrate if substrate is not None else reference_substrate(
        matvec, psolve, dot)
    dt = resolve_dtype(b.dtype)[0].type
    state, gd = _pipe_start(sub, b, x0)

    if not guard:
        # as pcg's lean loop: rr on the device, its root on the host
        rrs = [gd[2].reshape(-1)]
        for i in range(iters):
            state, gd = _pipe_step(sub, i == 0, state)
            rrs.append(gd[2].reshape(-1))
        rr = torch.stack(rrs).cpu().numpy()
        return _result(b, state[0], np.sqrt(np.maximum(rr, dt(0))), iters,
                       STATUS_UNGUARDED, -1)

    gd_h = gd.reshape(3, -1).cpu().numpy()
    with np.errstate(all="ignore"):
        r0 = np.sqrt(np.maximum(gd_h[2], dt(0)))
        fault = np.where(_nonfinite(r0, gd_h[0], gd_h[1]), STATUS_BREAKDOWN, 0)
        bad = np.where(fault != 0, 0, -1)
        trace = np.empty((iters + 1,) + r0.shape, dt)
        trace[0] = rn_prev = r0
        for i in range(iters):
            if fault.all():                 # every lane frozen for good
                trace[i + 1:] = rn_prev
                break
            new, gd = _pipe_step(sub, i == 0, state)
            gd_h = gd.reshape(3, -1).cpu().numpy()
            rn = np.sqrt(np.maximum(gd_h[2], dt(0)))
            breakdown, diverged = _pipe_guard(gd_h, rn, rn_prev, r0, dt)
            newly = (fault == 0) & (breakdown | diverged)
            fault = np.where(newly, _fault_code(breakdown, diverged), fault)
            bad = np.where(newly, i + 1, bad)
            good = fault == 0
            state = _pipe_freeze(good, new, state)
            rn_prev = np.where(good, rn, rn_prev)
            trace[i + 1] = rn_prev
    status = np.where(fault != 0, fault, STATUS_MAXITER)
    return _result(b, state[0], trace, iters, status, bad)


def pcg_pipelined_tol(
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
    """Pipelined PCG stopped at ``||r|| / ||b|| <= tol`` or ``max_iters``.

    Same recurrence as :func:`pcg_pipelined`; the stopping test reads the
    rr slot of the step's one stacked reduction (the true ``|r|``, the
    quantity :func:`pcg_tol` tests).  The residual ring, the batched
    semantics, the tail fill and the guards (stagnation included) are
    :func:`pcg_tol`'s."""
    sub = substrate if substrate is not None else reference_substrate(
        matvec, psolve, dot)
    dt = resolve_dtype(b.dtype)[0].type
    state, gd = _pipe_start(sub, b, x0)
    # one host copy: the stacked reduction and ||b||^2
    head = torch.cat([gd.reshape(3, -1), sub.dot(b, b).reshape(1, -1)])
    gd_h = head.cpu().numpy()
    tol_h = dt(tol)
    k = 0
    with np.errstate(all="ignore"):
        r0n = np.sqrt(np.maximum(gd_h[2], dt(0)))
        bnorm = np.sqrt(np.maximum(gd_h[3], dt(0)))
        bnorm = np.where(bnorm == 0, dt(1.0), bnorm)
        trace = np.zeros((max_iters + 1,) + r0n.shape, dt)
        trace[0] = r0n
        it = np.zeros(r0n.shape, np.int32)
        act = r0n / bnorm > tol_h
        if not guard:
            while act.any() and k < max_iters:
                it += act
                state, gd = _pipe_step(sub, k == 0, state)
                rn = np.sqrt(np.maximum(gd.reshape(3, -1)[2].cpu().numpy(),
                                        dt(0)))
                trace[k + 1] = rn
                act = rn / bnorm > tol_h
                k += 1
            trace[k + 1:] = trace[k]
            return _result(b, state[0], trace, it, STATUS_UNGUARDED, -1)

        init_bad = _nonfinite(r0n, gd_h[0], gd_h[1], bnorm)
        fault = np.where(init_bad, STATUS_BREAKDOWN, 0)
        bad = np.where(init_bad, 0, -1)
        act = act & (fault == 0)
        best, since, rn_prev = r0n, np.zeros_like(it), r0n
        while act.any() and k < max_iters:
            it += act
            new, gd = _pipe_step(sub, k == 0, state)
            gd_h = gd.reshape(3, -1).cpu().numpy()
            rn = np.sqrt(np.maximum(gd_h[2], dt(0)))
            breakdown, diverged = _pipe_guard(gd_h, rn, rn_prev, r0n, dt)
            improved = rn < best
            best = np.minimum(rn, best)
            since = np.where(improved, 0, since + 1)
            stalled = act & (since >= STALL_WINDOW)
            newly = (fault == 0) & (breakdown | diverged | stalled)
            fault = np.where(newly, _fault_code(breakdown, diverged, stalled),
                             fault)
            bad = np.where(newly, k + 1, bad)
            good = fault == 0
            state = _pipe_freeze(good, new, state)
            rn_prev = np.where(good, rn, rn_prev)
            trace[k + 1] = rn_prev
            act = good & (rn / bnorm > tol_h)
            k += 1
        trace[k + 1:] = trace[k]
    status = np.where(fault != 0, fault,
                      np.where(act, STATUS_MAXITER, STATUS_CONVERGED))
    return _result(b, state[0], trace, it, status, bad)


def jacobi(
    matvec: Callable,
    diag_inv: Vec,
    b: Vec,
    x0: Vec | None = None,
    iters: int = 100,
    dot: Callable = _default_dot,
) -> SolveResult:
    """Weighted Jacobi iteration: x += D^-1 (b - A x).  With a (k, n) b
    the (n,) ``diag_inv`` broadcasts over the batch.  Trace slot i + 1 is
    the residual norm of the iterate step i started from, as in the JAX
    package.  Unguarded (no reduction slots to inspect): status is
    UNGUARDED."""
    x = torch.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x)
    norms = [torch.sqrt(dot(r0, r0)).reshape(-1)]
    for _ in range(iters):
        r = b - matvec(x)
        x = x + diag_inv * r
        norms.append(torch.sqrt(dot(r, r)).reshape(-1))
    return _result(b, x, torch.stack(norms).cpu().numpy(), iters,
                   STATUS_UNGUARDED, -1)
