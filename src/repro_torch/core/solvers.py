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

Each ``lax.scan``/``lax.while_loop`` is a :func:`loop.while_loop` with the
JAX body ported one for one: the vectors, the recurrence scalars, the
guards (breakdown, divergence, the stall counter), the stop test, ``it``,
``k``, ``fault``, ``bad``, ``best``, ``since`` and the residual trace ring
are tensors on the vectors' device, one entry per lane, with the JAX
package's arithmetic (its float32 casts included), so the iteration
counts, ``status``, ``bad_iter`` and the trace equal the JAX package's.
Called on their own they run eagerly and the host reads one flag a round
of ``loop.CHUNK`` steps; inside a plan on the card the whole loop is one
CUDA graph that the card runs to its end.  The results reach the host
once, at the end.
The fixed-iteration methods loop on ``k < iters``.

A faulted lane keeps its last good x, as ``solvers._sel`` does on the
TPU, without a select over the carried vectors every step: on the step it
faults (and at the start, for a lane faulted before the loop) its x is put
back to the pre-step value and its recurrence (r, z, p and the scalars)
set to 0, which every later step maps to itself -- alpha = beta = 0, x'
= x + 0 * 0.  That fix-up runs under ``loop.when``: in a captured loop,
only on a step where a lane faults.  What the result reads -- x, the
trace (the last good residual), ``it``, ``status``, ``bad_iter`` -- is
the JAX package's; the frozen lane's other vectors are 0 instead of their
pre-fault values.

Results: ``x`` is a tensor on the vectors' device; ``res_norms``
((T,) or (T, k)), ``iters``, ``status`` and ``bad_iter`` (() or (k,)) are
host numpy values.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..device import resolve_dtype
from .loop import when, while_loop
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


# -- per-lane helpers (tensors of shape () or (k,)) ---------------------------


def _sq(d: Vec) -> Vec:
    """A dot result squeezed to the per-lane shape () / (k,)."""
    return d[..., 0] if d.dim() else d


def _norm(d: Vec) -> Vec:
    return torch.sqrt(_sq(d))


def _lanes(b: Vec, v) -> Vec:
    """One int32 value per lane of ``b``, on its device."""
    return torch.full(tuple(b.shape[:-1]), v, dtype=torch.int32,
                      device=b.device)


def _lane_mask(m: Vec, t: Vec) -> Vec:
    """A per-lane mask shaped to broadcast against ``t``."""
    return m.reshape(m.shape + (1,) * (t.dim() - m.dim()))


# A loop step's scalar logic is many tiny ops, each one kernel (one node
# of a captured loop) on the card: the helpers below spend as few as the
# JAX package's arithmetic allows (no Python scalar inside torch.where,
# which costs a fill kernel; the guard thresholds computed once a solve).


def _safe_div(num: Vec, den: Vec) -> Vec:
    """num / den with a zero denominator replaced by 1 (converged or zero
    RHS: the step freezes instead of emitting NaN).  ``den + (den == 0)``
    is ``den`` bit for bit wherever it is not 0."""
    return num / (den + (den == 0))


def _nonfinite(*vals: Vec) -> Vec:
    """Per lane: any of ``vals`` NaN or infinite (v - v is 0 exactly for
    a finite v, NaN otherwise)."""
    t = torch.stack(vals)
    return (t - t != 0).any(0)


def _thresholds(r0: Vec) -> tuple:
    """(sign floor, divergence) thresholds of the guards against ||r0||:
    a lane's sign tests apply while its residual is above the first, and
    it diverged past the second."""
    dt = resolve_dtype(r0.dtype)[0].type
    return (r0 * float(dt(SIGN_GUARD_FLOOR) * np.finfo(dt).eps),
            r0 * DIVERGENCE_FACTOR)


def _faults(fault: Vec, breakdown: Vec, diverged: Vec, stalled=None):
    """(fault', newly): the lanes without a fault so far that trip a guard
    take its status code, priority breakdown > diverged > stagnated."""
    f0 = fault == 0
    nb, nd = f0 & breakdown, f0 & diverged
    newly = nb | nd
    if stalled is not None:
        ns = f0 & stalled
        newly = newly | ns
        fault = fault.masked_fill(ns, STATUS_STAGNATED)
        fault.masked_fill_(nd, STATUS_DIVERGED)
    else:
        fault = fault.masked_fill(nd, STATUS_DIVERGED)
    return fault.masked_fill_(nb, STATUS_BREAKDOWN), newly


def _start_faults(init_bad: Vec) -> tuple:
    """(fault, bad) of lanes faulted before the loop (breakdown at 0)."""
    fault = torch.zeros(init_bad.shape, dtype=torch.int32,
                        device=init_bad.device)
    bad = torch.full(init_bad.shape, -1, dtype=torch.int32,
                     device=init_bad.device)
    return (fault.masked_fill_(init_bad, STATUS_BREAKDOWN),
            bad.masked_fill_(init_bad, 0))


def _status(fault: Vec, clean: int, act=None) -> Vec:
    """STATUS_* per lane: the fault, else ``clean`` (or maxiter where a
    lane is still active)."""
    st = torch.full(fault.shape, clean, dtype=torch.int32, device=fault.device)
    if act is not None:
        st.masked_fill_(act, STATUS_MAXITER)
    return torch.where(fault != 0, fault, st)


def _freeze(newly: Vec, x_new: Vec, x_old: Vec, zero: tuple) -> None:
    """In place, on the lanes ``newly`` marks: x back to its pre-step
    value and every tensor in ``zero`` (the recurrence) set to 0 -- a
    fixed point of the step (module docstring).  Runs only on a step
    where a lane faults when the loop is captured."""

    def fix():
        torch.where(_lane_mask(newly, x_new), x_old, x_new, out=x_new)
        for t in zero:
            t.masked_fill_(_lane_mask(newly, t), 0)

    when(newly.any(), fix)


def _trace(b: Vec, n_steps: int, r0: Vec) -> Vec:
    """The residual ring: slot i after step i, one column per lane, and a
    last slot that a step past the budget may write."""
    t = torch.zeros((n_steps + 2, max(1, int(np.prod(b.shape[:-1])))),
                    dtype=b.dtype, device=b.device)
    t[0] = r0.reshape(-1)
    return t


def _record(trace: Vec, k1: Vec, rn: Vec) -> None:
    """trace[k1] = rn, in place (k1 = the step's k + 1).  A gated step may
    write past the last step taken; :func:`_finish` fills that tail."""
    trace.index_copy_(0, k1.long().reshape(1), rn.reshape(1, -1))


def _finish(b: Vec, x: Vec, trace: Vec, k: Vec, it: Vec, status: Vec,
            bad: Vec) -> SolveResult:
    """Copy the results to the host: the trace up to slot k, its tail
    filled with slot k, and the per-lane counts shaped for ``b``."""
    lanes = tuple(b.shape[:-1])
    ints = torch.cat([it.reshape(-1), status.reshape(-1), bad.reshape(-1),
                      k.reshape(1)]).cpu().numpy()
    n = ints.shape[0] // 3
    kk = int(ints[-1])
    tr = trace[:-1].cpu().numpy()
    tr[kk + 1:] = tr[kk]
    return SolveResult(x, tr.reshape(tr.shape[:1] + lanes),
                       ints[:n].reshape(lanes), ints[n: 2 * n].reshape(lanes),
                       ints[2 * n: 3 * n].reshape(lanes))


# -- CG / PCG -----------------------------------------------------------------


def _step(sub: SolverSubstrate, x, r, z, p, rz, beta):
    """One folded PCG step -> (x', r', z', p', rz', beta', pAp, rr)."""
    p2, ap, denom = sub.fold_matvec_dot(z, p, beta)
    alpha = _safe_div(rz, denom)
    x2, r2, z2, rr, rz2 = sub.update(alpha, x, r, p2, ap)
    beta2 = _safe_div(rz2, rz)
    return x2, r2, z2, p2, rz2, beta2, denom, rr


def _breakdown(rn, denom, rz_prev, rz_new, rn_prev, floor) -> Vec:
    """Per lane: NaN/Inf in a reduced slot, or (above the sign floor)
    pAp < 0 with rz > 0, or rz' < 0: an indefinite A or M."""
    dq, rzq, rz2q = _sq(denom), _sq(rz_prev), _sq(rz_new)
    sign_bad = ((dq < 0) & (rzq > 0)) | (rz2q < 0)
    return _nonfinite(rn, dq, rz2q) | ((rn_prev > floor) & sign_bad)


def _start(sub, b, x0):
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - sub.matvec(x)
    z = sub.psolve(r)
    rz = sub.dot(r, z)
    return x, r, z, rz, torch.zeros_like(b), torch.zeros_like(rz)


def _freeze_start(init_bad: Vec, r, z, rz) -> None:
    """Lanes faulted before the loop: the zero fixed point from x0."""
    for t in (r, z, rz):
        t.masked_fill_(_lane_mask(init_bad, t), 0)


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
    x, r, z, rz, p, beta = _start(sub, b, x0)
    r0 = _norm(sub.dot(r, r))
    trace = _trace(b, iters, r0)
    k0 = torch.zeros((), dtype=torch.int32, device=b.device)

    def cond(s):
        return s[6] < iters

    if not guard:
        def body(s):
            x, r, z, p, rz, beta, k, trace = s
            x, r, z, p, rz, beta, _, rr = _step(sub, x, r, z, p, rz, beta)
            k1 = k + 1
            _record(trace, k1, _norm(rr))
            return x, r, z, p, rz, beta, k1, trace

        x, *_, k, trace = while_loop(cond, body,
                                     (x, r, z, p, rz, beta, k0, trace))
        return _finish(b, x, trace, k, _lanes(b, iters),
                       _lanes(b, STATUS_UNGUARDED), _lanes(b, -1))

    init_bad = _nonfinite(r0, _sq(rz))
    _freeze_start(init_bad, r, z, rz)
    fault, bad = _start_faults(init_bad)

    def body(s):
        x, r, z, p, rz, beta, k, trace, rn_prev, fault, bad, floor, big = s
        x2, r2, z2, p2, rz2, beta2, denom, rr = _step(sub, x, r, z, p, rz,
                                                      beta)
        rn = _norm(rr)
        fault, newly = _faults(fault,
                               _breakdown(rn, denom, rz, rz2, rn_prev, floor),
                               rn > big)
        k1 = k + 1
        bad = torch.where(newly, k1, bad)
        rn_out = torch.where(fault == 0, rn, rn_prev)
        _record(trace, k1, rn_out)
        _freeze(newly, x2, x, (r2, z2, p2, rz2, beta2))
        return (x2, r2, z2, p2, rz2, beta2, k1, trace, rn_out, fault, bad,
                floor, big)

    x, *_, k, trace, _, fault, bad, _, _ = while_loop(
        cond, body, (x, r, z, p, rz, beta, k0, trace, r0, fault, bad,
                     *_thresholds(r0)))
    return _finish(b, x, trace, k, _lanes(b, iters),
                   _status(fault, STATUS_MAXITER), bad)


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
    x, r, z, rz, p, beta = _start(sub, b, x0)
    bnorm = _norm(sub.dot(b, b))
    bnorm = bnorm + (bnorm == 0)
    r0n = _norm(sub.dot(r, r))
    trace = _trace(b, max_iters, r0n)
    act = r0n / bnorm > tol
    it = _lanes(b, 0)
    k0 = torch.zeros((), dtype=torch.int32, device=b.device)

    def cond(s):
        return s[6].any() & (s[8] < max_iters)

    if not guard:
        def body(s):
            x, r, z, p, rz, beta, act, it, k, trace, bnorm = s
            it = it + act
            x, r, z, p, rz, beta, _, rr = _step(sub, x, r, z, p, rz, beta)
            rn = _norm(rr)
            k1 = k + 1
            _record(trace, k1, rn)
            return (x, r, z, p, rz, beta, rn / bnorm > tol, it, k1, trace,
                    bnorm)

        x, *_, it, k, trace, _ = while_loop(
            cond, body, (x, r, z, p, rz, beta, act, it, k0, trace, bnorm))
        return _finish(b, x, trace, k, it, _lanes(b, STATUS_UNGUARDED),
                       _lanes(b, -1))

    init_bad = _nonfinite(r0n, _sq(rz), bnorm)
    _freeze_start(init_bad, r, z, rz)
    fault, bad = _start_faults(init_bad)
    act = act & ~init_bad

    def body(s):
        (x, r, z, p, rz, beta, act, it, k, trace, rn_prev, fault, bad, best,
         since, bnorm, floor, big) = s
        it = it + act
        x2, r2, z2, p2, rz2, beta2, denom, rr = _step(sub, x, r, z, p, rz,
                                                      beta)
        rn = _norm(rr)
        improved = rn < best
        best = torch.minimum(rn, best)
        since = (since + 1).masked_fill_(improved, 0)
        fault, newly = _faults(fault,
                               _breakdown(rn, denom, rz, rz2, rn_prev, floor),
                               rn > big, act & (since >= STALL_WINDOW))
        k1 = k + 1
        bad = torch.where(newly, k1, bad)
        good = fault == 0
        rn_out = torch.where(good, rn, rn_prev)
        _record(trace, k1, rn_out)
        act = good & (rn / bnorm > tol)
        _freeze(newly, x2, x, (r2, z2, p2, rz2, beta2))
        return (x2, r2, z2, p2, rz2, beta2, act, it, k1, trace, rn_out,
                fault, bad, best, since, bnorm, floor, big)

    (x, _, _, _, _, _, act, it, k, trace, _, fault, bad, *_) = while_loop(
        cond, body, (x, r, z, p, rz, beta, act, it, k0, trace, r0n, fault,
                     bad, r0n, torch.zeros_like(it), bnorm,
                     *_thresholds(r0n)))
    return _finish(b, x, trace, k, it, _status(fault, STATUS_CONVERGED, act),
                   bad)


# -- pipelined PCG (Chronopoulos-Gear) ---------------------------------------
#
# The loop state is the 13 recurrence entries (x, r, u, w, z, q, s, p, m,
# gamma, delta, gamma_old, alpha_old), then the in-flight halo of the next
# matvec operand when the substrate splits its matvec (``matvec_start`` /
# ``matvec_finish``, a tuple of tile-stacked tensors, empty otherwise),
# then the method's own entries.


def _pipe_dots(sub, dot2, explicit: bool):
    """The stacked [gamma, delta, rr] reduction: an explicit substrate's
    ``pipe_dots``, else the injected ``dot2`` (one stacked reduction even
    on the reference path), else the reference substrate's."""
    if explicit or dot2 is None:
        return sub.pipe_dots

    def pdots(r, u, w):
        return dot2(r, u, w, u, r, r)

    return pdots


def _pipe_start(sub, b, x0, pdots=None):
    """The pre-loop state (the 13 recurrence entries, then the halo of
    the first operand where the substrate splits its matvec) and its
    stacked reduction [gamma, delta, rr] (``pdots``, default the
    substrate's)."""
    pdots = pdots or sub.pipe_dots
    overlapped = sub.matvec_start is not None
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - sub.matvec(x)
    u = sub.psolve(r)
    w = sub.matvec(u)
    gd = pdots(r, u, w)
    m = sub.psolve(w)              # the first step's matvec operand
    h = tuple(sub.matvec_start(m)) if overlapped else ()
    zv = torch.zeros_like(b)
    one = torch.ones_like(gd[0])
    return (x, r, u, w, zv, zv, zv, zv, m, gd[0], gd[1], one, one) + h, gd


def _pipe_step(sub, k, state, pdots=None):
    """One pipelined step -> (state', [gamma', delta', rr']).  The scalar
    recurrence: beta = gamma/gamma_old (0 on the first step, k == 0),
    alpha = gamma / (delta - beta*gamma/alpha_old); a zero denominator
    gives the step a 0 instead of a NaN.  With the split matvec the step
    finishes the halo issued by the previous one and issues the next."""
    pdots = pdots or sub.pipe_dots
    overlapped = sub.matvec_start is not None
    x, r, u, w, z, q, s, p, m, gamma, delta, gamma_old, alpha_old = state[:13]
    nv = sub.matvec_finish(state[13:]) if overlapped else sub.matvec(m)
    beta = _safe_div(gamma, gamma_old).masked_fill_(k == 0, 0.0)
    alpha = _safe_div(gamma, delta - _safe_div(beta * gamma, alpha_old))
    x, r, u, w, z, q, s, p = sub.pipe_update(beta, alpha, x, r, u, w, z, q,
                                             s, p, m, nv)
    gd = pdots(r, u, w)            # the iteration's ONE stacked reduction
    m = sub.psolve(w)
    h = tuple(sub.matvec_start(m)) if overlapped else ()
    return (x, r, u, w, z, q, s, p, m, gd[0], gd[1], gamma, alpha) + h, gd


def _pipe_norm(gd: Vec) -> Vec:
    return torch.sqrt(torch.clamp_min(_sq(gd[2]), 0.0))


def _pipe_guard(gd, rn, rn_prev, floor, big):
    """Per lane, from the one stacked reduction: NaN/Inf, or (above the
    sign floor) gamma = (r, M^-1 r) < 0 (M indefinite) or delta < 0 with
    gamma > 0 (A indefinite) => breakdown; residual blow-up => diverged."""
    gq, dq = _sq(gd[0]), _sq(gd[1])
    sign_bad = (gq < 0) | ((dq < 0) & (gq > 0))
    breakdown = _nonfinite(rn, gq, dq) | ((rn_prev > floor) & sign_bad)
    return breakdown, rn > big


def _pipe_freeze(newly, new, old) -> None:
    """:func:`_freeze` over the pipelined state: x back, the vectors,
    gamma, delta, alpha_old and the halo to 0 (gamma_old is the pre-step
    gamma, a tensor of the old state: it stays)."""
    _freeze(newly, new[0], old[0], new[1:11] + new[12:])


def pcg_pipelined(
    matvec: Callable,
    b: Vec,
    psolve: Callable,
    x0: Vec | None = None,
    iters: int = 100,
    dot2: Callable | None = None,
    dot: Callable = _default_dot,
    substrate: SolverSubstrate | None = None,
    guard: bool = True,
) -> SolveResult:
    """Chronopoulos-Gear pipelined PCG, fixed iteration count: ONE stacked
    reduction [gamma, delta, rr] an iteration, where PCG has three dots.
    rr makes the trace the TRUE residual norm, comparable with
    :func:`pcg`'s.  ``dot2(a1, b1, a2, b2, ...)`` stacks dot(ai, bi) pairs
    under one reduction (the distributed engine injects its psum of a
    stack); a ``substrate`` brings its own ``pipe_dots`` and, on a halo
    layout, the split matvec whose exchange for the next operand is
    issued at the tail of each step -- the same values either way.
    Guards (``guard=True``) read the same reduction: NaN/Inf, gamma < 0,
    delta < 0 with gamma > 0, divergence; a faulted lane freezes at its
    last good iterate."""
    sub = substrate if substrate is not None else reference_substrate(
        matvec, psolve, dot)
    pdots = _pipe_dots(sub, dot2, substrate is not None)
    state, gd = _pipe_start(sub, b, x0, pdots)
    nc = len(state)
    r0 = _pipe_norm(gd)
    trace = _trace(b, iters, r0)
    k0 = torch.zeros((), dtype=torch.int32, device=b.device)

    def cond(s):
        return s[nc] < iters

    if not guard:
        def body(s):
            k, trace = s[nc:]
            new, gd = _pipe_step(sub, k, s[:nc], pdots)
            k1 = k + 1
            _record(trace, k1, _pipe_norm(gd))
            return new + (k1, trace)

        out = while_loop(cond, body, state + (k0, trace))
        return _finish(b, out[0], out[nc + 1], out[nc], _lanes(b, iters),
                       _lanes(b, STATUS_UNGUARDED), _lanes(b, -1))

    init_bad = _nonfinite(r0, _sq(gd[0]), _sq(gd[1]))
    _freeze(init_bad, state[0], state[0], state[1:11] + state[13:])
    fault, bad = _start_faults(init_bad)

    def body(s):
        old, (k, trace, rn_prev, fault, bad, floor, big) = s[:nc], s[nc:]
        new, gd = _pipe_step(sub, k, old, pdots)
        rn = _pipe_norm(gd)
        fault, newly = _faults(fault, *_pipe_guard(gd, rn, rn_prev, floor,
                                                   big))
        k1 = k + 1
        bad = torch.where(newly, k1, bad)
        rn_out = torch.where(fault == 0, rn, rn_prev)
        _record(trace, k1, rn_out)
        _pipe_freeze(newly, new, old)
        return new + (k1, trace, rn_out, fault, bad, floor, big)

    out = while_loop(cond, body, state + (k0, trace, r0, fault, bad,
                                          *_thresholds(r0)))
    return _finish(b, out[0], out[nc + 1], out[nc], _lanes(b, iters),
                   _status(out[nc + 3], STATUS_MAXITER), out[nc + 4])


def pcg_pipelined_tol(
    matvec: Callable,
    b: Vec,
    psolve: Callable,
    x0: Vec | None = None,
    tol: float = 1e-8,
    max_iters: int = 1000,
    dot2: Callable | None = None,
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
    pdots = _pipe_dots(sub, dot2, substrate is not None)
    state, gd = _pipe_start(sub, b, x0, pdots)
    nc = len(state)
    r0n = _pipe_norm(gd)
    bnorm = torch.sqrt(torch.clamp_min(_sq(sub.dot(b, b)), 0.0))
    bnorm = bnorm + (bnorm == 0)
    trace = _trace(b, max_iters, r0n)
    act = r0n / bnorm > tol
    it = _lanes(b, 0)
    k0 = torch.zeros((), dtype=torch.int32, device=b.device)

    def cond(s):
        return s[nc].any() & (s[nc + 2] < max_iters)

    if not guard:
        def body(s):
            old, (act, it, k, trace, bnorm) = s[:nc], s[nc:]
            it = it + act
            new, gd = _pipe_step(sub, k, old, pdots)
            rn = _pipe_norm(gd)
            k1 = k + 1
            _record(trace, k1, rn)
            return new + (rn / bnorm > tol, it, k1, trace, bnorm)

        out = while_loop(cond, body, state + (act, it, k0, trace, bnorm))
        return _finish(b, out[0], out[nc + 3], out[nc + 2], out[nc + 1],
                       _lanes(b, STATUS_UNGUARDED), _lanes(b, -1))

    init_bad = _nonfinite(r0n, _sq(gd[0]), _sq(gd[1]), bnorm)
    _freeze(init_bad, state[0], state[0], state[1:11] + state[13:])
    fault, bad = _start_faults(init_bad)
    act = act & ~init_bad

    def body(s):
        old = s[:nc]
        (act, it, k, trace, rn_prev, fault, bad, best, since, bnorm, floor,
         big) = s[nc:]
        it = it + act
        new, gd = _pipe_step(sub, k, old, pdots)
        rn = _pipe_norm(gd)
        improved = rn < best
        best = torch.minimum(rn, best)
        since = (since + 1).masked_fill_(improved, 0)
        fault, newly = _faults(fault, *_pipe_guard(gd, rn, rn_prev, floor, big),
                               act & (since >= STALL_WINDOW))
        k1 = k + 1
        bad = torch.where(newly, k1, bad)
        good = fault == 0
        rn_out = torch.where(good, rn, rn_prev)
        _record(trace, k1, rn_out)
        act = good & (rn / bnorm > tol)
        _pipe_freeze(newly, new, old)
        return new + (act, it, k1, trace, rn_out, fault, bad, best, since,
                      bnorm, floor, big)

    out = while_loop(cond, body, state + (act, it, k0, trace, r0n, fault, bad,
                                          r0n, torch.zeros_like(it), bnorm,
                                          *_thresholds(r0n)))
    act, it, k, trace, fault, bad = (out[nc], out[nc + 1], out[nc + 2],
                                     out[nc + 3], out[nc + 5], out[nc + 6])
    return _finish(b, out[0], trace, k, it,
                   _status(fault, STATUS_CONVERGED, act), bad)


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
    trace = _trace(b, iters, _norm(dot(r0, r0)))
    k0 = torch.zeros((), dtype=torch.int32, device=b.device)

    def body(s):
        x, k, trace, b = s
        r = b - matvec(x)
        k1 = k + 1
        _record(trace, k1, _norm(dot(r, r)))
        return x + diag_inv * r, k1, trace, b

    x, k, trace, _ = while_loop(lambda s: s[1] < iters, body,
                                (x, k0, trace, b))
    return _finish(b, x, trace, k, _lanes(b, iters),
                   _lanes(b, STATUS_UNGUARDED), _lanes(b, -1))
