"""Solver substrates: the fused-kernel and reference implementations of the
PCG iteration's hot ops.

Port of ``repro.core.substrate`` for local (single-device) solves of one
(n,) right-hand side or a (k, n) batch.  A substrate bundles what one PCG
iteration consumes:

  ``matvec(v)``                 -- y = A v
  ``psolve(r)``                 -- z = M^-1 r
  ``dot(u, v)``                 -- dot product: () for (n,), (k, 1) for
                                   (k, n), so per-RHS scalars broadcast
                                   back against the vectors
  ``fold_matvec_dot(z, p, b)``  -- (p', A p', dot(p', A p')) with the
                                   p-update p' = z + b*p folded into the
                                   matrix stream
  ``update(alpha, x, r, p, ap)``-- (x', r', z, rr, rz), the one-pass CG
                                   vector update
  ``pipe_dots(r, u, w)``        -- stacked [gamma=(r,u), delta=(w,u),
                                   rr=(r,r)]: the pipelined iteration's
                                   ONE reduction
  ``pipe_update(beta, alpha, x, r, u, w, z, q, s, p, m, n)``
                                -- the Chronopoulos-Gear 8-vector update

* :func:`reference_substrate` composes the caller's matvec/psolve/dot with
  plain PyTorch ops, one per solver line -- the verification oracle.
* :func:`fused_local_substrate` runs the hand-written kernels through
  ``kernels.ops``: on a CUDA device every call launches a kernel (the 1-D
  ones for (n,) vectors, the batched ones for (k, n), which take the
  solver layout as it is), on the CPU the kernels' plain versions run the
  same arithmetic.
* :func:`fused_ic0_local_substrate` is the same for block-IC(0): the
  preconditioner is two ``sptrsv_solve_dot`` calls, the second with rz
  in-stream.
* :func:`format_stream_ops` gives the (matvec, fold_matvec_dot) pair of a
  non-ELL storage format (SELL, HYB, BCSR, a matrix-free stencil); both
  fused substrates take it as ``stream_ops`` in place of the ELL pair.
  The engine hands the same matvec closure to the reference substrate, so
  within a format the two differ only where the fused update's kernel
  sums its dots in another order than PyTorch (on the CPU, nowhere: they
  are bitwise equal).

* :func:`fused_shard_substrate` and :func:`fused_shard_ic0_substrate` are
  the tile grid's (the JAX package's ``shard_map`` flavors, run once over
  every tile of the grid): the matvec is the engine's NoC-composed SpMV,
  the update is ``cg_update`` on the whole tile-stacked vector, whose
  [rr, rz] come out of the kernel as one reduction (the JAX program's one
  stacked psum), and every other dot is the engine's reducing dot (tile
  partials added in tile order).  The p-fold stays a plain composition
  around the NoC matvec, as in the JAX package.

Every substrate carries the pipelined recurrence's ``pipe_dots`` (a stack
of its own dot; the shard flavors' is one stacked reduction) and
``pipe_update`` (plain PyTorch, as the JAX package's jnp composition: it
has no Pallas kernel).  On a halo layout the engine adds the split
communication-hiding matvec (``matvec_start`` / ``matvec_finish``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..kernels import ops

__all__ = ["SolverSubstrate", "reference_substrate", "fused_local_substrate",
           "fused_ic0_local_substrate", "fused_shard_substrate",
           "fused_shard_ic0_substrate", "format_stream_ops", "pipe_update",
           "modeled_vector_traffic", "modeled_ic0_traffic"]


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Solver dot convention: () for (n,), (k, 1) for (k, n) batches."""
    if u.dim() == 1:
        return torch.sum(u * v)
    return torch.sum(u * v, dim=-1, keepdim=True)


class SolverSubstrate(NamedTuple):
    """The per-iteration op bundle PCG runs against (module docstring).
    ``matvec_start(v)`` issues the exchange of v's halo and returns it in
    flight (a tuple of tile-stacked tensors); ``matvec_finish(halo)``
    computes A v from it.  Both are None off a tile grid's halo layout."""

    kind: str
    matvec: Callable
    psolve: Callable
    dot: Callable
    fold_matvec_dot: Callable
    update: Callable
    pipe_dots: Callable
    pipe_update: Callable
    matvec_start: Callable | None = None
    matvec_finish: Callable | None = None


def pipe_update(beta, alpha, x, r, u, w, z, q, s, p, m, n):
    """The Chronopoulos-Gear one-pass 8-vector update.

    Inputs are the carried vectors plus the two per-step products
    m = M^-1 w and n = A m; returns the new (x, r, u, w, z, q, s, p).
    Reduction-free: every dot the recurrence needs is in ``pipe_dots``,
    so one iteration has exactly ONE stacked reduction."""
    z = n + beta * z
    q = m + beta * q
    s = w + beta * s
    p = u + beta * p
    x = x + alpha * p
    r = r - alpha * s
    u = u - alpha * q
    w = w - alpha * z
    return x, r, u, w, z, q, s, p


def _pipe_dots_local(dot):
    """Stacked [gamma, delta, rr] from the substrate's own dot."""

    def pipe_dots(r, u, w):
        return torch.stack([dot(r, u), dot(w, u), dot(r, r)])

    return pipe_dots


def reference_substrate(matvec, psolve, dot=None) -> SolverSubstrate:
    """Unfused composition -- the historical PCG op sequence, used as the
    verification oracle and for ``fused=False`` plans."""
    dot = dot or _dot

    def fold_matvec_dot(z, p, beta):
        p = z + beta * p
        ap = matvec(p)
        return p, ap, dot(p, ap)

    def update(alpha, x, r, p, ap):
        x = x + alpha * p
        r = r - alpha * ap
        z = psolve(r)
        rz = dot(r, z)
        rr = dot(r, r)
        return x, r, z, rr, rz

    return SolverSubstrate("reference", matvec, psolve, dot,
                           fold_matvec_dot, update, _pipe_dots_local(dot),
                           pipe_update)


def _ell_stream_ops(cols, vals):
    """The ELL operator's (matvec, fold_matvec_dot) pair through the device
    dispatch: ``ell_spmv``/``ell_spmv_pfold_dot`` for (n,) vectors,
    ``ell_spmm``/``ell_spmm_pfold_dot`` for (k, n) batches (beta goes in as
    (k,), pap comes back as the (k, 1) dot)."""

    def matvec(v):
        if v.dim() == 2:
            return ops.ell_spmm(cols, vals, v)
        return ops.ell_spmv(cols, vals, v)

    def fold_matvec_dot(z, p, beta):
        if z.dim() == 2:
            pn, y, pap = ops.ell_spmm_pfold_dot(cols, vals, z, p,
                                                beta.reshape(-1))
            return pn, y, pap.reshape(-1, 1)
        return ops.ell_spmv_pfold_dot(cols, vals, z, p, beta)

    return matvec, fold_matvec_dot


def _lane_dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The solver dot with each lane reduced on its own, as an (n,) solve
    reduces its vector.  One reduction over the last axis of a (k, n)
    block is laid out by the block's shape, so on the card its bits would
    depend on k; this way lane j's dot -- and so its whole solve, since
    the kernels' dots are lane-independent too -- is the same at any k."""
    if u.dim() == 1:
        return torch.sum(u * v)
    return torch.stack([torch.sum(a * b) for a, b in zip(u, v)]).reshape(-1, 1)


def _fold_from_matvec(matvec):
    """The p-fold around any matvec: p' = z + beta*p, one matrix pass, the
    in-stream denominator dot(p', A p') reduced lane by lane.  The fold
    of the non-ELL formats (a gather-time fold kernel for them is not
    written)."""

    def fold_matvec_dot(z, p, beta):
        pn = z + beta * p
        y = matvec(pn)
        return pn, y, _lane_dot(pn, y)

    return fold_matvec_dot


def _bcsr_matvec(m, n_pad: int):
    """The BCSR matvec on padded solver vectors through ``ops.bcsr_spmm``
    (the kernel on a CUDA device, its plain version on the CPU).

    The kernel reads x through its strides and reads rows past ``n_cols``
    as 0, so the JAX substrate's zero embedding of x into the (nbc*bn,)
    block rows becomes a view: ``v[:, None]`` for an (n_pad,) vector, the
    transposed view ``v.T`` of a (k, n_pad) batch, cut to nbc*bn rows.
    Where the engine builds the blocks (bm = bn = its row padding) nbc*bn
    and nbr*bm both equal n_pad, and the result is a view too; otherwise
    one small copy pads x or y."""
    nbc = (m.n_cols + m.bn - 1) // m.bn
    rows_x, rows_y = nbc * m.bn, m.block_cols.shape[0] * m.bm

    def matvec(v):
        xk = v.T if v.dim() == 2 else v[:, None]
        if rows_x <= n_pad:
            xk = xk[:rows_x]
        else:
            pad = xk.new_zeros(rows_x - n_pad, xk.shape[1])
            xk = torch.cat([xk, pad])
        y = ops.bcsr_spmm(m.block_cols, m.blocks, xk, nbc=nbc,
                          x_valid=m.n_cols)
        if rows_y >= n_pad:
            y = y[:n_pad]
        else:
            y = torch.cat([y, y.new_zeros(n_pad - rows_y, y.shape[1])])
        return y.T.contiguous() if v.dim() == 2 else y[:, 0]

    return matvec


def format_stream_ops(fmt_obj, fmt: str, n_pad: int):
    """The (matvec, fold_matvec_dot) pair of a non-ELL storage format.

    ``fmt_obj`` is the built container (``formats.SELL``/``HYB``/``BCSR``,
    or a matrix-free ``stencil.Stencil``); vectors are padded solver
    layout, (n_pad,) or (k, n_pad).  SELL, HYB and the stencil run their
    plain PyTorch matvecs (``spops``, ``stencil``); BCSR runs the
    ``bcsr_spmm`` kernel on a CUDA device.  The fold is
    :func:`_fold_from_matvec` around the format's own matvec.
    """
    from . import spops

    if fmt == "stencil":
        from .stencil import stencil_matvec

        def matvec(v):
            return stencil_matvec(fmt_obj, v, n_pad)

    elif fmt == "sell":

        def matvec(v):
            if v.dim() == 2:
                return spops.spmm_sell_flat(fmt_obj, v)
            return spops.spmv_sell_flat(fmt_obj, v)

    elif fmt == "hyb":

        def matvec(v):
            if v.dim() == 2:
                return spops.spmm_hyb_padded(fmt_obj, v)
            return spops.spmv_hyb_padded(fmt_obj, v)

    elif fmt == "bcsr":
        matvec = _bcsr_matvec(fmt_obj, n_pad)
    else:
        raise ValueError(f"unknown stream format {fmt!r}")
    return matvec, _fold_from_matvec(matvec)


def fused_local_substrate(cols, vals, dinv=None,
                          stream_ops=None) -> SolverSubstrate:
    """Fused kernels over a local operator.

    ``cols``/``vals``: (rows_p, w) square padded ELL; ``dinv``: (rows_p,)
    Jacobi inverse diagonal, or None for the identity preconditioner.
    Vectors are (rows_p,) or (k, rows_p).  ``stream_ops`` replaces the ELL
    matrix stream with a non-ELL format's pair
    (:func:`format_stream_ops`); ``cg_update`` does not depend on the
    format."""
    matvec, fold_matvec_dot = (stream_ops if stream_ops is not None
                               else _ell_stream_ops(cols, vals))

    def psolve(r):
        return r * dinv if dinv is not None else r

    def update(alpha, x, r, p, ap):
        return ops.cg_update(alpha, x, r, p, ap, dinv)

    return SolverSubstrate("fused", matvec, psolve, _lane_dot,
                           fold_matvec_dot, update,
                           _pipe_dots_local(_lane_dot), pipe_update)


def fused_ic0_local_substrate(cols, vals, apply_dot,
                              stream_ops=None) -> SolverSubstrate:
    """Fused kernels over a local padded-ELL operator, for
    ``precond="block_ic0"``.

    ``cols``/``vals``: the engine's (n_pad, w) padded ELL of A;
    ``apply_dot``: ``precond.make_fused_ic0_apply`` of its factors, (n_pad,)
    residual -> (z, rz) by two ``sptrsv_solve_dot`` calls.  ``update`` runs
    ``cg_update`` with the identity (its z and rz are discarded), then the
    application with rz = dot(r', z) in-stream.  A (k, n_pad) batch runs
    lane by lane through the 1-D application, where the JAX package
    vmaps: the factors are shared, each lane is its own solve, and lane
    j's bits do not depend on k.  rz comes back as (k, 1).
    ``stream_ops`` replaces the ELL matrix stream as in
    :func:`fused_local_substrate`.
    """
    matvec, fold_matvec_dot = (stream_ops if stream_ops is not None
                               else _ell_stream_ops(cols, vals))

    def psolve(r):
        if r.dim() == 2:
            return torch.stack([apply_dot(v)[0] for v in r])
        return apply_dot(r)[0]

    def update(alpha, x, r, p, ap):
        xo, ro, _, rr, _ = ops.cg_update(alpha, x, r, p, ap, None)
        if ro.dim() == 2:
            zs, rzs = zip(*(apply_dot(v) for v in ro))
            return xo, ro, torch.stack(zs), rr, torch.stack(rzs).reshape(-1, 1)
        z, rz = apply_dot(ro)
        return xo, ro, z, rr, rz

    return SolverSubstrate("fused_ic0", matvec, psolve, _lane_dot,
                           fold_matvec_dot, update,
                           _pipe_dots_local(_lane_dot), pipe_update)


def _shard_stream_ops(matvec, tdots):
    """The tile grid's (dot, fold_matvec_dot, pipe_dots).  ``tdots(a1, b1,
    a2, b2, ...)`` is the engine's stack of dots without its collective
    record: tile partials added in tile order.  Each of these stands for
    one psum of the JAX program and records it (``noc.record``); the fold
    is p' = z + beta*p around the NoC matvec, a plain composition (JAX
    ``substrate.py``)."""
    from . import noc

    def dot(u, v):
        noc.record("all-reduce")
        return tdots(u, v)[0]

    def fold_matvec_dot(z, p, beta):
        p = z + beta * p
        ap = matvec(p)
        return p, ap, dot(p, ap)

    def pipe_dots(r, u, w):
        noc.record("all-reduce")           # ONE stacked reduction
        return tdots(r, u, w, u, r, r)

    return dot, fold_matvec_dot, pipe_dots


def fused_shard_substrate(matvec, dinv, tdots, psum) -> SolverSubstrate:
    """The tile grid's fused substrate.  ``matvec`` is the engine's
    NoC-composed SpMV over the padded global vector (a rank's shard of
    it on a process grid), ``dinv`` the Jacobi inverse diagonal of the
    same part (or None), ``tdots`` the engine's stacked dots (tile
    partials in tile order, unrecorded), ``psum(*shares)`` the sums over
    every tile of this process's shares.  ``update`` is ``cg_update`` over
    every tile this process holds at once: its [rr, rz] are one reduction
    (``psum``: nothing left to add on one device, the ranks' shares added
    in rank order on a process grid), where the JAX program psums one
    stack of the tiles' partials."""
    from . import noc

    dot, fold_matvec_dot, pipe_dots = _shard_stream_ops(matvec, tdots)

    def psolve(r):
        return r * dinv if dinv is not None else r

    def update(alpha, x, r, p, ap):
        xo, ro, z, rr, rz = ops.cg_update(alpha, x, r, p, ap, dinv)
        noc.record("all-reduce")           # [rr, rz]: one reduction
        rr, rz = psum(rr, rz)
        return xo, ro, z, rr, rz

    return SolverSubstrate("fused_shard", matvec, psolve, dot,
                           fold_matvec_dot, update, pipe_dots, pipe_update)


def fused_shard_ic0_substrate(matvec, psolve_local, tdots,
                              psum) -> SolverSubstrate:
    """The tile grid's substrate for ``precond="block_ic0"``: the tiles'
    block-IC(0) solves (``psolve_local``, no collective: each tile factors
    its own diagonal block) after a ``cg_update`` with the identity, and
    [rr, rz] as one reduction, as in :func:`fused_shard_substrate` (on a
    process grid rr's rank sum and rz's dot are two collectives)."""
    from . import noc

    dot, fold_matvec_dot, pipe_dots = _shard_stream_ops(matvec, tdots)

    def update(alpha, x, r, p, ap):
        xo, ro, _, rr, _ = ops.cg_update(alpha, x, r, p, ap, None)
        z = psolve_local(ro)
        rz = tdots(ro, z)[0]
        noc.record("all-reduce")           # [rr, rz]: one reduction
        (rr,) = psum(rr)
        return xo, ro, z, rr, rz

    return SolverSubstrate("fused_shard_ic0", matvec, psolve_local, dot,
                           fold_matvec_dot, update, pipe_dots, pipe_update)


def modeled_vector_traffic(ell_width: float) -> dict:
    """Vector words moved per Jacobi-PCG iteration, per RHS, in units of n
    (the JAX package's model; the matrix stream is excluded).

    Unfused (one op per solver line, x gathered per nonzero):
      SpMV gather w + ap write 1; dot(p,ap) 2; x-axpy 3; r-axpy 3;
      z = dinv*r 3; dot(r,z) 2; dot(r,r) 1; p-update 3   -> 18 + w.
    Fused (x resident in the SpMV kernel, dots in-stream):
      spmv_dot 2 (p in, ap out); cg_update 8 (x,r,p,ap,dinv in; x,r,z
      out); p-update 3                                     -> 13.
    Fused + p-fold (p = z + beta*p at gather time): the fold pass streams
      z in, p in, p' out, ap out = 4; cg_update 8           -> 12.
    """
    unfused = 18.0 + float(ell_width)
    fused = 13.0
    fused_fold = 12.0
    return {
        "ell_width": float(ell_width),
        "unfused_words_per_n": unfused,
        "fused_words_per_n": fused,
        "fused_fold_words_per_n": fused_fold,
        "reduction": round(unfused / fused_fold, 3),
    }


def modeled_ic0_traffic(ell_width: float, n_levels_l: int,
                        n_levels_u: int) -> dict:
    """Vector words per IC(0)-PCG iteration, per RHS, in units of n (the
    JAX package's model).

    Reference (one op per wavefront): every level gathers the solution
    vector and scatters it back, 2n a level, plus b in, x out and the two
    ordering flips per solve, on top of the Jacobi model's non-psolve
    terms (18 + w - 3):

      unfused = (15 + w) + 2*(2 + 2) + 2 * (L_l + L_u)

    Fused (``sptrsv_solve_dot``): each solve reads b and writes x once,
    plus the dot weight of the second solve and the two flips, ~7 words
    whatever the level count; with the p-fold SpMV (12 - 3 words):

      fused = 9 + 7 = 16
    """
    levels = float(n_levels_l + n_levels_u)
    unfused = (15.0 + float(ell_width)) + 8.0 + 2.0 * levels
    fused = 16.0
    return {
        "ell_width": float(ell_width),
        "n_levels_l": int(n_levels_l),
        "n_levels_u": int(n_levels_u),
        "unfused_words_per_n": unfused,
        "fused_words_per_n": fused,
        "reduction": round(unfused / fused, 3),
    }
