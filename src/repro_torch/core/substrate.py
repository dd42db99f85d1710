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

The pipelined recurrence and the shard flavors wait for their slices.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..kernels import ops

__all__ = ["SolverSubstrate", "reference_substrate", "fused_local_substrate",
           "fused_ic0_local_substrate"]


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Solver dot convention: () for (n,), (k, 1) for (k, n) batches."""
    if u.dim() == 1:
        return torch.sum(u * v)
    return torch.sum(u * v, dim=-1, keepdim=True)


class SolverSubstrate(NamedTuple):
    """The per-iteration op bundle PCG runs against (module docstring)."""

    kind: str
    matvec: Callable
    psolve: Callable
    dot: Callable
    fold_matvec_dot: Callable
    update: Callable


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
                           fold_matvec_dot, update)


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


def fused_local_substrate(cols, vals, dinv=None) -> SolverSubstrate:
    """Fused kernels over a local padded-ELL operator.

    ``cols``/``vals``: (rows_p, w) square padded ELL; ``dinv``: (rows_p,)
    Jacobi inverse diagonal, or None for the identity preconditioner.
    Vectors are (rows_p,) or (k, rows_p)."""
    matvec, fold_matvec_dot = _ell_stream_ops(cols, vals)

    def psolve(r):
        return r * dinv if dinv is not None else r

    def update(alpha, x, r, p, ap):
        return ops.cg_update(alpha, x, r, p, ap, dinv)

    return SolverSubstrate("fused", matvec, psolve, _lane_dot,
                           fold_matvec_dot, update)


def fused_ic0_local_substrate(cols, vals, apply_dot) -> SolverSubstrate:
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
    """
    matvec, fold_matvec_dot = _ell_stream_ops(cols, vals)

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
                           fold_matvec_dot, update)
