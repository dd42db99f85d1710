"""Solver substrates: the fused-kernel and reference implementations of the
PCG iteration's hot ops.

Port of ``repro.core.substrate`` for local (single-device) 1-D solves.  A
substrate bundles what one PCG iteration consumes:

  ``matvec(v)``                 -- y = A v
  ``psolve(r)``                 -- z = M^-1 r
  ``dot(u, v)``                 -- dot product (a 0-d tensor)
  ``fold_matvec_dot(z, p, b)``  -- (p', A p', dot(p', A p')) with the
                                   p-update p' = z + b*p folded into the
                                   matrix stream
  ``update(alpha, x, r, p, ap)``-- (x', r', z, rr, rz), the one-pass CG
                                   vector update

* :func:`reference_substrate` composes the caller's matvec/psolve/dot with
  plain PyTorch ops, one per solver line -- the verification oracle.
* :func:`fused_local_substrate` runs the hand-written kernels through
  ``kernels.ops``: on a CUDA device every call launches a kernel, on the
  CPU the kernels' plain versions run the same arithmetic.

Batched (k, n) vectors, IC(0), the pipelined recurrence and the shard
flavors wait for their slices.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..kernels import ops

__all__ = ["SolverSubstrate", "reference_substrate", "fused_local_substrate"]


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Solver dot convention for (n,) vectors: a 0-d tensor."""
    return torch.sum(u * v)


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
    """The ELL operator's (matvec, fold_matvec_dot) pair: ``ell_spmv`` and
    ``ell_spmv_pfold_dot`` through the device dispatch (1-D vectors)."""

    def matvec(v):
        return ops.ell_spmv(cols, vals, v)

    def fold_matvec_dot(z, p, beta):
        return ops.ell_spmv_pfold_dot(cols, vals, z, p, beta)

    return matvec, fold_matvec_dot


def fused_local_substrate(cols, vals, dinv=None) -> SolverSubstrate:
    """Fused kernels over a local padded-ELL operator.

    ``cols``/``vals``: (rows_p, w) square padded ELL; ``dinv``: (rows_p,)
    Jacobi inverse diagonal, or None for the identity preconditioner.
    Vectors are (rows_p,)."""
    matvec, fold_matvec_dot = _ell_stream_ops(cols, vals)

    def psolve(r):
        return r * dinv if dinv is not None else r

    def update(alpha, x, r, p, ap):
        return ops.cg_update(alpha, x, r, p, ap, dinv)

    return SolverSubstrate("fused", matvec, psolve, _dot,
                           fold_matvec_dot, update)
