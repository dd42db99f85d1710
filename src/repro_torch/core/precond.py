"""Preconditioners for PCG: Jacobi and IC(0).

Port of ``repro.core.precond``.  IC(0) (zero fill-in incomplete Cholesky)
is the paper's heavyweight preconditioner: applying it is two SpTRSVs per
iteration (L z' = r, then L^T z = z'), the irregular-parallelism workload
Azul's task model targets.  The factorization runs once, on the host, in
the same Python loops as the JAX package, so the factors are bitwise
equal to its own; application is torch on the factors' device, through
the level-scheduled solves.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from ..device import DEFAULT_DEVICE, resolve_device, resolve_dtype
from ..kernels import ops
from .formats import CSR, ELL, ell_from_csr
from .levels import LevelSchedule, build_schedule
from .spops import extract_diag_ell, sptrsv_ell

__all__ = ["jacobi_inv_diag", "csr_transpose", "IC0Factors", "ic0",
           "apply_ic0", "make_fused_ic0_apply"]


def jacobi_inv_diag(m: CSR) -> np.ndarray:
    """1 / diag(A) (host side), by one vectorised compare over the nnz."""
    n = m.shape[0]
    d = np.zeros(n, dtype=m.data.dtype if m.data.size else np.float64)
    rows = np.repeat(np.arange(n), np.diff(np.asarray(m.indptr)))
    sel = np.asarray(m.indices) == rows
    d[rows[sel]] = np.asarray(m.data)[sel]
    if np.any(d == 0):
        raise ValueError("zero diagonal; Jacobi preconditioner undefined")
    return 1.0 / d


def csr_transpose(m: CSR) -> CSR:
    """Host-side CSR transpose (for the L^T solve)."""
    s = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    t = s.T.tocsr()
    t.sort_indices()
    return CSR(t.indptr.astype(np.int32), t.indices.astype(np.int32), t.data,
               t.shape)


class IC0Factors(NamedTuple):
    """L (lower) and U = L^T stored as a lower solve on the reversed
    ordering: Lr = P U P with P the index reversal, which is lower
    triangular.  Application: z' = L^-1 r;  z = P Lr^-1 P z'.

    The ELL factors live on the device; each schedule's ``rows`` is an
    int32 device tensor made from the host schedule."""

    ell_l: ELL
    sched_l: LevelSchedule
    ell_u_rev: ELL
    sched_u_rev: LevelSchedule
    n: int


def _reverse_csr(m: CSR) -> CSR:
    """P A P with P = index reversal (host side, sparse-native)."""
    s = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    pidx = np.arange(m.shape[0])[::-1]
    r = s[pidx][:, pidx].tocsr()
    r.sort_indices()
    return CSR(r.indptr.astype(np.int32), r.indices.astype(np.int32), r.data,
               (m.shape[0], m.shape[1]))


def _on_device(sched: LevelSchedule, dev: torch.device) -> LevelSchedule:
    return sched._replace(rows=torch.from_numpy(sched.rows).to(dev))


def ic0(m: CSR, dtype=np.float32, width_pad: int = 8, row_pad: int = 8,
        device=DEFAULT_DEVICE) -> IC0Factors:
    """Zero fill-in incomplete Cholesky of an SPD CSR matrix (host side).

    IK-variant IC(0): L has A's lower-triangular sparsity pattern.  Raises
    if a pivot goes non-positive.  Per-row dicts plus a column->rows index,
    with the JAX package's update order entry by entry, so the factors'
    values are bitwise equal to its own in float64.
    """
    dev = resolve_device(device)
    n = m.shape[0]
    indptr, indices, data = m.indptr, m.indices, m.data
    rowd: list[dict] = [{} for _ in range(n)]     # lower-triangle rows
    for r in range(n):
        s, e = int(indptr[r]), int(indptr[r + 1])
        for c, v in zip(indices[s:e], data[s:e]):
            if c <= r and v != 0:
                rowd[r][int(c)] = float(v)
    col_rows: list[list] = [[] for _ in range(n)]  # rows below the diagonal
    for r in range(n):                             # ascending, so each
        for c in rowd[r]:                          # col_rows list is sorted
            if c < r:
                col_rows[c].append(r)

    for k in range(n):
        akk = rowd[k].get(k, 0.0)
        if akk <= 0:
            raise ValueError(f"IC(0) pivot failure at row {k}")
        akk = np.sqrt(akk)
        rowd[k][k] = akk
        rk = col_rows[k]
        for i in rk:
            rowd[i][k] /= akk
        for i in rk:
            ri = rowd[i]
            aik = ri[k]
            for j in rk:                          # j > k with (j, k) in L
                if j > i:
                    break                         # need k < j <= i
                if j in ri:
                    ri[j] -= aik * rowd[j][k]

    lptr = np.zeros(n + 1, np.int32)
    lcols: list[int] = []
    ldata: list[float] = []
    for r in range(n):
        # drop exact zeros (cancellation), as the JAX package does
        ents = sorted((c, v) for c, v in rowd[r].items() if v != 0)
        lcols.extend(c for c, _ in ents)
        ldata.extend(v for _, v in ents)
        lptr[r + 1] = len(lcols)
    lcsr = CSR(lptr, np.asarray(lcols, np.int32),
               np.asarray(ldata, np.float64), (n, n))
    ucsr_rev = _reverse_csr(csr_transpose(lcsr))
    ell_l = ell_from_csr(lcsr, width_pad=width_pad, row_pad=row_pad,
                         dtype=dtype, device=dev)
    ell_u = ell_from_csr(ucsr_rev, width_pad=width_pad, row_pad=row_pad,
                         dtype=dtype, device=dev)
    return IC0Factors(ell_l, _on_device(build_schedule(lcsr), dev), ell_u,
                      _on_device(build_schedule(ucsr_rev), dev), n)


def apply_ic0(f: IC0Factors, r: torch.Tensor) -> torch.Tensor:
    """z = (L L^T)^-1 r for an (n,) r, by two level-scheduled SpTRSVs (the
    reference substrate's op-per-wavefront composition)."""
    zp = sptrsv_ell(f.ell_l, f.sched_l, r)
    z_rev = sptrsv_ell(f.ell_u_rev, f.sched_u_rev, torch.flip(zp, (0,)))
    return torch.flip(z_rev, (0,))


def _inv_diag(e: ELL, dtype: torch.dtype) -> torch.Tensor:
    """(rows_p,) inverse diagonal of a factor, 1.0 in padded rows."""
    d = extract_diag_ell(e)
    d = torch.where(d == 0, 1.0, d)
    di = torch.ones(e.rows_padded, dtype=dtype, device=e.vals.device)
    di[: e.n_rows] = 1.0 / d
    return di


def make_fused_ic0_apply(f: IC0Factors, n: int, n_pad: int, dtype):
    """The fused IC(0) application for the solver substrates.

    Returns ``apply_dot(r_pad) -> (z_pad, rz)`` on the solver's (n_pad,)
    padded layout: both triangular solves run as single
    ``kernels.ops.sptrsv_solve_dot`` calls (one kernel launch each on the
    card), and the second (reversed-U) solve emits ``rz = dot(r, z)``
    in-stream: dot(r, z) == dot(flip(r), z_rev), so the dot weight is the
    flipped residual.  The per-level arithmetic is :func:`apply_ic0`'s,
    with a multiply by the inverse diagonal for its division.

    The inverse diagonals and both packs are built here, once, on the
    factors' device; ``apply_dot.resident`` lists those tensors.  The
    zero-pads and the three flips per call stay plain torch, as in the JAX
    package (``torch.flip`` copies: torch has no negative strides).
    """
    dt = resolve_dtype(dtype)[1]
    ell_l, ell_u = f.ell_l, f.ell_u_rev
    rp_l, rp_u = ell_l.rows_padded, ell_u.rows_padded
    sched_l, sched_u = f.sched_l.rows, f.sched_u_rev.rows
    dev = ell_l.vals.device
    dinv_l, dinv_u = _inv_diag(ell_l, dt), _inv_diag(ell_u, dt)
    pack_l = ops.sptrsv_solve_pack(ell_l.cols, sched_l, n)
    pack_u = ops.sptrsv_solve_pack(ell_u.cols, sched_u, n)

    def apply_dot(r_pad):
        b_l = torch.zeros(rp_l, dtype=dt, device=dev)
        b_l[:n] = r_pad[:n]
        zp, _ = ops.sptrsv_solve_dot(ell_l.cols, ell_l.vals, dinv_l, b_l,
                                     sched_l, None, n_rows=n, pack=pack_l)
        b_u = torch.zeros(rp_u, dtype=dt, device=dev)
        b_u[:n] = torch.flip(zp[:n], (0,))
        w_u = torch.zeros(rp_u, dtype=dt, device=dev)
        w_u[:n] = torch.flip(r_pad[:n], (0,))
        z_rev, rz = ops.sptrsv_solve_dot(ell_u.cols, ell_u.vals, dinv_u, b_u,
                                         sched_u, w_u, n_rows=n, pack=pack_u)
        z = torch.zeros(n_pad, dtype=dt, device=dev)
        z[:n] = torch.flip(z_rev[:n], (0,))
        return z, rz

    apply_dot.resident = (dinv_l, dinv_u, *(
        t for t in (*pack_l, *pack_u) if isinstance(t, torch.Tensor)))
    return apply_dot
