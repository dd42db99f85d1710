"""Plain PyTorch versions of the kernels on the ported paths.

Port of the matching oracles in ``repro.kernels.ref``.  Each function is
the mathematical contract its CUDA kernel implements: ``kernels.ops`` runs
it for tensors on the CPU, the CPU tests hold it against the JAX package,
and ``chip_smoke.py`` holds each kernel against it on the card.

The batched versions take the solver layout, (k, n) with one right-hand
side a row, as the kernels do; the JAX oracles take the Pallas kernels'
(n, k) layout, so the tests transpose on the JAX side.  The exception is
:func:`ell_spmm_dot_ref`, which keeps the JAX kernel's (rows_p, k) layout:
it is reached only through ``kernels.ops``, whose contract is the JAX
package's.
"""

from __future__ import annotations

import torch

__all__ = ["ell_spmv_ref", "ell_spmm_ref", "ell_spmv_dot_ref",
           "ell_spmm_dot_ref", "ell_spmv_pfold_dot_ref",
           "ell_spmm_pfold_dot_ref", "axpy_dot_ref", "cg_update_ref",
           "sptrsv_level_step_ref", "sptrsv_solve_dot_ref", "bcsr_spmm_ref"]


def ell_spmv_ref(cols: torch.Tensor, vals: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """y[r] = sum_k vals[r, k] * x[cols[r, k]].  Padding: vals == 0."""
    return torch.sum(vals * x[cols], dim=1)


def ell_spmm_ref(cols: torch.Tensor, vals: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Multi-RHS SpMM in the solver layout: x (k, n) -> Y (k, rows_p),
    Y[j, r] = sum_w vals[r, w] * x[j, cols[r, w]]."""
    return torch.sum(vals * x[:, cols], dim=-1)


def bcsr_spmm_ref(block_cols: torch.Tensor, blocks: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """Block-sparse (BCSR) times multi-RHS dense.

    block_cols: (nbr, w) int32
    blocks:     (nbr, w, bm, bn)
    x:          (nbc * bn, R)
    returns     (nbr * bm, R)

    x is made contiguous first, so the summation order is the same for
    every layout of x (the solver passes the transposed view of an (R, N)
    tensor).
    """
    nbr, w, bm, bn = blocks.shape
    xr = x.contiguous().reshape(-1, bn, x.shape[-1])          # (nbc, bn, R)
    xg = xr[block_cols]                          # (nbr, w, bn, R)
    y = torch.einsum("iwmn,iwnr->imr", blocks, xg)
    return y.reshape(nbr * bm, x.shape[-1])


def ell_spmv_dot_ref(cols: torch.Tensor, vals: torch.Tensor,
                     x: torch.Tensor):
    """SpMV + dot: (y, pap) = (A @ x, dot(x, y)) for a square padded
    operator, x (rows_p,)."""
    y = torch.sum(vals * x[cols], dim=1)
    return y, torch.sum(x * y)


def ell_spmm_dot_ref(cols: torch.Tensor, vals: torch.Tensor,
                     x: torch.Tensor):
    """Multi-RHS SpMM + dot in the JAX kernel's layout: x (rows_p, k) ->
    (Y (rows_p, k), pap (k,)), Y = A @ X and pap[j] = dot(X[:, j],
    Y[:, j])."""
    y = torch.sum(vals[..., None] * x[cols], dim=1)
    return y, torch.sum(x * y, dim=0)


def ell_spmv_pfold_dot_ref(cols, vals, z, p, beta):
    """p-fold contract: p' = z + beta*p, then (p', A @ p', dot(p', A @ p'))
    from the one matrix stream."""
    pn = z + beta * p
    y = torch.sum(vals * pn[cols], dim=1)
    return pn, y, torch.sum(pn * y)


def ell_spmm_pfold_dot_ref(cols, vals, z, p, beta):
    """Multi-RHS p-fold in the solver layout: z/p (k, rows_p), beta k
    per-lane values.  Returns (p', Y, pap) with p' = z + beta*p per lane,
    Y = A p' and pap[j] = dot(p'[j], Y[j]), pap of shape (k,)."""
    pn = z + torch.reshape(beta, (-1, 1)) * p
    y = torch.sum(vals * pn[:, cols], dim=-1)
    return pn, y, torch.sum(pn * y, dim=-1)


def axpy_dot_ref(a, x: torch.Tensor, y: torch.Tensor):
    """z = y + a*x and dot(z, z), one CG pipeline stage; ``a`` a number or
    a 0-d tensor."""
    z = y + a * x
    return z, torch.sum(z * z)


def _dot(u, v):
    """The solvers' dot convention: () for (n,), (k, 1) for (k, n)."""
    if u.dim() == 1:
        return torch.sum(u * v)
    return torch.sum(u * v, dim=-1, keepdim=True)


def cg_update_ref(alpha, x, r, p, ap, dinv=None):
    """One-pass CG update contract for (n,) vectors, or (k, n) batches with
    alpha (k, 1) and dinv (n,) shared by the lanes:

        x' = x + alpha p;  r' = r - alpha ap;  z = dinv r' (or r');
        rr = dot(r', r');  rz = dot(r', z)   (() or (k, 1)).
    """
    xo = x + alpha * p
    ro = r - alpha * ap
    rr = _dot(ro, ro)
    if dinv is None:
        return xo, ro, ro, rr, rr
    z = ro * dinv
    return xo, ro, z, rr, _dot(ro, z)


def sptrsv_level_step_ref(cols, vals, diag, b, x, level_rows):
    """One wavefront of the level-scheduled lower solve, the contract of the
    JAX op ``ops.sptrsv_level_step`` (its gather, kernel and scatter).

    cols/vals: (rows_p, w) padded ELL of L; diag: L's diagonal (at least
    n entries); b: (rows_p,); x: (n + 1,), slot n the sentinel slot;
    level_rows: (W,) row ids >= 0 padded with a sentinel.  For each id:

        lr = min(id, rows_p - 1)
        xr = (b[lr] - sum_s (c != lr ? v : 0) * x[min(c, n)])
             / diag[min(id, n - 1)]

    and x'[id] = xr for ids <= n (the sentinel slot n included); ids past
    n are dropped.  Returns the new x; the input is left untouched.
    """
    n = x.shape[0] - 1
    rows_p = cols.shape[0]
    ids = torch.as_tensor(level_rows, device=x.device).long()
    lr = torch.clamp(ids, max=rows_p - 1)
    c = cols[lr].long()
    off = torch.where(c != lr[:, None], vals[lr], 0.0)
    contrib = torch.sum(off * x[torch.clamp(c, max=n)], dim=1)
    xr = (b[lr] - contrib) / diag[torch.clamp(ids, max=n - 1)]
    keep = ids <= n
    out = x.clone()
    out[ids[keep]] = xr[keep]
    return out


def sptrsv_solve_dot_ref(cols, vals, dinv, b, sched_rows, wdot, n_rows: int):
    """Whole level-scheduled lower solve plus dot(wdot, x), the contract of
    the ``sptrsv_solve_dot`` kernel.

    cols/vals: (rows_p, w) padded ELL of L; dinv: (rows_p,) inverse
    diagonal (1.0 in padded rows); b/wdot: (rows_p,); sched_rows:
    (n_levels, W) row ids padded with a sentinel >= n_rows.  Level by
    level, for each real row r of the level:

        x[r] = (b[r] - sum_slots (c != r ? v : 0) * x[c]) * dinv[r]

    Padded rows of x are 0.  Returns (x (rows_p,), pp 0-d tensor).
    """
    rows_p = cols.shape[0]
    x = torch.zeros(rows_p + 1, dtype=vals.dtype, device=vals.device)
    for level_rows in torch.as_tensor(sched_rows, device=vals.device).long():
        lr = torch.clamp(level_rows, max=rows_p - 1)
        c = cols[lr].long()
        off = torch.where(c != lr[:, None], vals[lr], 0.0)
        contrib = torch.sum(off * x[c], dim=1)
        xr = (b[lr] - contrib) * dinv[lr]
        xr = torch.where(level_rows < n_rows, xr, 0.0)
        # sentinel slots -> the absorber slot rows_p (they add 0.0)
        x.index_add_(0, torch.clamp(level_rows, max=rows_p), xr)
    x = x[:rows_p]
    return x, torch.sum(wdot * x)
