"""Device dispatch for the kernels on the ported paths.

A tensor on a CUDA device launches the hand-written kernel (or the wrapper
raises: there is no fallback on the card).  A tensor on the CPU takes the
kernel's plain PyTorch version.  That is the whole rule: no mode switch and
no environment variable, so on the card nothing can route around a kernel.

Each kernel wrapper counts its launches in a plain integer attribute
(``ell_spmv.ell_spmv.launches``, ...); :func:`launch_counts` reads them and
:func:`reset_launch_counts` sets them to 0.
"""

from __future__ import annotations

import torch

from . import ref
from . import bcsr_spmm as _bcsr_spmm
from . import ell_spmv as _ell_spmv
from . import spmv_dot as _spmv_dot
from . import sptrsv as _sptrsv
from . import vecops as _vecops

__all__ = ["ell_spmv", "ell_spmm", "ell_spmv_pfold_dot", "ell_spmm_pfold_dot",
           "cg_update", "sptrsv_solve_pack", "sptrsv_solve_dot", "bcsr_spmm",
           "KERNELS",
           "launch_counts", "reset_launch_counts"]

# name -> the wrapper that launches it; the 1-D and the batched (k, n)
# kernels are counted apart
KERNELS = {
    "ell_spmv": _ell_spmv.ell_spmv,
    "ell_spmv_pfold_dot": _spmv_dot.ell_spmv_pfold_dot,
    "cg_update": _vecops.cg_update,
    "ell_spmm": _ell_spmv.ell_spmm,
    "ell_spmm_pfold_dot": _spmv_dot.ell_spmm_pfold_dot,
    "cg_update_batched": _vecops.cg_update_batched,
    "sptrsv_solve_dot": _sptrsv.sptrsv_solve_dot,
    "bcsr_spmm": _bcsr_spmm.bcsr_spmm,
}


def ell_spmv(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor):
    """y = A @ x over padded ELL."""
    if x.is_cuda:
        return _ell_spmv.ell_spmv(cols, vals, x)
    return ref.ell_spmv_ref(cols, vals, x)


def ell_spmm(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor):
    """Y = A @ X over padded ELL for X (k, n) in the solver layout."""
    if x.is_cuda:
        return _ell_spmv.ell_spmm(cols, vals, x)
    return ref.ell_spmm_ref(cols, vals, x)


def ell_spmv_pfold_dot(cols, vals, z, p, beta):
    """(p', A @ p', dot(p', A @ p')) with p' = z + beta*p."""
    if z.is_cuda:
        return _spmv_dot.ell_spmv_pfold_dot(cols, vals, z, p, beta)
    return ref.ell_spmv_pfold_dot_ref(cols, vals, z, p, beta)


def ell_spmm_pfold_dot(cols, vals, z, p, beta):
    """Per lane of (k, n) z/p: (P', A @ P', pap (k,)) with P' = z + beta*p,
    beta (k,)."""
    if z.is_cuda:
        return _spmv_dot.ell_spmm_pfold_dot(cols, vals, z, p, beta)
    return ref.ell_spmm_pfold_dot_ref(cols, vals, z, p, beta)


def cg_update(alpha, x, r, p, ap, dinv=None):
    """One-pass CG update -> (x', r', z, rr, rz), for (n,) vectors or (k, n)
    batches (alpha (k, 1))."""
    if x.is_cuda:
        fn = _vecops.cg_update_batched if x.dim() == 2 else _vecops.cg_update
        return fn(alpha, x, r, p, ap, dinv)
    return ref.cg_update_ref(alpha, x, r, p, ap, dinv)


def sptrsv_solve_pack(cols: torch.Tensor, sched_rows,
                      n_rows: int) -> _sptrsv.SptrsvPack:
    """The call-invariant inputs of :func:`sptrsv_solve_dot` for one
    factor (``cols`` (rows_p, w) on its device): the schedule as compact
    level lists.  Build it once per factor; a solver loop passes it to
    every call."""
    return _sptrsv.solve_pack(sched_rows, n_rows, cols.shape[0], cols.device)


def sptrsv_solve_dot(cols, vals, dinv, b, sched_rows, wdot=None,
                     n_rows: int | None = None, pack=None):
    """Whole level-scheduled lower solve with dot(wdot, x) in-stream:
    (x (rows_p,), pp).  cols/vals: (rows_p, w) padded ELL; dinv:
    (rows_p,) inverse diagonal; b/wdot: (rows_p,); sched_rows:
    (n_levels, W) padded with a sentinel >= ``n_rows`` (default rows_p).
    ``pack``: :func:`sptrsv_solve_pack` of the same schedule (built here
    when None)."""
    rows_p = cols.shape[0]
    n_rows = rows_p if n_rows is None else n_rows
    if b.is_cuda:
        if pack is None:
            pack = sptrsv_solve_pack(cols, sched_rows, n_rows)
        return _sptrsv.sptrsv_solve_dot(cols, vals, dinv, b, pack, wdot)
    if wdot is None:
        wdot = torch.zeros(rows_p, dtype=vals.dtype)
    return ref.sptrsv_solve_dot_ref(cols, vals, dinv, b, sched_rows, wdot,
                                    n_rows)


def bcsr_spmm(block_cols, blocks, x, nbc: int | None = None,
              x_valid: int | None = None):
    """Block-sparse x dense multi-RHS: blocks (nbr, w, bm, bn), x
    (nbc*bn, R) -> (nbr*bm, R); ``nbc`` asserts x is exactly (nbc*bn, R).
    Rows of x at or past ``x_valid`` read as 0 (default: all rows)."""
    if x.is_cuda:
        return _bcsr_spmm.bcsr_spmm(block_cols, blocks, x, nbc=nbc,
                                    x_valid=x_valid)
    _bcsr_spmm.check_nbc(blocks, x, nbc)
    if x_valid is not None and x_valid < x.shape[0]:
        x = torch.cat([x[:x_valid], x.new_zeros(x.shape[0] - x_valid,
                                                x.shape[1])])
    return ref.bcsr_spmm_ref(block_cols, blocks, x)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
