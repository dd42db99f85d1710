"""Preconditioners for PCG (host side).

Port of ``repro.core.precond`` for the first slice: the Jacobi inverse
diagonal.  IC(0) and its level-scheduled triangular solves wait for the
block-IC(0) slice.
"""

from __future__ import annotations

import numpy as np

from .formats import CSR

__all__ = ["jacobi_inv_diag"]


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
