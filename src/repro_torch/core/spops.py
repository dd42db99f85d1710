"""Single-device sparse ops on packed formats (plain PyTorch).

Port of ``repro.core.spops`` for the ported paths: the padded-ELL matvec
and its multi-RHS twin, which the reference substrate and
``AzulEngine.spmv`` run, and the level-scheduled triangular solve that the
reference substrate's block-IC(0) applies.  They are plain PyTorch on
whatever device their tensors lie on -- never a hand-written kernel.
"""

from __future__ import annotations

import torch

from .formats import ELL
from .levels import LevelSchedule

__all__ = ["spmv_ell_padded", "spmm_ell_padded", "extract_diag_ell",
           "sptrsv_ell"]


def spmv_ell_padded(cols: torch.Tensor, vals: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Padded-row SpMV: (rows_p, w) gather + row sum.  Padding vals are 0,
    and padding cols point at 0, which is always in bounds."""
    return torch.sum(vals * x[cols], dim=1)


def spmm_ell_padded(cols: torch.Tensor, vals: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Batched multi-RHS SpMV in the solvers' stacked layout: x is (k, n),
    returns (k, rows_p).  x[:, cols] is (k, rows_p, w), weighted by the
    shared (rows_p, w) vals."""
    return torch.sum(vals * x[:, cols], dim=-1)


def extract_diag_ell(m: ELL) -> torch.Tensor:
    """Diagonal of a square ELL matrix, (n_rows,), 0.0 where absent."""
    r = torch.arange(m.rows_padded, device=m.cols.device)[:, None]
    is_diag = (m.cols == r) & (m.vals != 0)
    return torch.sum(torch.where(is_diag, m.vals, 0.0), dim=1)[: m.n_rows]


def sptrsv_ell(m: ELL, sched: LevelSchedule, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b for lower-triangular L in ELL form, level by level:

        x[r] = (b[r] - sum_{c<r} L[r,c] x[c]) / L[r,r]

    for all rows of a level at once (a Python loop over the levels, where
    the JAX package scans).  Rows of a level never depend on each other, so
    the gather of x sees only values solved at earlier levels.  ``b`` is
    (n,); returns x (n,).
    """
    n = m.n_rows
    if sched.n != n:
        raise ValueError("schedule/matrix size mismatch")
    dev, dt = b.device, b.dtype
    diag = extract_diag_ell(m)
    diag = torch.where(diag == 0, 1.0, diag)  # padded rows / degenerate
    b_pad = torch.zeros(m.rows_padded, dtype=dt, device=dev)
    b_pad[:n] = b
    # x carries one extra slot (index n) that absorbs the padded slots
    x = torch.zeros(n + 1, dtype=dt, device=dev)
    cols, vals = m.cols, m.vals
    rows = torch.as_tensor(sched.rows, device=dev).long()
    for level_rows in rows:
        lrows = torch.clamp(level_rows, max=m.rows_padded - 1)
        c = cols[lrows].long()
        v = vals[lrows]
        off = torch.where(c != lrows[:, None], v, 0.0)
        contrib = torch.sum(off * x[torch.clamp(c, max=n)], dim=1)
        xr = (b_pad[lrows] - contrib) / diag[torch.clamp(level_rows, max=n - 1)]
        x[level_rows] = xr
    return x[:n]
