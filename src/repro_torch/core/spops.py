"""Single-device sparse ops on packed formats (plain PyTorch).

Port of ``repro.core.spops``: the padded-ELL matvec and its multi-RHS
twin, the SELL, HYB and BCSR matvecs of the format portfolio, and the
level-scheduled triangular solve that the reference substrate's
block-IC(0) applies.  They are plain PyTorch on whatever device their
tensors lie on -- never a hand-written kernel.

The SELL and HYB matvecs reduce each row in a fixed order
(:func:`tree_sum` over the containers' ``row_groups``) where the JAX
package runs ``segment_sum`` and ``.at[].add``: their PyTorch
counterparts (``index_add_``, ``scatter_add_``) add with float atomics on
CUDA, whose order -- and so whose bits -- change from run to run.  Here
lane j of a (k, n) call is bitwise the (1, n) call on lane j, and two
calls give the same bits.
"""

from __future__ import annotations

import torch

import torch.nn.functional as F

from .formats import BCSR, ELL, HYB, SELL
from .levels import LevelSchedule

__all__ = ["spmv_ell_padded", "spmm_ell_padded", "tree_sum",
           "spmv_sell_flat", "spmm_sell_flat", "spmv_hyb_padded",
           "spmm_hyb_padded", "spmv_bcsr", "spmv_bcsr_padded",
           "spmm_bcsr_padded", "extract_diag_ell", "sptrsv_ell"]


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


def tree_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed pairwise order: halve the axis
    by adding its second half onto its first, carrying an odd last column
    to the next round.  Elementwise adds only, so the bits of each sum
    depend on its own values alone."""
    while t.shape[-1] > 1:
        w = t.shape[-1]
        h = w // 2
        s = t[..., :h] + t[..., h: 2 * h]
        t = torch.cat([s, t[..., 2 * h:]], dim=-1) if w % 2 else s
    return t[..., 0]


def _reduce_rows(contrib: torch.Tensor, groups, out: torch.Tensor,
                 add: bool) -> torch.Tensor:
    """Per-row sums of ``contrib`` (..., n_entries) over a row_groups
    plan, stored into (or, with ``add``, added onto) ``out``'s rows.  The
    rows of a plan are unique, so no two writes meet."""
    c = F.pad(contrib, (0, 1))            # the plan's zero slot
    for idx, rows in groups:
        s = tree_sum(c[..., idx])
        out[..., rows] = out[..., rows] + s if add else s
    return out


def spmv_sell_flat(m: SELL, x: torch.Tensor) -> torch.Tensor:
    """Padded-row SpMV over sliced-ELL flat storage: one gather of x per
    stored entry, then each row's entries summed in a fixed order.
    Returns (rows_padded,)."""
    out = torch.empty(m.rows_padded, dtype=m.vals.dtype, device=m.vals.device)
    return _reduce_rows(m.vals * x[m.cols], m.row_groups, out, add=False)


def spmm_sell_flat(m: SELL, x: torch.Tensor) -> torch.Tensor:
    """Multi-RHS sliced-ELL SpMV in the solver layout: x (k, n_pad) ->
    (k, rows_padded), one matrix stream for all k."""
    out = torch.empty(x.shape[0], m.rows_padded, dtype=m.vals.dtype,
                      device=m.vals.device)
    return _reduce_rows(m.vals * x[:, m.cols], m.row_groups, out, add=False)


def spmv_hyb_padded(m: HYB, x: torch.Tensor) -> torch.Tensor:
    """HYB SpMV: the ELL core's gather and row sums, then each tail row's
    entries summed and added onto its row.  Returns (rows_padded,)."""
    y = tree_sum(m.vals * x[m.cols])
    return _reduce_rows(m.tail_vals * x[m.tail_cols], m.row_groups, y,
                        add=True)


def spmm_hyb_padded(m: HYB, x: torch.Tensor) -> torch.Tensor:
    """Multi-RHS HYB SpMV: x (k, n_pad) -> (k, rows_padded)."""
    y = tree_sum(m.vals * x[:, m.cols])
    return _reduce_rows(m.tail_vals * x[:, m.tail_cols], m.row_groups, y,
                        add=True)


def _nbc(m: BCSR) -> int:
    return (m.n_cols + m.bn - 1) // m.bn


def spmv_bcsr(m: BCSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for BCSR A on a true (n_cols,) x; returns (n_rows,)."""
    x_blk = torch.zeros(_nbc(m) * m.bn, dtype=x.dtype, device=x.device)
    x_blk[: m.n_cols] = x
    xg = x_blk.reshape(-1, m.bn)[m.block_cols]        # (nbr, width, bn)
    y = torch.einsum("iwmn,iwn->im", m.blocks, xg)
    return y.reshape(-1)[: m.n_rows]


def spmv_bcsr_padded(m: BCSR, x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """BCSR SpMV on padded engine vectors: x (n_pad,) -> (n_pad,).  x
    re-embeds into the (nbc*bn,) block layout (zeros past n_cols), the
    blocks apply as dense (bm, bn) products, and the (nbr*bm,) result
    re-embeds into n_pad."""
    x_blk = torch.zeros(_nbc(m) * m.bn, dtype=x.dtype, device=x.device)
    x_blk[: m.n_cols] = x[: m.n_cols]
    xg = x_blk.reshape(-1, m.bn)[m.block_cols]
    y = torch.einsum("iwmn,iwn->im", m.blocks, xg).reshape(-1)
    if y.shape[0] >= n_pad:
        return y[:n_pad]
    out = torch.zeros(n_pad, dtype=y.dtype, device=y.device)
    out[: y.shape[0]] = y
    return out


def spmm_bcsr_padded(m: BCSR, x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Multi-RHS BCSR SpMV: x (k, n_pad) -> (k, n_pad), one block stream
    for all k."""
    k = x.shape[0]
    x_blk = torch.zeros(k, _nbc(m) * m.bn, dtype=x.dtype, device=x.device)
    x_blk[:, : m.n_cols] = x[:, : m.n_cols]
    xg = x_blk.reshape(k, -1, m.bn)[:, m.block_cols]  # (k, nbr, width, bn)
    y = torch.einsum("iwmn,kiwn->kim", m.blocks, xg).reshape(k, -1)
    if y.shape[1] >= n_pad:
        return y[:, :n_pad]
    out = torch.zeros(k, n_pad, dtype=y.dtype, device=y.device)
    out[:, : y.shape[1]] = y
    return out


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
