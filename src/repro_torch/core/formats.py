"""Sparse matrix storage formats: CSR on the host, padded ELL on the device.

Port of ``repro.core.formats`` for the formats the first slice runs:

* ``CSR`` -- the host interchange format (scipy-compatible numpy arrays).
* ``ELL`` -- ELLPACK padded to ``(rows_padded, width)``: every row holds
  ``width`` (col, val) slots; padding slots point at column 0 with value
  0.0, so an unmasked gather-multiply-add stays in bounds and exact.

SELL, HYB and BCSR wait for the formats slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["CSR", "ELL", "pad_to", "csr_from_dense", "csr_to_dense",
           "csr_from_scipy", "ell_from_csr"]


def pad_to(x: int, mult: int) -> int:
    """Round ``x`` up to a multiple of ``mult``."""
    if mult <= 0:
        raise ValueError(f"padding multiple must be positive, got {mult}")
    return ((x + mult - 1) // mult) * mult


class CSR(NamedTuple):
    """Compressed sparse row, host side.

    ``indptr``:  (n_rows + 1,) int32
    ``indices``: (nnz,)      int32 column ids, sorted within each row
    ``data``:    (nnz,)      float
    ``shape``:   (n_rows, n_cols)
    """

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)


class ELL(NamedTuple):
    """Padded ELLPACK on a device.

    ``cols``: (rows_padded, width) int32 tensor; padding slots hold 0.
    ``vals``: (rows_padded, width) float tensor; padding slots hold 0.0.
    ``n_rows``/``n_cols``: the true (unpadded) dims.
    """

    cols: torch.Tensor
    vals: torch.Tensor
    n_rows: int
    n_cols: int

    @property
    def rows_padded(self) -> int:
        return self.cols.shape[0]

    @property
    def width(self) -> int:
        return self.cols.shape[1]


def csr_from_dense(a: np.ndarray, tol: float = 0.0) -> CSR:
    a = np.asarray(a)
    if a.ndim != 2:
        raise ValueError("csr_from_dense expects a 2D array")
    mask = np.abs(a) > tol
    indptr = np.zeros(a.shape[0] + 1, dtype=np.int32)
    np.cumsum(mask.sum(axis=1), out=indptr[1:])
    indices = np.nonzero(mask)[1].astype(np.int32)
    data = a[mask].astype(a.dtype)
    return CSR(indptr, indices, data, (a.shape[0], a.shape[1]))


def csr_to_dense(m: CSR) -> np.ndarray:
    out = np.zeros(m.shape, dtype=m.data.dtype if m.data.size else np.float32)
    rows = np.repeat(np.arange(m.shape[0]), m.row_nnz())
    out[rows, m.indices] = m.data
    return out


def csr_from_scipy(m) -> CSR:
    """Accept a scipy.sparse matrix (any format)."""
    m = m.tocsr()
    # scipy's setdiag can leave ``has_sorted_indices`` stale (True with
    # unsorted rows), turning sort_indices() into a silent no-op -- force
    # the sort so the CSR invariant (sorted within each row) holds
    m.has_sorted_indices = False
    m.sort_indices()
    return CSR(
        m.indptr.astype(np.int32),
        m.indices.astype(np.int32),
        np.asarray(m.data),
        tuple(m.shape),
    )


def ell_arrays_from_csr(m: CSR, width: int | None = None, row_pad: int = 8,
                        width_pad: int = 1, dtype=np.float32):
    """The padded ELL ``(cols, vals)`` as numpy arrays (host side).

    ``width`` defaults to the max row nnz, then pads to a multiple of
    ``width_pad``; rows pad to a multiple of ``row_pad``.  Vectorised: each
    stored entry lands at (its row, its rank within the row) in one
    scatter, which gives the same arrays as the JAX package's per-row loop.
    """
    n_rows, _ = m.shape
    row_nnz = np.asarray(m.row_nnz(), dtype=np.int64)
    w = int(row_nnz.max()) if (width is None and n_rows) else int(width or 0)
    w = max(w, 1)
    w = pad_to(w, width_pad)
    rp = pad_to(max(n_rows, 1), row_pad)
    if n_rows and int(row_nnz.max()) > w:
        r = int(np.argmax(row_nnz > w))
        raise ValueError(f"row {r} has nnz {int(row_nnz[r])} > ELL width {w}")

    rows = np.repeat(np.arange(n_rows), row_nnz)
    rank = np.arange(rows.size) - np.asarray(m.indptr, dtype=np.int64)[rows]
    cols = np.zeros((rp, w), dtype=np.int32)
    vals = np.zeros((rp, w), dtype=dtype)
    cols[rows, rank] = m.indices
    vals[rows, rank] = m.data
    return cols, vals


def ell_from_csr(m: CSR, width: int | None = None, row_pad: int = 8,
                 width_pad: int = 1, dtype=np.float32,
                 device=DEFAULT_DEVICE) -> ELL:
    """Pack a CSR matrix into padded ELLPACK on ``device`` (see
    :func:`ell_arrays_from_csr` for the padding rules)."""
    dev = resolve_device(device)
    cols, vals = ell_arrays_from_csr(m, width=width, row_pad=row_pad,
                                     width_pad=width_pad, dtype=dtype)
    return ELL(torch.from_numpy(cols).to(dev), torch.from_numpy(vals).to(dev),
               m.shape[0], m.shape[1])
