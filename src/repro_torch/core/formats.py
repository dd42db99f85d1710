"""Sparse matrix storage formats: CSR on the host, the packed formats on
the device.

Port of ``repro.core.formats``:

* ``CSR``  -- the host interchange format (scipy-compatible numpy arrays).
* ``ELL``  -- ELLPACK padded to ``(rows_padded, width)``: every row holds
  ``width`` (col, val) slots; padding slots point at column 0 with value
  0.0, so an unmasked gather-multiply-add stays in bounds and exact.
* ``SELL`` -- sliced ELLPACK: slices of ``slice_height`` rows, each padded
  only to its own widest row, stored flat and slice-major.
* ``HYB``  -- an ELL core at the storage-optimal width plus a COO tail of
  the entries past it.
* ``BCSR`` -- block rows of dense (bm, bn) blocks, padded to a common
  number of blocks per block row.

The packing functions are vectorised numpy; their arrays are EQUAL to
those of the JAX package's per-row loops (the tests compare them).  SELL
and HYB also carry ``row_groups``: the fixed-order row reduction their
matvecs run (:func:`row_groups`), which the JAX package's segment sums
and scatter-adds do not need.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["CSR", "ELL", "SELL", "HYB", "BCSR", "pad_to", "csr_from_dense",
           "csr_to_dense", "csr_from_scipy", "ell_from_csr", "ell_to_dense",
           "row_groups", "sell_arrays_from_csr", "sell_from_csr",
           "sell_to_dense", "hyb_core_width", "hyb_arrays_from_csr",
           "hyb_from_csr", "hyb_to_dense", "bcsr_arrays_from_csr",
           "bcsr_from_csr", "bcsr_to_dense"]


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


class SELL(NamedTuple):
    """Sliced ELLPACK, flat slice-major storage, on a device.

    ``cols``/``vals``: (n_stored,) entries, slice by slice, each slice a
                       row-major (slice_height, w_s) block (0 / 0.0 in
                       padding slots)
    ``rows``:          (n_stored,) int32 padded row id of each entry
    ``slice_widths``:  host (n_slices,) int32 per-slice widths
    ``n_rows``/``n_cols``: true dims; ``rows_padded``/``slice_height``.
    ``row_groups``:    the fixed-order row reduction (:func:`row_groups`)
    """

    cols: torch.Tensor
    vals: torch.Tensor
    rows: torch.Tensor
    slice_widths: np.ndarray
    n_rows: int
    n_cols: int
    rows_padded: int
    slice_height: int
    row_groups: tuple = ()

    @property
    def n_stored(self) -> int:
        return self.cols.shape[0]


class HYB(NamedTuple):
    """Hybrid ELL + COO on a device: a regular core plus a spill tail.

    ``cols``/``vals``: (rows_padded, core_width) padded ELL core
    ``tail_rows``/``tail_cols``/``tail_vals``: (n_tail,) COO entries past
        ``core_width`` in their row, in row order (padded at the end with
        row 0 / col 0 / val 0.0)
    ``n_rows``/``n_cols``: true dims.
    ``row_groups``: the tail's fixed-order per-row reduction
        (:func:`row_groups`)
    """

    cols: torch.Tensor
    vals: torch.Tensor
    tail_rows: torch.Tensor
    tail_cols: torch.Tensor
    tail_vals: torch.Tensor
    n_rows: int
    n_cols: int
    row_groups: tuple = ()

    @property
    def rows_padded(self) -> int:
        return self.cols.shape[0]

    @property
    def core_width(self) -> int:
        return self.cols.shape[1]

    @property
    def n_tail(self) -> int:
        return self.tail_rows.shape[0]


class BCSR(NamedTuple):
    """Block-CSR of dense (bm, bn) blocks on a device, padded to ``width``
    blocks a block row.

    ``block_cols``: (n_block_rows, width) int32 block-column ids (0 padded)
    ``blocks``:     (n_block_rows, width, bm, bn) dense blocks (zero padded)
    ``n_rows``/``n_cols``: true dims.
    """

    block_cols: torch.Tensor
    blocks: torch.Tensor
    n_rows: int
    n_cols: int

    @property
    def bm(self) -> int:
        return self.blocks.shape[2]

    @property
    def bn(self) -> int:
        return self.blocks.shape[3]

    @property
    def width(self) -> int:
        return self.blocks.shape[1]


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


def ell_to_dense(m: ELL) -> np.ndarray:
    cols = m.cols.cpu().numpy()
    vals = m.vals.cpu().numpy()
    out = np.zeros((m.n_rows, m.n_cols), dtype=vals.dtype)
    keep = vals[: m.n_rows] != 0.0
    r = np.nonzero(keep)[0]
    np.add.at(out, (r, cols[: m.n_rows][keep]), vals[: m.n_rows][keep])
    return out


def _rank_in_row(m: CSR) -> tuple[np.ndarray, np.ndarray]:
    """(row, rank within its row) of every stored entry, in CSR order."""
    row_nnz = np.asarray(m.row_nnz(), dtype=np.int64)
    rows = np.repeat(np.arange(m.shape[0], dtype=np.int64), row_nnz)
    rank = np.arange(rows.size) - np.asarray(m.indptr, dtype=np.int64)[rows]
    return rows, rank


# ---------------------------------------------------------------------------
# the fixed-order row reduction of SELL and HYB
# ---------------------------------------------------------------------------


def row_groups(starts, lengths, out_rows, n_entries: int, order=None,
               device=DEFAULT_DEVICE) -> tuple:
    """The plan of a row reduction over a flat entry array in which row
    ``out_rows[i]`` owns entries ``starts[i] .. starts[i] + lengths[i]``.

    Rows are bucketed by their length rounded up to a power of two P; a
    bucket is ``(idx (M, P) int64, rows (M,) int64)``, where ``idx`` lists
    each row's entries in order and pads with ``n_entries`` (a slot the
    matvec appends, holding 0).  ``order`` maps positions to entry ids
    (a stable sort of unsorted entries); the identity by default.  The
    matvec gathers each bucket and sums its columns by
    :func:`repro_torch.core.spops.tree_sum`, elementwise adds in a fixed
    pairwise order: no atomics, so the bits depend neither on the run nor
    on how many right-hand sides share the call.
    """
    dev = resolve_device(device)
    starts = np.asarray(starts, np.int64)
    lengths = np.asarray(lengths, np.int64)
    out_rows = np.asarray(out_rows, np.int64)
    width = np.left_shift(1, np.frexp(np.maximum(lengths, 1) - 1)[1]
                          .astype(np.int64))
    groups = []
    for p in np.unique(width):
        sel = width == p
        j = np.arange(p, dtype=np.int64)
        idx = starts[sel, None] + j[None, :]
        pad = j[None, :] >= lengths[sel, None]
        idx[pad] = n_entries
        if order is not None:
            idx = np.where(pad, n_entries,
                           np.asarray(order, np.int64)[np.minimum(
                               idx, max(n_entries - 1, 0))])
        groups.append((torch.from_numpy(idx).to(dev),
                       torch.from_numpy(out_rows[sel]).to(dev)))
    return tuple(groups)


def sell_row_groups(slice_widths, slice_height: int,
                    device=DEFAULT_DEVICE) -> tuple:
    """:func:`row_groups` of a SELL layout: every padded row owns its
    slice's width of consecutive entries."""
    row_w = np.repeat(np.asarray(slice_widths, np.int64), slice_height)
    starts = np.concatenate([[0], np.cumsum(row_w)[:-1]])
    return row_groups(starts, row_w, np.arange(row_w.size), int(row_w.sum()),
                      device=device)


def hyb_row_groups(tail_rows, device=DEFAULT_DEVICE) -> tuple:
    """:func:`row_groups` of a HYB tail: each row's tail entries in their
    stored order (the end padding, row 0 / val 0.0, joins row 0)."""
    tail_rows = np.asarray(tail_rows, np.int64)
    if tail_rows.size == 0:
        return ()
    order = np.argsort(tail_rows, kind="stable")
    uniq, starts, lengths = np.unique(tail_rows[order], return_index=True,
                                      return_counts=True)
    return row_groups(starts, lengths, uniq, tail_rows.size, order=order,
                      device=device)


# ---------------------------------------------------------------------------
# SELL
# ---------------------------------------------------------------------------


def sell_arrays_from_csr(m: CSR, slice_height: int = 8, row_pad: int = 8,
                         dtype=np.float32):
    """SELL as host arrays ``(cols, vals, rows, slice_widths,
    rows_padded)``: rows pad to a multiple of ``row_pad`` and of
    ``slice_height``; each slice stores its rows at its own widest row's
    width (at least 1), padding slots col 0 / val 0.0 in their own row."""
    n_rows, _ = m.shape
    rp = pad_to(pad_to(max(n_rows, 1), row_pad), slice_height)
    row_nnz = np.zeros(rp, dtype=np.int64)
    row_nnz[:n_rows] = m.row_nnz()
    widths = np.maximum(row_nnz.reshape(-1, slice_height).max(axis=1),
                        1).astype(np.int32)
    row_w = np.repeat(widths.astype(np.int64), slice_height)
    row_off = np.concatenate([[0], np.cumsum(row_w)[:-1]])
    total = int(row_w.sum())
    cols = np.zeros(total, dtype=np.int32)
    vals = np.zeros(total, dtype=dtype)
    rows = np.repeat(np.arange(rp, dtype=np.int32), row_w)
    r, rank = _rank_in_row(m)
    pos = row_off[r] + rank
    cols[pos] = m.indices
    vals[pos] = m.data
    return cols, vals, rows, widths, rp


def sell_from_csr(m: CSR, slice_height: int = 8, row_pad: int = 8,
                  dtype=np.float32, device=DEFAULT_DEVICE) -> SELL:
    """Pack a CSR matrix into sliced ELLPACK on ``device`` (padding rules
    of :func:`sell_arrays_from_csr`)."""
    dev = resolve_device(device)
    cols, vals, rows, widths, rp = sell_arrays_from_csr(
        m, slice_height=slice_height, row_pad=row_pad, dtype=dtype)
    return SELL(torch.from_numpy(cols).to(dev), torch.from_numpy(vals).to(dev),
                torch.from_numpy(rows).to(dev), widths, m.shape[0], m.shape[1],
                rp, slice_height, sell_row_groups(widths, slice_height, dev))


def sell_to_dense(m: SELL) -> np.ndarray:
    cols = m.cols.cpu().numpy()
    vals = m.vals.cpu().numpy()
    rows = m.rows.cpu().numpy()
    out = np.zeros((m.n_rows, m.n_cols), dtype=vals.dtype)
    keep = (rows < m.n_rows) & (vals != 0.0)
    np.add.at(out, (rows[keep], cols[keep]), vals[keep])
    return out


# ---------------------------------------------------------------------------
# HYB
# ---------------------------------------------------------------------------


def hyb_core_width(row_nnz: np.ndarray, row_pad: int = 8,
                   width_pad: int = 1) -> int:
    """The storage-optimal ELL core width of a HYB split: the width among
    1 and the distinct row lengths minimising 2*rows_p*w (core) +
    3*spill(w) (tail row, col, val); ties take the smaller width."""
    row_nnz = np.asarray(row_nnz)
    rp = pad_to(max(row_nnz.shape[0], 1), row_pad)
    best_w, best_cost = 1, None
    for w in sorted({1, *(int(k) for k in np.unique(row_nnz) if k > 0)}):
        spill = int(np.maximum(row_nnz - w, 0).sum())
        cost = 2 * rp * w + 3 * spill
        if best_cost is None or cost < best_cost:
            best_w, best_cost = w, cost
    return pad_to(best_w, width_pad)


def hyb_arrays_from_csr(m: CSR, core_width: int | None = None,
                        row_pad: int = 8, width_pad: int = 1,
                        tail_pad: int = 8, dtype=np.float32):
    """HYB as host arrays ``(cols, vals, tail_rows, tail_cols,
    tail_vals)``: an ELL core of ``core_width`` (default
    :func:`hyb_core_width`) and, in row order, every entry past it; the
    tail pads to a multiple of ``tail_pad`` with row 0 / col 0 / val 0.0
    (and is empty when nothing spills)."""
    n_rows, _ = m.shape
    if core_width is None:
        core_width = hyb_core_width(m.row_nnz(), row_pad=row_pad,
                                    width_pad=width_pad)
    w = max(1, pad_to(int(core_width), width_pad))
    rp = pad_to(max(n_rows, 1), row_pad)
    r, rank = _rank_in_row(m)
    core = rank < w
    cols = np.zeros((rp, w), dtype=np.int32)
    vals = np.zeros((rp, w), dtype=dtype)
    cols[r[core], rank[core]] = m.indices[core]
    vals[r[core], rank[core]] = m.data[core]
    spill = ~core
    n_spill = int(spill.sum())
    nt = pad_to(max(n_spill, 1), tail_pad) if n_spill else 0
    tr = np.zeros(nt, dtype=np.int32)
    tc = np.zeros(nt, dtype=np.int32)
    tv = np.zeros(nt, dtype=dtype)
    tr[:n_spill] = r[spill]
    tc[:n_spill] = m.indices[spill]
    tv[:n_spill] = m.data[spill]
    return cols, vals, tr, tc, tv


def hyb_from_csr(m: CSR, core_width: int | None = None, row_pad: int = 8,
                 width_pad: int = 1, tail_pad: int = 8, dtype=np.float32,
                 device=DEFAULT_DEVICE) -> HYB:
    """Pack a CSR matrix into HYB on ``device`` (see
    :func:`hyb_arrays_from_csr`)."""
    dev = resolve_device(device)
    arrays = hyb_arrays_from_csr(m, core_width=core_width, row_pad=row_pad,
                                 width_pad=width_pad, tail_pad=tail_pad,
                                 dtype=dtype)
    t = [torch.from_numpy(a).to(dev) for a in arrays]
    return HYB(*t, m.shape[0], m.shape[1], hyb_row_groups(arrays[2], dev))


def hyb_to_dense(m: HYB) -> np.ndarray:
    cols = m.cols.cpu().numpy()
    vals = m.vals.cpu().numpy()
    out = np.zeros((m.n_rows, m.n_cols), dtype=vals.dtype)
    keep = vals[: m.n_rows] != 0.0
    r = np.nonzero(keep)[0]
    np.add.at(out, (r, cols[: m.n_rows][keep]), vals[: m.n_rows][keep])
    tr, tc, tv = (t.cpu().numpy() for t in (m.tail_rows, m.tail_cols,
                                            m.tail_vals))
    keep = tv != 0.0
    np.add.at(out, (tr[keep], tc[keep]), tv[keep])
    return out


# ---------------------------------------------------------------------------
# BCSR
# ---------------------------------------------------------------------------


def bcsr_arrays_from_csr(m: CSR, bm: int = 8, bn: int = 128,
                         width: int | None = None, dtype=np.float32):
    """BCSR as host arrays ``(block_cols, blocks)``.

    A block (I, J) is stored iff a stored entry falls inside it; each block
    row lists its blocks by ascending J and pads to ``width`` (default: the
    most blocks of any block row) with block column 0 and zero blocks.
    Entries that share a position add up, in CSR order.
    """
    n_rows, n_cols = m.shape
    nbr = pad_to(max(n_rows, 1), bm) // bm
    nbc = pad_to(max(n_cols, 1), bn) // bn
    r, _ = _rank_in_row(m)
    c = np.asarray(m.indices, dtype=np.int64)
    key = (r // bm) * nbc + c // bn
    uniq, inv = np.unique(key, return_inverse=True)
    ui, uj = uniq // nbc, uniq % nbc
    per_row = np.bincount(ui, minlength=nbr)
    wmax = int(per_row.max()) if per_row.size else 0
    w = max(int(width or wmax), 1)
    if wmax > w:
        raise ValueError(f"block row has {wmax} blocks > width {w}")
    first = np.concatenate([[0], np.cumsum(per_row)[:-1]])
    slot = np.arange(uniq.size) - first[ui]
    block_cols = np.zeros((nbr, w), dtype=np.int32)
    blocks = np.zeros((nbr, w, bm, bn), dtype=dtype)
    block_cols[ui, slot] = uj
    np.add.at(blocks, (ui[inv], slot[inv], r % bm, c % bn), m.data)
    return block_cols, blocks


def bcsr_from_csr(m: CSR, bm: int = 8, bn: int = 128,
                  width: int | None = None, dtype=np.float32,
                  device=DEFAULT_DEVICE) -> BCSR:
    """Pack CSR into padded BCSR of dense (bm, bn) blocks on ``device``
    (see :func:`bcsr_arrays_from_csr`)."""
    dev = resolve_device(device)
    bc, bl = bcsr_arrays_from_csr(m, bm=bm, bn=bn, width=width, dtype=dtype)
    return BCSR(torch.from_numpy(bc).to(dev), torch.from_numpy(bl).to(dev),
                m.shape[0], m.shape[1])


def bcsr_to_dense(m: BCSR) -> np.ndarray:
    bc = m.block_cols.cpu().numpy().astype(np.int64)
    bl = m.blocks.cpu().numpy()
    nbr, w, bm, bn = bl.shape
    full = np.zeros((nbr, bm, pad_to(max(m.n_cols, 1), bn) // bn, bn),
                    dtype=bl.dtype)
    i = np.repeat(np.arange(nbr), w)
    np.add.at(full, (i, slice(None), bc.reshape(-1)),
              bl.reshape(nbr * w, bm, bn))
    return full.reshape(nbr * bm, -1)[: m.n_rows, : m.n_cols]
