"""Static partitioning of a sparse matrix onto the tile grid, and the
host-side reordering that shrinks its halos.

Port of ``repro.core.partition`` (numpy throughout; the packed arrays are
equal to the JAX package's).  The matrix is cut into blocks once, on the
host, and each block belongs to a tile for the lifetime of the engine.
Every tile's block is padded to a common ELL geometry and stacked along a
leading tile axis, so tile ``t`` owns slice ``t`` of the stacked arrays.

* ``plan_1d`` -- a row partition over all P tiles; SpMV gathers the whole
  x on every tile (the bandwidth-hungry baseline).
* ``plan_2d`` -- a (pr x pc) block partition: tile (i, j) owns block
  A[I=i, J=j], so SpMV sees 1/pc of x and emits 1/pr of y (Azul's NoC
  pattern).

``split_rows`` cuts rows into equal-row or nnz-balanced chunks (prefix
sum); ``plan_2d(balance="nnz")`` puts the row-block boundaries on the nnz
prefix sum and embeds global rows into the common padded geometry through
``pad2g``.  ``padded_layout_1d`` is the 1-D plan's padded device layout.
``tile_csr`` extracts a submatrix with local indices.

``rcm_permutation`` computes a bandwidth-reducing reverse Cuthill-McKee
ordering over the *symmetrized* pattern and ``permute_csr`` applies it
symmetrically (A' = P A P^T).  ``AzulEngine(reorder="rcm")`` packs the
permuted matrix and permutes vectors on the way in and back on the way
out.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .formats import CSR, pad_to

__all__ = ["Plan1D", "Plan2D", "plan_1d", "plan_2d", "split_rows",
           "tile_csr", "padded_layout_1d", "rcm_permutation", "permute_csr",
           "matrix_bandwidth", "partition_nnz_histogram"]


def _sym_adjacency(m: CSR) -> tuple[np.ndarray, np.ndarray]:
    """CSR adjacency (indptr, indices) of the symmetrized pattern
    A | A^T, diagonal dropped -- the graph RCM walks."""
    n = m.shape[0]
    r = np.repeat(np.arange(n, dtype=np.int64), m.row_nnz())
    c = m.indices.astype(np.int64)
    rr = np.concatenate([r, c])
    cc = np.concatenate([c, r])
    keep = rr != cc
    key = np.unique(rr[keep] * n + cc[keep])
    rows, cols = key // n, key % n
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return indptr, cols


def rcm_permutation(m: CSR) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of ``m``'s symmetrized pattern.

    Returns ``perm`` such that new row/col ``i`` is old row/col ``perm[i]``
    (use with :func:`permute_csr`).  Deterministic: BFS seeds are the
    minimum-degree node of each component (ties by index) and neighbors are
    visited in increasing (degree, index) order -- so plans and the CI
    traffic records built on top of it are reproducible.
    """
    if m.shape[0] != m.shape[1]:
        raise ValueError("rcm_permutation expects a square matrix")
    n = m.shape[0]
    indptr, indices = _sym_adjacency(m)
    degree = np.diff(indptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    for seed in np.argsort(degree, kind="stable"):
        if visited[seed]:
            continue
        visited[seed] = True
        order[pos] = seed
        head = pos
        pos += 1
        while head < pos:                      # BFS, degree-sorted neighbors
            v = order[head]
            head += 1
            nbrs = indices[indptr[v]:indptr[v + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.size:
                nbrs = nbrs[np.argsort(degree[nbrs], kind="stable")]
                visited[nbrs] = True
                order[pos:pos + nbrs.size] = nbrs
                pos += nbrs.size
    return order[::-1].copy()                  # the R in RCM


def permute_csr(m: CSR, perm: np.ndarray) -> CSR:
    """Symmetric permutation A' = P A P^T: A'[i, j] = A[perm[i], perm[j]],
    column indices re-sorted per row (CSR invariant)."""
    n = m.shape[0]
    perm = np.asarray(perm, dtype=np.int64)
    iperm = np.empty(n, np.int64)
    iperm[perm] = np.arange(n)
    counts = m.row_nnz()[perm]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    within = np.arange(int(indptr[-1])) - np.repeat(indptr[:-1], counts)
    src = np.repeat(np.asarray(m.indptr, np.int64)[perm], counts) + within
    indices = iperm[m.indices[src]]
    data = np.asarray(m.data)[src]
    order = np.lexsort((indices, np.repeat(np.arange(n), counts)))
    return CSR(indptr.astype(np.int32), indices[order].astype(np.int32),
               data[order], m.shape)


def matrix_bandwidth(m: CSR) -> int:
    """max |i - j| over stored entries (0 for diagonal/empty) -- the halo
    driver RCM minimizes."""
    if m.nnz == 0:
        return 0
    r = np.repeat(np.arange(m.shape[0], dtype=np.int64), m.row_nnz())
    return int(np.abs(r - m.indices).max())


def split_rows(m: CSR, parts: int, balance: str = "rows") -> np.ndarray:
    """Return (parts+1,) row offsets splitting ``m`` into contiguous chunks.

    ``balance='rows'``: equal row counts (rounded linspace).
    ``balance='nnz'``:  split points on the nnz prefix sum, so each chunk
    carries ~nnz/parts nonzeros (Azul's load-balance criterion: tile work
    is proportional to the nonzeros it stores, not its rows).
    """
    n = m.shape[0]
    if parts <= 0:
        raise ValueError("parts must be positive")
    if balance == "rows":
        base = np.linspace(0, n, parts + 1)
        return np.round(base).astype(np.int64)
    if balance == "nnz":
        csum = np.asarray(m.indptr, dtype=np.float64)
        total = max(csum[-1], 1.0)
        targets = np.linspace(0.0, total, parts + 1)
        hi = np.searchsorted(csum, targets, side="left")
        lo = np.maximum(hi - 1, 0)
        # the boundary closer to the ideal cumulative nnz (plain
        # side="left" can overshoot far on skewed rows)
        pick_hi = np.abs(csum[np.minimum(hi, n)] - targets) <= np.abs(
            csum[lo] - targets)
        offs = np.where(pick_hi, np.minimum(hi, n), lo)
        offs[0], offs[-1] = 0, n
        # monotone (empty chunks allowed for pathological inputs)
        return np.maximum.accumulate(offs).astype(np.int64)
    raise ValueError(f"unknown balance mode {balance!r}")


def tile_csr(m: CSR, r0: int, r1: int, c0: int, c1: int) -> CSR:
    """The (r0:r1, c0:c1) submatrix with *local* indices (stored entries
    in their CSR order, vectorised over the rows' nnz slice)."""
    indptr = np.asarray(m.indptr, np.int64)
    lo, hi = int(indptr[r0]), int(indptr[r1])
    counts = np.diff(indptr[r0: r1 + 1])
    rows = np.repeat(np.arange(r1 - r0), counts)
    cs = np.asarray(m.indices)[lo:hi]
    sel = (cs >= c0) & (cs < c1)
    out_ptr = np.zeros(r1 - r0 + 1, np.int64)
    np.cumsum(np.bincount(rows[sel], minlength=r1 - r0), out=out_ptr[1:])
    return CSR(out_ptr.astype(np.int32), (cs[sel] - c0).astype(np.int32),
               np.asarray(m.data)[lo:hi][sel], (r1 - r0, c1 - c0))


class Plan1D(NamedTuple):
    """Row-partitioned plan: tile t owns rows [row_offsets[t],
    row_offsets[t+1]).  ``cols``/``vals``: (P, rows_p, width) stacked
    padded ELL tiles (local row index, *global* column index)."""

    cols: np.ndarray
    vals: np.ndarray
    row_offsets: np.ndarray       # (P+1,)
    n: int                        # true vector length
    n_padded: int                 # P * rows_p
    rows_per_tile: int            # rows_p

    @property
    def parts(self) -> int:
        return self.cols.shape[0]


class Plan2D(NamedTuple):
    """2D block plan on a (pr x pc) grid; tile (i, j) owns block
    A[I=i, J=j].  ``cols``/``vals``: (pr*pc, rows_p, width) padded ELL
    tiles with column indices local to column block J; tile order is
    row-major, index = i * pc + j.  Row and column blocks are equal-sized
    (n_padded / pr, n_padded / pc).

    nnz balance: row-block boundaries follow the nnz prefix sum
    (``row_offsets``), every block pads to the common ``block_rows``, and
    ``pad2g`` maps padded indices to global rows (``n`` marks padding).
    Uniform plans carry ``row_offsets=None``/``pad2g=None``."""

    cols: np.ndarray
    vals: np.ndarray
    pr: int
    pc: int
    n: int
    n_padded: int
    row_offsets: np.ndarray | None = None    # (pr+1,), nnz balance
    pad2g: np.ndarray | None = None          # (n_padded,)

    @property
    def block_rows(self) -> int:
        return self.n_padded // self.pr

    @property
    def block_cols(self) -> int:
        return self.n_padded // self.pc


def _stack_ell_from_coo(tile_id, loc_r, loc_c, val, n_tiles: int,
                        rows_p: int, width_pad: int, dtype):
    """Stacked-ELL packer: entries grouped by (tile, local row), each
    entry's slot its rank within the group; duplicates are summed."""
    if val.size == 0:
        w = max(width_pad, 1)
        return (np.zeros((n_tiles, rows_p, w), np.int32),
                np.zeros((n_tiles, rows_p, w), dtype))
    key = tile_id.astype(np.int64) * rows_p + loc_r
    order = np.lexsort((loc_c, key))
    key_s, c_s, v_s = key[order], loc_c[order], val[order]
    first = np.r_[0, np.flatnonzero(np.diff(key_s)) + 1]
    group_start = np.repeat(first, np.diff(np.r_[first, key_s.size]))
    k = np.arange(key_s.size) - group_start          # slot within row
    w = pad_to(max(int(k.max()) + 1, 1), width_pad)
    cols = np.zeros((n_tiles * rows_p, w), np.int32)
    vals = np.zeros((n_tiles * rows_p, w), dtype)
    cols[key_s, k] = c_s
    np.add.at(vals, (key_s, k), v_s)
    return cols.reshape(n_tiles, rows_p, w), vals.reshape(n_tiles, rows_p, w)


def _csr_to_coo(m: CSR):
    rows = np.repeat(np.arange(m.shape[0], dtype=np.int64), m.row_nnz())
    return rows, m.indices.astype(np.int64), np.asarray(m.data)


def plan_1d(m: CSR, parts: int, balance: str = "rows", width_pad: int = 8,
            row_pad: int = 8, dtype=np.float32) -> Plan1D:
    n = m.shape[0]
    if m.shape[0] != m.shape[1]:
        raise ValueError("plan_1d expects a square matrix")
    offs = split_rows(m, parts, balance)
    rows, cols_g, vals_g = _csr_to_coo(m)
    tile = np.clip(np.searchsorted(offs, rows, side="right") - 1, 0, parts - 1)
    loc_r = rows - offs[tile]
    rows_p = pad_to(max(int(np.diff(offs).max()) if parts else 1, 1), row_pad)
    cols, vals = _stack_ell_from_coo(tile, loc_r, cols_g, vals_g, parts,
                                     rows_p, width_pad, dtype)
    return Plan1D(cols, vals, offs, n, parts * rows_p, rows_p)


def plan_2d(m: CSR, pr: int, pc: int, width_pad: int = 8, row_pad: int = 8,
            dtype=np.float32, balance: str = "rows") -> Plan2D:
    n = m.shape[0]
    if m.shape[0] != m.shape[1]:
        raise ValueError("plan_2d expects a square matrix")
    if balance == "nnz":
        return _plan_2d_nnz(m, pr, pc, width_pad, row_pad, dtype)
    if balance != "rows":
        raise ValueError(f"unknown balance mode {balance!r}")
    # equal row/col blocks, block rows a multiple of row_pad, and a whole
    # per-tile vector segment u = n_pad / (pr*pc)
    n_pad = pad_to(n, pr * pc * row_pad)
    br, bc = n_pad // pr, n_pad // pc
    rows, cols_g, vals_g = _csr_to_coo(m)
    bi, bj = rows // br, cols_g // bc
    cols, vals = _stack_ell_from_coo(bi * pc + bj, rows - bi * br,
                                     cols_g - bj * bc, vals_g, pr * pc, br,
                                     width_pad, dtype)
    return Plan2D(cols, vals, pr, pc, n, n_pad)


def _plan_2d_nnz(m: CSR, pr: int, pc: int, width_pad: int, row_pad: int,
                 dtype) -> Plan2D:
    """nnz-balanced 2D plan: row-block boundaries on the nnz prefix sum,
    every block padded to a common ``br`` (a multiple of row_pad and of
    pc).  Rows and columns embed into the padded geometry through the same
    ``pad2g``, so sub-shard k of column block J is the u-segment the mesh
    transpose puts on tile (k, J)."""
    n = m.shape[0]
    offs = split_rows(m, pr, "nnz")
    max_blk = max(int(np.diff(offs).max()) if pr else 1, 1)
    br = pad_to(max_blk, row_pad * pc)
    n_pad = pr * br
    bc = n_pad // pc
    pad2g = np.full(n_pad, n, np.int64)
    g2pad = np.empty(n, np.int64)
    for i in range(pr):
        r0, r1 = int(offs[i]), int(offs[i + 1])
        pad2g[i * br: i * br + (r1 - r0)] = np.arange(r0, r1)
        g2pad[r0:r1] = i * br + np.arange(r1 - r0)
    rows, cols_g, vals_g = _csr_to_coo(m)
    pr_idx, pc_idx = g2pad[rows], g2pad[cols_g]
    tile = (pr_idx // br) * pc + (pc_idx // bc)
    cols, vals = _stack_ell_from_coo(tile, pr_idx % br, pc_idx % bc, vals_g,
                                     pr * pc, br, width_pad, dtype)
    # a balanced split that lands on the uniform geometry IS the uniform
    # plan (identity embedding): no pad2g, so uniform-only consumers
    # (build_sptrsv) keep working
    if (n_pad == pad_to(n, pr * pc * row_pad)
            and np.array_equal(pad2g[:n], np.arange(n))):
        return Plan2D(cols, vals, pr, pc, n, n_pad)
    return Plan2D(cols, vals, pr, pc, n, n_pad, row_offsets=offs,
                  pad2g=pad2g)


def padded_layout_1d(plan: Plan1D) -> tuple[np.ndarray, np.ndarray]:
    """The 1D plan's padded device layout: (cols_pad, pad2g).

    ``cols_pad``: (parts, rows_p, w) column ids remapped from global rows
    into the padded tile layout (tile t, local r) = t*u + r, the layout
    the engine holds vectors in and the comm plan is compiled against.
    ``pad2g``: (n_padded,) padded index -> global row (``n`` in padding
    slots)."""
    parts, u = plan.parts, plan.rows_per_tile
    offs = plan.row_offsets
    cols = np.asarray(plan.cols)
    owner = np.clip(np.searchsorted(offs, cols, side="right") - 1, 0,
                    parts - 1)
    cols_pad = (owner * u + (cols - offs[owner])).astype(np.int32)
    pad2g = np.full(plan.n_padded, plan.n, np.int64)
    for t in range(parts):
        cnt = int(offs[t + 1] - offs[t])
        pad2g[t * u: t * u + cnt] = np.arange(offs[t], offs[t + 1])
    return cols_pad, pad2g


def partition_nnz_histogram(m: CSR, offs: np.ndarray) -> np.ndarray:
    """nnz per chunk."""
    csum = np.asarray(m.indptr, dtype=np.int64)
    return csum[offs[1:]] - csum[offs[:-1]]
