"""SuiteSparse-analog sparse matrix generators (numpy/scipy, host side).

Port of ``repro.data.matrices``: the same structural families -- 2D/3D
PDE Laplacians, banded systems, random SPD graphs, skewed and power-law
rows -- built from the same seeds, so both packages see equal matrices.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..core.formats import CSR, csr_from_scipy

__all__ = ["laplacian_2d", "laplacian_3d", "banded_spd", "random_spd",
           "rmat_spd", "skew_spd", "suite"]


def laplacian_2d(nx: int, ny: int | None = None) -> CSR:
    """5-point Poisson stencil on an nx x ny grid (classic PCG benchmark)."""
    ny = ny or nx
    d = sp.diags([2.0, -1.0, -1.0], [0, -1, 1], shape=(nx, nx))
    i_x, i_y = sp.eye(nx), sp.eye(ny)
    a = sp.kron(i_y, d) + sp.kron(sp.diags([2.0, -1.0, -1.0], [0, -1, 1], shape=(ny, ny)), i_x)
    return csr_from_scipy(a.tocsr())


def laplacian_3d(n: int) -> CSR:
    d = sp.diags([2.0, -1.0, -1.0], [0, -1, 1], shape=(n, n))
    i = sp.eye(n)
    a = (sp.kron(sp.kron(d, i), i) + sp.kron(sp.kron(i, d), i)
         + sp.kron(sp.kron(i, i), d))
    return csr_from_scipy(a.tocsr())


def banded_spd(n: int, bands: int = 4, seed: int = 0) -> CSR:
    rng = np.random.default_rng(seed)
    diags = [rng.standard_normal(n) * 0.3 for _ in range(bands)]
    offs = list(range(1, bands + 1))
    a = sp.diags(diags, offs, shape=(n, n))
    a = a + a.T + sp.eye(n) * (2.0 * bands)
    return csr_from_scipy(a.tocsr())


def random_spd(n: int, density: float = 0.01, seed: int = 0) -> CSR:
    """B B^T + shift*I with sparse B -- random SPD with controlled fill."""
    b = sp.random(n, n, density=density, random_state=seed, format="csr")
    a = (b @ b.T + sp.eye(n) * max(1.0, n * density)).tocsr()
    return csr_from_scipy(a)


def skew_spd(n: int, hubs: int = 8, hub_nnz: int | None = None,
             seed: int = 0) -> CSR:
    """SPD with a skewed row-length distribution: a tridiagonal base plus
    ``hubs`` dense-ish hub rows/columns of ~``hub_nnz`` off-diagonals each
    (default ~n*2/5).  Strict diagonal dominance keeps it SPD."""
    rng = np.random.default_rng(seed)
    hub_nnz = hub_nnz or max(8, (2 * n) // 5)
    base = sp.diags([-1.0, -1.0], [-1, 1], shape=(n, n)).tolil()
    hub_rows = rng.choice(n, size=hubs, replace=False)
    for h in hub_rows:
        cols = rng.choice(n, size=min(hub_nnz, n - 1), replace=False)
        cols = cols[cols != h]
        base[h, cols] = -0.01
    a = sp.csr_matrix(base)
    a = (a + a.T) * 0.5                      # symmetrize the hub pattern
    # strictly diagonally dominant: diag > sum(|offdiag|) row-wise
    rowsum = np.asarray(np.abs(a).sum(axis=1)).ravel()
    a = a + sp.diags(rowsum + 1.0)
    return csr_from_scipy(a.tocsr())


def rmat_spd(n: int, nnz_per_row: float = 8.0, seed: int = 0,
             a: float = 0.57, b: float = 0.19, c: float = 0.19) -> CSR:
    """R-MAT power-law graph Laplacian + I: recursive quadrant sampling
    (Chakrabarti et al.) gives the heavy-tailed degree distribution of
    circuit/social graphs; Laplacian-plus-shift of the symmetrized pattern
    is SPD with the same skewed rows."""
    rng = np.random.default_rng(seed)
    scale = max(1, int(np.ceil(np.log2(max(n, 2)))))
    m = int(n * nnz_per_row / 2)
    rows = np.zeros(m, np.int64)
    cols = np.zeros(m, np.int64)
    for _ in range(scale):
        r = rng.random(m)
        # quadrant probabilities (a | b / c | d), d = 1 - a - b - c
        rbit = (r >= a + b).astype(np.int64)
        cbit = (((r >= a) & (r < a + b)) | (r >= a + b + c)).astype(np.int64)
        rows = (rows << 1) | rbit
        cols = (cols << 1) | cbit
    rows %= n
    cols %= n
    keep = rows != cols
    w = np.ones(keep.sum())
    g = sp.coo_matrix((w, (rows[keep], cols[keep])), shape=(n, n)).tocsr()
    g.data[:] = 1.0                           # collapse duplicate samples
    g = g.maximum(g.T)                        # symmetrize
    deg = np.asarray(g.sum(axis=1)).ravel()
    lap = sp.diags(deg + 1.0) - g             # Laplacian + I: SPD
    return csr_from_scipy(lap.tocsr())


def suite(scale: str = "small") -> dict[str, CSR]:
    """Named benchmark suite spanning the paper's size/density envelope
    (the same names and generators as the JAX package)."""
    if scale == "small":
        return {
            "lap2d_32": laplacian_2d(32),
            "lap3d_10": laplacian_3d(10),
            "banded_1k": banded_spd(1000),
            "rspd_1k": random_spd(1000, 0.01, 1),
            "skew_1k": skew_spd(1000, hubs=8, seed=3),
            "rmat_1k": rmat_spd(1000, 8.0, seed=4),
        }
    return {
        "lap2d_96": laplacian_2d(96),
        "lap3d_22": laplacian_3d(22),
        "banded_10k": banded_spd(10_000, 6),
        "rspd_8k": random_spd(8000, 0.004, 2),
        "skew_10k": skew_spd(10_000, hubs=16, seed=3),
        "rmat_8k": rmat_spd(8000, 8.0, seed=4),
    }
