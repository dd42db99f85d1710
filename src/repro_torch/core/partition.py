"""Host-side reordering of a sparse matrix (the part of
``repro.core.partition`` a local engine needs).

``rcm_permutation`` computes a bandwidth-reducing reverse Cuthill-McKee
ordering over the *symmetrized* pattern and ``permute_csr`` applies it
symmetrically (A' = P A P^T).  ``AzulEngine(reorder="rcm")`` packs the
permuted matrix and permutes vectors on the way in and back on the way
out.  The tile partitions (``plan_1d``, ``plan_2d``) arrive with the
distributed engine (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import numpy as np

from .formats import CSR

__all__ = ["rcm_permutation", "permute_csr"]


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
