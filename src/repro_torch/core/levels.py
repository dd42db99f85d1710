"""SpTRSV level scheduling -- the static "task compiler".

Port of ``repro.core.levels`` (host numpy, the same loops).  Azul fires a
row's task once every x value it depends on has arrived; the schedule
computes the same order offline: rows are grouped into dependency levels
(wavefronts), ``level[r] = 1 + max(level[c] for c in deps(r))``.  All rows
of a level are independent, so a triangular solve walks the levels in
order and solves each level's rows in parallel -- one grid-wide barrier a
level in the CUDA kernel (``kernels/csrc/sptrsv.cu``).

``rows``, ``counts`` and ``level_of`` equal the JAX package's arrays.
``rows`` is a host numpy array here; ``precond.ic0`` pins a device copy.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

from .formats import CSR, pad_to

__all__ = ["LevelSchedule", "compute_levels", "build_schedule",
           "parallelism_profile"]


class LevelSchedule(NamedTuple):
    """Packed wavefront schedule for a lower-triangular matrix.

    ``rows``:   (n_levels, max_width) int32 row ids, padded with ``n`` (one
                past the last row); a numpy array, or an int32 tensor made
                from it.
    ``counts``: (n_levels,) int32 true rows per level (numpy).
    ``level_of``: (n,) int32 level id per row (numpy).
    """

    rows: Any
    counts: np.ndarray
    level_of: np.ndarray
    n: int

    @property
    def n_levels(self) -> int:
        return self.rows.shape[0]

    @property
    def max_width(self) -> int:
        return self.rows.shape[1]


def compute_levels(m: CSR, unit_diag: bool = False) -> np.ndarray:
    """Dependency level per row of a lower-triangular CSR matrix.

    Row r depends on every column c < r with a stored L[r, c].  CSR rows are
    visited in order and dependencies only point backwards, so one forward
    pass suffices.
    """
    n = m.shape[0]
    level = np.zeros(n, dtype=np.int32)
    for r in range(n):
        s, e = int(m.indptr[r]), int(m.indptr[r + 1])
        lv = 0
        for p in range(s, e):
            c = int(m.indices[p])
            if c < r:
                lv = max(lv, level[c] + 1)
            elif c > r and not unit_diag:
                raise ValueError(f"matrix is not lower triangular: ({r},{c})")
        level[r] = lv
    return level


def build_schedule(m: CSR, width_pad: int = 8) -> LevelSchedule:
    """The packed schedule of a lower-triangular CSR matrix: each level's
    rows in ascending order, padded with ``n`` to a common width (a
    multiple of ``width_pad``)."""
    level = compute_levels(m)
    n = m.shape[0]
    n_levels = int(level.max()) + 1 if n else 1
    counts = np.bincount(level, minlength=n_levels).astype(np.int32)
    width = pad_to(max(int(counts.max()) if n else 1, 1), width_pad)
    rows = np.full((n_levels, width), n, dtype=np.int32)
    fill = np.zeros(n_levels, dtype=np.int32)
    for r in range(n):
        lv = level[r]
        rows[lv, fill[lv]] = r
        fill[lv] += 1
    return LevelSchedule(rows, counts, level, n)


def parallelism_profile(sched: LevelSchedule) -> dict:
    """Summary stats matching the paper's Fig. 2 (parallelism per level)."""
    counts = np.asarray(sched.counts)
    return {
        "n_rows": sched.n,
        "n_levels": int(sched.n_levels),
        "mean_parallelism": float(counts.mean()) if counts.size else 0.0,
        "median_parallelism": float(np.median(counts)) if counts.size else 0.0,
        "max_parallelism": int(counts.max()) if counts.size else 0,
        "amdahl_speedup_bound": float(sched.n / max(sched.n_levels, 1)),
    }
