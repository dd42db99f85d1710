"""Per-matrix storage-format choice by modeled matrix-stream words.

Port of the format rule of ``repro.kernels.autotune`` (``row_stats``,
``modeled_format_words``, ``choose_format``).  The port keeps no
persistent cache: the rule is a pure function of the row-length
distribution, recomputed at engine build.
"""

from __future__ import annotations

import numpy as np

__all__ = ["FORMAT_HYSTERESIS", "row_stats", "modeled_format_words",
           "choose_format"]

# a compact format must save at least 1 - FORMAT_HYSTERESIS of the padded
# ELL words to replace it
FORMAT_HYSTERESIS = 0.8


def _pad_up(x: int, q: int) -> int:
    return -(-max(int(x), 1) // q) * q


def row_stats(csr) -> dict:
    """Row-length fingerprint of a CSR-like matrix (anything with
    ``shape``, ``nnz`` and ``row_nnz()``)."""
    rn = np.asarray(csr.row_nnz(), dtype=np.int64)
    n_rows, n_cols = (int(s) for s in csr.shape)
    w_max = int(rn.max()) if rn.size else 0
    w_mean = float(rn.mean()) if rn.size else 0.0
    std = float(rn.std()) if rn.size else 0.0
    return {
        "n_rows": n_rows,
        "n_cols": n_cols,
        "nnz": int(csr.nnz),
        "w_max": w_max,
        "w_mean": round(w_mean, 3),
        "row_cv": round(std / w_mean, 4) if w_mean else 0.0,
    }


def modeled_format_words(csr, slice_height: int = 8, row_pad: int = 8) -> dict:
    """Modeled matrix-stream words per matvec (col, val pairs streamed):

    - ``ell``:  2 * rows_padded * w_max
    - ``sell``: 2 * sum over slices of slice_height * slice width
    - ``hyb``:  2 * rows_padded * w_core + 3 * spilled entries, at the
      storage-optimal core width
    """
    rn = np.asarray(csr.row_nnz(), dtype=np.int64)
    n_rows = int(csr.shape[0])
    rp = _pad_up(_pad_up(n_rows, row_pad), slice_height)
    w_max = int(rn.max()) if rn.size else 0

    rn_pad = np.zeros((rp,), dtype=np.int64)
    rn_pad[:n_rows] = rn
    widths = rn_pad.reshape(-1, slice_height).max(axis=1)
    e_sell = int(np.maximum(widths, 1).sum()) * slice_height

    best_w, best_words = max(w_max, 1), None
    for w in sorted(set(np.unique(rn).tolist()) | {1}):
        spill = int(np.maximum(rn - w, 0).sum())
        words = 2 * rp * w + 3 * spill
        if best_words is None or words < best_words:
            best_w, best_words = w, words

    return {
        "ell": 2 * rp * max(w_max, 1),
        "sell": 2 * e_sell,
        "hyb": int(best_words if best_words is not None else 2 * rp),
        "hyb_core_width": best_w,
    }


def choose_format(csr, slice_height: int = 8,
                  row_pad: int = 8) -> tuple[str, dict]:
    """``(format, words)``: padded ELL unless sell or hyb saves at least
    ``1 - FORMAT_HYSTERESIS`` of its words (ties prefer sell)."""
    words = modeled_format_words(csr, slice_height=slice_height, row_pad=row_pad)
    fmt = "ell"
    best = min(("sell", "hyb"), key=lambda f: (words[f], f != "sell"))
    if words[best] < FORMAT_HYSTERESIS * words["ell"]:
        fmt = best
    return fmt, words
