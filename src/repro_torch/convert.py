"""Carry a local operator's state between the JAX package and the port.

The JAX engine's local operator is three arrays -- the padded ELL
``cols``/``vals`` and the padded inverse diagonal -- read out as numpy
(``np.asarray(eng.ell.cols)``, ``eng.ell.vals``, ``eng._dinv_pad``).
:func:`engine_state_from_numpy` builds the port's engine over exactly those
arrays, so both packages can run on identical operands;
:func:`engine_state_to_numpy` reads them back.
"""

from __future__ import annotations

import numpy as np

from .core.engine import AzulEngine
from .device import DEFAULT_DEVICE

__all__ = ["engine_state_from_numpy", "engine_state_to_numpy"]


def engine_state_from_numpy(cols, vals, dinv, n: int, n_pad: int,
                            precond: str = "jacobi", fused="auto",
                            device=DEFAULT_DEVICE) -> AzulEngine:
    """The port's local engine over a packed operator.

    ``cols``/``vals``: (n_pad, w) padded ELL, ``dinv``: (n_pad,) inverse
    diagonal (zeros past ``n``), ``n``: the true row count.  The arrays are
    validated here, once, so the kernels can gather without bounds checks.
    """
    cols, vals, dinv = np.asarray(cols), np.asarray(vals), np.asarray(dinv)
    if cols.ndim != 2 or cols.shape != vals.shape or cols.shape[0] != n_pad:
        raise ValueError(f"cols {cols.shape} / vals {vals.shape} must both be "
                         f"(n_pad={n_pad}, w)")
    if dinv.shape != (n_pad,):
        raise ValueError(f"dinv {dinv.shape} must be ({n_pad},)")
    if not 0 < n <= n_pad:
        raise ValueError(f"need 0 < n <= n_pad, got n={n}, n_pad={n_pad}")
    if not np.issubdtype(cols.dtype, np.integer):
        raise TypeError(f"cols must be integer, got {cols.dtype}")
    if cols.size and (cols.min() < 0 or cols.max() >= n_pad):
        raise ValueError("cols index outside [0, n_pad)")
    return AzulEngine.from_state(cols.astype(np.int32), vals,
                                 dinv.astype(vals.dtype), n, precond=precond,
                                 fused=fused, device=device)


def engine_state_to_numpy(engine: AzulEngine) -> dict:
    """``{"cols", "vals", "dinv", "n", "n_pad"}`` of a port engine, as
    host arrays."""
    return {
        "cols": engine.ell.cols.cpu().numpy(),
        "vals": engine.ell.vals.cpu().numpy(),
        "dinv": engine._dinv_pad.cpu().numpy(),
        "n": engine.n,
        "n_pad": engine.n_pad,
    }
