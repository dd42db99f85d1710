"""Carry a local operator's state between the JAX package and the port.

The JAX engine's local operator is three arrays -- the padded ELL
``cols``/``vals`` and the padded inverse diagonal -- read out as numpy
(``np.asarray(eng.ell.cols)``, ``eng.ell.vals``, ``eng._dinv_pad``).
:func:`engine_state_from_numpy` builds the port's engine over exactly those
arrays, so both packages can run on identical operands;
:func:`engine_state_to_numpy` reads them back.

A block-IC(0) engine also carries its ``IC0Factors``: the two padded ELL
factors and the two schedules' ``rows`` (``eng._ic0.ell_l.cols``, ...,
``eng._ic0.sched_l.rows``), as the dict :func:`ic0_factors_to_numpy`
returns.  :func:`ic0_factors_from_numpy` builds the port's factors from
it.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.engine import AzulEngine
from .core.formats import ELL
from .core.levels import LevelSchedule
from .core.precond import IC0Factors
from .device import DEFAULT_DEVICE, resolve_device

__all__ = ["engine_state_from_numpy", "engine_state_to_numpy",
           "ic0_factors_from_numpy", "ic0_factors_to_numpy"]

_FACTORS = (("l", "ell_l", "sched_l"), ("u_rev", "ell_u_rev", "sched_u_rev"))


def _check_ell(cols, vals, rows_p: int, what: str):
    cols, vals = np.asarray(cols), np.asarray(vals)
    if cols.ndim != 2 or cols.shape != vals.shape or cols.shape[0] != rows_p:
        raise ValueError(f"{what}: cols {cols.shape} / vals {vals.shape} must "
                         f"both be ({rows_p}, w)")
    if not np.issubdtype(cols.dtype, np.integer):
        raise TypeError(f"{what}: cols must be integer, got {cols.dtype}")
    if cols.size and (cols.min() < 0 or cols.max() >= rows_p):
        raise ValueError(f"{what}: cols index outside [0, {rows_p})")
    return cols.astype(np.int32), vals


def _schedule(rows, n: int) -> LevelSchedule:
    """A LevelSchedule from its (n_levels, W) ``rows`` (padded with ``n``);
    raises unless every row 0..n-1 is listed exactly once."""
    rows = np.asarray(rows)
    if rows.ndim != 2 or not np.issubdtype(rows.dtype, np.integer):
        raise ValueError(f"schedule rows must be a 2-D integer array, got "
                         f"{rows.dtype} {rows.shape}")
    real = rows != n
    ids = rows[real]
    if ids.size != n or not np.array_equal(np.sort(ids), np.arange(n)):
        raise ValueError("schedule rows must list every row 0..n-1 once, "
                         "padded with n")
    level_of = np.empty(n, np.int32)
    level_of[ids] = np.nonzero(real)[0]
    return LevelSchedule(rows.astype(np.int32),
                         real.sum(axis=1).astype(np.int32), level_of, n)


def ic0_factors_from_numpy(factors: dict, device=DEFAULT_DEVICE) -> IC0Factors:
    """The port's ``IC0Factors`` on ``device`` from host arrays:
    ``{"l_cols", "l_vals", "l_rows", "u_rev_cols", "u_rev_vals",
    "u_rev_rows", "n"}`` (the ELL factors and the schedules' ``rows``)."""
    dev = resolve_device(device)
    n = int(factors["n"])
    parts = []
    for key, _, _ in _FACTORS:
        rows_p = np.asarray(factors[f"{key}_cols"]).shape[0]
        if not 0 < n <= rows_p:
            raise ValueError(f"need 0 < n <= rows_p, got n={n}, {rows_p}")
        cols, vals = _check_ell(factors[f"{key}_cols"], factors[f"{key}_vals"],
                                rows_p, f"factor {key}")
        sched = _schedule(factors[f"{key}_rows"], n)
        parts += [ELL(torch.tensor(cols, device=dev),
                      torch.tensor(vals, device=dev), n, n),
                  sched._replace(rows=torch.tensor(sched.rows, device=dev))]
    return IC0Factors(*parts, n)


def ic0_factors_to_numpy(f: IC0Factors) -> dict:
    """The host arrays of the port's factors, as
    :func:`ic0_factors_from_numpy` takes them."""
    out = {"n": f.n}
    for key, ell_name, sched_name in _FACTORS:
        ell, sched = getattr(f, ell_name), getattr(f, sched_name)
        out[f"{key}_cols"] = ell.cols.cpu().numpy()
        out[f"{key}_vals"] = ell.vals.cpu().numpy()
        out[f"{key}_rows"] = sched.rows.cpu().numpy()
    return out


def engine_state_from_numpy(cols, vals, dinv, n: int, n_pad: int,
                            precond: str = "jacobi", fused="auto",
                            device=DEFAULT_DEVICE,
                            ic0: dict | None = None) -> AzulEngine:
    """The port's local engine over a packed operator.

    ``cols``/``vals``: (n_pad, w) padded ELL, ``dinv``: (n_pad,) inverse
    diagonal (zeros past ``n``), ``n``: the true row count; ``ic0``: for
    ``precond="block_ic0"``, the factors as :func:`ic0_factors_from_numpy`
    takes them.  The arrays are validated here, once, so the kernels can
    gather without bounds checks.
    """
    cols, vals = _check_ell(cols, vals, n_pad, "operator")
    dinv = np.asarray(dinv)
    if dinv.shape != (n_pad,):
        raise ValueError(f"dinv {dinv.shape} must be ({n_pad},)")
    if not 0 < n <= n_pad:
        raise ValueError(f"need 0 < n <= n_pad, got n={n}, n_pad={n_pad}")
    factors = None
    if ic0 is not None:
        if int(ic0["n"]) != n:
            raise ValueError(f"factors are for n={ic0['n']}, operator n={n}")
        for key in ("l_vals", "u_rev_vals"):
            if np.asarray(ic0[key]).dtype != vals.dtype:
                raise TypeError(f"factor {key} is {np.asarray(ic0[key]).dtype}, "
                                f"the operator {vals.dtype}")
        factors = ic0_factors_from_numpy(ic0, device=device)
    return AzulEngine.from_state(cols, vals, dinv.astype(vals.dtype), n,
                                 precond=precond, fused=fused, device=device,
                                 ic0_factors=factors)


def engine_state_to_numpy(engine: AzulEngine) -> dict:
    """``{"cols", "vals", "dinv", "n", "n_pad"}`` of a port engine, as
    host arrays, and ``"ic0"`` (:func:`ic0_factors_to_numpy`) for a
    block-IC(0) engine."""
    out = {
        "cols": engine.ell.cols.cpu().numpy(),
        "vals": engine.ell.vals.cpu().numpy(),
        "dinv": engine._dinv_pad.cpu().numpy(),
        "n": engine.n,
        "n_pad": engine.n_pad,
    }
    if engine._ic0 is not None:
        out["ic0"] = ic0_factors_to_numpy(engine._ic0)
    return out
