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

The JAX package's SELL, HYB and BCSR containers and its matrix-free
``Stencil`` carry over as dicts of their fields, arrays as numpy
(``{k: np.asarray(v) for k, v in obj._asdict().items()}``):
:func:`format_from_numpy` builds the port's container (SELL and HYB with
their row-reduction plans), :func:`format_to_numpy` reads one back.  An
engine built by :func:`engine_state_from_numpy` takes them as
``formats={"hyb": {...}}`` for plans with ``SolveSpec(format=...)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.engine import AzulEngine
from .core.formats import (BCSR, ELL, HYB, SELL, hyb_row_groups,
                           sell_row_groups)
from .core.levels import LevelSchedule
from .core.precond import IC0Factors
from .core.stencil import Stencil
from .device import DEFAULT_DEVICE, resolve_device, resolve_dtype

__all__ = ["engine_state_from_numpy", "engine_state_to_numpy",
           "ic0_factors_from_numpy", "ic0_factors_to_numpy",
           "format_from_numpy", "format_to_numpy"]

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


def _index(a, bound: int, what: str) -> np.ndarray:
    a = np.asarray(a)
    if not np.issubdtype(a.dtype, np.integer):
        raise TypeError(f"{what} must be integer, got {a.dtype}")
    if a.size and (a.min() < 0 or a.max() >= bound):
        raise ValueError(f"{what}: index outside [0, {bound})")
    return a.astype(np.int32)


def format_from_numpy(fmt: str, arrays: dict, device=DEFAULT_DEVICE):
    """The port's container for ``fmt`` ("sell", "hyb", "bcsr" or
    "stencil") from the JAX container's fields as host arrays (the
    ``_asdict()`` of it).  Indices are validated here, once, so the
    matvecs gather without bounds checks."""
    if fmt not in ("sell", "hyb", "bcsr", "stencil"):
        raise ValueError(f"no format container for {fmt!r}")
    dev = resolve_device(device)
    a = arrays
    if fmt == "stencil":
        if a["kind"] not in ("lap2d", "lap3d"):
            raise ValueError(f"unknown stencil kind {a['kind']!r}")
        return Stencil(str(a["kind"]), tuple(int(d) for d in a["dims"]))
    n_rows, n_cols = int(a["n_rows"]), int(a["n_cols"])
    if fmt == "sell":
        rp, sh = int(a["rows_padded"]), int(a["slice_height"])
        widths = np.asarray(a["slice_widths"]).astype(np.int32)
        vals = np.asarray(a["vals"])
        total = sh * int(widths.sum())
        if rp != sh * widths.size or vals.shape != (total,):
            raise ValueError(f"SELL: {widths.size} slices of {sh} rows and "
                             f"{vals.shape} values for {rp} padded rows")
        cols = _index(a["cols"], n_cols, "SELL cols")
        rows = _index(a["rows"], rp, "SELL rows")
        if not np.array_equal(rows, np.repeat(np.arange(rp, dtype=np.int32),
                                              np.repeat(widths, sh))):
            raise ValueError("SELL rows do not follow the slice widths")
        return SELL(torch.tensor(cols, device=dev), torch.tensor(vals, device=dev),
                    torch.tensor(rows, device=dev), widths, n_rows, n_cols, rp,
                    sh, sell_row_groups(widths, sh, dev))
    if fmt == "hyb":
        vals, tv = np.asarray(a["vals"]), np.asarray(a["tail_vals"])
        rp = vals.shape[0]
        cols, _ = _check_ell(a["cols"], vals, rp, "HYB core")
        cols = _index(cols, n_cols, "HYB cols")
        tr = _index(a["tail_rows"], rp, "HYB tail_rows")
        tc = _index(a["tail_cols"], n_cols, "HYB tail_cols")
        if not tr.shape == tc.shape == tv.shape:
            raise ValueError("HYB tail arrays differ in length")
        t = [torch.tensor(v, device=dev) for v in (cols, vals, tr, tc, tv)]
        return HYB(*t, n_rows, n_cols, hyb_row_groups(tr, dev))
    else:
        blocks = np.asarray(a["blocks"])
        if blocks.ndim != 4:
            raise ValueError(f"BCSR blocks {blocks.shape} must be (nbr, w, bm, bn)")
        nbc = -(-n_cols // blocks.shape[3])
        bc = _index(a["block_cols"], nbc, "BCSR block_cols")
        if bc.shape != blocks.shape[:2]:
            raise ValueError(f"BCSR block_cols {bc.shape} vs blocks {blocks.shape}")
        return BCSR(torch.tensor(bc, device=dev), torch.tensor(blocks, device=dev),
                    n_rows, n_cols)


def format_to_numpy(obj) -> tuple[str, dict]:
    """``(fmt, fields)`` of a port container, arrays as numpy, the fields
    :func:`format_from_numpy` takes (SELL/HYB without their plans)."""
    fmt = {SELL: "sell", HYB: "hyb", BCSR: "bcsr", Stencil: "stencil"}[type(obj)]
    out = {}
    for k, v in obj._asdict().items():
        if k == "row_groups":
            continue
        out[k] = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
    return fmt, out


def engine_state_from_numpy(cols, vals, dinv, n: int, n_pad: int,
                            precond: str = "jacobi", fused="auto",
                            device=DEFAULT_DEVICE,
                            ic0: dict | None = None,
                            formats: dict | None = None) -> AzulEngine:
    """The port's local engine over a packed operator.

    ``cols``/``vals``: (n_pad, w) padded ELL, ``dinv``: (n_pad,) inverse
    diagonal (zeros past ``n``), ``n``: the true row count; ``ic0``: for
    ``precond="block_ic0"``, the factors as :func:`ic0_factors_from_numpy`
    takes them; ``formats``: {"sell" | "hyb" | "bcsr": the container's
    fields} (:func:`format_from_numpy`) of the same operator.  The arrays
    are validated here, once, so the kernels can gather without bounds
    checks.
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
    objs = {}
    for fmt, arrays in (formats or {}).items():
        obj = format_from_numpy(fmt, arrays, device=device)
        if obj.n_rows != n or obj.n_cols != n:
            raise ValueError(f"{fmt} container is {obj.n_rows} x "
                             f"{obj.n_cols}, the operator {n} x {n}")
        vt = obj.blocks if fmt == "bcsr" else obj.vals
        if vt.dtype != resolve_dtype(vals.dtype)[1]:
            raise TypeError(f"{fmt} container is {vt.dtype}, the operator "
                            f"{vals.dtype}")
        if fmt != "bcsr" and obj.rows_padded != n_pad:
            raise ValueError(f"{fmt} container has {obj.rows_padded} padded "
                             f"rows, the operator {n_pad}")
        objs[fmt] = obj
    return AzulEngine.from_state(cols, vals, dinv.astype(vals.dtype), n,
                                 precond=precond, fused=fused, device=device,
                                 ic0_factors=factors, fmt_objs=objs)


def engine_state_to_numpy(engine: AzulEngine) -> dict:
    """``{"cols", "vals", "dinv", "n", "n_pad"}`` of a port engine, as
    host arrays, ``"ic0"`` (:func:`ic0_factors_to_numpy`) for a
    block-IC(0) engine and ``"formats"`` for the SELL/HYB/BCSR containers
    it has built."""
    if engine.ell is None:
        raise ValueError("a stencil engine stores no operator; carry its "
                         "Stencil with format_to_numpy")
    out = {
        "cols": engine.ell.cols.cpu().numpy(),
        "vals": engine.ell.vals.cpu().numpy(),
        "dinv": engine._dinv_pad.cpu().numpy(),
        "n": engine.n,
        "n_pad": engine.n_pad,
    }
    if engine._ic0 is not None:
        out["ic0"] = ic0_factors_to_numpy(engine._ic0)
    if engine._fmt_objs:
        out["formats"] = {fmt: format_to_numpy(obj)[1]
                          for fmt, obj in engine._fmt_objs.items()}
    return out
