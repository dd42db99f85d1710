"""CUDA kernels for ELLPACK SpMV, y = A x, and its multi-RHS twin SpMM,
Y = A X, with their launch wrappers.

Replace the Pallas TPU kernels ``repro.kernels.ell_spmv.ell_spmv`` and
``ell_spmm`` (``src/repro/kernels/ell_spmv.py:53`` and ``:106``); the
kernels are ``csrc/ell_spmv.cu``, whose header gives their bounds and
design.  The plain PyTorch versions beside them are :func:`ell_spmv_plain`
and :func:`ell_spmm_plain` (``ref.ell_spmv_ref``, ``ref.ell_spmm_ref``).

``ell_spmv`` and ``ell_spmm`` each have two variants that compute the
same bits (:data:`SPMV_VARIANTS`); :func:`pick_variant` takes a forced
one, else the winner ``kernels.autotune`` recorded at the shape, else
:func:`spmv_variant`'s from the ELL width and the operands' alignment.
"""

from __future__ import annotations

import torch

from . import autotune, build
from .ref import ell_spmm_ref as ell_spmm_plain
from .ref import ell_spmv_ref as ell_spmv_plain

__all__ = ["ell_spmv", "ell_spmv_plain", "ell_spmm", "ell_spmm_plain",
           "group_size", "spmv_variant", "rows_grid", "pick_variant",
           "SPMV_VARIANTS"]

# "rows": a thread a row, 16-byte streaming loads (W a multiple of 4, at
# most 16, 16-byte aligned cols and vals); "group": G = group_size(W) lanes
# a row, any W
SPMV_VARIANTS = ("rows", "group")
_THREADS = 256                   # csrc/common.cuh kThreads
# blocks of spmv_dot.cu's rows kernel an SM holds, by group_size(W): its
# registers are capped to fit them (csrc/spmv_dot.cu rows_blocks_per_sm)
_ROWS_BLOCKS_PER_SM = {4: 5, 8: 5, 16: 3}


def group_size(width: int) -> int:
    """Lanes per row: the power of two >= ``width``, at most 32."""
    return min(32, 1 << max(int(width) - 1, 0).bit_length())


def spmv_variant(width: int, aligned: bool = True) -> str:
    """The ``ell_spmv`` kernel for ELL width ``width``: "rows" where a row
    is whole 16-byte vectors of at most 16 slots (the engine pads widths
    to multiples of 8) and the operands are ``aligned`` to 16 bytes, else
    "group"."""
    return ("rows" if aligned and 0 < width <= 16 and width % 4 == 0
            else "group")


def rows_grid(rows: int, width: int, sms: int = 132) -> int:
    """Blocks spmv_dot.cu's rows kernel launches (``ell_spmv``,
    ``ell_spmm`` and the four ``spmv_dot`` wrappers): a persistent grid of the blocks every SM
    holds at once (5 at W <= 8, 3 at W <= 16; the fastest of the A/B in
    PERF.md, float64 and float32 alike), never more than the rows need (a
    block's warps take 256 rows at a time, 512 at W = 4).  The kernel
    strides its grid over the rows, so any grid covers every row."""
    g = group_size(width)
    need = max(-(-int(rows) // (_THREADS * (2 if g == 4 else 1))), 1)
    return min(_ROWS_BLOCKS_PER_SM[g] * int(sms), need)


def pick_variant(name: str, cols: torch.Tensor, vals: torch.Tensor,
                 variant: str | None, k: int | None = None) -> str:
    """The variant a rows-or-group wrapper (``ell_spmv``, ``ell_spmm`` and
    the ``spmv_dot`` kernels) launches: ``variant`` if one is forced (a
    forced "rows" on an operand it cannot take raises); else the winner
    ``kernels.autotune`` recorded for ``name`` at (rows, W) or, for a
    batch of ``k``, (rows, W, k), in this dtype on this backend, where the
    operands admit it; else :func:`spmv_variant` of the width and the
    16-byte alignment of ``cols`` and ``vals``.  Every variant gives the
    same bits, so a cache entry changes only the time."""
    rows, w = cols.shape
    aligned = (cols.data_ptr() | vals.data_ptr()) % 16 == 0
    if variant is None:
        rule = spmv_variant(w, aligned)
        shape = (rows, w) if k is None else (rows, w, k)
        tuned = (autotune.lookup(name, shape, vals.dtype) or {}).get("variant")
        if tuned == "group" or (tuned == "rows" and rule == "rows"):
            return tuned
        return rule
    if variant not in SPMV_VARIANTS:
        raise ValueError(f"{name}: variant {variant!r} not in {SPMV_VARIANTS}")
    if variant == "rows" and spmv_variant(w, aligned) != "rows":
        raise ValueError(f"{name}: the rows variant takes W a multiple of 4 "
                         f"up to 16 and 16-byte aligned cols and vals; got "
                         f"W = {w}")
    return variant


def _spmm_rows(name: str, cols, vals, x, y, k: int, ldx: int) -> int:
    """One launch of spmv_dot.cu's rows kernel with the dot compiled out:
    Y (k, rows) = A X for X (k, ldx), row-major, on :func:`rows_grid`
    (``ell_spmv`` is its k = 1 call), counted as ``name``'s launch.
    Returns the CUDA error code."""
    rows, w = cols.shape
    sms = torch.cuda.get_device_properties(vals.device).multi_processor_count
    fn = build.entry("repro_ell_spmm_rows", vals.dtype)
    return fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
              rows, w, k, ldx, rows_grid(rows, w, sms),
              build.launch_counter(name, vals.device),
              build.stream_handle(vals.device))


def ell_spmv(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
             variant: str | None = None) -> torch.Tensor:
    """y = A @ x on the card.  ``cols`` (rows_p, W) int32 and ``vals``
    (rows_p, W) float32/float64 are padded ELL whose columns index into the
    1-D ``x``; padding slots hold value 0.  Raises for tensors that are not
    on one CUDA device.

    ``variant`` overrides :func:`spmv_variant` (one of
    :data:`SPMV_VARIANTS`; "rows" needs W a multiple of 4 up to 16 and
    16-byte aligned cols and vals, and raises otherwise).  Every variant
    gives the same bits."""
    if cols.dim() != 2 or cols.shape != vals.shape or x.dim() != 1:
        raise ValueError(f"ell_spmv: cols {tuple(cols.shape)}, vals "
                         f"{tuple(vals.shape)}, x {tuple(x.shape)}")
    build.require_cuda("ell_spmv", vals.dtype, vals.device,
                       cols=cols, vals=vals, x=x)
    rows, w = cols.shape
    if rows == 0 or w == 0 or x.numel() == 0:
        raise ValueError("ell_spmv: empty operator")
    variant = pick_variant("ell_spmv", cols, vals, variant)
    y = torch.empty(rows, dtype=vals.dtype, device=vals.device)
    if variant == "group":
        fn = build.entry("repro_ell_spmv", vals.dtype)
        err = fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
                 rows, w, group_size(w),
                 build.launch_counter("ell_spmv", vals.device),
                 build.stream_handle(vals.device))
    else:
        err = _spmm_rows("ell_spmv", cols, vals, x, y, 1, x.numel())
    build.check(err, "ell_spmv")
    return y


def ell_spmm(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
             variant: str | None = None) -> torch.Tensor:
    """Y = A @ X on the card for k right-hand sides in the solver layout:
    ``x`` (k, ncols) -> Y (k, rows_p), both row-major, ``cols``/``vals``
    as for :func:`ell_spmv`.  Raises for tensors that are not on one CUDA
    device or not contiguous (a transposed view included).  ``variant``
    as for :func:`ell_spmv`; lane j of Y does not depend on k or the
    variant and equals :func:`ell_spmv` on lane j bit for bit."""
    if cols.dim() != 2 or cols.shape != vals.shape or x.dim() != 2:
        raise ValueError(f"ell_spmm: cols {tuple(cols.shape)}, vals "
                         f"{tuple(vals.shape)}, x {tuple(x.shape)} (k, n)")
    build.require_cuda("ell_spmm", vals.dtype, vals.device,
                       cols=cols, vals=vals, x=x)
    rows, w = cols.shape
    k, ldx = x.shape
    if rows == 0 or w == 0 or k == 0 or ldx == 0:
        raise ValueError("ell_spmm: empty operator or batch")
    variant = pick_variant("ell_spmm", cols, vals, variant, k)
    y = torch.empty(k, rows, dtype=vals.dtype, device=vals.device)
    if variant == "group":
        fn = build.entry("repro_ell_spmm", vals.dtype)
        err = fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
                 rows, ldx, w, group_size(w), k,
                 build.launch_counter("ell_spmm", vals.device),
                 build.stream_handle(vals.device))
    else:
        err = _spmm_rows("ell_spmm", cols, vals, x, y, k, ldx)
    build.check(err, "ell_spmm")
    return y
