"""CUDA kernels for ELLPACK SpMV, y = A x, and its multi-RHS twin SpMM,
Y = A X, with their launch wrappers.

Replace the Pallas TPU kernels ``repro.kernels.ell_spmv.ell_spmv`` and
``ell_spmm`` (``src/repro/kernels/ell_spmv.py:53`` and ``:106``); the
kernels are ``csrc/ell_spmv.cu``, whose header gives their bounds and
design.  The plain PyTorch versions beside them are :func:`ell_spmv_plain`
and :func:`ell_spmm_plain` (``ref.ell_spmv_ref``, ``ref.ell_spmm_ref``).
"""

from __future__ import annotations

import torch

from . import build
from .ref import ell_spmm_ref as ell_spmm_plain
from .ref import ell_spmv_ref as ell_spmv_plain

__all__ = ["ell_spmv", "ell_spmv_plain", "ell_spmm", "ell_spmm_plain",
           "group_size"]


def group_size(width: int) -> int:
    """Lanes per row: the power of two >= ``width``, at most 32."""
    return min(32, 1 << max(int(width) - 1, 0).bit_length())


def ell_spmv(cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = A @ x on the card.  ``cols`` (rows_p, W) int32 and ``vals``
    (rows_p, W) float32/float64 are padded ELL whose columns index into the
    1-D ``x``; padding slots hold value 0.  Raises for tensors that are not
    on one CUDA device."""
    if cols.dim() != 2 or cols.shape != vals.shape or x.dim() != 1:
        raise ValueError(f"ell_spmv: cols {tuple(cols.shape)}, vals "
                         f"{tuple(vals.shape)}, x {tuple(x.shape)}")
    build.require_cuda("ell_spmv", vals.dtype, vals.device,
                       cols=cols, vals=vals, x=x)
    rows, w = cols.shape
    if rows == 0 or w == 0 or x.numel() == 0:
        raise ValueError("ell_spmv: empty operator")
    y = torch.empty(rows, dtype=vals.dtype, device=vals.device)
    fn = build.entry("repro_ell_spmv", vals.dtype)
    build.check(fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
                   y.data_ptr(), rows, w, group_size(w),
                   build.stream_handle(vals.device)), "ell_spmv")
    ell_spmv.launches += 1
    return y


ell_spmv.launches = 0


def ell_spmm(cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X on the card for k right-hand sides in the solver layout:
    ``x`` (k, ncols) -> Y (k, rows_p), both row-major, ``cols``/``vals``
    as for :func:`ell_spmv`.  Raises for tensors that are not on one CUDA
    device or not contiguous (a transposed view included)."""
    if cols.dim() != 2 or cols.shape != vals.shape or x.dim() != 2:
        raise ValueError(f"ell_spmm: cols {tuple(cols.shape)}, vals "
                         f"{tuple(vals.shape)}, x {tuple(x.shape)} (k, n)")
    build.require_cuda("ell_spmm", vals.dtype, vals.device,
                       cols=cols, vals=vals, x=x)
    rows, w = cols.shape
    k, ldx = x.shape
    if rows == 0 or w == 0 or k == 0 or ldx == 0:
        raise ValueError("ell_spmm: empty operator or batch")
    y = torch.empty(k, rows, dtype=vals.dtype, device=vals.device)
    fn = build.entry("repro_ell_spmm", vals.dtype)
    build.check(fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
                   y.data_ptr(), rows, ldx, w, group_size(w), k,
                   build.stream_handle(vals.device)), "ell_spmm")
    ell_spmm.launches += 1
    return y


ell_spmm.launches = 0
