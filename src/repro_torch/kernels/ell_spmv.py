"""CUDA kernel for ELLPACK SpMV, y = A x, with its launch wrapper.

Replaces the Pallas TPU kernel ``repro.kernels.ell_spmv.ell_spmv``
(``src/repro/kernels/ell_spmv.py:53``); the kernel itself is
``csrc/ell_spmv.cu``, whose header gives its bound and design.  The plain
PyTorch version beside it is :func:`ell_spmv_plain` (``ref.ell_spmv_ref``).
"""

from __future__ import annotations

import torch

from . import build
from .ref import ell_spmv_ref as ell_spmv_plain

__all__ = ["ell_spmv", "ell_spmv_plain", "group_size"]


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
