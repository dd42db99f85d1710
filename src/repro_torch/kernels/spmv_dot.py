"""CUDA kernels for the p-fold SpMV + dot and its multi-RHS twin, with
their launch wrappers.

``p' = z + beta*p``, ``y = A p'`` and ``pap = dot(p', y)`` from one matrix
stream, per lane for a batch.  Replace the Pallas TPU kernels
``repro.kernels.spmv_dot.ell_spmv_pfold_dot`` and ``ell_spmm_pfold_dot``
(``src/repro/kernels/spmv_dot.py:217`` and ``:296``); the kernels are
``csrc/spmv_dot.cu``, whose header gives their bounds and design.  The
plain PyTorch versions are :func:`ell_spmv_pfold_dot_plain` and
:func:`ell_spmm_pfold_dot_plain`.
"""

from __future__ import annotations

import torch

from . import build
from .ell_spmv import group_size
from .ref import ell_spmm_pfold_dot_ref as ell_spmm_pfold_dot_plain
from .ref import ell_spmv_pfold_dot_ref as ell_spmv_pfold_dot_plain

__all__ = ["ell_spmv_pfold_dot", "ell_spmv_pfold_dot_plain",
           "ell_spmm_pfold_dot", "ell_spmm_pfold_dot_plain"]

_THREADS = 256      # csrc/common.cuh kThreads


def ell_spmv_pfold_dot(cols: torch.Tensor, vals: torch.Tensor,
                       z: torch.Tensor, p: torch.Tensor, beta):
    """Returns ``(p', y, pap)`` on the card for a square padded ELL
    operator: ``z``/``p`` have shape (rows_p,), ``beta`` is a scalar (a 0-d
    device tensor on the solver path); ``pap`` is a 0-d tensor."""
    if cols.dim() != 2 or cols.shape != vals.shape:
        raise ValueError(f"ell_spmv_pfold_dot: cols {tuple(cols.shape)} vs "
                         f"vals {tuple(vals.shape)}")
    rows, w = cols.shape
    if z.shape != (rows,) or p.shape != (rows,):
        raise ValueError(
            f"ell_spmv_pfold_dot needs square padded vectors: z "
            f"{tuple(z.shape)} / p {tuple(p.shape)} vs rows {rows}")
    if rows == 0 or w == 0:
        raise ValueError("ell_spmv_pfold_dot: empty operator")
    dt, dev = vals.dtype, vals.device
    beta = build.device_scalar(beta, dt, dev)
    build.require_cuda("ell_spmv_pfold_dot", dt, dev, cols=cols, vals=vals,
                       z=z, p=p, beta=beta)
    group = group_size(w)
    rows_per_block = _THREADS // group
    nblocks = -(-rows // rows_per_block)
    pn = torch.empty(rows, dtype=dt, device=dev)
    y = torch.empty(rows, dtype=dt, device=dev)
    partials = torch.empty(nblocks, dtype=dt, device=dev)
    pap = torch.empty(1, dtype=dt, device=dev)
    fn = build.entry("repro_ell_spmv_pfold_dot", dt)
    build.check(fn(cols.data_ptr(), vals.data_ptr(), z.data_ptr(),
                   p.data_ptr(), beta.data_ptr(), pn.data_ptr(), y.data_ptr(),
                   partials.data_ptr(), pap.data_ptr(), rows, w, group,
                   nblocks, build.stream_handle(dev)), "ell_spmv_pfold_dot")
    ell_spmv_pfold_dot.launches += 1
    return pn, y, pap.reshape(())


ell_spmv_pfold_dot.launches = 0


def ell_spmm_pfold_dot(cols: torch.Tensor, vals: torch.Tensor,
                       z: torch.Tensor, p: torch.Tensor, beta):
    """Returns ``(P', Y, pap)`` on the card for k right-hand sides in the
    solver layout: ``z``/``p`` (k, rows_p) row-major, ``beta`` k per-lane
    values (the solver's (k, 1) device tensor, or a number for every
    lane); ``pap`` is (k,)."""
    if cols.dim() != 2 or cols.shape != vals.shape:
        raise ValueError(f"ell_spmm_pfold_dot: cols {tuple(cols.shape)} vs "
                         f"vals {tuple(vals.shape)}")
    rows, w = cols.shape
    if z.dim() != 2 or z.shape[1] != rows or p.shape != z.shape:
        raise ValueError(
            f"ell_spmm_pfold_dot needs square padded (k, n) vectors: z "
            f"{tuple(z.shape)} / p {tuple(p.shape)} vs rows {rows}")
    k = z.shape[0]
    if rows == 0 or w == 0 or k == 0:
        raise ValueError("ell_spmm_pfold_dot: empty operator or batch")
    dt, dev = vals.dtype, vals.device
    beta = build.device_lanes(beta, k, dt, dev)
    build.require_cuda("ell_spmm_pfold_dot", dt, dev, cols=cols, vals=vals,
                       z=z, p=p, beta=beta)
    group = group_size(w)
    nblocks = -(-rows // (_THREADS // group))
    pn = torch.empty(k, rows, dtype=dt, device=dev)
    y = torch.empty(k, rows, dtype=dt, device=dev)
    partials = torch.empty(k, nblocks, dtype=dt, device=dev)
    pap = torch.empty(k, dtype=dt, device=dev)
    fn = build.entry("repro_ell_spmm_pfold_dot", dt)
    build.check(fn(cols.data_ptr(), vals.data_ptr(), z.data_ptr(),
                   p.data_ptr(), beta.data_ptr(), pn.data_ptr(), y.data_ptr(),
                   partials.data_ptr(), pap.data_ptr(), rows, w, group,
                   nblocks, k, build.stream_handle(dev)), "ell_spmm_pfold_dot")
    ell_spmm_pfold_dot.launches += 1
    return pn, y, pap


ell_spmm_pfold_dot.launches = 0
