"""CUDA kernels for ELL SpMV + dot, the p-fold SpMV + dot and their
multi-RHS twins, with their launch wrappers.

``y = A x`` and ``pap = dot(x, y)`` from one matrix stream
(:func:`ell_spmv_dot`, :func:`ell_spmm_dot`); the p-fold variants also
compute ``p' = z + beta*p`` at gather time and return it
(:func:`ell_spmv_pfold_dot`, :func:`ell_spmm_pfold_dot`), per lane for a
batch.  Replace the Pallas TPU kernels ``repro.kernels.spmv_dot``
``ell_spmv_dot``, ``ell_spmm_dot``, ``ell_spmv_pfold_dot`` and
``ell_spmm_pfold_dot`` (``src/repro/kernels/spmv_dot.py:67``, ``:134``,
``:217`` and ``:296``); the kernels are ``csrc/spmv_dot.cu``, whose header
gives their bounds and design.  The plain PyTorch versions are the
``*_plain`` names beside them.
"""

from __future__ import annotations

import torch

from . import build
from .ell_spmv import group_size
from .ref import ell_spmm_dot_ref as ell_spmm_dot_plain
from .ref import ell_spmm_pfold_dot_ref as ell_spmm_pfold_dot_plain
from .ref import ell_spmv_dot_ref as ell_spmv_dot_plain
from .ref import ell_spmv_pfold_dot_ref as ell_spmv_pfold_dot_plain

__all__ = ["ell_spmv_dot", "ell_spmv_dot_plain", "ell_spmm_dot",
           "ell_spmm_dot_plain", "check_square",
           "ell_spmv_pfold_dot", "ell_spmv_pfold_dot_plain",
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


def check_square(cols: torch.Tensor, x: torch.Tensor, batched: bool) -> None:
    """The JAX kernels' operand checks (``src/repro/kernels/spmv_dot.py:83,
    146, 151``): x is (rows_p,), or (rows_p, k) when ``batched``."""
    rows = cols.shape[0]
    if batched:
        if x.dim() != 2:
            raise ValueError(f"ell_spmm_dot expects x of shape (n, k), got "
                             f"{tuple(x.shape)}")
        if x.shape[0] != rows:
            raise ValueError(f"ell_spmm_dot needs a square padded operator: "
                             f"x {tuple(x.shape)} vs rows {rows}")
    elif tuple(x.shape) != (rows,):
        raise ValueError(f"ell_spmv_dot needs a square padded operator: x "
                         f"{tuple(x.shape)} vs rows {rows}")


def ell_spmv_dot(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor):
    """Returns ``(y, pap)`` on the card: y = A x and pap = dot(x, y), a 0-d
    tensor, for a square padded ELL operator and x (rows_p,)."""
    if cols.dim() != 2 or cols.shape != vals.shape:
        raise ValueError(f"ell_spmv_dot: cols {tuple(cols.shape)} vs vals "
                         f"{tuple(vals.shape)}")
    check_square(cols, x, batched=False)
    rows, w = cols.shape
    if rows == 0 or w == 0:
        raise ValueError("ell_spmv_dot: empty operator")
    dt, dev = vals.dtype, vals.device
    build.require_cuda("ell_spmv_dot", dt, dev, cols=cols, vals=vals, x=x)
    group = group_size(w)
    nblocks = -(-rows // (_THREADS // group))
    y = torch.empty(rows, dtype=dt, device=dev)
    partials = torch.empty(nblocks, dtype=dt, device=dev)
    pap = torch.empty(1, dtype=dt, device=dev)
    fn = build.entry("repro_ell_spmv_dot", dt)
    build.check(fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
                   partials.data_ptr(), pap.data_ptr(), rows, w, group,
                   nblocks, build.stream_handle(dev)), "ell_spmv_dot")
    ell_spmv_dot.launches += 1
    return y, pap.reshape(())


ell_spmv_dot.launches = 0


def ell_spmm_dot(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor):
    """Returns ``(Y, pap)`` on the card for k right-hand sides in the JAX
    kernel's layout: x (rows_p, k) -> Y = A X (rows_p, k) and pap (k,),
    pap[j] = dot(X[:, j], Y[:, j]).  ``x`` is row-major, or the transposed
    view ``v.T`` of a contiguous (k, rows_p) tensor (the solver layout,
    taken without a copy); Y comes back in x's layout."""
    if cols.dim() != 2 or cols.shape != vals.shape:
        raise ValueError(f"ell_spmm_dot: cols {tuple(cols.shape)} vs vals "
                         f"{tuple(vals.shape)}")
    check_square(cols, x, batched=True)
    rows, w = cols.shape
    k = x.shape[1]
    if rows == 0 or w == 0 or k == 0:
        raise ValueError("ell_spmm_dot: empty operator or batch")
    dt, dev = vals.dtype, vals.device
    build.require_cuda("ell_spmm_dot", dt, dev, cols=cols, vals=vals)
    if x.device != dev or x.dtype != dt:
        raise ValueError(f"ell_spmm_dot: x is {x.dtype} on {x.device}, the "
                         f"matrix {dt} on {dev}")
    if x.is_contiguous():
        y = torch.empty(rows, k, dtype=dt, device=dev)
    elif x.t().is_contiguous():
        y = torch.empty(k, rows, dtype=dt, device=dev).t()
    else:
        raise ValueError(f"ell_spmm_dot: x strides {x.stride()}: need a "
                         "row-major (rows_p, k) tensor or the transposed view "
                         "of a contiguous (k, rows_p) one")
    sr, sl = y.stride()                # equal to x's where its size > 1
    group = group_size(w)
    nblocks = -(-rows // (_THREADS // group))
    partials = torch.empty(k, nblocks, dtype=dt, device=dev)
    pap = torch.empty(k, dtype=dt, device=dev)
    fn = build.entry("repro_ell_spmm_dot", dt)
    build.check(fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
                   partials.data_ptr(), pap.data_ptr(), rows, w, group,
                   nblocks, k, sr, sl, build.stream_handle(dev)),
                "ell_spmm_dot")
    ell_spmm_dot.launches += 1
    return y, pap


ell_spmm_dot.launches = 0
