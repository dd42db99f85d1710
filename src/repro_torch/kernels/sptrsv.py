"""CUDA kernels for the level-scheduled lower-triangular solve: the whole
solve with an in-stream dot, and one wavefront; with the pack and the
launch wrappers.

``x = L^-1 b`` over a padded ELL factor, walked level by level, and
``pp = dot(wdot, x)``.  Replaces the Pallas TPU kernel
``repro.kernels.sptrsv.sptrsv_solve_dot`` (``src/repro/kernels/sptrsv.py:132``);
the kernel is ``csrc/sptrsv.cu``, whose header gives its bound and
design.  The plain PyTorch version is :func:`sptrsv_solve_dot_plain`.

The kernel takes the schedule as compact level lists, not the Pallas
kernel's pre-gathered (levels, width, w) planes: :func:`solve_pack` builds
them once per factor.

:func:`sptrsv_level_step` solves one level and replaces
``repro.kernels.sptrsv.sptrsv_level_step`` (``:64``) with the gather and
scatter of its ``ops`` wrapper; its plain version is
:func:`sptrsv_level_step_plain`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import build
from .ref import sptrsv_level_step_ref as sptrsv_level_step_plain
from .ref import sptrsv_solve_dot_ref as sptrsv_solve_dot_plain

__all__ = ["SptrsvPack", "solve_pack", "sptrsv_solve_dot",
           "sptrsv_solve_dot_plain", "grid_blocks", "sptrsv_level_step",
           "sptrsv_level_step_plain"]

_THREADS = 256      # csrc/common.cuh kThreads


class SptrsvPack(NamedTuple):
    """The call-invariant schedule of one factor, as the kernel reads it.

    ``level_ptr``:  (n_levels + 1,) int32; level l's rows are
                    ``level_rows[level_ptr[l]:level_ptr[l + 1]]``.
    ``level_rows``: (rows solved,) int32 row ids in the schedule's order.
    ``rows_p``:     the factor's padded row count.
    ``max_width``:  rows in the widest level.
    """

    level_ptr: torch.Tensor
    level_rows: torch.Tensor
    rows_p: int
    max_width: int

    @property
    def n_levels(self) -> int:
        return self.level_ptr.shape[0] - 1


def solve_pack(sched_rows, n_rows: int, rows_p: int,
               device) -> SptrsvPack:
    """Compact level lists from a (n_levels, W) schedule padded with a
    sentinel >= ``n_rows`` (a numpy array or a tensor), on ``device``.
    Raises for a row id outside [0, n_rows) that is not the sentinel, or a
    row scheduled twice: the kernel writes x[r] for every listed row."""
    rows = (sched_rows.cpu().numpy() if isinstance(sched_rows, torch.Tensor)
            else np.asarray(sched_rows))
    if rows.ndim != 2 or rows.shape[0] == 0:
        raise ValueError(f"schedule must be (n_levels, W), got {rows.shape}")
    if not 0 < n_rows <= rows_p:
        raise ValueError(f"need 0 < n_rows <= rows_p, got {n_rows}, {rows_p}")
    if rows.min() < 0:
        raise ValueError("schedule holds a negative row id")
    real = rows < n_rows
    level_rows = rows[real].astype(np.int32)           # row-major: in order
    if np.bincount(level_rows, minlength=n_rows).max() > 1:
        raise ValueError("schedule lists a row twice")
    counts = real.sum(axis=1)
    level_ptr = np.zeros(rows.shape[0] + 1, np.int32)
    np.cumsum(counts, out=level_ptr[1:])
    return SptrsvPack(torch.from_numpy(level_ptr).to(device),
                      torch.from_numpy(level_rows).to(device), rows_p,
                      int(counts.max()))


_CORESIDENT: dict = {}


def grid_blocks(pack: SptrsvPack, dtype: torch.dtype,
                device: torch.device) -> int:
    """The kernel's grid: the blocks that can be co-resident on ``device``
    (occupancy x SMs), cut to the blocks the widest level can use."""
    key = (dtype, device.index)
    if key not in _CORESIDENT:
        with torch.cuda.device(device):
            got = build.entry("repro_sptrsv_coresident", dtype)()
        if got <= 0:
            raise RuntimeError(f"sptrsv_solve_dot: no cooperative launch on "
                               f"{device} (CUDA error {-got})")
        _CORESIDENT[key] = got
    need = -(-max(pack.max_width, 1) // _THREADS)
    return min(_CORESIDENT[key], need)


def sptrsv_solve_dot(cols: torch.Tensor, vals: torch.Tensor,
                     dinv: torch.Tensor, b: torch.Tensor, pack: SptrsvPack,
                     wdot: torch.Tensor | None = None, blocks: int | None = None):
    """Returns ``(x, pp)`` on the card: ``x`` (rows_p,) solves the
    lower-triangular padded ELL factor ``cols``/``vals`` (rows_p, w) with
    inverse diagonal ``dinv`` (rows_p,) for ``b`` (rows_p,) in the level
    order of ``pack``; padded rows of x are 0.  ``pp`` is dot(wdot, x), a
    0-d tensor, or 0 for ``wdot=None``.  ``blocks`` overrides the grid
    (:func:`grid_blocks`); a grid the card cannot hold co-resident is
    refused by the driver, and then this raises."""
    if cols.dim() != 2 or cols.shape != vals.shape:
        raise ValueError(f"sptrsv_solve_dot: cols {tuple(cols.shape)} vs "
                         f"vals {tuple(vals.shape)}")
    rows_p, w = cols.shape
    if rows_p != pack.rows_p or w == 0:
        raise ValueError(f"sptrsv_solve_dot: factor {tuple(cols.shape)} vs "
                         f"pack rows_p {pack.rows_p}")
    vecs = dict(dinv=dinv, b=b) | ({} if wdot is None else dict(wdot=wdot))
    for name, v in vecs.items():
        if v.shape != (rows_p,):
            raise ValueError(f"sptrsv_solve_dot: {name} {tuple(v.shape)} vs "
                             f"rows_p {rows_p}")
    dt, dev = vals.dtype, vals.device
    build.require_cuda("sptrsv_solve_dot", dt, dev, cols=cols, vals=vals,
                       level_ptr=pack.level_ptr, level_rows=pack.level_rows,
                       **vecs)
    if blocks is None:
        blocks = grid_blocks(pack, dt, dev)
    x = torch.zeros(rows_p, dtype=dt, device=dev)
    partials = torch.empty(blocks, dtype=dt, device=dev)
    pp = torch.empty(1, dtype=dt, device=dev)
    fn = build.entry("repro_sptrsv_solve_dot", dt)
    build.check(fn(cols.data_ptr(), vals.data_ptr(), dinv.data_ptr(),
                   b.data_ptr(), None if wdot is None else wdot.data_ptr(),
                   pack.level_ptr.data_ptr(), pack.level_rows.data_ptr(),
                   x.data_ptr(), partials.data_ptr(), pp.data_ptr(),
                   pack.n_levels, w, blocks, build.stream_handle(dev)),
                "sptrsv_solve_dot")
    sptrsv_solve_dot.launches += 1
    return x, pp.reshape(())


sptrsv_solve_dot.launches = 0


def sptrsv_level_step(cols: torch.Tensor, vals: torch.Tensor,
                      diag: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                      level_rows: torch.Tensor,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """One level of the lower solve on the card (the contract of
    :func:`sptrsv_level_step_plain`): ``cols``/``vals`` (rows_p, w) padded
    ELL of L, ``diag`` its diagonal (at least n entries), ``b`` (rows_p,),
    ``x`` (n + 1,) with the sentinel slot n, ``level_rows`` (W,) int32 ids
    >= 0.  The solved values are written into ``out`` and ``out`` is
    returned: by default a copy of ``x``, which stays untouched.  ``out``
    may be ``x`` itself (a solve that updates x level by level; the
    kernel's header says why that is legal)."""
    if cols.dim() != 2 or cols.shape != vals.shape:
        raise ValueError(f"sptrsv_level_step: cols {tuple(cols.shape)} vs "
                         f"vals {tuple(vals.shape)}")
    rows_p, w = cols.shape
    n = x.shape[0] - 1 if x.dim() == 1 else 0
    if rows_p == 0 or w == 0 or n < 1:
        raise ValueError(f"sptrsv_level_step: factor {tuple(cols.shape)}, x "
                         f"{tuple(x.shape)} (n + 1 slots, n >= 1)")
    if b.shape != (rows_p,) or diag.dim() != 1 or diag.shape[0] < n:
        raise ValueError(f"sptrsv_level_step: b {tuple(b.shape)} vs rows_p "
                         f"{rows_p}, diag {tuple(diag.shape)} vs n {n}")
    if level_rows.dim() != 1 or level_rows.numel() == 0:
        raise ValueError(f"sptrsv_level_step: level_rows "
                         f"{tuple(level_rows.shape)}")
    dt, dev = vals.dtype, vals.device
    build.require_cuda("sptrsv_level_step", dt, dev, cols=cols, vals=vals,
                       diag=diag, b=b, x=x, level_rows=level_rows)
    if out is None:
        out = x.clone()
    build.require_cuda("sptrsv_level_step", dt, dev, out=out)
    if out.shape != x.shape:
        raise ValueError(f"sptrsv_level_step: out {tuple(out.shape)} vs x "
                         f"{tuple(x.shape)}")
    fn = build.entry("repro_sptrsv_level_step", dt)
    build.check(fn(cols.data_ptr(), vals.data_ptr(), diag.data_ptr(),
                   b.data_ptr(), level_rows.data_ptr(), x.data_ptr(),
                   out.data_ptr(), level_rows.numel(), rows_p, w, n,
                   build.stream_handle(dev)), "sptrsv_level_step")
    sptrsv_level_step.launches += 1
    return out


sptrsv_level_step.launches = 0
