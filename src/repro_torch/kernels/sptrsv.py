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
them once per factor, with the per-level grid and (given the factor's
columns) the dependency codes that the cluster variant reads.  The solve
has two variants (:data:`SOLVE_VARIANTS`); :func:`solve_variant` picks one
from the schedule's and the factor's shape and the alignment of its
values.

:func:`sptrsv_level_step` solves one level and replaces
``repro.kernels.sptrsv.sptrsv_level_step`` (``:64``) with the gather and
scatter of its ``ops`` wrapper; its plain version is
:func:`sptrsv_level_step_plain`.  It has three variants
(:data:`LEVEL_VARIANTS`) that give the same bits; the two of the redesign
compile the ELL width and launch programmatic-dependent on the kernel
before them, and :func:`level_step_variant` picks one from the width, the
dtype, the alignment of cols and vals and the index range.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import build
from .ref import sptrsv_level_step_ref as sptrsv_level_step_plain
from .ref import sptrsv_solve_dot_ref as sptrsv_solve_dot_plain

__all__ = ["SptrsvPack", "solve_pack", "dependency_codes",
           "sptrsv_solve_dot", "sptrsv_solve_dot_plain", "grid_blocks",
           "solve_variant", "cluster_geometry", "cluster_max_threads",
           "SOLVE_VARIANTS", "sptrsv_level_step",
           "sptrsv_level_step_plain", "LEVEL_VARIANTS", "LEVEL_WIDTHS",
           "LEVEL_THREADS", "level_step_variant", "pdl_ready"]

_THREADS = 256      # csrc/common.cuh kThreads

# "cluster": one thread-block cluster, hardware barrier, rows prefetched;
# "cooperative": a grid barrier
SOLVE_VARIANTS = ("cluster", "cooperative")
CLUSTER_MAX_BLOCKS = 16          # non-portable cluster size on the H100
CLUSTER_BLOCK_THREADS = 32       # the fewest threads a cluster block has
CLUSTER_MAX_THREADS = 256        # csrc/sptrsv.cu kClusterThreads
# sptrsv_level_step: "vec" (compiled W, 16-byte row loads), "wave"
# (compiled W, scalar loads), both programmatic-dependent launches;
# "first" (the first design: any W, 64-bit ids, a plain launch)
LEVEL_VARIANTS = ("vec", "wave", "first")
LEVEL_WIDTHS = (1, 2, 3, 4, 5, 6, 7, 8, 16)     # csrc/sptrsv.cu launch_wave
LEVEL_THREADS = 64                              # csrc/sptrsv.cu kLevelThreads
_INT32_MAX = (1 << 31) - 1
# csrc/sptrsv.cu: the cluster kernel's dependency codes
DEP_SKIP, DEP_ZERO = -1, -(1 << 31)
DEP_WINDOW, DEP_SLOT_BITS = 8, 12


class SptrsvPack(NamedTuple):
    """The call-invariant schedule of one factor, as the kernel reads it.

    ``level_ptr``:  (n_levels + 1,) int32; level l's rows are
                    ``level_rows[level_ptr[l]:level_ptr[l + 1]]``.
    ``level_rows``: (rows solved,) int32 row ids in the schedule's order.
    ``rows_p``:     the factor's padded row count.
    ``max_width``:  rows in the widest level.
    ``level_grid``: (n_levels, max_width) int32; level l's rows in order,
                    then -1: slot s of every level is one cluster thread's.
    ``dep``:        (rows_p, w) int32 dependency codes of the cluster
                    variant (:func:`dependency_codes`), or None for a pack
                    built without the factor's columns;
    ``dep_global``: whether a code reads x from global memory;
    ``cols_key``:   the identity of the cols tensor ``dep`` was built from
                    (its address, version and shape), or None: the codes
                    hold for that tensor only (:meth:`built_from`).
    """

    level_ptr: torch.Tensor
    level_rows: torch.Tensor
    rows_p: int
    max_width: int
    level_grid: torch.Tensor
    dep: torch.Tensor | None = None
    dep_global: bool = False
    cols_key: tuple | None = None

    @property
    def n_levels(self) -> int:
        return self.level_ptr.shape[0] - 1

    def built_from(self, cols: torch.Tensor) -> bool:
        """Whether ``dep`` holds for ``cols``: the pack was built from this
        very tensor, unmodified since."""
        return (self.dep is not None and self.cols_key is not None
                and self.cols_key == _cols_key(cols))


def _cols_key(cols: torch.Tensor) -> tuple:
    return (cols.data_ptr(), cols._version, tuple(cols.shape))


def dependency_codes(cols: np.ndarray, level_grid: np.ndarray) -> np.ndarray:
    """The cluster kernel's code for each slot of a factor's padded ELL
    ``cols`` (rows_p, w) under the schedule's ``level_grid``, as int32:

    * DEP_SKIP (-1): the diagonal slot (col == row): no product;
    * DEP_ZERO (int32 min): the column is not solved before the row's level
      (padding, an unscheduled row, the row's own level): x there is 0;
    * (level % DEP_WINDOW) << DEP_SLOT_BITS | slot: solved fewer than
      DEP_WINDOW levels earlier, at that slot: read from the window of
      x the kernel keeps in distributed shared memory;
    * -(col + 2): solved earlier still: read from x in global memory.

    Rows the schedule does not list get DEP_SKIP throughout."""
    rows_p = cols.shape[0]
    level_of = np.full(rows_p, -1, np.int64)
    slot_of = np.zeros(rows_p, np.int64)
    lv, sl = np.nonzero(level_grid >= 0)
    ids = level_grid[lv, sl]
    level_of[ids], slot_of[ids] = lv, sl
    c = cols.astype(np.int64)
    inside = (c >= 0) & (c < rows_p)
    cc = np.where(inside, c, 0)
    lr = level_of[:, None]
    lc = np.where(inside, level_of[cc], -1)
    earlier = (lc >= 0) & (lc < lr)
    near = earlier & (lr - lc < DEP_WINDOW)
    code = np.full(c.shape, DEP_ZERO, np.int64)
    code[earlier] = -(c[earlier] + 2)
    code[near] = ((lc % DEP_WINDOW) << DEP_SLOT_BITS | slot_of[cc])[near]
    code[c == np.arange(rows_p)[:, None]] = DEP_SKIP
    code[level_of < 0] = DEP_SKIP
    return code.astype(np.int32)


def solve_pack(sched_rows, n_rows: int, rows_p: int, device,
               cols=None) -> SptrsvPack:
    """Compact level lists from a (n_levels, W) schedule padded with a
    sentinel >= ``n_rows`` (a numpy array or a tensor), on ``device``;
    with the factor's ``cols`` (rows_p, w), also the cluster variant's
    dependency codes, which bind the pack to that cols tensor (a numpy
    ``cols`` gives codes bound to no tensor).  Raises for a row id outside
    [0, n_rows) that is not the sentinel, or a row scheduled twice: the
    kernel writes x[r] for every listed row."""
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
    width = max(int(counts.max()), 1)
    grid = np.full((rows.shape[0], width), -1, np.int32)
    grid[np.arange(width)[None, :] < counts[:, None]] = level_rows
    dev = torch.device(device)
    dep, far, key = None, False, None
    if cols is not None and width <= 1 << DEP_SLOT_BITS:
        host = (cols.cpu().numpy() if isinstance(cols, torch.Tensor)
                else np.asarray(cols))
        if host.shape[0] != rows_p:
            raise ValueError(f"cols {host.shape} vs rows_p {rows_p}")
        codes = dependency_codes(host, grid)
        far = bool(((codes < DEP_SKIP) & (codes != DEP_ZERO)).any())
        dep = torch.from_numpy(codes).to(dev)
        if isinstance(cols, torch.Tensor):
            key = _cols_key(cols)
    return SptrsvPack(torch.from_numpy(level_ptr).to(dev),
                      torch.from_numpy(level_rows).to(dev), rows_p,
                      int(counts.max()), torch.from_numpy(grid).to(dev), dep,
                      far, key)


def cluster_max_threads(width: int) -> int:
    """The most threads a cluster block can have for a factor of ELL width
    ``width``: its four stages of rows and its window fit the 227 KB of
    shared memory a block has (csrc/sptrsv.cu cluster_smem)."""
    return CLUSTER_MAX_THREADS if width <= 8 else CLUSTER_MAX_THREADS // 2


def cluster_geometry(max_width: int, width: int = 8):
    """(blocks, threads) of the cluster variant for a widest level of
    ``max_width`` rows of a factor of ELL width ``width``: one row a
    thread, spread over as many blocks (SMs) as whole warps allow, at most
    CLUSTER_MAX_BLOCKS (a level's scattered loads cost each SM time in
    proportion to its rows: PERF.md), a power of two threads a block.
    Raises if the level does not fit."""
    rows = max(int(max_width), 1)
    blocks = min(CLUSTER_MAX_BLOCKS, -(-rows // CLUSTER_BLOCK_THREADS))
    threads = max(32, 1 << (-(-rows // blocks) - 1).bit_length())
    if threads > cluster_max_threads(width):
        raise ValueError(f"a level of {rows} rows does not fit a cluster of "
                         f"{blocks} blocks of at most "
                         f"{cluster_max_threads(width)} threads")
    return blocks, threads


def solve_variant(n_levels: int, max_width: int, width: int,
                  aligned: bool = True) -> str:
    """The ``sptrsv_solve_dot`` kernel for a schedule of ``n_levels``
    levels whose widest has ``max_width`` rows, over a factor of ELL width
    ``width`` whose values are ``aligned`` to 16 bytes: "cluster" where the
    widest level fits one cluster at a row a thread and the rows are whole
    aligned 16-byte vectors of at most 16 slots, else "cooperative".  A
    pure function of its arguments."""
    fits = CLUSTER_MAX_BLOCKS * cluster_max_threads(width)
    if aligned and n_levels >= 1 and 0 < width <= 16 and width % 4 == 0 \
            and 1 <= max_width <= fits:
        return "cluster"
    return "cooperative"


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
                     wdot: torch.Tensor | None = None, blocks: int | None = None,
                     variant: str | None = None):
    """Returns ``(x, pp)`` on the card: ``x`` (rows_p,) solves the
    lower-triangular padded ELL factor ``cols``/``vals`` (rows_p, w) with
    inverse diagonal ``dinv`` (rows_p,) for ``b`` (rows_p,) in the level
    order of ``pack``; padded rows of x are 0.  ``pp`` is dot(wdot, x), a
    0-d tensor, or 0 for ``wdot=None``.

    By default the variant is :func:`solve_variant`'s where ``pack`` was
    built from this ``cols`` tensor (:meth:`SptrsvPack.built_from`), and
    "cooperative" otherwise: the cluster variant reads the pack's
    dependency codes in place of ``cols``.  ``variant`` forces one of
    :data:`SOLVE_VARIANTS` (the cluster variant raises where the shape,
    the alignment or the pack does not admit it).  ``blocks`` selects the
    cooperative variant with that grid (:func:`grid_blocks` by default): a
    grid the card cannot hold co-resident is refused by CUDA, and then
    this raises."""
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
                       level_grid=pack.level_grid, **vecs)
    aligned = vals.data_ptr() % 16 == 0
    if variant is None:
        variant = ("cooperative" if blocks is not None
                   or not pack.built_from(cols)
                   else solve_variant(pack.n_levels, pack.max_width, w,
                                      aligned))
    if variant not in SOLVE_VARIANTS:
        raise ValueError(f"sptrsv_solve_dot: variant {variant!r} not in "
                         f"{SOLVE_VARIANTS}")
    if blocks is not None and variant != "cooperative":
        raise ValueError("sptrsv_solve_dot: blocks sets the cooperative "
                         "variant's grid")
    wptr = None if wdot is None else wdot.data_ptr()
    x = torch.zeros(rows_p, dtype=dt, device=dev)
    pp = torch.empty(1, dtype=dt, device=dev)
    tail = (build.launch_counter("sptrsv_solve_dot", dev),
            build.stream_handle(dev))
    head = (cols.data_ptr(), vals.data_ptr(), dinv.data_ptr(), b.data_ptr(),
            wptr)
    if variant == "cluster":
        if solve_variant(1, 1, w, aligned) != "cluster":
            raise ValueError(f"sptrsv_solve_dot: the cluster variant takes W "
                             f"a multiple of 4 up to 16 and 16-byte aligned "
                             f"vals; got W = {w}")
        if not pack.built_from(cols):
            raise ValueError("sptrsv_solve_dot: the cluster variant needs a "
                             "pack built from this cols tensor")
        build.require_cuda("sptrsv_solve_dot", torch.int32, dev,
                           level_dep=pack.dep)
        blocks, threads = cluster_geometry(pack.max_width, w)
        partials = torch.empty(blocks, dtype=dt, device=dev)
        err = build.entry("repro_sptrsv_cluster", dt)(
            pack.dep.data_ptr(), *head[1:], pack.level_grid.data_ptr(),
            x.data_ptr(), partials.data_ptr(), pp.data_ptr(), pack.n_levels,
            pack.level_grid.shape[1], w, int(pack.dep_global), blocks,
            threads, *tail)
    else:
        if blocks is None:
            blocks = grid_blocks(pack, dt, dev)
        partials = torch.empty(blocks, dtype=dt, device=dev)
        err = build.entry("repro_sptrsv_solve_dot", dt)(
            *head, pack.level_ptr.data_ptr(), pack.level_rows.data_ptr(),
            x.data_ptr(), partials.data_ptr(), pp.data_ptr(), pack.n_levels,
            w, blocks, *tail)
    build.check(err, "sptrsv_solve_dot")
    return x, pp.reshape(())


def level_step_variant(width: int, dtype: torch.dtype, aligned: bool = True,
                       index32: bool = True) -> str:
    """The ``sptrsv_level_step`` kernel for a factor of ELL width ``width``
    in ``dtype`` (float32 or float64; else TypeError) whose cols and vals
    are ``aligned`` to 16 bytes and whose ids fit 32 bits (``index32``:
    rows_p * width and n + 1 at most 2^31 - 1): "vec" where the width is
    compiled (:data:`LEVEL_WIDTHS`), a row is whole 16-byte vectors of
    cols and of values (width % 4 == 0, in either dtype) and the operands
    are aligned; "wave" at the other compiled widths; else "first".  A
    pure function of its arguments."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sptrsv_level_step: dtype must be float32 or "
                        f"float64, got {dtype}")
    if width not in LEVEL_WIDTHS or not index32:
        return "first"
    return "vec" if aligned and width % 4 == 0 else "wave"


_PDL_READY: set = set()


def pdl_ready(device: torch.device) -> None:
    """Check once a device that the card launches programmatic-dependent
    kernels and that stream capture keeps the programmatic edge between
    them (CUDA 12.3 or later); raises if not.  The check captures a graph
    of its own, so its first call must come before any capture."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx in _PDL_READY:
        return
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"sptrsv_level_step: the first launch on cuda:{idx} is inside a "
            "CUDA graph capture; launch once (or call sptrsv.pdl_ready) "
            "before capturing")
    with torch.cuda.device(idx):
        err = build.plain_entry("repro_pdl_capture_check")()
    if err != 0:
        raise RuntimeError(
            f"sptrsv_level_step: stream capture on cuda:{idx} does not keep "
            f"programmatic launch edges (CUDA error {err}; needs CUDA 12.3 "
            "or later); force variant='first'")
    _PDL_READY.add(idx)


def sptrsv_level_step(cols: torch.Tensor, vals: torch.Tensor,
                      diag: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                      level_rows: torch.Tensor,
                      out: torch.Tensor | None = None,
                      variant: str | None = None,
                      pdl: bool = True) -> torch.Tensor:
    """One level of the lower solve on the card (the contract of
    :func:`sptrsv_level_step_plain`): ``cols``/``vals`` (rows_p, w) padded
    ELL of L, ``diag`` its diagonal (at least n entries), ``b`` (rows_p,),
    ``x`` (n + 1,) with the sentinel slot n, ``level_rows`` (W,) int32 ids
    >= 0.  The solved values are written into ``out`` and ``out`` is
    returned: by default a copy of ``x``, which stays untouched.  ``out``
    may be ``x`` itself (a solve that updates x level by level; the
    kernel's header says why that is legal).

    ``variant`` forces one of :data:`LEVEL_VARIANTS` (:func:`level_step_variant`'s
    by default; "vec" and "wave" raise where the width, the alignment or
    the index range does not admit them).  Every variant gives the same
    bits.  ``pdl=False`` launches "vec" and "wave" without the
    programmatic edge (the A/B in chip_smoke.py); "first" never has it."""
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
    aligned = (cols.data_ptr() | vals.data_ptr()) % 16 == 0
    index32 = rows_p * w <= _INT32_MAX and n < _INT32_MAX
    rule = level_step_variant(w, dt, aligned, index32)
    if variant is None:
        variant = rule
    elif variant not in LEVEL_VARIANTS:
        raise ValueError(f"sptrsv_level_step: variant {variant!r} not in "
                         f"{LEVEL_VARIANTS}")
    elif variant != "first" and (rule == "first" or (variant == "vec"
                                                     and rule != "vec")):
        raise ValueError(
            f"sptrsv_level_step: variant {variant!r} takes W in "
            f"{LEVEL_WIDTHS} and 32-bit ids ('vec' also W % 4 == 0 and "
            f"16-byte aligned cols and vals); got W = {w}, aligned "
            f"{aligned}, rows_p * W = {rows_p * w}")
    head = (cols.data_ptr(), vals.data_ptr(), diag.data_ptr(), b.data_ptr(),
            level_rows.data_ptr(), x.data_ptr(), out.data_ptr(),
            level_rows.numel(), rows_p, w, n)
    tail = (build.launch_counter("sptrsv_level_step", dev),
            build.stream_handle(dev))
    if variant == "first":
        err = build.entry("repro_sptrsv_level_step", dt)(*head, *tail)
    else:
        if pdl:
            pdl_ready(dev)
        err = build.entry("repro_sptrsv_level_wave", dt)(
            *head, int(variant == "vec"), int(pdl), *tail)
    build.check(err, "sptrsv_level_step")
    return out
