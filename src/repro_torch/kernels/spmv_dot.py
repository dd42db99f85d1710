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

Each wrapper launches one of two variants, which give the same bits in
every output (``ell_spmv.SPMV_VARIANTS``, picked by
``ell_spmv.pick_variant``: forced with ``variant=``, else an autotuned
winner at the shape, else from the ELL width and the 16-byte alignment
of cols and vals): "rows", a thread a row with
16-byte streaming loads, for W a multiple of 4 up to 16, on the grid of
:func:`rows_grid`; "group", the first slice's row groups, for any W.
The kernels are bound by memory: the matrix once for all lanes, plus z
and p read and p' and y written per lane (134.2 MB, 40.1 us at 3.35 TB/s,
for ``ell_spmv_pfold_dot`` at 1,048,576 x 8 in float64).  pap sums each
lane's rows in blocks of ``256 // group_size(W)`` rows (the first design's
thread blocks, :func:`pap_blocks`) in the same order under both variants,
then the blocks' partials in index order in a second launch, so a lane's
pap does not depend on the variant or on k.  The fold is recomputed at
each gather: a separate fold pass would add 16 bytes a row and lane in
float64.
"""

from __future__ import annotations

import torch

from . import build
from .ell_spmv import group_size, pick_variant, rows_grid
from .ref import ell_spmm_dot_ref as ell_spmm_dot_plain
from .ref import ell_spmm_pfold_dot_ref as ell_spmm_pfold_dot_plain
from .ref import ell_spmv_dot_ref as ell_spmv_dot_plain
from .ref import ell_spmv_pfold_dot_ref as ell_spmv_pfold_dot_plain

__all__ = ["ell_spmv_dot", "ell_spmv_dot_plain", "ell_spmm_dot",
           "ell_spmm_dot_plain", "check_square", "pap_blocks", "rows_grid",
           "ell_spmv_pfold_dot", "ell_spmv_pfold_dot_plain",
           "ell_spmm_pfold_dot", "ell_spmm_pfold_dot_plain"]

_THREADS = 256      # csrc/common.cuh kThreads


def pap_blocks(rows: int, width: int) -> int:
    """The partials of pap a lane: blocks of ``256 // group_size(width)``
    rows, the first design's thread blocks, under every variant."""
    return -(-int(rows) // (_THREADS // group_size(width)))


def _launch(name: str, cols, vals, z, p, beta, pn, y, partials, pap,
            k: int, sr: int, sl: int, variant: str) -> None:
    """One launch of ``name``'s kernel in ``variant``: the fold where ``p``
    is given, lane j of every vector at row * sr + j * sl."""
    rows, w = cols.shape
    dt, dev = vals.dtype, vals.device
    nblocks = partials.shape[-1]
    ptr = lambda t: 0 if t is None else t.data_ptr()
    head = (cols.data_ptr(), vals.data_ptr(), z.data_ptr())
    tail = (build.launch_counter(name, dev), build.stream_handle(dev))
    if variant == "rows":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        fn = build.entry("repro_spmv_dot_rows", dt)
        err = fn(*head, ptr(p), ptr(beta), ptr(pn), y.data_ptr(),
                 partials.data_ptr(), pap.data_ptr(), rows, w, nblocks, k,
                 sr, sl, rows_grid(rows, w, sms),
                 int(p is not None), *tail)
    else:
        fn = build.entry(f"repro_{name}", dt)
        fold = (p.data_ptr(), beta.data_ptr(), pn.data_ptr()) if p is not None else ()
        lanes = (k,) if name == "ell_spmm_pfold_dot" else \
            (k, sr, sl) if name == "ell_spmm_dot" else ()
        err = fn(*head, *fold, y.data_ptr(), partials.data_ptr(),
                 pap.data_ptr(), rows, w, group_size(w), nblocks, *lanes,
                 *tail)
    build.check(err, name)


def ell_spmv_pfold_dot(cols: torch.Tensor, vals: torch.Tensor,
                       z: torch.Tensor, p: torch.Tensor, beta,
                       variant: str | None = None):
    """Returns ``(p', y, pap)`` on the card for a square padded ELL
    operator: ``z``/``p`` have shape (rows_p,), ``beta`` is a scalar (a 0-d
    device tensor on the solver path); ``pap`` is a 0-d tensor.
    ``variant`` forces one of ``ell_spmv.SPMV_VARIANTS`` (a "rows" the
    operands do not admit raises); every variant gives the same bits."""
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
    variant = pick_variant("ell_spmv_pfold_dot", cols, vals, variant)
    pn = torch.empty(rows, dtype=dt, device=dev)
    y = torch.empty(rows, dtype=dt, device=dev)
    partials = torch.empty(pap_blocks(rows, w), dtype=dt, device=dev)
    pap = torch.empty(1, dtype=dt, device=dev)
    _launch("ell_spmv_pfold_dot", cols, vals, z, p, beta, pn, y, partials,
            pap, 1, 1, rows, variant)
    return pn, y, pap.reshape(())


def ell_spmm_pfold_dot(cols: torch.Tensor, vals: torch.Tensor,
                       z: torch.Tensor, p: torch.Tensor, beta,
                       variant: str | None = None):
    """Returns ``(P', Y, pap)`` on the card for k right-hand sides in the
    solver layout: ``z``/``p`` (k, rows_p) row-major, ``beta`` k per-lane
    values (the solver's (k, 1) device tensor, or a number for every
    lane); ``pap`` is (k,).  ``variant`` as for
    :func:`ell_spmv_pfold_dot`; lane j's outputs do not depend on k or
    the variant and equal :func:`ell_spmv_pfold_dot` on lane j."""
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
    variant = pick_variant("ell_spmm_pfold_dot", cols, vals, variant, k)
    pn = torch.empty(k, rows, dtype=dt, device=dev)
    y = torch.empty(k, rows, dtype=dt, device=dev)
    partials = torch.empty(k, pap_blocks(rows, w), dtype=dt, device=dev)
    pap = torch.empty(k, dtype=dt, device=dev)
    _launch("ell_spmm_pfold_dot", cols, vals, z, p, beta, pn, y, partials,
            pap, k, 1, rows, variant)
    return pn, y, pap


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


def ell_spmv_dot(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                 variant: str | None = None):
    """Returns ``(y, pap)`` on the card: y = A x and pap = dot(x, y), a 0-d
    tensor, for a square padded ELL operator and x (rows_p,).
    ``variant`` as for :func:`ell_spmv_pfold_dot`."""
    if cols.dim() != 2 or cols.shape != vals.shape:
        raise ValueError(f"ell_spmv_dot: cols {tuple(cols.shape)} vs vals "
                         f"{tuple(vals.shape)}")
    check_square(cols, x, batched=False)
    rows, w = cols.shape
    if rows == 0 or w == 0:
        raise ValueError("ell_spmv_dot: empty operator")
    dt, dev = vals.dtype, vals.device
    build.require_cuda("ell_spmv_dot", dt, dev, cols=cols, vals=vals, x=x)
    variant = pick_variant("ell_spmv_dot", cols, vals, variant)
    y = torch.empty(rows, dtype=dt, device=dev)
    partials = torch.empty(pap_blocks(rows, w), dtype=dt, device=dev)
    pap = torch.empty(1, dtype=dt, device=dev)
    _launch("ell_spmv_dot", cols, vals, x, None, None, None, y, partials, pap,
            1, 1, rows, variant)
    return y, pap.reshape(())


def ell_spmm_dot(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                 variant: str | None = None):
    """Returns ``(Y, pap)`` on the card for k right-hand sides in the JAX
    kernel's layout: x (rows_p, k) -> Y = A X (rows_p, k) and pap (k,),
    pap[j] = dot(X[:, j], Y[:, j]).  ``x`` is row-major, or the transposed
    view ``v.T`` of a contiguous (k, rows_p) tensor (the solver layout,
    taken without a copy); Y comes back in x's layout.  ``variant`` as for
    :func:`ell_spmv_pfold_dot`."""
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
    variant = pick_variant("ell_spmm_dot", cols, vals, variant, k)
    sr, sl = y.stride()                # equal to x's where its size > 1
    partials = torch.empty(k, pap_blocks(rows, w), dtype=dt, device=dev)
    pap = torch.empty(k, dtype=dt, device=dev)
    _launch("ell_spmm_dot", cols, vals, x, None, None, None, y, partials, pap,
            k, sr, sl, variant)
    return y, pap
