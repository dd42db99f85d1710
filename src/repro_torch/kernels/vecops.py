"""CUDA kernels for the one-pass CG vector update and the axpy + dot
stage, with their launch wrappers.

``x' = x + alpha*p``, ``r' = r - alpha*ap``, ``z = dinv*r'`` (or ``r'``),
``rr = dot(r', r')`` and ``rz = dot(r', z)`` in one pass, per lane for a
batch.  Replace the Pallas TPU kernel ``repro.kernels.vecops.cg_update``
(``src/repro/kernels/vecops.py:157``): :func:`cg_update` its 1-D bodies
(``:89``, ``:105``), :func:`cg_update_batched` its batched ones (``:124``,
``:140``).  :func:`axpy_dot` (z = y + a*x and dot(z, z)) replaces
``vecops.axpy_dot`` (``:49``).  The kernels are ``csrc/vecops.cu``, whose
header gives their bounds and design.  The plain PyTorch versions are
:func:`cg_update_plain` and :func:`axpy_dot_plain`.
"""

from __future__ import annotations

import torch

from . import build
from .ref import axpy_dot_ref as axpy_dot_plain
from .ref import cg_update_ref as cg_update_plain

__all__ = ["cg_update", "cg_update_batched", "cg_update_plain", "axpy_dot",
           "axpy_dot_plain"]

_PER_BLOCK = 256 * 4      # csrc: kThreads * kElems


def cg_update(alpha, x, r, p, ap, dinv=None):
    """Returns ``(x', r', z, rr, rz)`` on the card for (n,) vectors;
    ``alpha`` is a scalar (a 0-d device tensor on the solver path), ``dinv``
    the (n,) Jacobi inverse diagonal or None for the identity (then ``z`` is
    ``r'`` and ``rz`` is ``rr``).  ``rr``/``rz`` are 0-d tensors."""
    n = x.shape[-1] if x.dim() == 1 else -1
    for name, v in (("r", r), ("p", p), ("ap", ap)) + (
            (("dinv", dinv),) if dinv is not None else ()):
        if v.shape != x.shape:
            raise ValueError(f"cg_update: {name} {tuple(v.shape)} vs x "
                             f"{tuple(x.shape)}")
    if n <= 0:
        raise ValueError(f"cg_update expects non-empty (n,) vectors, got "
                         f"{tuple(x.shape)} (cg_update_batched takes (k, n))")
    dt, dev = x.dtype, x.device
    alpha = build.device_scalar(alpha, dt, dev)
    vecs = dict(alpha=alpha, x=x, r=r, p=p, ap=ap)
    if dinv is not None:
        vecs["dinv"] = dinv
    build.require_cuda("cg_update", dt, dev, **vecs)
    nblocks = -(-n // _PER_BLOCK)
    nsums = 1 if dinv is None else 2
    xo = torch.empty(n, dtype=dt, device=dev)
    ro = torch.empty(n, dtype=dt, device=dev)
    zo = None if dinv is None else torch.empty(n, dtype=dt, device=dev)
    partials = torch.empty(nsums * nblocks, dtype=dt, device=dev)
    out = torch.empty(nsums, dtype=dt, device=dev)
    fn = build.entry("repro_cg_update", dt)
    build.check(fn(alpha.data_ptr(), x.data_ptr(), r.data_ptr(), p.data_ptr(),
                   ap.data_ptr(), None if dinv is None else dinv.data_ptr(),
                   xo.data_ptr(), ro.data_ptr(),
                   None if zo is None else zo.data_ptr(), partials.data_ptr(),
                   out.data_ptr(), n, nblocks,
                   build.launch_counter("cg_update", dev),
                   build.stream_handle(dev)), "cg_update")
    if dinv is None:
        return xo, ro, ro, out[0], out[0]
    return xo, ro, zo, out[0], out[1]


def cg_update_batched(alpha, x, r, p, ap, dinv=None):
    """Returns ``(x', r', z, rr, rz)`` on the card for k right-hand sides in
    the solver layout: ``x``/``r``/``p``/``ap`` (k, n) row-major,
    ``alpha`` k per-lane values (the solver's (k, 1) device tensor),
    ``dinv`` the (n,) Jacobi inverse diagonal shared by the lanes or None
    (then ``z`` is ``r'`` and ``rz`` is ``rr``).  ``rr``/``rz`` are (k, 1),
    the solvers' dot convention."""
    if x.dim() != 2 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"cg_update_batched expects non-empty (k, n) "
                         f"vectors, got {tuple(x.shape)}")
    k, n = x.shape
    for name, v in (("r", r), ("p", p), ("ap", ap)):
        if v.shape != x.shape:
            raise ValueError(f"cg_update_batched: {name} {tuple(v.shape)} vs "
                             f"x {tuple(x.shape)}")
    if dinv is not None and dinv.shape != (n,):
        raise ValueError(f"cg_update_batched: dinv {tuple(dinv.shape)} vs "
                         f"n {n}")
    dt, dev = x.dtype, x.device
    alpha = build.device_lanes(alpha, k, dt, dev)
    vecs = dict(alpha=alpha, x=x, r=r, p=p, ap=ap)
    if dinv is not None:
        vecs["dinv"] = dinv
    build.require_cuda("cg_update_batched", dt, dev, **vecs)
    nblocks = -(-n // _PER_BLOCK)
    nsums = 1 if dinv is None else 2
    xo = torch.empty(k, n, dtype=dt, device=dev)
    ro = torch.empty(k, n, dtype=dt, device=dev)
    zo = None if dinv is None else torch.empty(k, n, dtype=dt, device=dev)
    partials = torch.empty(nsums * k, nblocks, dtype=dt, device=dev)
    out = torch.empty(nsums, k, 1, dtype=dt, device=dev)
    fn = build.entry("repro_cg_update_batched", dt)
    build.check(fn(alpha.data_ptr(), x.data_ptr(), r.data_ptr(), p.data_ptr(),
                   ap.data_ptr(), None if dinv is None else dinv.data_ptr(),
                   xo.data_ptr(), ro.data_ptr(),
                   None if zo is None else zo.data_ptr(), partials.data_ptr(),
                   out.data_ptr(), n, nblocks, k,
                   build.launch_counter("cg_update_batched", dev),
                   build.stream_handle(dev)), "cg_update_batched")
    if dinv is None:
        return xo, ro, ro, out[0], out[0]
    return xo, ro, zo, out[0], out[1]


def axpy_dot(a, x: torch.Tensor, y: torch.Tensor):
    """Returns ``(z, zz)`` on the card: z = y + a*x and zz = dot(z, z), a
    0-d tensor, for (n,) vectors of any n; ``a`` is a number or a 0-d
    device tensor (read through a pointer: no host sync)."""
    if x.dim() != 1 or x.numel() == 0 or y.shape != x.shape:
        raise ValueError(f"axpy_dot expects two non-empty (n,) vectors, got "
                         f"x {tuple(x.shape)}, y {tuple(y.shape)}")
    dt, dev = x.dtype, x.device
    a = build.device_scalar(a, dt, dev)
    build.require_cuda("axpy_dot", dt, dev, a=a, x=x, y=y)
    n = x.shape[0]
    nblocks = -(-n // _PER_BLOCK)
    z = torch.empty(n, dtype=dt, device=dev)
    partials = torch.empty(nblocks, dtype=dt, device=dev)
    zz = torch.empty(1, dtype=dt, device=dev)
    fn = build.entry("repro_axpy_dot", dt)
    build.check(fn(a.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(),
                   partials.data_ptr(), zz.data_ptr(), n, nblocks,
                   build.launch_counter("axpy_dot", dev),
                   build.stream_handle(dev)), "axpy_dot")
    return z, zz.reshape(())
