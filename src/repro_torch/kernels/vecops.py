"""CUDA kernel for the one-pass CG vector update, with its launch wrapper.

``x' = x + alpha*p``, ``r' = r - alpha*ap``, ``z = dinv*r'`` (or ``r'``),
``rr = dot(r', r')`` and ``rz = dot(r', z)`` in one pass.  Replaces the 1-D
bodies of the Pallas TPU kernel ``repro.kernels.vecops.cg_update``
(``src/repro/kernels/vecops.py:157``, bodies ``:89`` and ``:105``); the
kernel is ``csrc/vecops.cu``, whose header gives its bound and design.
The plain PyTorch version is :func:`cg_update_plain`.
"""

from __future__ import annotations

import torch

from . import build
from .ref import cg_update_ref as cg_update_plain

__all__ = ["cg_update", "cg_update_plain"]

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
                         f"{tuple(x.shape)} (batched bodies: batched slice)")
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
                   out.data_ptr(), n, nblocks, build.stream_handle(dev)),
                "cg_update")
    cg_update.launches += 1
    if dinv is None:
        return xo, ro, ro, out[0], out[0]
    return xo, ro, zo, out[0], out[1]


cg_update.launches = 0
