"""Plain PyTorch versions of the kernels on the first slice's path.

Port of the matching oracles in ``repro.kernels.ref``.  Each function is
the mathematical contract its CUDA kernel implements: ``kernels.ops`` runs
it for tensors on the CPU, the CPU tests hold it against the JAX package,
and ``chip_smoke.py`` holds each kernel against it on the card.
"""

from __future__ import annotations

import torch

__all__ = ["ell_spmv_ref", "ell_spmv_pfold_dot_ref", "cg_update_ref"]


def ell_spmv_ref(cols: torch.Tensor, vals: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """y[r] = sum_k vals[r, k] * x[cols[r, k]].  Padding: vals == 0."""
    return torch.sum(vals * x[cols], dim=1)


def ell_spmv_pfold_dot_ref(cols, vals, z, p, beta):
    """p-fold contract: p' = z + beta*p, then (p', A @ p', dot(p', A @ p'))
    from the one matrix stream."""
    pn = z + beta * p
    y = torch.sum(vals * pn[cols], dim=1)
    return pn, y, torch.sum(pn * y)


def cg_update_ref(alpha, x, r, p, ap, dinv=None):
    """One-pass CG update contract for (n,) vectors:

        x' = x + alpha p;  r' = r - alpha ap;  z = dinv r' (or r');
        rr = dot(r', r');  rz = dot(r', z).
    """
    xo = x + alpha * p
    ro = r - alpha * ap
    rr = torch.sum(ro * ro)
    if dinv is None:
        return xo, ro, ro, rr, rr
    z = ro * dinv
    return xo, ro, z, rr, torch.sum(ro * z)
