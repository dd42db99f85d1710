"""Single-device sparse ops on packed formats (plain PyTorch).

Port of ``repro.core.spops`` for the ported paths: the padded-ELL matvec
and its multi-RHS twin, which the reference substrate and
``AzulEngine.spmv`` run.  They are plain PyTorch on whatever device their
tensors lie on -- never a hand-written kernel.
"""

from __future__ import annotations

import torch

__all__ = ["spmv_ell_padded", "spmm_ell_padded"]


def spmv_ell_padded(cols: torch.Tensor, vals: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Padded-row SpMV: (rows_p, w) gather + row sum.  Padding vals are 0,
    and padding cols point at 0, which is always in bounds."""
    return torch.sum(vals * x[cols], dim=1)


def spmm_ell_padded(cols: torch.Tensor, vals: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Batched multi-RHS SpMV in the solvers' stacked layout: x is (k, n),
    returns (k, rows_p).  x[:, cols] is (k, rows_p, w), weighted by the
    shared (rows_p, w) vals."""
    return torch.sum(vals * x[:, cols], dim=-1)
