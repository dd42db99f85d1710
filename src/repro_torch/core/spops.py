"""Single-device sparse ops on packed formats (plain PyTorch).

Port of ``repro.core.spops`` for the first slice: the padded-ELL matvec
the reference substrate and ``AzulEngine.spmv`` run.  It is plain PyTorch
on whatever device its tensors lie on -- never a hand-written kernel.
"""

from __future__ import annotations

import torch

__all__ = ["spmv_ell_padded"]


def spmv_ell_padded(cols: torch.Tensor, vals: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Padded-row SpMV: (rows_p, w) gather + row sum.  Padding vals are 0,
    and padding cols point at 0, which is always in bounds."""
    return torch.sum(vals * x[cols], dim=1)
