"""Device and dtype resolution shared by the port's entry points.

Entry points take ``device="cuda"`` by default.  A CUDA request on a
machine without a card raises instead of falling back to the CPU: the CPU
path (the kernels' plain versions) runs only when the caller asks for it
with ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "resolve_dtype"]

DEFAULT_DEVICE = "cuda"

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` for ``device``; raises RuntimeError for a CUDA
    device when no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def resolve_dtype(dtype) -> tuple[np.dtype, torch.dtype]:
    """(numpy dtype, torch dtype) for a float32/float64 given either way."""
    if isinstance(dtype, torch.dtype):
        for nd, td in _TORCH_DTYPES.items():
            if td == dtype:
                return nd, td
    else:
        nd = np.dtype(dtype)
        if nd in _TORCH_DTYPES:
            return nd, _TORCH_DTYPES[nd]
    raise ValueError(f"dtype must be float32 or float64, got {dtype!r}")
