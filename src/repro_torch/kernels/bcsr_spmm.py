"""CUDA kernel for block-sparse (BCSR) times multi-RHS dense, Y = A X,
with its launch wrapper.

Replaces the Pallas TPU kernel ``repro.kernels.bcsr_spmm.bcsr_spmm``
(``src/repro/kernels/bcsr_spmm.py:45``); the kernel is
``csrc/bcsr_spmm.cu``, whose header gives its bound and design.  The plain
PyTorch version beside it is :func:`bcsr_spmm_plain`
(``ref.bcsr_spmm_ref``, an einsum).
"""

from __future__ import annotations

import torch

from . import build
from .ref import bcsr_spmm_ref as bcsr_spmm_plain

__all__ = ["bcsr_spmm", "bcsr_spmm_plain", "check_nbc"]

MAX_BM, MAX_BN = 16, 128


def check_nbc(blocks: torch.Tensor, x: torch.Tensor, nbc: int | None) -> None:
    """The JAX package's x-extent checks: x is (m * bn, R), and exactly
    (nbc * bn, R) when ``nbc`` is given."""
    bn = blocks.shape[3]
    if x.dim() != 2 or x.shape[0] % bn:
        raise ValueError(f"x shape {tuple(x.shape)} incompatible with bn={bn}")
    if nbc is not None and x.shape[0] != nbc * bn:
        raise ValueError(
            f"x shape {tuple(x.shape)} incompatible with nbc={nbc}, bn={bn}: "
            f"expected ({nbc * bn}, R)")


def bcsr_spmm(block_cols: torch.Tensor, blocks: torch.Tensor,
              x: torch.Tensor, nbc: int | None = None,
              x_valid: int | None = None) -> torch.Tensor:
    """Y = A @ X on the card.

    ``block_cols`` (nbr, w) int32 and ``blocks`` (nbr, w, bm, bn)
    float32/float64, contiguous, with bm <= 16 and bn <= 128; ``x``
    (nbc * bn, R) of the blocks' dtype with unit stride along one axis:
    row-major, or lanes-major like the transposed view ``v.T`` of the
    solver's (R, n) layout.  Rows of x at or past ``x_valid`` (default:
    all rows) are read as 0.  Returns Y (nbr * bm, R), lanes-major (the
    transposed view of a contiguous (R, nbr * bm) tensor) when x is, else
    row-major.  ``block_cols`` must index block columns of x: the engine's
    packing guarantees it, no launch checks it, and a row the kernel would
    read past x reads as 0.  Raises for tensors that are not on one CUDA
    device or not laid out as above.
    """
    if (block_cols.dim() != 2 or blocks.dim() != 4
            or tuple(blocks.shape[:2]) != tuple(block_cols.shape)):
        raise ValueError(f"bcsr_spmm: block_cols {tuple(block_cols.shape)}, "
                         f"blocks {tuple(blocks.shape)}")
    check_nbc(blocks, x, nbc)
    build.require_cuda("bcsr_spmm", blocks.dtype, blocks.device,
                       cols_block=block_cols, blocks=blocks)
    if x.device != blocks.device or x.dtype != blocks.dtype:
        raise ValueError(f"bcsr_spmm: x is {x.dtype} on {x.device}, the "
                         f"blocks {blocks.dtype} on {blocks.device}")
    nbr, w, bm, bn = blocks.shape
    r = x.shape[1]
    lanes_major = r > 1 and x.stride(0) == 1
    if not (lanes_major or r == 1 or x.stride(1) == 1) or min(x.stride()) < 1:
        raise ValueError(f"bcsr_spmm: x strides {x.stride()}: need unit "
                         "stride along the rows or along the lanes")
    if nbr == 0 or w == 0 or r == 0:
        raise ValueError("bcsr_spmm: empty operator or batch")
    if bm > MAX_BM or bn > MAX_BN:
        raise ValueError(f"bcsr_spmm: blocks of {bm} x {bn}; the kernel takes "
                         f"bm <= {MAX_BM} and bn <= {MAX_BN}")
    rows = nbr * bm
    if lanes_major:
        y = torch.empty(r, rows, dtype=blocks.dtype, device=blocks.device).t()
    else:
        y = torch.empty(rows, r, dtype=blocks.dtype, device=blocks.device)
    valid = x.shape[0] if x_valid is None else max(0, min(int(x_valid),
                                                        x.shape[0]))
    fn = build.entry("repro_bcsr_spmm", blocks.dtype)
    build.check(fn(block_cols.data_ptr(), blocks.data_ptr(), x.data_ptr(),
                   y.data_ptr(), nbr, w, bm, bn, r, valid,
                   x.stride(0), x.stride(1), y.stride(0), y.stride(1),
                   build.stream_handle(blocks.device)), "bcsr_spmm")
    bcsr_spmm.launches += 1
    return y


bcsr_spmm.launches = 0
