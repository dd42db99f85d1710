"""CUDA kernel for block-sparse (BCSR) times multi-RHS dense, Y = A X,
with its launch wrapper.

Replaces the Pallas TPU kernel ``repro.kernels.bcsr_spmm.bcsr_spmm``
(``src/repro/kernels/bcsr_spmm.py:45``); the kernel is
``csrc/bcsr_spmm.cu``, whose header gives its bound and design.  The plain
PyTorch version beside it is :func:`bcsr_spmm_plain`
(``ref.bcsr_spmm_ref``, an einsum).

The kernel has two variants that compute the same bits
(:data:`BCSR_VARIANTS`); :func:`pick_variant` picks one from the block
shape, the dtype, x's layout and the operands' alignment.
"""

from __future__ import annotations

import torch

from . import build
from .ref import bcsr_spmm_ref as bcsr_spmm_plain

__all__ = ["bcsr_spmm", "bcsr_spmm_plain", "check_nbc", "pick_variant",
           "x_vectorized", "lane_chunk", "launch_grid", "smem_layout",
           "BCSR_VARIANTS", "COMPILED_BN", "SMEM_BM"]

MAX_BM, MAX_BN = 16, 128
# "smem": bn compiled, x's block columns staged in shared memory, 16-byte
# loads; "first": the first slice's design, any operand (csrc/bcsr_spmm.cu)
BCSR_VARIANTS = ("smem", "first")
_CODE = {"first": 0, "smem": 1}
COMPILED_BN = (4, 8, 16)        # the block widths the smem variant compiles
SMEM_BM = (4, 8, 16)            # the block heights it takes
_THREADS = 256                  # csrc/common.cuh kThreads
_WIDE_LANES = 16                # csrc/bcsr_spmm.cu kWideLanes
_FIRST_LANES = 8                # csrc/common.cuh kMaxLanes
_SMEM_MAX = 232448              # shared memory a block may use on Hopper


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


def x_vectorized(x: torch.Tensor) -> bool:
    """Whether the smem variant may copy x's block columns by 16-byte
    cp.async: x
    is lanes-major (unit row stride; one lane always is) and every lane's
    column starts on a 16-byte boundary."""
    r, size = x.shape[1], x.element_size()
    return (x.stride(0) == 1 and x.data_ptr() % 16 == 0
            and (r == 1 or x.stride(1) * size % 16 == 0))


def lane_chunk(r: int, variant: str) -> int:
    """Lanes a thread carries: the power of two >= ``r``, at most 16 for
    smem and 8 for the first design; wider batches run in chunks of that
    many lanes."""
    cap = _FIRST_LANES if variant == "first" else _WIDE_LANES
    return min(cap, 1 << max(int(r) - 1, 0).bit_length())


def launch_grid(variant: str, nbr: int, bm: int, r: int) -> tuple[int, int]:
    """The (x, y) grid of blocks of 256 threads the variant launches, a
    row a thread: 256 / bm block rows a block for smem, 256 rows for the
    first design; one y per chunk of :func:`lane_chunk` lanes.  The
    wrapper passes both to the kernel, which refuses a grid that leaves a
    row or a lane without a thread."""
    if variant == "smem":
        gx = -(-int(nbr) // (_THREADS // bm))
    else:
        gx = -(-int(nbr) * bm // _THREADS)
    return gx, -(-int(r) // lane_chunk(r, variant))


def smem_layout(bm: int, bn: int, k: int, itemsize: int) -> dict:
    """The smem variant's staging buffer (csrc/bcsr_spmm.cu
    smem_row_stride): a block's 256 / bm block rows each get K lanes of
    bn values, padded to an odd number of 16-byte words; two buffers.
    Returns the row stride and the total in bytes."""
    words = k * bn * itemsize // 16
    stride = k * bn + (16 // itemsize if words % 2 == 0 else 0)
    per_block = _THREADS // bm
    return {"row_stride": stride * itemsize,
            "bytes": 2 * per_block * stride * itemsize}


def _smem_admits(bm: int, bn: int, itemsize: int, x_vec: bool,
                 aligned: bool) -> bool:
    return (bn in COMPILED_BN and bm in SMEM_BM and aligned and x_vec
            and smem_layout(bm, bn, _WIDE_LANES, itemsize)["bytes"]
            <= _SMEM_MAX)


def pick_variant(bm: int, bn: int, dtype: torch.dtype, x_vec: bool,
                 aligned: bool, variant: str | None = None) -> str:
    """The variant for (bm, bn) blocks of ``dtype``: ``x_vec`` is
    :func:`x_vectorized` of x, ``aligned`` whether the blocks start on a
    16-byte boundary.  "smem" where it applies, else "first";
    ``variant`` forces one, and a forced "smem" the operands do not admit
    raises."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    admits = _smem_admits(bm, bn, itemsize, x_vec, aligned)
    if variant is None:
        return "smem" if admits else "first"
    if variant not in BCSR_VARIANTS:
        raise ValueError(f"bcsr_spmm: variant {variant!r} not in "
                         f"{BCSR_VARIANTS}")
    if variant == "smem" and not admits:
        raise ValueError(
            f"bcsr_spmm: the smem variant takes bn in {COMPILED_BN}, bm in "
            f"{SMEM_BM}, 16-byte aligned blocks and lanes-major 16-byte "
            f"aligned x; got {bm} x {bn} blocks, x vectorized: {x_vec}, "
            f"blocks aligned: {aligned}")
    return variant


def bcsr_spmm(block_cols: torch.Tensor, blocks: torch.Tensor,
              x: torch.Tensor, nbc: int | None = None,
              x_valid: int | None = None,
              variant: str | None = None) -> torch.Tensor:
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
    read past x reads as 0.  ``variant`` forces one of
    :data:`BCSR_VARIANTS` (see :func:`pick_variant`); every variant gives
    the same bits.  Raises for tensors that are not on one CUDA device or
    not laid out as above.
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
    x_vec = x_vectorized(x)
    variant = pick_variant(bm, bn, blocks.dtype, x_vec,
                           blocks.data_ptr() % 16 == 0, variant)
    rows = nbr * bm
    if lanes_major:
        y = torch.empty(r, rows, dtype=blocks.dtype, device=blocks.device).t()
    else:
        y = torch.empty(rows, r, dtype=blocks.dtype, device=blocks.device)
    valid = x.shape[0] if x_valid is None else max(0, min(int(x_valid),
                                                        x.shape[0]))
    gx, gy = launch_grid(variant, nbr, bm, r)
    fn = build.entry("repro_bcsr_spmm", blocks.dtype)
    build.check(fn(block_cols.data_ptr(), blocks.data_ptr(), x.data_ptr(),
                   y.data_ptr(), nbr, w, bm, bn, r, valid,
                   x.stride(0), x.stride(1), y.stride(0), y.stride(1),
                   _CODE[variant], lane_chunk(r, variant), gx, gy,
                   build.launch_counter("bcsr_spmm", blocks.device),
                   build.stream_handle(blocks.device)),
                "bcsr_spmm")
    return y
