"""Matrix-free stencil operators: the coefficient stream without the storage.

Port of ``repro.core.stencil``.  A :class:`Stencil` names a
constant-coefficient operator whose nonzeros are generated, not stored;
:func:`stencil_matvec` applies it as shifted adds on the grid view of the
solver vector -- no gathers, no cols/vals, O(n) memory.  The engine takes
a ``Stencil`` wherever it takes a CSR matrix
(``AzulEngine(lap2d_stencil(1024))``) and reports ``"stencil"`` as the
plan's format.  Coefficients equal the assembled generators':

* ``lap2d``: 5-point Poisson on (nx, ny), index = y*nx + x, diagonal 4
* ``lap3d``: 7-point Poisson on (n, n, n), first axis slowest, diagonal 6

The shifted adds are elementwise PyTorch ops, so the result does not
depend on the device's reduction order or on how many right-hand sides
share the call.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["Stencil", "lap2d_stencil", "lap3d_stencil", "stencil_matvec",
           "stencil_diag"]


class Stencil(NamedTuple):
    """A matrix-free constant-coefficient operator.

    ``kind``: "lap2d" | "lap3d"; ``dims``: grid extents, slowest axis
    first (the assembled generators' kron order).
    """

    kind: str
    dims: tuple

    @property
    def n(self) -> int:
        return math.prod(self.dims)

    @property
    def shape(self) -> tuple:
        return (self.n, self.n)

    @property
    def nnz_equiv(self) -> int:
        """Nonzeros the assembled operator would store: the diagonal plus
        2 per axis per interior neighbour pair."""
        total = self.n
        for m in self.dims:
            total += 2 * (m - 1) * (self.n // m)
        return total


def lap2d_stencil(nx: int, ny: int | None = None) -> Stencil:
    """Matrix-free twin of ``data.matrices.laplacian_2d(nx, ny)``."""
    ny = ny or nx
    if nx < 1 or ny < 1:
        raise ValueError(f"grid extents must be >= 1, got ({nx}, {ny})")
    return Stencil("lap2d", (int(ny), int(nx)))     # y is the slow axis


def lap3d_stencil(n: int) -> Stencil:
    """Matrix-free twin of ``data.matrices.laplacian_3d(n)``."""
    if n < 1:
        raise ValueError(f"grid extent must be >= 1, got {n}")
    return Stencil("lap3d", (int(n), int(n), int(n)))


def stencil_diag(st: Stencil) -> float:
    """The (constant) diagonal entry: 2 per grid axis."""
    return 2.0 * len(st.dims)


def _axis_1d(u: torch.Tensor, axis: int) -> torch.Tensor:
    """One tridiagonal (2, -1, -1) pass along ``axis`` with a zero
    boundary: 2*u - shift_down(u) - shift_up(u)."""
    m = u.shape[axis]
    z = torch.zeros_like(u.narrow(axis, 0, 1))
    dn = torch.cat([u.narrow(axis, 1, m - 1), z], dim=axis)
    up = torch.cat([z, u.narrow(axis, 0, m - 1)], dim=axis)
    return 2.0 * u - dn - up


def stencil_matvec(st: Stencil, x: torch.Tensor,
                   n_pad: int | None = None) -> torch.Tensor:
    """y = A x for the stencil on padded solver vectors.

    ``x`` is (n_pad,) or (k, n_pad) with n_pad >= st.n; entries past st.n
    are ignored and come back as zeros, as the stored formats' padded rows
    do.  One shifted-add pass per grid axis on the grid view.
    """
    n = st.n
    if n_pad is None:
        n_pad = x.shape[-1]
    lead = tuple(x.shape[:-1])
    u = x[..., :n].reshape(lead + tuple(st.dims))
    y = torch.zeros_like(u)
    for ax in range(len(st.dims)):
        y = y + _axis_1d(u, axis=ax + len(lead))
    y = y.reshape(lead + (n,))
    if n_pad == n:
        return y
    out = torch.zeros(lead + (n_pad,), dtype=y.dtype, device=y.device)
    out[..., :n] = y
    return out
