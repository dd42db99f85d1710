"""Tile meshes: Azul's grid of tiles, held on one device.

Port of ``repro.launch.mesh``.  The JAX package places one tile on each
device of a ``jax.sharding.Mesh``; the port puts every tile of the mesh on
one device, in one process.  A :class:`TileMesh` is the grid's shape, its
axis names and that device; tile ``t`` is the row-major flat index over
the axes (the order ``jax.make_mesh`` lays its devices in), and a
tile-stacked tensor holds tile ``t``'s shard at index ``t`` of its tile
axis (``repro_torch.core.noc``).  A mesh therefore needs no device per
tile: a (16, 16) production mesh is 256 tiles on one card.

The mesh also caches the host-built index tensors of its NoC operations
(:meth:`TileMesh.index`), so a captured solve loop reads them and never
copies an index to the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["TileMesh", "make_production_mesh", "make_mesh", "batch_axes",
           "AXES"]

AXES = {"single": ("data", "model"), "multi": ("pod", "data", "model")}


class TileMesh:
    """A grid of tiles on one device.

    ``shape`` maps each axis name to its size (in axis order, as
    ``jax.sharding.Mesh.shape``), ``axis_names`` is their order, ``size``
    the number of tiles and ``device`` the ``torch.device`` every tile's
    shard lives on."""

    def __init__(self, shape, axis_names, device=DEFAULT_DEVICE):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or not shape:
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             "must be non-empty and of one length")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names repeat: {axis_names}")
        if min(shape) < 1:
            raise ValueError(f"mesh axes need at least one tile: {shape}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.size = int(np.prod(shape))
        self.device = resolve_device(device)
        self._coords = np.stack(np.unravel_index(np.arange(self.size), shape),
                                axis=1)                       # (P, naxes)
        self._index: dict = {}

    @property
    def devices_shape(self) -> tuple:
        return tuple(self.shape[a] for a in self.axis_names)

    def axes(self, axes) -> tuple:
        """``axes`` (a name or a sequence of names) as a tuple, checked
        against the mesh."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"mesh has no axis {a!r} "
                                 f"(axes {self.axis_names})")
        if len(set(axes)) != len(axes):
            raise ValueError(f"axis names repeat: {axes}")
        return axes

    def group(self, axes) -> tuple[np.ndarray, np.ndarray]:
        """(coord, members) for the axis group ``axes``: ``coord[t]`` is
        tile t's row-major coordinate over ``axes`` (in their order, as
        ``lax.axis_index``), ``members[t]`` the tiles that share t's
        coordinates on every other axis, ordered by that coordinate."""
        axes = self.axes(axes)
        key = ("group", axes)
        got = self._index.get(key)
        if got is not None:
            return got
        pos = [self.axis_names.index(a) for a in axes]
        sizes = [self.shape[a] for a in axes]
        coord = np.ravel_multi_index(tuple(self._coords[:, pos].T), sizes) \
            if axes else np.zeros(self.size, np.int64)
        p = int(np.prod(sizes)) if axes else 1
        members = np.empty((self.size, p), np.int64)
        for t in range(self.size):
            c = self._coords[t].copy()
            for g in range(p):
                c[pos] = np.unravel_index(g, sizes)
                members[t, g] = np.ravel_multi_index(tuple(c),
                                                     self.devices_shape)
        got = (np.asarray(coord, np.int64), members)
        self._index[key] = got
        return got

    def index(self, key, build) -> torch.Tensor:
        """The int64 index tensor ``build()`` (a numpy array) makes, on the
        mesh's device, built once per ``key``.  Building one while a CUDA
        graph is being captured raises: an engine builds every index its
        plans read before their first capture."""
        got = self._index.get(key)
        if got is None:
            if (self.device.type == "cuda"
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError(f"NoC index {key!r} was not built before "
                                   "the capture")
            got = torch.as_tensor(np.asarray(build(), np.int64),
                                  device=self.device)
            self._index[key] = got
        return got

    def __repr__(self) -> str:
        return (f"TileMesh({self.devices_shape}, {self.axis_names}, "
                f"device={self.device})")


def make_mesh(shape, axes, device=DEFAULT_DEVICE) -> TileMesh:
    """A :class:`TileMesh` of ``shape`` over ``axes`` on ``device``
    ("cuda" by default, which raises where there is no card)."""
    return TileMesh(shape, axes, device)


def make_production_mesh(*, multi_pod: bool = False,
                         device=DEFAULT_DEVICE) -> TileMesh:
    """The JAX package's production grid: (16, 16) tiles over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return make_mesh(shape, AXES["multi" if multi_pod else "single"], device)


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes the global batch shards over (everything except 'model')."""
    return tuple(a for a in mesh.axis_names if a != "model")
