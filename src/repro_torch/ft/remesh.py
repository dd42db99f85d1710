"""Spec validation for a mesh (port of ``validate_spec`` from
``repro.ft.remesh``).

A spec is the JAX ``PartitionSpec``'s entries as a tuple (:func:`spec`):
one entry per tensor dim, each ``None``, a mesh axis name, or a tuple of
axis names.  A
mesh is anything with a ``shape`` mapping axis name to size
(``launch.sharding.MeshShape``, ``launch.mesh.TileMesh``).
``remesh_restore``, which restores a checkpoint onto a mesh of several
cards, waits for placement on a ``launch.mesh.ProcessMesh`` (ROADMAP Queue
1 item 11b, on item 10's process grid).
"""

from __future__ import annotations

import math

__all__ = ["validate_spec", "spec"]


def spec(*entries) -> tuple:
    """The entries of ``PartitionSpec(*entries)``: a one-axis tuple is its
    axis name, an empty tuple ``None``."""
    return _normal(entries)


def _normal(entries) -> tuple:
    return tuple(None if e == () else e[0] if isinstance(e, tuple) and len(e) == 1
                 else e for e in entries)


def validate_spec(shape: tuple, spec: tuple, mesh) -> tuple:
    """Drop spec axes that don't divide the array on this mesh."""
    out = []
    for dim, s in enumerate(spec):
        if s is None:
            out.append(None)
            continue
        axes = (s,) if isinstance(s, str) else tuple(s)
        size = math.prod(int(mesh.shape[a]) for a in axes)
        if dim < len(shape) and shape[dim] % size == 0:
            out.append(s)
        else:
            out.append(None)
    return _normal(out)
