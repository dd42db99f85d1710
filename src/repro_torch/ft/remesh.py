"""Elastic scaling: reshard a checkpoint onto a different mesh (port of
``repro.ft.remesh``).

Checkpoints store full (unsharded) leaves, so scaling a run from mesh A to
mesh B (grow after capacity arrives, shrink around a failed pod) is:

    specs_b = sharding.state_specs(state_like, fsdp, mesh_b)
    state, step, demoted = remesh_restore(state_like, ckpt_dir, mesh_b, specs_b)

A spec is the JAX ``PartitionSpec``'s entries as a tuple (:func:`spec`):
one entry per tensor dim, each ``None``, a mesh axis name, or a tuple of
axis names.  A mesh is anything with a ``shape`` mapping axis name to size
(``launch.sharding.MeshShape``, ``launch.mesh.TileMesh``,
``launch.mesh.ProcessMesh``).  Divisibility is revalidated against the new
mesh; incompatible axes fall back to replication, listed for the caller
to inspect -- the run continues, just less sharded.
"""

from __future__ import annotations

import math

__all__ = ["remesh_restore", "validate_spec", "spec"]


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


def remesh_restore(tree_like, ckpt_dir: str, mesh, spec_tree, step=None):
    """Restore a checkpoint onto ``mesh`` with per-leaf specs (revalidated).
    Returns (state, step, demoted) where demoted lists, in the tree's leaf
    order, the (shape, spec) of every leaf that fell back to replication.

    ``tree_like`` gives the structure (a ``TrainState``, a ``Model``,
    nested dicts; its tensors may live on ``meta``) and ``spec_tree`` its
    specs (``launch.sharding.state_specs`` and friends).  On a
    ``ProcessMesh`` every rank reads each whole leaf and keeps its slice
    (``checkpoint.restore(sharding_tree=)`` with ``sharding.named``'s
    placements), on its device."""
    from ..checkpoint.manager import restore
    from ..launch.sharding import Placement, named

    placements = named(mesh, spec_tree, tree_like)
    demoted = []

    def walk(pls, specs):
        if pls is None:
            return
        if isinstance(pls, Placement):
            pls, specs = {(): pls}, {(): specs}
        for path, pl in pls.items():
            if pl.spec != tuple(specs[path]):
                demoted.append((pl.shape, tuple(specs[path])))

    if isinstance(placements, tuple) and hasattr(placements, "_fields"):
        for pls, specs in zip(placements, spec_tree):
            walk(pls, specs)
    else:
        walk(placements, spec_tree)
    state, step = restore(tree_like, ckpt_dir, step=step, sharding_tree=placements)
    return state, step, demoted
