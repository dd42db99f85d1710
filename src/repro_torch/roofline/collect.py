"""Collective bytes of one train step on a process grid (the port's
counterpart of ``repro.roofline.collect``).

The JAX module parses the compiled HLO of a step for its collectives; the
port has no compiler to read, but it has the design of its own sharded
step (``train.step``, on a ``launch.mesh.ProcessMesh``), and this module
counts what that design puts on the wire: the bytes one rank receives in
one step, by the name of the ``ProcessMesh`` call that moves them (the
keys of ``mesh.stats.wire_bytes``).  Every rank receives the same bytes.
For a leaf whose spec, validated on the mesh, splits it over axes of
``p`` tiles in all (``launch.sharding.Placement``), and the ``b`` tiles
of the batch axes, each micro-batch:

* ``param_gather``: each layer's params gathered twice (the forward, and
  the backward's recompute), every other param once: ``(p - 1)`` times
  the slice's bytes a gather;
* ``grad_reduce_scatter``: every param's gradient (its dtype) to its
  slice, ``(b - 1)`` slices;
* ``batch_sum``: the loss's mask count (1 f32), each MoE layer's routing
  fractions (``E`` f32, in the forward and again in the recompute), each
  MTP head's count; ``(b - 1)`` of each;

and once a step ``batch_sum`` of the micro-batches' losses (``ga`` f32),
``clip`` one f32 a leaf, ``compress`` (int8 compression) one f32 a leaf,
each ``(p - 1)`` times, and ``adafactor``: a factored leaf's partial row
and column means and its row means' partial sums where the dim they
reduce is split (f32, over the tiles that split that dim), and one f32 a
leaf for its RMS.  AdamW moves nothing.  Checked against
``mesh.stats.wire_bytes`` of real steps (tests/test_torch_meshtrain.py;
``chip_smoke.py`` phase 12).
"""

from __future__ import annotations

import math
from collections import Counter

__all__ = ["train_step_bytes"]

_F32 = 4


def _split(pl, dim: int) -> int:
    """Tiles that split ``dim`` of a placement's leaf."""
    return math.prod(int(pl.mesh.shape[a]) for a in pl.dim_axes((dim % len(pl.shape),)))


def _tiles(pl) -> int:
    return math.prod(int(pl.mesh.shape[a]) for a in pl.axes)


def train_step_bytes(cfg, state, mesh, specs=None, grad_accum: int = 1,
                     compress_grads: bool = False) -> dict:
    """``{call: bytes}`` one rank receives in one step of the sharded train
    step of ``state`` (a ``TrainState``; shapes and dtypes are read, so it
    may live on ``meta``) placed by ``specs`` (default
    ``state_specs(state, cfg.fsdp, mesh)``) on ``mesh`` (a ``ProcessMesh``
    or a ``MeshShape``), plus ``"total_bytes"``."""
    from ..launch.mesh import batch_axes
    from ..launch.sharding import (Placement, _itemsize, leaf_shape,
                                   state_specs, tree_leaves)

    specs = state_specs(state, cfg.fsdp, mesh) if specs is None else specs
    b = math.prod(int(mesh.shape[a]) for a in batch_axes(mesh))
    leaves = tree_leaves(state.params)
    adafactor = "f" in state.opt_state
    out: Counter = Counter()
    for path, leaf in leaves.items():
        shape = leaf_shape(leaf)
        pl = Placement(mesh, specs.params[path], shape)
        size = _itemsize(leaf)
        stacked = path[0] == "groups"
        rows = shape[0] if stacked else 1
        row_bytes = math.prod(pl.local_shape[1:] if stacked else pl.local_shape) * size
        gathers = 2 if stacked else 1
        p = _tiles(pl)
        out["param_gather"] += grad_accum * gathers * rows * (p - 1) * row_bytes
        out["grad_reduce_scatter"] += grad_accum * rows * (b - 1) * row_bytes
        out["clip"] += (p - 1) * _F32
        if compress_grads:
            out["compress"] += (p - 1) * _F32
        if adafactor:
            out["adafactor"] += (p - 1) * _F32 + _factored_bytes(pl, stacked)
    moe = sum(n for kind, n in cfg.layer_groups() if kind == "attn_moe")
    per_micro = 1 + 2 * moe * cfg.n_experts + cfg.mtp_depth
    out["batch_sum"] += (b - 1) * _F32 * (grad_accum * per_micro + grad_accum)
    got = {k: v for k, v in out.items() if v}
    got["total_bytes"] = sum(got.values())
    return got


def _factored_bytes(pl, stacked: bool) -> int:
    """Adafactor's partial-mean bytes of one leaf (module docstring)."""
    if len(pl.shape) < 2:
        return 0
    rows, upl = 1, pl
    if stacked and len(pl.shape) > 2:
        rows, upl = pl.shape[0], pl.row()
    loc = upl.local_shape
    got = 0
    if _split(upl, -1) > 1:                       # vr: the mean over dim -1
        got += (_split(upl, -1) - 1) * math.prod(loc[:-1])
    if _split(upl, -2) > 1:                       # vc, then mean(vr, -1)
        got += (_split(upl, -2) - 1) * (math.prod(loc[:-2] + loc[-1:])
                                        + math.prod(loc[:-2]))
    return rows * got * _F32
