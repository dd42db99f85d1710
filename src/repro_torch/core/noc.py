"""The NoC layer: Azul's send/recv message passing over the tiles of one
device, or between the ranks of a process grid.

Port of ``repro.core.noc``.  The JAX package runs one tile per device and
wraps ``jax.lax`` collectives over named mesh axes; the port holds every
tile of a :class:`~repro_torch.launch.mesh.TileMesh` on one device, so a
shard is a slice of a **tile-stacked** tensor ``xs`` of shape
``(..., P, m)``: tile ``t``'s shard is ``xs[..., t, :]``, its vector axis
the last one (a (k, u) batched shard of the JAX package is the (k, P, u)
stack).  A padded global vector in the JAX package's layout (tile (i, j)
holds segment ``q = i*pc + j``) is its own stack: ``x.view(..., P, u)``.

Each primitive keeps its JAX name and semantics:

  neighbor_shift    -- one torus hop (ppermute), Azul's point-to-point send
  pull_shard        -- receive the shard a fixed hop count away: one step
                       of a compiled halo-exchange schedule (commplan)
  gather_along      -- assemble an x halo along a mesh axis (all_gather)
  reduce_along      -- combine partials along an axis (psum)
  reduce_scatter_along -- combine partials, each tile keeping its chunk
                       (psum_scatter)
  mesh_transpose    -- the L_row -> L_col vector-layout swap of 2d SpMV
  reverse_vector    -- global reversal of a contiguously sharded vector
  bcast_from        -- one tile broadcasting along an axis (masked psum)
  axis_coord        -- every tile's coordinate along an axis

A permutation is one ``index_select`` over the tile axis, a gather or a
scatter one ``index_select`` through an index built on the host once per
mesh (``TileMesh.index``), and a reduction adds the tiles' partials one
after another in group order 0..p-1 (no float atomics).  Identity hops
are elided as the JAX ``_ppermute`` elides them (p == 1 axes, zero
shifts): the input comes back and nothing is recorded.

:func:`recording` collects the collective each call stands for
(``all-reduce``, ``collective-permute``, ``all-gather``,
``reduce-scatter``): ``SolvePlan.hlo_summary`` reads it.

On a :class:`~repro_torch.launch.mesh.ProcessMesh` (one rank a tile) a
rank's stack has one entry on its tile axis: (..., 1, m) stands where a
``TileMesh`` has (..., P, m), and every call returns the rank's slice of
the ``TileMesh`` result, bit for bit.  A permutation is one
``batch_isend_irecv`` between the rank and its peers (a fixed point a
local copy, a tile no pair reaches zeros); a gather one ``all_gather``
over the axes' subgroup; a reduction (``reduce_along``, ``bcast_from``,
``tile_sum``) gathers the partials and adds them in group order 0..p-1
as above, and ``reduce_scatter_along`` the same over the chunks one
``all_to_all_single`` brings each tile (its own chunk of every member's
partials: (p-1) u words in, where a gather would bring (p-1) p u) --
never ``all_reduce``, whose order is the library's -- so every rank holds
the same bits of every reduced value and takes the same branches.
``axis_coord`` is the rank's own coordinate, and :func:`rank_sum` adds
the ranks' shares of a sum over every tile.
"""

from __future__ import annotations

import contextvars
from collections import Counter
from contextlib import contextmanager

import numpy as np
import torch

__all__ = ["neighbor_shift", "pull_shard", "gather_along", "reduce_along",
           "reduce_scatter_along", "mesh_transpose", "reverse_vector",
           "bcast_from", "axis_coord", "tile_sum", "rank_sum", "recording",
           "record", "NocRecorder"]

_RECORDER = contextvars.ContextVar("repro_torch_noc", default=None)


class NocRecorder:
    """Counts of the collectives the NoC calls stood for while it was
    active (:func:`recording`), by their HLO names."""

    def __init__(self):
        self.counts: Counter = Counter()

    def summary(self) -> dict:
        """``{"count_by_op": {name: n}, "total_count": n}`` as floats, the
        JAX package's ``analyze_stablehlo_text`` record."""
        ops = {k: float(v) for k, v in sorted(self.counts.items()) if v}
        return {"count_by_op": ops, "total_count": float(sum(ops.values()))}


@contextmanager
def recording():
    """Record the collectives of the NoC calls made inside the block."""
    rec = NocRecorder()
    token = _RECORDER.set(rec)
    try:
        yield rec
    finally:
        _RECORDER.reset(token)


def record(op: str) -> None:
    """Count one ``op`` collective in the active recorder (if any): the
    NoC calls record themselves; a kernel whose in-stream reduction stands
    for a psum of the JAX program records it here."""
    rec = _RECORDER.get()
    if rec is not None:
        rec.counts[op] += 1



def _check_stack(xs: torch.Tensor, mesh, vec_axis=None) -> None:
    if xs.dim() < 2 or xs.shape[-2] != mesh.local_size:
        raise ValueError(f"tile-stacked tensor must be (..., "
                         f"{mesh.local_size}, m), got {tuple(xs.shape)}")
    if vec_axis is not None and vec_axis != xs.dim() - 2:
        raise ValueError(
            f"vec_axis {vec_axis}: the shard's vector axis is its last one "
            f"({xs.dim() - 2} for a {xs.dim() - 1}-d shard)")


def axis_coord(mesh, axis) -> torch.Tensor:
    """Every tile's coordinate along ``axis`` (a name or a tuple of names,
    row-major over them): a (P,) int64 tensor, tile t's entry its
    ``lax.axis_index`` (a (1,) tensor, the rank's own, on a
    ``ProcessMesh``)."""
    axes = mesh.axes(axis)
    return mesh.index(("coord", axes),
                      lambda: mesh.group(axes)[0][mesh.local])


def _ppermute(xs: torch.Tensor, mesh, axes, perm,
              what: str) -> torch.Tensor:
    """``lax.ppermute`` over the axis group ``axes``: ``perm`` lists
    (source, destination) coordinates; a tile no pair reaches receives
    zeros.  Identity permutations are elided (nothing moves, nothing is
    recorded).  ``what`` names the NoC call in a process grid's stats."""
    axes = mesh.axes(axes)
    perm = tuple((int(s), int(d)) for s, d in perm)
    if all(s == d for s, d in perm):
        return xs
    _check_stack(xs, mesh)
    if mesh.per_process:
        record("collective-permute")
        return mesh.permute(xs, axes, perm, what)

    def build():
        coord, members = mesh.group(axes)
        src_of = {d: s for s, d in perm}
        return [members[t, src_of[c]] if c in src_of else mesh.size
                for t, c in enumerate(coord)]

    idx = mesh.index(("perm", axes, perm), build)
    record("collective-permute")
    if len({d for _, d in perm}) < mesh.group(axes)[1].shape[1]:
        xs = torch.cat([xs, xs.new_zeros(xs.shape[:-2] + (1, xs.shape[-1]))],
                       dim=-2)
    return xs.index_select(-2, idx)


def neighbor_shift(xs: torch.Tensor, mesh, axis, shift: int = 1):
    """One torus hop along ``axis`` (wraps around): tile i's shard moves
    to tile (i + shift) mod p."""
    p = mesh.group(axis)[1].shape[1]
    return _ppermute(xs, mesh, axis, [(i, (i + shift) % p) for i in range(p)],
                     "neighbor_shift")


def pull_shard(xs: torch.Tensor, mesh, axes, delta: int):
    """Every tile receives the shard ``delta`` hops up ``axes``: tile i
    gets tile (i + delta) mod p's shard -- one step of a compiled halo
    pull schedule (``core.commplan``)."""
    p = mesh.group(axes)[1].shape[1]
    return _ppermute(xs, mesh, axes,
                     [((i + delta) % p, i) for i in range(p)], "pull_shard")


def mesh_transpose(xs: torch.Tensor, mesh, row_axes, col_axes):
    """The swap between SpMV's output layout (L_row: segment q = i*pc + j
    on tile (i, j)) and its input layout (L_col: segment q = j*pr + k on
    tile (k, j)), one permutation over the flattened ``row_axes +
    col_axes``; the identity (elided) where pr == 1 or pc == 1."""
    row_axes, col_axes = mesh.axes(row_axes), mesh.axes(col_axes)
    pr = mesh.group(row_axes)[1].shape[1]
    pc = mesh.group(col_axes)[1].shape[1]
    perm = [(j * pr + k, k * pc + j) for k in range(pr) for j in range(pc)]
    return _ppermute(xs, mesh, row_axes + col_axes, perm, "mesh_transpose")


def reverse_vector(xs: torch.Tensor, mesh, axes, vec_axis=None):
    """Globally reverse a vector held in contiguous (L_row) shards: shard q
    swaps with shard p-1-q and each shard flips (the last axis)."""
    _check_stack(xs, mesh, vec_axis)
    p = mesh.group(axes)[1].shape[1]
    moved = _ppermute(xs, mesh, axes, [(p - 1 - q, q) for q in range(p)],
                      "reverse_vector")
    return torch.flip(moved, (-1,))


def _group_gather(xs: torch.Tensor, mesh, axes, what: str) -> torch.Tensor:
    """(..., P, m) -> (..., P, p, m): every tile's group members' shards,
    in coordinate order, by one index gather over the tile axis (on a
    ``ProcessMesh`` (..., 1, m) -> (..., 1, p, m), one all_gather)."""
    axes = mesh.axes(axes)
    if mesh.per_process:
        return mesh.gather(xs, axes, what)
    members = mesh.group(axes)[1]
    idx = mesh.index(("gather", axes), lambda: members.reshape(-1))
    return xs.index_select(-2, idx).view(
        xs.shape[:-2] + (mesh.size, members.shape[1], xs.shape[-1]))


def _sum_members(g: torch.Tensor) -> torch.Tensor:
    """(..., P, p, m) -> (..., P, m), the p members added in order."""
    acc = g[..., 0, :]
    for c in range(1, g.shape[-2]):
        acc = acc + g[..., c, :]
    return acc


def gather_along(xs: torch.Tensor, mesh, axis, tiled: bool = True,
                 vec_axis=None) -> torch.Tensor:
    """Assemble the shards of every tile along ``axis`` onto each tile,
    in coordinate order: (..., P, m) -> (..., P, p*m), or (..., P, p, m)
    with ``tiled=False`` (the gathered axis before the vector axis)."""
    _check_stack(xs, mesh, vec_axis)
    g = _group_gather(xs, mesh, axis, "gather_along")
    record("all-gather")
    return g.reshape(g.shape[:-2] + (-1,)) if tiled else g


def reduce_along(xs: torch.Tensor, mesh, axis) -> torch.Tensor:
    """psum along ``axis``: every tile gets the sum of its group's shards,
    added in coordinate order."""
    _check_stack(xs, mesh)
    g = _group_gather(xs, mesh, axis, "reduce_along")
    record("all-reduce")
    return _sum_members(g)


def reduce_scatter_along(xs: torch.Tensor, mesh, axis,
                         vec_axis=None) -> torch.Tensor:
    """psum_scatter along ``axis``: the shards' vector axis (length p*u)
    splits into p chunks and the tile at coordinate c keeps the sum of
    its group's chunk c, added in coordinate order: (..., P, p*u) ->
    (..., P, u)."""
    _check_stack(xs, mesh, vec_axis)
    axes = mesh.axes(axis)
    coord, members = mesh.group(axes)
    p = members.shape[1]
    big = xs.shape[-1]
    if big % p:
        raise ValueError(f"reduce_scatter_along: vector length {big} is not "
                         f"a multiple of the {p} tiles along {axes}")
    u = big // p
    if mesh.per_process:
        g = mesh.all_to_all(xs.reshape(xs.shape[:-1] + (p, u)), axes,
                            "reduce_scatter_along")
        record("reduce-scatter")
        return _sum_members(g)

    def build():
        base = members * big + (coord * u)[:, None]            # (P, p)
        return (base[:, :, None] + np.arange(u)).reshape(-1)

    idx = mesh.index(("scatter", axes, big), build)
    record("reduce-scatter")
    flat = xs.reshape(xs.shape[:-2] + (mesh.size * big,))
    g = flat.index_select(-1, idx).view(xs.shape[:-2] + (mesh.size, p, u))
    return _sum_members(g)


def bcast_from(xs: torch.Tensor, mesh, axis, src) -> torch.Tensor:
    """Broadcast the shard of the tile at coordinate ``src`` along
    ``axis`` to every tile of that axis (a masked psum)."""
    me = axis_coord(mesh, axis)
    mask = (me == src).to(xs.dtype).unsqueeze(-1)
    return reduce_along(xs * mask, mesh, axis)


def tile_sum(parts: torch.Tensor, mesh) -> torch.Tensor:
    """Per-tile partials ``parts`` (..., P) -> (...), added in tile order
    0..P-1: the value of a psum over every axis, held once (on a
    ``ProcessMesh`` the rank's (..., 1) partial, the ranks' partials
    gathered and added in that order).  Records nothing: the caller
    records the collective it stands for."""
    if parts.shape[-1] != mesh.local_size:
        raise ValueError(f"tile partials {tuple(parts.shape)} vs "
                         f"{mesh.local_size} tiles")
    if mesh.per_process:
        parts = mesh.gather(parts.unsqueeze(-1), mesh.axis_names,
                            "tile_sum")[..., 0, :, 0]
    acc = parts[..., 0]
    for t in range(1, mesh.size):
        acc = acc + parts[..., t]
    return acc


def rank_sum(share: torch.Tensor, mesh) -> torch.Tensor:
    """A sum over every tile from this process's ``share`` of it: on a
    ``TileMesh`` the process holds every tile and ``share`` is the sum; on
    a ``ProcessMesh`` the ranks' shares are gathered and added in rank
    order 0..P-1, the same bits on every rank.  Records nothing."""
    if not mesh.per_process:
        return share
    return tile_sum(share.unsqueeze(-1), mesh)
