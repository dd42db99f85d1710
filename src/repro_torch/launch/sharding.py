"""Logical -> mesh sharding rules for the model zoo (port of the spec
rules of ``repro.launch.sharding``).

Policy (the JAX package's):
  * batch            -> all non-"model" axes ("pod","data")
  * heads / d_ff / vocab / experts / lru width / ssm heads -> "model"  (TP/EP)
  * d_model (params) -> "data" (+"pod" never: pods are pure DP)          (FSDP)
  * decode KV caches -> sequence dim over "model", batch over the batch
    axes
  * optimizer state  -> same spec as its param (ZeRO: state lives with the
    shard); Adafactor's factored (vr, vc) drop the corresponding dim.

A spec is a tuple with one entry per tensor dim (the entries of the JAX
``PartitionSpec``): ``None``, an axis name, or a tuple of axis names.  A
mesh is anything with a ``shape`` mapping axis name to size: a
:class:`MeshShape` of :data:`MESHES` (the JAX package's production meshes
``single`` and ``multi``, and ``card``, the one H100 the port runs on) or
a ``launch.mesh.TileMesh``.  Specs are validated against the leaf
shape and mesh with ``ft.remesh.validate_spec`` (axes that do not divide
are dropped -> replication).

The rules are keyed on the JAX tree's path names, for example
``("groups", "0", "mix", "wq", "w")``: params come as
``models.model.param_leaves`` gives them (a layer group's leaf is a
``LayerStack``, the JAX tree's leaf stacked on a leading layer axis), the
optimizer state is the JAX package's tree (``train.optim``), and the
port's per-layer caches are stacked the same way (:func:`cache_leaves`).
Each ``*_specs`` returns a dict (``state_specs`` a ``TrainState`` of
them): the leaf's path (as the tree gives it, list indices as ints) ->
spec, in the tree's leaf order.

Placement (:func:`named`, :func:`tree_named`): each leaf's spec,
validated on the mesh, becomes a :class:`Placement` -- the spec, the
``torch.distributed.tensor`` placements (``Shard``/``Replicate`` a mesh
axis, in the mesh's axis order) and the index slices each tile holds.
Tile ``t`` is the row-major flat index over the mesh's axes (rank ``t`` of
a ``launch.mesh.ProcessMesh``, as ``jax.make_mesh`` lays its devices
out); a spec entry of several axes splits its dim major-to-minor in the
entry's order, as JAX does, so every tile's slices are those of JAX's
``NamedSharding.devices_indices_map``.  :func:`place` keeps a rank's
slice of every leaf of a tree and frees the rest; :func:`gather` is its
inverse.  Data moves only through the ``ProcessMesh``'s own staged calls
(``gather``, ``all_to_all``), never DTensor's ``redistribute``: the gloo
backend has no reduce-scatter and takes no card tensors, and every byte
is counted in ``mesh.stats``.  Every sum across ranks is added in rank
(coordinate) order, so ranks that hold the same slice hold the same bits.
"""

from __future__ import annotations

import math

import torch

import numpy as np

from ..ft.remesh import spec as _spec
from ..ft.remesh import validate_spec
from ..models.model import LayerStack, Model, param_leaves, replace_params

__all__ = [
    "MeshShape", "MESHES", "param_specs", "opt_specs", "cache_specs",
    "batch_specs", "state_specs", "tree_leaves", "cache_leaves",
    "leaf_shape", "local_shape", "device_bytes", "Placement", "named",
    "tree_named", "place", "gather", "held_bytes",
]

_F = "data"     # FSDP axis
_M = "model"    # TP/EP axis


class MeshShape:
    """A mesh's axes and their sizes, without devices: ``shape`` maps axis
    name to size in axis order, as ``jax.sharding.Mesh.shape``."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())

    def __repr__(self):
        return f"MeshShape({self.shape})"


MESHES = {
    "single": MeshShape({"data": 16, "model": 16}),
    "multi": MeshShape({"pod": 2, "data": 16, "model": 16}),
    "card": MeshShape({"data": 1, "model": 1}),
}


def _param_rule(path: tuple[str, ...], ndim: int, fsdp: bool,
                shape: tuple = (), mesh_sizes: dict | None = None,
                ep_stationary: bool = False) -> tuple:
    name = path[-1] if path else ""
    parent = path[-2] if len(path) >= 2 else ""
    f = _F if fsdp else None
    stacked = "groups" in path  # leading layer axis
    lead = (None,) if stacked else ()

    def pp(*spec):
        full = lead + spec
        if len(full) < ndim:
            full = full + (None,) * (ndim - len(full))
        return _spec(*full[:ndim])

    # embeddings / head: (V, D) -- vocab on model, D on fsdp
    if name == "table":
        return _spec(_M, f)
    # norms / small vectors
    if name in ("scale", "bias", "dt_bias", "A_log", "D", "lam", "conv_b"):
        return pp(None)
    if name == "b":  # linear bias: shard like the output dim
        if parent in ("wo", "out_proj", "out"):
            return pp(None)
        return pp(_M)
    if name == "w":
        # direction by the enclosing linear's role
        if parent in ("wq", "wk", "wv", "wq_b", "wkv_b", "in_x", "in_g", "wi", "wg", "in_proj"):
            return pp(f, _M)       # (D, H*hd / F / big) -> col parallel
        if parent in ("wo", "out_proj", "out"):
            return pp(_M, f)       # row parallel
        if parent in ("wq_a", "wkv_a", "router", "proj"):
            return pp(f, None)
        if parent in ("w_a", "w_x"):
            return pp(None, _M)    # (W, W) RG-LRU gates
        return pp(None, None)
    # MoE expert banks: (E, D, F) / (E, F, D) -- experts on model (EP).
    # ep_stationary ("pin weights, move activations"):
    #   * E divisible by the whole mesh -> experts spread over every device;
    #   * else E on model, ffn dim on data -> still no weight movement.
    # Baseline (ep_stationary=False) FSDP-shards d_model over data.
    if name in ("wi", "wg", "wo") and (len(shape) - len(lead)) >= 3:
        e_idx = len(lead)
        e = shape[e_idx] if e_idx < len(shape) else 0
        if ep_stationary and mesh_sizes:
            total = 1
            for v in mesh_sizes.values():
                total *= v
            md = mesh_sizes.get(_M, 1)
            if e and e % total == 0:
                return pp((_F, _M), None, None)
            if e and e % md == 0:
                if name == "wo":
                    return pp(_M, _F, None)   # (E, F, D): F over data
                return pp(_M, None, _F)       # (E, D, F): F over data
        if name == "wo":
            return pp(_M, None, f)
        return pp(_M, f, None)
    if name == "conv_w":
        return pp(None, _M)        # (K, C) depthwise conv channels
    return pp(*(None,) * max(ndim - len(lead), 0))


# -- trees ---------------------------------------------------------------------


def leaf_shape(leaf) -> tuple:
    """The JAX leaf's shape: a ``LayerStack``'s is (L, *layer shape)."""
    if isinstance(leaf, LayerStack):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(getattr(leaf, "shape", ()))


def tree_leaves(tree, prefix: tuple = ()) -> dict:
    """path -> leaf of nested dicts, lists and tuples (a ``LayerStack`` and
    anything else is a leaf; ``None`` is an empty subtree, as in JAX); a
    ``Model`` gives its ``param_leaves``."""
    if isinstance(tree, Model):
        return {prefix + k: v for k, v in param_leaves(tree).items()}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree) if not _is_leaves(tree) else tree:
            out |= tree_leaves(tree[k], prefix + (k if isinstance(k, tuple) else (k,)))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree, LayerStack):
        out = {}
        for i, v in enumerate(tree):
            out |= tree_leaves(v, prefix + (i,))
        return out
    if tree is None:
        return {}
    return {prefix: tree}


def _is_leaves(tree: dict) -> bool:
    """A ``param_leaves``-style dict: its keys are paths already."""
    return bool(tree) and all(isinstance(k, tuple) for k in tree)


def cache_leaves(caches) -> dict:
    """The JAX package's cache leaves of the port's ``[group][layer]``
    caches: path ``(group, key, ...)`` -> the ``LayerStack`` of the
    group's per-layer tensors (JAX stacks them on a leading axis)."""
    out: dict = {}
    for g, layers in enumerate(caches):
        for layer in layers:
            for path, t in tree_leaves(layer, (g,)).items():
                out.setdefault(path, LayerStack()).append(t)
    return out


def _names(path) -> tuple[str, ...]:
    return tuple(str(p) for p in path)


# -- spec rules ----------------------------------------------------------------


def param_specs(params, fsdp: bool = True, mesh=None,
                ep_stationary: bool = False) -> dict:
    """path -> spec of every param leaf (shape-validated later)."""
    msizes = dict(mesh.shape) if mesh is not None else None
    out = {}
    for path, leaf in tree_leaves(params).items():
        shape = leaf_shape(leaf)
        out[path] = _param_rule(_names(path), len(shape), fsdp, shape,
                                msizes, ep_stationary)
    return out


def opt_specs(opt_state, fsdp: bool = True, mesh=None,
              ep_stationary: bool = False) -> dict:
    """Specs for optimizer state: moments share the param's spec; Adafactor
    vr drops the last dim, vc drops the second-to-last."""
    msizes = dict(mesh.shape) if mesh is not None else None
    out = {}
    for path, leaf in tree_leaves(opt_state).items():
        names = _names(path)
        # strip the leading container key ("m"/"v"/"f") to find the param path
        tail = names[1:]
        kind = names[0]
        shape = leaf_shape(leaf)
        nd = len(shape)
        if kind in ("m", "v"):
            out[path] = _param_rule(tail, nd, fsdp, shape, msizes, ep_stationary)
            continue
        # factored: leaf names end with vr/vc
        pshape = shape + (1,) if names[-1] == "vr" else (
            shape[:-1] + (1,) + shape[-1:] if names[-1] == "vc" else shape
        )
        ent = _param_rule(tail[:-1], nd + 1, fsdp, pshape, msizes,
                          ep_stationary)
        if names[-1] == "vr":
            out[path] = ent[:-1]
        elif names[-1] == "vc":
            out[path] = ent[:-2] + ent[-1:]
        elif names[-1] == "v":
            out[path] = _param_rule(tail[:-1], nd, fsdp, shape, msizes,
                                    ep_stationary)
        else:
            out[path] = (None,) * nd
    return out


def cache_specs(caches, batch: tuple[str, ...], seq_shard: bool = True) -> dict:
    """Decode/prefill cache specs of the port's ``[group][layer]`` caches
    (or of :func:`cache_leaves`' dict), leaves stacked (L, B, ...)."""
    m = _M if seq_shard else None
    leaves = caches if isinstance(caches, dict) else cache_leaves(caches)
    out = {}
    for path, leaf in leaves.items():
        name = _names(path)[-1]
        nd = len(leaf_shape(leaf))
        if name in ("k", "v", "k_s", "v_s"):       # (L, B, W, KV, hd)
            spec = ((None, batch, m) + (None,) * (nd - 3))[:nd]
        elif name in ("ckv", "kr"):                 # (L, B, S, R)
            spec = ((None, batch, m) + (None,) * (nd - 3))[:nd]
        elif name == "ssd":                         # (L, B, H, P, N)
            spec = ((None, batch, _M) + (None,) * (nd - 3))[:nd]
        elif name == "conv":                        # (L, B, K, C)
            spec = ((None, batch, None, _M) + (None,) * (nd - 4))[:nd]
        elif name == "h":                           # (L, B, W)
            spec = (None, batch, _M)[:nd]
        else:
            spec = (None,) * nd
        out[path] = _spec(*spec)
    return out


def batch_specs(batch_tree, batch: tuple[str, ...]) -> dict:
    out = {}
    for path, leaf in tree_leaves(batch_tree).items():
        nd = len(leaf_shape(leaf))
        out[path] = _spec(*((batch,) + (None,) * (nd - 1))[:nd]) if nd else ()
    return out


def state_specs(state, fsdp: bool = True, mesh=None,
                ep_stationary: bool = False):
    """Specs for a TrainState(params, opt_state, step, ef)."""
    from ..train.step import TrainState
    ps = param_specs(state.params, fsdp, mesh, ep_stationary)
    os_ = opt_specs(state.opt_state, fsdp, mesh, ep_stationary)
    ef = None if state.ef is None else param_specs(state.ef, fsdp, mesh, ep_stationary)
    return TrainState(ps, os_, (), ef)


# -- bytes a device holds ------------------------------------------------------


def local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """The shard of ``shape`` one device holds under ``spec`` validated on
    ``mesh``."""
    ok = validate_spec(tuple(shape), spec, mesh)
    out = list(shape)
    for d, s in enumerate(ok):
        if s is not None:
            axes = (s,) if isinstance(s, str) else tuple(s)
            out[d] //= math.prod(int(mesh.shape[a]) for a in axes)
    return tuple(out)


def _itemsize(leaf) -> int:
    t = leaf[0] if isinstance(leaf, LayerStack) else leaf
    if isinstance(t, torch.Tensor):
        return t.element_size()
    return int(getattr(getattr(t, "dtype", None), "itemsize", 0))


def device_bytes(leaves: dict, specs: dict, mesh) -> int:
    """Bytes one device holds of ``leaves`` (path -> leaf) sharded by
    ``specs`` (path -> spec) on ``mesh``."""
    return sum(math.prod(local_shape(leaf_shape(leaf), specs[path], mesh))
               * _itemsize(leaf) for path, leaf in leaves.items())


# -- placement on a mesh ---------------------------------------------------------


def _entry_axes(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


class Placement:
    """One leaf's placement on ``mesh`` (module docstring).

    ``shape`` is the whole leaf's, ``spec`` its spec validated on the mesh
    (axes that do not divide dropped), ``local_shape`` the slice one tile
    holds, ``axes`` the mesh axes that split it (in mesh order).  A mesh of
    shapes alone (:class:`MeshShape`) gives the slices; a
    ``launch.mesh.ProcessMesh`` also places and moves the data of its rank
    (``held``, :meth:`shard`, :meth:`gather`, :meth:`reduce_scatter`,
    :meth:`sum_over`); on a ``TileMesh`` the process holds every tile, so
    it holds the whole leaf."""

    def __init__(self, mesh, spec: tuple, shape: tuple):
        self.mesh = mesh
        self.shape = tuple(int(d) for d in shape)
        self.spec = validate_spec(self.shape, tuple(spec), mesh)
        self.local_shape = local_shape(self.shape, self.spec, mesh)
        used = {a for e in self.spec for a in _entry_axes(e)}
        self.axes = tuple(a for a in mesh.axis_names if a in used)

    def __repr__(self) -> str:
        return f"Placement({self.shape}, {self.spec}, on {dict(self.mesh.shape)})"

    @property
    def per_process(self) -> bool:
        return bool(getattr(self.mesh, "per_process", False))

    def dim_axes(self, dims) -> tuple:
        """The mesh axes that split ``dims``, each dim's major to minor."""
        return tuple(a for d in dims for a in _entry_axes(self.spec[d]))

    @property
    def placements(self) -> tuple:
        """``torch.distributed.tensor`` placements, one a mesh axis in the
        mesh's order: ``Shard(d)`` where the axis splits dim d, else
        ``Replicate()``.  DTensor splits a dim over several mesh axes in
        mesh order, so a multi-axis entry must list its axes so."""
        from torch.distributed.tensor import Replicate, Shard

        names = self.mesh.axis_names
        for e in self.spec:
            ax = _entry_axes(e)
            if list(ax) != sorted(ax, key=names.index):
                raise ValueError(f"spec entry {e!r} is not in the mesh's axis "
                                 f"order {names}: no DTensor placement")
        return tuple(next((Shard(d) for d, e in enumerate(self.spec)
                           if a in _entry_axes(e)), Replicate()) for a in names)

    def index(self, tile: int, over=None) -> tuple:
        """The slices of the leaf that tile ``tile`` holds (JAX's
        ``devices_indices_map`` entry of the mesh's tile-th device); with
        ``over`` (a subset of :attr:`axes`) its slices within the tensor
        :meth:`gather` over ``over`` gives."""
        names = self.mesh.axis_names
        sizes = [int(self.mesh.shape[a]) for a in names]
        coords = dict(zip(names, np.unravel_index(int(tile), sizes)))
        over = self._over(over)
        out = []
        for d, e in enumerate(self.spec):
            ax = [a for a in _entry_axes(e) if a in over]
            i = int(np.ravel_multi_index([coords[a] for a in ax],
                                         [int(self.mesh.shape[a]) for a in ax])) if ax else 0
            n = self.local_shape[d]
            out.append(slice(i * n, (i + 1) * n))
        return tuple(out)

    def _over(self, over) -> tuple:
        """``over`` (None: every axis that splits the leaf) as the axes of
        :attr:`axes` it names, in mesh order."""
        if over is None:
            return self.axes
        return tuple(a for a in self.axes if a in over)

    def gathered_shape(self, over=None) -> tuple:
        """The shape :meth:`gather` over ``over`` returns: each dim's slice
        times the tiles of the gathered axes that split it."""
        over = self._over(over)
        return tuple(n * math.prod(int(self.mesh.shape[a]) for a in _entry_axes(e)
                                   if a in over)
                     for n, e in zip(self.local_shape, self.spec))

    @property
    def held(self) -> tuple:
        """The slices this process holds: its rank's on a ``ProcessMesh``,
        the whole leaf where one process holds every tile."""
        if self.per_process:
            return self.index(self.mesh.rank)
        return tuple(slice(0, n) for n in self.shape)

    def row(self) -> "Placement":
        """A layer's placement of a stacked leaf (its layer axis is never
        split)."""
        if self.spec[0] is not None:
            raise ValueError(f"{self}: the leading layer axis is split")
        return Placement(self.mesh, self.spec[1:], self.shape[1:])

    # -- data ------------------------------------------------------------------

    def shard(self, leaf):
        """This process's slice of ``leaf`` (a tensor, a numpy array, or a
        ``LayerStack`` of a stacked leaf's layers) as a tensor of its own on
        the mesh's device; the whole leaf is left to be freed."""
        if isinstance(leaf, LayerStack):
            r = self.row()
            return LayerStack(r.shard(t) for t in leaf)
        dev = getattr(self.mesh, "device", None)
        held = self.held
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()[held]
        else:
            t = torch.from_numpy(np.array(np.asarray(leaf)[held]))
        dev = t.device if dev is None else torch.device(dev)
        return t.to(dev) if t.device != dev else t.clone()

    def gather(self, x: torch.Tensor, what: str = "gather", over=None) -> torch.Tensor:
        """The whole leaf from this rank's slice ``x``: one ``all_gather``
        over the axes that split it (``mesh.gather``), the slices put in
        place; ``x`` itself where nothing splits it or one process holds
        every tile.  With ``over``, a subset of those axes: gathered over
        them alone, the slice this rank holds over the rest (a dim split
        by several axes must list the kept ones first)."""
        axes = self._over(over)
        if not self.per_process or not axes:
            return x
        for e in self.spec:
            ax = _entry_axes(e)
            kept = [a in axes for a in ax]
            if kept != sorted(kept):
                raise ValueError(f"{self}: gathering {axes} of entry {e!r} "
                                 "leaves no contiguous slice")
        got = self.mesh.gather(x.reshape(1, -1), axes, what)
        t = got.reshape([int(self.mesh.shape[a]) for a in axes]
                        + list(self.local_shape))
        perm = []
        for d, e in enumerate(self.spec):
            perm += [axes.index(a) for a in _entry_axes(e) if a in axes]
            perm.append(len(axes) + d)
        return t.permute(perm).reshape(self.gathered_shape(axes))

    def gather_leaf(self, leaf, what: str = "gather") -> torch.Tensor:
        """:meth:`gather` of a held leaf (a ``LayerStack``'s layers stacked
        into one message), as a tensor of its own on the host."""
        if isinstance(leaf, LayerStack):
            full = self.gather(torch.stack(list(leaf)), what).to("cpu", copy=True)
            return LayerStack(full.unbind(0))
        return self.gather(leaf, what).to("cpu", copy=True)

    def reduce_scatter(self, full: torch.Tensor, axes, what: str,
                       over=None) -> torch.Tensor:
        """This rank's slice of the sum of ``full`` over the members of its
        group along ``axes`` (the batch axes: the ranks that computed other
        parts of the batch): one ``all_to_all`` sends each member its slice,
        and the received slices are added in coordinate order, in f32, cast
        back to ``full``'s dtype.  ``full`` is the whole leaf, or with
        ``over`` the tensor :meth:`gather` over ``over`` gives (the members
        differ only on axes of ``over``)."""
        mine = self.index(self.mesh.rank, over) if self.per_process else self.held
        if not self.per_process:
            return full[mine]
        axes = self.mesh.axes(axes)
        mem = [int(q) for q in self.mesh.group(axes)[1][self.mesh.rank]] \
            if axes else [self.mesh.rank]
        if len(mem) == 1:
            return full[mine].contiguous()
        send = torch.stack([full[self.index(q, over)].reshape(-1) for q in mem])
        got = self.mesh.all_to_all(send.unsqueeze(0), axes, what)[0]
        acc = got[0].float()
        for c in range(1, len(mem)):
            acc = acc + got[c].float()
        return acc.to(full.dtype).view(self.local_shape)

    def sum_over(self, part: torch.Tensor, dims, what: str,
                 op: str = "sum") -> torch.Tensor:
        """The sum (``op="max"``: the max) over every slice along ``dims`` of
        ``part``, this rank's partial over its slice of those dims: the
        partials of the ranks that hold the other slices (its group along
        the axes that split ``dims``) gathered and added in coordinate
        order.  ``part`` itself where no axis splits ``dims`` or one process
        holds every tile."""
        axes = self.dim_axes(dims)
        if not self.per_process or not axes:
            return part
        got = self.mesh.gather(part.reshape(1, -1), axes, what)[0]
        acc = got[0]
        for c in range(1, got.shape[0]):
            acc = acc + got[c] if op == "sum" else torch.maximum(acc, got[c])
        return acc.view(part.shape)


def named(mesh, spec_tree, shape_tree):
    """specs -> :class:`Placement` s, validated against the leaves' shapes
    (axes that do not divide dropped -> replicated).  ``spec_tree`` is a
    spec, a dict path -> spec (``param_specs`` ...) or a ``TrainState`` of
    them (``state_specs``); ``shape_tree`` the matching tree of leaves
    (a ``Model``, nested dicts, a leaves dict, a ``TrainState``)."""
    from ..train.step import TrainState

    if isinstance(spec_tree, TrainState):
        return TrainState(*(None if s is None else named(mesh, s, getattr(shape_tree, f))
                            for f, s in zip(TrainState._fields, spec_tree)))
    if not isinstance(spec_tree, dict):
        return Placement(mesh, spec_tree, leaf_shape(shape_tree))
    leaves = tree_leaves(shape_tree)
    return {path: Placement(mesh, spec, leaf_shape(leaves[path]))
            for path, spec in spec_tree.items()}


def tree_named(mesh, tree, fsdp: bool = True):
    return named(mesh, param_specs(tree, fsdp), tree)


def _map_placed(fn, tree, placements):
    """``tree`` with each leaf replaced by ``fn(placement, leaf)``, its
    structure kept (a ``Model`` over the new tensors)."""
    from ..train.optim import tree_from_paths
    from ..train.step import TrainState

    if isinstance(tree, TrainState):
        return TrainState(*(_map_placed(fn, t, p) for t, p in zip(tree, placements)))
    if tree is None:
        return None
    if isinstance(placements, Placement):
        return fn(placements, tree)
    new = {k: fn(placements[k], v) for k, v in tree_leaves(tree).items()}
    if isinstance(tree, Model):
        return replace_params(tree, new)
    return new if _is_leaves(tree) else tree_from_paths(new)


def place(tree, placements):
    """``tree`` (whole leaves: a ``TrainState`` as
    ``convert.train_state_from_numpy`` or a checkpoint gives it, a
    ``Model``, nested dicts; numpy or tensors) with each leaf cut to the
    slice this process holds under ``placements`` (:func:`named`'s tree),
    on the mesh's device.  The whole leaves are not kept."""
    return _map_placed(lambda pl, v: pl.shard(v), tree, placements)


def gather(tree, placements):
    """The inverse of :func:`place`: every leaf whole, on the host (one
    ``all_gather`` a leaf on a ``ProcessMesh``; every rank gets them, in
    tile order)."""
    return _map_placed(lambda pl, v: pl.gather_leaf(v), tree, placements)


def held_bytes(tree) -> int:
    """Bytes of the tensors ``tree`` holds (a ``TrainState``'s four
    fields, a ``Model``, nested dicts)."""
    from ..train.step import TrainState

    trees = tree if isinstance(tree, TrainState) else (tree,)
    return sum(math.prod(leaf_shape(v)) * _itemsize(v)
               for t in trees for v in tree_leaves(t).values())
