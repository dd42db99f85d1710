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

``named`` and ``tree_named``, which place tensors across cards, wait for
``torch.distributed.tensor`` placements on a ``launch.mesh.ProcessMesh``
(ROADMAP Queue 1 item 11b, on item 10's process grid).
"""

from __future__ import annotations

import math

import torch

from ..ft.remesh import spec as _spec
from ..ft.remesh import validate_spec
from ..models.model import LayerStack, Model, param_leaves

__all__ = [
    "MeshShape", "MESHES", "param_specs", "opt_specs", "cache_specs",
    "batch_specs", "state_specs", "tree_leaves", "cache_leaves",
    "leaf_shape", "local_shape", "device_bytes",
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
