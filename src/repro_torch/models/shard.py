"""Activation-sharding hints of the model zoo (port of
``repro.models.shard``), and the seams of a model trained on a
``launch.mesh.ProcessMesh``.

The JAX package pins the sharding of hot activations with
``constrain(x, kind)`` inside ``use_mesh_axes(mesh, ...)``.
``jax.lax.with_sharding_constraint`` is the identity on values, and so is
the port's ``constrain``: under ``use_mesh_axes`` with a ``ProcessMesh``
it validates the kind's spec against the activation's global shape (the
batch dim times the batch shards), as the JAX one does, and returns
``x``; on one card it is the identity and checks nothing.  The port's
process grid splits the batch over the batch axes and keeps the rest of
each activation whole on every rank (storage is placed over ``model``,
compute is not split over it).

A rank of a ``ProcessMesh`` holds its batch shard, so where the loss
reduces over the batch it needs the other shards' numbers too:
:func:`batch_sum` adds a value over the batch shards (the ranks of this
rank's group along the batch axes, in coordinate order) and
:func:`batch_shards` counts them; both are the identity (1) outside such
a context.  :func:`layer_call` is the runner the train step installs
with :func:`running_layers`, so that ``models.model.forward`` runs each
layer from its params' shards.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

__all__ = ["use_mesh_axes", "active", "constrain", "batch_sum",
           "batch_shards", "running_layers", "layer_call"]

_CTX: dict = {"on": False}


@contextmanager
def use_mesh_axes(mesh, batch=("data",), model="model",
                  seq_parallel=False, ep_stationary=False):
    """Install the activation-sharding axes for the duration of a call
    (the JAX signature)."""
    prev = dict(_CTX)
    _CTX.update(on=True, mesh=mesh,
                batch=(batch,) if isinstance(batch, str) else tuple(batch),
                model=model, seq_parallel=bool(seq_parallel),
                ep_stationary=bool(ep_stationary))
    try:
        yield
    finally:
        _CTX.clear()
        _CTX.update(prev)


def active() -> bool:
    return bool(_CTX.get("on"))


def _process_mesh():
    """The installed mesh where it is a ``ProcessMesh``, else None."""
    mesh = _CTX.get("mesh") if _CTX.get("on") else None
    return mesh if getattr(mesh, "per_process", False) else None


def _spec_for(kind: str, ndim: int, shape: tuple = ()) -> tuple:
    b, m = _CTX["batch"], _CTX["model"]
    sp = m if _CTX.get("seq_parallel") else None
    table = {
        # (leading batch dim, then fixed tail); padded with None to ndim
        "act_bsd": (b, sp, None),              # (B, S, D) residual stream
        "act_bsf": (b, None, m),               # (B, S, F) ffn hidden
        "logits": (b, None, m),                # (B, S, V)
        "heads": (b, None, m, None),           # (B, S, H, D)
        "kv": (b, None, None, None),           # (B, S, KV, D) kv<model: repl
        "batch_only": (b,),                    # anything (B, ...)
        "moe_buf": (b, m, None, None),         # (G, E, C, D)
        "ssd_heads": (b, None, m, None),       # (B, L, H, P)
        "state_bh": (b, m),                    # (B, H, ...) decode states
    }
    if kind == "moe_buf" and _CTX.get("ep_stationary") and len(shape) >= 2:
        total = math.prod(int(v) for v in dict(_CTX["mesh"].shape).values())
        if shape[1] % total == 0:
            return ((None, tuple(b) + (m,), None, None) + (None,) * ndim)[:ndim]
        return ((None, m, None, None) + (None,) * ndim)[:ndim]
    if kind not in table:
        raise KeyError(kind)
    spec = table[kind]
    return (spec + (None,) * (ndim - len(spec)))[:ndim]


def constrain(x, kind: str):
    """``x``; under ``use_mesh_axes`` with a ``ProcessMesh``, first the
    kind's spec validated against ``x``'s global shape (module
    docstring)."""
    mesh = _process_mesh()
    if mesh is None:
        return x
    from ..ft.remesh import validate_spec

    shape = tuple(x.shape)
    if shape:
        shape = (shape[0] * batch_shards(),) + shape[1:]
    validate_spec(shape, _spec_for(kind, x.ndim, shape), mesh)
    return x


def batch_shards() -> int:
    """How many shards the batch is split into: the product of the batch
    axes' sizes on the installed ``ProcessMesh``, else 1."""
    mesh = _process_mesh()
    if mesh is None:
        return 1
    return math.prod(int(mesh.shape[a]) for a in _CTX["batch"])


def batch_sum(x):
    """``x`` added over the batch shards: this rank's value and those of
    its group along the batch axes, gathered (``mesh.gather``) and added
    in coordinate order, so every rank gets the same bits.  The identity
    outside a ``ProcessMesh``.  Values only: no gradient flows through
    the other ranks' terms (callers pass counts and routing fractions)."""
    mesh = _process_mesh()
    if mesh is None or batch_shards() == 1:
        return x
    got = mesh.gather(x.detach().reshape(1, -1), _CTX["batch"], "batch_sum")[0]
    acc = got[0]
    for c in range(1, got.shape[0]):
        acc = acc + got[c]
    return acc.view(x.shape)


@contextmanager
def running_layers(call):
    """Run every layer of ``models.model.forward`` through ``call(layer,
    x, cfg) -> (x, aux)`` for the duration of the context."""
    prev = _CTX.get("layer_call")
    _CTX["layer_call"] = call
    try:
        yield
    finally:
        _CTX["layer_call"] = prev


def layer_call():
    """The installed layer runner, or None."""
    return _CTX.get("layer_call")
