"""Activation-sharding hints of the model zoo (port of
``repro.models.shard``).

The JAX package pins the sharding of hot activations with
``constrain(x, kind)`` inside ``use_mesh_axes(mesh, ...)``.  The port runs a
model on one card, so ``constrain`` is the identity here, inside the
context or not; the call sites keep the JAX names so that a sharded model
has its seams.  A model sharded across cards waits for its placement on a
``launch.mesh.ProcessMesh`` (ROADMAP Queue 1 item 11b, on item 10's
process grid).
"""

from __future__ import annotations

from contextlib import contextmanager

__all__ = ["use_mesh_axes", "active", "constrain"]

_CTX: dict = {"on": False}


@contextmanager
def use_mesh_axes(mesh, batch=("data",), model="model",
                  seq_parallel=False, ep_stationary=False):
    """Record the activation-sharding axes for the duration of a call (the
    JAX signature); ``constrain`` stays the identity on one card."""
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


def constrain(x, kind: str):
    """The identity: every activation of a one-card model is whole."""
    del kind
    return x
