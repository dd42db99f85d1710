"""Atomic, async checkpointing of nested host/device state (port of
``repro.checkpoint.manager``).

Layout:  <dir>/step_<N>/
             manifest.json      -- leaf shapes, dtypes, sums, checksum
             <flat_key>.npy     -- one file per leaf (the full array)

The JAX package flattens its trees with ``jax.tree_util``; this module
flattens nested dicts (keys sorted, as jax sorts them), lists, tuples and
NamedTuples (a field is the path step ``.<name>``, as ``jax.tree_util``'s
attribute key prints) itself, with numpy arrays, numpy scalars and
tensors as leaves and None as an empty node.  A ``models.model.Model``
flattens to the JAX param tree's leaves (``param_leaves``): a layer
group's leaf is written as the stack of its layers, the array the JAX
tree holds, and restores as a new ``Model`` over views of it.  A
``train.TrainState`` therefore writes the keys ``.params/...``,
``.opt_state/...``, ``.step`` and ``.ef/...`` (none when ``ef`` is None).
Flat keys, file names, manifests and checksums are the JAX package's, and
a checkpoint written by either package restores in the other.  bfloat16
leaves are written as the JAX package writes them (two raw bytes an
element, manifest dtype ``bfloat16``) and restore as bfloat16 tensors.

Guarantees:
  * atomic: written to ``step_<N>.tmp`` then os.rename'd -- a crash mid-save
    never corrupts the latest checkpoint (restore scans for the newest
    directory with a valid manifest);
  * verified: every leaf is checked against the manifest (shape, dtype,
    content sum) on restore; an unpinned restore falls back past a damaged
    step;
  * async: ``CheckpointManager.save_async`` snapshots the leaves to host
    arrays, then writes on a background thread, so a solve overlaps
    checkpoint I/O with compute.

Leaves restore as numpy arrays, or as tensors on the device of the
matching leaf of ``tree_like`` where that leaf is a tensor.
``restore(..., sharding_tree=)`` places leaves directly: a matching tree
whose leaves are a ``launch.sharding.Placement`` (the port's JAX
``NamedSharding``: on a ``launch.mesh.ProcessMesh`` each rank reads the
whole leaf and keeps its own slice, on its device; where one process
holds every tile, the whole leaf on the mesh's device), a
``launch.mesh.TileMesh`` (the leaf onto the mesh's device), a
``torch.device`` or device string, or None (the leaf keeps the placement
above).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from ..models.model import LayerStack, Model, param_leaves, replace_params

__all__ = ["save", "restore", "latest_step", "CheckpointManager",
           "CorruptCheckpointError"]

_SEP = "/"


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _leaves(tree, path=()):
    """(path, leaf) pairs in jax's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict) and tree and all(isinstance(k, tuple) for k in tree):
        # a leaves dict (``param_leaves``, ``launch.sharding``): path -> leaf
        for k in sorted(tree):
            yield path + tuple(str(q) for q in k), tree[k]
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), path + ("." + name,))
    elif isinstance(tree, Model):
        for p, leaf in param_leaves(tree).items():
            yield path + tuple(str(q) for q in p), leaf
    elif type(tree) in (list, tuple):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def _flatten(tree) -> dict:
    return {_SEP.join(path): leaf for path, leaf in _leaves(tree)}


def _unflatten(tree, flat: dict, path=()):
    """``tree``'s structure with each leaf taken from ``flat`` (a
    ``Model`` becomes a new one over the leaves' tensors)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, flat, path + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, n), flat, path + ("." + n,))
                            for n in tree._fields))
    if isinstance(tree, Model):
        return replace_params(tree, {
            p: flat[_SEP.join(path + tuple(str(q) for q in p))]
            for p in param_leaves(tree)})
    if type(tree) in (list, tuple):
        return type(tree)(_unflatten(v, flat, path + (str(i),))
                          for i, v in enumerate(tree))
    return flat[_SEP.join(path)]


_BF16 = np.dtype("V2")      # bfloat16's two bytes, as numpy stores them


def _host(leaf) -> np.ndarray:
    """A host copy of one leaf (a snapshot: later writes to the leaf do
    not reach it); a ``LayerStack`` stacked on a leading axis, bfloat16
    as its raw two bytes an element."""
    if isinstance(leaf, LayerStack):
        return np.stack([_host(t) for t in leaf])
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().copy().view(_BF16)
        return t.cpu().numpy().copy()
    return np.array(leaf, copy=True)


def _meta(arr: np.ndarray) -> tuple:
    """(dtype name, f64 content sum) of a host leaf, as the manifest
    records them."""
    if arr.dtype == _BF16:
        f32 = (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
        return "bfloat16", float(np.sum(f32.astype(np.float64))) if arr.size else 0.0
    return str(arr.dtype), float(np.sum(arr.astype(np.float64))) if arr.size else 0.0


def _to_tensor(arr: np.ndarray, like) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(like.device)


def save(tree, directory: str, step: int, keep: int | None = 3) -> str:
    return _save_flat({k: _host(v) for k, v in _flatten(tree).items()},
                      directory, step, keep)


def _save_flat(flat: dict, directory: str, step: int, keep: int | None) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for key, arr in flat.items():
        fname = re.sub(r"[^A-Za-z0-9_.-]", "_", key) + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        dtype, total = _meta(arr)
        manifest["leaves"][key] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": dtype,
            "sum": total,
        }
    manifest["checksum"] = hashlib.sha256(
        json.dumps(manifest["leaves"], sort_keys=True).encode()
    ).hexdigest()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        # the rename below is the commit point: the manifest must be on
        # disk before the directory becomes visible as a valid checkpoint
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    if keep:
        _gc(directory, keep)
    return final


def _gc(directory: str, keep: int):
    steps = sorted(_all_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)


def _all_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(directory, d, "manifest.json")):
            out.append(int(m.group(1)))
    return out


def latest_step_valid(directory: str, s: int) -> bool:
    """Does step ``s`` have a manifest whose self-checksum holds?"""
    try:
        with open(os.path.join(directory, f"step_{s:08d}", "manifest.json")) as f:
            man = json.load(f)
        chk = hashlib.sha256(
            json.dumps(man["leaves"], sort_keys=True).encode()
        ).hexdigest()
        return chk == man["checksum"]
    except (json.JSONDecodeError, KeyError, OSError):
        return False


def latest_step(directory: str) -> int | None:
    for s in sorted(_all_steps(directory), reverse=True):
        if latest_step_valid(directory, s):
            return s
    return None  # partial/corrupt dirs fall through to older steps


class CorruptCheckpointError(RuntimeError):
    """A step directory failed leaf verification (truncated/flipped data)."""


def _load_step(directory: str, step: int, flat: dict):
    """Load and VERIFY one step's leaves against its manifest: shape,
    dtype, and content sum must match what was recorded at save time.
    Raises CorruptCheckpointError on any mismatch -- a torn write or
    bit-rotted .npy must not restore silently."""
    d = os.path.join(directory, f"step_{step:08d}")
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            man = json.load(f)
        out = {}
        for key in flat:
            meta = man["leaves"][key]
            arr = np.load(os.path.join(d, meta["file"]))
            if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
                arr = arr.view(_BF16)
            dtype, got = _meta(arr)
            if list(arr.shape) != meta["shape"] or dtype != meta["dtype"]:
                raise CorruptCheckpointError(
                    f"{d}/{meta['file']}: shape/dtype mismatch vs manifest")
            want = meta["sum"]
            ok = (got == want) or (
                np.isfinite(want)
                and abs(got - want) <= 1e-9 * max(1.0, abs(want)))
            if not ok:
                raise CorruptCheckpointError(
                    f"{d}/{meta['file']}: content sum {got!r} != recorded "
                    f"{want!r} (corrupted or truncated leaf)")
            out[key] = arr
        return out
    except CorruptCheckpointError:
        raise
    except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
        raise CorruptCheckpointError(f"{d}: unreadable ({e})") from e


def restore(tree_like, directory: str, step: int | None = None,
            sharding_tree=None):
    """Restore into the structure of ``tree_like``; returns (tree, step).

    Every leaf is verified against the manifest (shape/dtype/content sum).
    With ``step=None`` the scan walks valid steps newest-to-oldest and
    falls back past any step whose LEAVES fail verification even though
    its manifest checksum holds -- a partially-written or corrupted
    checkpoint costs one interval of progress, never a bad restore.  An
    explicit ``step`` raises CorruptCheckpointError instead.
    ``sharding_tree``: an optional matching tree of placements (module
    docstring) for direct placement onto a mesh."""
    flat = _flatten(tree_like)
    placed = {} if sharding_tree is None else _flatten(sharding_tree)
    if step is not None:
        out, used = _load_step(directory, step, flat), step
    else:
        candidates = [s for s in sorted(_all_steps(directory), reverse=True)
                      if latest_step_valid(directory, s)]
        out = used = None
        for s in candidates:
            try:
                out, used = _load_step(directory, s, flat), s
                break
            except CorruptCheckpointError:
                continue       # torn step: fall back to the previous one
        if out is None:
            raise FileNotFoundError(f"no valid checkpoint under {directory}")
    for key in placed:
        if key not in out:
            raise KeyError(f"sharding_tree leaf {key!r} is not a leaf "
                           "of tree_like")
    for key, like in flat.items():
        where = placed.get(key)
        if hasattr(where, "held"):          # a launch.sharding.Placement
            arr = np.array(out[key][where.held])
            dev = getattr(where.mesh, "device", "cpu")
            t = _to_tensor(arr, torch.empty(0, device=dev))
            out[key] = LayerStack(t.unbind(0)) if isinstance(like, LayerStack) else t
            continue
        if isinstance(like, LayerStack):
            out[key] = LayerStack(_to_tensor(out[key], like[0]).unbind(0))
        elif isinstance(like, torch.Tensor):
            out[key] = _to_tensor(out[key], like)
        if where is not None:
            dev = getattr(where, "device", where)
            out[key] = torch.as_tensor(out[key]).to(torch.device(dev))
    return _unflatten(tree_like, out), used


class CheckpointManager:
    """Async wrapper with a single in-flight writer thread."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None

    def save_async(self, tree, step: int):
        """Snapshot ``tree`` to host arrays now, write it on a thread."""
        self.wait()
        host = {k: _host(v) for k, v in _flatten(tree).items()}
        self._thread = threading.Thread(
            target=_save_flat, args=(host, self.dir, step, self.keep),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, tree_like, sharding_tree=None, step=None):
        return restore(tree_like, self.dir, step, sharding_tree)

    def latest_step(self):
        return latest_step(self.dir)
