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

A state placed on a process grid (``launch.sharding.Placement`` s on a
``launch.mesh.ProcessMesh``, passed as ``placements=``, a tree matching
the state's) is saved as its whole leaves: each placed leaf is gathered
over the mesh, on every rank, one leaf at a time and in the flattening
order (the gathers are collectives; a layer group's leaf a layer at a
time), and rank 0 alone writes, so the files are those of the
one-process save of the same global state.  No rank holds more than one
whole leaf (one layer of a stacked leaf) on its device at a time; rank 0
holds the host copies of every leaf until they are written (the whole
state's bytes), the other ranks none.  :class:`CheckpointManager` with
``mesh=`` runs on every rank: rank 0 writes, ``latest_step`` is rank 0's
(broadcast), and a restore waits for rank 0's writer and meets the other
ranks at a barrier before any rank reads.

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
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..models.model import LayerStack, Model, param_leaves, replace_params
from ..obs.clock import now

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
    if isinstance(tree, dict) and tree and all(isinstance(k, tuple) for k in tree):
        return {k: flat[_SEP.join(path + tuple(str(q) for q in k))]
                for k in tree}
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


_SUM_ROWS = 128       # buffer-size chunks a block of the content sum
_SUM_THREADS = 4


def _f64(arr: np.ndarray) -> np.ndarray:
    """``arr`` widened to float64 (bfloat16 through its float32 bits)."""
    if arr.dtype == _BF16:
        f32 = (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
        return f32.astype(np.float64)
    return arr.astype(np.float64)


def _f64_sum(arr: np.ndarray) -> float:
    """``float(np.sum(_f64(arr)))`` bit for bit, without the whole float64
    copy.  numpy sums a contiguous array as a running sum, in order, of the
    pairwise sums of its ``np.getbufsize()``-element chunks; here the
    chunks' pairwise sums are taken a block of _SUM_ROWS chunks at a time
    (each block widened alone) on _SUM_THREADS threads, and added in
    order by ``np.cumsum``."""
    flat = np.ascontiguousarray(arr).reshape(-1)
    n, w = flat.size, np.getbufsize()
    k = n // w
    if k <= _SUM_ROWS:
        return float(np.sum(_f64(flat))) if n else 0.0

    def block(i):
        return np.add.reduce(_f64(flat[i * w:min(i + _SUM_ROWS, k) * w])
                             .reshape(-1, w), axis=1)

    with ThreadPoolExecutor(_SUM_THREADS) as ex:
        sums = list(ex.map(block, range(0, k, _SUM_ROWS)))
    if n > k * w:
        sums.append(np.array([np.sum(_f64(flat[k * w:]))]))
    return float(np.cumsum(np.concatenate(sums))[-1])


def _meta(arr: np.ndarray) -> tuple:
    """(dtype name, f64 content sum) of a host leaf, as the manifest
    records them."""
    return ("bfloat16" if arr.dtype == _BF16 else str(arr.dtype)), _f64_sum(arr)


def _to_tensor(arr: np.ndarray, like) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(like.device)


def grid_of(placements):
    """The ``launch.mesh.ProcessMesh`` of a tree of placements (None when
    none of them is on one: no placements, or one process holds every
    tile)."""
    if placements is None:
        return None
    for pl in _flatten(placements).values():
        if getattr(pl, "per_process", False):
            return pl.mesh
    return None


def _writes(mesh) -> bool:
    """Does this process write the checkpoints: rank 0 of a process grid,
    or the one process."""
    return not getattr(mesh, "per_process", False) or mesh.rank == 0


def _whole_host(leaf, pl, keep: bool):
    """The host copy of ``leaf`` whole (None where this process keeps
    none): gathered over the mesh first where ``pl`` places it on a
    process grid -- a ``LayerStack`` a layer at a time (the messages the
    train step's per-layer gathers send), stacked on the host."""
    if not getattr(pl, "per_process", False):
        return _host(leaf) if keep else None
    if isinstance(leaf, LayerStack):
        row, layers = pl.row(), []
        for t in leaf:
            whole = row.gather(t.detach(), "checkpoint")
            if keep:
                layers.append(_host(whole))
            del whole
        return np.stack(layers) if keep else None
    whole = pl.gather(leaf.detach(), "checkpoint")
    return _host(whole) if keep else None


def _host_tree(tree, placements=None, keep: bool = True) -> dict:
    """flat key -> the host copy of each whole leaf of ``tree`` (module
    docstring: the gathers run on every rank, one leaf at a time; only a
    ``keep`` process keeps the copies)."""
    placed = {} if placements is None else _flatten(placements)
    out = {}
    for key, leaf in _flatten(tree).items():
        got = _whole_host(leaf, placed.get(key), keep)
        if keep:
            out[key] = got
    return out


def save(tree, directory: str, step: int, keep: int | None = 3,
         placements=None) -> str:
    """Write ``tree`` as step ``step``; with ``placements`` on a process
    grid every rank calls it, rank 0 writes, and it returns on every rank
    once the step is on disk (module docstring)."""
    mesh = grid_of(placements)
    host = _host_tree(tree, placements, _writes(mesh))
    final = (_save_flat(host, directory, step, keep) if _writes(mesh)
             else os.path.join(directory, f"step_{step:08d}"))
    if mesh is not None:
        mesh.barrier()
    return final


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
    """Async wrapper with a single in-flight writer thread.

    ``mesh`` (a ``launch.mesh.ProcessMesh``): the manager of one run on
    every rank of the grid (module docstring) -- every rank calls each
    method in the same order.  None, or a ``TileMesh``, is the one
    process's manager.  ``stats`` holds what the last save cost
    (``gather_s``, the snapshot to host arrays on the main thread with
    its gathers; ``host_bytes``, the host copies this process held;
    ``write_s`` once written) and the last restore (``restore_s``, the
    barrier's wait included)."""

    def __init__(self, directory: str, keep: int = 3, mesh=None):
        self.dir = directory
        self.keep = keep
        self.mesh = mesh
        self.stats: dict = {}
        self._thread: threading.Thread | None = None

    def save_async(self, tree, step: int, placements=None):
        """Snapshot ``tree`` to host arrays now (gathering the leaves that
        ``placements`` places on the grid), write it on a thread."""
        self.wait()
        if (grid_of(placements) is not None
                and not getattr(self.mesh, "per_process", False)):
            raise ValueError("placements on a process grid need the "
                             "manager of that grid (CheckpointManager(mesh=))")
        writes = _writes(self.mesh)
        t0 = now()
        host = _host_tree(tree, placements, writes)
        self.stats.pop("write_s", None)
        self.stats.update(step=step, gather_s=now() - t0,
                          host_bytes=sum(a.nbytes for a in host.values()))
        if writes:
            self._thread = threading.Thread(
                target=self._write, args=(host, step), daemon=True)
            self._thread.start()

    def _write(self, host: dict, step: int) -> None:
        t0 = now()
        _save_flat(host, self.dir, step, self.keep)
        self.stats["write_s"] = now() - t0

    def wait(self):
        """Drain this process's writer (rank 0's on a grid; a local wait,
        not a collective)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, tree_like, sharding_tree=None, step=None):
        """:func:`restore` from the manager's directory; on a grid after
        rank 0's writer is drained and every rank has met at a barrier."""
        t0 = now()
        self.wait()
        if self.mesh is not None:
            self.mesh.barrier()
        got = restore(tree_like, self.dir, step, sharding_tree)
        self.stats["restore_s"] = now() - t0
        return got

    def latest_step(self):
        """The newest valid step (None when there is none): on a grid rank
        0's answer, on every rank."""
        got = latest_step(self.dir) if _writes(self.mesh) else None
        return got if self.mesh is None else self.mesh.broadcast(got)
