"""Tile meshes: Azul's grid of tiles, on one device or one process a tile.

Port of ``repro.launch.mesh``.  The JAX package places one tile on each
device of a ``jax.sharding.Mesh``.  The port has two kinds of mesh, with
one surface (``shape``, ``axis_names``, ``size``, ``device``, ``axes()``,
``group()``, ``index()``, ``local`` / ``local_size``, the tiles this
process holds, and ``barrier()`` / ``broadcast()`` / ``host_gather()``,
the host control of the ranks, which do nothing where one process holds
every tile):

* a :class:`TileMesh` puts every tile of the grid on one device, in one
  process.  Tile ``t`` is the row-major flat index over the axes (the
  order ``jax.make_mesh`` lays its devices in), and a tile-stacked tensor
  holds tile ``t``'s shard at index ``t`` of its tile axis
  (``repro_torch.core.noc``).  A mesh therefore needs no device per tile:
  a (16, 16) production mesh is 256 tiles on one card.
* a :class:`ProcessMesh` is one process a tile over ``torch.distributed``
  (:func:`make_process_mesh`; ``launch.procs`` spawns the ranks): tile
  ``t`` is rank ``t``, row-major over the axes as above, and a rank's
  tile stack has one entry on its tile axis.  The NoC calls are messages
  between the ranks (``core.noc``).  Its ``backend`` is named by the
  caller, always: ``"gloo"`` stages every message through host memory (a
  copy to the host, the collective on CPU tensors, a copy back), so ranks
  may share a card or run on the CPU; ``"nccl"`` needs a card a rank.

A mesh caches the host-built index tensors of its NoC operations
(:meth:`TileMesh.index`), so a captured solve loop reads them and never
copies an index to the device.
"""

from __future__ import annotations

import os
from collections import Counter
from datetime import timedelta
from itertools import combinations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..obs.clock import now

__all__ = ["TileMesh", "ProcessMesh", "make_production_mesh", "make_mesh",
           "make_process_mesh", "leave_process_group", "batch_axes", "AXES",
           "BACKENDS",
           "GROUP_TIMEOUT_S"]

AXES = {"single": ("data", "model"), "multi": ("pod", "data", "model")}
BACKENDS = ("gloo", "nccl")
GROUP_TIMEOUT_S = 120.0       # a collective that waits longer raises


class _Grid:
    """Shape, axes and axis groups of a grid of tiles (both mesh kinds)."""

    per_process = False

    def __init__(self, shape, axis_names):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or not shape:
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             "must be non-empty and of one length")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names repeat: {axis_names}")
        if min(shape) < 1:
            raise ValueError(f"mesh axes need at least one tile: {shape}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.size = int(np.prod(shape))
        self._coords = np.stack(np.unravel_index(np.arange(self.size), shape),
                                axis=1)                       # (P, naxes)
        self._index: dict = {}

    @property
    def devices_shape(self) -> tuple:
        return tuple(self.shape[a] for a in self.axis_names)

    def axes(self, axes) -> tuple:
        """``axes`` (a name or a sequence of names) as a tuple, checked
        against the mesh."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"mesh has no axis {a!r} "
                                 f"(axes {self.axis_names})")
        if len(set(axes)) != len(axes):
            raise ValueError(f"axis names repeat: {axes}")
        return axes

    def group(self, axes) -> tuple[np.ndarray, np.ndarray]:
        """(coord, members) for the axis group ``axes``: ``coord[t]`` is
        tile t's row-major coordinate over ``axes`` (in their order, as
        ``lax.axis_index``), ``members[t]`` the tiles that share t's
        coordinates on every other axis, ordered by that coordinate."""
        axes = self.axes(axes)
        key = ("group", axes)
        got = self._index.get(key)
        if got is not None:
            return got
        pos = [self.axis_names.index(a) for a in axes]
        sizes = [self.shape[a] for a in axes]
        coord = np.ravel_multi_index(tuple(self._coords[:, pos].T), sizes) \
            if axes else np.zeros(self.size, np.int64)
        p = int(np.prod(sizes)) if axes else 1
        members = np.empty((self.size, p), np.int64)
        for t in range(self.size):
            c = self._coords[t].copy()
            for g in range(p):
                c[pos] = np.unravel_index(g, sizes)
                members[t, g] = np.ravel_multi_index(tuple(c),
                                                     self.devices_shape)
        got = (np.asarray(coord, np.int64), members)
        self._index[key] = got
        return got

    def index(self, key, build) -> torch.Tensor:
        """The int64 index tensor ``build()`` (a numpy array) makes, on the
        mesh's device, built once per ``key``.  Building one while a CUDA
        graph is being captured raises: an engine builds every index its
        plans read before their first capture."""
        got = self._index.get(key)
        if got is None:
            if (self.device.type == "cuda"
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError(f"NoC index {key!r} was not built before "
                                   "the capture")
            got = torch.as_tensor(np.asarray(build(), np.int64),
                                  device=self.device)
            self._index[key] = got
        return got


class TileMesh(_Grid):
    """A grid of tiles on one device.

    ``shape`` maps each axis name to its size (in axis order, as
    ``jax.sharding.Mesh.shape``), ``axis_names`` is their order, ``size``
    the number of tiles and ``device`` the ``torch.device`` every tile's
    shard lives on.  The process holds every tile: ``local`` selects all
    of them and ``local_size`` is ``size``."""

    def __init__(self, shape, axis_names, device=DEFAULT_DEVICE):
        super().__init__(shape, axis_names)
        self.device = resolve_device(device)
        self.local = slice(0, self.size)
        self.local_size = self.size

    def barrier(self) -> None:
        """One process holds every tile: nothing to wait for."""

    def broadcast(self, obj, src: int = 0, what: str = "broadcast"):
        """One process holds every tile: ``obj`` itself."""
        return obj

    def host_gather(self, values, what: str) -> np.ndarray:
        """One process holds every tile: ``values`` as a (1, m) float64
        array."""
        return np.asarray([values], np.float64)

    def __repr__(self) -> str:
        return (f"TileMesh({self.devices_shape}, {self.axis_names}, "
                f"device={self.device})")


class NocStats:
    """What a :class:`ProcessMesh` rank's messages cost: ``calls`` and
    ``wire_bytes`` (bytes this rank received from other ranks) by NoC call,
    ``stage_s`` (the copies between the device and the host buffers of the
    gloo backend) and ``comm_s`` (the collectives and sends themselves),
    in seconds on the host's clock."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls: Counter = Counter()
        self.wire_bytes: Counter = Counter()
        self.stage_s = 0.0
        self.comm_s = 0.0

    def as_dict(self) -> dict:
        return {"calls": dict(self.calls), "wire_bytes": dict(self.wire_bytes),
                "stage_s": self.stage_s, "comm_s": self.comm_s}


class ProcessMesh(_Grid):
    """A grid of tiles, one ``torch.distributed`` rank a tile (module
    docstring).  Build it with :func:`make_process_mesh` on every rank of
    an initialized default group of ``size`` ranks.

    ``rank`` is this process's tile, ``coords`` its coordinates over the
    axes, ``local`` selects its tile in tile-indexed host arrays
    (``local_size`` 1), ``stats`` a :class:`NocStats`.  Every axis subset
    with more than one and fewer than ``size`` tiles gets its
    ``torch.distributed`` subgroups here, on every rank in one fixed order
    (``new_group`` is itself a collective), never inside a solve."""

    per_process = True

    def __init__(self, shape, axis_names, backend: str,
                 device=DEFAULT_DEVICE):
        import torch.distributed as dist

        super().__init__(shape, axis_names)
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs an initialized default "
                               "process group (make_process_mesh, "
                               "launch.procs)")
        if dist.get_backend() != backend:
            raise ValueError(f"backend {backend!r} differs from the process "
                             f"group's {dist.get_backend()!r}")
        if dist.get_world_size() != self.size:
            raise ValueError(f"a {self.devices_shape} mesh needs {self.size} "
                             f"ranks, the group has {dist.get_world_size()}")
        self.backend = backend
        self.rank = dist.get_rank()
        self.coords = tuple(int(c) for c in self._coords[self.rank])
        self.local = slice(self.rank, self.rank + 1)
        self.local_size = 1
        self.device = _rank_device(backend, device, self.rank, self.size)
        self._stage = backend == "gloo" and self.device.type == "cuda"
        self._bufs: dict = {}
        self.stats = NocStats()
        # every subgroup, on every rank, in one order: the axis subsets in
        # combinations order, each subset's groups by their first tile
        self._groups: dict = {}
        for k in range(1, len(axis_names) + 1):
            for axes in combinations(self.axis_names, k):
                members = self.group(axes)[1]
                p = members.shape[1]
                if p in (1, self.size):
                    continue
                lists = sorted({tuple(sorted(int(r) for r in row))
                                for row in members})
                mine, _ = dist.new_subgroups_by_enumeration(
                    [list(ls) for ls in lists])
                self._groups[frozenset(axes)] = mine

    # -- transport ------------------------------------------------------------

    def _buffer(self, key, shape, dtype) -> torch.Tensor:
        """A host buffer for a message: on the gloo backend on a card one
        pinned buffer a (key, shape, dtype), reused (every copy through it
        is synchronous); otherwise a fresh tensor on the mesh's device."""
        if not self._stage:
            return torch.empty(shape, dtype=dtype, device=self.device)
        key = (key, tuple(shape), dtype)
        buf = self._bufs.get(key)
        if buf is None:
            # a normal tensor even when made under inference mode (a
            # serving step), so that later calls outside it may refill it
            with torch.inference_mode(False):
                buf = self._bufs[key] = torch.empty(shape, dtype=dtype,
                                                    pin_memory=True)
        return buf

    def _host(self, t: torch.Tensor, key) -> torch.Tensor:
        """``t`` as the buffer a message sends: on the gloo backend on a
        card, its copy in a pinned host buffer (the device's queued work
        finished first, so the copy's time is the copy's)."""
        if not self._stage:
            return t.contiguous()
        torch.cuda.synchronize(self.device)
        t0 = now()
        h = self._buffer(key, t.shape, t.dtype).copy_(t)
        self.stats.stage_s += now() - t0
        return h

    def _dev(self, h: torch.Tensor) -> torch.Tensor:
        """A received host buffer back on the mesh's device (a copy: the
        buffer is reused)."""
        if not self._stage:
            return h
        t0 = now()
        d = h.to(self.device)
        self.stats.stage_s += now() - t0
        return d

    def _member_order(self, axes) -> tuple:
        """(members of this tile's group in coordinate order, each one's
        rank in the subgroup, which ranks its members in global order)."""
        mem = [int(r) for r in self.group(axes)[1][self.rank]]
        by_rank = {r: i for i, r in enumerate(sorted(mem))}
        return mem, [by_rank[r] for r in mem]

    def gather(self, xs: torch.Tensor, axes, what: str) -> torch.Tensor:
        """(..., 1, m) -> (..., 1, p, m): the shards of this tile's group
        along ``axes``, in coordinate order (one ``all_gather`` over the
        axes' subgroup)."""
        import torch.distributed as dist

        axes = self.axes(axes)
        mem, grank = self._member_order(axes)
        p = len(mem)
        self.stats.calls[what] += 1
        if p == 1:
            return xs.unsqueeze(-2)
        h = self._host(xs, "send")
        got = [self._buffer(("gather", i), h.shape, h.dtype)
               for i in range(p)]
        t0 = now()
        dist.all_gather(got, h, group=self._groups.get(frozenset(axes)))
        self.stats.comm_s += now() - t0
        self.stats.wire_bytes[what] += (p - 1) * h.numel() * h.element_size()
        if not self._stage:
            return torch.stack([got[g] for g in grank], dim=-2)
        # each member's buffer copied straight into its slot on the card
        t0 = now()
        out = torch.empty(h.shape[:-1] + (p, h.shape[-1]), dtype=h.dtype,
                          device=self.device)
        for c, g in enumerate(grank):
            out[..., c, :].copy_(got[g])
        self.stats.stage_s += now() - t0
        return out

    def all_to_all(self, xs: torch.Tensor, axes, what: str) -> torch.Tensor:
        """(..., 1, p, m) -> (..., 1, p, m): chunk c of this tile's stack
        goes to the group member at coordinate c, and slot c of the result
        holds what that member sent this tile (one ``all_to_all_single``
        over the axes' subgroup)."""
        import torch.distributed as dist

        axes = self.axes(axes)
        mem, grank = self._member_order(axes)
        p = len(mem)
        self.stats.calls[what] += 1
        if p == 1:
            return xs
        # dim 0 in subgroup rank order, as all_to_all_single splits it
        inv = [0] * p
        for c, g in enumerate(grank):
            inv[g] = c
        send = torch.stack([xs[..., c, :] for c in inv])
        h = self._host(send, "send")
        got = self._buffer("all_to_all", h.shape, h.dtype)
        t0 = now()
        dist.all_to_all_single(got, h, group=self._groups.get(frozenset(axes)))
        self.stats.comm_s += now() - t0
        self.stats.wire_bytes[what] += (p - 1) * h[0].numel() * h.element_size()
        return self._dev(got)[grank].movedim(0, -2)

    def permute(self, xs: torch.Tensor, axes, perm, what: str) -> torch.Tensor:
        """``lax.ppermute`` of this rank's (..., 1, m) shard over the axis
        group ``axes``: sends to and receives from its peers with one
        ``batch_isend_irecv``; a fixed point is a local copy, and a tile no
        pair reaches receives zeros."""
        import torch.distributed as dist

        coord, members = self.group(axes)
        c, mem = int(coord[self.rank]), members[self.rank]
        dsts = [int(mem[d]) for s, d in perm if s == c]
        srcs = [int(mem[s]) for s, d in perm if d == c]
        src = srcs[0] if srcs else None
        self.stats.calls[what] += 1
        remote = [d for d in dsts if d != self.rank]
        ops, buf = [], None
        if remote:
            h = self._host(xs, "send")
            ops += [dist.P2POp(dist.isend, h, d) for d in remote]
        if src is not None and src != self.rank:
            buf = self._buffer("recv", xs.shape, xs.dtype)
            ops.append(dist.P2POp(dist.irecv, buf, src))
        if ops:
            t0 = now()
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            self.stats.comm_s += now() - t0
        if src is None:
            return torch.zeros_like(xs)
        if buf is None:
            return xs.clone()
        self.stats.wire_bytes[what] += buf.numel() * buf.element_size()
        return self._dev(buf)

    # -- host control ---------------------------------------------------------

    def barrier(self) -> None:
        """Wait until every rank of the mesh's world group reaches here."""
        import torch.distributed as dist

        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def broadcast(self, obj, src: int = 0, what: str = "broadcast"):
        """Rank ``src``'s ``obj`` (a small picklable host object) on every
        rank; the other ranks' ``obj`` is ignored.  Two collectives over
        the world group (the pickle's length, then its bytes), counted in
        ``stats`` under ``what`` (the bytes on the ranks that receive)."""
        import pickle

        import torch.distributed as dist

        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        mine = self.rank == src
        data = pickle.dumps(obj) if mine else b""
        size = torch.tensor([len(data)], dtype=torch.int64, device=dev)
        t0 = now()
        dist.broadcast(size, src)
        n = int(size.item())
        buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
               if mine else torch.empty(n, dtype=torch.uint8, device=dev))
        dist.broadcast(buf, src)
        self.stats.comm_s += now() - t0
        self.stats.calls[what] += 1
        if mine:
            return obj
        self.stats.wire_bytes[what] += n
        return pickle.loads(buf.cpu().numpy().tobytes())

    def host_gather(self, values, what: str) -> np.ndarray:
        """Every rank's ``values`` (m host floats), in rank order: a (size,
        m) float64 array, the same on every rank (one ``gather`` over
        every axis; a ranked max or sum of a host reading is a reduction
        of its column)."""
        mine = torch.tensor([values], dtype=torch.float64, device=self.device)
        got = self.gather(mine, self.axis_names, what)
        return got.reshape(self.size, -1).cpu().numpy()

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.devices_shape}, {self.axis_names}, "
                f"rank={self.rank}, backend={self.backend!r}, "
                f"device={self.device})")


def _rank_device(backend: str, device, rank: int, size: int) -> torch.device:
    """The device a rank runs on: the one asked for under gloo (ranks may
    share a card: "cuda" is the current one, card 0 unless the caller made
    another current); under nccl card ``rank``, which needs a card a rank
    -- nothing falls back to another backend."""
    dev = resolve_device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend runs on cards; got device "
                             f"{device!r}")
        if torch.cuda.device_count() < size:
            raise RuntimeError(
                f"the nccl backend needs a card a rank: {size} ranks, "
                f"{torch.cuda.device_count()} cards (ranks that share a card "
                "take backend='gloo')")
        return torch.device("cuda", rank)
    return dev


def pin_device(backend: str, device, rank: int, size: int) -> torch.device:
    """Resolve a rank's device and make it current before any other CUDA
    call of the process (``torch.cuda.set_device``)."""
    dev = _rank_device(backend, device, rank, size)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return dev


def make_mesh(shape, axes, device=DEFAULT_DEVICE) -> TileMesh:
    """A :class:`TileMesh` of ``shape`` over ``axes`` on ``device``
    ("cuda" by default, which raises where there is no card)."""
    return TileMesh(shape, axes, device)


def make_process_mesh(shape, axes, *, backend: str,
                      device=DEFAULT_DEVICE) -> ProcessMesh:
    """A :class:`ProcessMesh` of ``shape`` over ``axes``, called on every
    rank.  It joins the default process group where one is initialized
    (``launch.procs``, or the caller's own ``init_process_group``);
    otherwise, as under ``torchrun`` (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` in the environment), it
    initializes one with ``backend`` and a GROUP_TIMEOUT_S timeout on
    every collective.  The rank's device is made current before any other
    CUDA call."""
    import torch.distributed as dist

    size = int(np.prod([int(s) for s in shape]))
    joined = not dist.is_initialized()
    if joined:
        if "RANK" not in os.environ:
            raise RuntimeError(
                "no process group: run under torchrun or launch.procs, or "
                "call torch.distributed.init_process_group first")
        pin_device(backend, device, int(os.environ["RANK"]), size)
        dist.init_process_group(backend,
                                timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    else:
        pin_device(backend, device, dist.get_rank(), size)
    mesh = ProcessMesh(shape, axes, backend, device)
    mesh.joined = joined
    return mesh


def leave_process_group(mesh) -> None:
    """End this rank's part in the group :func:`make_process_mesh` joined
    for it (the torchrun path): one barrier, then the group destroyed here.
    A gloo group left to the interpreter's exit can abort the process as
    its threads are torn down ("terminate called without an active
    exception", exit code -6, under a loaded host), failing the run after
    its result.  Nothing where the caller's group was joined
    (``launch.procs``, the caller's own ``init_process_group``)."""
    if getattr(mesh, "joined", False):
        import torch.distributed as dist

        mesh.barrier()
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device=DEFAULT_DEVICE) -> TileMesh:
    """The JAX package's production grid: (16, 16) tiles over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return make_mesh(shape, AXES["multi" if multi_pod else "single"], device)


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes the global batch shards over (everything except 'model')."""
    return tuple(a for a in mesh.axis_names if a != "model")
