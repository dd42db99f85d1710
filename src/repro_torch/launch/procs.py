"""Spawn the ranks of one ``torch.distributed`` group on this host.

    from repro_torch.launch import procs

    def solve(rank, shape):              # a module-level function
        mesh = rank.mesh(shape, ("data", "model"))
        ...
        return result                    # picklable

    results = procs.run(solve, 4, ((2, 2),), backend="gloo", device="cpu")

:func:`run` starts ``nprocs`` processes with the ``spawn`` start method
(never ``fork``: CUDA and torch's thread pools do not survive it).  Each
rank makes its device current before any other CUDA call, joins the group
at a ``FileStore`` in a fresh temporary directory (no fixed port, so
concurrent runs cannot collide), with ``mesh.GROUP_TIMEOUT_S`` on every
collective, and calls ``fn(rank, *args)`` with a :class:`Rank`.  The
parent waits with its own deadline: when it passes, or as soon as any
rank fails, every rank still running is killed and the parent raises
(with the failed rank's traceback).  It returns the ranks' results in
rank order.

On a card the parent builds the kernel library first
(``kernels.build.library``), so the ranks load it instead of running
``nvcc`` all at once.  The backend is the caller's: ``"gloo"`` (ranks may
share a card, or run on the CPU) or ``"nccl"`` (a card a rank; fewer
cards raise).
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
import traceback
from datetime import timedelta
from multiprocessing.connection import wait
from typing import NamedTuple

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..obs.clock import now
from .mesh import BACKENDS, GROUP_TIMEOUT_S, make_process_mesh, pin_device

__all__ = ["Rank", "run", "RUN_TIMEOUT_S"]

RUN_TIMEOUT_S = 600.0          # the parent's deadline for the whole run
_POLL_S = 0.05


class Rank(NamedTuple):
    """What a spawned rank is: its rank, the group's size, the backend and
    the device it runs on; :meth:`mesh` builds its ``ProcessMesh``."""

    rank: int
    size: int
    backend: str
    device: str

    def mesh(self, shape, axes):
        return make_process_mesh(shape, axes, backend=self.backend,
                                 device=self.device)


def _entry(fn, args, rank: Rank, store: str, out: str) -> None:
    """A rank's process: pin the device, join the group, run ``fn`` and
    leave its result (or its traceback) in ``out``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        pin_device(rank.backend, rank.device, rank.rank, rank.size)
        dist.init_process_group(
            rank.backend, store=dist.FileStore(store, rank.size),
            rank=rank.rank, world_size=rank.size,
            timeout=timedelta(seconds=GROUP_TIMEOUT_S))
        got = ("ok", fn(rank, *args))
    except BaseException:
        got = ("error", traceback.format_exc())
    with open(out + ".tmp", "wb") as f:
        pickle.dump(got, f)
    os.replace(out + ".tmp", out)
    sys.stdout.flush()
    sys.stderr.flush()
    if got[0] != "ok":
        os._exit(1)            # no teardown: the other ranks may be stuck
    dist.destroy_process_group()


def _error(out: str) -> str:
    try:
        with open(out, "rb") as f:
            status, payload = pickle.load(f)
    except (OSError, EOFError, pickle.UnpicklingError):
        return "(no traceback: the process died)"
    return payload if status == "error" else "(exited after its result)"


def _raise_failed(ranks: list, outs: list) -> None:
    """Raise with the traceback of every rank that has exited with an
    error (a rank's failure often fails its peers' collectives too)."""
    bad = [r for r, p in enumerate(ranks) if p.exitcode not in (None, 0)]
    if bad:
        raise RuntimeError(
            f"{len(bad)} of {len(ranks)} ranks failed: " + "\n".join(
                f"rank {r} (exit code {ranks[r].exitcode}):\n"
                f"{_error(outs[r])}" for r in bad))


def run(fn, nprocs: int, args: tuple = (), *, backend: str,
        device=DEFAULT_DEVICE, timeout_s: float = RUN_TIMEOUT_S) -> list:
    """Run ``fn(Rank, *args)`` on ``nprocs`` spawned ranks (module
    docstring); returns their results in rank order.  ``fn`` and ``args``
    must pickle (``fn`` a module-level function)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if backend == "nccl" and torch.cuda.device_count() < nprocs:
            raise RuntimeError(
                f"the nccl backend needs a card a rank: {nprocs} ranks, "
                f"{torch.cuda.device_count()} cards (ranks that share a card "
                "take backend='gloo')")
        from ..kernels import build

        build.library()
    elif backend == "nccl":
        raise ValueError("the nccl backend runs on cards; got device "
                         f"{device!r}")
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(nprocs)]
        ranks = [ctx.Process(
            target=_entry,
            args=(fn, tuple(args), Rank(r, nprocs, backend, str(device)),
                  os.path.join(tmp, "store"), outs[r]))
            for r in range(nprocs)]
        try:
            for p in ranks:
                p.start()
            deadline = now() + timeout_s
            while any(p.is_alive() for p in ranks):
                _raise_failed(ranks, outs)
                if now() > deadline:
                    raise TimeoutError(
                        f"{nprocs} ranks ran past the {timeout_s:.0f} s "
                        "deadline; killed them")
                wait([p.sentinel for p in ranks if p.is_alive()], _POLL_S)
            _raise_failed(ranks, outs)
        finally:
            started = [p for p in ranks if p.pid is not None]
            for p in started:
                if p.is_alive():
                    p.kill()
            for p in started:
                p.join(10)
        results = []
        for out in outs:
            with open(out, "rb") as f:
                results.append(pickle.load(f)[1])
        return results
