"""Rank side of ``tests/test_torch_procserve.py``; no tests of its own.

The spawned ranks import this module by name (``tests/`` and the repo
root are on their ``sys.path``) and run :func:`rank_main` (one layout's
parity and every other case) or :func:`rank_parity` (the other layout's,
in a second group spawned beside the first) on a 2x2 ``ProcessMesh``;
the test process runs the same case functions on the one-process
``TileMesh`` grid and holds each rank to them.  Neither side imports
JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os

import numpy as np
import scipy.sparse as sp

import chip_smoke as CHIP
from repro_torch.core import AzulEngine
from repro_torch.data import matrices as tmat
from repro_torch.launch import serve as serve_cli
from repro_torch.obs import clock
from repro_torch.serve import SolveServer, SolveService, run_load
from repro_torch.serve import service as service_mod

GRID, AXES = (2, 2), ("data", "model")
LAYOUTS = ("dense", "halo")
# chip_smoke.SERVICE_PARITY's lap2d_32 script (chunk 8, max_batch 4, two
# requests, three ticks, four more, drained) on the 2x2 grid
PARITY = "lap2d_32"
OPERATOR = dict(CHIP.SERVICE_OPERATOR, dtype=np.float64)

# the other cases run banded_1k (9 iterations at tol 1e-8), in short chunks
SMALL = "banded_1k"
# the clocks: rank r reads offset + rate * (virtual time); rank 0's is the
# one-process run's.  A plan call takes CHUNK_S of virtual time, chunk
# SLOW_CHUNK SLOW_S on SLOW_RANK alone (the one-process run: on its clock)
CLOCKS = ((0.0, 1.0), (1000.0, 3.0), (-50.0, 0.25), (7.5, 0.5))
CHUNK_S, SLOW_S, SLOW_CHUNK, SLOW_RANK = 0.1, 1.0, 7, 1
# the clock scenario's service: one lane, aging 1 s a point
CLOCK_CHUNK, WAIT_S = 4, 10.0
# the legacy deadline path (chunks of CLOCK_CHUNK): a deadline rank 0's
# clock passes after the second chunk, before convergence (rank 1's own
# clock would pass it after the first)
SHIM_DEADLINE_S = 0.15
# launch.serve --solver --processes (under torchrun's environment in the
# ranks, and spawned from the test process)
_CLI = ["--solver", "--device", "cpu", "--matrix", SMALL, "--mesh-shape",
        "2x2", "--requests", "6", "--coalesce", "4", "--chunk", "10"]
CLI_ARGV = {"drain": _CLI,
            "closed": _CLI + ["--load-gen", "closed", "--concurrency", "3"]}
# the open loop on the real clock: rank 0's clock says what is due
OPEN = dict(requests=6, rate=400.0)


class SkewedClock(clock.FakeClock):
    """A fake clock that reads ``offset + rate * t`` of its virtual time
    ``t`` (``advance``/``sleep`` move ``t``)."""

    def __init__(self, offset: float, rate: float):
        super().__init__()
        self.offset, self.rate = offset, rate

    def now(self) -> float:
        return self.offset + self.rate * self._t


class Timed:
    """A plan whose every call takes ``CHUNK_S`` of virtual time on
    ``clk`` (``SLOW_S`` for call ``SLOW_CHUNK`` where ``slow``)."""

    def __init__(self, plan, clk, slow: bool, calls: list):
        self._plan, self._clk, self._slow, self._calls = plan, clk, slow, calls

    def __getattr__(self, name):
        return getattr(self._plan, name)

    def __call__(self, batch, x0=None):
        out = self._plan(batch, x0=x0)
        self._calls.append(1)
        late = self._slow and len(self._calls) == SLOW_CHUNK
        self._clk.advance(SLOW_S if late else CHUNK_S)
        return out


def _rhs(m, count: int, seed: int) -> np.ndarray:
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    return (a @ np.random.default_rng(seed).standard_normal(
        (count, m.shape[0])).T).T


def outcomes(outs) -> dict:
    """Per request, in the order given: iters, status, x (end to end)."""
    return {"iters": [int(o.iters) for o in outs],
            "status": [o.status for o in outs],
            "x": np.concatenate([o.x for o in outs])}


def stats_of(svc) -> dict:
    return json.loads(json.dumps(dict(svc.stats)))


# -- the cases (``mesh``: a rank's ProcessMesh or the one-process TileMesh) ------


def parity(mesh, layout: str) -> dict:
    """SERVICE_PARITY's lap2d_32 script on ``mesh`` in ``layout``; the
    outcomes, the stats and (a process grid) the clock collectives the
    ticks and chunks made."""
    script = CHIP.SERVICE_PARITY[PARITY]
    m = tmat.suite("small")[PARITY]
    svc = SolveService(max_batch=script["max_batch"], chunk=script["chunk"],
                       device=mesh.device)
    svc.register_operator(PARITY, m, layout=layout, mesh=mesh, **OPERATOR)
    if mesh.per_process:
        mesh.stats.reset()
    out = outcomes(CHIP.service_script(svc, m, script))
    out["stats"] = stats_of(svc)
    if mesh.per_process:
        calls = mesh.stats.calls
        out["clock_calls"] = [calls["serve_tick_clock"],
                              calls["serve_chunk_clock"]]
    return out


def clocks(mesh, rank: int) -> dict:
    """Priorities with aging, a deadline-0 request and a straggler chunk on
    one lane, under ``CLOCKS[rank]``: a busy request, an old low-priority
    one, WAIT_S later a high-priority one and a deadline-0 one."""
    m = tmat.suite("small")[SMALL]
    b = _rhs(m, 4, 11)
    with clock.override(SkewedClock(*CLOCKS[rank])) as clk:
        svc = SolveService(max_batch=1, chunk=CLOCK_CHUNK, aging=1.0,
                           device=mesh.device)
        svc.register_operator("lap", m, mesh=mesh, **OPERATOR)
        pool, calls = svc._operators["lap"].pools["cb"], []
        pool[1] = Timed(svc.plan_for("lap", 1, "cb"), clk,
                        rank == (SLOW_RANK if mesh.per_process else 0), calls)
        t_start = clk.now()
        ids = [svc.submit(b[0])]
        done = svc.tick()
        ids.append(svc.submit(b[1], priority=0.0))
        clk.advance(WAIT_S)
        ids.append(svc.submit(b[2], priority=5.0))
        ids.append(svc.submit(b[3], deadline=0.0))
        finish = list(done)
        while svc.pending() or svc.active():
            got = svc.tick()
            done.update(got)
            finish += sorted(got)
        span = clk.now() - t_start
    lat = service_mod._M_LATENCY_S.labels(service=svc._obs_label)
    out = outcomes([done[i] for i in ids])
    out["finish"] = [ids.index(i) for i in finish]
    # the latency metric on this rank's own clock: (count, sum, span)
    out["latency"] = (lat.count, lat.sum, span)
    out["stats"] = stats_of(svc)
    return out


def evictions(mesh) -> dict:
    """Two operators under a budget that holds the larger alone: the
    smaller's registration evicts it, a request to it reloads it (evicting
    the smaller), and one to the smaller reloads that in turn."""
    mats = {"big": tmat.suite("small")[SMALL], "small": tmat.laplacian_2d(8)}
    svc = SolveService(max_batch=2, chunk=8, device=mesh.device)
    big = svc.register_operator("big", mats["big"], mesh=mesh, **OPERATOR)
    svc.memory_limit = big.bytes
    svc.register_operator("small", mats["small"], mesh=mesh, **OPERATOR)
    done = {}
    ids = []
    for i, name in enumerate(("big", "small")):
        ids.append(svc.submit(_rhs(mats[name], 1, 3 + i)[0], name))
        done.update(svc.drain())
    out = outcomes([done[i] for i in ids])
    out["stats"] = stats_of(svc)
    out["bytes"] = {k: i.bytes for k, i in svc.operators().items()}
    out["resident"] = {k: i.resident for k, i in svc.operators().items()}
    return out


def shim(mesh, rank: int) -> dict:
    """The deprecated ``SolveServer`` on a grid engine under
    ``CLOCKS[rank]``: one coalesced full-budget ``step``, then a batch
    with a deadline through the legacy deadline path, whose chunks take
    CHUNK_S of virtual time each."""
    m = tmat.suite("small")[SMALL]
    b = _rhs(m, 5, 12)
    eng = AzulEngine(m, mesh=mesh, dtype=np.float64)
    with clock.override(SkewedClock(*CLOCKS[rank])) as clk:
        srv = SolveServer(eng, max_batch=4, method="pcg_tol", tol=1e-8,
                          max_iters=400, deadline_chunk=CLOCK_CHUNK)
        first = [srv.submit(x) for x in b[:3]]
        done = srv.step()
        srv._chunk_plans[2] = Timed(srv._service.plan_for("default", 2,
                                                          "chunk"),
                                    clk, False, [])
        rest = [srv.submit(b[3], deadline=SHIM_DEADLINE_S),
                srv.submit(b[4])]
        done.update(srv.drain())
    out = outcomes([done[i] for i in first + rest])
    out["stats"] = stats_of(srv)
    return out


def open_loop(mesh) -> dict:
    """``run_load``'s open loop on the real clock (the CLI's recording
    wrappers): every outcome, by request id."""
    m = tmat.suite("small")[SMALL]
    rhs = _rhs(m, 4, 5)
    svc = SolveService(max_batch=4, chunk=10, device=mesh.device)
    svc.register_operator(SMALL, m, mesh=mesh, **OPERATOR)
    seen, tick = {}, svc.tick

    def recording_tick():
        got = tick()
        seen.update(got)
        return got

    svc.tick = recording_tick
    res = run_load(svc, lambda i: rhs[i % 4], operator=SMALL, mode="open",
                   **OPEN)
    ids = sorted(seen)
    out = outcomes([seen[i] for i in ids])
    out.update(ids=ids, completed=res["completed"],
               rejected=res["rejected"], statuses=res["statuses"])
    return out


def cli(argv: list) -> tuple:
    """(exit code, JSON or None) of ``launch.serve`` in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = serve_cli.main(argv)
    text = buf.getvalue()
    return code, json.loads(text[text.index("{"):]) if text else None


def rank_raises(rank) -> None:
    """On a 2x1 grid rank 1 raises before a tick; rank 0 waits in its
    broadcast."""
    mesh = rank.mesh((2, 1), AXES)
    m = tmat.laplacian_2d(8)
    svc = SolveService(max_batch=2, chunk=4, device=mesh.device)
    svc.register_operator("lap", m, mesh=mesh, **OPERATOR)
    svc.submit(_rhs(m, 1, 0)[0])
    if rank.rank == 1:
        raise RuntimeError("rank 1 fails before its tick")
    svc.tick()


def rank_parity(rank, layout: str) -> dict:
    """The parity script in ``layout`` on this rank."""
    return {"rank": rank.rank, "parity": parity(rank.mesh(GRID, AXES), layout)}


def rank_main(rank, layout: str) -> dict:
    """The parity script in ``layout``, then every other case, on this rank
    (``rank``: a ``launch.procs.Rank``)."""
    mesh = rank.mesh(GRID, AXES)
    r = rank.rank
    out = {"rank": r, "parity": parity(mesh, layout),
           "clocks": clocks(mesh, r), "evictions": evictions(mesh),
           "shim": shim(mesh, r), "open": open_loop(mesh)}
    # launch.serve --processes under torchrun's environment: the group
    # exists, so the CLI joins it
    os.environ.update(RANK=str(r), WORLD_SIZE=str(rank.size))
    out["cli"] = {k: cli(argv + ["--processes"])
                  for k, argv in CLI_ARGV.items()}
    return out
