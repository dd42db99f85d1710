"""Rank side of ``tests/test_torch_procmesh.py``; no tests of its own.

The spawned ranks import this module by name (``tests/`` is on their
``sys.path``) and run :func:`rank_main` on their ``ProcessMesh``; the
test process runs the same case functions on a one-process ``TileMesh``
and holds each rank's results to them.  Neither side imports JAX.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from repro_torch import convert
from repro_torch.core import AzulEngine, SolveSpec, noc
from repro_torch.core.formats import csr_from_scipy
from repro_torch.data import matrices as tmat
from test_torch_dist_cases import MESHES, eng_case, matrix

NOC_M = 8                     # words of a NoC test shard
NOC_K = (None, 3)             # 1-D shards and (3, m) batched ones
SPEC = dict(method="pcg_tol", tol=1e-8, max_iters=2000)
CALLS = 2                     # calls of each plan (traces stay 1)
SPTRSV_ENGINE = eng_case("lap16", "2x2", balance="rows")

# solve cases: id -> (engine case, SolveSpec fields, lanes).  The
# "matrix|mesh|mode" ones are chip_smoke.DIST_PARITY's (JAX's counts; on
# 2x2 lap2d_32's layout "auto" is dense); the others' JAX counts come from
# the test's JAX subprocess
SOLVES = {
    "lap2d_32|2x2|2d": (eng_case("lap2d_32", "2x2"), SPEC, None),
    "banded_1k|2x2|2d": (eng_case("banded_1k", "2x2"), SPEC, None),
    "lap2d_32|4x1|2d": (eng_case("lap2d_32", "4x1"), SPEC, None),
    "lap2d_32|4x1|1d": (eng_case("lap2d_32", "4x1", mode="1d"), SPEC, None),
    "banded_1k|4x1|2d": (eng_case("banded_1k", "4x1"), SPEC, None),
    "banded_1k|4x1|1d": (eng_case("banded_1k", "4x1", mode="1d"), SPEC,
                         None),
    "lap2d_32|mp|2d": (eng_case("lap2d_32", "mp"), SPEC, None),
    "halo": (eng_case("lap2d_32", "2x2", layout="halo"), SPEC, None),
    "halo_1d": (eng_case("lap2d_32", "4x1", mode="1d", layout="halo"), SPEC,
                None),
    "block_ic0": (eng_case("lap2d_32", "2x2", precond="block_ic0"), SPEC,
                  None),
    "k4": (eng_case("lap2d_32", "2x2"), dict(SPEC, batch=4), 4),
    "pipelined": (eng_case("lap2d_32", "2x2", layout="halo"),
                  dict(SPEC, method="pcg_pipelined_tol"), None),
}
JAX_SOLVES = ("halo", "halo_1d", "block_ic0", "k4", "pipelined")


def mesh_size(mname: str) -> int:
    return int(np.prod(MESHES[mname][0]))


def solves_on(mname: str) -> list:
    return [sid for sid, (e, _, _) in SOLVES.items() if e["mesh"] == mname]


# -- the NoC calls ---------------------------------------------------------------


def noc_ops(mname: str) -> tuple:
    """(op, kwargs) of every NoC call on mesh ``mname``."""
    _, axes, rows, cols = MESHES[mname]
    return (("neighbor_shift", dict(axis=cols[0], shift=1)),
            ("neighbor_shift", dict(axis=rows[-1], shift=-1)),
            ("pull_shard", dict(axes=rows, delta=1)),
            ("pull_shard", dict(axes=axes, delta=3)),
            ("gather_along", dict(axis=rows)),
            ("gather_along", dict(axis=cols, tiled=False)),
            ("reduce_along", dict(axis=cols)),
            ("reduce_along", dict(axis=axes)),
            ("reduce_scatter_along", dict(axis=rows)),
            ("reduce_scatter_along", dict(axis=axes)),
            ("mesh_transpose", dict(row_axes=rows, col_axes=cols)),
            ("reverse_vector", dict(axes=axes)),
            ("bcast_from", dict(axis=rows, src=1)),
            ("axis_coord", dict(axis=cols)),
            ("axis_coord", dict(axis=rows)),
            ("tile_sum", {}))


def noc_stack(mname: str, i: int, k) -> np.ndarray:
    """The whole (P, m) / (k, P, m) tile stack of case ``i``, seeded."""
    p = mesh_size(mname)
    rng = np.random.default_rng(100 + i + (0 if k is None else 50))
    return rng.standard_normal((p, NOC_M) if k is None else (k, p, NOC_M))


def noc_call(mesh, op: str, kw: dict, xs: torch.Tensor) -> tuple:
    """(result as numpy, recorded collectives) of one NoC call on ``xs``,
    this process's tiles of the stack."""
    with noc.recording() as rec:
        if op == "axis_coord":
            out = noc.axis_coord(mesh, kw["axis"])
        elif op == "tile_sum":
            out = noc.tile_sum(xs[..., 0], mesh)
        else:
            out = getattr(noc, op)(xs, mesh, **kw)
    return out.numpy(), rec.summary()


def noc_cases(mname: str):
    for i, (op, kw) in enumerate(noc_ops(mname)):
        for k in NOC_K:
            yield f"{mname}:{i}:{op}:k{k}", i, op, kw, k


# -- the solves ------------------------------------------------------------------


def build(mesh, e: dict) -> AzulEngine:
    _, _, ra, ca = MESHES[e["mesh"]]
    return AzulEngine(matrix(tmat, e["mat"]), mesh=mesh, mode=e["mode"],
                      row_axes=ra, col_axes=ca, precond=e["precond"],
                      balance=e["balance"], dtype=np.float64,
                      layout=e["layout"], reorder=e["reorder"])


def rhs_of(mat: str, lanes) -> np.ndarray:
    """b = A x (x from default_rng(0)), as DIST_PARITY; (k, n) for lanes."""
    m = matrix(tmat, mat)
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    rng = np.random.default_rng(0)
    if lanes is None:
        return a @ rng.standard_normal(m.shape[0])
    return np.ascontiguousarray((a @ rng.standard_normal((lanes,
                                                          m.shape[0])).T).T)


def solve(eng: AzulEngine, spec: dict, b: np.ndarray) -> dict:
    """CALLS calls of the plan: the last one's results, every call's x
    equal, the plan's traces, info and collective summary; on a process
    grid the rank's message stats over the calls."""
    per_process = eng.mesh.per_process
    if per_process:
        eng.mesh.stats.reset()
    plan = eng.plan(SolveSpec(**spec))
    xs = [plan(b)[0] for _ in range(CALLS - 1)]
    x, norms = plan(b)
    return {"x": x, "norms": norms, "iters": np.asarray(plan.last_iters),
            "status": plan.last_status_names,
            "bad_iter": np.asarray(plan.last_bad_iter),
            "repeat_equal": all(np.array_equal(v, x) for v in xs),
            "traces": plan.traces, "loop": plan.info["loop"],
            "substrate": plan.info["substrate"],
            "layout": plan.info["layout"],
            "stats": eng.mesh.stats.as_dict() if per_process else None,
            "u": eng.u, "halo_width": eng.comm_plan.halo_width,
            "hlo": plan.hlo_summary()["count_by_op"]}


def lower(mat: str):
    m = matrix(tmat, mat)
    lo = sp.tril(sp.csr_matrix((m.data, m.indices, m.indptr),
                               shape=m.shape)).tocsr()
    lo.sort_indices()
    return csr_from_scipy(lo)


def sptrsv_x(mesh) -> np.ndarray:
    eng = build(mesh, SPTRSV_ENGINE)
    b = np.random.default_rng(11).standard_normal(eng.n)
    return eng.build_sptrsv(lower(SPTRSV_ENGINE["mat"]))(b)


def from_state(mesh, state: dict, mat: str) -> dict:
    """A grid engine over a (JAX) engine's host state, its pcg_tol solve."""
    eng = convert.dist_engine_state_from_numpy(mesh, state)
    return solve(eng, SPEC, rhs_of(mat, None))


# -- a rank ---------------------------------------------------------------------


def rank_main(rank, meshes: tuple, jax_state=None) -> dict:
    """Every case of ``meshes`` on this rank (each mesh a ``ProcessMesh``
    over the one group): the NoC calls on the rank's slice of each stack,
    the solves, and on 2x2 the ``build_sptrsv`` solve and the engine from
    ``jax_state``."""
    out = {"noc": {}, "solves": {}, "mesh": {}}
    for mname in meshes:
        shape, axes, _, _ = MESHES[mname]
        mesh = rank.mesh(shape, axes)
        r = mesh.rank
        out["mesh"][mname] = dict(rank=r, coords=mesh.coords,
                                  local=(mesh.local.start, mesh.local.stop),
                                  local_size=mesh.local_size,
                                  device=str(mesh.device))
        for cid, i, op, kw, k in noc_cases(mname):
            full = torch.from_numpy(noc_stack(mname, i, k))
            xs = full[r: r + 1] if k is None else full[:, r: r + 1]
            out["noc"][cid] = noc_call(mesh, op, kw, xs.contiguous())
        for sid in solves_on(mname):
            e, spec, lanes = SOLVES[sid]
            out["solves"][sid] = solve(build(mesh, e), spec,
                                       rhs_of(e["mat"], lanes))
        if mname == "2x2":
            out["sptrsv"] = sptrsv_x(mesh)
            if jax_state is not None:
                out["from_state"] = from_state(mesh, jax_state, "lap2d_32")
    return out


def rank_fails(rank, pid_dir: str, mode: str) -> None:
    """Rank 1 raises (``mode="raise"``) or hangs (``"hang"``) while rank
    0 waits for it in a collective; each rank leaves its pid first."""
    import os
    import time

    import torch.distributed as dist

    with open(os.path.join(pid_dir, f"{rank.rank}.pid"), "w") as f:
        f.write(str(os.getpid()))
    if rank.rank == 1:
        if mode == "raise":
            raise RuntimeError("rank 1 fails on purpose")
        time.sleep(600)
    got = [torch.zeros(1) for _ in range(rank.size)]
    dist.all_gather(got, torch.ones(1))
