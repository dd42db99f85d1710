"""The tile grid one process a tile (``launch.mesh.ProcessMesh``, gloo
ranks on the CPU) held to the one-process ``TileMesh`` and to the JAX
package's distributed engine.

Each mesh's ranks are spawned once for the module (``launch.procs``):
4 ranks run the 2x2 and 4x1 meshes' cases over one group, 8 ranks the
2x4 and multipod (2, 2, 2) ones; the rank side is
``tests/procmesh_cases.py``.  The test process runs the same cases on a
``TileMesh`` and holds every rank to them:

* every NoC call and ``tile_sum``, 1-D and batched, on random seeded
  stacks: each rank's result bitwise its slice of the ``TileMesh`` one,
  with equal ``record`` counts;
* the solves (chip_smoke.DIST_PARITY's Jacobi ``pcg_tol`` cases on 2x2
  (dense), 4x1 2d and 1d and the multipod grid; halo layouts; block-IC(0)
  on 2x2; k = 4 lanes; ``pcg_pipelined_tol`` on a halo 2x2 grid): counts
  and statuses equal to the JAX package's (DIST_PARITY, or a JAX
  subprocess with 8 forced host devices), x within 1e-12 relative of the
  ``TileMesh`` solve, x and info bitwise equal across ranks, traces 1
  over repeated calls, the loop eager, ``hlo_summary`` equal to the
  ``TileMesh`` plan's, the halo pulls' received bytes the comm plan's
  model;
* ``build_sptrsv`` on 2x2 against the ``TileMesh`` one; an engine built
  from the JAX engine's host state solving to JAX's count;
* ``launch.solve --processes`` (spawned, and under ``torchrun``) against
  the one-process verdict; a rank
  that raises or hangs makes the parent raise within its deadline, with
  no rank left running; nccl without a card a rank raises.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from procmesh_cases import (JAX_SOLVES, SOLVES, build, mesh_size,
                            noc_call, noc_cases, noc_stack, rank_fails,
                            rank_main, rhs_of, solve, sptrsv_x)
from repro_torch.launch import procs
from repro_torch.launch import solve as solve_cli
from repro_torch.launch.mesh import ProcessMesh, make_mesh, make_process_mesh
from test_torch_dist_cases import MESHES, REPO, run_jax
from torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, str(REPO))
import chip_smoke as CHIP  # noqa: E402

GROUPS = {4: ("2x2", "4x1"), 8: ("2x4", "mp")}
DEADLINE_S = 240.0
ALL_NOC = [c for ms in GROUPS.values() for m in ms for c in noc_cases(m)]
STATE_CASE = "lap2d_32|2x2|2d"

_JAX = r"""
import json, sys
import numpy as np
from repro.core.engine import AzulEngine
from repro.core.plan import SolveSpec
from repro.data import matrices as jm
from repro.launch.mesh import make_mesh
from procmesh_cases import SOLVES, rhs_of
from test_torch_dist_cases import MESHES, matrix

C = json.load(open(sys.argv[1]))
res, js = {}, {}
for sid in C["solves"]:
    e, spec, lanes = SOLVES[sid]
    shape, axes, ra, ca = MESHES[e["mesh"]]
    eng = AzulEngine(matrix(jm, e["mat"]), mesh=make_mesh(tuple(shape),
                     tuple(axes)), mode=e["mode"], row_axes=tuple(ra),
                     col_axes=tuple(ca), precond=e["precond"],
                     balance=e["balance"], dtype=np.float64,
                     layout=e["layout"], reorder=e["reorder"])
    plan = eng.plan(SolveSpec(**spec))
    plan(rhs_of(e["mat"], lanes))
    js[sid] = [np.asarray(plan.last_iters).tolist(), plan.last_status_names]
    if sid == C["state"]:
        cp = eng.comm_plan
        res["cols"] = eng.cols_template()
        res["vals"] = eng.vals_template()
        res["dinv"] = np.asarray(eng._dinv_pad)
        if eng._pad2g is not None:
            res["pad2g"] = np.asarray(eng._pad2g)
        res["cols_halo"] = np.asarray(cp.cols_halo)
        res["interior_mask"] = np.asarray(cp.interior_mask)
        js["state"] = {
            "mode": eng.mode, "row_axes": list(eng.row_axes),
            "col_axes": list(eng.col_axes), "n": int(eng.n),
            "n_pad": int(eng.n_pad), "u": int(eng.u), "br": int(eng.br),
            "bc": int(eng.bc), "deltas": [int(d) for d in cp.deltas],
            "comm": {f: (v.item() if hasattr(v, "item") else v)
                     for f, v in cp._asdict().items()
                     if not isinstance(v, (np.ndarray, tuple))
                     and v is not None and not hasattr(v, "shape")}}
np.savez(sys.argv[2], json=json.dumps(js), **res)
print("JAX_PROCMESH_DONE")
"""


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(the JAX side, {P: [rank results]}): the JAX subprocess runs while
    the 8 ranks do; the 4 ranks then take the JAX engine's state."""
    cases = {"solves": list(JAX_SOLVES) + [STATE_CASE], "state": STATE_CASE}
    path = tmp_path_factory.mktemp("procmesh") / "jax.npz"
    out = {}
    with ThreadPoolExecutor(1) as ex:
        jax_run = ex.submit(run_jax, _JAX, cases, path)
        out[8] = procs.run(rank_main, 8, (GROUPS[8], None), backend="gloo",
                           device="cpu", timeout_s=DEADLINE_S)
        jax_side = jax_run.result()
    out[4] = procs.run(rank_main, 4, (GROUPS[4], _jax_state(jax_side)),
                       backend="gloo", device="cpu", timeout_s=DEADLINE_S)
    return jax_side, out


@pytest.fixture(scope="module")
def jax_side(sides):
    return sides[0]


@pytest.fixture(scope="module")
def ranks(sides):
    return sides[1]


def _jax_state(jax_side) -> dict:
    """The JAX engine's host state in ``convert``'s layout."""
    arrays, meta = jax_side
    st = meta["state"]
    comm = dict(st["comm"], deltas=tuple(st["deltas"]),
                cols_halo=arrays["cols_halo"],
                interior_mask=arrays["interior_mask"])
    return {"mode": st["mode"], "row_axes": tuple(st["row_axes"]),
            "col_axes": tuple(st["col_axes"]), "n": st["n"],
            "n_pad": st["n_pad"], "u": st["u"], "br": st["br"],
            "bc": st["bc"], "cols": arrays["cols"], "vals": arrays["vals"],
            "dinv": arrays["dinv"], "pad2g": arrays.get("pad2g"),
            "comm_plan": comm}


_TILE: dict = {}


def tile_mesh(mname: str):
    if mname not in _TILE:
        shape, axes, _, _ = MESHES[mname]
        _TILE[mname] = make_mesh(shape, axes, device="cpu")
    return _TILE[mname]


def _tile_solve(sid: str) -> dict:
    key = ("solve", sid)
    if key not in _TILE:
        e, spec, lanes = SOLVES[sid]
        _TILE[key] = solve(build(tile_mesh(e["mesh"]), e), spec,
                           rhs_of(e["mat"], lanes))
    return _TILE[key]


# -- the NoC calls ---------------------------------------------------------------


@pytest.mark.parametrize("cid,i,op,kw,k", ALL_NOC, ids=[c[0] for c in ALL_NOC])
def test_noc_call_is_its_tilemesh_slice(ranks, cid, i, op, kw, k):
    mname = cid.split(":")[0]
    p = mesh_size(mname)
    want, want_rec = noc_call(tile_mesh(mname), op, kw,
                              torch.from_numpy(noc_stack(mname, i, k)))
    lead = 0 if (k is None or op == "axis_coord") else 1
    for r, res in enumerate(ranks[p]):
        got, rec = res["noc"][cid]
        mine = want if op == "tile_sum" else np.take(want, [r], axis=lead)
        assert got.dtype == mine.dtype and got.shape == mine.shape, (r, cid)
        assert np.array_equal(got, mine), (r, cid)
        assert rec == want_rec, (r, cid)


def test_process_mesh_surface(ranks):
    for p, meshes in GROUPS.items():
        for mname in meshes:
            shape = MESHES[mname][0]
            for r, res in enumerate(ranks[p]):
                m = res["mesh"][mname]
                assert m["rank"] == r and m["local"] == (r, r + 1)
                assert m["local_size"] == 1 and m["device"] == "cpu"
                assert m["coords"] == tuple(
                    int(c) for c in np.unravel_index(r, shape))


# -- the solves ------------------------------------------------------------------


def test_dist_parity_ic0_constant_equals_jax(jax_side):
    """chip_smoke.DIST_PARITY_IC0 (phase 8p's block-IC(0) count) is the
    JAX package's count of the same solve."""
    assert list(CHIP.DIST_PARITY_IC0) == [("lap2d_32", "2x2", "2d")]
    assert SOLVES["block_ic0"][0] == dict(
        SOLVES["lap2d_32|2x2|2d"][0], precond="block_ic0")
    assert jax_side[1]["block_ic0"] == [
        CHIP.DIST_PARITY_IC0[("lap2d_32", "2x2", "2d")], "converged"]


def _want_counts(jax_side, sid):
    if sid in JAX_SOLVES:
        return jax_side[1][sid]
    mat, mname, mode = sid.split("|")
    return CHIP.DIST_PARITY[(mat, mname, mode)], "converged"


@pytest.mark.parametrize("sid", list(SOLVES))
def test_solve_equals_jax_and_tilemesh(jax_side, ranks, sid):
    e, spec, lanes = SOLVES[sid]
    p = mesh_size(e["mesh"])
    tile = _tile_solve(sid)
    iters, status = _want_counts(jax_side, sid)
    r0 = ranks[p][0]["solves"][sid]
    assert r0["iters"].tolist() == iters and r0["status"] == status
    assert r0["iters"].tolist() == tile["iters"].tolist()
    assert r0["bad_iter"].tolist() == tile["bad_iter"].tolist()
    rel = np.abs(r0["x"] - tile["x"]).max() / np.abs(tile["x"]).max()
    assert rel <= 1e-12, rel
    assert r0["traces"] == 1 and r0["repeat_equal"] and tile["traces"] == 1
    assert r0["loop"] == "eager"
    assert r0["hlo"] == tile["hlo"]
    for key in ("substrate", "layout"):
        assert r0[key] == tile[key]
    for res in ranks[p][1:]:
        got = res["solves"][sid]
        for key in ("x", "norms", "iters", "bad_iter"):
            assert np.array_equal(got[key], r0[key]), key
        for key in ("status", "hlo", "traces", "loop"):
            assert got[key] == r0[key], key


@pytest.mark.parametrize("sid", ["halo", "halo_1d", "pipelined"])
def test_halo_pull_bytes_equal_the_comm_plan(ranks, sid):
    """Every pull a rank receives is one u-shard: its received bytes are
    the comm plan's modeled halo words x itemsize, pull for pull."""
    e = SOLVES[sid][0]
    for res in ranks[mesh_size(e["mesh"])]:
        got = res["solves"][sid]
        calls = got["stats"]["calls"]["pull_shard"]
        assert calls > 0 and calls % got["halo_width"] == 0
        assert got["stats"]["wire_bytes"]["pull_shard"] == \
            calls * got["u"] * 8
        assert "gather_along" not in got["stats"]["calls"]


def test_build_sptrsv_equals_tilemesh(ranks):
    want = sptrsv_x(tile_mesh("2x2"))
    for res in ranks[4]:
        assert np.array_equal(res["sptrsv"], want)


def test_engine_from_jax_state_solves_to_jax_count(jax_side, ranks):
    iters, status = jax_side[1][STATE_CASE]
    tile = _tile_solve(STATE_CASE)
    for res in ranks[4]:
        got = res["from_state"]
        assert got["iters"].tolist() == iters and got["status"] == status
        rel = np.abs(got["x"] - tile["x"]).max() / np.abs(tile["x"]).max()
        assert rel <= 1e-12


# -- the CLI, failures, backends ------------------------------------------------


def test_solve_cli_processes_equals_one_process(capsys):
    argv = ["--device", "cpu", "--matrix", "lap2d_32", "--method", "pcg_tol",
            "--mesh-shape", "2x2"]
    assert solve_cli.main(argv) == 0
    one = json.loads(capsys.readouterr().out)
    assert solve_cli.main(argv + ["--processes", "--dist-backend",
                                  "gloo"]) == 0
    many = json.loads(capsys.readouterr().out)
    assert many.pop("processes") == 4
    for key in ("final_residual", "rel_error"):
        assert many.pop(key) == pytest.approx(one.pop(key), rel=1e-6)
    assert many == one


def test_solve_cli_joins_the_group_torchrun_set_up():
    """Under torchrun (RANK/WORLD_SIZE set) ``--processes`` joins the
    group: rank 0 prints the verdict, the one-process grid's."""
    argv = ["--device", "cpu", "--matrix", "lap2d_32", "--method", "pcg_tol",
            "--mesh-shape", "2x2"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "4", "-m", "repro_torch.launch.solve", *argv,
         "--processes", "--dist-backend", "gloo"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=DEADLINE_S)
    assert r.returncode == 0, r.stderr[-3000:]
    many = json.loads(r.stdout)              # rank 0 alone printed
    assert many.pop("processes") == 4
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.solve",
                          *argv], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=DEADLINE_S)
    one = json.loads(out.stdout)
    for key in ("final_residual", "rel_error"):
        assert many.pop(key) == pytest.approx(one.pop(key), rel=1e-6)
    assert many == one


@pytest.mark.parametrize("mode", ["raise", "hang"])
def test_a_failed_rank_fails_the_run_without_a_hang(tmp_path, mode):
    """A rank that raises reaches the parent as its traceback soon after
    the ranks are up (both pid files written, after the group formed):
    the deadline is far above any spawn time, so a loaded host's slow
    start cannot fire it first; the time from the last pid file to the
    parent's raise is held instead.  A rank that hangs fires the short
    deadline.  Either way no rank is left running."""
    import time

    deadline = 60.0 if mode == "raise" else 6.0
    t0 = time.time()
    with pytest.raises((RuntimeError, TimeoutError)) as ei:
        procs.run(rank_fails, 2, (str(tmp_path), mode), backend="gloo",
                  device="cpu", timeout_s=deadline)
    t_end = time.time()
    assert t_end - t0 < deadline + 15
    if mode == "raise":
        assert "rank 1 fails on purpose" in str(ei.value)
        t_up = max(f.stat().st_mtime for f in tmp_path.glob("*.pid"))
        assert t_end - t_up < 10.0
    else:
        assert isinstance(ei.value, TimeoutError)
    for f in tmp_path.glob("*.pid"):
        with pytest.raises(ProcessLookupError):
            os.kill(int(f.read_text()), 0)


def test_backends_are_named_and_nccl_needs_a_card_a_rank():
    with pytest.raises(ValueError, match="backend"):
        procs.run(rank_fails, 2, (), backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        procs.run(rank_fails, 2, (), backend="nccl", device="cpu")
    with pytest.raises(RuntimeError, match="process group|torchrun"):
        make_process_mesh((2, 2), ("data", "model"), backend="gloo",
                          device="cpu")
    with pytest.raises(RuntimeError, match="initialized"):
        ProcessMesh((2, 2), ("data", "model"), "gloo", "cpu")


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
def test_nccl_with_ranks_sharing_a_card_raises():
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="a card a rank"):
        procs.run(rank_fails, n, (), backend="nccl", device="cuda")
