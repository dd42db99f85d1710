"""The port's tile grid behind its entry points, held to the JAX package:
the CLIs, the solve service, fault injection and checkpoints on a mesh,
and ``chip_smoke.DIST_PARITY``.

The JAX side runs once for the module in a subprocess with 8 forced host
devices and x64 (``tests/test_engine_dist.py``'s environment) and writes
its results into an .npz under ``tmp_path_factory``; the port runs in
process on ``device="cpu"``.

* ``DIST_PARITY``: the JAX package's iteration counts of lap2d_32 and
  banded_1k on the 2x2, 4x1 and 1d-4 grids and lap2d_32 on the multipod
  (2, 2, 2) grid equal the constants in ``chip_smoke.py`` (which hold the
  card to them within one) and the port's.
* ``launch.solve --mesh-shape 2x2`` (2d auto, 1d halo pipelined,
  block-IC(0) with rcm and rows balance) prints the JAX CLI's keys and
  values; ``launch.serve --solver --mesh-shape 2x2`` its keys and counts.
* A ``SolveService`` with an operator on a 2x2 mesh: per-request
  iterations and statuses equal to the JAX service's, x within 1e-9.
* ``halo_drop`` / ``halo_perturb``: ``corrupt_vals`` bitwise JAX's on a
  1d grid's stacked values; injectable grid plans (the overlap split
  recomputed from the corrupted values) give JAX's iterations, statuses
  and bad_iter; a restart-manager scenario with a halo fault reports as
  JAX's does.
* ``restore(sharding_tree=)`` places leaves on a mesh's device.
"""

import json
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro_torch import checkpoint, ft
from repro_torch.core import AzulEngine, SolveSpec
from repro_torch.data import matrices as tmat
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import solve as solve_cli
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve import SolveService
from test_torch_dist_cases import MESHES, REPO, matrix, rhs, run_jax
from torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, str(REPO))
import chip_smoke as CHIP  # noqa: E402

SOLVE_ARGV = (
    ["--matrix", "lap2d_32", "--method", "pcg_tol", "--mesh-shape", "2x2"],
    ["--matrix", "lap2d_32", "--method", "pcg_pipelined_tol", "--mesh-shape",
     "2x2", "--mode", "1d", "--layout", "halo", "--max-iters", "300"],
    ["--matrix", "banded_1k", "--method", "pcg", "--iters", "30",
     "--mesh-shape", "2x2", "--precond", "block_ic0", "--reorder", "rcm",
     "--balance", "rows"],
)
SERVE_ARGV = ["--solver", "--matrix", "lap2d_32", "--mesh-shape", "2x2",
              "--requests", "6", "--coalesce", "4"]
FT_KINDS = ("halo_drop", "halo_perturb")
FT_METHODS = ("pcg_tol", "pcg_pipelined_tol")
FT_SCENARIOS = (
    dict(method="pcg_tol", chunk=20, fault=dict(kind="halo_perturb", seed=2,
                                                count=4, iteration=15)),
    dict(method="pcg_pipelined_tol", chunk=20,
         fault=dict(kind="halo_perturb", seed=3, count=8, iteration=30)),
    dict(method="pcg_tol", chunk=20, fault=None),
)

_JAX = r"""
import contextlib, io, json, sys
import numpy as np
import scipy.sparse as sp
from repro import ft
from repro.core.engine import AzulEngine
from repro.core.plan import SolveSpec
from repro.data import matrices as jm
from repro.launch import serve as serve_cli
from repro.launch import solve as solve_cli
from repro.launch.mesh import make_mesh
from repro.serve import SolveService
from test_torch_dist_cases import MESHES, matrix, rhs

C = json.load(open(sys.argv[1]))
res, js = {}, {}


def mesh_of(name):
    shape, axes, _, _ = MESHES[name]
    return make_mesh(tuple(shape), tuple(axes))


def cli(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = mod.main(argv)
    return code, json.loads(buf.getvalue()[buf.getvalue().index("{"):])


parity = {}
for mat, mname, mode in C["parity"]:
    m = matrix(jm, mat)
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    b = a @ np.random.default_rng(0).standard_normal(m.shape[0])
    _, _, ra, ca = MESHES[mname]
    eng = AzulEngine(m, mesh=mesh_of(mname), mode=mode, row_axes=tuple(ra),
                     col_axes=tuple(ca), dtype=np.float64)
    plan = eng.plan(SolveSpec(method="pcg_tol", tol=1e-8, max_iters=2000))
    plan(b)
    parity[f"{mat}|{mname}|{mode}"] = [int(plan.last_iters),
                                       plan.last_status_names]
js["parity"] = parity
js["solve_cli"] = [cli(solve_cli, argv) for argv in C["solve_argv"]]
js["serve_cli"] = cli(serve_cli, C["serve_argv"])

# a service with one operator on a 2x2 grid
m = matrix(jm, "lap16")
a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
svc = SolveService(max_batch=4, chunk=25)
svc.register_operator("lap", m, method="pcg_tol", tol=1e-8, max_iters=400,
                      dtype=np.float64, mesh=mesh_of("2x2"))
B = rhs(m.shape[0], 6, 3)
ids = [svc.submit(a @ x, "lap") for x in B]
done = svc.drain()
js["service"] = [[done[i].iters, done[i].status] for i in ids]
res["service/x"] = np.stack([done[i].x for i in ids])

# halo faults on a 1d grid (tests/test_faults.py's setting)
eng = AzulEngine(m, mesh=mesh_of("4x1"), mode="1d", dtype=np.float64)
b = a @ rhs(m.shape[0], None, 1)
res["ft/mask"] = eng.halo_entry_mask()
ft_plans = {}
for kind in C["ft_kinds"]:
    inj = ft.FaultInjector(eng, ft.FaultSpec(kind=kind, seed=2, count=4))
    res[f"ft/{kind}"] = inj._corrupt
    for meth in C["ft_methods"]:
        plan = eng.plan(SolveSpec(method=meth, tol=1e-8, max_iters=400,
                                  layout="halo", injectable=True))
        x, _ = plan(b, vals=inj._corrupt)
        js[f"ft/{kind}/{meth}"] = [int(plan.last_iters),
                                   plan.last_status_names,
                                   int(plan.last_bad_iter)]
        res[f"ft/{kind}/{meth}/x"] = np.asarray(x)
reports = []
for case in C["ft_scenarios"]:
    mgr = ft.SolveRestartManager(
        eng, SolveSpec(method=case["method"], tol=1e-8, max_iters=400),
        chunk=case["chunk"])
    inj = (None if case["fault"] is None
           else ft.FaultInjector(eng, ft.FaultSpec(**case["fault"])))
    rep = mgr.solve(b, injector=inj)
    reports.append([rep.status, rep.iterations, rep.chunks, rep.restarts,
                    [[f["label"], f["global_iter"], f["bad_iter"]]
                     for f in rep.faults]])
js["ft/reports"] = reports

np.savez(sys.argv[2], json=json.dumps(js), **res)
print("JAX_DIST_SERVE_DONE")
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    cases = {"parity": [list(k) for k in CHIP.DIST_PARITY],
             "solve_argv": SOLVE_ARGV, "serve_argv": SERVE_ARGV,
             "ft_kinds": FT_KINDS, "ft_methods": FT_METHODS,
             "ft_scenarios": FT_SCENARIOS}
    return run_jax(_JAX, cases, tmp_path_factory.mktemp("dist") / "jax.npz")


def _mesh(name):
    shape, axes, ra, ca = MESHES[name]
    return make_mesh(shape, axes, device="cpu"), ra, ca


@pytest.mark.parametrize("key", list(CHIP.DIST_PARITY),
                         ids=["|".join(k) for k in CHIP.DIST_PARITY])
def test_dist_parity_constants_equal_jax_and_port(jax_side, key):
    _, meta = jax_side
    mat, mname, mode = key
    want = CHIP.DIST_PARITY[key]
    assert meta["parity"]["|".join(key)] == [want, "converged"]
    m = matrix(tmat, mat)
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    b = a @ np.random.default_rng(0).standard_normal(m.shape[0])
    mesh, ra, ca = _mesh(mname)
    eng = AzulEngine(m, mesh=mesh, mode=mode, row_axes=ra, col_axes=ca,
                     dtype=np.float64)
    plan = eng.plan(SolveSpec(method="pcg_tol", tol=1e-8, max_iters=2000))
    plan(b)
    assert int(plan.last_iters) == want
    assert plan.last_status_names == "converged"


def _run_cli(mod, argv, capsys):
    code = mod.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    return code, json.loads(out[out.index("{"):])


@pytest.mark.parametrize("i", range(len(SOLVE_ARGV)))
def test_solve_cli_on_a_mesh_equals_jax(jax_side, i, capsys):
    _, meta = jax_side
    jcode, want = meta["solve_cli"][i]
    code, got = _run_cli(solve_cli, SOLVE_ARGV[i], capsys)
    assert code == jcode == 0
    assert got.pop("device") == "cpu"
    assert set(got) == set(want)
    for key in ("final_residual", "rel_error"):
        assert got.pop(key) == pytest.approx(want.pop(key), rel=1e-6,
                                             abs=1e-12)
    assert got == want


def test_serve_cli_on_a_mesh_equals_jax(jax_side, capsys):
    _, meta = jax_side
    jcode, want = meta["serve_cli"]
    code, got = _run_cli(serve_cli, SERVE_ARGV, capsys)
    assert code == jcode == 0
    assert set(want) <= set(got)
    for key in ("operators", "requests", "ticks", "chunks", "rebuckets",
                "bucket_plans", "resident_bytes", "iters_mean", "iters_max",
                "completed", "statuses"):
        if key in want:
            assert got[key] == want[key], key
    assert got["verify_maxerr"] == pytest.approx(want["verify_maxerr"],
                                                 rel=1e-6)


def test_service_on_a_mesh_equals_jax(jax_side):
    arrays, meta = jax_side
    m = matrix(tmat, "lap16")
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    mesh, _, _ = _mesh("2x2")
    svc = SolveService(max_batch=4, chunk=25, device="cpu")
    info = svc.register_operator("lap", m, method="pcg_tol", tol=1e-8,
                                 max_iters=400, dtype=np.float64, mesh=mesh)
    assert info.n == m.shape[0]
    B = rhs(m.shape[0], 6, 3)
    ids = [svc.submit(a @ x, "lap") for x in B]
    done = svc.drain()
    assert [[done[i].iters, done[i].status] for i in ids] == meta["service"]
    got = np.stack([done[i].x for i in ids])
    assert np.allclose(got, arrays["service/x"], rtol=0, atol=1e-9)
    eng = svc._operators["lap"].engine
    assert eng.mode == "2d" and eng.mesh is mesh
    for plan in eng.plans._plans.values():
        assert plan.traces == 1


@pytest.fixture(scope="module")
def ft_engine():
    m = matrix(tmat, "lap16")
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    mesh, _, _ = _mesh("4x1")
    eng = AzulEngine(m, mesh=mesh, mode="1d", dtype=np.float64)
    return eng, a @ rhs(m.shape[0], None, 1)


@pytest.mark.faults
@pytest.mark.parametrize("kind", FT_KINDS)
def test_halo_faults_equal_jax(jax_side, ft_engine, kind):
    arrays, meta = jax_side
    eng, b = ft_engine
    assert np.array_equal(eng.halo_entry_mask(), arrays["ft/mask"])
    inj = ft.FaultInjector(eng, ft.FaultSpec(kind=kind, seed=2, count=4))
    assert np.array_equal(inj._corrupt, arrays[f"ft/{kind}"])
    for meth in FT_METHODS:
        plan = eng.plan(SolveSpec(method=meth, tol=1e-8, max_iters=400,
                                  layout="halo", injectable=True))
        x, _ = plan(b, vals=inj._corrupt)
        assert [int(plan.last_iters), plan.last_status_names,
                int(plan.last_bad_iter)] == meta[f"ft/{kind}/{meth}"]
        assert np.allclose(x, arrays[f"ft/{kind}/{meth}/x"], rtol=0,
                           atol=1e-9)
        xc, _ = plan(b)                      # clean again, one build
        clean = eng.plan(SolveSpec(method=meth, tol=1e-8, max_iters=400,
                                   layout="halo"))
        assert np.array_equal(xc, clean(b)[0])
        assert plan.traces == 1
        assert np.array_equal(eng.vals_template(), inj._clean)


@pytest.mark.faults
@pytest.mark.parametrize("i", range(len(FT_SCENARIOS)))
def test_restart_manager_on_a_grid_equals_jax(jax_side, ft_engine, i):
    _, meta = jax_side
    eng, b = ft_engine
    case = FT_SCENARIOS[i]
    mgr = ft.SolveRestartManager(
        eng, SolveSpec(method=case["method"], tol=1e-8, max_iters=400),
        chunk=case["chunk"])
    inj = (None if case["fault"] is None
           else ft.FaultInjector(eng, ft.FaultSpec(**case["fault"])))
    rep = mgr.solve(b, injector=inj)
    got = [rep.status, rep.iterations, rep.chunks, rep.restarts,
           [[f["label"], f["global_iter"], f["bad_iter"]] for f in rep.faults]]
    assert got == meta["ft/reports"][i]


def test_halo_faults_need_a_grid():
    eng = AzulEngine(matrix(tmat, "lap16"), device="cpu")
    with pytest.raises(ValueError, match="distributed engine"):
        ft.FaultInjector(eng, ft.FaultSpec(kind="halo_drop"))


def test_restore_places_leaves_on_the_mesh_device(tmp_path):
    mesh, _, _ = _mesh("2x2")
    tree = {"x": np.arange(6.0), "k": np.int64(3), "v": [np.ones(2)]}
    checkpoint.save(tree, str(tmp_path), 1)
    got, step = checkpoint.restore(
        {"x": np.zeros(6), "k": np.int64(0), "v": [np.zeros(2)]},
        str(tmp_path), sharding_tree={"x": mesh, "v": [torch.device("cpu")]})
    assert step == 1
    assert isinstance(got["x"], torch.Tensor) and got["x"].device == mesh.device
    assert torch.equal(got["x"], torch.arange(6.0, dtype=torch.float64))
    assert isinstance(got["v"][0], torch.Tensor)
    assert isinstance(got["k"], np.ndarray) and int(got["k"]) == 3
    with pytest.raises(KeyError, match="not a leaf"):
        checkpoint.restore({"x": np.zeros(6), "k": np.int64(0),
                            "v": [np.zeros(2)]}, str(tmp_path),
                           sharding_tree={"y": mesh})
