"""The engine and plan surface serving needs, held to the JAX package.

* ``__all__`` of ``repro_torch.core``, ``.serve``, ``.obs``, ``.ft`` and
  ``.checkpoint`` equals the JAX package's exports, less what is not
  ported (``set_torch_bridge`` in place of ``set_jax_bridge``), and every public
  signature equals ``repro``'s by ``inspect.signature``, less the
  parameters of features not ported yet, with a trailing ``device`` where
  the port takes one and the trailing grid parameters of ``PORT_ONLY``
  (the placements of a state on a process grid, a checkpoint manager's
  mesh).
* ``reorder="rcm"``: the permutation and the permuted matrix equal the
  JAX package's, solves reach its counts (Jacobi and block-IC(0)) and
  agree with ``reorder="none"``; vectors round-trip the permutation.
* ``layout``: a local engine lowers "dense" and "halo" raises, as in JAX;
  a mesh that is not a ``TileMesh`` raises TypeError, a 2x2 one builds
  the tile grid.
* ``PlanCache`` membership / ``specs`` / ``clear``, ``SolvePlan``'s repr
  and local ``hlo_summary``, ``warn_deprecated`` and the deprecated
  ``engine.solve`` shim, ``precond_names`` / ``unregister_precond``.
* ``python -m repro_torch.launch.serve --device cpu --solver`` prints the
  JAX CLI's keys; an unknown ``--arch``, and neither ``--arch`` nor
  ``--solver``, exit non-zero naming what is wrong, and ``--mesh-shape
  2x2`` serves on a tile grid.
"""

import contextlib
import inspect
import io
import json
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro.checkpoint as jcheckpoint
import repro.core as jcore
import repro.ft as jft
import repro.obs as jobs
import repro.serve as jserve
from repro.core.partition import permute_csr as jax_permute
from repro.core.partition import rcm_permutation as jax_rcm
from repro.data.matrices import laplacian_2d as jax_lap2d
from repro.data.matrices import suite as jax_suite
from repro.launch import serve as jax_serve_cli
from repro_torch import checkpoint, core, ft, obs, serve
from repro_torch.core import registry
from repro_torch.core.partition import permute_csr, rcm_permutation
from repro_torch.core.plan import _reset_deprecation_warnings, warn_deprecated
from repro_torch.data.matrices import laplacian_2d
from repro_torch.data.matrices import suite as torch_suite
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import make_mesh
from torch_threads import one_torch_thread  # noqa: F401

NOT_PORTED = {
    "core": set(),
    "serve": set(),
    "obs": {"set_jax_bridge"},
    "ft": set(),
    "checkpoint": set(),
}
ADDED = {"obs": {"set_torch_bridge"}}

# the public callables of tests/test_api_surface.py and of the fault
# tolerance layer, and the parameters of features the port does not have
# yet (none left among these)
SIGNATURES = {
    "core.AzulEngine.__init__": set(),
    "core.AzulEngine.vals_template": set(),
    "core.AzulEngine.cols_template": set(),
    "core.AzulEngine.halo_entry_mask": set(),
    "core.AzulEngine.vals_operand": set(),
    "core.AzulEngine.plan": set(),
    "core.AzulEngine.solve": set(),
    "core.AzulEngine.spmv": set(),
    "core.AzulEngine.substrate_kind": set(),
    "core.AzulEngine.to_device_vec": set(),
    "core.AzulEngine.from_device_vec": set(),
    "core.AzulEngine.device_bytes": set(),
    "core.SolveSpec.__init__": set(),
    "core.SolvePlan.__call__": set(),
    "core.SolvePlan.hlo_summary": set(),
    "core.PlanCache.get": set(),
    "core.register_solver": set(),
    "core.register_precond": set(),
    "core.get_solver": set(),
    "core.get_precond": set(),
    "core.chunk_spec": set(),
    "serve.SolveService.__init__": set(),
    "serve.SolveService.register_operator": set(),
    "serve.SolveService.submit": set(),
    "serve.SolveService.tick": set(),
    "serve.SolveService.drain": set(),
    "serve.SolveService.plan_for": set(),
    "serve.SolveService.unregister_operator": set(),
    "serve.SolveService.operators": set(),
    "serve.run_load": set(),
    "serve.SolveServer.__init__": set(),
    "serve.SolveServer.submit": set(),
    "serve.SolveServer.step": set(),
    "serve.SolveServer.drain": set(),
    "serve.SolveServer.plan_for": set(),
    "obs.Registry.counter": set(),
    "obs.Registry.gauge": set(),
    "obs.Registry.histogram": set(),
    "obs.span": set(),
    "obs.render_prometheus": set(),
    "obs.snapshot": set(),
    "obs.start_metrics_server": set(),
    "obs.clock.override": set(),
    "ft.FaultSpec.__init__": set(),
    "ft.FaultInjector.__init__": set(),
    "ft.FaultInjector.fires_in": set(),
    "ft.FaultInjector.vals_for": set(),
    "ft.FaultInjector.on_chunk": set(),
    "ft.FaultInjector.restart": set(),
    "ft.corrupt_vals": set(),
    "ft.SolveRestartManager.__init__": set(),
    "ft.SolveRestartManager.solve": set(),
    "ft.FTSolveReport.__init__": set(),
    "ft.RestartManager.__init__": set(),
    "ft.RestartManager.run": set(),
    "ft.restart.TrainLoopResult.__init__": set(),
    "ft.StepTimer.__init__": set(),
    "checkpoint.save": set(),
    "checkpoint.restore": set(),
    "checkpoint.latest_step": set(),
    "checkpoint.CheckpointManager.__init__": set(),
    "checkpoint.CheckpointManager.save_async": set(),
    "checkpoint.CheckpointManager.wait": set(),
    "checkpoint.CheckpointManager.restore": set(),
    "checkpoint.CheckpointManager.latest_step": set(),
}

# trailing parameters only the port has, after the JAX package's: where a
# state is placed on a process grid (a JAX array carries its sharding, a
# torch tensor does not), the checkpoints and the training loop are told
# the placements, and the manager its mesh
PORT_ONLY = {
    "checkpoint.save": ("placements",),
    "checkpoint.CheckpointManager.__init__": ("mesh",),
    "checkpoint.CheckpointManager.save_async": ("placements",),
    "ft.RestartManager.run": ("placements",),
}

PORT = {"core": core, "serve": serve, "obs": obs, "ft": ft,
        "checkpoint": checkpoint}
JAX = {"core": jcore, "serve": jserve, "obs": jobs, "ft": jft,
       "checkpoint": jcheckpoint}


def _resolve(mods, path):
    obj = mods[path.split(".")[0]]
    for p in path.split(".")[1:]:
        obj = getattr(obj, p)
    return obj


def _exports(mod) -> set:
    """``__all__``, or where a package has none (``repro.ft``,
    ``repro.checkpoint``), the public names it imports, less modules."""
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not inspect.ismodule(v)}


@pytest.mark.parametrize("pkg", ["core", "serve", "obs", "ft", "checkpoint"])
def test_exports_are_the_jax_packages(pkg):
    want = (_exports(JAX[pkg]) - NOT_PORTED[pkg]) | ADDED.get(pkg, set())
    assert set(PORT[pkg].__all__) == want
    for name in want:
        assert hasattr(PORT[pkg], name), name


@pytest.mark.parametrize("path", sorted(SIGNATURES))
def test_signatures_are_the_jax_packages(path):
    want = [p for p in inspect.signature(_resolve(JAX, path)).parameters
            if p not in SIGNATURES[path]]
    got = list(inspect.signature(_resolve(PORT, path)).parameters)
    if got and got[-1] == "device" and "device" not in want:
        got = got[:-1]
    extra = list(PORT_ONLY.get(path, ()))
    if extra:
        assert got[-len(extra):] == extra
        got = got[:-len(extra)]
    assert got == want


def test_registry_names_and_unregister_precond():
    assert core.precond_names() == ("block_ic0", "identity", "jacobi")
    assert set(core.precond_names()) == set(jcore.precond_names())
    pdef = registry.PrecondDef(name="scaled", aliases=("sc",),
                               local_apply=lambda eng: lambda r: 2.0 * r)
    core.register_precond(pdef)
    try:
        assert "scaled" in core.precond_names()
        assert core.get_precond("sc") is pdef
    finally:
        registry.unregister_precond("scaled")
    assert "scaled" not in core.precond_names()
    with pytest.raises(ValueError, match="unknown preconditioner"):
        core.get_precond("sc")
    registry.unregister_precond("never_registered")     # a no-op


# -- reorder="rcm" -----------------------------------------------------------


@pytest.mark.parametrize("name", ["lap2d_32", "banded_1k", "rspd_1k",
                                  "skew_1k"])
def test_rcm_permutation_and_permuted_matrix_equal_jax(name):
    jm, tm = jax_suite()[name], torch_suite()[name]
    perm = rcm_permutation(tm)
    assert np.array_equal(perm, jax_rcm(jm))
    got, want = permute_csr(tm, perm), jax_permute(jm, perm)
    for a, b in zip(got[:3], want[:3]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert tuple(got.shape) == tuple(want.shape)


@pytest.mark.parametrize("precond", ["jacobi", "block_ic0"])
@pytest.mark.parametrize("name", ["lap2d_32", "banded_1k"])
def test_rcm_solves_reach_jax_counts(name, precond):
    jm, tm = jax_suite()[name], torch_suite()[name]
    a = sp.csr_matrix((tm.data, tm.indices, tm.indptr), shape=tm.shape)
    b = a @ np.random.default_rng(0).standard_normal(tm.shape[0])
    spec = dict(method="pcg_tol", tol=1e-8, max_iters=400)
    jeng = jcore.AzulEngine(jm, precond=precond, dtype=np.float64,
                            reorder="rcm")
    jplan = jeng.plan(jcore.SolveSpec(**spec))
    jx, _ = jplan(b)
    res = {}
    for reorder in ("rcm", "none"):
        eng = core.AzulEngine(tm, precond=precond, dtype=np.float64,
                              reorder=reorder, device="cpu")
        plan = eng.plan(core.SolveSpec(**spec))
        x, norms = plan(b)
        res[reorder] = (x, int(plan.last_iters), plan.last_status_names)
        assert plan.info["reorder"] == reorder == plan.spec.reorder
    x, iters, status = res["rcm"]
    assert iters == int(jplan.last_iters)
    assert status == jplan.last_status_names == "converged"
    assert np.abs(x - jx).max() <= 1e-9 * np.abs(jx).max()
    assert np.allclose(x, res["none"][0], rtol=0, atol=1e-6)
    assert np.linalg.norm(b - a @ x) <= 1e-7 * np.linalg.norm(b)


def test_rcm_engine_permutes_vectors_and_counts_permuted_bytes():
    m = torch_suite()["rspd_1k"]
    eng = core.AzulEngine(m, dtype=np.float64, reorder="rcm", device="cpu")
    jeng = jcore.AzulEngine(jax_suite()["rspd_1k"], dtype=np.float64,
                            reorder="rcm")
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    v = np.random.default_rng(4).standard_normal((3, m.shape[0]))
    assert np.allclose(eng.spmv(v[0]), a @ v[0], rtol=0, atol=1e-12)
    assert np.allclose(eng.spmv(v), (a @ v.T).T, rtol=0, atol=1e-12)
    back = eng.from_device_vec(eng.to_device_vec(v))
    assert np.array_equal(back, v)
    dev = eng.to_device_vec(v[0])
    assert np.array_equal(dev[: m.shape[0]].numpy(), v[0][eng._row_perm])
    assert eng.device_bytes() == jeng.device_bytes()
    assert eng.format_choice == jeng.format_choice


def test_reorder_and_layout_validation():
    m = laplacian_2d(8)
    with pytest.raises(ValueError, match="reorder"):
        core.AzulEngine(m, reorder="amd", device="cpu")
    with pytest.raises(ValueError, match="layout"):
        core.AzulEngine(m, layout="ring", device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        core.AzulEngine(m, layout="halo", device="cpu")
    with pytest.raises(ValueError, match="halo"):
        jcore.AzulEngine(m, layout="halo")               # the same rule
    # a mesh must be the port's TileMesh; a 2x2 one builds the tile grid
    with pytest.raises(TypeError, match="TileMesh.*got object"):
        core.AzulEngine(m, mesh=object(), device="cpu")
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    grid = core.AzulEngine(m, mesh=mesh, device="cpu")
    assert grid.mode == "2d" and grid.mesh is mesh and grid.tiles == 4
    assert isinstance(grid.comm_plan, core.CommPlan)
    from repro_torch.core.stencil import lap2d_stencil
    with pytest.raises(ValueError, match="stored matrix"):
        core.AzulEngine(lap2d_stencil(8), reorder="rcm", device="cpu")
    eng = core.AzulEngine(m, dtype=np.float64, layout="dense", device="cpu")
    plan = eng.plan(core.SolveSpec(method="pcg_tol"))
    assert plan.spec.layout == "dense" and plan.info["layout"] == "dense"
    assert eng.plan(core.SolveSpec(method="pcg_tol", layout="auto")) is plan
    with pytest.raises(ValueError, match="single-device"):
        eng.plan(core.SolveSpec(method="pcg_tol", layout="halo"))
    with pytest.raises(ValueError, match="reorder"):
        eng.plan(core.SolveSpec(method="pcg_tol", reorder="rcm"))
    assert eng.plan(core.SolveSpec(method="pcg_tol", reorder="none")) is plan


# -- plan surface --------------------------------------------------------------


def test_plan_cache_repr_and_hlo_summary():
    eng = core.AzulEngine(laplacian_2d(8), dtype=np.float64, device="cpu")
    p1 = eng.plan(method="pcg", iters=10)
    p2 = eng.plan(method="pcg_tol", tol=1e-6)
    assert p1.spec in eng.plans and p2.spec in eng.plans
    assert core.SolveSpec(method="pcg", iters=10) not in eng.plans
    assert eng.plans.specs() == [p1.spec, p2.spec]
    assert len(eng.plans) == 2
    p1(np.ones(eng.n))
    assert repr(p1) == ("SolvePlan(pcg, precond=jacobi, substrate=fused, "
                        "batch=None, traces=1, executions=1)")
    assert p1.hlo_summary() == {"count_by_op": {}, "total_count": 0.0}
    assert p1.info["hlo"] is p1.hlo_summary()
    eng.plans.clear()
    assert len(eng.plans) == 0 and p1.spec not in eng.plans
    cache = core.PlanCache()
    built = []

    def build(spec):
        built.append(spec)
        return object()

    cache.get(p1.spec, build, env=("a",))
    cache.get(p1.spec, build, env=("b",))
    cache.get(p1.spec, build, env=("a",))
    assert len(built) == 2 and cache.hits == 1 and cache.misses == 2


def test_warn_deprecated_once_per_key():
    _reset_deprecation_warnings()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        warn_deprecated("k", "old")
        warn_deprecated("k", "old")
        warn_deprecated("other", "older")
    msgs = [str(w.message) for w in rec
            if issubclass(w.category, DeprecationWarning)]
    assert msgs == ["old", "older"]


@pytest.mark.parametrize("batch", [None, 3])
def test_engine_solve_shim_equals_the_plan(batch):
    m = laplacian_2d(8)
    eng = core.AzulEngine(m, dtype=np.float64, device="cpu")
    rng = np.random.default_rng(2)
    b = rng.standard_normal(m.shape[0] if batch is None else (batch,
                                                              m.shape[0]))
    _reset_deprecation_warnings()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        x, norms = eng.solve(b, method="pcg_tol", tol=1e-8, max_iters=300)
        eng.solve(b, method="pcg_tol", tol=1e-8, max_iters=300)
    assert sum(issubclass(w.category, DeprecationWarning) for w in rec) == 1
    plan = eng.plan(core.SolveSpec(method="pcg_tol", tol=1e-8, max_iters=300,
                                   batch=batch))
    assert plan.executions == 2
    x2, norms2 = plan(b)
    assert np.array_equal(x, x2) and np.array_equal(norms, norms2)
    jeng = jcore.AzulEngine(jax_lap2d(8), dtype=np.float64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jx, _ = jeng.solve(b, method="pcg_tol", tol=1e-8, max_iters=300)
    assert np.array_equal(np.atleast_1d(eng.last_solve_info["iters"]),
                          np.atleast_1d(jeng.last_solve_info["iters"]))
    assert np.abs(x - np.asarray(jx)).max() <= 1e-9 * np.abs(jx).max()


# -- launch.serve --solver ------------------------------------------------------


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue())


@pytest.mark.parametrize("extra", [
    ["--operators", "lap2d_32,banded_1k", "--requests", "6"],
    ["--matrix", "lap2d_32", "--load-gen", "closed", "--requests", "6"],
    ["--matrix", "lap2d_32", "--load-gen", "open", "--rate", "200",
     "--requests", "6", "--iters", "2000"],
    ["--matrix", "lap2d_32", "--method", "pcg", "--iters", "50",
     "--requests", "3", "--reorder", "rcm"],
])
def test_serve_cli_prints_the_jax_clis_keys(extra):
    got = _run(serve_cli.main, ["--solver", "--device", "cpu"] + extra)
    want = _run(jax_serve_cli.main, ["--solver"] + extra)
    # the port adds degraded_batches, and verify_rel_residual under load
    extra_keys = {"degraded_batches"} | (
        {"verify_rel_residual"} if "--load-gen" in extra else set())
    assert set(got) == set(want) | extra_keys
    assert got["degraded_batches"] == 0
    if "--load-gen" in extra:
        # a converged outcome's true residual is near the tolerance (1e-8);
        # one stopped at the budget is only finite
        done = got["statuses"] == {"converged": 6}
        assert 0 < got["verify_rel_residual"] <= (1e-7 if done else 1.0)
    for key in ("operators", "requests", "ticks", "chunks", "rebuckets",
                "bucket_plans", "resident_bytes", "iters_mean", "iters_max",
                "completed", "statuses", "retraces"):
        if key in want:
            assert got[key] == want[key], key
    if "verify_maxerr" in want:
        assert got["verify_maxerr"] == pytest.approx(want["verify_maxerr"],
                                                     rel=1e-6)


def test_serve_cli_refuses_what_is_not_ported(capsys):
    # every LM architecture is ported: an unknown --arch, and neither
    # --arch nor --solver, exit non-zero naming what is wrong
    for argv, what in ((["--arch", "gemma", "--device", "cpu"], "gemma"),
                       ([], "--arch is required")):
        with pytest.raises(SystemExit) as ei:
            serve_cli.main(argv)
        assert ei.value.code != 0
        assert what in capsys.readouterr().err
    # a tile grid is ported: --mesh-shape 2x2 serves
    assert serve_cli.main(["--solver", "--mesh-shape", "2x2", "--requests",
                           "2", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["requests"] == 2 and got["bucket_plans"] >= 1
    assert got["verify_maxerr"] < 1e-5 and got["iters_max"] <= 200
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve_cli.main(["--solver", "--requests", "1"])
        with pytest.raises(RuntimeError, match="cuda"):
            serve.SolveService()
