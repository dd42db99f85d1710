"""The engine and plan surface serving needs, held to the JAX package.

* ``__all__`` of ``repro_torch.core``, ``.serve`` and ``.obs`` equals the
  JAX package's, less what is not ported (``CommPlan``, the LM demo's
  ``generate`` / ``SlotServer``; ``set_torch_bridge`` in place of
  ``set_jax_bridge``), and every public signature equals ``repro``'s by
  ``inspect.signature``, less the parameters of features not ported yet,
  with a trailing ``device`` where the port takes one.
* ``reorder="rcm"``: the permutation and the permuted matrix equal the
  JAX package's, solves reach its counts (Jacobi and block-IC(0)) and
  agree with ``reorder="none"``; vectors round-trip the permutation.
* ``layout``: a local engine lowers "dense" and "halo" raises, as in JAX.
* ``PlanCache`` membership / ``specs`` / ``clear``, ``SolvePlan``'s repr
  and local ``hlo_summary``, ``warn_deprecated`` and the deprecated
  ``engine.solve`` shim, ``precond_names`` / ``unregister_precond``.
* ``python -m repro_torch.launch.serve --device cpu --solver`` prints the
  JAX CLI's keys; ``--arch`` and ``--mesh-shape`` refuse, naming their
  ROADMAP items.
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

import repro.core as jcore
import repro.obs as jobs
import repro.serve as jserve
from repro.core.partition import permute_csr as jax_permute
from repro.core.partition import rcm_permutation as jax_rcm
from repro.data.matrices import laplacian_2d as jax_lap2d
from repro.data.matrices import suite as jax_suite
from repro.launch import serve as jax_serve_cli
from repro_torch import core, obs, serve
from repro_torch.core import registry
from repro_torch.core.partition import permute_csr, rcm_permutation
from repro_torch.core.plan import _reset_deprecation_warnings, warn_deprecated
from repro_torch.data.matrices import laplacian_2d
from repro_torch.data.matrices import suite as torch_suite
from repro_torch.launch import serve as serve_cli

NOT_PORTED = {
    "core": {"CommPlan"},                     # ROADMAP Queue 1 item 10
    "serve": {"generate", "SlotServer"},      # item 11
    "obs": {"set_jax_bridge"},
}
ADDED = {"obs": {"set_torch_bridge"}}

# the public callables of tests/test_api_surface.py and the parameters of
# features the port does not have yet: the distributed engine (item 10),
# injectable plans (item 8)
SIGNATURES = {
    "core.AzulEngine.__init__": {"mode", "row_axes", "col_axes", "balance"},
    "core.AzulEngine.plan": set(),
    "core.AzulEngine.solve": set(),
    "core.AzulEngine.spmv": set(),
    "core.AzulEngine.substrate_kind": set(),
    "core.AzulEngine.to_device_vec": set(),
    "core.AzulEngine.from_device_vec": set(),
    "core.AzulEngine.device_bytes": set(),
    "core.SolveSpec.__init__": {"injectable"},
    "core.SolvePlan.__call__": {"vals"},
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
}

PORT = {"core": core, "serve": serve, "obs": obs}
JAX = {"core": jcore, "serve": jserve, "obs": jobs}


def _resolve(mods, path):
    obj = mods[path.split(".")[0]]
    for p in path.split(".")[1:]:
        obj = getattr(obj, p)
    return obj


@pytest.mark.parametrize("pkg", ["core", "serve", "obs"])
def test_exports_are_the_jax_packages(pkg):
    want = (set(JAX[pkg].__all__) - NOT_PORTED[pkg]) | ADDED.get(pkg, set())
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
    with pytest.raises(NotImplementedError, match="item 10"):
        core.AzulEngine(m, mesh=object(), device="cpu")
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
    for argv, item in ((["--arch", "gemma"], "item 11"),
                       (["--solver", "--mesh-shape", "2x2"], "item 10"),
                       ([], "item 11")):
        with pytest.raises(SystemExit) as ei:
            serve_cli.main(argv)
        assert ei.value.code != 0
        assert item in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve_cli.main(["--solver", "--requests", "1"])
        with pytest.raises(RuntimeError, match="cuda"):
            serve.SolveService()
