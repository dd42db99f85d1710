"""The first slice end to end on the CPU: the port's local Jacobi-PCG
solve (``AzulEngine`` -> ``plan(SolveSpec)`` -> ``plan(b)``) held against
the JAX package's on the same matrices and right-hand sides.

Iteration counts, status and ``bad_iter`` must be EQUAL; the residual
trace ring equal in shape and tail-fill and within 1e-9 relative to
||b|| elementwise; ``x`` allclose at rtol 1e-9.  Only summation order
differs between the two (float64 throughout).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core.engine import AzulEngine as JaxEngine
from repro.core.formats import csr_from_scipy as jcsr
from repro.core.plan import SolveSpec as JaxSpec
from repro.data import matrices as jmatrices
from repro_torch import convert
from repro_torch.core import solvers
from repro_torch.core.engine import AzulEngine
from repro_torch.core.formats import csr_from_scipy as tcsr
from repro_torch.core.plan import SolveSpec
from repro_torch.data import matrices
from repro_torch.kernels import autotune
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's pcg_tol counts on these (ROADMAP Recent, BENCH_pcg.json)
EXPECTED_ITERS = {"lap2d_32": 94, "banded_1k": 9}


@pytest.fixture(scope="module")
def problems():
    """(jax CSR, port CSR, b) per matrix, b drawn as
    benchmarks/bench_pcg.py:run_tol_solves draws it: one default_rng(0),
    lap2d_32 first, then banded_1k."""
    jm, pm = jmatrices.suite("small"), matrices.suite("small")
    rng = np.random.default_rng(0)
    out = {}
    for name in ("lap2d_32", "banded_1k"):
        m = jm[name]
        a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
        out[name] = (m, pm[name], a @ rng.standard_normal(m.shape[0]))
    return out


def _jax_engine(m, precond="jacobi"):
    # format="ell": the engines' choice for these matrices, pinned so the
    # JAX engine neither reads nor writes its on-disk autotune cache
    return JaxEngine(m, mesh=None, precond=precond, dtype=np.float64,
                     format="ell")


def _run(engine, spec, b):
    plan = engine.plan(spec)
    x, norms = plan(b)
    return (np.asarray(x), np.asarray(norms), int(np.asarray(plan.last_iters)),
            str(plan.last_status_names), int(np.asarray(plan.last_bad_iter)))


def _assert_same_solve(j, t, b):
    jx, jn, ji, js, jb = j
    tx, tn, ti, ts, tb = t
    assert (ti, ts, tb) == (ji, js, jb)
    assert tn.shape == jn.shape and tn.dtype == jn.dtype
    np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-9 * np.linalg.norm(b))
    # the ring's tail past the stop holds the final residual, in both
    assert np.all(tn[ti:] == tn[ti]) and np.all(jn[ji:] == jn[ji])
    np.testing.assert_allclose(tx, jx, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", ["lap2d_32", "banded_1k"])
def test_pcg_tol_jacobi_matches_jax(problems, name):
    jm, pm, b = problems[name]
    spec = dict(method="pcg_tol", tol=1e-8, max_iters=400)
    j = _run(_jax_engine(jm), JaxSpec(**spec), b)
    t = _run(AzulEngine(pm, dtype=np.float64, device="cpu"), SolveSpec(**spec), b)
    assert t[2] == EXPECTED_ITERS[name] and t[3] == "converged"
    _assert_same_solve(j, t, b)


@pytest.mark.parametrize("name", ["lap2d_32", "banded_1k"])
def test_pcg_tol_on_converted_operands_matches_jax(problems, name):
    """The port over the JAX engine's own arrays (``convert``) gives the
    same solve; so do the reference substrate and guard=False."""
    jm, _, b = problems[name]
    je = _jax_engine(jm)
    pe = convert.engine_state_from_numpy(
        np.asarray(je.ell.cols), np.asarray(je.ell.vals),
        np.asarray(je._dinv_pad), je.n, je.n_pad, device="cpu")
    spec = dict(method="pcg_tol", tol=1e-8, max_iters=400)
    j = _run(je, JaxSpec(**spec), b)
    _assert_same_solve(j, _run(pe, SolveSpec(**spec), b), b)
    ref = _run(pe, SolveSpec(**spec, fused=False), b)
    _assert_same_solve(_run(je, JaxSpec(**spec, fused=False), b), ref, b)
    assert ref[2] == j[2]
    lean = _run(pe, SolveSpec(**spec, guard=False), b)
    assert (lean[2], lean[3], lean[4]) == (j[2], "unguarded", -1)
    np.testing.assert_array_equal(lean[1], _run(pe, SolveSpec(**spec), b)[1])


@pytest.mark.parametrize("precond", ["jacobi", "none"])
def test_fixed_iteration_pcg_matches_jax(problems, precond):
    """Fixed-iteration pcg past convergence (maxiter status), including
    precond='none' -- the dinv=None body of cg_update."""
    jm, pm, b = problems["lap2d_32"]
    j = _run(_jax_engine(jm, precond), JaxSpec(method="pcg", iters=60), b)
    t = _run(AzulEngine(pm, precond=precond, dtype=np.float64, device="cpu"),
             SolveSpec(method="pcg", iters=60), b)
    assert t[3] == "maxiter" and t[1].shape == (61,)
    _assert_same_solve(j, t, b)


@pytest.mark.parametrize("method", ["pcg", "pcg_tol"])
def test_zero_rhs_status_matches_jax(problems, method):
    jm, pm, _ = problems["lap2d_32"]
    b = np.zeros(jm.shape[0])
    spec = dict(method=method, iters=20) if method == "pcg" else dict(
        method=method, tol=1e-8, max_iters=20)
    j = _run(_jax_engine(jm), JaxSpec(**spec), b)
    t = _run(AzulEngine(pm, dtype=np.float64, device="cpu"), SolveSpec(**spec), b)
    assert t[2:] == j[2:]
    assert np.array_equal(t[1], j[1]) and not t[0].any()


@pytest.mark.parametrize("method", ["pcg", "pcg_tol"])
def test_indefinite_operator_breakdown_matches_jax(method):
    """One diagonal entry scaled by -1000 makes A (and its Jacobi M)
    indefinite: both packages flag breakdown at the same iteration and
    freeze the same finite iterate."""
    m = matrices.laplacian_2d(10)
    a = sp.csr_matrix((m.data.copy(), m.indices, m.indptr), shape=m.shape)
    a[1, 1] *= -1000.0
    b = a @ np.random.default_rng(0).standard_normal(a.shape[0])
    spec = dict(method=method, iters=50) if method == "pcg" else dict(
        method=method, tol=1e-8, max_iters=200)
    j = _run(_jax_engine(jcsr(a)), JaxSpec(**spec), b)
    t = _run(AzulEngine(tcsr(a), dtype=np.float64, device="cpu"),
             SolveSpec(**spec), b)
    assert t[3] == "breakdown" and t[4] >= 1
    assert t[2:] == j[2:]
    assert np.isfinite(t[0]).all()
    np.testing.assert_allclose(t[1], j[1], rtol=1e-9)
    np.testing.assert_allclose(t[0], j[0], rtol=1e-9, atol=1e-12)


def test_solver_guards_on_a_dense_operator():
    """Solver level: psolve = -I is an indefinite M, breakdown at step 1
    (the JAX package's test_indefinite_preconditioner_is_breakdown)."""
    n = 32
    lap = torch.from_numpy(np.diag(2.0 * np.ones(n)) - np.diag(np.ones(n - 1), 1)
                           - np.diag(np.ones(n - 1), -1))
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(n))
    for fn, kw in ((solvers.pcg, dict(iters=50)),
                   (solvers.pcg_tol, dict(tol=1e-10, max_iters=50))):
        res = fn(lambda x: lap @ x, b, lambda r: -r, **kw)
        assert solvers.status_name(res.status) == "breakdown"
        assert int(res.bad_iter) == 1
        assert torch.isfinite(res.x).all()


def test_plan_builds_once_per_canonical_spec(problems):
    _, pm, b = problems["lap2d_32"]
    eng = AzulEngine(pm, dtype=np.float64, device="cpu")
    p1 = eng.plan(SolveSpec(method="pcg_tol", tol=1e-8, max_iters=400))
    p2 = eng.plan(SolveSpec(method="pcg_tol", max_iters=400, precond="jacobi",
                            format="ell"))
    p3 = eng.plan(SolveSpec(method="pcg_tol", iters=400, fused=True))
    assert p1 is p2 is p3 and eng.plans.misses == 1 and eng.plans.hits == 2
    # fixed-iteration methods null the tolerance fields: one plan for both
    q1 = eng.plan(SolveSpec(method="pcg", iters=30, tol=1e-3))
    q2 = eng.plan(SolveSpec(method="pcg", iters=30))
    assert q1 is q2 and q1.spec.tol is None and len(eng.plans) == 2
    assert eng.plan(SolveSpec(method="pcg_tol", max_iters=400,
                              fused=False)) is not p1
    for _ in range(3):
        p1(b)
    assert p1.executions == 3 and eng.plans.misses == 3
    assert eng.last_solve_info["status_names"] == "converged"
    assert p1.info["substrate"] == "fused" and eng.substrate_kind("pcg_tol") == "fused"
    assert eng.substrate_kind("pcg_tol", fused=False) == "reference"


def test_unported_options_raise(problems, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    autotune.clear_memo()
    _, pm, _ = problems["lap2d_32"]
    # the tile grid is ported: a mesh that is not a TileMesh is a type error
    with pytest.raises(TypeError, match="TileMesh"):
        AzulEngine(pm, mesh=object(), device="cpu")
    # the storage formats are ported: each builds and resolves
    for fmt in ("sell", "hyb", "bcsr"):
        eng = AzulEngine(pm, format=fmt, device="cpu")
        assert eng.format_choice == fmt
        assert eng.plan(SolveSpec(method="pcg", iters=2)).info["format"] == fmt
    with pytest.raises(ValueError, match="format"):
        AzulEngine(pm, format="coo", device="cpu")
    # the format rule picks HYB for the skewed matrix, as the JAX one does
    eng = AzulEngine(matrices.suite("small")["skew_1k"], device="cpu")
    assert eng.format_choice == "hyb"
    assert eng.plan(SolveSpec(method="pcg", iters=2)).info["format"] == "hyb"
    autotune.clear_memo()
    eng = AzulEngine(pm, device="cpu")
    # batched RHS are ported: only the JAX package's bad batch values raise
    for batch in (0, -2, "4", 2.0):
        with pytest.raises(ValueError, match="positive int"):
            eng.plan(SolveSpec(method="pcg", batch=batch))
    with pytest.raises(ValueError, match="engine precond"):
        eng.plan(SolveSpec(method="pcg", precond="none"))
    # every method of the JAX registry is ported: only other names raise
    with pytest.raises(ValueError, match="unknown solver"):
        eng.plan(SolveSpec(method="gmres"))


def _cli(module, args, env_extra):
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", **env_extra)
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout[r.stdout.index("{"):])


def test_cli_matches_jax_cli(tmp_path):
    args = ["--matrix", "lap2d_32", "--method", "pcg_tol"]
    # the JAX CLI's format autotuner writes its cache: keep it in tmp_path
    jax_out = _cli("repro.launch.solve", args,
                   {"REPRO_AUTOTUNE_CACHE": str(tmp_path / "autotune.json")})
    out = _cli("repro_torch.launch.solve", ["--device", "cpu", *args], {})
    assert out["iters_run"] == jax_out["iters_run"] == 94
    assert out["status"] == jax_out["status"] == "converged"
    assert abs(out["rel_error"] - jax_out["rel_error"]) <= 1e-9
    shared = set(jax_out) - {"noc"}
    assert shared <= set(out)
    for k in ("matrix", "n", "nnz", "method", "precond", "substrate", "fused",
              "format", "layout", "reorder", "bad_iter", "tol"):
        assert out[k] == jax_out[k], k
