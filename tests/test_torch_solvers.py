"""The rest of the solver registry on the CPU: ``cg``, the ``jacobi``
smoother, ``pcg_pipelined`` (alias ``pcg_pipe``) and
``pcg_pipelined_tol``, through ``AzulEngine`` -> ``plan(SolveSpec)`` ->
``plan(b)`` and the CLI, held against the JAX package on the same
matrices and right-hand sides (float64).

Iteration counts, status and ``bad_iter`` must be EQUAL; ``x`` allclose
at 1e-10 and the residual traces at 1e-9 relative to ||b|| (only the
summation order differs).  The pipelined counts are those of ``pcg_tol``
(the table ``chip_smoke.py`` holds the card to): lap2d_32 94 / 32 and
banded_1k 9 / 1 for Jacobi / block_ic0, and per lane at k = 4 (102, 98,
102, 102) / (35, 35, 35, 34) and (9, 9, 9, 9) / (1, 1, 1, 1).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core import substrate as jsubstrate
from repro.core.engine import AzulEngine as JaxEngine
from repro.core.plan import SolveSpec as JaxSpec
from repro.data import matrices as jmatrices
from repro_torch.core import registry, solvers, substrate
from repro_torch.core.engine import AzulEngine
from repro_torch.core.plan import SolveSpec
from repro_torch.core.stencil import lap2d_stencil
from repro_torch.data import matrices
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# pcg_pipelined_tol = pcg_tol counts of the JAX package (CPU, f64, tol 1e-8)
COUNTS = {("lap2d_32", "jacobi", None): [94],
          ("banded_1k", "jacobi", None): [9],
          ("lap2d_32", "block_ic0", None): [32],
          ("banded_1k", "block_ic0", None): [1],
          ("lap2d_32", "jacobi", 4): [102, 98, 102, 102],
          ("banded_1k", "jacobi", 4): [9, 9, 9, 9],
          ("lap2d_32", "block_ic0", 4): [35, 35, 35, 34],
          ("banded_1k", "block_ic0", 4): [1, 1, 1, 1]}


@pytest.fixture(scope="module")
def problems():
    """(jax CSR, port CSR, b (n,), B (4, n)) per matrix: b as
    ``chip_smoke.py``'s PARITY draws it (one default_rng(0), lap2d_32
    first), B = default_rng(0).standard_normal((4, n)) per matrix."""
    jm, pm = jmatrices.suite("small"), matrices.suite("small")
    rng = np.random.default_rng(0)
    out = {}
    for name in ("lap2d_32", "banded_1k"):
        m = jm[name]
        a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
        out[name] = (m, pm[name], a @ rng.standard_normal(m.shape[0]),
                     np.random.default_rng(0).standard_normal((4, m.shape[0])))
    return out


def _run(engine, spec, b):
    plan = engine.plan(spec)
    x, norms = plan(b)
    return (np.asarray(x), np.asarray(norms),
            np.atleast_1d(np.asarray(plan.last_iters)).tolist(),
            plan.last_status_names,
            np.atleast_1d(np.asarray(plan.last_bad_iter)).tolist())


def _same(j, t, b):
    jx, jn, ji, js, jb = j
    tx, tn, ti, ts, tb = t
    assert (ti, ts, tb) == (ji, js, jb)
    assert tn.shape == jn.shape
    np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-9 * np.linalg.norm(b))
    np.testing.assert_allclose(tx, jx, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("precond", ["jacobi", "block_ic0"])
@pytest.mark.parametrize("name", ["lap2d_32", "banded_1k"])
def test_pipelined_tol_counts_match_jax(problems, name, precond, batch):
    """Both substrates of the port (block_ic0's fused one forced on the
    CPU) against the JAX package's solve: equal counts, status, bad_iter;
    x allclose at 1e-10."""
    jm, pm, b1, b4 = problems[name]
    b = b4 if batch else b1
    spec = dict(method="pcg_pipelined_tol", tol=1e-8, max_iters=400,
                batch=batch)
    j = _run(JaxEngine(jm, precond=precond, dtype=np.float64, format="ell"),
             JaxSpec(**spec), b)
    assert j[2] == COUNTS[(name, precond, batch)]
    eng = AzulEngine(pm, precond=precond, dtype=np.float64, format="ell",
                     device="cpu")
    for fused, kind in ((True, "fused_ic0" if precond == "block_ic0"
                         else "fused"), (False, "reference")):
        plan = eng.plan(SolveSpec(**spec, fused=fused))
        assert plan.info["substrate"] == kind
        _same(j, _run(eng, SolveSpec(**spec, fused=fused), b), b)


@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("method", ["cg", "jacobi", "pcg_pipelined"])
def test_fixed_iteration_methods_match_jax(problems, method, batch):
    """cg and jacobi (iters=100) and fixed-iteration pcg_pipelined: the
    trace and x allclose to the JAX package's on each substrate the method
    lowers to (jacobi: the reference one only)."""
    jm, pm, b1, b4 = problems["lap2d_32"]
    b = b4 if batch else b1
    spec = dict(method=method, iters=100, batch=batch)
    j = _run(JaxEngine(jm, dtype=np.float64, format="ell"), JaxSpec(**spec), b)
    eng = AzulEngine(pm, dtype=np.float64, format="ell", device="cpu")
    for fused in (True, False):
        _same(j, _run(eng, SolveSpec(**spec, fused=fused), b), b)
    assert (eng.substrate_kind(method) == "reference") == (method == "jacobi")


def test_jacobi_trace_and_status():
    """Trace slot i + 1 holds the residual of the iterate step i starts
    from (so slots 0 and 1 both hold ||b - A x0||), as the JAX package's
    jacobi records it; no guards."""
    m = matrices.laplacian_2d(8)
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    b = a @ np.random.default_rng(1).standard_normal(m.shape[0])
    eng = AzulEngine(m, dtype=np.float64, device="cpu")
    plan = eng.plan(SolveSpec(method="jacobi", iters=30))
    _, norms = plan(b)
    x29, _ = eng.plan(SolveSpec(method="jacobi", iters=29))(b)
    assert norms.shape == (31,) and norms[0] == norms[1]
    assert norms[0] == pytest.approx(np.linalg.norm(b), rel=1e-12)
    assert norms[-1] == pytest.approx(np.linalg.norm(b - a @ x29), rel=1e-10)
    assert plan.last_status_names == "unguarded" and plan.last_bad_iter == -1
    assert plan.info["substrate"] == "reference" and plan.spec.guard is False


def test_alias_shares_one_plan(problems):
    _, pm, _, _ = problems["lap2d_32"]
    eng = AzulEngine(pm, dtype=np.float64, device="cpu")
    p1 = eng.plan(SolveSpec(method="pcg_pipe", iters=20))
    p2 = eng.plan(SolveSpec(method="pcg_pipelined", iters=20))
    assert p1 is p2 and p1.spec.method == "pcg_pipelined"
    assert len(eng.plans) == 1 and eng.plans.misses == 1
    assert registry.get_solver("pcg_pipe") is registry.get_solver("pcg_pipelined")
    assert registry.solver_names() == ("cg", "jacobi", "pcg",
                                       "pcg_pipelined", "pcg_pipelined_tol",
                                       "pcg_tol", "pcg_pipe")


def test_effective_preconditioner():
    """cg builds its psolve from identity whatever the engine's
    preconditioner, jacobi from the Jacobi diagonal; the rest from the
    engine's."""
    for engine_precond in ("jacobi", "block_ic0", "none"):
        assert registry.effective_precond(registry.get_solver("cg"),
                                          engine_precond).name == "identity"
        assert registry.effective_precond(registry.get_solver("jacobi"),
                                          engine_precond).name == "jacobi"
        assert registry.effective_precond(
            registry.get_solver("pcg_pipelined_tol"),
            engine_precond).name == registry.get_precond(engine_precond).name


def _setup(n=14, precond="jacobi"):
    """tests/test_pipelined.py's problem: laplacian_2d(14), x from
    default_rng(6)."""
    m = matrices.laplacian_2d(n)
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    eng = AzulEngine(m, precond=precond, dtype=np.float64, device="cpu")
    x_true = np.random.default_rng(6).standard_normal(m.shape[0])
    return a, eng, x_true, a @ x_true


def test_zero_rhs_fixed_iters_no_nan():
    """b = 0 drives gamma = delta = 0 every step: alpha = beta = 0, never
    0/0."""
    _, eng, _, _ = _setup()
    x, norms = eng.plan(SolveSpec(method="pcg_pipelined", iters=30))(
        np.zeros(eng.n))
    assert np.all(x == 0.0) and np.all(norms == 0.0)


def test_zero_rhs_tolerance_converges_at_zero_iters():
    _, eng, _, _ = _setup()
    plan = eng.plan(SolveSpec(method="pcg_pipelined_tol", tol=1e-10,
                              max_iters=50))
    x, norms = plan(np.zeros(eng.n))
    assert int(plan.last_iters) == 0 and plan.last_status_names == "converged"
    assert np.all(x == 0.0) and np.all(norms == 0.0)


def test_zero_rhs_batched_column_stays_finite():
    """A zero lane inside a batch does not poison its neighbour."""
    _, eng, x_true, b = _setup()
    plan = eng.plan(SolveSpec(method="pcg_pipelined_tol", tol=1e-9,
                              max_iters=300, batch=2))
    x, norms = plan(np.stack([b, np.zeros(eng.n)]))
    its = np.asarray(plan.last_iters)
    assert its[1] == 0 and 0 < its[0] < 300
    assert np.all(norms[:, 1] == 0.0)
    np.testing.assert_allclose(x[0], x_true, atol=1e-6)
    assert np.all(x[1] == 0.0)


def test_trace_is_true_residual_norm():
    """The pipelined trace is ||b - A x||, the quantity pcg traces."""
    a, eng, _, b = _setup(precond="jacobi")
    plan = eng.plan(SolveSpec(method="pcg_pipelined", iters=25))
    x, norms = plan(b)
    assert norms[0] == pytest.approx(np.linalg.norm(b), rel=1e-12)
    assert norms[-1] == pytest.approx(np.linalg.norm(b - a @ x), rel=1e-6)
    _, n_ref = eng.plan(SolveSpec(method="pcg", iters=25))(b)
    np.testing.assert_allclose(norms, n_ref, rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("method", ["cg", "pcg_pipelined", "pcg_pipelined_tol"])
def test_clean_solve_guarded_bitwise_identical_to_unguarded(method):
    _, eng, _, b = _setup(n=10)
    kw = (dict(tol=1e-8, max_iters=40) if method.endswith("_tol")
          else dict(iters=40))
    xg, ng = eng.plan(SolveSpec(method=method, guard=True, **kw))(b)
    xu, nu = eng.plan(SolveSpec(method=method, guard=False, **kw))(b)
    assert xg.tobytes() == xu.tobytes() and ng.tobytes() == nu.tobytes()


@pytest.mark.parametrize("method", ["pcg_pipelined", "pcg_pipelined_tol"])
def test_faulted_lane_freezes_as_jax(method):
    """A lane whose b holds a NaN faults at start-up (breakdown, bad_iter
    0) and stays frozen while the others run on: statuses, counts and the
    clean lanes' x equal the JAX package's."""
    jm = jmatrices.laplacian_2d(10)
    pm = matrices.laplacian_2d(10)
    a = sp.csr_matrix((jm.data, jm.indices, jm.indptr), shape=jm.shape)
    B = a @ np.random.default_rng(2).standard_normal((3, jm.shape[0])).T
    B = np.ascontiguousarray(B.T)
    B[1, 5] = np.nan
    kw = dict(method=method, batch=3, **(
        dict(tol=1e-8, max_iters=200) if method.endswith("_tol")
        else dict(iters=40)))
    j = _run(JaxEngine(jm, dtype=np.float64, format="ell"), JaxSpec(**kw), B)
    t = _run(AzulEngine(pm, dtype=np.float64, device="cpu"), SolveSpec(**kw), B)
    assert t[2:] == j[2:] and t[3][1] == "breakdown" and t[4][1] == 0
    np.testing.assert_allclose(t[0][[0, 2]], j[0][[0, 2]], rtol=1e-10,
                               atol=1e-10)
    assert np.isfinite(t[0][[0, 2]]).all()


@pytest.mark.parametrize("fmt", ["ell", "sell", "hyb", "bcsr", "stencil"])
def test_pipelined_tol_on_every_format(fmt):
    """lap2d_32 on each storage format and as the matrix-free stencil: 94
    iterations, converged, on the fused and the reference substrate."""
    m = matrices.suite("small")["lap2d_32"]
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    b = a @ np.random.default_rng(0).standard_normal(m.shape[0])
    eng = (AzulEngine(lap2d_stencil(32), dtype=np.float64, device="cpu")
           if fmt == "stencil" else
           AzulEngine(m, dtype=np.float64, format=fmt, device="cpu"))
    for fused in (True, False):
        plan = eng.plan(SolveSpec(method="pcg_pipelined_tol", tol=1e-8,
                                  max_iters=400, fused=fused))
        x, _ = plan(b)
        assert plan.info["format"] == fmt
        assert (int(plan.last_iters), plan.last_status_names) == (94, "converged")
        assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) <= 1e-8


def test_substrates_carry_the_pipelined_ops():
    """Every local substrate carries pipe_dots (a stack of its own dot:
    (3,) for (n,), (3, k, 1) for (k, n)) and pipe_update; the pipelined
    update equals the JAX package's on the same inputs."""
    cols = torch.zeros(8, 1, dtype=torch.int32)
    vals = torch.ones(8, 1, dtype=torch.float64)
    subs = [substrate.reference_substrate(lambda v: v, lambda r: r),
            substrate.fused_local_substrate(cols, vals),
            substrate.fused_ic0_local_substrate(cols, vals,
                                                lambda r: (r, torch.sum(r * r)))]
    v = torch.arange(8.0, dtype=torch.float64)
    vb = torch.stack([v, 2 * v])
    for sub in subs:
        assert sub.pipe_update is substrate.pipe_update
        assert sub.pipe_dots(v, v, v).shape == (3,)
        assert sub.pipe_dots(vb, vb, vb).shape == (3, 2, 1)
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((10, 16))
    got = substrate.pipe_update(0.3, 0.7, *(torch.from_numpy(a) for a in vecs))
    want = jsubstrate.pipe_update(0.3, 0.7, *vecs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-15)


def test_traffic_models_match_jax():
    for w in (5, 8.0, 27):
        assert substrate.modeled_vector_traffic(w) == \
            jsubstrate.modeled_vector_traffic(w)
    for args in ((5, 63, 63), (8, 2047, 2047), (3.0, 1, 2)):
        assert substrate.modeled_ic0_traffic(*args) == \
            jsubstrate.modeled_ic0_traffic(*args)


def test_solver_level_cg_is_identity_pcg():
    """cg = pcg with psolve = identity, at the solver level."""
    n = 32
    lap = torch.from_numpy(np.diag(2.0 * np.ones(n)) - np.diag(np.ones(n - 1), 1)
                           - np.diag(np.ones(n - 1), -1))
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(n))
    r1 = solvers.cg(lambda x: lap @ x, b, iters=20)
    r2 = solvers.pcg(lambda x: lap @ x, b, lambda r: r, iters=20)
    assert torch.equal(r1.x, r2.x) and np.array_equal(r1.res_norms, r2.res_norms)
    res = solvers.pcg_pipelined(lambda x: lap @ x, b, lambda r: -r, iters=30)
    assert solvers.status_name(res.status) == "breakdown"
    assert torch.isfinite(res.x).all()


def _cli(module, args, env_extra):
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", **env_extra)
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout[r.stdout.index("{"):])


@pytest.mark.parametrize("method", ["pcg_pipelined_tol", "cg", "jacobi"])
def test_cli_methods_match_jax_cli(tmp_path, method):
    args = ["--matrix", "lap2d_32", "--method", method, "--iters", "100"]
    jax_out = _cli("repro.launch.solve", args,
                   {"REPRO_AUTOTUNE_CACHE": str(tmp_path / "autotune.json"),
                    "JAX_ENABLE_X64": "1"})
    out = _cli("repro_torch.launch.solve", ["--device", "cpu", *args],
               {"REPRO_TORCH_AUTOTUNE_CACHE": str(tmp_path / "port.json")})
    assert set(jax_out) - {"noc"} <= set(out)
    for k in ("matrix", "n", "nnz", "method", "precond", "iters", "substrate",
              "fused", "format", "layout", "reorder", "status", "bad_iter"):
        assert out[k] == jax_out[k], k
    assert out.get("iters_run") == jax_out.get("iters_run")
    assert abs(out["rel_error"] - jax_out["rel_error"]) <= 1e-9 * max(
        1.0, jax_out["rel_error"])
    assert out["final_residual"] == pytest.approx(jax_out["final_residual"],
                                                  rel=1e-6)
