"""The compiled-plan contract of the port on the CPU: ``SolvePlan.traces``
and ``assert_steady``, shape specialization, and the device-resident
loop's rounds (``repro_torch.core.loop``).

* One build per plan: ``traces == 1`` over 100 executions, warm starts
  and a broadcast (n,) ``x0`` included (the JAX package's
  ``tests/test_plan.py`` and ``tests/test_engine_cache.py`` contract);
  a call of the plan's program with another input signature is a second
  build, and ``assert_steady`` then raises RuntimeError; so is a call
  that captures a loop again on a signature already seen.
* A user-registered solver that does not use ``loop.while_loop`` runs as
  it is, with one build.
* The round length ``loop.CHUNK`` changes nothing: every built-in method,
  one right-hand side and k = 4, guarded and unguarded, on a matrix with
  an indefinite block (a lane that breaks down mid-run) and a lane whose
  b holds a NaN (a breakdown before the loop), gives bitwise the same x,
  trace, iters, status and bad_iter for CHUNK = 1, 7 and 64, and the
  JAX package's iters, status and bad_iter.
* ``while_loop`` itself: ``lax.while_loop`` semantics against a Python
  loop, for any CHUNK.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core.engine import AzulEngine as JaxEngine
from repro.core.formats import csr_from_scipy as jcsr
from repro.core.plan import SolveSpec as JaxSpec
from repro_torch.core import loop, solvers
from repro_torch.core.engine import AzulEngine
from repro_torch.core.formats import csr_from_scipy as tcsr
from repro_torch.core.plan import SolveSpec
from repro_torch.core.registry import (SolverDef, register_solver,
                                       unregister_solver)
from repro_torch.data import matrices
from torch_threads import one_torch_thread  # noqa: F401

CHUNKS = (1, 7, 64)
K = 4


def _setup(n=10, precond="jacobi"):
    m = matrices.laplacian_2d(n)
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    eng = AzulEngine(m, precond=precond, dtype=np.float64, device="cpu")
    b = a @ np.random.default_rng(0).standard_normal(m.shape[0])
    return m, a, eng, b


# -- the build-once contract --------------------------------------------------


def test_one_trace_per_plan_across_100_executions():
    _, _, eng, b = _setup()
    plan = eng.plan(SolveSpec(method="pcg", iters=5))
    assert plan.traces == 0
    x0, _ = plan(b)
    for _ in range(99):
        x, _ = plan(b)
    assert plan.executions == 100
    assert plan.traces == 1, "plan retraced -- the compile-once contract broke"
    plan.assert_steady()
    np.testing.assert_array_equal(x, x0)


@pytest.mark.parametrize("method", ["pcg_tol", "pcg_pipelined_tol", "jacobi"])
def test_warm_starts_and_broadcast_x0_build_once(method):
    """Warm starts and a shared (n,) x0 over a batch reuse the one build,
    as serving re-enters a plan."""
    _, a, eng, b = _setup()
    spec = dict(method=method, tol=1e-8, max_iters=60, iters=20)
    plan = eng.plan(SolveSpec(**spec))
    x, _ = plan(b)
    for _ in range(3):
        x, _ = plan(b, x0=x)
    bp = eng.plan(SolveSpec(batch=K, **spec))
    B = np.stack([b] * K)
    xb, _ = bp(B, x0=np.zeros(eng.n))
    xb2, _ = bp(B, x0=xb)
    xb3, _ = bp(B)
    np.testing.assert_array_equal(xb3, xb)
    assert plan.traces == 1 and bp.traces == 1
    assert plan.executions == 4 and bp.executions == 3
    plan.assert_steady()
    bp.assert_steady()


def test_engine_cache_plan_traces_once():
    """tests/test_engine_cache.py's tolerance plan: one execution, one
    build, and the same plan object on a second lookup."""
    _, _, eng, b = _setup()
    pt = eng.plan(SolveSpec(method="pcg_tol", tol=1e-9, max_iters=60,
                            fused=True))
    assert pt.spec.tol == 1e-9 and pt.spec.max_iters == 60
    assert eng.plan(SolveSpec(method="pcg_tol", tol=1e-9, max_iters=60,
                              fused=True)) is pt
    pt(b)
    assert pt.traces == 1 and pt.executions == 1


def test_assert_steady_raises_on_a_second_build():
    """The plan's program called with another input signature builds
    again, as a jitted function retraces on a new shape: traces 2, and
    assert_steady raises RuntimeError (not AssertionError)."""
    _, _, eng, b = _setup()
    plan = eng.plan(SolveSpec(method="pcg_tol", tol=1e-8, max_iters=50))
    plan(b)
    plan.assert_steady()
    B = eng.to_device_vec(np.stack([b, b]))
    res = plan.fn(B, torch.zeros_like(B))
    assert np.asarray(res.iters).shape == (2,)
    assert plan.traces == 2
    with pytest.raises(RuntimeError, match="retraced"):
        plan.assert_steady()
    plan.fn(B, torch.zeros_like(B))          # a known signature: no build
    assert plan.traces == 2


def test_a_second_capture_counts_as_a_build():
    """On the card a build is a capture: a call that captures a loop
    again, on a signature the program already ran with, counts a second
    build (the recapture ``assert_steady`` exists to catch); a call that
    neither brings a new signature nor captures counts none."""
    cell = loop.ProgramCell()
    b = torch.zeros(5, dtype=torch.float64)
    for _ in range(2):
        with cell.running(b, b):
            pass
    assert cell.traces == 1
    with cell.running(b, b):
        cell.captures += 1               # what a capture on the card adds
    assert cell.traces == 2


def test_plans_are_shape_specialized():
    _, _, eng, b = _setup()
    plan = eng.plan(SolveSpec(method="pcg", iters=5, batch=K))
    with pytest.raises(ValueError, match="shape-specialized"):
        plan(b)                                  # (n,) into a batch-4 plan
    with pytest.raises(ValueError, match="shape-specialized"):
        plan(np.stack([b, b]))                   # (2, n) into a batch-4 plan
    x, norms = plan(np.stack([b] * K))
    assert x.shape == (K, eng.n) and norms.shape == (6, K)
    x2, _ = plan(np.stack([b] * K), x0=np.zeros(eng.n))
    np.testing.assert_array_equal(x2, x)
    assert plan.traces == 1


def test_user_solver_without_while_loop_builds_once():
    """A registered solver with its own Python loop runs as it is: one
    build, the JAX package's Richardson example converging."""

    def run_richardson(ctx, b, x0):
        x = x0
        norms = []
        for _ in range(ctx.iters):
            r = b - ctx.matvec(x)
            x = x + 0.8 * ctx.psolve(r)
            norms.append(float(torch.sqrt(torch.sum(r * r))))
        r = b - ctx.matvec(x)
        norms.insert(0, float(torch.sqrt(torch.sum((b - ctx.matvec(x0)) ** 2))))
        return solvers.SolveResult(x, np.asarray(norms),
                                   np.asarray(ctx.iters, np.int32))

    register_solver(SolverDef(name="_test_richardson", run=run_richardson))
    try:
        _, _, eng, b = _setup()
        plan = eng.plan(SolveSpec(method="_test_richardson", iters=300))
        assert plan.info["substrate"] == "reference"
        for _ in range(3):
            x, norms = plan(b)
        assert norms.shape == (301,) and norms[-1] < 1e-6 * norms[0]
        assert plan.traces == 1 and plan.cell.replays == 0
        assert plan.last_status_names == "unguarded"
    finally:
        unregister_solver("_test_richardson")
    with pytest.raises(ValueError, match="unknown solver"):
        eng.plan(SolveSpec(method="_test_richardson"))


# -- the round length changes nothing ------------------------------------------


@pytest.fixture(scope="module")
def split_problem():
    """test_torch_batched's block-diagonal A: SPD lap2d(10) beside an
    indefinite block (entry (1, 1) scaled by -1000).  Lanes 0 and 2 live
    on the SPD block, lane 1 on the indefinite one (it breaks down
    mid-run); lane 3 is lane 0 with a NaN in b (a breakdown before the
    loop)."""
    m = matrices.laplacian_2d(10)
    spd = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    bad = spd.copy()
    bad[1, 1] *= -1000.0
    a = sp.block_diag([spd, bad]).tocsr()
    h = spd.shape[0]
    x = np.random.default_rng(0).standard_normal((K, 2 * h))
    x[[0, 2, 3], h:] = 0.0
    x[1, :h] = 0.0
    x[1, h:] = np.random.default_rng(0).standard_normal(h)
    B = (a @ x.T).T
    B[3] = B[0]
    B[3, 5] = np.nan
    return a, B


def _spec(method, batch, guard):
    if method.endswith("_tol"):
        return dict(method=method, tol=1e-10, max_iters=200, batch=batch,
                    guard=guard)
    return dict(method=method, iters=100, batch=batch, guard=guard)


def _port(a, spec, b, monkeypatch, chunk, fused):
    monkeypatch.setattr(loop, "CHUNK", chunk)
    eng = AzulEngine(tcsr(a), dtype=np.float64, format="ell", device="cpu")
    plan = eng.plan(SolveSpec(fused=fused, **spec))
    x, norms = plan(b)
    assert plan.traces == 1
    return (x, norms, np.asarray(plan.last_iters),
            np.asarray(plan.last_status), np.asarray(plan.last_bad_iter))


@pytest.mark.parametrize("batch", [None, K])
@pytest.mark.parametrize("method,guard", [
    (m, g) for m in ("pcg", "pcg_tol", "cg", "pcg_pipelined",
                     "pcg_pipelined_tol") for g in (True, False)]
    + [("jacobi", False)])            # jacobi has no guards
def test_chunk_changes_nothing_and_counts_equal_jax(split_problem, method,
                                                    batch, guard, monkeypatch):
    a, B = split_problem
    b = B if batch else B[1]                # 1-D: the lane that breaks down
    spec = _spec(method, batch, guard)
    for fused in (True, False):
        runs = [_port(a, spec, b, monkeypatch, c, fused) for c in CHUNKS]
        for run in runs[1:]:
            for got, want in zip(run, runs[0]):
                assert got.shape == want.shape and got.dtype == want.dtype
                assert got.tobytes() == want.tobytes()
    j = JaxEngine(jcsr(a), mesh=None, dtype=np.float64, format="ell")
    jp = j.plan(JaxSpec(**spec))
    jp(b)
    x, norms, iters, status, bad = runs[0]
    np.testing.assert_array_equal(iters, np.asarray(jp.last_iters))
    np.testing.assert_array_equal(status, np.asarray(jp.last_status))
    np.testing.assert_array_equal(bad, np.asarray(jp.last_bad_iter))
    if guard and method != "jacobi":
        lanes = np.atleast_1d(status)
        assert solvers.STATUS_BREAKDOWN in lanes


def test_while_loop_matches_a_python_loop(monkeypatch):
    """lax.while_loop semantics for any round length: the state at the
    first step whose cond is false, entries passed through untouched, and
    nothing run when cond is false at the start."""

    def cond(s):
        return s[0] < s[2]

    def body(s):
        i, acc, stop = s
        return i + 1, acc * 1.5 + i.to(acc.dtype), stop

    for chunk in CHUNKS:
        monkeypatch.setattr(loop, "CHUNK", chunk)
        for stop in (0, 1, 6, 7, 8, 100):
            i = torch.zeros((), dtype=torch.int32)
            acc = torch.ones(3, dtype=torch.float64)
            stop_t = torch.tensor(stop, dtype=torch.int32)
            gi, gacc, gstop = loop.while_loop(cond, body, (i, acc, stop_t))
            wi, wacc = 0, torch.ones(3, dtype=torch.float64)
            while wi < stop:
                wacc = wacc * 1.5 + wi
                wi += 1
            assert int(gi) == wi and gstop is stop_t
            assert torch.equal(gacc, wacc)
