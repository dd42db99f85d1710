"""The third slice on the CPU: block-IC(0) PCG held against the JAX
package on the same numpy inputs.

* Host build: ``build_schedule``'s rows, counts and ``level_of`` EQUAL to
  the JAX package's; the ``ic0`` factors' ELL cols equal and vals bitwise
  equal in float64, schedules included.
* Triangular solves (float64, rtol 1e-12, only summation order and the
  kernel's multiply by the inverse diagonal for the reference's division
  differ): the port's ``sptrsv_ell`` against JAX's; the plain
  ``sptrsv_solve_dot`` (what ``ops`` runs for CPU tensors) against JAX's
  ``ops.sptrsv_solve_dot`` in Pallas interpret mode and against its
  ``ref`` oracle, with and without the dot weight; the fused application
  ``make_fused_ic0_apply`` (z, rz) against JAX's.
* Solves: block_ic0 ``pcg_tol``/``pcg`` through ``AzulEngine.plan`` on
  both port substrates, iteration counts, status and ``bad_iter`` EQUAL to
  JAX's (32 and 1 at tol 1e-8), trace within 1e-9 * ||b|| and x at rtol
  1e-9; batched k = 4 per-lane counts equal to JAX's, and lane j of the
  fused batch bitwise equal to lane j solved alone.
* The "auto" substrate rule, the ``convert`` round trip of the factors,
  the CLI, and the parity constants ``chip_smoke.py`` holds the card to.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core import levels as jlevels
from repro.core import precond as jprecond
from repro.core import spops as jspops
from repro.core.engine import AzulEngine as JaxEngine
from repro.core.formats import csr_from_scipy as jcsr
from repro.core.formats import ell_from_csr as jell_from_csr
from repro.core.plan import SolveSpec as JaxSpec
from repro.data import matrices as jmatrices
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import levels, precond, spops
from repro_torch.core.engine import AzulEngine
from repro_torch.core.formats import csr_from_scipy as tcsr
from repro_torch.core.formats import ell_from_csr
from repro_torch.core.plan import SolveSpec
from repro_torch.data import matrices
from repro_torch.kernels import ops
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-12, atol=1e-12)
# the JAX package's block_ic0 pcg_tol counts at tol 1e-8 (ROADMAP Recent)
EXPECTED_ITERS = {"lap2d_32": 32, "banded_1k": 1}
K = 4
# (n, density, seed) of random lower-triangular test matrices
LOWER_CASES = [(90, 0.05, 1), (90, 0.25, 2), (203, 0.02, 3)]


@pytest.fixture
def interpret():
    """The JAX package's kernels in Pallas interpret mode, restored after:
    the mode is process-global and other test files share the worker."""
    prev = jops.backend_mode()
    jops.backend_mode("interpret")
    try:
        yield
    finally:
        jops.backend_mode(prev)


def _lower(n, density, seed):
    """A random lower-triangular scipy matrix with a dominant diagonal."""
    a = sp.random(n, n, density=density, random_state=seed, format="csr")
    low = sp.tril(a, -1).tocsr()
    return (low + sp.eye(n) * 2.0).tocsr()


def _lower_mats():
    """Lower triangles of the small suite, and random lower matrices."""
    out = {}
    for name, m in jmatrices.suite("small").items():
        a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
        out[name] = sp.tril(a).tocsr()
    for n, dens, seed in LOWER_CASES:
        out[f"rand{n}_{dens}"] = _lower(n, dens, seed)
    return out


@pytest.mark.parametrize("name", sorted(_lower_mats()))
def test_build_schedule_equals_jax(name):
    low = _lower_mats()[name]
    js = jlevels.build_schedule(jcsr(low))
    ts = levels.build_schedule(tcsr(low))
    assert isinstance(ts.rows, np.ndarray) and ts.rows.dtype == np.int32
    np.testing.assert_array_equal(ts.rows, np.asarray(js.rows))
    np.testing.assert_array_equal(ts.counts, np.asarray(js.counts))
    np.testing.assert_array_equal(ts.level_of, js.level_of)
    assert ts.n == js.n and ts.n_levels == js.n_levels
    assert levels.parallelism_profile(ts) == jlevels.parallelism_profile(js)


def _factors_equal(tf, jf):
    for ell, sched in (("ell_l", "sched_l"), ("ell_u_rev", "sched_u_rev")):
        te, je = getattr(tf, ell), getattr(jf, ell)
        np.testing.assert_array_equal(te.cols.numpy(), np.asarray(je.cols))
        tv, jv = te.vals.numpy(), np.asarray(je.vals)
        assert tv.dtype == jv.dtype and np.array_equal(tv, jv)   # bitwise
        assert (te.n_rows, te.n_cols) == (je.n_rows, je.n_cols)
        ts, js = getattr(tf, sched), getattr(jf, sched)
        np.testing.assert_array_equal(ts.rows.numpy(), np.asarray(js.rows))
        np.testing.assert_array_equal(ts.counts, np.asarray(js.counts))
        np.testing.assert_array_equal(ts.level_of, js.level_of)
    assert tf.n == jf.n


@pytest.mark.parametrize("name", ["lap2d_32", "banded_1k", "rspd_1k"])
def test_ic0_factors_equal_jax(name):
    jm, pm = jmatrices.suite("small")[name], matrices.suite("small")[name]
    jf = jprecond.ic0(jm, dtype=np.float64)
    tf = precond.ic0(pm, dtype=np.float64, device="cpu")
    _factors_equal(tf, jf)


def _solve_case(case):
    """(jax ELL, port ELL, jax schedule, port schedule, n) of a lower
    matrix: a random one, or lap2d_32's L factor."""
    if case == "lap2d_32_L":
        jf = jprecond.ic0(jmatrices.laplacian_2d(32), dtype=np.float64)
        tf = precond.ic0(matrices.laplacian_2d(32), dtype=np.float64,
                         device="cpu")
        return jf.ell_l, tf.ell_l, jf.sched_l, tf.sched_l, jf.n
    n, dens, seed = LOWER_CASES[int(case)]
    low = _lower(n, dens, seed)
    je = jell_from_csr(jcsr(low), row_pad=8, width_pad=8, dtype=np.float64)
    te = ell_from_csr(tcsr(low), row_pad=8, width_pad=8, dtype=np.float64,
                      device="cpu")
    return (je, te, jlevels.build_schedule(jcsr(low)),
            levels.build_schedule(tcsr(low)), n)


SOLVE_CASES = ["0", "1", "2", "lap2d_32_L"]


@pytest.mark.parametrize("case", SOLVE_CASES)
def test_sptrsv_ell_matches_jax(case):
    je, te, js, ts, n = _solve_case(case)
    b = np.random.default_rng(7).standard_normal(n)
    got = spops.sptrsv_ell(te, ts, torch.from_numpy(b)).numpy()
    want = np.asarray(jspops.sptrsv_ell(je, js, jnp.asarray(b)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        spops.extract_diag_ell(te).numpy(),
        np.asarray(jspops.extract_diag_ell(je)), **TOL)


@pytest.mark.parametrize("with_dot", [True, False])
@pytest.mark.parametrize("case", SOLVE_CASES)
def test_sptrsv_solve_dot_plain_matches_jax(case, with_dot, interpret):
    je, te, js, ts, n = _solve_case(case)
    rp = te.rows_padded
    rng = np.random.default_rng(11)
    b = np.zeros(rp)
    b[:n] = rng.standard_normal(n)
    w = np.zeros(rp)
    w[:n] = rng.standard_normal(n)
    d = np.asarray(jspops.extract_diag_ell(je))
    dinv = np.ones(rp)
    dinv[:n] = 1.0 / d
    wd = w if with_dot else None
    tx, tpp = ops.sptrsv_solve_dot(te.cols, te.vals, torch.from_numpy(dinv),
                                   torch.from_numpy(b), ts.rows,
                                   None if wd is None else torch.from_numpy(wd),
                                   n_rows=n)
    jx, jpp = jops.sptrsv_solve_dot(je.cols, je.vals, jnp.asarray(dinv),
                                    jnp.asarray(b), js.rows,
                                    None if wd is None else jnp.asarray(wd),
                                    n_rows=n)
    rx, rpp = jref.sptrsv_solve_dot_ref(je.cols, je.vals, jnp.asarray(dinv),
                                        jnp.asarray(b), js.rows,
                                        jnp.asarray(w if with_dot else 0 * w),
                                        n)
    assert tx.shape == (rp,) and tpp.shape == ()
    assert np.all(tx.numpy()[n:] == 0)
    for x, pp in ((jx, jpp), (rx, rpp)):
        np.testing.assert_allclose(tx.numpy(), np.asarray(x), **TOL)
        np.testing.assert_allclose(float(tpp), float(pp), **TOL)
    if not with_dot:
        assert float(tpp) == 0.0


@pytest.mark.parametrize("name", ["lap2d_32", "banded_1k", "rspd_1k"])
def test_fused_ic0_apply_matches_jax(name):
    jm, pm = jmatrices.suite("small")[name], matrices.suite("small")[name]
    jf = jprecond.ic0(jm, dtype=np.float64)
    tf = precond.ic0(pm, dtype=np.float64, device="cpu")
    n, n_pad = jf.n, jf.ell_l.rows_padded
    r = np.zeros(n_pad)
    r[:n] = np.random.default_rng(3).standard_normal(n)
    jz, jrz = jprecond.make_fused_ic0_apply(jf, n, n_pad, jnp.float64)(
        jnp.asarray(r))
    tz, trz = precond.make_fused_ic0_apply(tf, n, n_pad, np.float64)(
        torch.from_numpy(r))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
    np.testing.assert_allclose(float(trz), float(jrz), **TOL)
    np.testing.assert_allclose(
        precond.apply_ic0(tf, torch.from_numpy(r[:n])).numpy(),
        np.asarray(jprecond.apply_ic0(jf, jnp.asarray(r[:n]))), **TOL)


@pytest.fixture(scope="module")
def problems():
    """(jax CSR, port CSR, b) per matrix, b = A randn from one
    default_rng(0), lap2d_32 first, as benchmarks/bench_pcg.py draws it."""
    jm, pm = jmatrices.suite("small"), matrices.suite("small")
    rng = np.random.default_rng(0)
    out = {}
    for name in ("lap2d_32", "banded_1k"):
        m = jm[name]
        a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
        out[name] = (m, pm[name], a @ rng.standard_normal(m.shape[0]))
    return out


def _run(engine, spec, b):
    plan = engine.plan(spec)
    x, norms = plan(b)
    return (plan, np.asarray(x), np.asarray(norms),
            np.asarray(plan.last_iters), plan.last_status_names,
            np.asarray(plan.last_bad_iter))


def _jax_engine(m):
    return JaxEngine(m, mesh=None, precond="block_ic0", dtype=np.float64,
                     format="ell")


@pytest.mark.parametrize("fused", [True, False], ids=["fused_ic0", "reference"])
@pytest.mark.parametrize("method", ["pcg_tol", "pcg"])
@pytest.mark.parametrize("name", ["lap2d_32", "banded_1k"])
def test_block_ic0_solve_matches_jax(problems, name, method, fused):
    jm, pm, b = problems[name]
    kw = (dict(tol=1e-8, max_iters=400) if method == "pcg_tol"
          else dict(iters=EXPECTED_ITERS[name] + 3))
    jp, jx, jn, ji, js, jb = _run(_jax_engine(jm), JaxSpec(method=method, **kw), b)
    eng = AzulEngine(pm, precond="block_ic0", dtype=np.float64, fused=fused,
                     device="cpu")
    tp, tx, tn, ti, ts, tb = _run(eng, SolveSpec(method=method, **kw), b)
    assert tp.info["substrate"] == ("fused_ic0" if fused else "reference")
    assert (int(ti), ts, int(tb)) == (int(ji), js, int(jb))
    if method == "pcg_tol":
        assert int(ti) == EXPECTED_ITERS[name] and ts == "converged"
    assert tn.shape == jn.shape and tn.dtype == jn.dtype
    np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-9 * np.linalg.norm(b))
    np.testing.assert_allclose(tx, jx, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", ["lap2d_32", "banded_1k"])
def test_block_ic0_batched_matches_jax(name):
    jm, pm = jmatrices.suite("small")[name], matrices.suite("small")[name]
    B = np.random.default_rng(0).standard_normal((K, jm.shape[0]))
    spec = dict(method="pcg_tol", tol=1e-8, max_iters=400)
    _, jx, jn, ji, js, jb = _run(_jax_engine(jm), JaxSpec(batch=K, **spec), B)
    for fused in (True, False):
        eng = AzulEngine(pm, precond="block_ic0", dtype=np.float64,
                         fused=fused, device="cpu")
        plan, tx, tn, ti, ts, tb = _run(eng, SolveSpec(batch=K, **spec), B)
        assert ti.tolist() == ji.tolist() and ts == js and tb.tolist() == jb.tolist()
        np.testing.assert_allclose(tx, jx, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-9 * np.abs(B).sum())
        if not fused:
            continue
        # lane j of the fused batch is lane j solved alone, bit for bit, up
        # to its stop (a lane that converges first keeps stepping in the
        # batch, as in the JAX package; lane 3 of lap2d_32 stops first)
        for j in (0, K - 1):
            _, xj, nj, ij, sj, bj = _run(eng, SolveSpec(batch=1, **spec),
                                         B[j:j + 1])
            assert (int(ij[0]), sj[0], int(bj[0])) == (int(ti[j]), ts[j],
                                                       int(tb[j]))
            assert np.array_equal(nj[: ij[0] + 1, 0], tn[: ij[0] + 1, j])
            if ij[0] == ti.max():
                assert np.array_equal(xj[0], tx[j])


def test_substrate_kind_follows_the_device(problems):
    _, pm, b = problems["lap2d_32"]
    eng = AzulEngine(pm, precond="block_ic0", dtype=np.float64, device="cpu")
    assert eng.substrate_kind("pcg_tol") == "reference"        # CPU "auto"
    assert eng.substrate_kind("pcg_tol", fused=True) == "fused_ic0"
    assert eng.substrate_kind("pcg", fused=False) == "reference"
    assert eng.plan(SolveSpec(method="pcg_tol")).info["substrate"] == "reference"
    forced = AzulEngine(pm, precond="block_ic0", dtype=np.float64, fused=True,
                        device="cpu")
    assert forced.plan(SolveSpec(method="pcg_tol")).info["substrate"] == "fused_ic0"
    # Jacobi is unchanged: "auto" is fused on the CPU too
    jac = AzulEngine(pm, dtype=np.float64, device="cpu")
    assert jac.substrate_kind("pcg_tol") == "fused"
    # the factors count in the device footprint
    assert eng.device_bytes() > jac.device_bytes() + sum(
        t.numel() * t.element_size()
        for t in (eng._ic0.ell_l.vals, eng._ic0.ell_u_rev.vals))


def test_convert_carries_the_factors(problems):
    jm, pm, b = problems["lap2d_32"]
    je = _jax_engine(jm)
    jf = je._ic0
    state = {"n": jf.n}
    for key, ell, sched in (("l", jf.ell_l, jf.sched_l),
                            ("u_rev", jf.ell_u_rev, jf.sched_u_rev)):
        state[f"{key}_cols"] = np.asarray(ell.cols)
        state[f"{key}_vals"] = np.asarray(ell.vals)
        state[f"{key}_rows"] = np.asarray(sched.rows)
    tf = convert.ic0_factors_from_numpy(state, device="cpu")
    _factors_equal(tf, jf)
    back = convert.ic0_factors_to_numpy(tf)
    assert back.keys() == state.keys()
    for k, v in state.items():
        assert np.array_equal(back[k], v), k
    eng = convert.engine_state_from_numpy(
        np.asarray(je.ell.cols), np.asarray(je.ell.vals),
        np.asarray(je._dinv_pad), je.n, je.n_pad, precond="block_ic0",
        fused=True, device="cpu", ic0=state)
    _, jx, _, ji, js, _ = _run(je, JaxSpec(method="pcg_tol", tol=1e-8,
                                           max_iters=400), b)
    _, tx, _, ti, ts, _ = _run(eng, SolveSpec(method="pcg_tol", tol=1e-8,
                                              max_iters=400), b)
    assert (int(ti), ts) == (int(ji), js) == (32, "converged")
    np.testing.assert_allclose(tx, jx, rtol=1e-9, atol=1e-12)
    assert set(convert.engine_state_to_numpy(eng)["ic0"]) == set(state)
    bad = dict(state, l_rows=state["l_rows"][1:])
    with pytest.raises(ValueError, match="every row"):
        convert.ic0_factors_from_numpy(bad, device="cpu")
    with pytest.raises(ValueError, match="ic0_factors"):
        AzulEngine.from_state(np.asarray(je.ell.cols), np.asarray(je.ell.vals),
                              np.asarray(je._dinv_pad), je.n,
                              precond="block_ic0", device="cpu")


def _cli(module, args, env_extra):
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", **env_extra)
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout[r.stdout.index("{"):])


def test_cli_block_ic0_matches_jax_cli(tmp_path):
    args = ["--matrix", "lap2d_32", "--method", "pcg_tol", "--precond",
            "block_ic0"]
    jax_out = _cli("repro.launch.solve", args,
                   {"REPRO_AUTOTUNE_CACHE": str(tmp_path / "autotune.json")})
    out = _cli("repro_torch.launch.solve", ["--device", "cpu", *args], {})
    assert out["iters_run"] == jax_out["iters_run"] == 32
    assert out["status"] == jax_out["status"] == "converged"
    assert abs(out["rel_error"] - jax_out["rel_error"]) <= 1e-9
    assert set(jax_out) - {"noc"} <= set(out)
    for k in ("matrix", "n", "nnz", "method", "precond", "substrate", "fused",
              "format", "layout", "reorder", "bad_iter", "tol"):
        assert out[k] == jax_out[k], k


def test_chip_smoke_ic0_parity_constants_match_jax():
    """chip_smoke.py holds the card to these counts: they must be the JAX
    package's (block_ic0 pcg_tol, f64, tol 1e-8; b as phase 3 draws it)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    mats = jmatrices.suite("small")
    rng = np.random.default_rng(0)
    for name, want in cs.PARITY_IC0.items():
        m = mats[name]
        a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
        b = a @ rng.standard_normal(m.shape[0])
        _, _, _, it, st, _ = _run(_jax_engine(m), JaxSpec(
            method="pcg_tol", tol=1e-8, max_iters=400), b)
        assert (int(it), st) == (want, "converged"), name
    for name, want in cs.PARITY_IC0_BATCHED.items():
        m = mats[name]
        B = np.random.default_rng(0).standard_normal((len(want), m.shape[0]))
        _, _, _, it, st, _ = _run(_jax_engine(m), JaxSpec(
            method="pcg_tol", tol=1e-8, max_iters=400, batch=len(want)), B)
        assert tuple(int(i) for i in it) == want, name
        assert st == ["converged"] * len(want)
