"""The second slice on the CPU: batched multi-RHS solves held against the
JAX package on the same numpy inputs.

* The plain batched kernels (``ell_spmm``, ``ell_spmm_pfold_dot``, the
  batched ``cg_update``) -- what ``repro_torch.kernels.ops`` runs for CPU
  tensors -- against ``repro.kernels.ref`` and the Pallas kernels in
  interpret mode.  The port takes the solver layout (k, n); the JAX ELL
  kernels take (n, k), so the JAX side gets the transposes.  Tolerance
  rtol = atol = 1e-12: only the summation order differs.
* Batched ``pcg_tol``/``pcg`` through ``AzulEngine.plan(SolveSpec(batch=
  k))``: per-lane ``iters``, ``status`` and ``bad_iter`` EQUAL to the JAX
  package's; ``x`` allclose at rtol 1e-9 and the (T, k) trace within
  1e-9 * ||b_j|| per lane (float64 throughout).
* Faulted lanes: a zero, a NaN and an ordinary lane; and one lane that
  breaks down mid-run while the others go on, which exercises the
  freeze-by-row-copy of ``solvers._freeze``.
* The plan surface, ``chunk_spec``, and the batched parity constants that
  ``chip_smoke.py`` holds the card to.
"""

import importlib.util
from dataclasses import fields
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core.engine import AzulEngine as JaxEngine
from repro.core.formats import csr_from_scipy as jcsr
from repro.core.plan import SolveSpec as JaxSpec
from repro.core.plan import chunk_spec as jax_chunk_spec
from repro.data import matrices as jmatrices
from repro.kernels import ref as jref
from repro.kernels.ell_spmv import ell_spmm as pallas_ell_spmm
from repro.kernels.spmv_dot import ell_spmm_pfold_dot as pallas_spmm_pfold_dot
from repro.kernels.vecops import cg_update as pallas_cg_update
from repro_torch import convert
from repro_torch.core import solvers
from repro_torch.core.engine import AzulEngine
from repro_torch.core.formats import csr_from_scipy as tcsr
from repro_torch.core.plan import SolveSpec, chunk_spec
from repro_torch.data import matrices
from repro_torch.kernels import ops

from test_torch_kernels import ELL_CASES, _close, _ell, _t

REPO = Path(__file__).resolve().parents[1]
LANES = [1, 3, 8]
K = 4                      # the batched solves' width


# -- the plain batched kernels against the JAX package ----------------------


@pytest.mark.parametrize("k", LANES)
@pytest.mark.parametrize("n,width,tm", ELL_CASES)
def test_ell_spmm_plain_matches_jax(n, width, tm, k):
    rng, cols, vals = _ell(n, width, seed=n + k)
    x = rng.standard_normal((k, cols.shape[0]))
    got = ops.ell_spmm(_t(cols), _t(vals), _t(x)).numpy()
    jc, jv, jx = jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x.T)
    assert got.shape == (k, cols.shape[0])
    _close(got, np.asarray(jref.ell_spmm_ref(jc, jv, jx)).T,
           np.asarray(pallas_ell_spmm(jc, jv, jx, tm=tm, tw=width,
                                      interpret=True)).T)


@pytest.mark.parametrize("k", LANES)
@pytest.mark.parametrize("n,width,tm", ELL_CASES)
def test_ell_spmm_pfold_dot_plain_matches_jax(n, width, tm, k):
    rng, cols, vals = _ell(n, width, seed=n + 2 * k)
    z, p = rng.standard_normal((2, k, cols.shape[0]))
    beta = np.linspace(0.0, 0.9, k)             # lane 0's beta is 0.0
    got = ops.ell_spmm_pfold_dot(_t(cols), _t(vals), _t(z), _t(p), _t(beta))
    jargs = (jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(z.T),
             jnp.asarray(p.T), jnp.asarray(beta))
    want_ref = jref.ell_spmm_pfold_dot_ref(*jargs)
    want_pl = pallas_spmm_pfold_dot(*jargs, tm=tm, tw=width, interpret=True)
    assert got[2].shape == (k,)
    for g, wr, wp in zip(got, want_ref, want_pl):
        wr, wp = np.asarray(wr), np.asarray(wp)
        if wr.ndim == 2:                        # (n, k) kernel layout
            wr, wp = wr.T, wp.T
        _close(g.numpy(), wr, wp)


@pytest.mark.parametrize("use_dinv", [True, False])
@pytest.mark.parametrize("k", LANES)
@pytest.mark.parametrize("n,tn", [(1000, 128), (4099, 512), (256, 256)])
def test_batched_cg_update_plain_matches_jax(n, tn, k, use_dinv):
    """Both batched bodies (``_b`` with the shared (n,) dinv, ``_b_nod``
    without), ragged n with a masked tail tile and an exact fit.  The
    Pallas cg_update takes the solver layout (k, n) itself."""
    rng = np.random.default_rng(n + tn + k)
    x, r, p, ap = rng.standard_normal((4, k, n))
    dinv = rng.random(n) + 0.5 if use_dinv else None
    alpha = np.linspace(0.1, 0.9, k).reshape(k, 1)
    got = ops.cg_update(_t(alpha), _t(x), _t(r), _t(p), _t(ap),
                        None if dinv is None else _t(dinv))
    jargs = [jnp.asarray(v) for v in (x, r, p, ap)]
    jd = None if dinv is None else jnp.asarray(dinv)
    want_ref = jref.cg_update_ref(jnp.asarray(alpha), *jargs, jd)
    want_pl = pallas_cg_update(jnp.asarray(alpha), *jargs, jd, tn=tn,
                               interpret=True)
    assert got[3].shape == got[4].shape == (k, 1)
    for g, wr, wp in zip(got, want_ref, want_pl):
        _close(g.numpy(), wr, wp)


# -- batched solves against the JAX package ---------------------------------


@pytest.fixture(scope="module")
def suite_pair():
    return jmatrices.suite("small"), matrices.suite("small")


def _jax_engine(m, precond="jacobi"):
    # format="ell": pinned, so the JAX engine neither reads nor writes its
    # on-disk autotune cache
    return JaxEngine(m, mesh=None, precond=precond, dtype=np.float64,
                     format="ell")


def _run(engine, spec, b, x0=None):
    plan = engine.plan(spec)
    x, norms = plan(b, x0)
    return (np.asarray(x), np.asarray(norms), np.asarray(plan.last_iters),
            list(plan.last_status_names), np.asarray(plan.last_bad_iter))


def _assert_same_batched_solve(j, t, b):
    jx, jn, ji, js, jb = j
    tx, tn, ti, ts, tb = t
    assert ti.shape == (b.shape[0],) and ti.dtype == np.int32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tb, jb)
    assert ts == js
    assert tn.shape == jn.shape and tn.dtype == jn.dtype
    bn = np.linalg.norm(b, axis=1)
    both = np.isfinite(jn)
    np.testing.assert_array_equal(both, np.isfinite(tn))
    assert np.all(np.abs(tn - jn)[both] <= (1e-9 * np.broadcast_to(bn, jn.shape))[both])
    np.testing.assert_allclose(tx, jx, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("method", ["pcg_tol", "pcg"])
@pytest.mark.parametrize("precond", ["jacobi", "none"])
@pytest.mark.parametrize("name", ["lap2d_32", "banded_1k"])
def test_batched_solve_matches_jax(suite_pair, name, precond, method):
    jm, pm = suite_pair[0][name], suite_pair[1][name]
    b = np.random.default_rng(0).standard_normal((K, jm.shape[0]))
    spec = (dict(method=method, tol=1e-8, max_iters=400) if method == "pcg_tol"
            else dict(method=method, iters=60))
    j = _run(_jax_engine(jm, precond), JaxSpec(batch=K, **spec), b)
    t = _run(AzulEngine(pm, precond=precond, dtype=np.float64, device="cpu"),
             SolveSpec(batch=K, **spec), b)
    _assert_same_batched_solve(j, t, b)
    want = "converged" if method == "pcg_tol" else "maxiter"
    assert t[3] == [want] * K


def test_batched_solvers_direct_match_the_plan(suite_pair):
    """``solvers.pcg_tol`` called directly on (k, n) tensors (reference
    substrate from matvec/psolve) gives the plan's per-lane results."""
    pm = suite_pair[1]["lap2d_32"]
    eng = AzulEngine(pm, dtype=np.float64, device="cpu")
    b = np.random.default_rng(0).standard_normal((K, eng.n))
    plan = eng.plan(SolveSpec(method="pcg_tol", tol=1e-8, max_iters=400,
                              batch=K, fused=False))
    x, norms = plan(b)
    cols, vals, dinv = eng.ell.cols, eng.ell.vals, eng._dinv_pad
    from repro_torch.core.spops import spmm_ell_padded

    res = solvers.pcg_tol(lambda v: spmm_ell_padded(cols, vals, v),
                          eng.to_device_vec(b), lambda r: r * dinv,
                          x0=eng.to_device_vec(np.zeros_like(b)), tol=1e-8,
                          max_iters=400)
    np.testing.assert_array_equal(res.iters, plan.last_iters)
    np.testing.assert_array_equal(res.res_norms, norms)
    np.testing.assert_array_equal(eng.from_device_vec(res.x), x)


@pytest.mark.parametrize("method", ["pcg_tol", "pcg"])
def test_zero_nan_and_ordinary_lanes_match_jax(suite_pair, method):
    """A zero lane converges at once, a NaN lane is a breakdown at
    iteration 0 and stays frozen, the ordinary lane runs as if alone."""
    jm, pm = suite_pair[0]["lap2d_32"], suite_pair[1]["lap2d_32"]
    b = np.zeros((3, jm.shape[0]))
    b[1, 5] = np.nan
    b[2] = np.random.default_rng(0).standard_normal(jm.shape[0])
    spec = (dict(method=method, tol=1e-8, max_iters=200) if method == "pcg_tol"
            else dict(method=method, iters=40))
    j = _run(_jax_engine(jm), JaxSpec(batch=3, **spec), b)
    t = _run(AzulEngine(pm, dtype=np.float64, device="cpu"),
             SolveSpec(batch=3, **spec), b)
    _assert_same_batched_solve(j, t, b)
    last = "converged" if method == "pcg_tol" else "maxiter"
    assert t[3] == [last, "breakdown", last] and t[4][1] == 0
    assert not t[0][0].any() and not t[0][1].any()     # frozen at x0 = 0


def _split_operator():
    """Block-diagonal A: an SPD Laplacian block beside the indefinite one
    of test_torch_solve (lap2d(10), entry (1, 1) scaled by -1000).  Lanes 0
    and 2 live on the SPD block and converge; lane 1 lives on the
    indefinite block and breaks down mid-run."""
    m = matrices.laplacian_2d(10)
    spd = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    bad = spd.copy()
    bad[1, 1] *= -1000.0
    a = sp.block_diag([spd, bad]).tocsr()
    h = spd.shape[0]
    x = np.random.default_rng(0).standard_normal((3, 2 * h))
    x[[0, 2], h:] = 0.0
    x[1, :h] = 0.0
    x[1, h:] = np.random.default_rng(0).standard_normal(h)
    return a, (a @ x.T).T


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("method", ["pcg_tol", "pcg"])
def test_lane_faulting_mid_run_is_frozen_like_jax(method, fused):
    a, b = _split_operator()
    spec = (dict(method=method, tol=1e-10, max_iters=200)
            if method == "pcg_tol" else dict(method=method, iters=80))
    j = _run(JaxEngine(jcsr(a), mesh=None, dtype=np.float64, format="ell"),
             JaxSpec(batch=3, fused=fused, **spec), b)
    t = _run(AzulEngine(tcsr(a), dtype=np.float64, device="cpu"),
             SolveSpec(batch=3, fused=fused, **spec), b)
    _assert_same_batched_solve(j, t, b)
    iters, status, bad = t[2], t[3], t[4]
    last = "converged" if method == "pcg_tol" else "maxiter"
    assert status == [last, "breakdown", last]
    # lane 1 faults while the others are still running, and the others
    # go on stepping past it
    assert 1 <= bad[1] < iters[0] and bad[0] == bad[2] == -1
    assert np.isfinite(t[0]).all()
    # the faulted lane's trace holds its last good residual from bad_iter on
    tr = t[1][:, 1]
    assert np.all(tr[bad[1]:] == tr[bad[1] - 1])


# -- the plan surface --------------------------------------------------------


def _converted(jm):
    je = _jax_engine(jm)
    pe = convert.engine_state_from_numpy(
        np.asarray(je.ell.cols), np.asarray(je.ell.vals),
        np.asarray(je._dinv_pad), je.n, je.n_pad, device="cpu")
    return je, pe


def test_batched_plan_surface_on_converted_operands(suite_pair):
    jm = suite_pair[0]["lap2d_32"]
    je, pe = _converted(jm)
    rng = np.random.default_rng(4)
    b = rng.standard_normal((K, jm.shape[0]))
    x0 = rng.standard_normal(jm.shape[0])          # one x0 for every lane
    spec = dict(method="pcg_tol", tol=1e-8, max_iters=400, batch=K)
    j = _run(je, JaxSpec(**spec), b, x0)
    t = _run(pe, SolveSpec(**spec), b, x0)
    _assert_same_batched_solve(j, t, b)
    plan = pe.plan(SolveSpec(**spec))
    assert plan.last_iters.shape == (K,)
    assert isinstance(plan.last_status_names, list)
    assert pe.last_solve_info["status_names"] == plan.last_status_names
    assert plan.info["batch"] == K
    # the shared x0 is the broadcast one
    t2 = _run(pe, SolveSpec(**spec), b, np.broadcast_to(x0, b.shape))
    np.testing.assert_array_equal(t2[0], t[0])
    with pytest.raises(ValueError, match="RHS shape"):
        plan(b[:2])
    with pytest.raises(ValueError, match="RHS shape"):
        plan(b[0])
    with pytest.raises(ValueError, match="RHS shape"):
        pe.plan(SolveSpec(method="pcg_tol", max_iters=400))(b)
    for batch in (0, "4"):
        with pytest.raises(ValueError, match="positive int"):
            pe.plan(SolveSpec(method="pcg_tol", batch=batch))


def test_engine_spmv_takes_a_batch(suite_pair):
    jm, pm = suite_pair[0]["banded_1k"], suite_pair[1]["banded_1k"]
    x = np.random.default_rng(2).standard_normal((3, jm.shape[0]))
    got = AzulEngine(pm, dtype=np.float64, device="cpu").spmv(x)
    want = _jax_engine(jm).spmv(x)
    assert got.shape == (3, jm.shape[0])
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12, atol=1e-12)


_SPEC_FIELDS = ("method", "precond", "iters", "tol", "max_iters", "batch",
                "fused", "layout", "reorder", "guard", "format")


@pytest.mark.parametrize("fixed_length", [True, False])
@pytest.mark.parametrize("method", ["pcg", "pcg_tol"])
def test_chunk_spec_matches_jax(method, fixed_length):
    assert set(_SPEC_FIELDS) == {f.name for f in fields(SolveSpec)}
    kw = dict(method=method, iters=300, tol=1e-7, max_iters=500)
    got = chunk_spec(SolveSpec(**kw), 25, batch=8, fixed_length=fixed_length)
    want = jax_chunk_spec(JaxSpec(**kw), 25, batch=8,
                          fixed_length=fixed_length)
    for f in _SPEC_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    with pytest.raises(ValueError, match="chunk"):
        chunk_spec(SolveSpec(**kw), 0)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_batched_parity_constants_match_jax(suite_pair):
    """``chip_smoke.py`` holds the card's batched per-lane counts to these
    constants; they must be the JAX package's own."""
    consts = _chip_smoke().PARITY_BATCHED
    assert set(consts) == {"lap2d_32", "banded_1k"}
    for name, want in consts.items():
        jm = suite_pair[0][name]
        b = np.random.default_rng(0).standard_normal((len(want), jm.shape[0]))
        _, _, iters, status, _ = _run(
            _jax_engine(jm),
            JaxSpec(method="pcg_tol", tol=1e-8, max_iters=400,
                    batch=len(want)), b)
        assert tuple(int(i) for i in iters) == tuple(want)
        assert status == ["converged"] * len(want)
