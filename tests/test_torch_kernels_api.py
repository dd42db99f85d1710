"""The four kernels reached through ``kernels.ops`` only (``ell_spmv_dot``,
``ell_spmm_dot``, ``axpy_dot``, ``sptrsv_level_step``): the port's plain
versions -- what ``repro_torch.kernels.ops`` runs for CPU tensors -- held
against ``repro.kernels.ref`` and the Pallas kernels in interpret mode on
the same numpy inputs.

Sweeps: those of ``tests/test_fused.py`` (hypothesis, n 12-120, float32
and float64, k 1-5) for the SpMV + dot pair; those of
``tests/test_kernels.py`` (level-step full solves at n = 24 and 72 against
scipy, ``axpy_dot`` at n = 1024 and 4096); and a factor whose padded rows
(rows_p >= n + 2) hold columns past n, with level lists carrying ids past
n, which exercises the sentinel clamps and the dropped scatter; and
lap2d_32's IC(0) L factor level by level, with a numpy model of the card
kernel writing x in place (``out=x``) in two thread orders.

Tolerances, as in the JAX tests: 1e-12 in float64; in float32 1e-4 for
the vectors and rtol 1e-5 (atol 1e-4) for the dots.  Only the summation
order differs.  The CUDA kernels run only on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _hypothesis_compat import given, settings, strategies as st
from repro.core.formats import csr_from_scipy, ell_from_csr
from repro.core.levels import build_schedule
from repro.core.spops import extract_diag_ell
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.spmv_dot import ell_spmm_dot as pallas_spmm_dot
from repro.kernels.spmv_dot import ell_spmv_dot as pallas_spmv_dot
from repro.kernels.vecops import axpy_dot as pallas_axpy_dot
from repro_torch.kernels import ops, spmv_dot, sptrsv, vecops
from torch_threads import one_torch_thread  # noqa: F401


def _tol(f64: bool) -> dict:
    return {"vec": 1e-12 if f64 else 1e-4,
            "dot": dict(rtol=1e-12, atol=1e-12) if f64
            else dict(rtol=1e-5, atol=1e-4)}


@pytest.fixture
def interpret():
    """The JAX ops in Pallas interpret mode, the mode restored after."""
    before = jops.backend_mode()
    jops.backend_mode("interpret")
    yield
    jops.backend_mode(before)


def _ell(n, density, seed, dtype):
    """A random square matrix with diagonal 2 as the JAX package's padded
    ELL (rows and width padded to 8), as numpy arrays."""
    a = sp.random(n, n, density=density, random_state=seed, format="csr")
    a.setdiag(2.0)
    e = ell_from_csr(csr_from_scipy(a.tocsr()), row_pad=8, width_pad=8,
                     dtype=dtype)
    return np.asarray(e.cols), np.asarray(e.vals)


def _t(a):
    return torch.from_numpy(np.array(a))


@given(st.integers(12, 120), st.sampled_from([0.05, 0.3]),
       st.booleans(), st.integers(0, 10**6))
@settings(max_examples=12, deadline=None)
def test_ell_spmv_dot_plain_matches_jax(n, density, f64, seed):
    dtype = np.float64 if f64 else np.float32
    cols, vals = _ell(n, density, seed, dtype)
    x = np.random.default_rng(seed).standard_normal(cols.shape[0]).astype(dtype)
    y, pap = ops.ell_spmv_dot(_t(cols), _t(vals), _t(x))
    assert y.dtype == pap.dtype == getattr(torch, np.dtype(dtype).name)
    jargs = (jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x))
    tol = _tol(f64)
    for wy, wp in (jref.ell_spmv_dot_ref(*jargs),
                   pallas_spmv_dot(*jargs, tm=8, tw=8, interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=tol["vec"])
        np.testing.assert_allclose(float(pap), float(wp), **tol["dot"])


@given(st.integers(12, 90), st.integers(1, 5), st.booleans(),
       st.integers(0, 10**6))
@settings(max_examples=10, deadline=None)
def test_ell_spmm_dot_plain_matches_jax(n, k, f64, seed):
    """The JAX kernel's layout x (rows_p, k) on both sides; the port's
    plain version also takes the transposed view of a (k, rows_p)
    tensor."""
    dtype = np.float64 if f64 else np.float32
    cols, vals = _ell(n, 0.15, seed, dtype)
    xk = np.random.default_rng(seed).standard_normal(
        (cols.shape[0], k)).astype(dtype)
    jargs = (jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(xk))
    wants = (jref.ell_spmm_dot_ref(*jargs),
             pallas_spmm_dot(*jargs, tm=8, tw=8, interpret=True))
    tol = _tol(f64)
    for x in (_t(xk), _t(xk.T).T):
        y, pap = ops.ell_spmm_dot(_t(cols), _t(vals), x)
        assert y.shape == (cols.shape[0], k) and pap.shape == (k,)
        for wy, wp in wants:
            np.testing.assert_allclose(y.numpy(), np.asarray(wy),
                                       atol=tol["vec"])
            np.testing.assert_allclose(pap.numpy(), np.asarray(wp),
                                       **tol["dot"])


@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("n,tn", [(1024, 256), (4096, 1024)])
def test_axpy_dot_plain_matches_jax(n, tn, f64):
    dtype = np.float64 if f64 else np.float32
    rng = np.random.default_rng(5)
    x = rng.standard_normal(n).astype(dtype)
    y = rng.standard_normal(n).astype(dtype)
    tol = _tol(f64)
    for a in (0.7, torch.tensor(0.7, dtype=getattr(torch, np.dtype(dtype).name))):
        z, zz = ops.axpy_dot(a, _t(x), _t(y))
        jx, jy = jnp.asarray(x), jnp.asarray(y)
        for wz, wzz in (jref.axpy_dot_ref(0.7, jx, jy),
                        pallas_axpy_dot(0.7, jx, jy, tn=tn, interpret=True)):
            np.testing.assert_allclose(z.numpy(), np.asarray(wz), atol=tol["vec"])
            np.testing.assert_allclose(float(zz), float(wzz), **tol["dot"])


def _lower(n, seed=3):
    """The lower-triangular matrix of ``tests/test_kernels.py``'s
    level-step solve: strictly lower random part plus 2 on the diagonal."""
    a = sp.random(n, n, density=0.2, random_state=seed, format="csr")
    return (sp.tril(a, k=-1) + sp.eye(n) * 2.0).tocsr()


def _level_case(n, dtype, sentinel: bool):
    """(cols, vals, diag, b, schedule rows) as numpy.  ``sentinel``: row
    padding to 16, so rows_p >= n + 2, the padded rows' columns set past n
    (to rows_p - 1), and 8 more ids past n (n + 2) in every level list."""
    m = csr_from_scipy(_lower(n))
    e = ell_from_csr(m, row_pad=16 if sentinel else 8, width_pad=8, dtype=dtype)
    cols, vals = np.array(e.cols), np.asarray(e.vals)
    rp = cols.shape[0]
    diag = np.asarray(extract_diag_ell(e))
    diag = np.where(diag == 0, 1.0, diag).astype(dtype)
    rows = np.asarray(build_schedule(m).rows)
    if sentinel:
        assert rp >= n + 2
        cols[n:] = rp - 1
        rows = np.concatenate(
            [rows, np.full((rows.shape[0], 8), n + 2, np.int32)], 1)
    b = np.zeros(rp, dtype)
    b[:n] = np.random.default_rng(4).standard_normal(n)
    return cols, vals, diag, b, rows


@pytest.mark.parametrize("sentinel", [False, True])
@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("n", [24, 72])
def test_sptrsv_level_step_plain_matches_jax(interpret, n, f64, sentinel):
    """Level by level from the same x (n + 1 slots): the port's step equals
    ``repro.kernels.ref`` and the JAX op in interpret mode (gather, Pallas
    kernel, dropped scatter) within the tolerance, the sentinel slot
    included, and leaves its input untouched; the full solve matches
    scipy's ``solve_triangular``."""
    from scipy.linalg import solve_triangular

    dtype = np.float64 if f64 else np.float32
    cols, vals, diag, b, rows = _level_case(n, dtype, sentinel)
    jc, jv, jd, jb = (jnp.asarray(a) for a in (cols, vals, diag, b))
    tc, tv, td, tb = (_t(a) for a in (cols, vals, diag, b))
    tol = _tol(f64)["vec"]
    x = np.zeros(n + 1, dtype)
    for lv in rows:
        tx = _t(x)
        got = ops.sptrsv_level_step(tc, tv, td, tb, tx, _t(lv))
        assert np.array_equal(tx.numpy(), x)           # functional
        assert torch.equal(got, sptrsv.sptrsv_level_step_plain(
            tc, tv, td, tb, tx, _t(lv)))
        jx, jl = jnp.asarray(x), jnp.asarray(lv)
        for want in (jref.sptrsv_level_step_ref(jc, jv, jd, jb, jx, jl),
                     jops.sptrsv_level_step(jc, jv, jd, jb, jx, jl, tl=8)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=tol)
        x = got.numpy()
    ref_x = solve_triangular(_lower(n).toarray(), b[:n].astype(np.float64),
                             lower=True)
    np.testing.assert_allclose(x[:n], ref_x, atol=1e-10 if f64 else 5e-4)


def _level_kernel_model(cols, vals, diag, b, x, level_rows, order):
    """A numpy model of the card's level step writing into ``x`` in place
    (``out=x``): the entries of ``level_rows`` taken one at a time in
    ``order`` (the threads' order is not fixed), each reading x as the
    writes before it left it; the kernel's arithmetic in x's dtype, each
    product and each partial sum rounded, in slot order from 0, then the
    difference and the quotient."""
    n = x.shape[0] - 1
    rows_p = cols.shape[0]
    for i in order:
        idx = int(level_rows[i])
        lr = min(idx, rows_p - 1)
        s = x.dtype.type(0)
        for c, v in zip(cols[lr], vals[lr]):
            s = s + (v if c != lr else x.dtype.type(0)) * x[min(int(c), n)]
        xr = (b[lr] - s) / diag[min(idx, n - 1)]
        if idx <= n:
            x[idx] = xr
    return x


@pytest.mark.parametrize("f64", [False, True])
def test_sptrsv_level_step_in_place_on_ic0_factor(interpret, f64):
    """lap2d_32's IC(0) L factor level by level: a model of the kernel
    updating x in place (out=x) gives the same bits for the real rows
    whether its entries run in forward or reversed order (no real row of a
    level reads a value the level writes), and the plain version is within
    the tolerance of it there; the plain version is within the tolerance
    of JAX's op in interpret mode from the same x, the sentinel slot
    included; the solve matches scipy's.  The sentinel slot itself is
    exempt in place: rows_p == n here, so the schedule's padding id n
    solves the clamped row n - 1, whose inputs the same level may write
    (csrc/sptrsv.cu's header)."""
    from scipy.linalg import solve_triangular

    from repro.core.precond import ic0 as jax_ic0
    from repro.data.matrices import laplacian_2d

    dtype = np.float64 if f64 else np.float32
    f = jax_ic0(laplacian_2d(32), dtype=dtype)
    n = f.n
    cols, vals = np.asarray(f.ell_l.cols), np.asarray(f.ell_l.vals)
    diag = np.asarray(extract_diag_ell(f.ell_l))
    diag = np.where(diag == 0, 1.0, diag).astype(dtype)
    b = np.zeros(cols.shape[0], dtype)
    b[:n] = np.random.default_rng(5).standard_normal(n)
    rows = np.asarray(f.sched_l.rows)
    assert rows.max() == n == cols.shape[0]   # padding ids clamp to row n - 1
    jc, jv, jd, jb = (jnp.asarray(a) for a in (cols, vals, diag, b))
    tc, tv, td, tb = (_t(a) for a in (cols, vals, diag, b))
    tol = _tol(f64)["vec"]
    x = np.zeros(n + 1, dtype)
    for lv in rows:
        model = _level_kernel_model(cols, vals, diag, b, x.copy(), lv,
                                    range(lv.shape[0]))
        back = _level_kernel_model(cols, vals, diag, b, x.copy(), lv,
                                   range(lv.shape[0] - 1, -1, -1))
        assert np.array_equal(model[:n], back[:n])
        got = ops.sptrsv_level_step(tc, tv, td, tb, _t(x), _t(lv)).numpy()
        np.testing.assert_allclose(got[:n], model[:n], rtol=0, atol=tol)
        want = jops.sptrsv_level_step(jc, jv, jd, jb, jnp.asarray(x),
                                      jnp.asarray(lv), tl=8)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)
        x = model
    lower = np.zeros((n, n))
    np.add.at(lower, (np.repeat(np.arange(n), cols.shape[1]), cols[:n].ravel()),
              vals[:n].ravel())
    ref_x = solve_triangular(lower, b[:n].astype(np.float64), lower=True)
    np.testing.assert_allclose(x[:n], ref_x, atol=1e-10 if f64 else 5e-4)


def test_ops_exports_are_the_plain_versions_on_cpu():
    """On CPU tensors each export returns its plain version's bits, and no
    launch is counted."""
    cols, vals = _ell(40, 0.2, 1, np.float64)
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal(cols.shape[0]))
    xk = _t(rng.standard_normal((cols.shape[0], 3)))
    c, v = _t(cols), _t(vals)
    before = ops.launch_counts()
    for got, want in ((ops.ell_spmv_dot(c, v, x),
                       spmv_dot.ell_spmv_dot_plain(c, v, x)),
                      (ops.ell_spmm_dot(c, v, xk),
                       spmv_dot.ell_spmm_dot_plain(c, v, xk)),
                      (ops.axpy_dot(0.3, x, x), vecops.axpy_dot_plain(0.3, x, x))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    lc, lv, ld, lb, lrows = (_t(a) for a in _level_case(24, np.float64, True))
    x0 = torch.zeros(25, dtype=torch.float64)
    assert torch.equal(ops.sptrsv_level_step(lc, lv, ld, lb, x0, lrows[0]),
                       sptrsv.sptrsv_level_step_plain(lc, lv, ld, lb, x0,
                                                      lrows[0]))
    assert ops.launch_counts() == before
    assert {"ell_spmv_dot", "ell_spmm_dot", "axpy_dot",
            "sptrsv_level_step"} <= set(before) and len(ops.KERNELS) == 12


def test_non_square_operator_raises_value_error():
    """As the JAX kernels do (``spmv_dot.py:83, 146, 151``), on the CPU path
    and in the kernel wrappers alike."""
    cols, vals = _ell(40, 0.2, 1, np.float64)
    rp = cols.shape[0]
    c, v = _t(cols), _t(vals)
    short = torch.ones(rp - 8, dtype=torch.float64)
    for fn in (ops.ell_spmv_dot, spmv_dot.ell_spmv_dot):
        with pytest.raises(ValueError, match="square padded operator"):
            fn(c, v, short)
    for fn in (ops.ell_spmm_dot, spmv_dot.ell_spmm_dot):
        with pytest.raises(ValueError, match="square padded operator"):
            fn(c, v, torch.ones(rp - 8, 2, dtype=torch.float64))
        with pytest.raises(ValueError, match=r"shape \(n, k\)"):
            fn(c, v, torch.ones(rp, dtype=torch.float64))
    with pytest.raises(ValueError, match="square padded operator"):
        pallas_spmv_dot(jnp.asarray(cols), jnp.asarray(vals),
                        jnp.ones(rp - 8), tm=8, tw=8, interpret=True)
    with pytest.raises(ValueError, match="square padded operator"):
        pallas_spmm_dot(jnp.asarray(cols), jnp.asarray(vals),
                        jnp.ones((rp - 8, 2)), tm=8, tw=8, interpret=True)


def test_kernel_wrappers_refuse_cpu_tensors():
    """Each of the four wrappers launches on a CUDA device or raises."""
    cols, vals = _ell(40, 0.2, 1, np.float64)
    c, v = _t(cols), _t(vals)
    x = torch.ones(cols.shape[0], dtype=torch.float64)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        spmv_dot.ell_spmv_dot(c, v, x)
    with pytest.raises(ValueError, match="CUDA"):
        spmv_dot.ell_spmm_dot(c, v, torch.ones(cols.shape[0], 2,
                                               dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        vecops.axpy_dot(0.5, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        sptrsv.sptrsv_level_step(c, v, x, x, torch.zeros(41, dtype=torch.float64),
                                 torch.zeros(8, dtype=torch.int32))
    assert ops.launch_counts() == before
