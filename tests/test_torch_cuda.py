"""The port's CUDA kernels on a card, held against their plain versions.

Every test here needs an NVIDIA card and carries the ``gpu`` marker; with
no card the ``cuda`` fixture skips it.  The module imports neither ``jax``
nor ``repro``, so on a machine without JAX it runs alone:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_cuda.py

Tolerances, because only the summation order differs: max |kernel -
plain| <= rtol * max |plain| with rtol 1e-12 in float64 and 1e-5 in
float32; the elementwise outputs (p', x', r', z) are bitwise equal.  The
batched kernels' lane j does not depend on k: it equals a k = 1 call on
lane j's inputs bit for bit, in every output.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro_torch.core.engine import AzulEngine
from repro_torch.core.plan import SolveSpec
from repro_torch.data.matrices import suite
from repro_torch.kernels import ell_spmv, ops, spmv_dot, vecops

pytestmark = pytest.mark.gpu

RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
DTYPES = [torch.float64, torch.float32]
# (rows, ELL width, stored entries per row): ragged rows, widths that are
# and are not a power of two, a single-lane group
SHAPES = [(1000, 5, 5), (4099, 8, 7), (64, 1, 1), (777, 33, 20)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _operator(rows, width, k, dtype, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    cols = torch.zeros(rows, width, dtype=torch.int32, device=device)
    vals = torch.zeros(rows, width, dtype=dtype, device=device)
    cols[:, :k] = torch.randint(0, rows, (rows, k), generator=g,
                                device=device, dtype=torch.int32)
    vals[:, :k] = torch.randn(rows, k, generator=g, device=device, dtype=dtype)
    vec = lambda: torch.randn(rows, generator=g, device=device, dtype=dtype)
    return cols, vals, vec


def _close(got, want, dtype):
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        assert err <= RTOL[dtype] * max(float(w.abs().max()), 1e-300), err


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows,width,k", SHAPES)
def test_ell_spmv_kernel_matches_plain(cuda, rows, width, k, dtype):
    cols, vals, vec = _operator(rows, width, k, dtype, rows + width, cuda)
    x = vec()
    before = ell_spmv.ell_spmv.launches
    y = ell_spmv.ell_spmv(cols, vals, x)
    assert ell_spmv.ell_spmv.launches == before + 1
    _close((y,), (ell_spmv.ell_spmv_plain(cols, vals, x),), dtype)


@pytest.mark.parametrize("beta", [0.0, 0.37])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows,width,k", SHAPES)
def test_pfold_kernel_matches_plain(cuda, rows, width, k, dtype, beta):
    cols, vals, vec = _operator(rows, width, k, dtype, rows + 1, cuda)
    z, p = vec(), vec()
    bt = torch.tensor(beta, dtype=dtype, device=cuda)
    got = spmv_dot.ell_spmv_pfold_dot(cols, vals, z, p, bt)
    want = spmv_dot.ell_spmv_pfold_dot_plain(cols, vals, z, p, bt)
    assert torch.equal(got[0], want[0])
    _close(got, want, dtype)
    again = spmv_dot.ell_spmv_pfold_dot(cols, vals, z, p, bt)
    assert torch.equal(again[2], got[2])        # no atomics: bitwise repeat


@pytest.mark.parametrize("use_dinv", [True, False])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n", [1, 1000, 1024, 4099])
def test_cg_update_kernel_matches_plain(cuda, n, dtype, use_dinv):
    _, _, vec = _operator(n, 1, 1, dtype, n + 7, cuda)
    x, r, p, ap = vec(), vec(), vec(), vec()
    dinv = vec().abs() + 0.5 if use_dinv else None
    alpha = torch.tensor(0.61, dtype=dtype, device=cuda)
    got = vecops.cg_update(alpha, x, r, p, ap, dinv)
    want = vecops.cg_update_plain(alpha, x, r, p, ap, dinv)
    for i in range(3):
        assert torch.equal(got[i], want[i]), i
    _close(got[3:], want[3:], dtype)


def test_wrappers_check_operands(cuda):
    cols, vals, vec = _operator(64, 8, 8, torch.float64, 3, cuda)
    x = vec()
    with pytest.raises(TypeError, match="cols"):
        ell_spmv.ell_spmv(cols.long(), vals, x)
    with pytest.raises(TypeError, match="x"):
        ell_spmv.ell_spmv(cols, vals, x.float())
    with pytest.raises(ValueError, match="contiguous"):
        ell_spmv.ell_spmv(cols, vals, torch.stack([x, x], 1)[:, 0])
    with pytest.raises(ValueError, match="cpu"):
        ell_spmv.ell_spmv(cols, vals, x.cpu())


@pytest.mark.parametrize("name,iters", [("lap2d_32", 94), ("banded_1k", 9)])
def test_pcg_tol_on_the_card(cuda, name, iters):
    """The main path on the card at suite size: the JAX package's count
    within one iteration (the kernels sum in another order), one launch of
    each per-iteration kernel per iteration."""
    mats = suite("small")
    rng = np.random.default_rng(0)
    bs = {}
    for nm in ("lap2d_32", "banded_1k"):     # b as benchmarks/bench_pcg.py draws it
        m = mats[nm]
        bs[nm] = sp.csr_matrix((m.data, m.indices, m.indptr),
                               shape=m.shape) @ rng.standard_normal(m.shape[0])
    eng = AzulEngine(mats[name], dtype=np.float64)
    plan = eng.plan(SolveSpec(method="pcg_tol", tol=1e-8, max_iters=400))
    ops.reset_launch_counts()
    x, norms = plan(bs[name])
    got = int(plan.last_iters)
    counts = ops.launch_counts()
    assert abs(got - iters) <= 1 and plan.last_status_names == "converged"
    assert counts == {"ell_spmv": 1, "ell_spmv_pfold_dot": got, "cg_update": got,
                      "ell_spmm": 0, "ell_spmm_pfold_dot": 0,
                      "cg_update_batched": 0}
    assert np.isfinite(x).all() and norms.shape == (401,)


# batch widths: one lane, a ragged chunk, a full chunk, two chunks
LANES = [1, 3, 8, 17]


def _lanes(vec, k):
    return torch.stack([vec() for _ in range(k)])


@pytest.mark.parametrize("k", LANES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows,width,nnz", SHAPES)
def test_ell_spmm_kernel_matches_plain(cuda, rows, width, nnz, dtype, k):
    cols, vals, vec = _operator(rows, width, nnz, dtype, rows + k, cuda)
    x = _lanes(vec, k)
    before = ell_spmv.ell_spmm.launches
    y = ell_spmv.ell_spmm(cols, vals, x)
    assert ell_spmv.ell_spmm.launches == before + 1 and y.shape == (k, rows)
    _close((y,), (ell_spmv.ell_spmm_plain(cols, vals, x),), dtype)


@pytest.mark.parametrize("k", LANES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows,width,nnz", SHAPES)
def test_spmm_pfold_kernel_matches_plain(cuda, rows, width, nnz, dtype, k):
    cols, vals, vec = _operator(rows, width, nnz, dtype, rows + 2 * k, cuda)
    z, p = _lanes(vec, k), _lanes(vec, k)
    beta = torch.linspace(0.0, 0.9, k, dtype=dtype, device=cuda)  # holds a 0
    got = spmv_dot.ell_spmm_pfold_dot(cols, vals, z, p, beta)
    want = spmv_dot.ell_spmm_pfold_dot_plain(cols, vals, z, p, beta)
    assert torch.equal(got[0], want[0]) and got[2].shape == (k,)
    _close(got, want, dtype)
    again = spmv_dot.ell_spmm_pfold_dot(cols, vals, z, p, beta)
    assert torch.equal(again[2], got[2])        # no atomics: bitwise repeat


@pytest.mark.parametrize("use_dinv", [True, False])
@pytest.mark.parametrize("k", LANES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n", [1, 1000, 4099])
def test_cg_update_batched_kernel_matches_plain(cuda, n, dtype, k, use_dinv):
    _, _, vec = _operator(n, 1, 1, dtype, n + 3 * k, cuda)
    x, r, p, ap = (_lanes(vec, k) for _ in range(4))
    dinv = vec().abs() + 0.5 if use_dinv else None
    alpha = torch.linspace(0.1, 0.9, k, dtype=dtype, device=cuda).reshape(k, 1)
    got = vecops.cg_update_batched(alpha, x, r, p, ap, dinv)
    want = vecops.cg_update_plain(alpha, x, r, p, ap, dinv)
    for i in range(3):
        assert torch.equal(got[i], want[i]), i
    assert got[3].shape == got[4].shape == (k, 1)
    _close(got[3:], want[3:], dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows,width,nnz", SHAPES)
def test_batched_lanes_do_not_depend_on_k(cuda, rows, width, nnz, dtype):
    """Lane j of a k = 8 call equals the k = 1 call on lane j's inputs bit
    for bit, every output; a k = 1 call equals the 1-D kernel."""
    cols, vals, vec = _operator(rows, width, nnz, dtype, rows + 5, cuda)
    k = 8
    x, z, p, r, ap = (_lanes(vec, k) for _ in range(5))
    dinv = vec().abs() + 0.5
    beta = torch.linspace(0.0, 0.7, k, dtype=dtype, device=cuda)
    alpha = torch.linspace(0.2, 0.8, k, dtype=dtype, device=cuda).reshape(k, 1)
    wide = (ell_spmv.ell_spmm(cols, vals, x),
            *spmv_dot.ell_spmm_pfold_dot(cols, vals, z, p, beta),
            *vecops.cg_update_batched(alpha, x, r, p, ap, dinv),
            *vecops.cg_update_batched(alpha, x, r, p, ap))
    for j in range(k):
        s = slice(j, j + 1)
        one = (ell_spmv.ell_spmm(cols, vals, x[s]),
               *spmv_dot.ell_spmm_pfold_dot(cols, vals, z[s], p[s], beta[s]),
               *vecops.cg_update_batched(alpha[s], x[s], r[s], p[s], ap[s], dinv),
               *vecops.cg_update_batched(alpha[s], x[s], r[s], p[s], ap[s]))
        for i, (w, o) in enumerate(zip(wide, one)):
            assert torch.equal(w[s], o), (j, i)
    flat = (ell_spmv.ell_spmv(cols, vals, x[0]),
            *spmv_dot.ell_spmv_pfold_dot(cols, vals, z[0], p[0], beta[0]),
            *vecops.cg_update(alpha[0], x[0], r[0], p[0], ap[0], dinv))
    one = (ell_spmv.ell_spmm(cols, vals, x[:1]),
           *spmv_dot.ell_spmm_pfold_dot(cols, vals, z[:1], p[:1], beta[:1]),
           *vecops.cg_update_batched(alpha[:1], x[:1], r[:1], p[:1], ap[:1], dinv))
    for i, (f, o) in enumerate(zip(flat, one)):
        assert torch.equal(f.reshape(-1), o.reshape(-1)), i


def test_batched_wrappers_refuse_transposed_views(cuda):
    """The batched kernels take the solver layout (k, n) as it is: a
    transposed (n, k) view is not contiguous and raises."""
    cols, vals, vec = _operator(64, 8, 8, torch.float64, 4, cuda)
    xt = torch.stack([vec(), vec()], 1).T          # (2, 64), not contiguous
    x = xt.contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ell_spmv.ell_spmm(cols, vals, xt)
    with pytest.raises(ValueError, match="contiguous"):
        spmv_dot.ell_spmm_pfold_dot(cols, vals, xt, x, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        vecops.cg_update_batched(0.5, x, xt, x, x)
    with pytest.raises(ValueError, match="square padded"):
        spmv_dot.ell_spmm_pfold_dot(cols, vals, x[:, :63], x[:, :63], 0.5)


@pytest.mark.parametrize("precond", ["jacobi", "none"])
def test_batched_plan_on_the_card(cuda, precond):
    """A k = 4 batched pcg_tol plan on lap2d_32: ell_spmm once, then the
    two batched per-iteration kernels once per loop step, no 1-D kernel;
    per-lane counts within one of the JAX package's (102, 98, 102, 102)."""
    m = suite("small")["lap2d_32"]
    b = np.random.default_rng(0).standard_normal((4, m.shape[0]))
    eng = AzulEngine(m, precond=precond, dtype=np.float64)
    plan = eng.plan(SolveSpec(method="pcg_tol", tol=1e-8, max_iters=400,
                              batch=4))
    ops.reset_launch_counts()
    x, norms = plan(b)
    counts = ops.launch_counts()
    iters = np.asarray(plan.last_iters)
    steps = int(iters.max())
    assert np.all(np.abs(iters - [102, 98, 102, 102]) <= 1)
    assert plan.last_status_names == ["converged"] * 4
    assert counts == {"ell_spmv": 0, "ell_spmv_pfold_dot": 0, "cg_update": 0,
                      "ell_spmm": 1, "ell_spmm_pfold_dot": steps,
                      "cg_update_batched": steps}
    assert x.shape == (4, m.shape[0]) and norms.shape == (401, 4)
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    res = np.linalg.norm(b - (a @ x.T).T, axis=1) / np.linalg.norm(b, axis=1)
    assert np.all(res <= 1e-7)
