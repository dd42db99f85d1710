"""The port's CUDA kernels on a card, held against their plain versions.

Every test here needs an NVIDIA card and carries the ``gpu`` marker; with
no card the ``cuda`` fixture skips it.  The module imports neither ``jax``
nor ``repro``, so on a machine without JAX it runs alone:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_cuda.py

Tolerances, because only the summation order differs: max |kernel -
plain| <= rtol * max |plain| with rtol 1e-12 in float64 and 1e-5 in
float32; the elementwise outputs (p', x', r', z) are bitwise equal.  The
batched kernels' lane j does not depend on k: it equals a k = 1 call on
lane j's inputs bit for bit, in every output.  ``sptrsv_solve_dot`` is
held to its plain version on random lower-triangular matrices, a chain, a
diagonal and IC(0) factors, is bitwise the same on a second run, and
leaves padded rows 0.  ``bcsr_spmm`` is held to its plain version at the
JAX sweep shapes and the engine's 8 x 8 blocks, lane by lane bitwise
independent of R; the SELL and HYB matvecs (plain PyTorch, fixed-order
row sums) repeat bit for bit, lane j of a batch equals its solo call, and
both equal the CPU's bits; plans on every format reach the CPU's counts.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro_torch.core.engine import AzulEngine
from repro_torch.core.plan import SolveSpec
from repro_torch.data.matrices import suite
from repro_torch.core.formats import csr_from_scipy, ell_from_csr
from repro_torch.core.levels import build_schedule
from repro_torch.core.precond import _inv_diag, ic0
from repro_torch.data.matrices import laplacian_2d
from repro_torch.core import formats, spops
from repro_torch.data.matrices import skew_spd
from repro_torch.kernels import bcsr_spmm, ell_spmv, ops, spmv_dot, sptrsv, vecops

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
                      "cg_update_batched": 0, "sptrsv_solve_dot": 0,
                      "bcsr_spmm": 0}
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
                      "cg_update_batched": steps, "sptrsv_solve_dot": 0,
                      "bcsr_spmm": 0}
    assert x.shape == (4, m.shape[0]) and norms.shape == (401, 4)
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    res = np.linalg.norm(b - (a @ x.T).T, axis=1) / np.linalg.norm(b, axis=1)
    assert np.all(res <= 1e-7)


# -- sptrsv_solve_dot ---------------------------------------------------------


def _triangular(case):
    """A lower-triangular CSR for each card case: random with a dominant
    diagonal (two densities), a 2047-row bidiagonal chain (2047 levels of
    one row), a diagonal (one level), and lap2d_64's IC(0) factors."""
    if case.startswith("rand"):
        n, dens = {"rand1000": (1000, 0.01), "rand4099": (4099, 0.002)}[case]
        a = sp.random(n, n, density=dens, random_state=n, format="csr")
        low = sp.tril(a, -1).tocsr()
        return csr_from_scipy(low + sp.diags(np.asarray(abs(low).sum(1)).ravel() + 1))
    if case == "chain":
        return csr_from_scipy(sp.diags([np.full(2046, -0.5), np.ones(2047)],
                                       [-1, 0]).tocsr())
    return csr_from_scipy(sp.diags(np.arange(1.0, 101.0)).tocsr())


def _solve_inputs(case, dtype, device):
    if case in ("ic0_L", "ic0_U"):
        f = ic0(laplacian_2d(64), dtype=np.float64 if dtype == torch.float64
                else np.float32, device=device)
        ell, rows = ((f.ell_l, f.sched_l.rows) if case == "ic0_L"
                     else (f.ell_u_rev, f.sched_u_rev.rows))
        n = f.n
    else:
        m = _triangular(case)
        n = m.shape[0]
        ell = ell_from_csr(m, row_pad=8, width_pad=8,
                           dtype=np.float64 if dtype == torch.float64
                           else np.float32, device=device)
        rows = torch.from_numpy(build_schedule(m).rows).to(device)
    g = torch.Generator(device=device).manual_seed(n)
    b = torch.zeros(ell.rows_padded, dtype=dtype, device=device)
    b[:n] = torch.randn(n, generator=g, device=device, dtype=dtype)
    w = torch.zeros_like(b)
    w[:n] = torch.randn(n, generator=g, device=device, dtype=dtype)
    return ell, rows, _inv_diag(ell, dtype), b, w, n


SOLVE_CASES = ["rand1000", "rand4099", "chain", "diag", "ic0_L", "ic0_U"]


@pytest.mark.parametrize("with_dot", [True, False])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", SOLVE_CASES)
def test_sptrsv_kernel_matches_plain(cuda, case, dtype, with_dot):
    ell, rows, dinv, b, w, n = _solve_inputs(case, dtype, cuda)
    wd = w if with_dot else None
    pack = ops.sptrsv_solve_pack(ell.cols, rows, n)
    before = sptrsv.sptrsv_solve_dot.launches
    x, pp = sptrsv.sptrsv_solve_dot(ell.cols, ell.vals, dinv, b, pack, wd)
    x2, pp2 = sptrsv.sptrsv_solve_dot(ell.cols, ell.vals, dinv, b, pack, wd)
    torch.cuda.synchronize()
    assert sptrsv.sptrsv_solve_dot.launches == before + 2
    assert torch.equal(x, x2) and torch.equal(pp, pp2)        # deterministic
    assert bool((x[n:] == 0).all())
    want = sptrsv.sptrsv_solve_dot_plain(ell.cols, ell.vals, dinv, b, rows,
                                         torch.zeros_like(w) if wd is None
                                         else w, n)
    _close((x, pp.reshape(1)), (want[0], want[1].reshape(1)), dtype)
    if wd is None:
        assert float(pp) == 0.0


def test_sptrsv_wrapper_checks_operands(cuda):
    ell, rows, dinv, b, w, n = _solve_inputs("rand1000", torch.float64, cuda)
    pack = ops.sptrsv_solve_pack(ell.cols, rows, n)
    with pytest.raises(TypeError, match="b"):
        sptrsv.sptrsv_solve_dot(ell.cols, ell.vals, dinv, b.float(), pack)
    with pytest.raises(TypeError, match="cols"):
        sptrsv.sptrsv_solve_dot(ell.cols.long(), ell.vals, dinv, b, pack)
    with pytest.raises(ValueError, match="wdot"):
        sptrsv.sptrsv_solve_dot(ell.cols, ell.vals, dinv, b, pack, w[:-8])
    with pytest.raises(ValueError, match="cpu"):
        sptrsv.sptrsv_solve_dot(ell.cols, ell.vals, dinv, b.cpu(), pack)
    # a grid the card cannot hold co-resident: the cooperative launch is
    # refused, and the wrapper raises instead of running another path
    before = sptrsv.sptrsv_solve_dot.launches
    too_many = sptrsv.grid_blocks(pack._replace(max_width=1 << 30),
                                  torch.float64, b.device) + 1
    with pytest.raises(RuntimeError, match="sptrsv_solve_dot: CUDA error"):
        sptrsv.sptrsv_solve_dot(ell.cols, ell.vals, dinv, b, pack, w,
                                blocks=too_many)
    assert sptrsv.sptrsv_solve_dot.launches == before
    x, _ = sptrsv.sptrsv_solve_dot(ell.cols, ell.vals, dinv, b, pack, w)
    torch.cuda.synchronize()
    assert torch.isfinite(x).all()


@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("name", ["lap2d_32", "banded_1k"])
def test_block_ic0_plan_on_the_card(cuda, name, batch):
    """block_ic0 pcg_tol on the card through the fused IC(0) substrate:
    the JAX package's counts within one iteration a lane (1-D 32 and 1;
    k = 4 as chip_smoke.py's PARITY_IC0_BATCHED), two sptrsv_solve_dot
    launches per lane per loop step plus two per lane at start-up."""
    want = {("lap2d_32", None): [32], ("banded_1k", None): [1],
            ("lap2d_32", 4): [35, 35, 35, 34], ("banded_1k", 4): [1] * 4}
    m = suite("small")[name]
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    rng = np.random.default_rng(0)
    b = (rng.standard_normal((4, m.shape[0])) if batch
         else a @ rng.standard_normal(m.shape[0]))
    eng = AzulEngine(m, precond="block_ic0", dtype=np.float64)
    plan = eng.plan(SolveSpec(method="pcg_tol", tol=1e-8, max_iters=400,
                              batch=batch))
    assert plan.info["substrate"] == "fused_ic0"
    ops.reset_launch_counts()
    x, _ = plan(b)
    counts = ops.launch_counts()
    iters = np.atleast_1d(plan.last_iters)
    steps, lanes = int(iters.max()), len(iters)
    assert np.all(np.abs(iters - want[(name, batch)]) <= 1)
    assert np.all(np.atleast_1d(plan.last_status_names) == "converged")
    assert counts["sptrsv_solve_dot"] == 2 * lanes * (steps + 1)
    pfold = "ell_spmm_pfold_dot" if batch else "ell_spmv_pfold_dot"
    update = "cg_update_batched" if batch else "cg_update"
    assert counts[pfold] == counts[update] == steps
    xs = np.atleast_2d(x)
    bs = np.atleast_2d(b)
    res = np.linalg.norm(bs - (a @ xs.T).T, axis=1) / np.linalg.norm(bs, axis=1)
    assert np.all(res <= 1e-7)


# -- the format portfolio: bcsr_spmm, SELL and HYB matvecs, plans ------------


def _bcsr(n, density, bm, bn, dtype, seed, device):
    a = sp.random(n, n, density=density, random_state=seed, format="csr")
    a.setdiag(2.0)
    b = formats.bcsr_from_csr(csr_from_scipy(a.tocsr()), bm=bm, bn=bn,
                              dtype=np.float64, device=device)
    return b.block_cols, b.blocks.to(dtype), -(-n // bn)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("bm,bn,r", [(8, 16, 4), (8, 128, 8), (16, 32, 16),
                                     (8, 8, 1), (8, 8, 8), (4, 8, 17)])
def test_bcsr_spmm_kernel_matches_plain(cuda, bm, bn, r, dtype):
    bc, bl, nbc = _bcsr(1003, 0.01, bm, bn, dtype, bm * bn + r, cuda)
    g = torch.Generator(device=cuda).manual_seed(r)
    x = torch.randn(nbc * bn, r, generator=g, device=cuda, dtype=dtype)
    before = bcsr_spmm.bcsr_spmm.launches
    y = bcsr_spmm.bcsr_spmm(bc, bl, x, nbc=nbc)
    torch.cuda.synchronize()
    assert bcsr_spmm.bcsr_spmm.launches == before + 1
    _close((y,), (bcsr_spmm.bcsr_spmm_plain(bc, bl, x),), dtype)
    # a second launch and the lanes-major layout give the same bits
    assert torch.equal(y, bcsr_spmm.bcsr_spmm(bc, bl, x, nbc=nbc))
    xt = x.T.contiguous().T
    yt = bcsr_spmm.bcsr_spmm(bc, bl, xt, nbc=nbc)
    assert yt.stride(0) == 1 or r == 1
    assert torch.equal(yt, y)
    # lane j of the R-wide call is the R = 1 call on lane j
    for j in range(r):
        assert torch.equal(y[:, j: j + 1],
                           bcsr_spmm.bcsr_spmm(bc, bl, x[:, j: j + 1].contiguous()))
    # rows past x_valid read as 0
    xv = x.clone()
    xv[nbc * bn // 2:] = 0
    assert torch.equal(bcsr_spmm.bcsr_spmm(bc, bl, x, x_valid=nbc * bn // 2),
                       bcsr_spmm.bcsr_spmm(bc, bl, xv))


def test_bcsr_wrapper_checks_operands(cuda):
    bc, bl, nbc = _bcsr(200, 0.05, 8, 8, torch.float64, 1, cuda)
    x = torch.ones(nbc * 8, 2, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="incompatible with nbc"):
        bcsr_spmm.bcsr_spmm(bc, bl, x, nbc=nbc + 1)
    with pytest.raises(ValueError, match="incompatible with nbc"):
        ops.bcsr_spmm(bc, bl, x[:-8], nbc=nbc)
    with pytest.raises(ValueError, match="float32"):
        bcsr_spmm.bcsr_spmm(bc, bl, x.float())
    with pytest.raises(TypeError, match="cols_block"):
        bcsr_spmm.bcsr_spmm(bc.long(), bl, x)
    with pytest.raises(ValueError, match="strides"):
        bcsr_spmm.bcsr_spmm(bc, bl, torch.ones(nbc * 8, 4, dtype=torch.float64,
                                               device=cuda)[:, ::2])
    with pytest.raises(ValueError, match="bn <= 128"):
        bcsr_spmm.bcsr_spmm(bc[:, :1].contiguous(),
                            torch.ones(bc.shape[0], 1, 8, 256,
                                       dtype=torch.float64, device=cuda),
                            torch.ones(256, 1, dtype=torch.float64, device=cuda))


@pytest.mark.parametrize("name", ["skew_1k", "rmat_1k"])
def test_sell_hyb_matvecs_deterministic_on_card(cuda, name):
    """No float atomics: two calls are bitwise equal, lane j of k = 8 is
    the solo call on lane j, and the bits equal the CPU's (elementwise
    multiplies and adds in a fixed order give the same IEEE results)."""
    m = suite("small")[name]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((8, 1000)))
    for build, mv, mm in ((formats.sell_from_csr, spops.spmv_sell_flat,
                           spops.spmm_sell_flat),
                          (formats.hyb_from_csr, spops.spmv_hyb_padded,
                           spops.spmm_hyb_padded)):
        on_card = build(m, dtype=np.float64, device=cuda)
        on_cpu = build(m, dtype=np.float64, device="cpu")
        xc = x.to(cuda)
        wide = mm(on_card, xc)
        assert torch.equal(wide, mm(on_card, xc))
        for j in range(8):
            assert torch.equal(wide[j], mv(on_card, xc[j]))
            assert torch.equal(wide[j], mm(on_card, xc[j: j + 1])[0])
        assert torch.equal(wide.cpu(), mm(on_cpu, x))


@pytest.mark.parametrize("name,fmt", [
    ("skew_1k", "auto"), ("skew_1k", "sell"), ("skew_1k", "bcsr"),
    ("rmat_1k", "auto"), ("lap2d_32", "bcsr"), ("skew_96", "hyb")])
def test_format_plans_on_the_card(cuda, name, fmt):
    """pcg_tol on each format on the card: the CPU's count within one (the
    dots sum in another order), the same status on both substrates, and
    the launches of the format's path: bcsr_spmm once per matvec (loop
    steps + 1), no ELL kernel; SELL/HYB only cg_update."""
    m = (skew_spd(96, hubs=3, hub_nnz=30, seed=1) if name == "skew_96"
         else suite("small")[name])
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    b = a @ np.random.default_rng(0).standard_normal(m.shape[0])
    spec = SolveSpec(method="pcg_tol", tol=1e-8, max_iters=400)
    cpu = AzulEngine(m, dtype=np.float64, format=fmt, device="cpu").plan(spec)
    cpu(b)
    eng = AzulEngine(m, dtype=np.float64, format=fmt)
    plan = eng.plan(spec)
    ops.reset_launch_counts()
    x, _ = plan(b)
    counts = ops.launch_counts()
    steps = int(plan.last_iters)
    assert plan.info["format"] == cpu.info["format"]
    assert abs(steps - int(cpu.last_iters)) <= 1
    assert plan.last_status_names == "converged"
    assert counts["cg_update"] == steps
    bcsr = plan.info["format"] == "bcsr"
    assert counts["bcsr_spmm"] == (steps + 1 if bcsr else 0)
    assert counts["ell_spmv"] == counts["ell_spmv_pfold_dot"] == 0
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) <= 1e-7
    ref = eng.plan(SolveSpec(method="pcg_tol", tol=1e-8, max_iters=400,
                             fused=False))
    ref(b)
    assert ref.last_status_names == "converged"
    assert abs(int(ref.last_iters) - steps) <= 1
