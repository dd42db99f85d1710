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
Every variant of a redesigned kernel gives its first design's bits;
``sptrsv_level_step``'s redesign at every compiled width (1-8, 16),
aligned and not, and its programmatic wait: a solve with b rewritten on
the stream before each level, eager and in one graph, bitwise the solve
without it, one launch a level counted on every replay.  A
plan captures its loop once and its replays equal a direct call of the
same solver bit for bit, with the launches its kernels counted on the
card.  The solve service: a request that joins a running cohort while
the bucket moves k_pad 1 -> 2 -> 4 -> 8 equals its solo solve bit for
bit, the batched kernels' lanes are independent of k at the service's
buckets 2 and 4, an eviction frees the plans' memory pools (reserved
memory falls) and a reload captures each plan once, and a fused chunk
that fails on the card raises, with no plain plan built.  An injectable
plan's clean call equals the plain plan's bit for bit, with its launches;
a corrupted call breaks down and the next clean call is clean again, in
one capture; the restart manager recovers a corrupted chunk.  The LM zoo:
every architecture's f32 smoke config on the card within 1e-4 x max|cpu|
of its CPU run on the same weights (prefill and eight greedy decode
steps, the tokens equal), and ``launch.serve --arch --smoke --slots
--device cuda`` completing every request.  Training: two smoke train steps
on the card (the second with lr > 0) against the CPU's from the same
state and batches: loss and grad_norm within 1e-4 relative; Adafactor's
params within 1e-4 x max|p|; AdamW's first update is sign-like
(m^/sqrt(v^) ~ sign(g)), so an element whose grad is near zero in f32
noise may move by up to 2 lr more on one device: 99.9% of its params
within 1e-4 x max|p|, every one within 2 lr.
"""

import json

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
from repro_torch import configs, convert
from repro_torch import train as T
from repro_torch.data import TokenPipeline
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model as M
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.gpu

RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# the kernels no solver path launches (reached through kernels.ops only)
OFF_PATH = {"ell_spmv_dot": 0, "ell_spmm_dot": 0, "axpy_dot": 0,
            "sptrsv_level_step": 0}
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
    before = ops.launch_counts()["ell_spmv"]
    y = ell_spmv.ell_spmv(cols, vals, x)
    assert ops.launch_counts()["ell_spmv"] == before + 1
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
                      "bcsr_spmm": 0, **OFF_PATH}
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
    before = ops.launch_counts()["ell_spmm"]
    y = ell_spmv.ell_spmm(cols, vals, x)
    assert ops.launch_counts()["ell_spmm"] == before + 1
    assert y.shape == (k, rows)
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


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows,width,nnz", SHAPES)
def test_batched_lanes_do_not_depend_on_k(cuda, rows, width, nnz, dtype, k):
    """Lane j of a k-lane call (k = 2 and 4 are the service's buckets
    below 8) equals the k = 1 call on lane j's inputs bit for bit, every
    output; a k = 1 call equals the 1-D kernel."""
    cols, vals, vec = _operator(rows, width, nnz, dtype, rows + 5, cuda)
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
                      "bcsr_spmm": 0, **OFF_PATH}
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
    before = ops.launch_counts()["sptrsv_solve_dot"]
    x, pp = sptrsv.sptrsv_solve_dot(ell.cols, ell.vals, dinv, b, pack, wd)
    x2, pp2 = sptrsv.sptrsv_solve_dot(ell.cols, ell.vals, dinv, b, pack, wd)
    torch.cuda.synchronize()
    assert ops.launch_counts()["sptrsv_solve_dot"] == before + 2
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
    before = ops.launch_counts()["sptrsv_solve_dot"]
    too_many = sptrsv.grid_blocks(pack._replace(max_width=1 << 30),
                                  torch.float64, b.device) + 1
    with pytest.raises(RuntimeError, match="sptrsv_solve_dot: CUDA error"):
        sptrsv.sptrsv_solve_dot(ell.cols, ell.vals, dinv, b, pack, w,
                                blocks=too_many)
    assert ops.launch_counts()["sptrsv_solve_dot"] == before
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
    before = ops.launch_counts()["bcsr_spmm"]
    y = bcsr_spmm.bcsr_spmm(bc, bl, x, nbc=nbc)
    torch.cuda.synchronize()
    assert ops.launch_counts()["bcsr_spmm"] == before + 1
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


# -- the kernels reached through kernels.ops only ------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows,width,k", SHAPES)
def test_ell_spmv_dot_kernel_matches_plain(cuda, rows, width, k, dtype):
    """Within the tolerance of the plain version, bitwise on a second
    launch, and y bitwise ell_spmv's (the same gather and row sums)."""
    cols, vals, vec = _operator(rows, width, k, dtype, rows + 11, cuda)
    x = vec()
    before = ops.launch_counts()["ell_spmv_dot"]
    y, pap = spmv_dot.ell_spmv_dot(cols, vals, x)
    assert ops.launch_counts()["ell_spmv_dot"] == before + 1
    assert pap.shape == ()
    want = spmv_dot.ell_spmv_dot_plain(cols, vals, x)
    _close((y, pap.reshape(1)), (want[0], want[1].reshape(1)), dtype)
    y2, pap2 = spmv_dot.ell_spmv_dot(cols, vals, x)
    assert torch.equal(y, y2) and torch.equal(pap, pap2)
    assert torch.equal(y, ell_spmv.ell_spmv(cols, vals, x))
    got = ops.ell_spmv_dot(cols, vals, x)
    assert torch.equal(got[0], y) and torch.equal(got[1], pap)


@pytest.mark.parametrize("k", LANES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows,width,nnz", SHAPES)
def test_ell_spmm_dot_kernel_matches_plain(cuda, rows, width, nnz, dtype, k):
    """The JAX layout X (rows_p, k), row-major and as the transposed view
    of the solver's (k, rows_p): Y in x's layout, within the tolerance,
    the two layouts and lane j vs the k = 1 call bitwise equal, Y bitwise
    ell_spmm's."""
    cols, vals, vec = _operator(rows, width, nnz, dtype, rows + 3 * k, cuda)
    xs = _lanes(vec, k)                      # (k, rows), the solver layout
    y, pap = spmv_dot.ell_spmm_dot(cols, vals, xs.T.contiguous())
    yv, papv = spmv_dot.ell_spmm_dot(cols, vals, xs.T)
    assert y.shape == yv.shape == (rows, k) and pap.shape == (k,)
    if k > 1:
        assert y.is_contiguous() and yv.stride() == xs.T.stride()
    want = spmv_dot.ell_spmm_dot_plain(cols, vals, xs.T)
    _close((y, pap), want, dtype)
    assert torch.equal(y, yv) and torch.equal(pap, papv)
    assert torch.equal(yv.T, ell_spmv.ell_spmm(cols, vals, xs))
    for j in range(k):
        yj, pj = spmv_dot.ell_spmm_dot(cols, vals, xs[j: j + 1].T)
        assert torch.equal(yj, y[:, j: j + 1]) and torch.equal(pj, pap[j: j + 1])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n", [1, 1000, 1024, 4099])
def test_axpy_dot_kernel_matches_plain(cuda, n, dtype):
    """z bitwise the plain version's (a a number or a 0-d device tensor),
    zz within the tolerance and bitwise on a second launch."""
    _, _, vec = _operator(n, 1, 1, dtype, n + 13, cuda)
    x, y = vec(), vec()
    for a in (0.7, torch.tensor(-1.3, dtype=dtype, device=cuda)):
        before = ops.launch_counts()["axpy_dot"]
        z, zz = vecops.axpy_dot(a, x, y)
        assert ops.launch_counts()["axpy_dot"] == before + 1
        assert zz.shape == ()
        want = vecops.axpy_dot_plain(a, x, y)
        assert torch.equal(z, want[0])
        _close((zz.reshape(1),), (want[1].reshape(1),), dtype)
        assert torch.equal(zz, vecops.axpy_dot(a, x, y)[1])


def _level_inputs(case, dtype, device):
    """(cols, vals, diag, b, schedule rows (L, W) int32, n) of a factor;
    "sentinel": a random factor with n = 1003 (rows_p = 1008), its padded
    rows holding columns past n, and level lists that also carry ids past
    n (dropped)."""
    if case != "sentinel":
        ell, rows, _, b, _, n = _solve_inputs(case, dtype, device)
        cols, vals = ell.cols, ell.vals
    else:
        a = sp.random(1003, 1003, density=0.004, random_state=5, format="csr")
        low = sp.tril(a, -1).tocsr()
        m = csr_from_scipy(low + sp.diags(np.asarray(abs(low).sum(1)).ravel() + 1))
        n = 1003
        ell = ell_from_csr(m, row_pad=8, width_pad=8, dtype=np.float64,
                           device=device)
        cols, vals = ell.cols.clone(), ell.vals.to(dtype)
        cols[n:] = cols.shape[0] - 1        # past n: read through the clamp
        r = build_schedule(m).rows
        rows = torch.from_numpy(np.concatenate(
            [r, np.full((r.shape[0], 8), n + 3, np.int32)], 1)).to(device)
        g = torch.Generator(device=device).manual_seed(n)
        b = torch.zeros(cols.shape[0], dtype=dtype, device=device)
        b[:n] = torch.randn(n, generator=g, device=device, dtype=dtype)
    diag = torch.sum(torch.where(cols == torch.arange(
        cols.shape[0], device=device)[:, None], vals, 0.0), dim=1)
    diag = torch.where(diag == 0, 1.0, diag)
    return cols, vals, diag, b, torch.as_tensor(rows, device=device), n


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", ["rand1000", "chain", "diag", "ic0_L",
                                  "sentinel"])
def test_sptrsv_level_step_kernel_matches_plain(cuda, case, dtype):
    """Level by level from the same x: the kernel within the tolerance of
    the plain version, x untouched, the in-place form (out=x) bitwise the
    functional one; the solved x within the tolerance of
    sptrsv_solve_dot's (which multiplies by the inverse diagonal)."""
    cols, vals, diag, b, rows, n = _level_inputs(case, dtype, cuda)
    x = torch.zeros(n + 1, dtype=dtype, device=cuda)
    inplace = x.clone()
    for lv in rows:
        keep = x.clone()
        got = sptrsv.sptrsv_level_step(cols, vals, diag, b, x, lv)
        assert torch.equal(x, keep)
        _close((got,), (sptrsv.sptrsv_level_step_plain(cols, vals, diag, b,
                                                       x, lv),), dtype)
        sptrsv.sptrsv_level_step(cols, vals, diag, b, inplace, lv, out=inplace)
        assert torch.equal(inplace, got)
        x = got
    pack = ops.sptrsv_solve_pack(cols, rows, n)
    xs, _ = sptrsv.sptrsv_solve_dot(cols, vals, 1.0 / diag, b, pack)
    _close((x[:n],), (xs[:n],), dtype)


def _level_chain(cols, vals, diag, b, rows, n, variant=None):
    """x solved in place level by level with ``variant``."""
    x = torch.zeros(n + 1, dtype=vals.dtype, device=vals.device)
    for lv in rows:
        sptrsv.sptrsv_level_step(cols, vals, diag, b, x, lv, out=x,
                                 variant=variant)
    return x


def _level_count():
    return ops.launch_counts()["sptrsv_level_step"]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", ["rand1000", "chain", "diag", "ic0_L",
                                  "sentinel"])
def test_level_step_new_design_equals_first(cuda, case, dtype):
    """The variant the rule picks gives the first design's bits level by
    level from the same x and over the in-place solve; each call is one
    launch.  The rule picks the new design ("vec") at W = 8 and 16;
    rand1000's W = 24 is not compiled, so there it picks "first" and a
    forced new variant raises."""
    cols, vals, diag, b, rows, n = _level_inputs(case, dtype, cuda)
    rule = sptrsv.level_step_variant(cols.shape[1], dtype)
    assert rule == ("first" if case == "rand1000" else "vec")
    if rule == "first":
        with pytest.raises(ValueError, match="variant 'wave'"):
            sptrsv.sptrsv_level_step(cols, vals, diag, b, b[:n + 1], rows[0],
                                     variant="wave")
    x = torch.zeros(n + 1, dtype=dtype, device=cuda)
    before = _level_count()
    for lv in rows:
        got = sptrsv.sptrsv_level_step(cols, vals, diag, b, x, lv)
        assert torch.equal(got, sptrsv.sptrsv_level_step(
            cols, vals, diag, b, x, lv, variant="first"))
        x = got
    assert _level_count() == before + 2 * len(rows)
    assert torch.equal(_level_chain(cols, vals, diag, b, rows, n),
                       _level_chain(cols, vals, diag, b, rows, n, "first"))


def _width_factor(width, dtype, device, misaligned=False):
    """A random lower factor whose rows hold exactly min(r + 1, width)
    entries (diagonal last), as padded ELL of width ``width``; with
    ``misaligned``, vals is a view 8 bytes into its storage."""
    n = 1500
    rng = np.random.default_rng(width)
    r_, c_ = [], []
    for r in range(n):
        k = min(r, width - 1)
        r_ += [r] * (k + 1)
        c_ += list(rng.choice(r, size=k, replace=False)) + [r]
    m = sp.csr_matrix((rng.uniform(0.1, 1.0, len(r_)), (r_, c_)), shape=(n, n))
    m = (m + sp.diags(np.asarray(abs(m).sum(1)).ravel())).tocsr()
    ell = ell_from_csr(csr_from_scipy(m), row_pad=8, width_pad=1,
                       dtype=np.float64, device=device)
    cols, vals = ell.cols, ell.vals.to(dtype)
    assert cols.shape[1] == width
    if misaligned:
        store = torch.empty(vals.numel() + 2, dtype=dtype, device=device)
        off = 1 if dtype == torch.float64 else 2
        vals = store[off: off + vals.numel()].view(vals.shape).copy_(vals)
    diag = torch.where(cols == torch.arange(cols.shape[0], device=device)[:, None],
                       vals, 0.0).sum(1)
    diag = torch.where(diag == 0, 1.0, diag)
    b = torch.zeros(cols.shape[0], dtype=dtype, device=device)
    b[:n] = torch.from_numpy(rng.standard_normal(n)).to(device, dtype)
    rows = torch.from_numpy(build_schedule(m).rows).to(device)
    return cols, vals, diag, b, rows, n


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("width", [1, 2, 3, 4, 5, 6, 7, 8, 16])
def test_level_step_compiled_widths_equal_first(cuda, width, dtype):
    """At every compiled width each new variant the operands admit ("vec"
    needs W % 4 == 0 and 16-byte aligned cols and vals) solves to the
    first design's bits, a level's launch counted once; misaligned vals
    take "wave", and a forced "vec" on them raises."""
    for misaligned in (False, True):
        cols, vals, diag, b, rows, n = _width_factor(width, dtype, cuda,
                                                     misaligned)
        aligned = (cols.data_ptr() | vals.data_ptr()) % 16 == 0
        assert aligned != misaligned
        rule = sptrsv.level_step_variant(width, dtype, aligned)
        assert rule == ("vec" if aligned and width % 4 == 0 else "wave")
        want = _level_chain(cols, vals, diag, b, rows, n, "first")
        for variant in (None, "wave") + (("vec",) if rule == "vec" else ()):
            before = _level_count()
            assert torch.equal(_level_chain(cols, vals, diag, b, rows, n,
                                            variant), want)
            assert _level_count() == before + len(rows)
        if rule != "vec":
            with pytest.raises(ValueError, match="variant 'vec'"):
                sptrsv.sptrsv_level_step(cols, vals, diag, b, want, rows[0],
                                         variant="vec")


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_level_step_first_at_an_uncompiled_width(cuda, dtype):
    """W = 12 is not compiled: the rule and a forced "first" launch the
    first design (within the tolerance of the plain version), a forced
    new variant raises, nothing is launched for it."""
    cols, vals, diag, b, rows, n = _width_factor(12, dtype, cuda)
    assert sptrsv.level_step_variant(12, dtype) == "first"
    x = torch.zeros(n + 1, dtype=dtype, device=cuda)
    for lv in rows[:40]:
        got = sptrsv.sptrsv_level_step(cols, vals, diag, b, x, lv)
        assert torch.equal(got, sptrsv.sptrsv_level_step(
            cols, vals, diag, b, x, lv, variant="first"))
        _close((got,), (sptrsv.sptrsv_level_step_plain(cols, vals, diag, b,
                                                       x, lv),), dtype)
        x = got
    before = _level_count()
    for variant in ("vec", "wave"):
        with pytest.raises(ValueError, match=f"variant '{variant}'"):
            sptrsv.sptrsv_level_step(cols, vals, diag, b, x, rows[0],
                                     variant=variant)
    assert _level_count() == before


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_level_step_waits_for_the_op_before_it(cuda, dtype):
    """The in-place solve of lap2d_64's IC(0) L with ``b`` rewritten on
    the stream before each level (a copy on odd levels, a multiply by 1 on
    even ones, NaN over it after each): eager, and as one CUDA graph
    replayed on an x of 7s, bitwise the solve without the rewrites (a read
    of b before the rewrite had landed would see NaN), with one launch a
    level counted on every replay."""
    cols, vals, diag, b, rows, n = _level_inputs("ic0_L", dtype, cuda)
    want = _level_chain(cols, vals, diag, b, rows, n)
    bw, nan = b.clone(), torch.full_like(b, float("nan"))
    x = torch.zeros(n + 1, dtype=dtype, device=cuda)

    def chain():
        x.zero_()
        for i, lv in enumerate(rows):
            if i % 2:
                bw.copy_(b)
            else:
                torch.mul(b, 1.0, out=bw)
            sptrsv.sptrsv_level_step(cols, vals, diag, bw, x, lv, out=x)
            bw.copy_(nan)

    chain()
    assert torch.equal(x, want)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chain()
    for _ in range(2):
        x.fill_(7.0)
        before = _level_count()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(x, want)
        assert _level_count() == before + len(rows)


def test_off_path_wrappers_check_operands(cuda):
    cols, vals, vec = _operator(64, 8, 8, torch.float64, 6, cuda)
    x = vec()
    with pytest.raises(ValueError, match="square padded"):
        spmv_dot.ell_spmv_dot(cols, vals, x[:63])
    with pytest.raises(ValueError, match="square padded"):
        ops.ell_spmm_dot(cols, vals, torch.stack([x, x], 1)[:63])
    with pytest.raises(ValueError, match=r"shape \(n, k\)"):
        spmv_dot.ell_spmm_dot(cols, vals, x)
    with pytest.raises(ValueError, match="strides"):
        spmv_dot.ell_spmm_dot(cols, vals, torch.stack([x] * 4, 1)[:, ::2])
    with pytest.raises(ValueError, match="axpy_dot"):
        vecops.axpy_dot(0.5, x, x[:63])
    with pytest.raises(TypeError, match="level_rows"):
        sptrsv.sptrsv_level_step(cols, vals, x, x, torch.zeros(65, dtype=x.dtype,
                                 device=cuda), torch.zeros(8, device=cuda,
                                                           dtype=torch.int64))


@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("precond", ["jacobi", "block_ic0"])
def test_pipelined_plan_on_the_card(cuda, precond, batch):
    """pcg_pipelined_tol on the card: the JAX package's counts within one a
    lane (those of pcg_tol), the matvec kernel loop steps + 2 times (two
    matvecs at start-up), block_ic0's two triangular solves per lane per
    psolve (loop steps + 2 of them)."""
    want = {("jacobi", None): [94], ("jacobi", 4): [102, 98, 102, 102],
            ("block_ic0", None): [32], ("block_ic0", 4): [35, 35, 35, 34]}
    m = suite("small")["lap2d_32"]
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    rng = np.random.default_rng(0)
    b = (rng.standard_normal((4, m.shape[0])) if batch
         else a @ rng.standard_normal(m.shape[0]))
    eng = AzulEngine(m, precond=precond, dtype=np.float64)
    plan = eng.plan(SolveSpec(method="pcg_pipelined_tol", tol=1e-8,
                              max_iters=400, batch=batch))
    ops.reset_launch_counts()
    x, _ = plan(b)
    counts = ops.launch_counts()
    iters = np.atleast_1d(plan.last_iters)
    steps, lanes = int(iters.max()), len(iters)
    assert np.all(np.abs(iters - want[(precond, batch)]) <= 1)
    assert np.all(np.atleast_1d(plan.last_status_names) == "converged")
    assert counts["ell_spmm" if batch else "ell_spmv"] == steps + 2
    assert counts["sptrsv_solve_dot"] == (2 * lanes * (steps + 2)
                                          if precond == "block_ic0" else 0)
    xs, bs = np.atleast_2d(x), np.atleast_2d(b)
    res = np.linalg.norm(bs - (a @ xs.T).T, axis=1) / np.linalg.norm(bs, axis=1)
    assert np.all(res <= 1e-7)


# -- the redesigned kernels' variants --------------------------------------

# SHAPES, one more row wider than a warp's group, and a W = 8 operator of
# 2^16 rows (many blocks of the rows variant)
SPMV_VARIANT_SHAPES = SHAPES + [(1000, 40, 36), (1 << 16, 8, 5)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows,width,k", SPMV_VARIANT_SHAPES)
def test_ell_spmv_variants_equal_spmm_lane0(cuda, rows, width, k, dtype):
    """Every ell_spmv variant the width admits gives y bitwise equal to
    lane 0 of ell_spmm (the group kernels' lane order), and the wrapper's
    own choice is one of them.  Values off a 16-byte boundary (a view one
    element in) go to the group kernel by default, and forcing the rows
    kernel on them raises."""
    cols, vals, vec = _operator(rows, width, k, dtype, rows + 2 * width, cuda)
    x = vec()
    lane0 = ell_spmv.ell_spmm(cols, vals, x[None].contiguous())[0]
    runs = {"default": ell_spmv.ell_spmv(cols, vals, x),
            "group": ell_spmv.ell_spmv(cols, vals, x, variant="group")}
    if ell_spmv.spmv_variant(width) == "rows":
        runs["rows"] = ell_spmv.ell_spmv(cols, vals, x, variant="rows")
        off = torch.empty(rows * width + 1, dtype=dtype, device=cuda)
        moved = off[1:].view(rows, width)
        moved.copy_(vals)
        runs["misaligned, default"] = ell_spmv.ell_spmv(cols, moved, x)
        with pytest.raises(ValueError, match="aligned"):
            ell_spmv.ell_spmv(cols, moved, x, variant="rows")
    else:
        with pytest.raises(ValueError, match="multiple of 4"):
            ell_spmv.ell_spmv(cols, vals, x, variant="rows")
    torch.cuda.synchronize()
    for name, y in runs.items():
        assert torch.equal(y, lane0), name
    _close((runs["default"],), (ell_spmv.ell_spmv_plain(cols, vals, x),), dtype)


@pytest.mark.parametrize("variant", ["cluster", "cooperative"])
@pytest.mark.parametrize("with_dot", [True, False])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", SOLVE_CASES)
def test_sptrsv_variants_match_plain(cuda, case, dtype, with_dot, variant):
    """Each sptrsv_solve_dot variant, forced through the wrapper: within
    the tolerance of the plain version, padded rows 0, a second launch
    bitwise equal, pp 0 without the dot.  Where the shape does not admit the cluster
    variant (rand1000's rows are 24 slots wide) forcing it raises."""
    ell, rows, dinv, b, w, n = _solve_inputs(case, dtype, cuda)
    wd = w if with_dot else None
    pack = ops.sptrsv_solve_pack(ell.cols, rows, n)
    before = ops.launch_counts()["sptrsv_solve_dot"]
    if variant == "cluster" and sptrsv.solve_variant(
            pack.n_levels, pack.max_width, ell.cols.shape[1]) != "cluster":
        # rows wider than 16 slots: the cluster variant refuses them
        with pytest.raises(ValueError, match="cluster variant"):
            sptrsv.sptrsv_solve_dot(ell.cols, ell.vals, dinv, b, pack, wd,
                                    variant=variant)
        assert ops.launch_counts()["sptrsv_solve_dot"] == before
        return
    x, pp = sptrsv.sptrsv_solve_dot(ell.cols, ell.vals, dinv, b, pack, wd,
                                    variant=variant)
    x2, pp2 = sptrsv.sptrsv_solve_dot(ell.cols, ell.vals, dinv, b, pack, wd,
                                      variant=variant)
    torch.cuda.synchronize()
    assert ops.launch_counts()["sptrsv_solve_dot"] == before + 2
    assert torch.equal(x, x2) and torch.equal(pp, pp2)
    assert bool((x[n:] == 0).all())
    want = sptrsv.sptrsv_solve_dot_plain(ell.cols, ell.vals, dinv, b, rows,
                                         torch.zeros_like(w) if wd is None
                                         else w, n)
    _close((x, pp.reshape(1)), (want[0], want[1].reshape(1)), dtype)
    if wd is None:
        assert float(pp) == 0.0


@pytest.mark.parametrize("case", ["ic0_L", "chain"])
def test_sptrsv_cluster_needs_its_own_pack(cuda, case):
    """The cluster variant reads the pack's dependency codes in place of
    cols: with another cols tensor (an equal copy here) the wrapper runs
    the cooperative kernel by default and refuses a forced cluster launch;
    misaligned values take the cooperative kernel too.  Each answer is the
    plain version's within the tolerance."""
    ell, rows, dinv, b, w, n = _solve_inputs(case, torch.float64, cuda)
    pack = ops.sptrsv_solve_pack(ell.cols, rows, n)
    assert sptrsv.solve_variant(pack.n_levels, pack.max_width,
                                ell.cols.shape[1]) == "cluster"
    want = sptrsv.sptrsv_solve_dot_plain(ell.cols, ell.vals, dinv, b, rows, w, n)
    other = ell.cols.clone()
    off = torch.empty(ell.vals.numel() + 1, dtype=ell.vals.dtype, device=cuda)
    moved = off[1:].view(ell.vals.shape)
    moved.copy_(ell.vals)
    before = ops.launch_counts()["sptrsv_solve_dot"]
    with pytest.raises(ValueError, match="pack built from this cols"):
        sptrsv.sptrsv_solve_dot(other, ell.vals, dinv, b, pack, w,
                                variant="cluster")
    with pytest.raises(ValueError, match="aligned"):
        sptrsv.sptrsv_solve_dot(ell.cols, moved, dinv, b, pack, w,
                                variant="cluster")
    assert ops.launch_counts()["sptrsv_solve_dot"] == before
    for c, v in ((other, ell.vals), (ell.cols, moved), (ell.cols, ell.vals)):
        x, pp = sptrsv.sptrsv_solve_dot(c, v, dinv, b, pack, w)
        torch.cuda.synchronize()
        _close((x, pp.reshape(1)), (want[0], want[1].reshape(1)),
               torch.float64)


def _spmv_dot_calls(cols, vals, vec, k, dtype, cuda):
    """The four spmv_dot wrappers on one operator, as functions of the
    variant: the p-fold pair (1-D and k lanes) and the dot twins (1-D and
    the JAX layout, row-major and as the transposed solver view)."""
    z, p = vec(), vec()
    zs, ps = _lanes(vec, k), _lanes(vec, k)
    beta = torch.tensor(0.37, dtype=dtype, device=cuda)
    betas = torch.linspace(0.0, 0.9, k, dtype=dtype, device=cuda)
    xj = zs.T.contiguous()
    return {
        "ell_spmv_pfold_dot": lambda c, v, var: spmv_dot.ell_spmv_pfold_dot(
            c, v, z, p, beta, variant=var),
        "ell_spmm_pfold_dot": lambda c, v, var: spmv_dot.ell_spmm_pfold_dot(
            c, v, zs, ps, betas, variant=var),
        "ell_spmv_dot": lambda c, v, var: spmv_dot.ell_spmv_dot(
            c, v, z, variant=var),
        "ell_spmm_dot": lambda c, v, var: spmv_dot.ell_spmm_dot(
            c, v, xj, variant=var),
        "ell_spmm_dot view": lambda c, v, var: spmv_dot.ell_spmm_dot(
            c, v, zs.T, variant=var),
    }


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows,width,k", SPMV_VARIANT_SHAPES + [(5000, 4, 4),
                                                                (1 << 16, 16, 9)])
def test_spmv_dot_variants_bitwise(cuda, rows, width, k, dtype):
    """Every spmv_dot wrapper gives the same bits in every output under
    each variant the width admits: the kept one, the first design
    (variant="group") and, where W is a multiple of 4 up to 16, "rows";
    values off a 16-byte boundary take the group kernel by default and a
    forced "rows" on them, or on a width it does not take, raises."""
    cols, vals, vec = _operator(rows, width, k, dtype, rows + 3 * width, cuda)
    rows_ok = ell_spmv.spmv_variant(width) == "rows"
    off = torch.empty(rows * width + 1, dtype=dtype, device=cuda)
    moved = off[1:].view(rows, width)
    moved.copy_(vals)
    for name, call in _spmv_dot_calls(cols, vals, vec, 5, dtype, cuda).items():
        first = call(cols, vals, "group")
        runs = {"default": call(cols, vals, None),
                "second launch": call(cols, vals, None),
                "misaligned, default": call(cols, moved, None)}
        if rows_ok:
            runs["rows"] = call(cols, vals, "rows")
            with pytest.raises(ValueError, match="aligned"):
                call(cols, moved, "rows")
        else:
            with pytest.raises(ValueError, match="multiple of 4"):
                call(cols, vals, "rows")
        for label, got in runs.items():
            for i, (g, f) in enumerate(zip(got, first)):
                assert torch.equal(g, f), (name, label, i)


@pytest.mark.parametrize("variant", bcsr_spmm.BCSR_VARIANTS)
def test_bcsr_kernel_refuses_a_grid_that_misses_rows(cuda, variant):
    """The kernel launches on the grid and lane chunk the wrapper computes
    (bcsr_spmm.launch_grid, lane_chunk): that grid runs, and one block or
    one lane chunk short of it, or a chunk wider than the variant carries,
    is refused with cudaErrorInvalidValue, writes nothing and counts no
    launch."""
    from repro_torch.kernels import build

    bm = bn = 8
    r = 9
    bc, bl, nbc = _bcsr(1003, 0.01, bm, bn, torch.float64, 7, cuda)
    nbr, w = bc.shape
    x = torch.ones(r, nbc * bn, dtype=torch.float64, device=cuda).T
    fn = build.entry("repro_bcsr_spmm", torch.float64)
    code = {"first": 0, "smem": 1}[variant]
    chunk = bcsr_spmm.lane_chunk(r, variant)
    gx, gy = bcsr_spmm.launch_grid(variant, nbr, bm, r)

    def launch(c, x_blocks, y_chunks):
        y = torch.full((r, nbr * bm), 7.0, dtype=torch.float64,
                       device=cuda).T
        err = fn(bc.data_ptr(), bl.data_ptr(), x.data_ptr(), y.data_ptr(),
                 nbr, w, bm, bn, r, x.shape[0], x.stride(0), x.stride(1),
                 y.stride(0), y.stride(1), code, c, x_blocks, y_chunks,
                 build.launch_counter("bcsr_spmm", x.device),
                 build.stream_handle(x.device))
        torch.cuda.synchronize()
        return err, y

    err, y = launch(chunk, gx, gy)
    assert err == 0
    assert torch.equal(y, bcsr_spmm.bcsr_spmm(bc, bl, x, variant=variant))
    wide = 16 if variant == "first" else 32
    before = ops.launch_counts()["bcsr_spmm"]
    for c, bx, by in ((chunk, gx - 1, gy), (chunk, gx, gy - 1),
                      (wide, gx, 1), (chunk // 2 + 1, gx, gy + 1)):
        err, y = launch(c, bx, by)
        assert err == 1, (c, bx, by)
        assert torch.all(y == 7.0)
    assert ops.launch_counts()["bcsr_spmm"] == before


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows,width,nnz", [(4099, 8, 7), (1000, 16, 13),
                                            (1001, 4, 4), (777, 33, 20)])
def test_spmm_pfold_lanes_at_k16(cuda, rows, width, nnz, dtype):
    """k = 16 (two chunks of the group kernel, one lane loop of the rows
    kernel): lane j of every output equals the k = 1 call and the 1-D
    kernel on lane j bit for bit, and pap is within the tolerance of the
    plain version."""
    cols, vals, vec = _operator(rows, width, nnz, dtype, rows + 16, cuda)
    k = 16
    z, p = _lanes(vec, k), _lanes(vec, k)
    beta = torch.linspace(0.0, 0.9, k, dtype=dtype, device=cuda)
    wide = spmv_dot.ell_spmm_pfold_dot(cols, vals, z, p, beta)
    _close(wide, spmv_dot.ell_spmm_pfold_dot_plain(cols, vals, z, p, beta), dtype)
    for j in range(k):
        s = slice(j, j + 1)
        one = spmv_dot.ell_spmm_pfold_dot(cols, vals, z[s], p[s], beta[s])
        flat = spmv_dot.ell_spmv_pfold_dot(cols, vals, z[j], p[j], beta[j])
        for i in range(3):
            assert torch.equal(wide[i][s], one[i]), (j, i)
            assert torch.equal(wide[i][j].reshape(-1), flat[i].reshape(-1)), (j, i)


# -- the redesigned batched gathers: bcsr_spmm and ell_spmm -----------------

# the JAX kernel tests' (bm, bn, R) sweep, the engine's 8 x 8 blocks at
# R = 1, 8 and 16, the other compiled widths, a batch of two chunks, and
# block heights the smem variant does not take
BCSR_VARIANT_SHAPES = [(8, 16, 4), (8, 128, 8), (16, 32, 16), (8, 8, 1),
                       (8, 8, 8), (8, 8, 16), (4, 4, 3), (16, 16, 16),
                       (4, 16, 5), (8, 4, 17), (2, 8, 5), (3, 16, 2)]


def _x_layouts(r, rows, dtype, g, cuda):
    """x in the solver layout (lanes-major, aligned), the JAX layout
    (row-major) and lanes-major one element off a 16-byte boundary."""
    lanes = torch.randn(r, rows, generator=g, device=cuda, dtype=dtype).T
    buf = torch.randn(r * rows + 1, generator=g, device=cuda, dtype=dtype)
    return {"lanes-major": lanes, "row-major": lanes.contiguous(),
            "misaligned": buf[1:].view(r, rows).T}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("bm,bn,r", BCSR_VARIANT_SHAPES)
def test_bcsr_spmm_variants_bitwise(cuda, bm, bn, r, dtype):
    """Every variant the operands admit gives Y bitwise the first design's,
    in every x layout and with an x_valid that cuts a block column; a
    second launch repeats it, lane j equals the one-lane call on lane j,
    the default is one of them, and a forced smem the operands do not
    admit raises (misaligned or row-major x takes the first design's
    scalar loads)."""
    bc, bl, nbc = _bcsr(1003, 0.01, bm, bn, dtype, bm * bn + r, cuda)
    g = torch.Generator(device=cuda).manual_seed(bm + bn + r)
    rows = nbc * bn
    smem_fits = bcsr_spmm.smem_layout(bm, bn, 16, bl.element_size())[
        "bytes"] <= 232448                     # two buffers of 16 lanes
    for layout, x in _x_layouts(r, rows, dtype, g, cuda).items():
        x_vec = bcsr_spmm.x_vectorized(x)
        assert x_vec == (layout == "lanes-major" or (layout == "row-major"
                                                     and r == 1))
        for valid in (None, rows - bn - bn // 2 - 1):
            call = lambda v, x=x, valid=valid: bcsr_spmm.bcsr_spmm(
                bc, bl, x, nbc=nbc, x_valid=valid, variant=v)
            first = call("first")
            xv = x if valid is None else torch.where(
                torch.arange(rows, device=cuda)[:, None] < valid, x, 0)
            _close((first,), (bcsr_spmm.bcsr_spmm_plain(bc, bl, xv),), dtype)
            assert torch.equal(call(None), first)
            for v in bcsr_spmm.BCSR_VARIANTS:
                admitted = v == "first" or (
                    bn in bcsr_spmm.COMPILED_BN and bm in bcsr_spmm.SMEM_BM
                    and x_vec and smem_fits)
                if not admitted:
                    with pytest.raises(ValueError, match=f"the {v} variant"):
                        call(v)
                    continue
                got = call(v)
                assert torch.equal(got, first), (layout, valid, v)
                assert torch.equal(call(v), got), (layout, valid, v)
                for j in range(r):
                    one = bcsr_spmm.bcsr_spmm(bc, bl, x[:, j: j + 1], nbc=nbc,
                                              x_valid=valid, variant=v)
                    assert torch.equal(got[:, j: j + 1], one), (layout, v, j)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rows,width,nnz", [(4099, 8, 7), (1000, 16, 13),
                                            (1001, 4, 4), (1000, 12, 11),
                                            (1 << 16, 8, 5), (1000, 5, 5),
                                            (777, 33, 20)])
def test_ell_spmm_variants_bitwise(cuda, rows, width, nnz, dtype):
    """ell_spmm's rows kernel gives Y bitwise the first design's (the row
    groups) at k = 1, 3, 8, 16 and 17 (one launch up to 16 on the rows
    kernel), lane j equals the k = 1 call and ell_spmv on lane j, a second
    launch repeats, X wider than the rows (ncols > rows_p) passes; values
    off a 16-byte boundary take the group kernel by default, and forcing
    the rows kernel on them, or on a width it does not take, raises."""
    cols, vals, vec = _operator(rows, width, nnz, dtype, rows + width, cuda)
    rows_ok = ell_spmv.spmv_variant(width) == "rows"
    off = torch.empty(rows * width + 1, dtype=dtype, device=cuda)
    moved = off[1:].view(rows, width)
    moved.copy_(vals)
    for k in (1, 3, 8, 16, 17):
        x = _lanes(vec, k)
        first = ell_spmv.ell_spmm(cols, vals, x, variant="group")
        _close((first,), (ell_spmv.ell_spmm_plain(cols, vals, x),), dtype)
        runs = {"default": ell_spmv.ell_spmm(cols, vals, x),
                "second launch": ell_spmv.ell_spmm(cols, vals, x),
                "misaligned, default": ell_spmv.ell_spmm(cols, moved, x)}
        if rows_ok:
            runs["rows"] = ell_spmv.ell_spmm(cols, vals, x, variant="rows")
            with pytest.raises(ValueError, match="aligned"):
                ell_spmv.ell_spmm(cols, moved, x, variant="rows")
        else:
            with pytest.raises(ValueError, match="multiple of 4"):
                ell_spmv.ell_spmm(cols, vals, x, variant="rows")
        for label, got in runs.items():
            assert torch.equal(got, first), (k, label)
        got = runs["default"]
        for j in range(k):
            assert torch.equal(got[j: j + 1],
                               ell_spmv.ell_spmm(cols, vals, x[j: j + 1]))
            assert torch.equal(got[j], ell_spmv.ell_spmv(cols, vals, x[j]))
    wide = torch.cat([_lanes(vec, 3), _lanes(vec, 3)[:, :5]], 1)
    assert torch.equal(ell_spmv.ell_spmm(cols, vals, wide),
                       ell_spmv.ell_spmm(cols, vals, wide, variant="group"))
    torch.cuda.synchronize()


# -- compiled plans: the captured loop ----------------------------------------


@pytest.mark.parametrize("method,precond,fmt,batch", [
    ("pcg_tol", "jacobi", "ell", None), ("pcg_tol", "jacobi", "ell", 4),
    ("pcg_tol", "block_ic0", "ell", None), ("pcg_tol", "jacobi", "bcsr", 4),
    ("pcg_pipelined_tol", "jacobi", "ell", 4), ("pcg", "jacobi", "hyb", None),
    ("jacobi", "jacobi", "ell", None)])
def test_replayed_plan_equals_a_direct_call(cuda, method, precond, fmt, batch):
    """A plan on the card captures its loop once and replays it: 20 calls
    make one build (one capture, its time unchanged after the first call,
    one replay a call), and the result equals the same solver function
    called directly (its rounds run eagerly) bit for bit -- x, the trace,
    iters, status and bad_iter -- with the kernels' own launch counts the
    same every call and those of the step count."""
    from repro_torch.core import registry
    from repro_torch.core.solvers import ensure_status

    m = suite("small")["lap2d_32"]
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    rng = np.random.default_rng(0)
    b = (rng.standard_normal((batch, m.shape[0])) if batch
         else a @ rng.standard_normal(m.shape[0]))
    eng = AzulEngine(m, precond=precond, dtype=np.float64, format=fmt)
    plan = eng.plan(SolveSpec(method=method, tol=1e-8, max_iters=400,
                              iters=150, batch=batch))
    counts, captured = [], []
    for _ in range(20):
        ops.reset_launch_counts()
        x, norms = plan(b)
        counts.append(ops.launch_counts())
        captured.append((plan.cell.captures, plan.cell.capture_s))
    assert plan.traces == 1 and plan.executions == 20
    plan.assert_steady()
    assert captured == [(1, captured[0][1])] * 20
    assert captured[0][1] is not None and plan.cell.replays == 20
    assert all(c == counts[0] for c in counts)
    bd = eng.to_device_vec(b)
    res = ensure_status(registry.get_solver(method).run(
        plan.context, bd, torch.zeros_like(bd)), bd)
    assert eng.from_device_vec(res.x).tobytes() == x.tobytes()
    assert res.res_norms.tobytes() == norms.tobytes()
    for got, want in ((res.iters, plan.last_iters),
                      (res.status, plan.last_status),
                      (res.bad_iter, plan.last_bad_iter)):
        np.testing.assert_array_equal(got, want)
    steps = int(np.max(plan.last_iters))
    if method == "pcg_tol" and fmt == "ell":
        fold = "ell_spmm_pfold_dot" if batch else "ell_spmv_pfold_dot"
        assert counts[0][fold] == steps


# -- the solve service on the card ---------------------------------------------


def _service_pair(name="lap2d_32", chunk=8, **kw):
    from repro_torch.serve import SolveService

    out = []
    for _ in range(2):
        svc = SolveService(max_batch=8, chunk=chunk, **kw)
        svc.register_operator(name, suite("small")[name], method="pcg_tol",
                              tol=1e-8, iters=2000, dtype=np.float64)
        out.append(svc)
    return out


def _pool_plans(svc):
    return [p for op in svc._operators.values() for pool in op.pools.values()
            for p in pool.values()]


def test_service_join_bitwise_across_buckets(cuda):
    """A request that joins a running cohort while the bucket moves
    k_pad 1 -> 2 -> 4 -> 8 ends with its solo solve's bits, x and
    res_norms; every pool plan captured once; no chunk degraded."""
    m = suite("small")["lap2d_32"]
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    bs = a @ np.random.default_rng(8).standard_normal((8, m.shape[0])).T
    bs = np.ascontiguousarray(bs.T)
    solo, svc = _service_pair()
    solo.submit(bs[1])
    ref = solo.drain()[0]
    ids = [svc.submit(bs[0])]
    svc.tick()                                      # k_pad 1
    ids.append(svc.submit(bs[1]))
    svc.tick()                                      # 2
    ids += [svc.submit(b) for b in bs[2:4]]
    svc.tick()                                      # 4
    ids += [svc.submit(b) for b in bs[4:]]
    done = svc.drain()                              # 8
    assert sorted(svc._operators["lap2d_32"].pools["cb"]) == [1, 2, 4, 8]
    got = done[ids[1]]
    assert got.status == ref.status == "converged"
    assert got.iters == ref.iters
    assert np.array_equal(got.x, ref.x)
    assert np.array_equal(got.res_norms, ref.res_norms)
    assert all(o.status == "converged" for o in done.values())
    for s in (solo, svc):
        assert s.stats["degraded_batches"] == 0
        for plan in _pool_plans(s):
            assert plan.traces == 1 and plan.cell.captures == 1


def test_service_eviction_frees_the_plans_pools(cuda):
    """Evicting an operator frees its engine and its captured plans'
    memory pools: after the eviction and ``empty_cache`` the reserved
    memory falls by more than the operator's own bytes; a reload captures
    each plan once again and gives the same bits."""
    import gc

    from repro_torch.serve import SolveService

    big = laplacian_2d(256)
    svc = SolveService(max_batch=8, chunk=8)
    info = svc.register_operator("big", big, method="pcg_tol", tol=1e-8,
                                 iters=100, dtype=np.float64)
    b = np.random.default_rng(3).standard_normal((4, big.shape[0]))
    ids = [svc.submit(v) for v in b]
    first = svc.drain()
    assert {k for k in svc._operators["big"].pools["cb"]} == {4}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    svc._evict(svc._operators["big"])
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved()
    assert before - after > info.bytes
    ids2 = [svc.submit(v) for v in b]
    again = svc.drain()
    assert svc.stats["reloads"] == 1 and svc.stats["degraded_batches"] == 0
    for r1, r2 in zip(ids, ids2):
        assert np.array_equal(first[r1].x, again[r2].x)
    for plan in _pool_plans(svc):
        assert plan.traces == 1 and plan.cell.captures == 1


def test_service_raises_a_kernel_failure_on_the_card(cuda):
    """degraded_batches stays 0 on the kernels; a fused chunk that raises
    on the card raises to the caller, and no plain (reference) plan is
    built to answer it."""
    svc, boom_svc = _service_pair("banded_1k")
    m = suite("small")["banded_1k"]
    b = np.random.default_rng(4).standard_normal(m.shape[0])
    svc.submit(b)
    ref = svc.drain()[0]
    assert ref.status == "converged" and svc.stats["degraded_batches"] == 0

    class Boom:
        info, traces, calls = {"fused": True}, 1, 0

        def __call__(self, batch, x0=None):
            Boom.calls += 1
            raise RuntimeError("injected fused-kernel failure")

    op = boom_svc._operators["banded_1k"]
    op.pools["cb"][1] = Boom()
    boom_svc.submit(b)
    with pytest.raises(RuntimeError, match="injected"):
        boom_svc.drain()
    assert Boom.calls == 1 and boom_svc.stats["degraded_batches"] == 0
    assert not op.pools["cb_ref"] and not op.pools["ref"]


# -- fault injection on the card -----------------------------------------------


@pytest.mark.parametrize("precond,batch", [("jacobi", None), ("jacobi", 4),
                                           ("block_ic0", None)])
def test_injectable_plan_on_the_card(cuda, precond, batch):
    """An injectable plan's clean call equals the plain plan's bit for bit
    with the same kernel launches; a corrupted call breaks down before the
    loop; the next clean call is the clean result again; one build, one
    capture; the engine's values and engine.spmv stay clean."""
    from repro_torch.ft import FaultSpec, corrupt_vals

    m = suite("small")["lap2d_32"]
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    rng = np.random.default_rng(0)
    b = (rng.standard_normal((batch, m.shape[0])) if batch
         else a @ rng.standard_normal(m.shape[0]))
    eng = AzulEngine(m, precond=precond, dtype=np.float64)
    kw = dict(method="pcg_tol", tol=1e-8, max_iters=400, batch=batch)
    plain, plan = eng.plan(SolveSpec(**kw)), eng.plan(SolveSpec(injectable=True, **kw))
    assert plan.vals.data_ptr() % 16 == 0
    assert plan.vals.data_ptr() != eng.ell.vals.data_ptr()
    xs = rng.standard_normal(m.shape[0])
    y0, vals0 = eng.spmv(xs), eng.ell.vals.clone()
    x_ref, n_ref = plain(b)
    ops.reset_launch_counts()
    plain(b)
    want = ops.launch_counts()
    ops.reset_launch_counts()
    x, nrm = plan(b)
    assert ops.launch_counts() == want
    assert x.tobytes() == x_ref.tobytes() and nrm.tobytes() == n_ref.tobytes()
    bad = corrupt_vals(eng.vals_template(), FaultSpec(kind="nan", seed=1))
    plan(b, vals=bad)
    assert set(np.atleast_1d(plan.last_status_names)) == {"breakdown"}
    assert set(np.atleast_1d(plan.last_bad_iter).tolist()) == {0}
    x2, n2 = plan(b)
    assert x2.tobytes() == x_ref.tobytes() and n2.tobytes() == n_ref.tobytes()
    assert plan.traces == 1 and plan.cell.captures == 1
    assert torch.equal(eng.ell.vals, vals0)
    assert eng.spmv(xs).tobytes() == y0.tobytes()


def test_restart_manager_recovers_a_corrupted_chunk_on_the_card(cuda):
    """A transient NaN and a bit-flip at iteration 30 are each detected in
    their chunk, rolled back and rerun, and the solve converges; every
    chunk replays the one captured graph."""
    from repro_torch.ft import FaultInjector, FaultSpec, SolveRestartManager

    m = suite("small")["lap2d_32"]
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    x_true = np.random.default_rng(0).standard_normal(m.shape[0])
    b = a @ x_true
    eng = AzulEngine(m, dtype=np.float64)
    mgr = SolveRestartManager(eng, SolveSpec(method="pcg_tol", tol=1e-8,
                                             max_iters=2000), chunk=25)
    for kind in ("nan", "bitflip"):
        rep = mgr.solve(b, injector=FaultInjector(
            eng, FaultSpec(kind=kind, iteration=30, seed=1)))
        assert rep.restarts >= 1 and rep.faults[0]["global_iter"] == 25
        assert rep.status == "converged" and rep.rel_residual <= 1e-6
        assert np.allclose(rep.x, x_true, atol=1e-5)
    assert mgr._plan.traces == 1 and mgr._plan.cell.captures == 1


# -- the tile grid (every tile on the card) ----------------------------------


@pytest.mark.parametrize("shape,mode", [((2, 2), "2d"), ((4, 1), "1d")])
def test_stacked_tile_kernels_against_plain(cuda, shape, mode):
    """The grid's one-launch block apply: ``ell_spmv`` / ``ell_spmm`` over
    the stacked (tiles*rows_p, w) blocks with columns offset into the
    tile-stacked x buffer, and ``cg_update`` over the padded global
    vector, each against its plain version; lane 0 of ``ell_spmm`` equals
    ``ell_spmv`` bit for bit."""
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import make_mesh

    m = laplacian_2d(48)
    eng = AzulEngine(m, mesh=make_mesh(shape, ("data", "model")), mode=mode,
                     dtype=np.float64)
    g = torch.Generator(device=cuda).manual_seed(3)
    vals = eng._flat_vals(eng.vals)
    for lay in ("dense", "halo"):
        cols = eng._kernel_cols(lay)
        buf = eng.tiles * eng._buffer_len(lay)
        x = torch.randn(buf, dtype=torch.float64, device=cuda, generator=g)
        want = ref.ell_spmv_ref(cols, vals, x)
        got = ops.ell_spmv(cols, vals, x)
        assert (got - want).abs().max() <= 1e-12 * want.abs().max()
        xk = torch.randn(4, buf, dtype=torch.float64, device=cuda, generator=g)
        yk = ops.ell_spmm(cols, vals, xk)
        wk = ref.ell_spmm_ref(cols, vals, xk)
        assert (yk - wk).abs().max() <= 1e-12 * wk.abs().max()
        assert torch.equal(yk[0], ops.ell_spmv(cols, vals, xk[0].contiguous()))
    vs = [torch.randn(eng.n_pad, dtype=torch.float64, device=cuda,
                      generator=g) for _ in range(4)]
    alpha = torch.tensor(0.5, dtype=torch.float64, device=cuda)
    for got, want in zip(ops.cg_update(alpha, *vs, eng._dinv_pad),
                         ref.cg_update_ref(alpha, *vs, eng._dinv_pad)):
        assert (got - want).abs().max() <= 1e-12 * want.abs().max()


def test_grid_plan_launch_counts_and_capture(cuda):
    """A 2x2 grid plan captures once and launches, per solve, one
    ``ell_spmv`` a step plus the initial residual's and one ``cg_update``
    a step; its counts are the CPU's within one; halo == dense bitwise."""
    from repro_torch.launch.mesh import make_mesh

    m = laplacian_2d(64)
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    b = a @ np.random.default_rng(0).standard_normal(m.shape[0])
    kw = dict(method="pcg_tol", tol=1e-8, max_iters=1000)
    cpu = AzulEngine(m, mesh=make_mesh((2, 2), ("data", "model"),
                                       device="cpu"), dtype=np.float64)
    cpu_plan = cpu.plan(SolveSpec(**kw))
    cpu_plan(b)
    eng = AzulEngine(m, mesh=make_mesh((2, 2), ("data", "model")),
                     dtype=np.float64)
    xs = {}
    for lay in ("dense", "halo"):
        plan = eng.plan(SolveSpec(layout=lay, **kw))
        plan(b)
        ops.reset_launch_counts()
        xs[lay], _ = plan(b)
        got = ops.launch_counts()
        it = int(plan.last_iters)
        assert abs(it - int(cpu_plan.last_iters)) <= 1
        assert got["ell_spmv"] == it + 1 and got["cg_update"] == it
        assert got["ell_spmv_pfold_dot"] == 0
        assert plan.traces == 1 and plan.cell.captures == 1
    assert xs["dense"].tobytes() == xs["halo"].tobytes()


# -- LM serving: the model zoo on the card against its CPU run ---------------

LM_ARCHS = ["dbrx-132b", "deepseek-v3-671b", "granite-3-8b", "h2o-danube-1.8b",
            "mamba2-370m", "musicgen-large", "paligemma-3b", "qwen1.5-32b",
            "qwen2-72b", "recurrentgemma-9b"]


def _lm_greedy(params, cfg, toks, pfx, steps, device):
    t = torch.as_tensor(toks, device=device)
    f = None if pfx is None else torch.as_tensor(pfx, device=device)
    with torch.inference_mode():
        lg, caches, pos = M.prefill(params, cfg, tokens=t, prefix_embeds=f,
                                    max_len=t.shape[1] + (0 if f is None else
                                                          f.shape[1]) + steps)
        logits, picks = [lg.float().cpu()], [lg[:, -1].argmax(-1)[:, None]]
        for i in range(steps):
            lg, caches = M.decode_step(params, cfg, caches, picks[-1], pos + i)
            logits.append(lg.float().cpu())
            picks.append(lg[:, -1].argmax(-1)[:, None])
    return logits, torch.cat(picks, 1).cpu()


@pytest.mark.parametrize("name", LM_ARCHS)
def test_lm_smoke_matches_cpu(cuda, name):
    """An f32 smoke config on the card: prefill and eight greedy decode
    steps within 1e-4 x max|cpu| of the CPU run on the same weights, the
    tokens equal."""
    cfg = configs.get_smoke(name).replace(param_dtype="float32",
                                          compute_dtype="float32")
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = convert.lm_params_from_numpy(cfg, convert.lm_params_to_numpy(cpu),
                                        cuda)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (2, 24))
    pfx = (rng.standard_normal((2, cfg.n_prefix_tokens, cfg.d_model))
           .astype(np.float32) if cfg.prefix_lm else None)
    want, wt = _lm_greedy(cpu, cfg, toks, pfx, 8, "cpu")
    got, gt = _lm_greedy(card, cfg, toks, pfx, 8, cuda)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    assert torch.equal(gt, wt)


def test_serve_cli_arch_on_card(cuda, capsys):
    assert serve_cli.main(["--arch", "granite-3-8b", "--smoke", "--slots",
                           "--device", "cuda", "--batch", "3"]) == 0
    out = capsys.readouterr().out
    got = json.loads(out[out.index("{"):])
    assert got["slot_server_completed"] == 3 and got["arch"] == "granite-3-8b"


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_lm_train_step_matches_cpu(cuda, opt_name):
    cfg = configs.get_smoke("granite-3-8b").replace(param_dtype="float32",
                                                    compute_dtype="float32")
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = convert.lm_params_from_numpy(cfg, convert.lm_params_to_numpy(cpu),
                                        cuda)
    opt = getattr(T, opt_name)(T.warmup_cosine(3e-3, 1, 10))
    states = {"cpu": T.init_train_state(cpu, opt),
              "cuda": T.init_train_state(card, opt)}
    step = T.build_train_step(cfg, opt)
    pipe = TokenPipeline(cfg.vocab_size, 4, 32, seed=0)
    for i in range(2):
        m = {}
        for dev in states:
            states[dev], m[dev] = step(states[dev], pipe.batch_at(i))
        for k in ("loss", "grad_norm"):
            want = float(m["cpu"][k])
            assert abs(float(m["cuda"][k]) - want) <= 1e-4 * abs(want), k
    close = total = 0
    for a, b in zip(states["cuda"].params.parameters(),
                    states["cpu"].params.parameters()):
        assert a.device.type == "cuda"
        d, tol = (a.cpu() - b).abs(), 1e-4 * float(b.abs().max())
        if opt_name == "adafactor":
            assert float(d.max()) <= tol
        else:
            assert float(d.max()) <= 2 * 3e-3
        close += int((d <= tol).sum())
        total += d.numel()
    assert close / total >= 0.999
