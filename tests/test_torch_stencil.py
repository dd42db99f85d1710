"""The port's matrix-free stencil operators held against the JAX package.

``stencil_matvec`` against the JAX one and the assembled Laplacian
(float64, 1-D and (k, n), padded); stencil engines through the normal
entry points with the JAX package's iteration counts (``lap2d_32``,
``lap3d_10``, a k = 2 batch); the engine rules that keep a stencil out of
modes that need stored values; ``spmv``, ``device_bytes`` and the CLI's
``--matrix stencil:...``.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core import stencil as jstencil
from repro.core.engine import AzulEngine as JaxEngine
from repro.core.plan import SolveSpec as JaxSpec
from repro.kernels import autotune as jautotune
from repro_torch import convert
from repro_torch.core import stencil
from repro_torch.core.engine import AzulEngine
from repro_torch.core.plan import SolveSpec
from repro_torch.data.matrices import laplacian_2d, laplacian_3d
from repro_torch.kernels import autotune
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True)
def caches(tmp_path, monkeypatch):
    """Both packages' format caches (read by stored-matrix engines) in
    tmp_path, memos cleared."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "port.json"))
    jautotune.clear_memo()
    autotune.clear_memo()
    yield tmp_path
    jautotune.clear_memo()
    autotune.clear_memo()


def _as_scipy(m):
    return sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)


@pytest.mark.parametrize("dims", [(5, 7), (8, 8), (16, 4), (1, 9), (3, 3, 3),
                                  (4, 4, 4)])
@pytest.mark.parametrize("k", [None, 3])
def test_stencil_matvec_matches_jax_and_assembled(dims, k):
    if len(dims) == 2:
        st, jst = stencil.lap2d_stencil(*dims), jstencil.lap2d_stencil(*dims)
        a = _as_scipy(laplacian_2d(*dims))
    else:
        st, jst = stencil.lap3d_stencil(dims[0]), jstencil.lap3d_stencil(dims[0])
        a = _as_scipy(laplacian_3d(dims[0]))
    assert st == tuple(jst) and st.n == a.shape[0] == jst.n
    assert st.nnz_equiv == jst.nnz_equiv == a.count_nonzero()
    assert stencil.stencil_diag(st) == jstencil.stencil_diag(jst)
    n = st.n
    n_pad = -(-n // 8) * 8 + 8                       # past the true rows
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n_pad,) if k is None else (k, n_pad))
    got = stencil.stencil_matvec(st, torch.from_numpy(x), n_pad).numpy()
    want = np.asarray(jstencil.stencil_matvec(jst, jnp.asarray(x), n_pad))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[..., :n], (a @ x[..., :n].reshape(-1, n).T)
                               .T.reshape(x[..., :n].shape), **TOL)
    assert not got[..., n:].any()
    if k is not None:                                # lanes alone, bitwise
        for j in range(k):
            one = stencil.stencil_matvec(st, torch.from_numpy(x[j]), n_pad)
            assert torch.equal(torch.from_numpy(got[j]), one)


@pytest.mark.parametrize("kind,size,want", [("lap2d", 32, 94),
                                               ("lap3d", 10, None)])
def test_stencil_solve_matches_jax(kind, size, want):
    """A stencil engine through the entry points: the JAX package's count,
    status and trace, x allclose; the stored Laplacian's count beside it."""
    st = getattr(stencil, f"{kind}_stencil")(size)
    jst = getattr(jstencil, f"{kind}_stencil")(size)
    pe = AzulEngine(st, dtype=np.float64, device="cpu")
    je = JaxEngine(jst, mesh=None, precond="jacobi", dtype=np.float64)
    assert pe.format_choice == je.format_choice == "stencil"
    assert pe.ell is None and (pe.n, pe.n_pad) == (je.n, je.n_pad)
    x_true = np.random.default_rng(0).standard_normal(st.n)
    b = pe.spmv(x_true)
    np.testing.assert_allclose(b, np.asarray(je.spmv(x_true)), **TOL)
    spec = dict(method="pcg_tol", tol=1e-8, max_iters=400)
    p = pe.plan(SolveSpec(**spec))
    jp = je.plan(JaxSpec(**spec))
    x, norms = p(b)
    jx, jnorms = jp(b)
    assert p.info["format"] == jp.info["format"] == "stencil"
    assert p.info["substrate"] == "fused"
    assert int(p.last_iters) == int(jp.last_iters)
    assert p.last_status_names == jp.last_status_names == "converged"
    if want is not None:
        assert int(p.last_iters) == want
    np.testing.assert_allclose(norms, np.asarray(jnorms), rtol=0,
                               atol=1e-9 * np.linalg.norm(b))
    np.testing.assert_allclose(x, np.asarray(jx), rtol=1e-9, atol=1e-12)
    # the stored twin: same operator, counts may differ only by sum order
    m = laplacian_2d(size) if kind == "lap2d" else laplacian_3d(size)
    ps = AzulEngine(m, dtype=np.float64, device="cpu").plan(SolveSpec(**spec))
    ps(b)
    assert abs(int(ps.last_iters) - int(p.last_iters)) <= 1


def test_stencil_batched_and_reference_bitwise():
    st = stencil.lap2d_stencil(12, 9)
    jst = jstencil.lap2d_stencil(12, 9)
    b = np.random.default_rng(3).standard_normal((2, st.n))
    pe = AzulEngine(st, dtype=np.float64, device="cpu")
    je = JaxEngine(jst, mesh=None, precond="jacobi", dtype=np.float64)
    spec = dict(method="pcg_tol", tol=1e-9, max_iters=400, batch=2)
    p = pe.plan(SolveSpec(**spec))
    jp = je.plan(JaxSpec(**spec))
    x, _ = p(b)
    jx, _ = jp(b)
    assert list(p.last_iters) == list(np.asarray(jp.last_iters))
    np.testing.assert_allclose(x, np.asarray(jx), rtol=1e-9, atol=1e-12)
    pr = pe.plan(SolveSpec(fused=False, **spec))
    xr, _ = pr(b)
    assert pr.info["substrate"] == "reference"
    np.testing.assert_array_equal(x, xr)


def test_stencil_engine_rules():
    st = stencil.lap2d_stencil(8)
    with pytest.raises(ValueError, match="stored nonzeros"):
        AzulEngine(st, precond="block_ic0", device="cpu")
    with pytest.raises(ValueError, match="conflicts"):
        AzulEngine(st, format="hyb", device="cpu")
    eng = AzulEngine(st, precond="none", dtype=np.float64, device="cpu")
    with pytest.raises(ValueError, match="conflicts"):
        eng.plan(SolveSpec(method="pcg", iters=5, format="ell"))
    assert eng.plan(SolveSpec(method="pcg", iters=5,
                              format="stencil")).info["format"] == "stencil"
    # O(n) device state: the inverse diagonal only
    assert eng.device_bytes() == eng.n_pad * 8
    with pytest.raises(ValueError, match="stores no operator"):
        convert.engine_state_to_numpy(eng)
    fmt, arrays = convert.format_to_numpy(st)
    assert fmt == "stencil"
    assert convert.format_from_numpy(fmt, arrays, device="cpu") == st
    jarr = {k: v for k, v in jstencil.lap2d_stencil(8)._asdict().items()}
    assert convert.format_from_numpy("stencil", jarr, device="cpu") == st
    for bad in ((0,), (0, 3)):
        with pytest.raises(ValueError, match="extent"):
            (stencil.lap3d_stencil if len(bad) == 1
             else stencil.lap2d_stencil)(*bad)
    x = np.random.default_rng(4).standard_normal(st.n)
    np.testing.assert_allclose(eng.spmv(x), _as_scipy(laplacian_2d(8)) @ x,
                               **TOL)


def test_cli_stencil_matches_jax_cli(caches):
    tmp_path = caches
    args = ["--matrix", "stencil:lap2d_32", "--method", "pcg_tol", "--tol",
            "1e-8"]
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               REPRO_AUTOTUNE_CACHE=str(tmp_path / "jax.json"),
               REPRO_TORCH_AUTOTUNE_CACHE=str(tmp_path / "port.json"))
    outs = []
    for module, extra in (("repro.launch.solve", []),
                          ("repro_torch.launch.solve", ["--device", "cpu"])):
        r = subprocess.run([sys.executable, "-m", module, *extra, *args],
                           cwd=REPO, env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append(json.loads(r.stdout[r.stdout.index("{"):]))
    jax_out, out = outs
    assert out["format"] == jax_out["format"] == "stencil"
    assert out["iters_run"] == jax_out["iters_run"] == 94
    np.testing.assert_allclose(out["rel_error"], jax_out["rel_error"],
                               rtol=1e-6)
    for k in ("matrix", "n", "nnz", "method", "substrate", "status", "tol"):
        assert out[k] == jax_out[k], k
