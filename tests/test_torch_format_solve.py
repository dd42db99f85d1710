"""The storage-format portfolio of the port held against the JAX package.

On the same numpy inputs, float64:

* each SELL / HYB / BCSR matvec of ``repro_torch.core.spops``, 1-D and
  (k, n), is allclose (rtol = atol = 1e-12) to the JAX package's: only the
  summation order differs (the port sums each row in a fixed pairwise
  order where JAX runs segment sums and scatter-adds);
* ``bcsr_spmm``'s plain version is allclose to ``repro.kernels.ref`` and
  to the Pallas kernel in interpret mode at the JAX sweep shapes, with the
  same ``nbc`` errors;
* solves on every format end with the JAX package's iteration counts and
  status: ``format="auto"`` picks HYB on skew_1k (19) and rmat_1k (16),
  the explicit formats on ``skew_spd(96, hubs=3, hub_nnz=30)``, a k = 3
  batch on HYB, block-IC(0) on HYB;
* within a format the fused and the reference substrate are bitwise equal;
* the format cache round-trips and recovers from a torn file, and the
  format resolution rules are the JAX package's local ones.

Both packages' on-disk format caches are pointed into ``tmp_path``.
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

from repro.core import formats as jformats
from repro.core import registry as jregistry
from repro.core import spops as jspops
from repro.core.engine import AzulEngine as JaxEngine
from repro.core.plan import SolveSpec as JaxSpec
from repro.data import matrices as jmatrices
from repro.kernels import autotune as jautotune
from repro.kernels import ref as jref
from repro.kernels.bcsr_spmm import bcsr_spmm as pallas_bcsr_spmm
from repro_torch.core import formats, registry, spops
from repro_torch.core.engine import AzulEngine
from repro_torch.core.plan import SolveSpec
from repro_torch.data import matrices
from repro_torch.kernels import autotune, bcsr_spmm, ops
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-12, atol=1e-12)
FORMATS = ("ell", "sell", "hyb", "bcsr")
# the JAX package's pcg_tol counts under format="auto" (BENCH_pcg.json
# "formats": both matrices pick hyb)
AUTO_ITERS = {"skew_1k": 19, "rmat_1k": 16}


@pytest.fixture(autouse=True)
def caches(tmp_path, monkeypatch):
    """Both packages' format caches in tmp_path, memos cleared."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "port.json"))
    jautotune.clear_memo()
    autotune.clear_memo()
    yield tmp_path
    jautotune.clear_memo()
    autotune.clear_memo()


def _pair(name):
    if name == "skew_96":
        return (jmatrices.skew_spd(96, hubs=3, hub_nnz=30, seed=1),
                matrices.skew_spd(96, hubs=3, hub_nnz=30, seed=1))
    return jmatrices.suite("small")[name], matrices.suite("small")[name]


def _containers(jm, pm):
    """(JAX container, port container) per format, as the engines build
    them (slice height, row pad and block size 8), float64."""
    return {
        "sell": (jformats.sell_from_csr(jm, dtype=np.float64),
                 formats.sell_from_csr(pm, dtype=np.float64, device="cpu")),
        "hyb": (jformats.hyb_from_csr(jm, dtype=np.float64),
                formats.hyb_from_csr(pm, dtype=np.float64, device="cpu")),
        "bcsr": (jformats.bcsr_from_csr(jm, bm=8, bn=8, dtype=np.float64),
                 formats.bcsr_from_csr(pm, bm=8, bn=8, dtype=np.float64,
                                       device="cpu")),
    }


def _jax_mv(fmt, obj, x, n_pad):
    x = jnp.asarray(x)
    if fmt == "sell":
        return (jspops.spmm_sell_flat if x.ndim == 2
                else jspops.spmv_sell_flat)(obj, x)
    if fmt == "hyb":
        return (jspops.spmm_hyb_padded if x.ndim == 2
                else jspops.spmv_hyb_padded)(obj, x)
    if x.ndim == 2:
        return jspops.spmm_bcsr_padded(obj, x, n_pad)
    return jspops.spmv_bcsr_padded(obj, x, n_pad)


def _port_mv(fmt, obj, x, n_pad):
    x = torch.from_numpy(x)
    if fmt == "sell":
        return (spops.spmm_sell_flat if x.dim() == 2
                else spops.spmv_sell_flat)(obj, x)
    if fmt == "hyb":
        return (spops.spmm_hyb_padded if x.dim() == 2
                else spops.spmv_hyb_padded)(obj, x)
    if x.dim() == 2:
        return spops.spmm_bcsr_padded(obj, x, n_pad)
    return spops.spmv_bcsr_padded(obj, x, n_pad)


@pytest.mark.parametrize("name", ["skew_1k", "rmat_1k", "lap2d_32", "skew_96"])
@pytest.mark.parametrize("k", [None, 3])
def test_format_matvecs_match_jax(name, k):
    jm, pm = _pair(name)
    n = pm.shape[0]
    n_pad = -(-n // 8) * 8
    rng = np.random.default_rng(n)
    x = np.zeros((n_pad,) if k is None else (k, n_pad))
    x[..., :n] = rng.standard_normal(x[..., :n].shape)
    for fmt, (jo, po) in _containers(jm, pm).items():
        got = _port_mv(fmt, po, x, n_pad).numpy()
        want = np.asarray(_jax_mv(fmt, jo, x, n_pad))
        assert got.shape == want.shape == x.shape, fmt
        np.testing.assert_allclose(got, want, **TOL, err_msg=fmt)
    # the true-size BCSR matvec
    jo, po = _containers(jm, pm)["bcsr"]
    np.testing.assert_allclose(
        spops.spmv_bcsr(po, torch.from_numpy(x[..., :n].reshape(-1, n)[0])),
        np.asarray(jspops.spmv_bcsr(jo, jnp.asarray(x[..., :n].reshape(-1, n)[0]))),
        **TOL)


def test_sell_and_hyb_lanes_equal_their_solo_calls():
    """The fixed-order row reduction: lane j of a (k, n) call is bitwise
    the (1, n) call on lane j, and a second call repeats the bits."""
    cs = _containers(*_pair("rmat_1k"))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((5, 1000)))
    for fmt in ("sell", "hyb"):
        po = cs[fmt][1]
        mm = spops.spmm_sell_flat if fmt == "sell" else spops.spmm_hyb_padded
        mv = spops.spmv_sell_flat if fmt == "sell" else spops.spmv_hyb_padded
        wide = mm(po, x)
        assert torch.equal(wide, mm(po, x))
        for j in range(5):
            assert torch.equal(wide[j], mm(po, x[j: j + 1])[0]), (fmt, j)
            assert torch.equal(wide[j], mv(po, x[j])), (fmt, j)


def test_tree_sum_order():
    t = torch.tensor([[1.0, 2.0, 3.0, 4.0, 5.0]])
    assert spops.tree_sum(t).item() == 15.0
    # (1e16 + 1) + (-1e16 + 1): the pairwise order, not left to right
    t = torch.tensor([1e16, -1e16, 1.0, 1.0], dtype=torch.float64)
    assert spops.tree_sum(t).item() == ((1e16 + 1.0) + (-1e16 + 1.0))


# -- bcsr_spmm's plain version ----------------------------------------------


def _bcsr_case(bm, bn, r, n=96, seed=7):
    a = sp.random(n, n, density=0.1, random_state=seed, format="csr")
    a.setdiag(2.0)
    jm = jformats.csr_from_scipy(a.tocsr())
    pm = formats.csr_from_scipy(a.tocsr())
    jb = jformats.bcsr_from_csr(jm, bm=bm, bn=bn, dtype=np.float64)
    pb = formats.bcsr_from_csr(pm, bm=bm, bn=bn, dtype=np.float64, device="cpu")
    nbc = formats.pad_to(n, bn) // bn
    x = np.random.default_rng(1).standard_normal((nbc * bn, r))
    return jb, pb, nbc, x


@pytest.mark.parametrize("bm,bn,r", [(8, 16, 4), (8, 128, 8), (16, 32, 16),
                                     (8, 8, 1), (8, 8, 16)])
def test_bcsr_spmm_plain_matches_jax(bm, bn, r):
    """ops.bcsr_spmm on CPU tensors (the plain version) against the JAX
    oracle and the Pallas kernel in interpret mode."""
    jb, pb, nbc, x = _bcsr_case(bm, bn, r)
    got = ops.bcsr_spmm(pb.block_cols, pb.blocks, torch.from_numpy(x), nbc=nbc)
    assert got.shape == (pb.block_cols.shape[0] * bm, r)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.bcsr_spmm_ref(jb.block_cols, jb.blocks,
                                                   jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(pallas_bcsr_spmm(jb.block_cols, jb.blocks,
                                                 jnp.asarray(x), interpret=True,
                                                 nbc=nbc)), **TOL)
    # the solver layout: the transposed view of an (R, N) tensor
    xt = torch.from_numpy(np.ascontiguousarray(x.T)).T
    assert torch.equal(ops.bcsr_spmm(pb.block_cols, pb.blocks, xt), got)


def test_bcsr_spmm_nbc_validation():
    """The JAX package's x-extent errors: x exactly (nbc*bn, R) when nbc is
    given, a multiple of bn always."""
    jb, pb, nbc, x = _bcsr_case(8, 16, 4, n=64, seed=11)
    bc, bl = pb.block_cols, pb.blocks
    ops.bcsr_spmm(bc, bl, torch.from_numpy(x), nbc=nbc)
    for bad in (x[:-16], np.vstack([x, x[:16]])):
        with pytest.raises(ValueError, match="incompatible with nbc"):
            ops.bcsr_spmm(bc, bl, torch.from_numpy(bad), nbc=nbc)
        with pytest.raises(ValueError, match="incompatible with nbc"):
            pallas_bcsr_spmm(jb.block_cols, jb.blocks, jnp.asarray(bad),
                             interpret=True, nbc=nbc)
    with pytest.raises(ValueError, match="incompatible with bn"):
        ops.bcsr_spmm(bc, bl, torch.from_numpy(x[:-3]))
    # x_valid: rows past it read as 0
    xv = torch.from_numpy(x.copy())
    xv[40:] = 0.0
    assert torch.equal(ops.bcsr_spmm(bc, bl, torch.from_numpy(x), x_valid=40),
                       ops.bcsr_spmm(bc, bl, xv))


def test_bcsr_wrapper_refuses_cpu_tensors_and_bad_shapes():
    _, pb, nbc, x = _bcsr_case(8, 16, 4, n=64, seed=11)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        bcsr_spmm.bcsr_spmm(pb.block_cols, pb.blocks, torch.from_numpy(x))
    with pytest.raises(ValueError, match="incompatible with nbc"):
        bcsr_spmm.bcsr_spmm(pb.block_cols, pb.blocks, torch.from_numpy(x),
                            nbc=nbc + 1)
    with pytest.raises(ValueError, match="block_cols"):
        bcsr_spmm.bcsr_spmm(pb.block_cols[:, :1], pb.blocks,
                            torch.from_numpy(x))
    assert ops.launch_counts() == before
    assert bcsr_spmm.bcsr_spmm_plain is ops.ref.bcsr_spmm_ref


# -- solves on each format --------------------------------------------------


def _b(m, rng):
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    return a @ rng.standard_normal(m.shape[0])


def _solve(eng, spec_cls, b, **spec):
    plan = eng.plan(spec_cls(**spec))
    x, norms = plan(b)
    return (np.asarray(x), np.asarray(norms), np.asarray(plan.last_iters),
            plan.last_status_names, plan.info["format"])


def test_auto_format_solves_match_jax():
    """format="auto" on the skewed suite matrices: both packages pick HYB
    and stop at the same count (b as bench_pcg's formats section draws
    it: one default_rng(0), skew_1k first)."""
    rng = np.random.default_rng(0)
    spec = dict(method="pcg_tol", tol=1e-8, max_iters=400)
    for name, want in AUTO_ITERS.items():
        jm, pm = _pair(name)
        b = _b(pm, rng)
        je = JaxEngine(jm, mesh=None, precond="jacobi", dtype=np.float64)
        pe = AzulEngine(pm, dtype=np.float64, device="cpu")
        assert pe.format_choice == je.format_choice == "hyb"
        assert pe.format_words == je.format_words
        jx, jn, ji, js, jf = _solve(je, JaxSpec, b, **spec)
        tx, tn, ti, ts, tf = _solve(pe, SolveSpec, b, **spec)
        assert (tf, int(ti), ts) == (jf, int(ji), js) == ("hyb", want,
                                                         "converged")
        np.testing.assert_allclose(tn, jn, rtol=0,
                                   atol=1e-9 * np.linalg.norm(b))
        np.testing.assert_allclose(tx, jx, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("fmt", FORMATS)
def test_explicit_format_solves_match_jax(fmt):
    """Every explicit format on the JAX package's format-test matrix:
    equal counts and status, x allclose, true residual small."""
    jm, pm = _pair("skew_96")
    b = np.random.default_rng(1).standard_normal(96)
    spec = dict(method="pcg_tol", tol=1e-10, max_iters=300)
    je = JaxEngine(jm, mesh=None, precond="jacobi", dtype=np.float64,
                   format=fmt)
    pe = AzulEngine(pm, dtype=np.float64, format=fmt, device="cpu")
    assert pe.format_choice == fmt
    jx, _, ji, js, jf = _solve(je, JaxSpec, b, **spec)
    tx, _, ti, ts, tf = _solve(pe, SolveSpec, b, **spec)
    assert (tf, int(ti), ts) == (jf, int(ji), js) == (fmt, int(ji), "converged")
    np.testing.assert_allclose(tx, jx, rtol=1e-9, atol=1e-12)
    a = sp.csr_matrix((pm.data, pm.indices, pm.indptr), shape=pm.shape)
    assert np.linalg.norm(b - a @ tx) / np.linalg.norm(b) < 1e-8


@pytest.mark.parametrize("fmt", FORMATS)
def test_fused_bitwise_matches_reference_per_format(fmt):
    """One matvec closure serves both substrates, so within a format the
    fused and the reference substrate are bitwise equal (on the CPU, where
    the fused update runs cg_update's plain version), for one RHS and a
    k = 3 batch."""
    _, pm = _pair("skew_96")
    rng = np.random.default_rng(0)
    eng = AzulEngine(pm, dtype=np.float64, format=fmt, device="cpu")
    for b in (rng.standard_normal(96), rng.standard_normal((3, 96))):
        batch = None if b.ndim == 1 else 3
        pf = eng.plan(SolveSpec(method="pcg", iters=40, batch=batch, fused=True))
        pr = eng.plan(SolveSpec(method="pcg", iters=40, batch=batch, fused=False))
        assert (pf.info["substrate"], pr.info["substrate"]) == ("fused",
                                                               "reference")
        xf, nf = pf(b)
        xr, nr = pr(b)
        np.testing.assert_array_equal(xf, xr)
        np.testing.assert_array_equal(nf, nr)


def test_batched_hyb_solve_matches_jax():
    jm, pm = _pair("skew_1k")
    b = np.random.default_rng(2).standard_normal((3, 1000))
    spec = dict(method="pcg_tol", tol=1e-9, max_iters=300, batch=3)
    je = JaxEngine(jm, mesh=None, precond="jacobi", dtype=np.float64,
                   format="hyb")
    pe = AzulEngine(pm, dtype=np.float64, format="hyb", device="cpu")
    jx, _, ji, js, _ = _solve(je, JaxSpec, b, **spec)
    tx, _, ti, ts, tf = _solve(pe, SolveSpec, b, **spec)
    assert tf == "hyb" and list(ti) == list(ji) and ts == js
    assert ts == ["converged"] * 3
    np.testing.assert_allclose(tx, jx, rtol=1e-9, atol=1e-12)


def test_block_ic0_on_hyb_matches_jax():
    """block-IC(0) streams A from HYB: the factors come from the CSR, the
    matvec from the format, on both substrates."""
    jm, pm = _pair("skew_1k")
    b = _b(pm, np.random.default_rng(0))
    spec = dict(method="pcg_tol", tol=1e-8, max_iters=200)
    je = JaxEngine(jm, mesh=None, precond="block_ic0", dtype=np.float64,
                   format="hyb")
    pe = AzulEngine(pm, precond="block_ic0", dtype=np.float64, format="hyb",
                    device="cpu")
    jx, _, ji, js, _ = _solve(je, JaxSpec, b, **spec)
    for fused in (True, False):
        tx, _, ti, ts, tf = _solve(pe, SolveSpec, b, fused=fused, **spec)
        assert (tf, int(ti), ts) == ("hyb", int(ji), js)
        np.testing.assert_allclose(tx, jx, rtol=1e-9, atol=1e-12)
    assert pe.plan(SolveSpec(fused=True, **spec)).info["substrate"] == "fused_ic0"


def test_spec_format_overrides_the_engine():
    _, pm = _pair("lap2d_32")
    eng = AzulEngine(pm, dtype=np.float64, device="cpu")
    assert eng.format_choice == "ell" and eng.format == "auto"
    base = eng.device_bytes()
    p = eng.plan(SolveSpec(method="pcg", iters=5, format="sell"))
    assert p.info["format"] == "sell" and p.spec.format == "sell"
    assert eng.device_bytes() > base           # the SELL container counts
    assert eng.plan(SolveSpec(method="pcg", iters=5)).info["format"] == "ell"
    assert eng.plan(SolveSpec(method="pcg", iters=5,
                              format="auto")).info["format"] == "ell"
    pinned = AzulEngine(pm, dtype=np.float64, format="bcsr", device="cpu")
    assert pinned.plan(SolveSpec(method="pcg", iters=5)).info["format"] == "bcsr"
    assert pinned.plan(SolveSpec(method="pcg", iters=5,
                                 format="hyb")).info["format"] == "hyb"
    with pytest.raises(ValueError, match="stencil"):
        eng.plan(SolveSpec(method="pcg", iters=5, format="stencil"))
    with pytest.raises(ValueError, match="format"):
        eng.plan(SolveSpec(method="pcg", iters=5, format="coo"))
    with pytest.raises(ValueError, match="stencil"):
        AzulEngine(pm, format="stencil", device="cpu")


# -- the format cache and the resolution rules ------------------------------


def test_format_cache_roundtrip_and_recovery(caches):
    """As the JAX package's test: a decision is recorded and looked up,
    tile readers would skip it, a torn file reads as empty and is
    rewritten valid.  The port writes its own file only."""
    path = caches / "port.json"
    assert autotune.cache_path() == str(path) and not path.exists()
    m = matrices.skew_spd(64, hubs=2, seed=9)
    fmt, words = autotune.choose_format(m)
    assert (fmt, words) == jautotune.choose_format(
        jmatrices.skew_spd(64, hubs=2, seed=9), use_cache=False)
    assert autotune.lookup_format(m, np.float32) == fmt
    disk = json.loads(path.read_text())
    ent = next(v for k, v in disk.items() if k.startswith("format|"))
    assert ent["format"] == fmt and ent["stats"] == autotune.row_stats(m)
    assert not (caches / "jax.json").exists()
    path.write_text('{"format|64x64x')
    autotune.clear_memo()
    assert autotune.lookup_format(m, np.float32) is None
    assert autotune.choose_format(m)[0] == fmt
    json.loads(path.read_text())
    # a cached decision wins over the rule, as in the JAX package
    key = next(iter(json.loads(path.read_text())))
    path.write_text(json.dumps({key: {"format": "sell"}}))
    autotune.clear_memo()
    assert autotune.choose_format(m)[0] == "sell"
    assert autotune.choose_format(m, use_cache=False)[0] == fmt


def test_format_cache_merges_concurrent_records(caches):
    """record_format re-reads the disk under the lock: an entry another
    process wrote since this one loaded survives."""
    path = caches / "port.json"
    a, b = matrices.skew_spd(64, hubs=2, seed=1), matrices.rmat_spd(64, seed=2)
    autotune.record_format(a, "hyb", {"ell": 1})
    other = json.loads(path.read_text())
    other["format|1x1x1x1|float32|host"] = {"format": "ell"}
    path.write_text(json.dumps(other))     # memo does not know this one
    autotune.record_format(b, "sell", {"ell": 2})
    disk = json.loads(path.read_text())
    assert "format|1x1x1x1|float32|host" in disk and len(disk) == 3


def test_resolve_format_rules_equal_jax():
    sdef, jsdef = registry.get_solver("pcg"), jregistry.get_solver("pcg")
    cases = [(None, "sell", False), ("auto", "hyb", False),
             ("bcsr", "ell", False), ("ell", "hyb", False),
             (None, "ell", True), ("auto", "ell", True),
             ("stencil", "ell", True)]
    for knob, choice, stencil in cases:
        assert registry.resolve_format(sdef, knob, engine_choice=choice,
                                       stencil=stencil) == \
            jregistry.resolve_format(jsdef, True, knob, engine_choice=choice,
                                     stencil=stencil)
    for knob, stencil in (("ell", True), ("stencil", False), ("nope", False),
                          ("hyb", True)):
        with pytest.raises(ValueError):
            registry.resolve_format(sdef, knob, stencil=stencil)
        with pytest.raises(ValueError):
            jregistry.resolve_format(jsdef, True, knob, stencil=stencil)


def _cli(module, args, env_extra):
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", **env_extra)
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout[r.stdout.index("{"):])


def test_cli_auto_format_matches_jax_cli(caches):
    args = ["--matrix", "skew_1k", "--method", "pcg_tol", "--tol", "1e-8",
            "--format", "auto"]
    env = {"REPRO_AUTOTUNE_CACHE": str(caches / "jax.json"),
           "REPRO_TORCH_AUTOTUNE_CACHE": str(caches / "port.json")}
    jax_out = _cli("repro.launch.solve", args, env)
    out = _cli("repro_torch.launch.solve", ["--device", "cpu", *args], env)
    assert out["format"] == jax_out["format"] == "hyb"
    assert out["iters_run"] == jax_out["iters_run"] == 19
    np.testing.assert_allclose(out["rel_error"], jax_out["rel_error"],
                               rtol=1e-6)
    for k in ("matrix", "n", "nnz", "method", "precond", "substrate", "fused",
              "layout", "reorder", "status", "bad_iter", "tol"):
        assert out[k] == jax_out[k], k


def test_chip_smoke_format_parity_constants_match_jax():
    """chip_smoke.py holds the card to these counts: they must be the JAX
    package's (Jacobi pcg_tol, f64, tol 1e-8, b = A x with x from a fresh
    default_rng(0) per matrix), with its format="auto" choice."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.FORMATS == FORMATS
    run = dict(method="pcg_tol", tol=1e-8, max_iters=400)
    for name, (fmt, want) in cs.PARITY_FORMATS.items():
        jm, _ = _pair(name)
        b = _b(jm, np.random.default_rng(0))
        je = JaxEngine(jm, mesh=None, precond="jacobi", dtype=np.float64)
        _, _, it, st, f = _solve(je, JaxSpec, b, **run)
        assert (f, int(it), st) == (fmt, want, "converged"), name
    for name, want in cs.PARITY_IC0_HYB.items():
        jm, _ = _pair(name)
        b = _b(jm, np.random.default_rng(0))
        je = JaxEngine(jm, mesh=None, precond="block_ic0", dtype=np.float64,
                       format="hyb")
        _, _, it, st, f = _solve(je, JaxSpec, b, **run)
        assert (f, int(it), st) == ("hyb", want, "converged"), name
