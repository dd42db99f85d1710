"""Host operator build of the port held against the JAX package: the
matrix generators give equal CSR arrays, CSR -> padded ELL packing gives
EQUAL cols/vals (row_pad 8, width_pad 8 as the engine packs), the SELL,
HYB and BCSR packing functions give EQUAL arrays over the suite and over property
sweeps, the dense round trips are equal, the engine's inverse diagonal
and its format rule are equal, and ``repro_torch.convert`` round-trips
(the packed ELL state and each format container)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.core import formats as jformats
from repro.core.engine import AzulEngine as JaxEngine
from repro.data import matrices as jmatrices
from repro.kernels import autotune as jautotune
from repro_torch import convert
from repro_torch.core import formats
from repro_torch.core.engine import AzulEngine
from repro_torch.data import matrices
from repro_torch.kernels import autotune
from torch_threads import one_torch_thread  # noqa: F401

# the names of suite("small") in both packages
SMALL = ("lap2d_32", "lap3d_10", "banded_1k", "rspd_1k", "skew_1k", "rmat_1k")


@pytest.fixture(scope="module")
def suites():
    return jmatrices.suite("small"), matrices.suite("small")


def _jax_engine(m):
    # format="ell" pins the JAX engine's format without consulting (or
    # writing) its on-disk autotune cache
    return JaxEngine(m, mesh=None, precond="jacobi", dtype=np.float64,
                     format="ell")


@pytest.mark.parametrize("name", SMALL)
def test_suite_generators_equal(suites, name):
    assert tuple(suites[0]) == tuple(suites[1]) == SMALL
    jm, pm = suites[0][name], suites[1][name]
    assert jm.shape == pm.shape
    for a, b in zip((jm.indptr, jm.indices, jm.data),
                    (pm.indptr, pm.indices, pm.data)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", SMALL)
def test_ell_packing_equals_jax(suites, name):
    jm, pm = suites[0][name], suites[1][name]
    je = jformats.ell_from_csr(jm, row_pad=8, width_pad=8, dtype=np.float64)
    cols, vals = formats.ell_arrays_from_csr(pm, row_pad=8, width_pad=8,
                                             dtype=np.float64)
    assert np.array_equal(np.asarray(je.cols), cols)
    assert np.array_equal(np.asarray(je.vals), vals)
    pe = formats.ell_from_csr(pm, row_pad=8, width_pad=8, dtype=np.float64,
                              device="cpu")
    assert pe.cols.dtype == torch.int32
    assert np.array_equal(pe.cols.numpy(), cols)
    assert np.array_equal(pe.vals.numpy(), vals)
    assert (pe.n_rows, pe.n_cols) == (je.n_rows, je.n_cols)


def _random_csr(n, density, seed):
    a = sp.random(n, n, density=density, random_state=seed, format="csr")
    a = a + sp.eye(n)
    return jformats.csr_from_scipy(a), formats.csr_from_scipy(a)


@given(st.integers(1, 40), st.floats(0.0, 0.5), st.integers(0, 10**6),
       st.sampled_from([1, 4, 8]), st.sampled_from([1, 8]))
@settings(max_examples=25, deadline=None)
def test_ell_packing_property(n, density, seed, row_pad, width_pad):
    jm, pm = _random_csr(n, density, seed)
    je = jformats.ell_from_csr(jm, row_pad=row_pad, width_pad=width_pad,
                               dtype=np.float32)
    cols, vals = formats.ell_arrays_from_csr(pm, row_pad=row_pad,
                                             width_pad=width_pad,
                                             dtype=np.float32)
    assert np.array_equal(np.asarray(je.cols), cols)
    assert np.array_equal(np.asarray(je.vals), vals)
    assert np.array_equal(jformats.csr_to_dense(jm), formats.csr_to_dense(pm))


def test_ell_width_too_small_raises():
    _, pm = _random_csr(8, 0.5, 1)
    with pytest.raises(ValueError, match="ELL width"):
        formats.ell_arrays_from_csr(pm, width=1)


@pytest.mark.parametrize("name", ["lap2d_32", "banded_1k"])
def test_engine_operands_equal_jax(suites, name):
    je = _jax_engine(suites[0][name])
    pe = AzulEngine(suites[1][name], dtype=np.float64, device="cpu")
    assert (pe.n, pe.n_pad) == (je.n, je.n_pad)
    assert np.array_equal(np.asarray(je.ell.cols), pe.ell.cols.numpy())
    assert np.array_equal(np.asarray(je.ell.vals), pe.ell.vals.numpy())
    assert np.array_equal(np.asarray(je._dinv_pad), pe._dinv_pad.numpy())
    assert pe.format_choice == je.format_choice == "ell"


@pytest.mark.parametrize("name", SMALL)
def test_format_rule_equals_jax(suites, name):
    """Row statistics, modeled words and the format choice equal the JAX
    package's (its on-disk cache bypassed with use_cache=False)."""
    jm, pm = suites[0][name], suites[1][name]
    assert autotune.row_stats(pm) == jautotune.row_stats(jm)
    assert (autotune.modeled_format_words(pm)
            == jautotune.modeled_format_words(jm))
    assert autotune.choose_format(pm, use_cache=False) == \
        jautotune.choose_format(jm, use_cache=False)


def test_convert_round_trips(suites):
    je = _jax_engine(suites[0]["lap2d_32"])
    state = dict(cols=np.asarray(je.ell.cols), vals=np.asarray(je.ell.vals),
                 dinv=np.asarray(je._dinv_pad), n=je.n, n_pad=je.n_pad)
    pe = convert.engine_state_from_numpy(**state, device="cpu")
    back = convert.engine_state_to_numpy(pe)
    assert back.keys() == state.keys()
    for k, v in state.items():
        assert np.array_equal(back[k], v), k
    assert back["vals"].dtype == np.float64 and back["cols"].dtype == np.int32


def test_convert_rejects_bad_state():
    cols = np.zeros((8, 2), np.int32)
    vals = np.zeros((8, 2))
    dinv = np.ones(8)
    with pytest.raises(ValueError, match="cols index"):
        convert.engine_state_from_numpy(cols + 8, vals, dinv, 8, 8,
                                        device="cpu")
    with pytest.raises(ValueError, match="dinv"):
        convert.engine_state_from_numpy(cols, vals, dinv[:4], 8, 8,
                                        device="cpu")
    with pytest.raises(ValueError, match="n_pad"):
        convert.engine_state_from_numpy(cols, vals, dinv, 9, 8, device="cpu")


# -- the format portfolio's containers ----------------------------------------


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_fields_equal(jobj, pobj):
    """Every field of the JAX container equals the port's (arrays in
    dtype and value); the port's extra row_groups are not compared."""
    for k, jv in jobj._asdict().items():
        pv = getattr(pobj, k)
        if isinstance(jv, int):
            assert jv == pv, k
        else:
            a, b = np.asarray(jv), _np(pv)
            assert a.dtype == b.dtype and np.array_equal(a, b), k


def _format_pairs(jm, pm, dtype=np.float64, sh=8, row_pad=8, bm=8, bn=8,
              core_width=None):
    """(JAX container, port container) for SELL, HYB and BCSR."""
    return {
        "sell": (jformats.sell_from_csr(jm, slice_height=sh, row_pad=row_pad,
                                        dtype=dtype),
                 formats.sell_from_csr(pm, slice_height=sh, row_pad=row_pad,
                                       dtype=dtype, device="cpu")),
        "hyb": (jformats.hyb_from_csr(jm, core_width=core_width,
                                      row_pad=row_pad, dtype=dtype),
                formats.hyb_from_csr(pm, core_width=core_width,
                                     row_pad=row_pad, dtype=dtype,
                                     device="cpu")),
        "bcsr": (jformats.bcsr_from_csr(jm, bm=bm, bn=bn, dtype=dtype),
                 formats.bcsr_from_csr(pm, bm=bm, bn=bn, dtype=dtype,
                                       device="cpu")),
    }


_TO_DENSE = {"sell": ("sell_to_dense",), "hyb": ("hyb_to_dense",),
             "bcsr": ("bcsr_to_dense",)}


@pytest.mark.parametrize("name", SMALL)
def test_format_packing_equals_jax(suites, name):
    """SELL, HYB and BCSR as the engine builds them (slice height, row pad
    and block size 8): every array equal to the JAX package's, and the
    dense round trip too."""
    jm, pm = suites[0][name], suites[1][name]
    for fmt, (jo, po) in _format_pairs(jm, pm).items():
        _assert_fields_equal(jo, po)
        fn = _TO_DENSE[fmt][0]
        assert np.array_equal(getattr(jformats, fn)(jo),
                              getattr(formats, fn)(po)), fmt


@given(st.integers(1, 40), st.floats(0.0, 0.5), st.integers(0, 10**6),
       st.sampled_from([2, 4, 8]), st.sampled_from([1, 8]),
       st.sampled_from([None, 1, 2, 4]),
       st.sampled_from([(2, 4), (8, 16), (4, 8), (16, 32)]))
@settings(max_examples=30, deadline=None)
def test_format_packing_property(n, density, seed, sh, row_pad, core_width,
                                  blk):
    jm, pm = _random_csr(n, density, seed)
    pairs = _format_pairs(jm, pm, dtype=np.float32, sh=sh, row_pad=row_pad,
                      bm=blk[0], bn=blk[1], core_width=core_width)
    for fmt, (jo, po) in pairs.items():
        _assert_fields_equal(jo, po)
        fn = _TO_DENSE[fmt][0]
        assert np.array_equal(getattr(jformats, fn)(jo),
                              getattr(formats, fn)(po)), fmt
    assert np.array_equal(jformats.ell_to_dense(jformats.ell_from_csr(jm)),
                          formats.ell_to_dense(formats.ell_from_csr(
                              pm, device="cpu")))


def test_hyb_core_width_equals_jax():
    rng = np.random.default_rng(0)
    for row_nnz in (np.full(16, 5), np.r_[np.full(63, 3), 50],
                    rng.integers(0, 30, 200), np.zeros(7, np.int64)):
        for width_pad in (1, 4):
            assert formats.hyb_core_width(row_nnz, width_pad=width_pad) == \
                jformats.hyb_core_width(row_nnz, width_pad=width_pad)


def test_bcsr_duplicate_entries_add_up_like_jax():
    """A CSR with a position stored twice: both packings add the two."""
    indptr = np.array([0, 3, 4], np.int32)
    indices = np.array([0, 1, 1, 0], np.int32)
    data = np.array([1.0, 2.0, 0.5, 4.0])
    jm = jformats.CSR(indptr, indices, data, (2, 2))
    pm = formats.CSR(indptr, indices, data, (2, 2))
    jo = jformats.bcsr_from_csr(jm, bm=2, bn=2, dtype=np.float64)
    po = formats.bcsr_from_csr(pm, bm=2, bn=2, dtype=np.float64, device="cpu")
    _assert_fields_equal(jo, po)
    with pytest.raises(ValueError, match="width"):
        formats.bcsr_from_csr(pm, bm=1, bn=1, width=1, device="cpu")


@pytest.mark.parametrize("fmt", ["sell", "hyb", "bcsr"])
def test_convert_carries_format_containers(suites, fmt):
    """A JAX container, read out as numpy, becomes the port's container
    with equal arrays, and reads back equal; an engine built from the
    packed state solves on it."""
    jm, pm = suites[0]["skew_1k"], suites[1]["skew_1k"]
    jo = _format_pairs(jm, pm)[fmt][0]
    arrays = {k: (v if isinstance(v, int) else np.asarray(v))
              for k, v in jo._asdict().items()}
    po = convert.format_from_numpy(fmt, arrays, device="cpu")
    _assert_fields_equal(jo, po)
    back_fmt, back = convert.format_to_numpy(po)
    assert back_fmt == fmt and back.keys() == arrays.keys()
    for k, v in arrays.items():
        assert np.array_equal(back[k], v), k
    je = _jax_engine(jm)
    state = dict(cols=np.asarray(je.ell.cols), vals=np.asarray(je.ell.vals),
                 dinv=np.asarray(je._dinv_pad), n=je.n, n_pad=je.n_pad)
    eng = convert.engine_state_from_numpy(**state, formats={fmt: arrays},
                                          device="cpu")
    assert convert.engine_state_to_numpy(eng)["formats"][fmt].keys() == \
        arrays.keys()
    from repro_torch.core.plan import SolveSpec
    b = np.random.default_rng(0).standard_normal(je.n)
    p = eng.plan(SolveSpec(method="pcg_tol", tol=1e-8, max_iters=200,
                           format=fmt))
    p(b)
    assert p.info["format"] == fmt and p.last_status_names == "converged"
    with pytest.raises(ValueError, match="no host matrix"):
        eng.plan(SolveSpec(method="pcg", format=({"sell", "hyb", "bcsr"}
                                                 - {fmt}).pop()))


def test_convert_rejects_bad_containers(suites):
    pm = suites[1]["lap2d_32"]
    _, bad = convert.format_to_numpy(formats.bcsr_from_csr(
        pm, bm=8, bn=8, device="cpu"))
    bad["block_cols"] = bad["block_cols"] + 1000
    with pytest.raises(ValueError, match="block_cols"):
        convert.format_from_numpy("bcsr", bad, device="cpu")
    _, bad = convert.format_to_numpy(formats.sell_from_csr(pm, device="cpu"))
    bad["rows"] = bad["rows"][::-1].copy()
    with pytest.raises(ValueError, match="slice widths"):
        convert.format_from_numpy("sell", bad, device="cpu")
    _, bad = convert.format_to_numpy(formats.hyb_from_csr(pm, device="cpu"))
    bad["cols"] = bad["cols"] - 1
    with pytest.raises(ValueError, match="index"):
        convert.format_from_numpy("hyb", bad, device="cpu")
    with pytest.raises(ValueError, match="no format container"):
        convert.format_from_numpy("coo", {}, device="cpu")
