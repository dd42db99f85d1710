"""Host operator build of the port held against the JAX package: the
matrix generators give equal CSR arrays, CSR -> padded ELL packing gives
EQUAL cols/vals (row_pad 8, width_pad 8 as the engine packs), the engine's
inverse diagonal and its format rule are equal, and
``repro_torch.convert`` round-trips."""

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
    assert autotune.choose_format(pm) == jautotune.choose_format(
        jm, use_cache=False)


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
