"""The port's tile partitions and comm plans, held to the JAX package's on
the same numpy inputs (in process: ``repro.core.partition`` and
``repro.core.commplan`` need no mesh).

* ``split_rows``, ``tile_csr``, ``plan_1d``, ``plan_2d`` (equal rows and
  nnz-balanced, with ``row_offsets`` and ``pad2g``) and
  ``padded_layout_1d``: every array equal, over random sizes, grids
  (2, 2), (4, 1), (2, 4), (4, 2) and banded and unstructured matrices.
* ``compile_comm_plan_1d`` / ``_2d``: every field equal (deltas, the
  halo-remapped columns, the interior mask and counts, ``use_halo``), the
  modeled bytes and ``model()`` equal, ``halo_remap_cols`` and the
  ``_decide`` rule equal.
"""

import numpy as np
import pytest

from _hypothesis_compat import given, settings, strategies as st
from repro.core import commplan as jcommplan
from repro.core import partition as jpartition
from repro.data import matrices as jmat
from repro_torch.core import commplan, partition
from repro_torch.data import matrices as tmat
from torch_threads import one_torch_thread  # noqa: F401

GRIDS = ((2, 2), (4, 1), (2, 4), (4, 2))
KINDS = ("banded", "random", "lap2d")


def _pair(kind: str, n: int, seed: int):
    """The same matrix from both packages' builders."""
    if kind == "banded":
        args = (n, 1 + seed % 5, seed)
        return tmat.banded_spd(*args), jmat.banded_spd(*args)
    if kind == "random":
        args = (n, 0.05, seed)
        return tmat.random_spd(*args), jmat.random_spd(*args)
    g = max(int(np.sqrt(n)), 2)
    return tmat.laplacian_2d(g), jmat.laplacian_2d(g)


def _eq(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b)


def _same_comm(cp, jcp):
    assert type(cp).__name__ == type(jcp).__name__ == "CommPlan"
    for field in jcp._fields:
        got, want = getattr(cp, field), getattr(jcp, field)
        if isinstance(want, np.ndarray):
            _eq(got, want)
        else:
            assert got == want, field
    for lay in ("halo", "dense"):
        assert cp.bytes_per_iter(lay) == jcp.bytes_per_iter(lay)
    assert cp.model() == jcp.model()
    assert cp.halo_width == jcp.halo_width
    assert cp.overlap_efficiency == jcp.overlap_efficiency


@given(st.sampled_from(KINDS), st.integers(24, 260), st.integers(0, 50),
       st.sampled_from(GRIDS), st.sampled_from(("rows", "nnz")))
@settings(max_examples=40, deadline=None)
def test_plan_2d_and_comm_plan_equal_jax(kind, n, seed, grid, balance):
    m, jm = _pair(kind, n, seed)
    pr, pc = grid
    p = partition.plan_2d(m, pr, pc, dtype=np.float64, balance=balance)
    jp = jpartition.plan_2d(jm, pr, pc, dtype=np.float64, balance=balance)
    _eq(p.cols, jp.cols)
    _eq(p.vals, jp.vals)
    assert (p.pr, p.pc, p.n, p.n_padded) == (jp.pr, jp.pc, jp.n, jp.n_padded)
    assert (p.block_rows, p.block_cols) == (jp.block_rows, jp.block_cols)
    _eq(p.row_offsets, jp.row_offsets)
    _eq(p.pad2g, jp.pad2g)
    u = p.n_padded // (pr * pc)
    cp = commplan.compile_comm_plan_2d(p.cols, p.vals, pr, pc, u, itemsize=8)
    jcp = jcommplan.compile_comm_plan_2d(np.asarray(jp.cols),
                                         np.asarray(jp.vals), pr, pc, u,
                                         itemsize=8)
    _same_comm(cp, jcp)


@given(st.sampled_from(KINDS), st.integers(24, 260), st.integers(0, 50),
       st.sampled_from((2, 3, 4, 8)), st.sampled_from(("rows", "nnz")))
@settings(max_examples=40, deadline=None)
def test_plan_1d_and_comm_plan_equal_jax(kind, n, seed, parts, balance):
    m, jm = _pair(kind, n, seed)
    _eq(partition.split_rows(m, parts, balance),
        jpartition.split_rows(jm, parts, balance))
    p = partition.plan_1d(m, parts, balance=balance, dtype=np.float32)
    jp = jpartition.plan_1d(jm, parts, balance=balance, dtype=np.float32)
    _eq(p.cols, jp.cols)
    _eq(p.vals, jp.vals)
    _eq(p.row_offsets, jp.row_offsets)
    assert (p.n, p.n_padded, p.rows_per_tile, p.parts) == (
        jp.n, jp.n_padded, jp.rows_per_tile, jp.parts)
    cols_pad, pad2g = partition.padded_layout_1d(p)
    jcols_pad, jpad2g = jpartition.padded_layout_1d(jp)
    _eq(cols_pad, jcols_pad)
    _eq(pad2g, jpad2g)
    cp = commplan.compile_comm_plan_1d(cols_pad, p.vals, p.rows_per_tile,
                                       parts)
    jcp = jcommplan.compile_comm_plan_1d(jcols_pad, np.asarray(jp.vals),
                                         jp.rows_per_tile, parts)
    _same_comm(cp, jcp)
    hist = partition.partition_nnz_histogram(m, p.row_offsets)
    _eq(hist, jpartition.partition_nnz_histogram(jm, jp.row_offsets))


@given(st.sampled_from(KINDS), st.integers(10, 200), st.integers(0, 50),
       st.integers(0, 9), st.integers(1, 9))
@settings(max_examples=30, deadline=None)
def test_tile_csr_and_bandwidth_equal_jax(kind, n, seed, a, b):
    m, jm = _pair(kind, n, seed)
    nn = m.shape[0]
    r0, c0 = (a * nn) // 10, (b * nn) // 20
    r1, c1 = min(nn, r0 + 1 + (b * nn) // 10), min(nn, c0 + 1 + (a * nn) // 10)
    t, jt = partition.tile_csr(m, r0, r1, c0, c1), \
        jpartition.tile_csr(jm, r0, r1, c0, c1)
    for x, y in zip(t[:3], jt[:3]):
        _eq(x, y)
    assert t.shape == jt.shape
    assert partition.matrix_bandwidth(m) == jpartition.matrix_bandwidth(jm)


@pytest.mark.parametrize("p", [1, 2, 4, 16])
def test_decide_rule_and_remap_equal_jax(p):
    rng = np.random.default_rng(p)
    for h in range(p + 1):
        deltas = tuple(range(1, h + 1))[: max(p - 1, 0)]
        assert commplan._decide(deltas, p) == jcommplan._decide(deltas, p)
    u, tiles = 8, p
    cols = rng.integers(0, u * p, size=(tiles, 16, 4)).astype(np.int32)
    vals = rng.standard_normal((tiles, 16, 4)) * (rng.random((tiles, 16, 4))
                                                   > 0.3)
    deltas = tuple(range(1, p))
    coord = np.arange(tiles)
    _eq(commplan.halo_remap_cols(cols, vals, u, p, deltas, coord),
        jcommplan.halo_remap_cols(cols, vals, u, p, deltas, coord))


def test_unstructured_matrix_keeps_dense_and_banded_takes_halo():
    """The ``use_halo`` decision on the two shapes of matrix it exists for,
    as the JAX package decides it."""
    for kind, want in (("random", False), ("banded", True)):
        m, jm = _pair(kind, 256, 1)
        p = partition.plan_1d(m, 8, dtype=np.float64)
        cols_pad, _ = partition.padded_layout_1d(p)
        cp = commplan.compile_comm_plan_1d(cols_pad, p.vals,
                                           p.rows_per_tile, 8)
        jp = jpartition.plan_1d(jm, 8, dtype=np.float64)
        jcp = jcommplan.compile_comm_plan_1d(
            jpartition.padded_layout_1d(jp)[0], np.asarray(jp.vals),
            jp.rows_per_tile, 8)
        assert cp.use_halo == jcp.use_halo == want
