"""The port's plain kernel versions held against the JAX package.

For each kernel on the first slice's path (``ell_spmv``,
``ell_spmv_pfold_dot``, ``cg_update``) the port's plain PyTorch version --
what ``repro_torch.kernels.ops`` runs for CPU tensors -- must match both
``repro.kernels.ref`` and the Pallas kernel run in interpret mode, on the
same float64 inputs made with numpy.  Tolerance rtol = atol = 1e-12: only
the summation order differs.

The CUDA kernels themselves run only on a card; ``chip_smoke.py`` holds
them against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ell_spmv import ell_spmv as pallas_ell_spmv
from repro.kernels.spmv_dot import ell_spmv_pfold_dot as pallas_pfold_dot
from repro.kernels.vecops import cg_update as pallas_cg_update
from repro_torch.kernels import bcsr_spmm, ell_spmv, ops, spmv_dot, sptrsv, vecops

TOL = dict(rtol=1e-12, atol=1e-12)

# (true rows n, ELL width, Pallas row tile dividing the padded rows)
ELL_CASES = [(1003, 5, 16), (64, 8, 64), (4099, 3, 216)]


def _ell(n, width, seed):
    """Random square padded ELL (rows padded to 8) as numpy: padded rows and
    a share of the slots hold col 0 / val 0.0, like the engine's packing."""
    rng = np.random.default_rng(seed)
    rows_p = -(-n // 8) * 8
    cols = rng.integers(0, n, (rows_p, width)).astype(np.int32)
    vals = rng.standard_normal((rows_p, width))
    pad = rng.random((rows_p, width)) < 0.2
    pad[n:] = True
    cols[pad], vals[pad] = 0, 0.0
    return rng, cols, vals


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, *wants):
    for w in wants:
        np.testing.assert_allclose(np.asarray(got), np.asarray(w), **TOL)


@pytest.mark.parametrize("n,width,tm", ELL_CASES)
def test_ell_spmv_plain_matches_jax(n, width, tm):
    rng, cols, vals = _ell(n, width, seed=n)
    x = rng.standard_normal(cols.shape[0])
    got = ops.ell_spmv(_t(cols), _t(vals), _t(x)).numpy()
    _close(got,
           jref.ell_spmv_ref(jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x)),
           pallas_ell_spmv(jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x),
                           tm=tm, tw=width, interpret=True))


@pytest.mark.parametrize("beta", [0.0, 0.37])
@pytest.mark.parametrize("n,width,tm", ELL_CASES)
def test_ell_spmv_pfold_dot_plain_matches_jax(n, width, tm, beta):
    rng, cols, vals = _ell(n, width, seed=n + 1)
    z, p = rng.standard_normal((2, cols.shape[0]))
    got = ops.ell_spmv_pfold_dot(_t(cols), _t(vals), _t(z), _t(p),
                                 torch.tensor(beta, dtype=torch.float64))
    jargs = (jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(z), jnp.asarray(p))
    want_ref = jref.ell_spmv_pfold_dot_ref(*jargs, jnp.float64(beta))
    want_pl = pallas_pfold_dot(*jargs, beta, tm=tm, tw=width, interpret=True)
    for g, wr, wp in zip(got, want_ref, want_pl):
        _close(g.numpy(), wr, wp)


@pytest.mark.parametrize("use_dinv", [True, False])
@pytest.mark.parametrize("n,tn", [(1000, 128), (4099, 512), (256, 256)])
def test_cg_update_plain_matches_jax(n, tn, use_dinv):
    """Ragged n with a masked tail tile (n % tn != 0), an exact fit, and
    both bodies (with the Jacobi diagonal, and identity with dinv=None)."""
    rng = np.random.default_rng(n + tn)
    x, r, p, ap = rng.standard_normal((4, n))
    dinv = rng.random(n) + 0.5 if use_dinv else None
    alpha = 0.61
    got = ops.cg_update(torch.tensor(alpha, dtype=torch.float64), _t(x), _t(r),
                        _t(p), _t(ap), None if dinv is None else _t(dinv))
    jargs = [jnp.asarray(v) for v in (x, r, p, ap)]
    jd = None if dinv is None else jnp.asarray(dinv)
    want_ref = jref.cg_update_ref(jnp.float64(alpha), *jargs, jd)
    want_pl = pallas_cg_update(alpha, *jargs, jd, tn=tn, interpret=True)
    for g, wr, wp in zip(got, want_ref, want_pl):
        _close(g.numpy(), wr, wp)


def test_plain_versions_sit_beside_the_kernels():
    """Each kernel module carries its plain version, and the CPU dispatch
    runs exactly that function."""
    assert ell_spmv.ell_spmv_plain is ops.ref.ell_spmv_ref
    assert ell_spmv.ell_spmm_plain is ops.ref.ell_spmm_ref
    assert spmv_dot.ell_spmv_pfold_dot_plain is ops.ref.ell_spmv_pfold_dot_ref
    assert spmv_dot.ell_spmm_pfold_dot_plain is ops.ref.ell_spmm_pfold_dot_ref
    assert vecops.cg_update_plain is ops.ref.cg_update_ref
    assert sptrsv.sptrsv_solve_dot_plain is ops.ref.sptrsv_solve_dot_ref
    assert bcsr_spmm.bcsr_spmm_plain is ops.ref.bcsr_spmm_ref


def test_cpu_tensors_never_count_as_launches():
    _, cols, vals = _ell(64, 8, seed=3)
    v = torch.ones(64, dtype=torch.float64)
    before = ops.launch_counts()
    ops.ell_spmv(_t(cols), _t(vals), v)
    ops.ell_spmv_pfold_dot(_t(cols), _t(vals), v, v, 0.5)
    ops.cg_update(0.5, v, v, v, v, v)
    vb = torch.ones(3, 64, dtype=torch.float64)
    ops.ell_spmm(_t(cols), _t(vals), vb)
    ops.ell_spmm_pfold_dot(_t(cols), _t(vals), vb, vb, torch.ones(3))
    ops.cg_update(torch.ones(3, 1), vb, vb, vb, vb, v)
    sched = torch.arange(64).reshape(64, 1)        # a diagonal: one row a level
    ops.sptrsv_solve_dot(_t(cols), _t(vals), v, v, sched, v)
    bc = torch.zeros(8, 2, dtype=torch.int32)
    ops.bcsr_spmm(bc, torch.ones(8, 2, 8, 8, dtype=torch.float64),
                  torch.ones(64, 3, dtype=torch.float64), nbc=8)
    assert ops.launch_counts() == before
    assert set(before) == {"ell_spmv", "ell_spmv_pfold_dot", "cg_update",
                           "ell_spmm", "ell_spmm_pfold_dot",
                           "cg_update_batched", "sptrsv_solve_dot",
                           "bcsr_spmm"}


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches on a CUDA device or raises: it never runs
    the plain version itself."""
    _, cols, vals = _ell(64, 8, seed=4)
    c, v = _t(cols), _t(vals)
    x = torch.ones(64, dtype=torch.float64)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        ell_spmv.ell_spmv(c, v, x)
    with pytest.raises(ValueError, match="CUDA"):
        spmv_dot.ell_spmv_pfold_dot(c, v, x, x, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        vecops.cg_update(0.5, x, x, x, x)
    xb = torch.ones(3, 64, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        ell_spmv.ell_spmm(c, v, xb)
    with pytest.raises(ValueError, match="CUDA"):
        spmv_dot.ell_spmm_pfold_dot(c, v, xb, xb, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        vecops.cg_update_batched(0.5, xb, xb, xb, xb)
    pack = sptrsv.solve_pack(np.arange(64).reshape(64, 1), 64, 64, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        sptrsv.sptrsv_solve_dot(c, v, x, x, pack, x)
    with pytest.raises(ValueError, match="CUDA"):
        bcsr_spmm.bcsr_spmm(torch.zeros(8, 2, dtype=torch.int32),
                            torch.ones(8, 2, 8, 8, dtype=torch.float64),
                            torch.ones(64, 3, dtype=torch.float64))
    assert ops.launch_counts() == before


def test_kernel_wrappers_validate_shapes():
    _, cols, vals = _ell(64, 8, seed=5)
    x = torch.ones(63, dtype=torch.float64)
    with pytest.raises(ValueError, match="square padded"):
        spmv_dot.ell_spmv_pfold_dot(_t(cols), _t(vals), x, x, 0.5)
    with pytest.raises(ValueError, match="cg_update"):
        vecops.cg_update(0.5, x, x, x, torch.ones(64, dtype=torch.float64))
    xb = torch.ones(3, 63, dtype=torch.float64)
    with pytest.raises(ValueError, match="square padded"):
        spmv_dot.ell_spmm_pfold_dot(_t(cols), _t(vals), xb, xb, 0.5)
    with pytest.raises(ValueError, match="cg_update_batched"):
        vecops.cg_update_batched(0.5, xb, xb, xb, xb, torch.ones(64))
    pack = sptrsv.solve_pack(np.arange(64).reshape(8, 8), 64, 64, "cpu")
    x64 = torch.ones(64, dtype=torch.float64)
    with pytest.raises(ValueError, match="sptrsv_solve_dot: b"):
        sptrsv.sptrsv_solve_dot(_t(cols), _t(vals), x64, x, pack)
    with pytest.raises(ValueError, match="pack rows_p"):
        sptrsv.sptrsv_solve_dot(_t(cols[:56]), _t(vals[:56]), x64, x64, pack)
    # the schedule: a row listed twice, a negative id, n_rows past rows_p
    with pytest.raises(ValueError, match="twice"):
        sptrsv.solve_pack(np.zeros((2, 8), np.int32), 64, 64, "cpu")
    with pytest.raises(ValueError, match="negative"):
        sptrsv.solve_pack(-np.ones((2, 8), np.int32), 64, 64, "cpu")
    with pytest.raises(ValueError, match="n_rows"):
        sptrsv.solve_pack(np.arange(64).reshape(8, 8), 65, 64, "cpu")
    bc = torch.zeros(8, 2, dtype=torch.int32)
    bl = torch.ones(8, 2, 8, 8, dtype=torch.float64)
    with pytest.raises(ValueError, match="incompatible with bn"):
        bcsr_spmm.bcsr_spmm(bc, bl, torch.ones(63, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match="incompatible with nbc"):
        bcsr_spmm.bcsr_spmm(bc, bl, torch.ones(64, 3, dtype=torch.float64),
                            nbc=7)
    with pytest.raises(ValueError, match="block_cols"):
        bcsr_spmm.bcsr_spmm(bc[:4], bl, torch.ones(64, 3, dtype=torch.float64))


def test_group_size_covers_the_row():
    assert [ell_spmv.group_size(w) for w in (1, 2, 3, 5, 8, 9, 32, 100)] == \
        [1, 2, 4, 8, 8, 16, 32, 32]
