"""The port's checkpoints (``repro_torch.checkpoint``), held to the JAX
package's (``repro.checkpoint``).

* The corruption scenarios of ``tests/test_faults.py``: a damaged leaf
  under a valid manifest fails an explicit restore and is skipped by the
  unpinned one, a torn manifest is skipped, all steps corrupt raise
  FileNotFoundError.
* Either package's checkpoint restores bitwise in the other, for a nested
  tree of dicts, lists, tuples, None, numpy arrays and scalars; the step
  directories hold the same files and byte-identical manifests; ``keep``
  collects the same steps.
* Tensors: saved as their host arrays, restored as tensors where the
  template leaf is one; ``CheckpointManager.save_async`` snapshots its
  leaves when it is called.  ``sharding_tree`` places the leaves it names
  on their mesh or device (None keeps the leaf where it is).
* A fault-tolerant solve resumes from the other package's checkpoints.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro.checkpoint as jck
import repro.ft as jft
from repro.core import AzulEngine as JaxEngine
from repro.core import SolveSpec as JaxSpec
from repro.data.matrices import laplacian_2d as jax_lap2d
from repro_torch import checkpoint as ck
from repro_torch import ft
from repro_torch.core import AzulEngine, SolveSpec
from repro_torch.data.matrices import laplacian_2d
from repro_torch.launch.mesh import make_mesh
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.faults


def _tree(val, k):
    return {"x": np.full(32, float(val)), "k": np.int64(k)}


def _nested(seed):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal(17),
        "k": np.int64(seed),
        "b": {"w": [rng.standard_normal((3, 4)).astype(np.float32),
                    rng.integers(0, 9, 5).astype(np.int32)],
              "a": (np.float64(2.5), rng.standard_normal(0))},
        "none": None,
        "z": np.bool_(True),
    }


def _bitwise(got, want):
    assert type(got) is type(want) or isinstance(want, np.generic)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _bitwise(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _bitwise(g, w)
    elif want is None:
        assert got is None
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_restore_falls_back_past_corrupted_leaf(tmp_path, pkg):
    m = ck if pkg == "port" else jck
    d = str(tmp_path / "ck")
    m.save(_tree(1.0, 10), d, 10)
    m.save(_tree(2.0, 20), d, 20)
    leaf = os.path.join(d, "step_00000020", "x.npy")
    with open(leaf, "r+b") as f:
        f.seek(-8, os.SEEK_END)
        f.write(b"\xff" * 8)
    for restore in (ck.restore, jck.restore):
        with pytest.raises((ck.CorruptCheckpointError, jck.CorruptCheckpointError)):
            restore(_tree(0.0, 0), d, step=20)
        tree, step = restore(_tree(0.0, 0), d)
        assert step == 10
        assert float(tree["x"][0]) == 1.0 and int(tree["k"]) == 10
    with pytest.raises(ck.CorruptCheckpointError):
        ck.restore(_tree(0.0, 0), d, step=20)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_restore_skips_torn_manifest_and_raises_when_all_corrupt(tmp_path, pkg):
    m = ck if pkg == "port" else jck
    d = str(tmp_path / "ck")
    m.save(_tree(1.0, 10), d, 10)
    m.save(_tree(2.0, 20), d, 20)
    with open(os.path.join(d, "step_00000020", "manifest.json"), "r+") as f:
        f.truncate(17)
    assert ck.latest_step(d) == jck.latest_step(d) == 10
    tree, step = ck.restore(_tree(0.0, 0), d)
    assert step == 10 and float(tree["x"][0]) == 1.0
    with open(os.path.join(d, "step_00000010", "manifest.json"), "r+") as f:
        f.truncate(3)
    assert ck.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ck.restore(_tree(0.0, 0), d)


def test_checkpoints_cross_restore_bitwise(tmp_path):
    pd, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    for step in (3, 5, 7, 9):
        ck.save(_nested(step), pd, step, keep=3)
        jck.save(_nested(step), jd, step, keep=3)
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd))
    for step in (5, 7, 9):
        name = f"step_{step:08d}"
        assert sorted(os.listdir(os.path.join(pd, name))) == \
            sorted(os.listdir(os.path.join(jd, name)))
        with open(os.path.join(pd, name, "manifest.json"), "rb") as f:
            man = f.read()
        with open(os.path.join(jd, name, "manifest.json"), "rb") as f:
            assert f.read() == man
    like = _nested(0)
    for src in (pd, jd):
        for restore in (ck.restore, jck.restore):
            tree, step = restore(like, src)
            assert step == 9
            _bitwise(tree, _nested(9))
            tree, step = restore(like, src, step=5)
            _bitwise(tree, _nested(5))


def test_tensor_leaves_and_async_snapshot(tmp_path):
    d = str(tmp_path / "ck")
    x = torch.arange(12, dtype=torch.float64).reshape(3, 4)
    tree = {"x": x, "n": [torch.tensor(7, dtype=torch.int64), np.ones(2)]}
    mgr = ck.CheckpointManager(d, keep=2)
    mgr.save_async(tree, 1)
    x.add_(100.0)                    # after the call: not in the checkpoint
    tree["n"][1][:] = -1.0
    mgr.wait()
    got, step = mgr.restore({"x": torch.zeros(3, 4, dtype=torch.float64),
                             "n": [torch.zeros((), dtype=torch.int64),
                                   np.zeros(2)]})
    assert step == 1 == mgr.latest_step()
    assert isinstance(got["x"], torch.Tensor) and got["x"].device.type == "cpu"
    assert torch.equal(got["x"], torch.arange(12, dtype=torch.float64).reshape(3, 4))
    assert int(got["n"][0]) == 7 and np.array_equal(got["n"][1], np.ones(2))
    jtree, _ = jck.restore({"x": np.zeros((3, 4)), "n": [np.int64(0), np.zeros(2)]}, d)
    assert np.array_equal(jtree["x"], np.arange(12.0).reshape(3, 4))
    for s in (2, 3):
        mgr.save_async(tree, s)
    mgr.wait()
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000003"]
    # sharding_tree places the leaves it names (None keeps the placement)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    got, _ = mgr.restore(tree, sharding_tree={"x": mesh, "n": [None, "cpu"]})
    assert isinstance(got["x"], torch.Tensor) and got["x"].device == mesh.device
    assert isinstance(got["n"][1], torch.Tensor)


def test_solve_resumes_from_the_other_packages_checkpoints(tmp_path):
    m = laplacian_2d(16)
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    b = a @ np.random.default_rng(0).standard_normal(m.shape[0])
    eng = AzulEngine(m, dtype=np.float64, format="ell", device="cpu")
    jeng = JaxEngine(jax_lap2d(16), dtype=np.float64, format="ell")
    pd, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    kw = dict(chunk=20)
    # a solve cut short by its budget leaves checkpoints behind
    ft.SolveRestartManager(eng, SolveSpec(method="pcg_tol", max_iters=40),
                           checkpoint_dir=pd, **kw).solve(b)
    jft.SolveRestartManager(jeng, JaxSpec(method="pcg_tol", max_iters=40),
                            checkpoint_dir=jd, **kw).solve(b)
    assert ck.latest_step(pd) == jck.latest_step(jd) == 40
    reps = [ft.SolveRestartManager(eng, SolveSpec(method="pcg_tol",
                                                  max_iters=400),
                                   checkpoint_dir=jd, **kw).solve(b),
            jft.SolveRestartManager(jeng, JaxSpec(method="pcg_tol",
                                                  max_iters=400),
                                    checkpoint_dir=pd, **kw).solve(b)]
    for rep in reps:
        assert rep.resumed_from == 40 and rep.status == "converged"
    assert reps[0].iterations == reps[1].iterations
    assert reps[0].chunks == reps[1].chunks
    np.testing.assert_allclose(reps[0].x, reps[1].x, rtol=0, atol=1e-9)
