"""The port's tile grid (``AzulEngine(mesh=...)``) held to the JAX
package's distributed engine on the same numpy inputs.

The JAX side needs one device per tile: it runs ONCE for the module, in a
subprocess with 8 forced host devices and x64 (the environment of
``tests/test_engine_dist.py``), and writes every result into an .npz
under ``tmp_path_factory``; the port runs in process on ``device="cpu"``
(``make_mesh(..., device="cpu")``).

* Every NoC primitive on (2, 2), (2, 4), (4, 2) and the multipod (2, 2, 2)
  mesh, 1-D shards and batched (k, u) ones (``vec_axis``), non-square
  ``mesh_transpose``, ``tiled=False``: equal to the JAX collectives; an
  identity hop is elided and records no ``collective-permute``.
* Engine build: the stacked cols/vals (``cols_template`` /
  ``vals_template``), the inverse diagonal, ``pad2g``, the comm plan and
  the per-tile block-IC(0) planes equal to JAX's; ``device_bytes`` equal.
* ``spmv``, 1-D and k = 4: allclose 1e-12 to JAX's; halo == dense bit for
  bit in the port.
* Solves: every registered method on 2d (2x2, 4x1, 2x4, 4x2), 1d (4
  tiles) and multipod (2, 2, 2) grids, dense and halo, Jacobi and
  block-IC(0), 1-D and k = 4, fused and reference, guarded and not,
  ``reorder="rcm"`` and ``balance="rows"``: iterations, statuses and
  bad_iter EQUAL to JAX's, x allclose 1e-10, and ``hlo_summary()``'s
  ``count_by_op`` equal to JAX's (pipelined all-reduce 2 against pcg's
  4, halo plans with no all-gather).
* The overlapped (interior/frontier) pipelined plans equal the dense ones
  bit for bit; ``build_sptrsv`` against JAX's and scipy; ``convert``
  carries a JAX engine's arrays into a port engine that solves as JAX's
  does, and round-trips its own.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro_torch import convert
from repro_torch.core import AzulEngine, SolveSpec, noc
from repro_torch.core.engine import _offset_cols
from repro_torch.core.formats import csr_from_scipy
from repro_torch.data import matrices as tmat
from repro_torch.launch.mesh import (AXES, TileMesh, batch_axes, make_mesh,
                                     make_production_mesh)
from test_torch_dist_cases import MESHES, eng_case, matrix, rhs, run_jax
from torch_threads import one_torch_thread  # noqa: F401

K = 4
SPEC = dict(iters=40, max_iters=400, tol=1e-8)
METHODS = ("pcg", "pcg_tol", "cg", "pcg_pipelined", "pcg_pipelined_tol",
           "jacobi")

ENGINES = {
    "lap_2x2": eng_case("lap16", "2x2"),
    "lap_2x2_ic0": eng_case("lap16", "2x2", precond="block_ic0"),
    "lap_1d4": eng_case("lap16", "4x1", mode="1d"),
    "lap_1d4_ic0": eng_case("lap16", "4x1", mode="1d", precond="block_ic0"),
    "rspd_4x1": eng_case("rspd192", "4x1"),
    "band_2x4": eng_case("band300", "2x4"),
    "lap_4x2": eng_case("lap16", "4x2"),
    "lap_mp": eng_case("lap16", "mp"),
    "lap_2x2_rcm": eng_case("lap16", "2x2", reorder="rcm"),
    "band_2x2_rows": eng_case("band300", "2x2", balance="rows"),
    "band_1d4_halo": eng_case("band300", "4x1", mode="1d", layout="halo"),
}


def _solves():
    out = []

    def add(eng, **kw):
        sid = f"{eng}:" + ",".join(f"{k}={v}" for k, v in sorted(kw.items()))
        out.append((sid, eng, dict(SPEC, **kw)))

    for meth in METHODS:
        add("lap_2x2", method=meth, layout="dense")
    for meth in ("pcg_tol", "pcg_pipelined", "pcg_pipelined_tol", "jacobi"):
        add("lap_2x2", method=meth, layout="halo")    # jacobi+halo raises
    for meth in ("pcg", "pcg_tol", "cg", "jacobi", "pcg_pipelined_tol"):
        add("lap_1d4", method=meth)
    add("lap_2x2", method="pcg_tol", layout="halo", batch=K)
    add("lap_2x2", method="pcg_pipelined_tol", layout="halo", batch=K)
    add("lap_1d4", method="cg", batch=K)
    add("lap_2x2", method="pcg_tol", fused=False)
    add("lap_2x2", method="pcg_pipelined", fused=False, layout="halo")
    add("lap_2x2", method="pcg_tol", guard=False, layout="halo")
    add("lap_1d4", method="pcg_pipelined_tol", layout="dense")
    for meth in ("pcg_tol", "pcg_pipelined_tol", "cg"):
        add("lap_2x2_ic0", method=meth, layout="halo")
    add("lap_2x2_ic0", method="pcg_tol", layout="dense")
    add("lap_2x2_ic0", method="pcg_tol", batch=K)
    add("lap_2x2_ic0", method="pcg_tol", fused=False)
    for meth in ("pcg", "pcg_pipelined_tol"):
        add("lap_1d4_ic0", method=meth)
    add("lap_1d4_ic0", method="pcg_pipelined_tol", batch=K)
    add("rspd_4x1", method="pcg_tol")
    add("rspd_4x1", method="pcg_tol", batch=K)
    add("band_2x4", method="pcg_tol")
    add("band_2x4", method="pcg_pipelined_tol", layout="halo")
    add("lap_4x2", method="pcg_tol")
    add("lap_mp", method="pcg_tol")
    add("lap_mp", method="pcg_pipelined_tol", layout="halo", batch=K)
    add("lap_2x2_rcm", method="pcg_tol")
    add("band_2x2_rows", method="pcg_tol")
    add("band_1d4_halo", method="pcg_pipelined", injectable=True)
    return out


SOLVES = _solves()


def _noc_cases():
    """(id, mesh, op, kwargs, batch): each primitive on 8-word shards."""
    out = []
    for mname in ("2x2", "2x4", "4x2", "mp"):
        _, axes, rows, cols = MESHES[mname]
        ops = (("mesh_transpose", dict(row_axes=rows, col_axes=cols)),
               ("pull_shard", dict(axes=rows, delta=1)),
               ("pull_shard", dict(axes=axes, delta=3)),
               ("neighbor_shift", dict(axis=cols[0], shift=1)),
               ("gather_along", dict(axis=rows)),
               ("gather_along", dict(axis=cols, tiled=False)),
               ("reduce_along", dict(axis=cols)),
               ("reduce_along", dict(axis=axes)),
               ("reduce_scatter_along", dict(axis=rows)),
               ("reverse_vector", dict(axes=axes)),
               ("bcast_from", dict(axis=rows, src=1)),
               ("axis_coord", dict(axis=cols)))
        for k in (None, 3):
            for i, (op, kw) in enumerate(ops):
                out.append((f"{mname}:{op}:{i}:k{k}", mname, op, kw, k))
    return out


NOC = _noc_cases()

SPTRSV_ENGINE = eng_case("lap16", "2x2", balance="rows")
CONVERT_ENGINES = ("lap_2x2_ic0", "lap_1d4")

_JAX = r"""
import json, sys
import numpy as np
import scipy.sparse as sp
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import noc
from repro.core.engine import AzulEngine, _shard_map
from repro.core.formats import csr_from_scipy
from repro.core.plan import SolveSpec
from repro.data import matrices as jm
from repro.launch.mesh import make_mesh
from test_torch_dist_cases import MESHES, matrix, rhs

C = json.load(open(sys.argv[1]))
res, js = {}, {}
meshes = {}


def mesh_of(name):
    if name not in meshes:
        shape, axes, _, _ = MESHES[name]
        meshes[name] = make_mesh(tuple(shape), tuple(axes))
    return meshes[name]


def build(e):
    _, _, ra, ca = MESHES[e["mesh"]]
    return AzulEngine(matrix(jm, e["mat"]), mesh=mesh_of(e["mesh"]),
                      mode=e["mode"], row_axes=tuple(ra), col_axes=tuple(ca),
                      precond=e["precond"], balance=e["balance"],
                      dtype=np.float64, layout=e["layout"],
                      reorder=e["reorder"])


def noc_input(p, m, k):
    shape = (p * m,) if k is None else (k, p * m)
    return np.arange(int(np.prod(shape)), dtype=np.float64).reshape(shape) \
        * 0.25 + 1.0


for cid, mname, op, kw, k in C["noc"]:
    shape, axes, _, _ = MESHES[mname]
    mesh = mesh_of(mname)
    p = int(np.prod(shape))
    x = noc_input(p, 8, k)
    va = 0 if k is None else 1
    kw = {a: tuple(v) if isinstance(v, list) else v for a, v in kw.items()}
    if op == "gather_along":
        f = lambda v: noc.gather_along(v, kw["axis"], tiled=kw.get("tiled", True), vec_axis=va)
    elif op == "reduce_scatter_along":
        f = lambda v: noc.reduce_scatter_along(v, kw["axis"], vec_axis=va)
    elif op == "reverse_vector":
        f = lambda v: noc.reverse_vector(v, kw["axes"], vec_axis=va)
    elif op == "axis_coord":
        f = lambda v: jnp.full((1,), noc.axis_coord(kw["axis"]), jnp.int32)
    else:
        fn = getattr(noc, op)
        f = lambda v, fn=fn: fn(v, **kw)
    spec = P(tuple(axes)) if k is None else P(None, tuple(axes))
    ospec = P(tuple(axes)) if op == "axis_coord" else spec
    res[f"noc/{cid}"] = np.asarray(jax.jit(_shard_map(
        f, mesh, in_specs=(spec,), out_specs=ospec))(x))

engines = {name: build(e) for name, e in C["engines"].items()}
for name, eng in engines.items():
    cp = eng.comm_plan
    res[f"{name}/cols"] = eng.cols_template()
    res[f"{name}/vals"] = eng.vals_template()
    res[f"{name}/dinv"] = np.asarray(eng._dinv_pad)
    if eng._pad2g is not None:
        res[f"{name}/pad2g"] = np.asarray(eng._pad2g)
    res[f"{name}/cols_halo"] = np.asarray(cp.cols_halo)
    res[f"{name}/interior_mask"] = np.asarray(cp.interior_mask)
    res[f"{name}/halo_mask"] = eng.halo_entry_mask()
    meta = {"n_pad": int(eng.n_pad), "u": int(eng.u),
            "deltas": list(cp.deltas), "use_halo": bool(cp.use_halo),
            "model": cp.model(), "device_bytes": int(eng.device_bytes()),
            "comm": {f: (getattr(cp, f) if not isinstance(getattr(cp, f), (np.ndarray, tuple))
                         else None) for f in cp._fields},
            "br": int(eng.br if eng.mode == "2d" else eng.u),
            "bc": int(eng.bc if eng.mode == "2d" else eng.n_pad)}
    meta["comm"] = {k: (v.item() if hasattr(v, "item") else v)
                    for k, v in meta["comm"].items() if v is not None}
    if eng.precond == "block_ic0":
        meta["rows_p"] = int(eng._pc_rows_p)
        for pre, planes in (("l", eng._pc_l), ("u", eng._pc_u)):
            for key, a in zip(("cols", "vals", "dinv", "rows"), planes):
                res[f"{name}/{pre}_{key}"] = np.asarray(a)
        res[f"{name}/ks"] = np.asarray(eng._pc_k)
    n = eng.n
    res[f"{name}/y"] = np.asarray(eng.spmv(rhs(n, None, 7)))
    res[f"{name}/Y"] = np.asarray(eng.spmv(rhs(n, 4, 8)))
    js[name] = meta

for sid, ename, spec in C["solves"]:
    eng = engines[ename]
    b = rhs(eng.n, spec.get("batch"))
    try:
        plan = eng.plan(SolveSpec(**spec))
    except ValueError as e:
        js[sid] = {"error": str(e)}
        continue
    kw = {}
    if spec.get("injectable"):
        kw["vals"] = eng.vals_template()
    x, norms = plan(b, **kw)
    res[f"{sid}/x"] = np.asarray(x)
    res[f"{sid}/norms"] = np.asarray(norms)
    js[sid] = {"iters": np.asarray(plan.last_iters).tolist(),
               "status": np.asarray(plan.last_status).tolist(),
               "bad_iter": np.asarray(plan.last_bad_iter).tolist(),
               "substrate": plan.info["substrate"],
               "layout": plan.info["layout"], "noc": plan.info.get("noc"),
               "hlo": plan.hlo_summary()["count_by_op"]}

# block-staged distributed SpTRSV (square grid, uniform rows)
def lower(name):
    m = matrix(jm, name)
    lo = sp.tril(sp.csr_matrix((m.data, m.indices, m.indptr),
                               shape=m.shape)).tocsr()
    lo.sort_indices()
    return csr_from_scipy(lo)


eng = build(C["sptrsv_engine"])
fn = eng.build_sptrsv(lower(C["sptrsv_engine"]["mat"]))
res["sptrsv/x"] = np.asarray(fn(rhs(eng.n, None, 11)))
for bad in ("1d", "rcm", "nnz"):
    e = dict(C["sptrsv_engine"])
    e.update({"1d": dict(mode="1d"), "rcm": dict(reorder="rcm"),
              "nnz": dict(balance="nnz", mat="band300")}[bad])
    try:
        build(e).build_sptrsv(lower(e["mat"]))
        js[f"sptrsv/{bad}"] = "ok"
    except ValueError as err:
        js[f"sptrsv/{bad}"] = str(err)

np.savez(sys.argv[2], json=json.dumps(js), **res)
print("JAX_DIST_DONE")
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    cases = {"engines": ENGINES, "solves": SOLVES, "noc": NOC,
             "sptrsv_engine": SPTRSV_ENGINE}
    return run_jax(_JAX, cases, tmp_path_factory.mktemp("dist") / "jax.npz")


_MESH_CACHE: dict = {}
_ENG_CACHE: dict = {}


def port_mesh(name: str) -> TileMesh:
    if name not in _MESH_CACHE:
        shape, axes, _, _ = MESHES[name]
        _MESH_CACHE[name] = make_mesh(shape, axes, device="cpu")
    return _MESH_CACHE[name]


def port_build(e: dict, **over) -> AzulEngine:
    e = dict(e, **over)
    _, _, ra, ca = MESHES[e["mesh"]]
    return AzulEngine(matrix(tmat, e["mat"]), mesh=port_mesh(e["mesh"]),
                      mode=e["mode"], row_axes=ra, col_axes=ca,
                      precond=e["precond"], balance=e["balance"],
                      dtype=np.float64, layout=e["layout"],
                      reorder=e["reorder"], device="cpu")


def port_engine(name: str) -> AzulEngine:
    if name not in _ENG_CACHE:
        _ENG_CACHE[name] = port_build(ENGINES[name])
    return _ENG_CACHE[name]


# -- NoC primitives -----------------------------------------------------------


@pytest.mark.parametrize("cid,mname,op,kw,k", NOC, ids=[c[0] for c in NOC])
def test_noc_primitive_equals_jax(jax_side, cid, mname, op, kw, k):
    arrays, _ = jax_side
    mesh = port_mesh(mname)
    p, m = mesh.size, 8
    shape = (p * m,) if k is None else (k, p * m)
    x = np.arange(int(np.prod(shape)), dtype=np.float64).reshape(shape) \
        * 0.25 + 1.0
    xs = torch.tensor(x).view(shape[:-1] + (p, m))
    va = 0 if k is None else 1
    with noc.recording() as rec:
        if op == "gather_along":
            got = noc.gather_along(xs, mesh, kw["axis"],
                                   tiled=kw.get("tiled", True), vec_axis=va)
        elif op in ("reduce_scatter_along", "reverse_vector"):
            got = getattr(noc, op)(xs, mesh, *kw.values(), vec_axis=va)
        elif op == "axis_coord":
            got = noc.axis_coord(mesh, kw["axis"])
        else:
            got = getattr(noc, op)(xs, mesh, **kw)
    want = arrays[f"noc/{cid}"]
    assert np.array_equal(got.numpy().reshape(want.shape), want)
    if op != "axis_coord":
        assert sum(rec.counts.values()) <= 1


def test_identity_hops_are_elided_and_record_nothing():
    mesh = make_mesh((4, 1), ("data", "model"), device="cpu")
    xs = torch.arange(8.0).view(4, 2)
    with noc.recording() as rec:
        assert noc.mesh_transpose(xs, mesh, "data", "model") is xs   # pc == 1
        assert noc.neighbor_shift(xs, mesh, "model", 1) is xs        # p == 1
        assert noc.pull_shard(xs, mesh, "data", 4) is xs             # 4 % 4
        assert noc.neighbor_shift(xs, mesh, "data", 0) is xs         # shift 0
    assert rec.summary() == {"count_by_op": {}, "total_count": 0.0}
    with noc.recording() as rec:
        noc.pull_shard(xs, mesh, "data", 1)
        noc.gather_along(xs, mesh, "data")
        noc.reduce_scatter_along(xs, mesh, "model")
        noc.reduce_along(xs, mesh, ("data", "model"))
    assert rec.summary()["count_by_op"] == {
        "all-gather": 1.0, "all-reduce": 1.0, "collective-permute": 1.0,
        "reduce-scatter": 1.0}
    with pytest.raises(ValueError, match="vec_axis"):
        noc.gather_along(xs, mesh, "data", vec_axis=1)
    with pytest.raises(ValueError, match="no axis"):
        noc.gather_along(xs, mesh, "pod")


# -- engine build, spmv -------------------------------------------------------


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_arrays_equal_jax(jax_side, name):
    arrays, meta = jax_side
    eng = port_engine(name)
    want = meta[name]
    assert np.array_equal(eng.cols_template(), arrays[f"{name}/cols"])
    assert np.array_equal(eng.vals_template(), arrays[f"{name}/vals"])
    assert np.array_equal(eng._dinv_pad.numpy(), arrays[f"{name}/dinv"])
    assert (eng._pad2g is None) == (f"{name}/pad2g" not in arrays)
    if eng._pad2g is not None:
        assert np.array_equal(eng._pad2g, arrays[f"{name}/pad2g"])
    cp = eng.comm_plan
    assert np.array_equal(cp.cols_halo, arrays[f"{name}/cols_halo"])
    assert np.array_equal(cp.interior_mask, arrays[f"{name}/interior_mask"])
    assert np.array_equal(eng.halo_entry_mask(), arrays[f"{name}/halo_mask"])
    assert list(cp.deltas) == want["deltas"]
    assert cp.use_halo == want["use_halo"] and cp.model() == want["model"]
    for f, v in want["comm"].items():
        assert getattr(cp, f) == v, f
    assert (eng.n_pad, eng.u) == (want["n_pad"], want["u"])
    assert eng.device_bytes() == want["device_bytes"]
    if eng.precond == "block_ic0":
        rows_p, lp, up, ks = eng._pc_blocks
        assert rows_p == want["rows_p"]
        assert np.array_equal(ks, arrays[f"{name}/ks"])
        for pre, planes in (("l", lp), ("u", up)):
            for key, a in zip(("cols", "vals", "dinv", "rows"), planes):
                assert np.array_equal(a, arrays[f"{name}/{pre}_{key}"]), \
                    (pre, key)


@pytest.mark.parametrize("name", list(ENGINES))
def test_spmv_equals_jax_and_halo_equals_dense(jax_side, name):
    arrays, _ = jax_side
    eng = port_engine(name)
    x, xk = rhs(eng.n, None, 7), rhs(eng.n, 4, 8)
    y, yk = eng.spmv(x), eng.spmv(xk)
    for got, want in ((y, arrays[f"{name}/y"]), (yk, arrays[f"{name}/Y"])):
        assert got.shape == want.shape
        assert np.allclose(got, want, rtol=1e-12,
                           atol=1e-12 * np.abs(want).max())
    m = matrix(tmat, ENGINES[name]["mat"])
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    assert np.allclose(y, a @ x, atol=1e-12 * np.abs(y).max())
    dense = port_build(ENGINES[name], layout="dense")
    halo = port_build(ENGINES[name], layout="halo")
    assert np.array_equal(dense.spmv(x), halo.spmv(x))
    assert np.array_equal(dense.spmv(xk), halo.spmv(xk))


# -- solves -------------------------------------------------------------------


@pytest.mark.parametrize("sid,ename,spec", SOLVES, ids=[s[0] for s in SOLVES])
def test_solve_equals_jax(jax_side, sid, ename, spec):
    arrays, meta = jax_side
    want = meta[sid]
    eng = port_engine(ename)
    if "error" in want:
        with pytest.raises(ValueError) as ei:
            eng.plan(SolveSpec(**spec))
        assert str(ei.value) == want["error"]
        return
    plan = eng.plan(SolveSpec(**spec))
    b = rhs(eng.n, spec.get("batch"))
    kw = {"vals": eng.vals_template()} if spec.get("injectable") else {}
    x, norms = plan(b, **kw)
    assert np.asarray(plan.last_iters).tolist() == want["iters"]
    assert np.asarray(plan.last_status).tolist() == want["status"]
    assert np.asarray(plan.last_bad_iter).tolist() == want["bad_iter"]
    assert plan.info["substrate"] == want["substrate"]
    assert plan.info["layout"] == want["layout"]
    assert plan.info.get("noc") == want["noc"]
    assert x.shape == arrays[f"{sid}/x"].shape
    assert np.allclose(x, arrays[f"{sid}/x"], rtol=0, atol=1e-10)
    assert np.allclose(norms, arrays[f"{sid}/norms"], rtol=1e-6,
                       atol=1e-12 * np.abs(norms).max())
    assert plan.hlo_summary()["count_by_op"] == want["hlo"]
    assert plan.traces == 1
    plan(b, **kw)
    assert plan.traces == 1 and plan.executions == 2


@pytest.mark.parametrize("name,batch", [("lap_2x2", None), ("lap_2x2", K),
                                        ("lap_1d4", None), ("lap_1d4_ic0", K),
                                        ("band_2x4", None)])
def test_overlap_and_halo_plans_equal_dense_bitwise(name, batch):
    """The interior/frontier split (two launches summed) and the halo
    layout compute the dense layout's values bit for bit."""
    eng = port_engine(name)
    b = rhs(eng.n, batch)
    outs = {}
    for meth in ("pcg_pipelined_tol", "pcg_tol"):
        for lay in ("halo", "dense"):
            plan = eng.plan(SolveSpec(method=meth, layout=lay, batch=batch,
                                      **SPEC))
            outs[meth, lay] = plan(b) + (np.asarray(plan.last_iters),)
            if meth == "pcg_pipelined_tol":
                assert plan.info["noc"]["comm_overlap"] == (lay == "halo")
        for a, c in zip(outs[meth, "halo"], outs[meth, "dense"]):
            assert np.array_equal(a, c)


def test_pipelined_reduces_once_a_step():
    """The JAX test_pipelined invariant: a 1d halo pipelined plan holds 2
    all-reduces (set-up and loop body) and no all-gather, pcg 4."""
    eng = port_build(eng_case("lap16", "4x1", mode="1d"))
    ops = eng.plan(SolveSpec(method="pcg_pipelined", iters=60,
                             layout="halo")).hlo_summary()["count_by_op"]
    assert ops["all-reduce"] == 2 and "all-gather" not in ops
    assert ops["collective-permute"] > 0
    pcg = eng.plan(SolveSpec(method="pcg", iters=60, layout="halo"))
    assert pcg.hlo_summary()["count_by_op"]["all-reduce"] == 4
    assert pcg.info["hlo"] is pcg.hlo_summary()
    assert pcg.traces == 0                  # the summary builds nothing


# -- distributed SpTRSV, convert, validation ----------------------------------


def test_build_sptrsv_equals_jax_and_scipy(jax_side):
    arrays, meta = jax_side
    eng = port_build(SPTRSV_ENGINE)
    m = matrix(tmat, SPTRSV_ENGINE["mat"])
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    lo = sp.tril(a).tocsr()
    lo.sort_indices()
    fn = eng.build_sptrsv(csr_from_scipy(lo))
    assert eng.build_sptrsv(csr_from_scipy(lo)) is fn        # cached
    b = rhs(a.shape[0], None, 11)
    x = fn(b)
    assert np.allclose(x, arrays["sptrsv/x"], rtol=1e-12, atol=1e-12)
    ref = sp.linalg.spsolve_triangular(lo, b, lower=True)
    assert np.allclose(x, ref, atol=1e-10)
    for bad, over in (("1d", dict(mode="1d")), ("rcm", dict(reorder="rcm")),
                      ("nnz", dict(balance="nnz", mat="band300"))):
        want = meta[f"sptrsv/{bad}"]
        mm = matrix(tmat, over.get("mat", SPTRSV_ENGINE["mat"]))
        lo2 = sp.tril(sp.csr_matrix((mm.data, mm.indices, mm.indptr),
                                    shape=mm.shape)).tocsr()
        lo2.sort_indices()
        with pytest.raises(ValueError) as ei:
            port_build(SPTRSV_ENGINE, **over).build_sptrsv(
                csr_from_scipy(lo2))
        assert str(ei.value) == want
    with pytest.raises(ValueError, match="square"):
        port_build(eng_case("lap16", "2x4")).build_sptrsv(csr_from_scipy(lo))


@pytest.mark.parametrize("name", CONVERT_ENGINES)
def test_convert_carries_jax_state_and_round_trips(jax_side, name):
    arrays, meta = jax_side
    e = ENGINES[name]
    eng = port_engine(name)
    state = convert.dist_engine_state_to_numpy(eng)
    # the JAX engine's arrays, read out as numpy, build the same state
    jstate = dict(state)
    for key in ("cols", "vals", "dinv"):
        jstate[key] = arrays[f"{name}/{key}"]
    jstate["pad2g"] = arrays.get(f"{name}/pad2g")
    cp = dict(state["comm_plan"])
    cp.update(meta[name]["comm"])
    cp.update(deltas=tuple(meta[name]["deltas"]),
              cols_halo=arrays[f"{name}/cols_halo"],
              interior_mask=arrays[f"{name}/interior_mask"])
    jstate["comm_plan"] = cp
    if e["precond"] == "block_ic0":
        jstate["block_ic0"] = dict(rows_p=meta[name]["rows_p"],
                                   ks=arrays[f"{name}/ks"], **{
                                       f"{p}_{k}": arrays[f"{name}/{p}_{k}"]
                                       for p in "lu"
                                       for k in ("cols", "vals", "dinv",
                                                 "rows")})
    mesh = port_mesh(e["mesh"])
    b = rhs(eng.n)
    ref_x, ref_n = eng.plan(SolveSpec(method="pcg_tol", **SPEC))(b)
    for st in (state, jstate):
        new = convert.dist_engine_state_from_numpy(mesh, st,
                                                   precond=e["precond"])
        x, nr = new.plan(SolveSpec(method="pcg_tol", **SPEC))(b)
        assert np.array_equal(x, ref_x) and np.array_equal(nr, ref_n)
        assert new.device_bytes() == eng.device_bytes()
        back = convert.dist_engine_state_to_numpy(new)
        for key in ("cols", "vals", "dinv"):
            assert np.array_equal(back[key], state[key])
    with pytest.raises(ValueError, match="cols index"):
        bad = dict(state, cols=state["cols"] + 10 ** 6)
        convert.dist_engine_state_from_numpy(mesh, bad, precond=e["precond"])
    with pytest.raises(ValueError, match="local engine"):
        convert.dist_engine_state_to_numpy(
            AzulEngine(matrix(tmat, "lap16"), device="cpu"))


def test_mesh_validation_and_no_fallback():
    m = matrix(tmat, "lap16")
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(TypeError, match="TileMesh"):
        AzulEngine(m, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        AzulEngine(m, mesh=mesh, mode="3d")
    with pytest.raises(ValueError, match="distributed mode"):
        AzulEngine(m, mesh=mesh, format="bcsr")
    with pytest.raises(ValueError, match="local-only"):
        from repro_torch.core.stencil import lap2d_stencil
        AzulEngine(lap2d_stencil(8), mesh=mesh)
    with pytest.raises(ValueError, match="every mesh axis"):
        AzulEngine(m, mesh=mesh, row_axes=("model",), col_axes=("data",))
    with pytest.raises(ValueError, match="no axis"):
        AzulEngine(m, mesh=mesh, row_axes=("pod",))
    with pytest.raises(ValueError, match="differs"):
        AzulEngine(m, mesh=mesh, device="meta")
    eng = AzulEngine(m, mesh=mesh)          # the mesh names the device
    assert eng.device.type == "cpu" and eng.mode == "2d" and eng.tiles == 4
    with pytest.raises(ValueError, match="distributed mode"):
        eng.plan(SolveSpec(method="pcg", format="sell"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh((2, 2), ("data", "model"))
    prod = make_production_mesh(device="cpu")
    assert prod.devices_shape == (16, 16) and prod.size == 256
    multi = make_production_mesh(multi_pod=True, device="cpu")
    assert multi.axis_names == AXES["multi"] and batch_axes(multi) == (
        "pod", "data")
    # 256 tiles x a 2^23-word dense 1d buffer is past the kernels' int32
    # columns: refused at build
    with pytest.raises(ValueError, match="int32"):
        _offset_cols(np.zeros((256, 8, 1), np.int32), 1 << 23)
    assert _offset_cols(np.ones((256, 8, 1), np.int32), 1 << 20).max() == \
        255 * (1 << 20) + 1
