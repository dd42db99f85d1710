"""Placements of the LM trees on a mesh (``launch.sharding.named`` and
``Placement``) held to the JAX package's ``NamedSharding`` on the CPU.

For every leaf of the ten architectures' smoke configs -- params, AdamW's
and Adafactor's state, decode caches and a batch -- on the meshes 2x2,
4x1, 2x4 (``data``, ``model``) and 2x2x2 (``pod``, ``data``, ``model``),
every tile's slices (``Placement.index``) equal JAX's
``NamedSharding(mesh, spec).devices_indices_map(shape)`` entry of the
mesh's tile-th device (``jax.sharding.Mesh.devices`` in row-major
order).  The JAX side runs once, from shapes alone (``jax.eval_shape``),
in a subprocess with 8 forced host devices; no rank is spawned.  Each
tile's slices add up to ``sharding.device_bytes``, and the ``DTensor``
placements name the same split.  A rank's state is drawn one tensor at a
time (``init_params(placements=)``, ``launch.train.placed_state``): its
slices equal those of the whole init, and building it never holds more
than its slices and one whole draw.
"""

import math
import weakref

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import configs
from repro_torch import train as T
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import model as M
from test_torch_dist_cases import run_jax
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = sorted(configs.names())
MESHES = {"2x2": ((2, 2), ("data", "model")), "4x1": ((4, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CACHE = (8, 64)                # decode caches: (batch, length)
BATCH = (8, 16)                # a train batch: (batch, seq)

_JAX = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro import configs as jconfigs
from repro import train as JT
from repro.launch import sharding as SH
from repro.models import model as JM

A = json.load(open(sys.argv[1]))
out = {}

def key(path):
    return "/".join(str(getattr(q, "key", getattr(q, "idx", q))) for q in path)

def slices(sh, shape, tiles):
    got = sh.devices_indices_map(tuple(shape))
    return [[[s.start or 0, shape[d] if s.stop is None else s.stop]
             for d, s in enumerate(got[dev])] for dev in tiles]

for mname, (shape, axes) in A["meshes"].items():
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), tuple(axes))
    tiles = list(mesh.devices.flat)
    baxes = tuple(a for a in axes if a != "model")
    for arch in A["archs"]:
        cfg = jconfigs.get_smoke(arch)
        p = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), cfg))
        trees = {"params": (p, SH.param_specs(p, cfg.fsdp))}
        for opt in ("adamw", "adafactor"):
            st = jax.eval_shape(lambda o=opt: JT.init_train_state(
                p, getattr(JT, o)(JT.warmup_cosine(1e-3, 1, 10))))
            trees[opt] = (st.opt_state, SH.opt_specs(st.opt_state, cfg.fsdp))
        c = jax.eval_shape(lambda: JM.init_caches(cfg, *A["cache"]))
        trees["caches"] = (c, SH.cache_specs(c, baxes, cfg.seq_shard_decode))
        b = {k: jax.ShapeDtypeStruct(tuple(A["batch"]), np.int32) for k in ("tokens", "labels")}
        trees["batch"] = (b, SH.batch_specs(b, baxes))
        for tname, (tree, specs) in trees.items():
            named = SH.named(mesh, specs, tree)
            leaves = jax.tree_util.tree_leaves_with_path(tree)
            shs = jax.tree_util.tree_leaves(named, is_leaf=lambda x: hasattr(x, "devices_indices_map"))
            for (path, leaf), sh in zip(leaves, shs):
                out[f"{mname}|{arch}|{tname}|{key(path)}"] = slices(sh, leaf.shape, tiles)
np.savez(sys.argv[2], json=json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_slices(tmp_path_factory):
    args = {"meshes": MESHES, "archs": ARCHS, "cache": CACHE, "batch": BATCH}
    return run_jax(_JAX, args, tmp_path_factory.mktemp("placement") / "jax.npz")[1]


def port_trees(arch) -> dict:
    """tree name -> (leaves, specs) of the port's trees of ``arch``'s smoke
    config, on ``meta``."""
    cfg = configs.get_smoke(arch)
    model = M.init_params(cfg, None, "meta")
    out = {"params": (SH.tree_leaves(model), SH.param_specs(model, cfg.fsdp))}
    for opt in ("adamw", "adafactor"):
        st = T.init_train_state(model, getattr(T, opt)(T.warmup_cosine(1e-3, 1, 10)))
        out[opt] = (SH.tree_leaves(st.opt_state), SH.opt_specs(st.opt_state, cfg.fsdp))
    return out, cfg, model


def _key(path) -> str:
    return "/".join(map(str, path))


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_tile_holds_jaxs_slices(jax_slices, arch, mname):
    shape, axes = MESHES[mname]
    mesh = SH.MeshShape(dict(zip(axes, shape)))
    trees, cfg, model = port_trees(arch)
    baxes = batch_axes(mesh)
    caches = SH.cache_leaves(M.init_caches(cfg, *CACHE, device="meta"))
    trees["caches"] = (caches, SH.cache_specs(caches, baxes, cfg.seq_shard_decode))
    batch = {k: torch.empty(BATCH, dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    trees["batch"] = (batch, SH.batch_specs(batch, baxes))
    n = 0
    for tname, (tree, specs) in trees.items():
        leaves = SH.tree_leaves(tree)
        pls = SH.named(mesh, specs, leaves)
        per_tile = [0] * mesh.size
        for path, pl in pls.items():
            want = jax_slices[f"{mname}|{arch}|{tname}|{_key(path)}"]
            got = [[[s.start, s.stop] for s in pl.index(t)] for t in range(mesh.size)]
            assert got == want, (tname, path, pl.spec)
            for t in range(mesh.size):
                per_tile[t] += math.prod(s.stop - s.start for s in pl.index(t)) \
                    * SH._itemsize(leaves[path])
            n += 1
        assert per_tile == [SH.device_bytes(leaves, specs, mesh)] * mesh.size
    assert n == sum(1 for k in jax_slices if k.startswith(f"{mname}|{arch}|"))


@pytest.mark.parametrize("mname", list(MESHES))
def test_dtensor_placements_name_the_split(mname):
    """``Shard(d)`` on every mesh axis that splits dim d, ``Replicate()``
    elsewhere, in the mesh's axis order; and a tree of placements from a
    ``TrainState`` of specs is a ``TrainState`` of them."""
    from torch.distributed.tensor import Replicate, Shard

    shape, axes = MESHES[mname]
    mesh = SH.MeshShape(dict(zip(axes, shape)))
    trees, cfg, model = port_trees("dbrx-132b")
    for leaves, specs in trees.values():
        for path, pl in SH.named(mesh, specs, leaves).items():
            want = tuple(next((Shard(d) for d, e in enumerate(pl.spec)
                               if a == e or (isinstance(e, tuple) and a in e)),
                              Replicate()) for a in axes)
            assert pl.placements == want, path
    state = T.init_train_state(model, T.adafactor(T.warmup_cosine(1e-3, 1, 10)))
    pls = SH.named(mesh, SH.state_specs(state, cfg.fsdp, mesh), state)
    assert isinstance(pls, T.TrainState) and pls.ef is None
    assert pls.step.shape == () and pls.step.index(0) == ()
    assert set(pls.params) == set(M.param_leaves(model))


def test_place_and_gather_in_one_process():
    """Where one process holds every tile (a ``TileMesh``) ``place`` keeps
    each whole leaf (copied onto the mesh's device) and ``gather`` gives
    it back: bitwise, bytes as held."""
    from repro_torch.launch.mesh import make_mesh

    cfg = configs.get_smoke("granite-3-8b")
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = T.init_train_state(model, T.adamw(T.warmup_cosine(1e-3, 1, 10)), compress=True)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    pls = SH.named(mesh, SH.state_specs(state, cfg.fsdp, mesh), state)
    placed = SH.place(state, pls)
    back = SH.gather(placed, pls)
    for f in ("params", "opt_state", "ef"):
        a, b = SH.tree_leaves(getattr(state, f)), SH.tree_leaves(getattr(back, f))
        assert list(a) == list(b)
        for k in a:
            for x, y in zip(T.optim.rows(a[k]), T.optim.rows(b[k])):
                assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()
    assert SH.held_bytes(placed) == SH.held_bytes(state)


class _Rank(SH.MeshShape):
    """One rank of a process grid without its processes: ``Placement``
    gives this process rank ``rank``'s slices, on the CPU."""

    per_process = True

    def __init__(self, shape: dict, rank: int):
        super().__init__(shape)
        self.rank, self.device = rank, torch.device("cpu")


class _CpuBytes(TorchDispatchMode):
    """Bytes of the CPU storages that the ops inside it create: ``live``
    now, ``peak`` the most at once (a storage an op's input already had is
    not new; a new one counts until it is freed)."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._refs: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {t.untyped_storage()._cdata for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor) and t.device.type == "cpu"}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or t.device.type != "cpu":
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._refs:
                continue
            n = st.nbytes()
            self._refs[key] = weakref.ref(st, lambda _, k=key, n=n: self._free(k, n))
            self.live += n
            self.peak = max(self.peak, self.live)
        return out

    def _free(self, key, n):
        if self._refs.pop(key, None) is not None:
            self.live -= n


def _assert_same_leaves(a, b):
    for f in ("params", "opt_state", "ef"):
        x, y = SH.tree_leaves(getattr(a, f) or {}), SH.tree_leaves(getattr(b, f) or {})
        assert list(x) == list(y), f
        for k in x:
            for u, v in zip(T.optim.rows(x[k]), T.optim.rows(y[k])):
                assert u.dtype == v.dtype and torch.equal(u, v), (f, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_draws_a_ranks_slices(arch):
    """``init_params(placements=)`` cuts each tensor to the rank's slice as
    it is drawn: bitwise the slices ``place`` cuts from the whole init, on
    a rank that every axis of the 2x2x2 mesh splits."""
    cfg = configs.get_smoke(arch)
    mesh = _Rank({"pod": 2, "data": 2, "model": 2}, 5)
    whole = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pls = SH.tree_named(mesh, whole, cfg.fsdp)
    got = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu", placements=pls)
    want = SH.place(whole, pls)
    a, b = M.param_leaves(got), M.param_leaves(want)
    assert list(a) == list(b)
    for k in a:
        for u, v in zip(T.optim.rows(a[k]), T.optim.rows(b[k])):
            assert u.dtype == v.dtype and torch.equal(u, v), k
    assert SH.held_bytes(got) == SH.device_bytes(SH.tree_leaves(whole),
                                                 SH.param_specs(whole, cfg.fsdp), mesh)


@pytest.mark.parametrize("opt_name,compress", [("adamw", False), ("adafactor", False),
                                               ("adamw", True)])
def test_placed_state_never_holds_the_whole_state(opt_name, compress):
    """``launch.train.placed_state`` on a rank of the 2x2 grid: the state
    ``place`` cuts from the whole seed-0 state, bitwise, holding
    ``device_bytes``; while it is built the rank holds at most those bytes
    plus two of the largest whole f32 draw, well under the whole state."""
    from repro_torch.launch.train import make_optimizer, placed_state

    cfg = configs.get_smoke("granite-3-8b")
    mesh = _Rank({"data": 2, "model": 2}, 3)
    opt = make_optimizer(opt_name, 3e-3, 3)
    with _CpuBytes() as built:
        state, pls, want = placed_state(mesh, cfg, opt, compress)
    draw = 4 * max(p.numel() for p in M.init_params(cfg, None, "meta").parameters())
    with _CpuBytes() as whole:
        ref = SH.place(T.init_train_state(
            M.init_params(cfg, torch.Generator().manual_seed(0), "cpu"), opt,
            compress=compress), pls)
    _assert_same_leaves(state, ref)
    assert SH.held_bytes(state) == want == built.live
    assert built.peak <= want + 2 * draw < whole.peak
