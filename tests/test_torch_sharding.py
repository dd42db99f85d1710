"""The port's sharding spec rules (``repro_torch.launch.sharding``) and
``ft.remesh.validate_spec`` held to the JAX package's on the CPU.

Every architecture at its published config, built on the ``meta`` device
(nothing allocated) beside ``jax.eval_shape`` of the JAX init: first the
leaf paths and shapes equal (the port's ``LayerStack`` leaves stacked as
JAX stacks a group's layers; the optimizer state and the caches the same),
then every spec leaf by leaf equal to ``tuple(P)`` of JAX's: params,
AdamW's and Adafactor's state, caches (seq_shard on and off), batches and
whole ``TrainState`` s, on both JAX production meshes (``single`` 16 x 16,
``multi`` 2 x 16 x 16), with fsdp and ``ep_stationary`` on and off.  The
JAX functions read nothing of a mesh but ``mesh.shape``, so both packages
are given the port's ``MeshShape``.  ``validate_spec`` equals JAX's on
hypothesis shapes and specs.
"""

import itertools

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro import train as JT
from repro.ft.remesh import validate_spec as jax_validate_spec
from repro.launch import sharding as JSH
from repro.models import model as JM
from repro_torch import configs
from repro_torch import train as T
from repro_torch.ft.remesh import validate_spec
from repro_torch.launch import sharding as SH
from repro_torch.models import model as M
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = sorted(configs.names())
MESHES = ("single", "multi")
FLAGS = list(itertools.product((True, False), (True, False)))   # fsdp, ep
CACHE = (4, 4096)             # decode cache (batch, length) at full width


def jax_leaves(tree, specs=False) -> dict:
    """path (dict keys, list indices) -> leaf of a JAX tree."""
    is_leaf = (lambda x: isinstance(x, P)) if specs else None
    return {tuple(getattr(q, "key", getattr(q, "idx", None)) for q in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf)}


def same_shapes(port: dict, jax_tree):
    want = jax_leaves(jax_tree)
    assert list(port) == list(want)
    for k, leaf in port.items():
        assert SH.leaf_shape(leaf) == tuple(want[k].shape), k


def same_specs(port: dict, jax_specs):
    want = jax_leaves(jax_specs, specs=True)
    assert list(port) == list(want)
    for k, spec in port.items():
        assert spec == tuple(want[k]), (k, spec, want[k])


_TREES: dict = {}


def trees(name):
    """(port model, JAX params, {opt: (port state, JAX state)}, (port
    caches, JAX caches)) of ``name`` at its published config, shapes only,
    built once a module."""
    if name not in _TREES:
        cfg, jcfg = configs.get(name), jconfigs.get(name)
        model = M.init_params(cfg, None, "meta")
        jp = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jcfg))
        opts = {}
        for opt in ("adamw", "adafactor"):
            state = T.init_train_state(model, getattr(T, opt)(T.warmup_cosine(1e-4, 1, 10)))
            jstate = jax.eval_shape(lambda p, o=opt: JT.init_train_state(
                p, getattr(JT, o)(JT.warmup_cosine(1e-4, 1, 10))), jp)
            opts[opt] = (state, jstate)
        caches = M.init_caches(cfg, *CACHE, device="meta")
        jcaches = jax.eval_shape(lambda: JM.init_caches(jcfg, *CACHE))
        _TREES[name] = (model, jp, opts, (caches, jcaches))
    return _TREES[name]


@pytest.fixture(scope="module", autouse=True)
def _drop_trees():
    yield
    _TREES.clear()


@pytest.mark.parametrize("name", ARCHS)
def test_leaf_shapes_equal_jax(name):
    model, jp, opts, (caches, jcaches) = trees(name)
    same_shapes(SH.tree_leaves(model), jp)
    for state, jstate in opts.values():
        same_shapes(SH.tree_leaves(state.opt_state), jstate.opt_state)
    same_shapes(SH.cache_leaves(caches), jcaches)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("fsdp,ep", FLAGS)
def test_param_specs_equal_jax(name, mesh, fsdp, ep):
    model, jp, _, _ = trees(name)
    m = SH.MESHES[mesh]
    same_specs(SH.param_specs(model, fsdp, m, ep), JSH.param_specs(jp, fsdp, m, ep))
    # the leaves dict gives the same
    assert SH.param_specs(M.param_leaves(model), fsdp, m, ep) == \
        SH.param_specs(model, fsdp, m, ep)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("fsdp,ep", FLAGS)
def test_opt_specs_equal_jax(name, opt, mesh, fsdp, ep):
    _, _, opts, _ = trees(name)
    state, jstate = opts[opt]
    m = SH.MESHES[mesh]
    same_specs(SH.opt_specs(state.opt_state, fsdp, m, ep),
               JSH.opt_specs(jstate.opt_state, fsdp, m, ep))


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("seq_shard", [True, False])
def test_cache_specs_equal_jax(name, mesh, seq_shard):
    _, _, _, (caches, jcaches) = trees(name)
    from repro_torch.launch.mesh import batch_axes

    baxes = batch_axes(SH.MESHES[mesh])
    got = SH.cache_specs(caches, baxes, seq_shard)
    same_specs(got, JSH.cache_specs(jcaches, baxes, seq_shard))
    assert SH.cache_specs(SH.cache_leaves(caches), baxes, seq_shard) == got


@pytest.mark.parametrize("mesh", MESHES)
def test_batch_specs_equal_jax(mesh):
    from repro_torch.launch.mesh import batch_axes

    baxes = batch_axes(SH.MESHES[mesh])
    b = {"tokens": np.zeros((256, 4096), np.int32),
         "labels": np.zeros((256, 4096), np.int32),
         "mask": np.zeros((256, 4096), np.float32), "scalar": np.float32(0)}
    jb = {k: jax.ShapeDtypeStruct(np.shape(v), v.dtype) for k, v in b.items()}
    same_specs(SH.batch_specs(b, baxes), JSH.batch_specs(jb, baxes))


@pytest.mark.parametrize("name", ["granite-3-8b", "deepseek-v3-671b",
                                  "recurrentgemma-9b", "mamba2-370m"])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("compress", [False, True])
def test_state_specs_equal_jax(name, mesh, compress):
    model, jp, _, _ = trees(name)
    m = SH.MESHES[mesh]
    opt = T.adafactor(T.warmup_cosine(1e-4, 1, 10))
    state = T.init_train_state(model, opt, compress=compress)
    jstate = jax.eval_shape(lambda p: JT.init_train_state(
        p, JT.adafactor(JT.warmup_cosine(1e-4, 1, 10)), compress=compress), jp)
    got = SH.state_specs(state, True, m, True)
    want = JSH.state_specs(jstate, True, m, True)
    same_specs(got.params, want.params)
    same_specs(got.opt_state, want.opt_state)
    assert got.step == tuple(want.step) == ()
    if compress:
        same_specs(got.ef, want.ef)
    else:
        assert got.ef is None and want.ef is None


@pytest.mark.parametrize("name", ARCHS)
def test_device_bytes_split_the_leaves(name):
    """On ``card`` (1 x 1) a device holds every byte; on ``single`` each
    leaf's shard is its shape over the validated spec's axis sizes."""
    model, jp, _, _ = trees(name)
    leaves = SH.tree_leaves(model)
    full = sum(int(np.prod(SH.leaf_shape(v))) * 2 for v in leaves.values())
    for mesh in ("card", "single"):
        m = SH.MESHES[mesh]
        specs = SH.param_specs(model, True, m)
        jspecs = jax_leaves(JSH.param_specs(jp, True, m), specs=True)
        want = 0
        for k, leaf in jax_leaves(jp).items():
            ok = jax_validate_spec(leaf.shape, jspecs[k], m)
            div = [int(np.prod([m.shape[a] for a in ((s,) if isinstance(s, str) else s)]))
                   if s is not None else 1 for s in ok]
            want += int(np.prod([d // q for d, q in zip(leaf.shape, div)])) * 2
        got = SH.device_bytes(leaves, specs, m)
        assert got == want
        assert (got == full) == (mesh == "card")


def test_meshes():
    assert {k: m.shape for k, m in SH.MESHES.items()} == {
        "single": {"data": 16, "model": 16},
        "multi": {"pod": 2, "data": 16, "model": 16},
        "card": {"data": 1, "model": 1}}
    assert SH.MESHES["multi"].size == 512 and SH.MESHES["card"].size == 1
    from repro.launch.mesh import AXES

    assert SH.MESHES["single"].axis_names == AXES["single"]
    assert SH.MESHES["multi"].axis_names == AXES["multi"]


_AXES = st.sampled_from([None, "data", "model", "pod", ("data", "model"),
                         ("pod", "data")])


@settings(max_examples=200, deadline=None)
@given(shape=st.lists(st.integers(1, 96), min_size=0, max_size=4),
       spec=st.lists(_AXES, min_size=0, max_size=5),
       mesh=st.sampled_from(sorted(SH.MESHES)))
def test_validate_spec_equals_jax(shape, spec, mesh):
    m = SH.MESHES[mesh]
    if any(s is not None and set((s,) if isinstance(s, str) else s) - set(m.shape)
           for s in spec):
        return
    got = validate_spec(tuple(shape), tuple(spec), m)
    assert got == tuple(jax_validate_spec(tuple(shape), P(*spec), m))
    assert len(got) == len(spec)
