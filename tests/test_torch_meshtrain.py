"""The LM train state placed on a ``launch.mesh.ProcessMesh`` and trained
there (``launch.sharding.named``/``place``/``gather``,
``build_train_step(grad_shardings=)``, ``ft.remesh.remesh_restore``,
``launch.train``'s ``train_on_mesh`` and ``--mesh``,
``roofline.collect``), held to the JAX package's sharded step and to the
port's one-process step on the CPU.

One module fixture spawns 4 gloo ranks once (``launch.procs``; the rank
side is ``tests/meshtrain_cases.py``), while a JAX subprocess with forced
host devices runs the same cases on a 2x2 ``jax.sharding.Mesh``
(``SH.named`` + ``jax.jit``, with ``grad_shardings``), from the same
first state (the port's seed-0 model, handed over as numpy) on the same
batches.  Each case runs 3 steps of granite-3-8b's or dbrx-132b's f32
smoke config, batch 4 x 16:

* loss within rtol 1e-5 of both references at every step; ``grad_norm``
  within rtol 1e-5 (1e-4 with the int8 compression, whose codes may flip
  at a rounding boundary, as in tests/test_torch_train.py); the ranks'
  metrics bitwise equal;
* the params, gathered after the 3 steps, within 1e-5 of max|p| of each
  leaf of the one-process port's and of JAX's (1e-3 with the int8
  compression: a flipped code moves a gradient by a quantum); every
  rank's slices bitwise the gathered state's at its index;
* each rank's held bytes equal to ``sharding.device_bytes``; the wire
  bytes of every step equal to ``roofline.collect.train_step_bytes``;
* ``remesh_restore`` of a checkpoint saved from the 2x2 grid and of one
  the JAX package wrote, onto 4x1 and 1x4 ranks: slices bitwise the
  checkpoint's leaves, ``demoted`` equal to JAX's ``remesh_restore``;
* ``train_on_mesh`` (the body of ``launch.train --mesh``) against the
  one-process CLI's losses, both in f32; ``--mesh`` exits 2 naming the
  ranks needed.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import meshtrain_cases as C
from repro import configs as jconfigs
from repro import train as JT
from repro.checkpoint import manager as jckpt
from repro.models import model as JM
from repro_torch import configs, convert
from repro_torch import train as T
from repro_torch.checkpoint import manager as ckpt
from repro_torch.launch import dryrun, procs
from repro_torch.launch import sharding as SH
from repro_torch.launch import train as train_cli
from repro_torch.models import model as M
from repro_torch.roofline.collect import train_step_bytes
from test_torch_dist_cases import run_jax
from torch_threads import one_torch_thread  # noqa: F401

DEADLINE_S = 300.0

_JAX = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs as jconfigs
from repro import train as JT
from repro.data import TokenPipeline
from repro.ft.remesh import remesh_restore
from repro.launch import sharding as SH
from repro.launch.mesh import make_mesh
from repro.models import model as JM
import meshtrain_cases as C

A = json.load(open(sys.argv[1]))
init = np.load(A["init"])
res, js = {}, {"remesh": {}}

def key(path):
    return "/".join(str(getattr(q, "key", getattr(q, "idx", q))) for q in path)

def cfg_of(arch, widths=None):
    return jconfigs.get_smoke(arch).replace(param_dtype="float32",
                                           compute_dtype="float32", **(widths or {}))

mesh = make_mesh(C.GRID, C.AXES)
for cid, (arch, opt_name, kw) in C.CASES.items():
    cfg = cfg_of(arch)
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), cfg))
    params = jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(init[f"{arch}/{key(p)}"]), shapes)
    opt = getattr(JT, opt_name)(JT.warmup_cosine(*C.SCHEDULE))
    state = JT.init_train_state(params, opt, compress=kw.get("compress_grads", False))
    state = jax.device_put(state, SH.named(mesh, SH.state_specs(state, cfg.fsdp), state))
    gsh = SH.named(mesh, SH.param_specs(state.params, cfg.fsdp), state.params)
    step = jax.jit(JT.build_train_step(cfg, opt, grad_shardings=gsh, **kw))
    pipe = TokenPipeline(cfg.vocab_size, C.BATCH, C.SEQ, seed=0)
    loss, gn = [], []
    for i in range(C.STEPS):
        state, m = step(state, {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()})
        loss.append(float(m["loss"]))
        gn.append(float(m["grad_norm"]))
    js[cid] = {"loss": loss, "grad_norm": gn}
    for p, v in jax.tree_util.tree_leaves_with_path(state.params):
        res[f"{cid}/{key(p)}"] = np.asarray(v)

cfg = cfg_of(C.REMESH_ARCH, C.REMESH_WIDTHS)
for src, d in A["jax_ckpts"].items():
    opt = getattr(JT, C.REMESH_OPT[src])(JT.warmup_cosine(*C.SCHEDULE))
    like = jax.eval_shape(lambda: JT.init_train_state(
        JM.init_params(jax.random.PRNGKey(0), cfg), opt))
    for mname, shape in C.REMESH_MESHES.items():
        m = make_mesh(shape, C.AXES)
        _, step, demoted = remesh_restore(like, d, m, SH.state_specs(like, cfg.fsdp))
        js["remesh"][f"{src}|{mname}"] = [[list(s), list(p)] for s, p in demoted]
np.savez(sys.argv[2], json=json.dumps(js), **res)
print("JAX_MESHTRAIN_DONE")
"""


def _flat(tree, prefix=()) -> dict:
    """path -> leaf of a nested dict/list numpy tree."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], prefix + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(x, prefix + (i,)).items()}
    return {prefix: tree}


def _jax_ckpt(cfg_kw, opt_name, d):
    """A checkpoint the JAX package writes of its own first state."""
    cfg = jconfigs.get_smoke(C.REMESH_ARCH).replace(
        param_dtype="float32", compute_dtype="float32", **cfg_kw)
    opt = getattr(JT, opt_name)(JT.warmup_cosine(*C.SCHEDULE))
    params = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    jckpt.save(JT.init_train_state(params, opt), d, 0)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(JAX's arrays and JSON, the ranks' results, the one-process port's
    results, the checkpoint directories)."""
    tmp = tmp_path_factory.mktemp("meshtrain")
    init = {}
    for arch in {a for a, _, _ in C.CASES.values()}:
        model = C.init_state(C.case_cfg(arch), "adamw").params
        for path, v in _flat(convert.lm_params_to_numpy(model)).items():
            init[arch + "/" + "/".join(map(str, path))] = v
    np.savez(tmp / "init.npz", **init)
    dirs = {"port": str(tmp / "ckpt_port"), "jax": str(tmp / "ckpt_jax"),
            "jax_adamw": str(tmp / "ckpt_jax_adamw")}
    _jax_ckpt(C.REMESH_WIDTHS, C.REMESH_OPT["jax"], dirs["jax"])
    _jax_ckpt(C.REMESH_WIDTHS, C.REMESH_OPT["port"], dirs["jax_adamw"])
    args = {"init": str(tmp / "init.npz"),
            "jax_ckpts": {"jax": dirs["jax"], "port": dirs["jax_adamw"]}}
    with ThreadPoolExecutor(1) as ex:
        jax_run = ex.submit(run_jax, _JAX, args, tmp / "jax.npz")
        ranks = procs.run(C.rank_main, 4, (dirs,), backend="gloo",
                          device="cpu", timeout_s=DEADLINE_S)
        one = {cid: C.one_process(cid) for cid in C.CASES}
        jax_side = jax_run.result()
    return jax_side, ranks, one, dirs


CASE_IDS = list(C.CASES)


def _tols(cid):
    """(grad_norm rtol, params atol as a share of max|p| after 3 steps).
    The gradients differ from the references' in the order of f32 sums;
    AdamW's early updates are sign-like (m^ / sqrt(v^) near +-1), so an
    element whose gradient sits near 0 moves up to 2 lr apart: 1e-4, the
    tolerance tests/test_torch_train.py holds AdamW's params to after an
    update; Adafactor's update is smooth in g: 1e-5; a flipped int8 code
    moves a gradient by a quantum: 1e-3."""
    if C.CASES[cid][2].get("compress_grads"):
        return 1e-4, 1e-3
    return 1e-5, (1e-4 if C.CASES[cid][1] == "adamw" else 1e-5)


@pytest.mark.parametrize("cid", CASE_IDS)
def test_metrics_match_jax_and_one_process(sides, cid):
    (_, js), ranks, one, _ = sides
    gtol, _ = _tols(cid)
    got = ranks[0]["cases"][cid]
    for ref in (js[cid], one[cid]):
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=gtol)
    for r in ranks[1:]:
        assert r["cases"][cid]["loss"] == got["loss"]
        assert r["cases"][cid]["grad_norm"] == got["grad_norm"]


@pytest.mark.parametrize("cid", CASE_IDS)
def test_params_match_jax_and_one_process(sides, cid):
    (arrays, _), ranks, one, _ = sides
    _, ptol = _tols(cid)
    got = _flat(ranks[0]["cases"][cid]["params"])
    want_one = _flat(one[cid]["params"])
    assert list(got) == list(want_one)
    for path, a in got.items():
        for w in (want_one[path], arrays[f"{cid}/" + "/".join(map(str, path))]):
            assert np.abs(a - w).max() <= ptol * np.abs(w).max(), path
    for r in ranks[1:]:
        assert all(np.array_equal(a, b) for a, b in
                   zip(_flat(r["cases"][cid]["params"]).values(), got.values()))


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_update_on_identical_grads_matches_one_process(sides, opt_name):
    """Clip and one update on the same gradients, placed on 2x2 and in one
    process: the optimizers' tolerances (f32 1e-6 of max|p|), grad_norm
    rtol 1e-6."""
    _, ranks, _, _ = sides
    want = C.update_case(None, opt_name)
    for r in ranks:
        got = r["update"][opt_name]
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-6)
        for path, w in want["params"].items():
            assert np.abs(got["params"][path] - w).max() <= 1e-6 * np.abs(w).max(), path


def test_dtensor_and_constrain_on_a_process_mesh(sides):
    """DTensor's ``full_tensor()`` of each placed slice is the whole leaf;
    ``constrain`` returns its input and validates the kind's spec against
    the mesh (JAX's ``KeyError`` s), and off a ProcessMesh it checks
    nothing."""
    from repro_torch.models import shard

    _, ranks, _, _ = sides
    for r in ranks:
        assert r["dtensor"]
        got = r["constrain"]
        assert got["identity"] and got["shards"] == 2
        assert "nope" in got["kind"] and "pod" in got["axis"]
    x = torch.zeros(2, 3)
    with shard.use_mesh_axes(SH.MESHES["single"], ("data",), "model"):
        assert shard.constrain(x, "nope") is x and shard.batch_shards() == 1
    assert shard.constrain(x, "act_bsd") is x


@pytest.mark.parametrize("cid", CASE_IDS)
def test_rank_slices_and_bytes(sides, cid):
    """Each rank holds exactly its slices of the gathered state, and as
    many bytes as ``device_bytes`` says a device holds."""
    _, ranks, _, _ = sides
    full = ranks[0]["cases"][cid]
    whole = {("params",) + k: v for k, v in _flat(full["params"]).items()}
    whole |= {("opt_state",) + k: v for k, v in _flat(full["opt_state"]).items()}
    for r in ranks:
        got = r["cases"][cid]
        assert got["held_bytes"] == got["device_bytes"]
        assert got["convert_round_trip"]
        for path, held in got["held"].items():
            if path[0] == "ef":
                continue
            idx = tuple(slice(a, b) for a, b in got["index"][path])
            assert np.array_equal(held, whole[path][idx]), path


@pytest.mark.parametrize("cid", CASE_IDS)
def test_wire_bytes_equal_collect(sides, cid):
    _, ranks, _, _ = sides
    arch, opt_name, kw = C.CASES[cid]
    cfg = C.case_cfg(arch)
    state = C.init_state(cfg, opt_name, kw.get("compress_grads", False))
    want = train_step_bytes(cfg, state, SH.MeshShape(dict(zip(C.AXES, C.GRID))),
                            grad_accum=kw.get("grad_accum", 1),
                            compress_grads=kw.get("compress_grads", False),
                            batch=(C.BATCH, C.SEQ))
    total = want.pop("total_bytes")
    for r in ranks:
        for step in r["cases"][cid]["wire_bytes"]:
            assert step == want
            assert sum(step.values()) == total


@pytest.mark.parametrize("src", ["port", "jax"])
@pytest.mark.parametrize("mname", list(C.REMESH_MESHES))
def test_remesh_restore(sides, src, mname):
    (_, js), ranks, _, dirs = sides
    whole = _checkpoint_leaves(dirs[src])
    want_demoted = [(tuple(s), tuple(p)) for s, p in js["remesh"][f"{src}|{mname}"]]
    for r in ranks:
        got = r["remesh"][(src, mname)]
        assert got["step"] == (1 if src == "port" else 0)
        assert [(tuple(s), tuple(p)) for s, p in got["demoted"]] == want_demoted
        for path, held in got["held"].items():
            idx = tuple(slice(a, b) for a, b in got["index"][path])
            name = "." + path[0] + "/" + "/".join(map(str, path[1:]))
            assert np.array_equal(held, whole[name][idx]), path
    assert want_demoted                      # the odd widths demote leaves


def _checkpoint_leaves(d) -> dict:
    """flat key -> the whole leaf of the newest step under ``d``."""
    step = ckpt.latest_step(d)
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        man = json.load(f)
    return {k: np.load(os.path.join(d, f"step_{step:08d}", m["file"]))
            for k, m in man["leaves"].items()}


def test_train_on_mesh_matches_the_one_process_cli(sides, capsys, monkeypatch):
    """In f32 (the ranks' ``train_on_mesh`` and the CLI's ``--smoke``
    config): the split step rounds its partial sums over ``model``
    differently from one process, which bf16 shows at 1e-4."""
    _, ranks, _, _ = sides
    f32 = C.case_cfg("granite-3-8b")
    monkeypatch.setattr(configs, "get_smoke", lambda name: f32)
    assert train_cli.main(["--arch", "granite-3-8b", "--smoke", "--device",
                           "cpu", "--steps", "3", "--batch", str(C.BATCH),
                           "--seq", str(C.SEQ)]) == 0
    out = capsys.readouterr().out
    one = json.loads(out[out.index("{"):])
    for r in ranks:
        np.testing.assert_allclose(r["cli"]["losses"], one["losses"], rtol=1e-5)
        assert r["cli"]["losses"] == ranks[0]["cli"]["losses"]
        assert r["cli"]["held_bytes"] == r["cli"]["device_bytes"]


def test_mesh_cli_exits_2_naming_the_ranks(sides, capsys, monkeypatch):
    _, ranks, _, _ = sides
    for r in ranks:
        for mesh, need in (("single", 256), ("multi", 512)):
            code, err = r["mesh_exit"][mesh]
            assert code == 2 and f"needs {need} ranks" in err[0]
            assert "the process group has 4" in err[0]
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(SystemExit) as exc:
        train_cli.main(["--arch", "granite-3-8b", "--smoke", "--mesh",
                        "multi", "--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "needs 512 ranks" in err and "no torchrun environment" in err


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_dry_run_train_cell_has_collective_bytes(mesh):
    """The dry run's train cells on the production meshes carry the
    collect model's bytes, so the roofline has a collective term."""
    from repro_torch.roofline import analyze as A

    res = dryrun.run_cell("granite-3-8b", ("train", 64, 512), mesh, probe_layers=1)
    coll = res["collectives"]
    assert coll["total_bytes"] > 0
    cfg = configs.get("granite-3-8b").replace(n_layers=1)
    m = SH.MESHES[mesh]
    state = T.init_train_state(M.init_params(cfg, None, "meta"), T.adamw(
        T.warmup_cosine(1e-4, 100, 10_000)))
    want = train_step_bytes(cfg, state, m, grad_accum=res["grad_accum"],
                            batch=(512, 64))
    assert coll == {"total_bytes": float(want.pop("total_bytes")), "by_call": want}
    row = A.roofline_row(res, cfg)
    assert row.t_collective == coll["total_bytes"] / A.LINK_BW
