"""The LM train step's compute split over ``model`` on a
``launch.mesh.ProcessMesh`` (``models.shard``'s ``to_model``/
``from_model``/``model_allsum``/``model_concat``, column/row-parallel
attention and MLP, MLA, experts a rank, mamba2's SSD heads, RG-LRU's
width, vocab-parallel embedding and loss, ``train.step``'s gathers over
the batch axes), held to the JAX package's sharded step and to the port's
one-process step on the CPU.

One module fixture spawns 4 gloo ranks once on a 2x2 (``data``,
``model``) grid (``launch.procs``; the rank side is
``tests/tpsplit_cases.py``), while a JAX subprocess with forced host
devices runs the same cases on a 2x2 ``jax.sharding.Mesh`` with
``grad_shardings``, from the same first state (the port's seed-0 model,
handed over as numpy) on the same batches.  Each case runs 3 steps of an
f32 smoke config (mamba2's in SSD chunks of 8 on both sides), batch 4 x
16:

* loss and ``grad_norm`` within rtol 1e-5 of both references at every
  step, the ranks' metrics bitwise equal;
* the params gathered after the steps within 1e-5 (Adafactor) or 1e-4
  (AdamW: its early updates are sign-like, so a gradient near 0 moves
  its element up to 2 lr apart) of max|p| of each leaf of both;
* the wire bytes of every step equal to ``roofline.collect.
  train_step_bytes``, call by call, and the step's ``split_kinds``
  table splitting what the config's units allow;
* granite's, mamba2's and recurrentgemma's rank 0 step (on
  ``dryrun.StandInMesh``, which receives what the real rank 0 does)
  counts under 0.35 of the one-process step's FLOPs
  (``dryrun.StepCounter``);
* ``shard.constrain`` raises on a ``heads``, ``ssd_heads`` or ``act_bsf``
  activation whose ``model`` dim is whole where the split gives a rank
  1/m of it;
* the two crossings of the mamba2 and RG-LRU splits on small tensors:
  forward bits equal on every rank, each rank's gradient its slice of
  the whole computation's.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import meshtrain_cases as MC
import tpsplit_cases as C
from repro_torch import convert
from repro_torch import train as T
from repro_torch.launch import dryrun, procs
from repro_torch.launch import sharding as SH
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
from repro.launch import sharding as SH
from repro.launch.mesh import make_mesh
from repro.models import model as JM
import meshtrain_cases as MC
import tpsplit_cases as C

A = json.load(open(sys.argv[1]))
init = np.load(A["init"])
res, js = {}, {}

def key(path):
    return "/".join(str(getattr(q, "key", getattr(q, "idx", q))) for q in path)

mesh = make_mesh(C.GRID, C.AXES)
for cid, (arch, opt_name) in C.CASES.items():
    cfg = jconfigs.get_smoke(arch).replace(param_dtype="float32", compute_dtype="float32",
                                           **C.WIDTHS.get(arch, {}))
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), cfg))
    params = jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(init[f"{arch}/{key(p)}"]), shapes)
    opt = getattr(JT, opt_name)(JT.warmup_cosine(*MC.SCHEDULE))
    state = JT.init_train_state(params, opt)
    state = jax.device_put(state, SH.named(mesh, SH.state_specs(state, cfg.fsdp), state))
    gsh = SH.named(mesh, SH.param_specs(state.params, cfg.fsdp), state.params)
    step = jax.jit(JT.build_train_step(cfg, opt, grad_shardings=gsh))
    pipe = TokenPipeline(cfg.vocab_size, C.BATCH, C.SEQ, seed=0)
    loss, gn = [], []
    for i in range(C.STEPS):
        state, m = step(state, {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()})
        loss.append(float(m["loss"]))
        gn.append(float(m["grad_norm"]))
    js[cid] = {"loss": loss, "grad_norm": gn}
    for p, v in jax.tree_util.tree_leaves_with_path(state.params):
        res[f"{cid}/{key(p)}"] = np.asarray(v)
np.savez(sys.argv[2], json=json.dumps(js), **res)
print("JAX_TPSPLIT_DONE")
"""


def _flat(tree, prefix=()) -> dict:
    """path -> leaf of a nested dict/list numpy tree."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], prefix + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(x, prefix + (i,)).items()}
    return {prefix: tree}


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(JAX's arrays and JSON, the ranks' results, the one-process port's
    results)."""
    tmp = tmp_path_factory.mktemp("tpsplit")
    init = {}
    for arch in {a for a, _ in C.CASES.values()}:
        model = MC.init_state(C.case_cfg(arch), "adamw").params
        for path, v in _flat(convert.lm_params_to_numpy(model)).items():
            init[arch + "/" + "/".join(map(str, path))] = v
    np.savez(tmp / "init.npz", **init)
    with ThreadPoolExecutor(1) as ex:
        jax_run = ex.submit(run_jax, _JAX, {"init": str(tmp / "init.npz")},
                            tmp / "jax.npz")
        ranks = procs.run(C.rank_main, 4, (), backend="gloo", device="cpu",
                          timeout_s=DEADLINE_S)
        one = {cid: C.one_process(cid) for cid in C.CASES}
        jax_side = jax_run.result()
    return jax_side, ranks, one


CASE_IDS = list(C.CASES)


@pytest.mark.parametrize("cid", CASE_IDS)
def test_metrics_match_jax_and_one_process(sides, cid):
    (_, js), ranks, one = sides
    got = ranks[0]["cases"][cid]
    for ref in (js[cid], one[cid]):
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=1e-5)
    for r in ranks[1:]:
        assert r["cases"][cid]["loss"] == got["loss"]
        assert r["cases"][cid]["grad_norm"] == got["grad_norm"]


@pytest.mark.parametrize("cid", CASE_IDS)
def test_params_match_jax_and_one_process(sides, cid):
    (arrays, _), ranks, one = sides
    ptol = 1e-4 if C.CASES[cid][1] == "adamw" else 1e-5
    got = _flat(ranks[0]["cases"][cid]["params"])
    want_one = _flat(one[cid]["params"])
    assert list(got) == list(want_one)
    for path, a in got.items():
        for w in (want_one[path], arrays[f"{cid}/" + "/".join(map(str, path))]):
            assert np.abs(a - w).max() <= ptol * np.abs(w).max(), path
    for r in ranks[1:]:
        assert all(np.array_equal(a, b) for a, b in
                   zip(_flat(r["cases"][cid]["params"]).values(), got.values()))


@pytest.mark.parametrize("cid", CASE_IDS)
def test_wire_bytes_equal_collect(sides, cid):
    _, ranks, _ = sides
    arch, opt_name = C.CASES[cid]
    cfg = C.case_cfg(arch)
    want = train_step_bytes(cfg, MC.init_state(cfg, opt_name),
                            SH.MeshShape(dict(zip(C.AXES, C.GRID))),
                            batch=(C.BATCH, C.SEQ))
    total = want.pop("total_bytes")
    assert {"tp_fwd", "tp_bwd", "vocab_embed", "vocab_ce"} <= set(want)
    for r in ranks:
        for step in r["cases"][cid]["wire_bytes"]:
            assert step == want
            assert sum(step.values()) == total


def test_split_kinds_follow_the_units(sides):
    """The step's table: everything splits at m = 2 but the kv heads of
    the kv = 1 configs; granite-3-8b's published vocab (49,155) keeps its
    tables whole; mamba2 splits by its SSD heads (the published config's
    32, where ``n_heads`` is 1)."""
    from repro_torch import configs
    from repro_torch.models import shard

    _, ranks, _ = sides
    got = {cid: ranks[0]["cases"][cid]["split_kinds"] for cid in CASE_IDS}
    assert got["granite_adamw"] == {
        "layers": {"attn_mlp": {"heads": True, "kv": True, "mlp": True}},
        "vocab": True}
    assert got["deepseek_adafactor"]["layers"] == {
        "attn_mlp": {"heads": True, "mlp": True},
        "attn_moe": {"heads": True, "experts": True, "shared": True}}
    assert got["paligemma_adamw"]["layers"]["attn_mlp"]["kv"] is False
    assert got["recurrentgemma_adamw"]["layers"]["rec"] == {"lru": True, "mlp": True}
    assert got["recurrentgemma_adamw"]["layers"]["attn"]["heads"] is True
    assert got["mamba2_adamw"] == {"layers": {"ssm": {"heads": True}}, "vocab": True}
    mamba = configs.get("mamba2-370m")
    assert mamba.n_heads == 1 and shard.ssd_heads(mamba) == 32
    assert shard.split_kinds(mamba, 16)["layers"]["ssm"] == {"heads": True}
    assert shard.split_kinds(mamba, 64)["layers"]["ssm"] == {"heads": False}
    assert shard.split_kinds(configs.get("recurrentgemma-9b"), 16)["layers"][
        "rec"] == {"lru": True, "mlp": True}
    full = shard.split_kinds(configs.get("granite-3-8b"), 2)
    assert full["vocab"] is False and full["layers"]["attn_mlp"]["kv"] is True
    assert shard.split_kinds(configs.get("granite-3-8b"), 16)["layers"][
        "attn_mlp"] == {"heads": True, "kv": False, "mlp": True}


def _rank_flops(cid: str) -> dict:
    """{one process: counted FLOPs, rank 0: ...} of the case's step at its
    batch, rank 0's on the stand-in of the 2x2 grid (its wire bytes the
    real rank 0's), and the stand-in's wire bytes."""
    arch, _ = C.CASES[cid]
    cfg = C.case_cfg(arch)
    batch = {k: torch.as_tensor(v, device="meta") for k, v in
             MC.batch_at(cfg, 0).items()}
    counts = {}
    for grid in (None, dict(zip(C.AXES, C.GRID))):
        opt = MC.optimizer("adamw")
        shapes = T.init_train_state(M.init_params(cfg, None, "meta"), opt)
        if grid is None:
            state, kw = shapes, {}
        else:
            mesh = dryrun.StandInMesh(grid)
            pls = SH.named(mesh, SH.state_specs(shapes, cfg.fsdp, mesh), shapes)
            state = T.init_train_state(
                M.init_params(cfg, None, "meta", placements=pls.params), opt)
            kw = {"grad_shardings": pls.params}
        step = T.build_train_step(cfg, opt, donate=True, **kw)
        counter = dryrun.StepCounter()
        with counter:
            step(state, batch)
        counts[grid is None] = counter.flops
    return counts, dict(mesh.stats.wire_bytes)


def test_rank_flops_under_a_third(sides):
    """Rank 0's step of granite on the stand-in of the 2x2 grid: its wire
    bytes are the real rank 0's, and it counts under 0.35 of the
    one-process step's FLOPs (about 1/4: the batch and the compute each
    split in two)."""
    _, ranks, _ = sides
    counts, wire = _rank_flops("granite_adamw")
    assert wire == ranks[0]["cases"]["granite_adamw"]["wire_bytes"][0]
    assert counts[False] < 0.35 * counts[True], counts


@pytest.mark.parametrize("cid", ["mamba2_adamw", "recurrentgemma_adamw"])
def test_rank_flops_under_a_third_ssm_rec(sides, cid):
    """The same for mamba2 (SSD heads split; B and C whole on every rank)
    and recurrentgemma (RG-LRU width and MLPs split)."""
    _, ranks, _ = sides
    counts, wire = _rank_flops(cid)
    assert wire == ranks[0]["cases"][cid]["wire_bytes"][0]
    assert counts[False] < 0.35 * counts[True], counts


def test_constrain_checks_the_rank_shape(sides):
    _, ranks, _ = sides
    for r in ranks:
        got = r["constrain"]
        assert got["half"] and got["unchecked"]
        assert got["whole"] and "leaves 2" in got["whole"]
        assert got["shards"] == (2, r["coords"][1])


def test_constrain_checks_ssd_heads_and_lru_width(sides):
    _, ranks, _ = sides
    for r in ranks:
        got = r["constrain"]
        assert got["ssd_half"] and got["bsf_half"]
        assert got["ssd_whole"] and "'ssd_heads'" in got["ssd_whole"] \
            and "leaves 4" in got["ssd_whole"]
        assert got["bsf_whole"] and "'act_bsf'" in got["bsf_whole"] \
            and "leaves 32" in got["bsf_whole"]


def test_crossings_match_the_whole_computation(sides):
    """``model_allsum`` (the gated norm's sum of squares) and
    ``model_concat`` (the RG-LRU gates' input): the forward bits equal on
    every rank (the concatenation the whole activation itself), each
    rank's gradient its slice of the whole computation's, in f32; one
    (2, 3) f32 sum a call each way and one (2, 3, 4) f32 slice each way
    on the wire."""
    from repro_torch.models.blocks import rms_norm

    _, ranks, _ = sides
    x, g, w, scale = C.crossing_inputs()
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    torch.autograd.backward(rms_norm(scale, xs[0]), g)
    torch.autograd.backward(xs[1] @ w, g)
    first = ranks[0]["crossings"]
    np.testing.assert_allclose(first["allsum"][..., 0],
                               (x * x).sum(-1).numpy(), rtol=1e-6)
    assert np.array_equal(first["concat"], x.numpy())
    for r in ranks:
        got = r["crossings"]
        assert np.array_equal(got["allsum"], first["allsum"])
        assert np.array_equal(got["concat"], first["concat"])
        own = slice(4 * r["coords"][1], 4 * r["coords"][1] + 4)
        for key, t in (("norm_grad", xs[0]), ("concat_grad", xs[1])):
            np.testing.assert_allclose(got[key], t.grad[..., own].numpy(),
                                       rtol=1e-5, atol=1e-6)
        assert got["wire_bytes"] == {"norm_sum": 3 * 24, "lru_gather": 2 * 96}


@pytest.mark.parametrize("smoke,heads", [(True, False), (False, True)])
def test_train_cli_mesh_json_shows_the_ssm_split(monkeypatch, capsys, smoke, heads):
    """``launch.train --mesh single``'s closing JSON carries the step's
    ``split_kinds`` with mamba2's ``ssm.heads`` part: under a world of the
    mesh's 256 ranks (stubbed: the mesh is ``dryrun.StandInMesh`` of the
    16 x 16 grid, and ``train_on_mesh`` builds the split step on ``meta``
    and runs no step), the smoke config's 8 SSD heads do not divide by 16
    ranks along ``model``, the published config's 32 do."""
    import json

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as train_cli

    def fake_train(mesh, cfg, **kw):
        opt = train_cli.make_optimizer(kw["optimizer"], kw["lr"], kw["steps"])
        shapes = T.init_train_state(M.init_params(cfg, None, "meta"), opt)
        pls = SH.named(mesh, SH.param_specs(shapes.params, cfg.fsdp, mesh),
                       shapes.params)
        step = T.build_train_step(cfg, opt, grad_shardings=pls)
        return {"losses": [1.0, 0.5], "step_ms": [10.0, 9.0],
                "split_kinds": step.split_kinds}

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "256")
    monkeypatch.setattr(mesh_mod, "make_process_mesh", lambda shape, axes, **k:
                        dryrun.StandInMesh(dict(zip(axes, shape))))
    monkeypatch.setattr(train_cli, "train_on_mesh", fake_train)
    argv = ["--arch", "mamba2-370m", "--mesh", "single", "--device", "cpu",
            "--steps", "2"] + (["--smoke"] if smoke else [])
    assert train_cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["processes"] == 256
    assert out["split_kinds"]["layers"] == {"ssm": {"heads": heads}}
