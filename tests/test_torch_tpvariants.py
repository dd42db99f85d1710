"""Sequence parallelism (``seq_parallel``) and expert-stationary MoE
(``ep_stationary``) in the LM train step split over ``model`` on a
``launch.mesh.ProcessMesh``, held to the JAX package's sharded step under
the same options and to the port's one-process step on the CPU.

One module fixture spawns 4 gloo ranks once on a 2x2 (``data``,
``model``) grid (``launch.procs``; the rank side is
``tests/tpvariants_cases.py``), while a JAX subprocess with forced host
devices runs the same cases on a 2x2 ``jax.sharding.Mesh``: the state
placed by ``state_specs(..., mesh, ep_stationary=)``, the step traced
under ``use_mesh_axes(..., seq_parallel=, ep_stationary=)`` with
``grad_shardings``, from the same first state (the port's seed-0 model,
handed over as numpy) on the same batches.  Each case runs 3 steps of an
f32 smoke config, batch 4 x 16 (``tpvariants_cases.CASES``: granite sp,
deepseek sp+ep, dbrx ep with its 4 experts over the whole grid and with 6
over ``model``, mamba2 sp, recurrentgemma sp):

* loss and ``grad_norm`` within rtol 1e-5 of both references at every
  step, the ranks' metrics bitwise equal;
* the params gathered after the steps within 1e-5 (Adafactor) or 1e-4
  (AdamW) of max|p| of each leaf of both, the ranks' bitwise equal;
* the wire bytes of every step equal to ``roofline.collect.
  train_step_bytes(..., seq_parallel=, ep_stationary=)``, call by call;
  under ``ep_stationary`` the expert banks add no byte to
  ``param_gather`` or ``grad_reduce_scatter``;
* the bytes each rank holds equal to ``device_bytes`` of the specs;
* ``shard.constrain`` on a spec entry of a tuple of axes (a MoE buffer
  whose experts spread over ``data`` and ``model``);
* a placed ``ep_stationary`` state's checkpoint: the one-process save's
  files, byte for byte.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import meshtrain_cases as MC
import tpvariants_cases as C
from repro_torch import convert
from repro_torch.launch import procs
from repro_torch.launch import sharding as SH
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
from repro.models import shard
import meshtrain_cases as MC
import tpvariants_cases as C

A = json.load(open(sys.argv[1]))
init = np.load(A["init"])
res, js = {}, {}

def key(path):
    return "/".join(str(getattr(q, "key", getattr(q, "idx", q))) for q in path)

mesh = make_mesh(C.GRID, C.AXES)
for cid, (arch, opt_name, sp, ep, widths) in C.CASES.items():
    cfg = jconfigs.get_smoke(arch).replace(param_dtype="float32", compute_dtype="float32",
                                           **widths)
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), cfg))
    params = jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(init[f"{cid}/{key(p)}"]), shapes)
    opt = getattr(JT, opt_name)(JT.warmup_cosine(*MC.SCHEDULE))
    state = JT.init_train_state(params, opt)
    specs = SH.state_specs(state, cfg.fsdp, mesh, ep_stationary=ep)
    state = jax.device_put(state, SH.named(mesh, specs, state))
    gsh = SH.named(mesh, SH.param_specs(state.params, cfg.fsdp, mesh, ep_stationary=ep),
                   state.params)
    step = jax.jit(JT.build_train_step(cfg, opt, grad_shardings=gsh))
    pipe = TokenPipeline(cfg.vocab_size, C.BATCH, C.SEQ, seed=0)
    loss, gn = [], []
    with shard.use_mesh_axes(mesh, ("data",), "model", seq_parallel=sp,
                             ep_stationary=ep):
        for i in range(C.STEPS):
            state, m = step(state, {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()})
            loss.append(float(m["loss"]))
            gn.append(float(m["grad_norm"]))
    js[cid] = {"loss": loss, "grad_norm": gn}
    for p, v in jax.tree_util.tree_leaves_with_path(state.params):
        res[f"{cid}/{key(p)}"] = np.asarray(v)
np.savez(sys.argv[2], json=json.dumps(js), **res)
print("JAX_TPVARIANTS_DONE")
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
    results, the directory of the ranks' save)."""
    tmp = tmp_path_factory.mktemp("tpvariants")
    init = {}
    for cid in C.CASES:
        model = MC.init_state(C.case_cfg(cid), "adamw").params
        for path, v in _flat(convert.lm_params_to_numpy(model)).items():
            init[cid + "/" + "/".join(map(str, path))] = v
    np.savez(tmp / "init.npz", **init)
    with ThreadPoolExecutor(1) as ex:
        jax_run = ex.submit(run_jax, _JAX, {"init": str(tmp / "init.npz")},
                            tmp / "jax.npz")
        ranks = procs.run(C.rank_main, 4, (str(tmp / "placed"),), backend="gloo",
                          device="cpu", timeout_s=DEADLINE_S)
        one = {cid: C.one_process(cid) for cid in C.CASES}
        jax_side = jax_run.result()
    return jax_side, ranks, one, tmp


CASE_IDS = list(C.CASES)
EP_IDS = [cid for cid in CASE_IDS if C.options(cid)["ep_stationary"]]
GRID = SH.MeshShape(dict(zip(C.AXES, C.GRID)))


def _collect(cid: str, **opts) -> dict:
    cfg = C.case_cfg(cid)
    return train_step_bytes(cfg, MC.init_state(cfg, C.CASES[cid][1]), GRID,
                            batch=(C.BATCH, C.SEQ), **opts)


@pytest.mark.parametrize("cid", CASE_IDS)
def test_metrics_match_jax_and_one_process(sides, cid):
    (_, js), ranks, one, _ = sides
    got = ranks[0]["cases"][cid]
    for ref in (js[cid], one[cid]):
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=1e-5)
    for r in ranks[1:]:
        assert r["cases"][cid]["loss"] == got["loss"]
        assert r["cases"][cid]["grad_norm"] == got["grad_norm"]


@pytest.mark.parametrize("cid", CASE_IDS)
def test_params_match_jax_and_one_process(sides, cid):
    (arrays, _), ranks, one, _ = sides
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
    """Every step's bytes, call by call, are ``collect``'s model of the
    case's options: under ``seq_parallel`` the sequence's crossings in
    place of the sums over ``model`` (no ``tp_fwd`` or ``tp_bwd``), under
    ``ep_stationary`` the dispatch calls of its branch."""
    _, ranks, _, _ = sides
    opts = C.options(cid)
    want = _collect(cid, **opts)
    total = want.pop("total_bytes")
    if opts["seq_parallel"]:
        assert {"sp_gather", "sp_scatter"} <= set(want)
        assert not {"tp_fwd", "tp_bwd", "moe_combine"} & set(want)
    if opts["ep_stationary"]:
        spread = C.case_cfg(cid).n_experts % 4 == 0
        assert {"ep_dispatch", "ep_return"} <= set(want) if spread else \
            {"ep_gather", "ep_scatter"} <= set(want)
    for r in ranks:
        for step in r["cases"][cid]["wire_bytes"]:
            assert step == want
            assert sum(step.values()) == total


@pytest.mark.parametrize("cid", EP_IDS)
def test_ep_moves_no_expert_bank(cid):
    """Under ``ep_stationary`` the expert banks add nothing to the params'
    gathers and the gradients' reduce-scatters: those calls' bytes are the
    step's without the option less what the banks cost there (each bank
    slice (E/m, D/d, F) gathered over ``data`` in each layer's forward and
    recompute, its gradient reduce-scattered once), counted from the
    banks' shapes here."""
    opts = C.options(cid)
    cfg = C.case_cfg(cid)
    with_ep = _collect(cid, **opts)
    without = _collect(cid, seq_parallel=opts["seq_parallel"])
    banks = 0
    for path, leaf in SH.tree_leaves(MC.init_state(cfg, "adamw").params).items():
        if path[-1] in ("wi", "wg", "wo") and len(SH.leaf_shape(leaf)) == 4:
            layers, e, a, b = SH.leaf_shape(leaf)
            banks += layers * (e // 2) * a * b // 2 * 4
    assert banks > 0
    assert with_ep["param_gather"] == without["param_gather"] - 2 * banks
    assert with_ep["grad_reduce_scatter"] == without["grad_reduce_scatter"] - banks


@pytest.mark.parametrize("cid", CASE_IDS)
def test_held_bytes_equal_device_bytes(sides, cid):
    _, ranks, _, _ = sides
    for r in ranks:
        got = r["cases"][cid]
        assert got["held_bytes"] == got["device_bytes"]


def test_split_kinds_report_the_options(sides):
    _, ranks, _, _ = sides
    for cid in CASE_IDS:
        got = ranks[0]["cases"][cid]["split_kinds"]
        for opt, on in C.options(cid).items():
            assert got.get(opt, False) is on, (cid, opt)
    assert ranks[0]["cases"]["deepseek_sp_ep_adafactor"]["split_kinds"]["layers"][
        "attn_moe"] == {"heads": True, "experts": True, "shared": True}


def test_constrain_takes_a_tuple_of_axes(sides):
    _, ranks, _, _ = sides
    for r in ranks:
        got = r["constrain"]
        assert got["spread"] and got["model_only"] and got["stream"]
        assert "('data', 'model')" in got["spread_whole"] and "leaves 2" in got["spread_whole"]
        assert "'model'" in got["model_only_whole"] and "leaves 3" in got["model_only_whole"]


def test_placed_ep_checkpoint_equals_one_process_save(sides):
    from repro_torch.checkpoint import manager as ckpt

    _, ranks, _, tmp = sides
    cfg = C.case_cfg(C.CKPT_CASE)
    one = ckpt.save(MC.init_state(cfg, C.CASES[C.CKPT_CASE][1]), str(tmp / "one"), 1)
    placed = ranks[0]["saved"]
    names = sorted(p.name for p in (tmp / "one" / "step_00000001").iterdir())
    assert names == sorted(p.name for p in (tmp / "placed" / "step_00000001").iterdir())
    for name in names:
        assert (tmp / "one" / "step_00000001" / name).read_bytes() == \
            (tmp / "placed" / "step_00000001" / name).read_bytes(), name
    assert one.endswith("step_00000001") and placed.endswith("step_00000001")


def test_seq_parallel_needs_m_to_divide_the_sequence():
    """A sequence ``model`` does not divide keeps the stream whole (as
    ``validate_spec`` drops the axis): the bytes are the step's without
    ``seq_parallel``."""
    cid = "granite_sp_adamw"
    cfg = C.case_cfg(cid)
    state = MC.init_state(cfg, "adamw")
    odd = {o: train_step_bytes(cfg, state, GRID, batch=(C.BATCH, C.SEQ - 1),
                               seq_parallel=o) for o in (True, False)}
    assert odd[True] == odd[False] and "tp_fwd" in odd[True]
    assert "sp_gather" in _collect(cid, seq_parallel=True)
