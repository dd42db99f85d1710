"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

* Per-device argument bytes equal the sum worked out from the JAX
  package's own trees and specs: ``jax.eval_shape`` of its params,
  ``TrainState`` (its optimizer rule) or caches, ``repro.launch.sharding``'s
  specs validated by ``repro.ft.remesh.validate_spec`` on the same mesh
  shape, the int32 batch.
* The cell's JSON keys: the JAX cell's where they mean the same, the
  port's new ones (``counted_flops``, ``argument_bytes_by_part``,
  ``build_s``, ``run_s``); ``collectives`` 0 on ``card``, a decode
  cell's rank-0 bytes and temporaries on ``single``/``multi``; the CLI.
* The counted-FLOP band: counted / ``analytic_cell`` within
  [0.80, 1.30] for all ten smoke configs, and at most 1 for the dense
  attention stacks, where the count only leaves work out (the embedding
  gather, elementwise ops, and the last projection of each layer, which
  non-reentrant remat never recomputes); granite-3-8b and
  h2o-danube-1.8b at their published configs, 4 x 1024, within
  [0.85, 1.00] (measured 0.9109 and 0.8934).
* The live-bytes count on ``meta`` equals the same count of the same step
  run on the CPU with real tensors.
* A train cell on ``single``/``multi`` (granite-3-8b, dbrx-132b; and
  mamba2-370m on ``single``) runs rank 0's split step on ``StandInMesh``:
  temporaries counted, collective bytes equal to
  ``roofline.collect.train_step_bytes`` call by call, counted FLOPs rank
  0's own.
* Its ``sp`` and ``ep`` variants (granite-3-8b ``sp`` and
  deepseek-v3-671b ``ep`` at ``train_4k`` on ``single``, dbrx-132b
  ``sp,ep`` on ``multi``) run the step with ``seq_parallel`` /
  ``ep_stationary``: collectives ``collect``'s, granite's sums over
  ``model`` at most 1/7 of the cell's without ``sp``, deepseek's expert
  banks adding nothing to the params' gathers or the gradients'
  reduce-scatters.
* A prefill and a decode cell on ``single`` and ``multi`` (probe 1, and
  the ``nofsdp``, ``int8kv``, ``sp`` and ``ep`` variants) run rank 0's
  serving step on ``StandInMesh``: temporaries counted, collective bytes
  equal to ``roofline.collect.serve_step_bytes`` call by call, counted
  FLOPs rank 0's own; ``nofsdp`` gathers no weight a split part owns.
"""

import json
import math

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro import train as JT
from repro.ft.remesh import validate_spec as jax_validate_spec
from repro.launch import sharding as JSH
from repro.models import model as JM
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as SH
from repro_torch.roofline import analyze as A
from torch_threads import one_torch_thread  # noqa: F401

JAX_CELL_KEYS = {"arch", "shape", "mesh", "kind", "seq", "global_batch",
                 "devices", "n_params", "layer_groups", "probe_layers",
                 "variant", "memory_analysis", "collectives"}
PORT_KEYS = {"build_s", "run_s", "argument_bytes_by_part", "counted_flops",
             "counted_flops_total"}
DENSE = ("granite-3-8b", "h2o-danube-1.8b", "musicgen-large", "qwen1.5-32b",
         "qwen2-72b")
BAND_SMOKE = (0.80, 1.30)
BAND_FULL = (0.85, 1.00)


def jax_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of a JAX shape tree under its spec tree."""
    total = 0
    flat_s = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
    for leaf, spec in zip(jax.tree_util.tree_leaves(tree), flat_s, strict=True):
        ok = jax_validate_spec(tuple(leaf.shape), spec, mesh)
        local = [d // int(np.prod([mesh.shape[a] for a in
                                   ((s,) if isinstance(s, str) else s)]))
                 if s is not None else d for d, s in zip(leaf.shape, ok)]
        total += int(np.prod(local)) * np.dtype(leaf.dtype).itemsize
    return total


def jax_cfg(arch, probe):
    cfg = jconfigs.get(arch)
    if cfg.family == "hybrid":
        return cfg.replace(n_layers=probe * len(cfg.block_pattern))
    if cfg.first_dense_layers:
        return cfg.replace(n_layers=cfg.first_dense_layers + probe)
    return cfg.replace(n_layers=probe)


@pytest.mark.parametrize("arch,shape,mesh", [
    ("granite-3-8b", ("train", 256, 32), "single"),
    ("deepseek-v3-671b", ("train", 128, 64), "multi"),
    ("recurrentgemma-9b", ("train", 128, 32), "single"),
    ("h2o-danube-1.8b", ("decode", 2048, 32), "multi"),
    ("mamba2-370m", ("prefill", 128, 16), "single"),
    ("qwen2-72b", ("train", 128, 16), "card"),
])
def test_argument_bytes_equal_jax_specs(arch, shape, mesh):
    res = dryrun.run_cell(arch, shape, mesh, probe_layers=1)
    m = SH.MESHES[mesh]
    baxes = tuple(a for a in m.axis_names if a != "model")
    kind, seq, batch = shape
    cfg = jax_cfg(arch, 1)
    jp = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), cfg))
    toks = {"tokens": jax.ShapeDtypeStruct((batch, seq if kind != "decode" else 1),
                                           np.int32)}
    if kind == "train":
        toks["labels"] = toks["tokens"]
        opt = (JT.adafactor if cfg.n_params() > 40e9 else JT.adamw)(
            JT.warmup_cosine(1e-4, 100, 10_000))
        assert res["optimizer"] == ("adafactor" if cfg.n_params() > 40e9 else "adamw")
        st = jax.eval_shape(lambda: JT.init_train_state(
            JM.init_params(jax.random.PRNGKey(0), cfg), opt))
        want = {"params": jax_bytes(st.params, JSH.param_specs(st.params, cfg.fsdp, m), m),
                "opt_state": jax_bytes(st.opt_state,
                                       JSH.opt_specs(st.opt_state, cfg.fsdp, m), m),
                "step": 4, "ef": 0}
    else:
        want = {"params": jax_bytes(jp, JSH.param_specs(jp, cfg.fsdp, m), m)}
        if kind == "decode":
            caches = jax.eval_shape(lambda: JM.init_caches(cfg, batch, seq))
            want["caches"] = jax_bytes(
                caches, JSH.cache_specs(caches, baxes, cfg.seq_shard_decode), m)
            want["pos"] = 4
    want["batch" if kind == "train" else "tokens"] = jax_bytes(
        toks, JSH.batch_specs(toks, baxes), m)
    assert res["argument_bytes_by_part"] == want
    assert res["memory_analysis"]["argument_size_in_bytes"] == sum(want.values())
    if kind == "train":
        assert res["memory_analysis"]["alias_size_in_bytes"] == \
            want["params"] + want["opt_state"] + want["step"]


@pytest.mark.parametrize("mesh", dryrun.MESH_KINDS)
def test_cell_json_keys(mesh, tmp_path):
    res = dryrun.run_cell("mamba2-370m", ("decode", 256, 8), mesh, str(tmp_path),
                          probe_layers=1, variant="int8kv")
    saved = json.loads((tmp_path / "mamba2-370m__decode_8x256__"
                        f"{mesh}__probe1__int8kv.json").read_text())
    assert res.pop("_path").endswith(".json")
    assert saved == json.loads(json.dumps(res))
    assert set(saved) == JAX_CELL_KEYS | PORT_KEYS
    assert set(saved["memory_analysis"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "alias_size_in_bytes", "temp_size_in_bytes"}
    assert saved["devices"] == {"single": 256, "multi": 512, "card": 1}[mesh]
    assert saved["memory_analysis"]["temp_size_in_bytes"] > 0
    if mesh == "card":
        assert saved["collectives"] == {"total_bytes": 0.0}
    else:
        by_call = saved["collectives"]["by_call"]
        assert saved["collectives"]["total_bytes"] == sum(by_call.values()) > 0
        assert by_call["conv_gather"] > 0
    assert saved["counted_flops"] * saved["devices"] == saved["counted_flops_total"] > 0
    row = A.roofline_row(saved, configs.get("mamba2-370m").replace(n_layers=1))
    assert row.counted_flops == saved["counted_flops"]
    assert row.t_collective is not None


def test_train_cell_follows_the_jax_rules():
    # one layer of granite has 0.6e9 params: AdamW, and no accumulation
    # (the rule accumulates above 4e9)
    res = dryrun.run_cell("granite-3-8b", ("train", 64, 32), "single", probe_layers=1)
    assert res["n_params"] < 4e9
    assert res["optimizer"] == "adamw" and res["grad_accum"] == 1
    res = dryrun.run_cell("granite-3-8b", ("train", 64, 32), "single",
                          probe_layers=1, variant="ga2", optimizer="adafactor")
    assert res["optimizer"] == "adafactor" and res["grad_accum"] == 2
    with pytest.raises(ValueError, match="unknown variant"):
        dryrun.run_cell("granite-3-8b", "train_4k", "card", variant="fast")


def _band(arch, shape, monkeypatch=None):
    cfg = configs.get_smoke(arch) if monkeypatch else configs.get(arch)
    if monkeypatch:
        monkeypatch.setattr(configs, "get", lambda name: cfg)
    res = dryrun.run_cell(arch, shape, "card",
                          optimizer="adafactor" if arch == "granite-3-8b" else None)
    ana = A.analytic_cell(cfg, shape[0], shape[1], shape[2], res["grad_accum"])
    return res, res["counted_flops"] / ana["flops"]


@pytest.mark.parametrize("arch", sorted(configs.names()))
def test_counted_flops_band_smoke(arch, monkeypatch):
    _, ratio = _band(arch, ("train", 64, 4), monkeypatch)
    assert BAND_SMOKE[0] <= ratio <= BAND_SMOKE[1], ratio
    if arch in DENSE:
        assert ratio <= 1.0


@pytest.mark.parametrize("arch", ["granite-3-8b", "h2o-danube-1.8b"])
def test_counted_flops_band_full_width(arch):
    res, ratio = _band(arch, ("train", 1024, 4))
    assert BAND_FULL[0] <= ratio <= BAND_FULL[1], ratio
    parts = res["argument_bytes_by_part"]
    assert parts["params"] == 2 * configs.get(arch).n_params()


def test_meta_live_bytes_equal_a_real_cpu_step():
    """The same smoke step on ``meta`` and on the CPU with real tensors
    under one ``StepCounter`` each: equal FLOPs and peak."""
    import torch

    from repro_torch import train as T
    from repro_torch.models import model as M

    cfg = configs.get_smoke("granite-3-8b")
    out = {}
    for dev in ("meta", "cpu"):
        gen = torch.Generator().manual_seed(0) if dev == "cpu" else None
        params = M.init_params(cfg, gen, dev)
        opt = T.adafactor(T.warmup_cosine(1e-4, 1, 10))
        state = T.init_train_state(params, opt)
        step = T.build_train_step(cfg, opt, donate=True)
        batch = {k: torch.zeros((2, 32), dtype=torch.int32, device=dev)
                 for k in ("tokens", "labels")}
        c = dryrun.StepCounter()
        with c:
            step(state, batch)
        out[dev] = (c.flops, c.peak)
    assert out["meta"] == out["cpu"] and out["cpu"][1] > 0


def test_cli(tmp_path, capsys):
    assert dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                        "--mesh", "single", "--probe-layers", "1",
                        "--out", str(tmp_path)]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["collective_bytes_per_device"] > 0 and "collectives" not in res
    assert (tmp_path / "mamba2-370m__decode_32k__single__probe1.json").exists()
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                     "--mesh", "v5e"])


@pytest.mark.parametrize("arch,mesh", [
    ("granite-3-8b", "single"), ("dbrx-132b", "single"),
    ("granite-3-8b", "multi"), ("dbrx-132b", "multi"),
    ("mamba2-370m", "single")])
def test_train_cell_runs_rank_0_of_the_split_step(arch, mesh):
    """A train cell on a production mesh runs rank 0's split step on the
    stand-in: its temporaries are counted, its collective bytes are
    ``train_step_bytes``' call by call, and its FLOPs are rank 0's own
    count of that step.  mamba2-370m's 32 SSD heads split over the 16
    ranks along ``model``."""
    import torch

    from repro_torch import train as T
    from repro_torch.models import model as M
    from repro_torch.roofline.collect import train_step_bytes

    shape = ("train", 32, 64)
    res = dryrun.run_cell(arch, shape, mesh, probe_layers=1)
    assert res["memory_analysis"]["temp_size_in_bytes"] > 0
    cfg = configs.get(arch).replace(n_layers=1)
    opt = T.adamw(T.warmup_cosine(1e-4, 100, 10_000))
    shapes = T.init_train_state(M.init_params(cfg, None, "meta"), opt)
    m = SH.MESHES[mesh]
    want = train_step_bytes(cfg, shapes, m, grad_accum=res["grad_accum"],
                            batch=(64, 32))
    assert res["collectives"] == {"total_bytes": float(want.pop("total_bytes")),
                                  "by_call": want}
    rank = dryrun.StandInMesh(m.shape)
    pls = SH.named(rank, SH.state_specs(shapes, cfg.fsdp, rank), shapes)
    state = T.init_train_state(M.init_params(cfg, None, "meta",
                                             placements=pls.params), opt)
    step = T.build_train_step(cfg, opt, grad_accum=res["grad_accum"],
                              grad_shardings=pls.params, donate=True)
    batch = {k: torch.empty((64, 32), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    counter = dryrun.StepCounter()
    with counter:
        step(state, batch)
    assert res["counted_flops"] == counter.flops
    assert res["counted_flops_total"] == counter.flops * res["devices"]
    if arch == "mamba2-370m":
        assert step.split_kinds["layers"] == {"ssm": {"heads": True}}
        assert res["collectives"]["by_call"]["norm_sum"] > 0


# the calls over ``model`` of the split compute (everything but the
# params', the gradients' and the optimizer's)
MODEL_CALLS = {"tp_fwd", "tp_bwd", "moe_combine", "vocab_embed", "vocab_ce",
               "norm_sum", "lru_gather", "sp_gather", "sp_scatter"}


def _cell_bytes(arch, shape, mesh, res, **opts):
    """``train_step_bytes`` of the dry run's cell (its probe config, its
    optimizer and accumulation) with ``opts``."""
    from repro_torch import train as T
    from repro_torch.configs import SHAPES
    from repro_torch.models import model as M
    from repro_torch.roofline.collect import train_step_bytes

    _, seq, rows = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = configs.get(arch)
    cfg = cfg.replace(n_layers=(cfg.first_dense_layers or 0) + 1)
    opt = getattr(T, res["optimizer"])(T.warmup_cosine(1e-4, 100, 10_000))
    shapes = T.init_train_state(M.init_params(cfg, None, "meta"), opt)
    return cfg, shapes, train_step_bytes(cfg, shapes, SH.MESHES[mesh],
                                         grad_accum=res["grad_accum"],
                                         batch=(rows, seq), **opts)


@pytest.mark.parametrize("arch,shape,mesh,variant", [
    ("granite-3-8b", "train_4k", "single", "sp"),
    ("deepseek-v3-671b", "train_4k", "single", "ep"),
    ("dbrx-132b", ("train", 32, 64), "multi", "sp,ep")])
def test_sp_ep_train_cells_run_rank_0_of_the_split_step(arch, shape, mesh, variant):
    """The ``sp``/``ep`` train cells on the production meshes run rank 0's
    step with the options (no longer refused): temporaries counted,
    collectives equal to ``collect``'s model of the options.  granite's
    sums over ``model`` fall to at most 1/7 of the cell's without ``sp``
    (about 2/m of the whole-sequence sums at m = 16); deepseek's 256
    experts, one a rank, add nothing to ``param_gather`` or
    ``grad_reduce_scatter``: those calls' bytes are the cell's without
    ``ep`` less what its expert banks cost there, counted here from their
    shapes (each bank's (E/16, D/16, F) slice gathered over ``data`` in
    the layer's forward and recompute, its gradient reduce-scattered
    once)."""
    opts = {"seq_parallel": "sp" in variant, "ep_stationary": "ep" in variant}
    res = dryrun.run_cell(arch, shape, mesh, probe_layers=1, variant=variant)
    assert res["variant"] == variant
    assert res["memory_analysis"]["temp_size_in_bytes"] > 0
    cfg, shapes, want = _cell_bytes(arch, shape, mesh, res, **opts)
    assert res["collectives"] == {"total_bytes": float(want.pop("total_bytes")),
                                  "by_call": want}
    _, _, base = _cell_bytes(arch, shape, mesh, res)
    if arch == "granite-3-8b":
        sums = lambda got: sum(v for k, v in got.items() if k in MODEL_CALLS)
        assert 0 < sums(want) <= sums(base) / 7
        assert not {"tp_fwd", "tp_bwd"} & set(want)
    if arch == "deepseek-v3-671b":
        ga, banks = res["grad_accum"], 0
        for path, leaf in SH.tree_leaves(shapes.params).items():
            if path[-1] in ("wi", "wg", "wo") and len(SH.leaf_shape(leaf)) == 4:
                layers, e, a, b = SH.leaf_shape(leaf)
                banks += layers * (e // 16) * a * b // 16 * 2 * 15
        assert banks > 0
        assert want["param_gather"] == base["param_gather"] - 2 * ga * banks
        assert want["grad_reduce_scatter"] == base["grad_reduce_scatter"] - ga * banks
        assert {"ep_dispatch", "ep_return"} <= set(want)
    if arch == "dbrx-132b":
        assert {"sp_gather", "sp_scatter", "ep_gather", "ep_scatter"} <= set(want)


@pytest.mark.parametrize("arch,kind,mesh,variant", [
    ("granite-3-8b", "prefill", "single", ""),
    ("granite-3-8b", "decode", "single", ""),
    ("granite-3-8b", "prefill", "multi", "sp"),
    ("granite-3-8b", "decode", "multi", "nofsdp,int8kv"),
    ("deepseek-v3-671b", "decode", "single", ""),
    ("dbrx-132b", "prefill", "multi", "ep"),
    ("recurrentgemma-9b", "decode", "multi", "")])
def test_serve_cells_run_rank_0_of_the_placed_step(arch, kind, mesh, variant):
    """A prefill or decode cell on a production mesh runs rank 0's serving
    step on the stand-in (``serve.engine.on_mesh``): its temporaries are
    counted, its collective bytes are ``serve_step_bytes``' call by call,
    and its FLOPs are rank 0's own count.  A decode step over caches whose
    sequence is split over ``model`` merges its softmax there
    (``decode_combine``); ``nofsdp`` leaves the weights of the split parts
    where they are (granite's whole k/v projections, whose 8 kv heads do
    not split over 16 ranks, are all it gathers)."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.roofline.collect import serve_step_bytes
    from repro_torch.serve.engine import on_mesh

    shape = (kind, 64, 32)
    res = dryrun.run_cell(arch, shape, mesh, probe_layers=1, variant=variant)
    assert res["memory_analysis"]["temp_size_in_bytes"] > 0
    cfg = configs.get(arch)
    cfg = cfg.replace(n_layers=(cfg.first_dense_layers or 0) + 1) \
        if cfg.family != "hybrid" else cfg.replace(n_layers=len(cfg.block_pattern))
    if "int8kv" in variant:
        cfg = cfg.replace(kv_cache_dtype="int8")
    if "nofsdp" in variant:
        cfg = cfg.replace(fsdp=False)
    m = SH.MESHES[mesh]
    params = M.init_params(cfg, None, "meta")
    opts = {"seq_parallel": "sp" in variant, "ep_stationary": "ep" in variant}
    want = serve_step_bytes(cfg, params, m, kind, 32, 64, max_len=64, **opts)
    assert res["collectives"] == {"total_bytes": float(want.pop("total_bytes")),
                                  "by_call": want}
    if kind == "decode":
        assert want["decode_combine"] > 0
    if "nofsdp" in variant:
        kv = SH.tree_leaves(params)
        whole_kv = sum(SH.leaf_shape(kv[p])[0] * math.prod(SH.leaf_shape(kv[p])[1:])
                       // 16 * 15 * 2 for p in kv if p[-2] in ("wk", "wv"))
        assert want["param_gather"] == whole_kv
    if "sp" in variant:
        assert {"sp_gather", "sp_scatter"} <= set(want) and "tp_fwd" not in want
    if "ep" in variant:
        # dbrx's 16 experts, one a rank along model, their ffn columns over data
        assert {"ep_gather", "ep_scatter"} <= set(want)
    # rank 0's FLOPs: the same step counted here
    rank = dryrun.StandInMesh(m.shape)
    from repro_torch.launch.mesh import batch_axes

    baxes = batch_axes(m)
    pls = SH.named(rank, SH.param_specs(params, cfg.fsdp, m, opts["ep_stationary"]),
                   params)
    c_leaves = SH.cache_leaves(M.init_caches(cfg, 32, 64, "meta"))
    c_pls = SH.named(rank, SH.cache_specs(c_leaves, baxes, cfg.seq_shard_decode),
                     c_leaves)
    local = M.init_params(cfg, None, "meta", placements=pls)
    rows = SH.Placement(rank, (baxes, None), (32, 1)).local_shape[0]
    counter = dryrun.StepCounter()
    with counter, torch.inference_mode(), on_mesh(local, cfg, pls, c_pls, 64, **opts):
        if kind == "prefill":
            M.prefill(local, cfg, tokens=torch.empty((rows, 64), dtype=torch.long,
                                                     device="meta"), max_len=64)
        else:
            caches = M.init_caches(cfg, 32, 64, "meta", placements=c_pls)
            M.decode_step(local, cfg, caches, torch.empty((rows, 1), dtype=torch.long,
                                                          device="meta"), 63)
    assert res["counted_flops"] == counter.flops > 0
