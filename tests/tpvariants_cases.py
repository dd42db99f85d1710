"""Rank side of ``tests/test_torch_tpvariants.py``; no tests of its own.

The spawned ranks import this module by name (``tests/`` is on their
``sys.path``) and run :func:`rank_main` on a 2x2 (``data``, ``model``)
``ProcessMesh``; the test process runs the one-process steps with
:func:`one_process`.  Neither side imports JAX.  The seed-0 states,
schedule and batches are ``meshtrain_cases``'.
"""

from __future__ import annotations

import torch

import meshtrain_cases as MC
from repro_torch import convert
from repro_torch import train as T
from repro_torch.launch import sharding as SH

AXES, GRID = MC.AXES, MC.GRID
BATCH, SEQ, STEPS = MC.BATCH, MC.SEQ, MC.STEPS

# id -> (arch, optimizer, seq_parallel, ep_stationary, the smoke config's
# changes on both sides): sp over granite's split attention and MLP and
# its split vocab; sp and ep together over deepseek's MLA, shared expert
# and MTP head (4 experts on 4 ranks: one a rank); dbrx's ep with its 4
# experts over (data, model), and with 6 over model and their ffn columns
# over data; mamba2's SSD heads (16 tokens in chunks of 8) and
# recurrentgemma's RG-LRU and attention layers under sp; granite's sp
# with an odd vocab (131), whose tables stay whole, as the published
# 49,155's do
CASES = {
    "granite_sp_adamw": ("granite-3-8b", "adamw", True, False, {}),
    "granite_sp_vocab131_adafactor": ("granite-3-8b", "adafactor", True, False,
                                      {"vocab_size": 131}),
    "deepseek_sp_ep_adafactor": ("deepseek-v3-671b", "adafactor", True, True, {}),
    "dbrx_ep_adafactor": ("dbrx-132b", "adafactor", False, True, {}),
    "dbrx6_ep_adafactor": ("dbrx-132b", "adafactor", False, True, {"n_experts": 6}),
    "mamba2_sp_adamw": ("mamba2-370m", "adamw", True, False, {"ssm_chunk": 8}),
    "recurrentgemma_sp_adamw": ("recurrentgemma-9b", "adamw", True, False, {}),
}
CKPT_CASE = "deepseek_sp_ep_adafactor"


def case_cfg(cid: str):
    arch, _, _, _, widths = CASES[cid]
    return MC.case_cfg(arch, **widths)


def options(cid: str) -> dict:
    _, _, sp, ep, _ = CASES[cid]
    return {"seq_parallel": sp, "ep_stationary": ep}


def one_process(cid: str) -> dict:
    """The case's steps without ``grad_shardings``, in this process."""
    opt_name = CASES[cid][1]
    cfg = case_cfg(cid)
    state = MC.init_state(cfg, opt_name)
    step = T.build_train_step(cfg, MC.optimizer(opt_name))
    out = {"loss": [], "grad_norm": []}
    for i in range(STEPS):
        state, m = step(state, MC.batch_at(cfg, i))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["params"] = convert.lm_params_to_numpy(state.params)
    return out


def train_case(mesh, cid: str) -> dict:
    """The case's steps on ``mesh`` with its options: every metric, the
    wire bytes of each step, the step's table, the bytes held against
    ``device_bytes`` and the params gathered after."""
    opt_name = CASES[cid][1]
    opts = options(cid)
    cfg = case_cfg(cid)
    state = MC.init_state(cfg, opt_name)
    specs = SH.state_specs(state, cfg.fsdp, mesh, ep_stationary=opts["ep_stationary"])
    want = sum(SH.device_bytes(SH.tree_leaves(getattr(state, f)), getattr(specs, f), mesh)
               for f in ("params", "opt_state"))
    pls = SH.named(mesh, specs, state)
    placed = SH.place(state, pls)
    step = T.build_train_step(cfg, MC.optimizer(opt_name), grad_shardings=pls.params,
                              donate=True, **opts)
    out = {"loss": [], "grad_norm": [], "wire_bytes": [], "split_kinds": step.split_kinds,
           "held_bytes": SH.held_bytes(placed), "device_bytes": want + 4}
    for i in range(STEPS):
        mesh.stats.reset()
        placed, m = step(placed, MC.batch_at(cfg, i))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["wire_bytes"].append(dict(mesh.stats.wire_bytes))
    out["params"] = convert.lm_params_to_numpy(SH.gather(placed.params, pls.params))
    return out


def constrain_case(mesh) -> dict:
    """``shard.constrain`` of a MoE buffer under ``ep_stationary``: 8
    experts over (data, model) leave a rank 2 (its (G, 2, C, D) passes,
    (G, 4, C, D) raises), 6 over model alone leave it 3; an ``act_bsd``
    stream of the rank's S/m tokens under ``seq_parallel`` passes."""
    from repro_torch.models import shard

    def refused(shape, kind, whole):
        try:
            shard.constrain(torch.zeros(shape), kind, whole)
        except ValueError as e:
            return str(e)
        return None

    out = {}
    with shard.use_mesh_axes(mesh, ("data",), "model", seq_parallel=True,
                             ep_stationary=True):
        buf = torch.zeros(4, 2, 3, 8)
        out["spread"] = shard.constrain(buf, "moe_buf", 8) is buf
        out["spread_whole"] = refused((4, 4, 3, 8), "moe_buf", 8)
        buf6 = torch.zeros(4, 3, 3, 8)
        out["model_only"] = shard.constrain(buf6, "moe_buf", 6) is buf6
        out["model_only_whole"] = refused((4, 6, 3, 8), "moe_buf", 6)
        x = torch.zeros(2, 8, 16)
        out["stream"] = shard.constrain(x, "act_bsd") is x
    return out


def save_case(mesh, root: str) -> str:
    """:data:`CKPT_CASE`'s seed state placed with ``ep_stationary`` and
    saved by every rank (``checkpoint.save(placements=)``); the step's
    directory."""
    from repro_torch.checkpoint import manager as ckpt

    opt_name = CASES[CKPT_CASE][1]
    cfg = case_cfg(CKPT_CASE)
    state = MC.init_state(cfg, opt_name)
    pls = SH.named(mesh, SH.state_specs(state, cfg.fsdp, mesh, ep_stationary=True),
                   state)
    return ckpt.save(SH.place(state, pls), root, 1, placements=pls)


def rank_main(rank, root: str) -> dict:
    torch.set_num_threads(1)
    mesh = rank.mesh(GRID, AXES)
    return {"cases": {cid: train_case(mesh, cid) for cid in CASES},
            "constrain": constrain_case(mesh), "saved": save_case(mesh, root),
            "coords": mesh.coords}
