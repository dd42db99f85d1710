"""Rank side of ``tests/test_torch_tpsplit.py``; no tests of its own.

The spawned ranks import this module by name (``tests/`` is on their
``sys.path``) and run :func:`rank_main` on a 2x2 (``data``, ``model``)
``ProcessMesh``; the test process runs the one-process steps with
:func:`one_process`.  Neither side imports JAX.  The configs, seed-0
states, schedule and batches are ``meshtrain_cases``'.
"""

from __future__ import annotations

import torch

import meshtrain_cases as MC
from repro_torch import convert
from repro_torch import train as T
from repro_torch.launch import sharding as SH

AXES, GRID = MC.AXES, MC.GRID
BATCH, SEQ, STEPS = MC.BATCH, MC.SEQ, MC.STEPS

# id -> (arch, optimizer): attention and MLP split with kv split
# (granite), experts a rank (dbrx), MLA, a shared expert and the MTP head
# (deepseek), kv = 1 whole on every rank and tied tables (paligemma),
# split attention layers beside whole rec layers (recurrentgemma)
CASES = {
    "granite_adamw": ("granite-3-8b", "adamw"),
    "dbrx_adafactor": ("dbrx-132b", "adafactor"),
    "deepseek_adafactor": ("deepseek-v3-671b", "adafactor"),
    "paligemma_adamw": ("paligemma-3b", "adamw"),
    "recurrentgemma_adamw": ("recurrentgemma-9b", "adamw"),
}


def one_process(cid: str) -> dict:
    """The case's steps without ``grad_shardings``, in this process."""
    arch, opt_name = CASES[cid]
    cfg = MC.case_cfg(arch)
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
    """The case's split steps on ``mesh``: every metric, the wire bytes of
    each step, the step's table and the params gathered after."""
    arch, opt_name = CASES[cid]
    cfg = MC.case_cfg(arch)
    state = MC.init_state(cfg, opt_name)
    pls = SH.named(mesh, SH.state_specs(state, cfg.fsdp, mesh), state)
    placed = SH.place(state, pls)
    step = T.build_train_step(cfg, MC.optimizer(opt_name), grad_shardings=pls.params,
                              donate=True)
    out = {"loss": [], "grad_norm": [], "wire_bytes": [],
           "split_kinds": step.split_kinds}
    for i in range(STEPS):
        mesh.stats.reset()
        placed, m = step(placed, MC.batch_at(cfg, i))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["wire_bytes"].append(dict(mesh.stats.wire_bytes))
    out["params"] = convert.lm_params_to_numpy(SH.gather(placed.params, pls.params))
    return out


def constrain_case(mesh) -> dict:
    """``shard.constrain`` of a rank's heads: its H/m heads pass, the
    whole H raises; off the split (``whole`` not given) nothing is
    checked."""
    from repro_torch.models import shard

    out = {}
    with shard.use_mesh_axes(mesh, ("data",), "model"):
        half = torch.zeros(2, 8, 2, 16)
        out["half"] = shard.constrain(half, "heads", 4) is half
        out["unchecked"] = shard.constrain(torch.zeros(2, 8, 4, 16), "heads") is not None
        try:
            shard.constrain(torch.zeros(2, 8, 4, 16), "heads", 4)
            out["whole"] = None
        except ValueError as e:
            out["whole"] = str(e)
        out["shards"] = (shard.model_shards(), shard.model_index())
    return out


def rank_main(rank) -> dict:
    torch.set_num_threads(1)
    mesh = rank.mesh(GRID, AXES)
    return {"cases": {cid: train_case(mesh, cid) for cid in CASES},
            "constrain": constrain_case(mesh), "coords": mesh.coords}
