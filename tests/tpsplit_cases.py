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
# split RG-LRU layers and their MLPs beside split attention layers
# (recurrentgemma), split SSD heads (mamba2: 8 of them)
CASES = {
    "granite_adamw": ("granite-3-8b", "adamw"),
    "dbrx_adafactor": ("dbrx-132b", "adafactor"),
    "deepseek_adafactor": ("deepseek-v3-671b", "adafactor"),
    "paligemma_adamw": ("paligemma-3b", "adamw"),
    "recurrentgemma_adamw": ("recurrentgemma-9b", "adamw"),
    "mamba2_adamw": ("mamba2-370m", "adamw"),
}
# the smoke configs' changes on both sides: mamba2's 16 tokens in chunks
# of 8, so the inter-chunk recurrence runs twice
WIDTHS = {"mamba2-370m": {"ssm_chunk": 8}}


def case_cfg(arch: str):
    return MC.case_cfg(arch, **WIDTHS.get(arch, {}))


def one_process(cid: str) -> dict:
    """The case's steps without ``grad_shardings``, in this process."""
    arch, opt_name = CASES[cid]
    cfg = case_cfg(arch)
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
    cfg = case_cfg(arch)
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
    checked.  The same for mamba2's SSD heads (``ssd_heads``, (B, L, H,
    P)) and an RG-LRU width (``act_bsf``, (B, S, W))."""
    from repro_torch.models import shard

    def refused(shape, kind, whole):
        try:
            shard.constrain(torch.zeros(shape), kind, whole)
        except ValueError as e:
            return str(e)
        return None

    out = {}
    with shard.use_mesh_axes(mesh, ("data",), "model"):
        half = torch.zeros(2, 8, 2, 16)
        out["half"] = shard.constrain(half, "heads", 4) is half
        out["unchecked"] = shard.constrain(torch.zeros(2, 8, 4, 16), "heads") is not None
        out["whole"] = refused((2, 8, 4, 16), "heads", 4)
        out["shards"] = (shard.model_shards(), shard.model_index())
        ssd = torch.zeros(2, 16, 4, 16)
        out["ssd_half"] = shard.constrain(ssd, "ssd_heads", 8) is ssd
        out["ssd_whole"] = refused((2, 16, 8, 16), "ssd_heads", 8)
        bsf = torch.zeros(2, 16, 32)
        out["bsf_half"] = shard.constrain(bsf, "act_bsf", 64) is bsf
        out["bsf_whole"] = refused((2, 16, 64), "act_bsf", 64)
    return out


def crossing_inputs():
    """(x, g, w, scale) of the crossings' case: an activation (2, 3, 8)
    whose last dim splits over ``model``, the output gradient, a (8, 8)
    weight and a norm scale, from ``torch.Generator`` seed 1 (the same
    numbers on every rank and in the test process), f32."""
    gen = torch.Generator().manual_seed(1)
    return tuple(torch.randn(sh, generator=gen) for sh in
                 ((2, 3, 8), (2, 3, 8), (8, 8), (8,)))


def crossings_case(mesh) -> dict:
    """The two crossings of the mamba2 and RG-LRU splits on this rank's
    slice of ``crossing_inputs``' activation: the gated norm's
    ``rms_norm(whole=)`` (``shard.model_allsum``) and the gates' product
    over every rank's slice (``shard.model_concat``, then this rank's
    output columns of ``w``), each rank's loss its slice of the whole
    computation's (``sum(out * g)``).  Returns the forward values (the
    sum of squares, the concatenation) and the gradient of the rank's
    slice, as numpy, and the wire bytes by call."""
    from repro_torch.models import shard
    from repro_torch.models.blocks import rms_norm

    x, g, w, scale = crossing_inputs()
    out = {}
    with shard.use_mesh_axes(mesh, ("data",), "model"):
        m, r = shard.model_shards(), shard.model_index()
        k = x.shape[-1] // m
        own = slice(r * k, (r + 1) * k)
        mesh.stats.reset()
        xr = x[..., own].clone().requires_grad_(True)
        ss = shard.model_allsum(torch.sum(xr * xr, -1, keepdim=True), "norm_sum")
        y = rms_norm(scale[own], xr, whole=x.shape[-1])
        torch.autograd.backward(y, g[..., own])
        out["allsum"], out["norm_grad"] = ss.detach().numpy(), xr.grad.numpy()
        xr = x[..., own].clone().requires_grad_(True)
        cat = shard.model_concat(xr, "lru_gather")
        torch.autograd.backward(cat @ w[:, own], g[..., own])
        out["concat"], out["concat_grad"] = cat.detach().numpy(), xr.grad.numpy()
        out["wire_bytes"] = dict(mesh.stats.wire_bytes)
    return out


def rank_main(rank) -> dict:
    torch.set_num_threads(1)
    mesh = rank.mesh(GRID, AXES)
    return {"cases": {cid: train_case(mesh, cid) for cid in CASES},
            "constrain": constrain_case(mesh), "crossings": crossings_case(mesh),
            "coords": mesh.coords}
