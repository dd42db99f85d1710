"""Rank side of ``tests/test_torch_meshserve.py``; no tests of its own.

The spawned ranks import this module by name (``tests/`` is on their
``sys.path``) and run :func:`rank_main` on a 2x2 (``data``, ``model``)
``ProcessMesh``; the test process runs the one-process generation with
:func:`one_process`.  Neither side imports JAX.  Every side draws the
model from ``torch.Generator`` seed 0 and the prompts from
``launch.serve.serve_on_mesh``'s default (``default_rng(0)``, ids from 1).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import configs
from repro_torch.launch import sharding as SH
from repro_torch.launch.serve import serve_on_mesh
from repro_torch.models import model as M
from repro_torch.serve import generate

AXES = ("data", "model")
GRID = (2, 2)
BATCH, PROMPT, GEN = 4, 16, 8

# id -> (arch, launch.dryrun variant, max_len (None: PROMPT + GEN), the
# smoke config's changes on every side): granite as GQA (4 q heads over 2
# kv heads, both split over model) with fsdp, weights-stationary, an int8
# cache and sequence parallelism in its prefill; deepseek's MLA latent
# cache and MoE with a shared expert; dbrx's experts stationary over the
# whole grid; mamba2's SSD heads and conv state (C = 160 channels over 2
# ranks, not on a rank's heads); recurrentgemma's RG-LRU and its local
# attention ring of 20 slots wrapping at 16 + 8 tokens
CASES = {
    "granite_fsdp": ("granite-3-8b", "", None, {"n_kv_heads": 2}),
    "granite_nofsdp": ("granite-3-8b", "nofsdp", None, {"n_kv_heads": 2}),
    "granite_int8kv": ("granite-3-8b", "int8kv", None, {"n_kv_heads": 2}),
    "granite_sp": ("granite-3-8b", "sp", None, {"n_kv_heads": 2}),
    "deepseek": ("deepseek-v3-671b", "", None, {}),
    "dbrx_ep": ("dbrx-132b", "ep", None, {}),
    "mamba2": ("mamba2-370m", "", None, {}),
    "recurrentgemma_wrap": ("recurrentgemma-9b", "", 20, {}),
}


def case_cfg(cid: str):
    """The case's f32 smoke config, before its variant."""
    arch, _, _, widths = CASES[cid]
    return configs.get_smoke(arch).replace(param_dtype="float32",
                                           compute_dtype="float32", **widths)


def served_cfg(cid: str):
    """The config the case serves: its variant's cache dtype and fsdp."""
    var = CASES[cid][1]
    cfg = case_cfg(cid)
    if "int8kv" in var:
        cfg = cfg.replace(kv_cache_dtype="int8")
    if "nofsdp" in var:
        cfg = cfg.replace(fsdp=False)
    return cfg


def max_len(cid: str) -> int:
    return CASES[cid][2] or PROMPT + GEN


def prompts(cfg) -> np.ndarray:
    return np.random.default_rng(0).integers(1, cfg.vocab_size, size=(BATCH, PROMPT))


def seed_params(cid: str, device="cpu"):
    return M.init_params(case_cfg(cid), torch.Generator(device=device).manual_seed(0),
                         device)


def _cache_arrays(caches) -> dict:
    """path -> the stacked numpy leaf of one-process caches."""
    return {"/".join(map(str, path)): np.stack([t.float().cpu().numpy()
                                                if t.dtype == torch.bfloat16
                                                else t.cpu().numpy() for t in leaf])
            for path, leaf in SH.cache_leaves(caches).items()}


def one_process(cid: str, device="cpu", feed=None) -> dict:
    """The case's generation in this process: tokens, each step's last
    logits, the caches after the last step."""
    cfg = served_cfg(cid)
    params = seed_params(cid, device)
    out = {"logits": []}

    def on_step(i, logits, caches):
        out["logits"].append(logits[:, -1].float().cpu().numpy())
        out["caches"] = caches

    toks = generate(params, cfg, torch.as_tensor(prompts(cfg), device=device), GEN,
                    max_len=max_len(cid), feed=feed, on_step=on_step)
    out["tokens"] = toks.cpu().numpy()
    out["caches"] = _cache_arrays(out["caches"])
    return out


def serve_case(mesh, cid: str) -> dict:
    """The case on ``mesh``: ``serve_on_mesh``'s result with its logits and
    caches."""
    return serve_on_mesh(mesh, case_cfg(cid), batch=BATCH, prompt_len=PROMPT,
                         gen=GEN, variant=CASES[cid][1], max_len=max_len(cid))


SAMPLE_CASE, SAMPLE_SEED = "granite_fsdp", 7


def sampled(mesh) -> list:
    """SAMPLE_CASE sampled at temperature 1 on every rank, from a generator
    seeded SAMPLE_SEED alike: each rank's draws of its rows (the logits
    gathered whole over ``model`` first)."""
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.serve.engine import on_mesh

    cid = SAMPLE_CASE
    cfg = served_cfg(cid)
    ml = max_len(cid)
    baxes = batch_axes(mesh)
    shapes = M.init_params(cfg, None, "meta")
    pls = SH.named(mesh, SH.param_specs(shapes, cfg.fsdp, mesh), shapes)
    c_leaves = SH.cache_leaves(M.init_caches(cfg, BATCH, ml, "meta"))
    c_pls = SH.named(mesh, SH.cache_specs(c_leaves, baxes, cfg.seq_shard_decode),
                     c_leaves)
    params = M.init_params(cfg, torch.Generator(device=mesh.device).manual_seed(0),
                           mesh.device, placements=pls)
    rows = SH.Placement(mesh, (baxes, None), (BATCH, PROMPT)).shard(prompts(cfg))
    gen = torch.Generator(device=mesh.device).manual_seed(SAMPLE_SEED)
    with on_mesh(params, cfg, pls, c_pls, ml):
        got = generate(params, cfg, rows.long(), GEN, max_len=ml, temperature=1.0,
                       generator=gen)
    return got.tolist()


def one_process_sampled() -> list:
    """SAMPLE_CASE sampled as :func:`sampled` samples it, in this process."""
    cfg = served_cfg(SAMPLE_CASE)
    got = generate(seed_params(SAMPLE_CASE), cfg, torch.as_tensor(prompts(cfg)), GEN,
                   max_len=max_len(SAMPLE_CASE), temperature=1.0,
                   generator=torch.Generator().manual_seed(SAMPLE_SEED))
    return got.tolist()


def rank_main(rank) -> dict:
    torch.set_num_threads(1)
    mesh = rank.mesh(GRID, AXES)
    return {"cases": {cid: serve_case(mesh, cid) for cid in CASES},
            "sampled": sampled(mesh), "coords": mesh.coords}
