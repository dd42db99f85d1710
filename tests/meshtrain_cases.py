"""Rank side of ``tests/test_torch_meshtrain.py``; no tests of its own.

The spawned ranks import this module by name (``tests/`` is on their
``sys.path``) and run :func:`rank_main` on a 2x2 ``ProcessMesh`` (then
4x1 and 1x4 for the restores); the test process runs the one-process
steps with :func:`one_process`.  Neither side imports JAX: the JAX
package's side is the test module's subprocess.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import configs, convert
from repro_torch import train as T
from repro_torch.data import TokenPipeline
from repro_torch.launch import sharding as SH
from repro_torch.models import model as M

AXES = ("data", "model")
GRID = (2, 2)
BATCH, SEQ, STEPS = 4, 16, 3
SCHEDULE = (3e-3, 2, 10)         # warmup_cosine: step 0 has lr 0

# id -> (arch, optimizer, build_train_step options)
CASES = {
    "granite_adamw": ("granite-3-8b", "adamw", {}),
    "granite_adafactor": ("granite-3-8b", "adafactor", {}),
    "granite_adamw_accum2_int8": ("granite-3-8b", "adamw",
                                  {"grad_accum": 2, "compress_grads": True}),
    "dbrx_adafactor": ("dbrx-132b", "adafactor", {}),
}

# the restores: granite's smoke config at odd widths, so that leaves fall
# back to replication on 4x1 (d_model 66 on data) and 1x4 (d_ff 130 on
# model); "port" is saved from the 2x2 grid after a step, "jax" written by
# the JAX package
REMESH_ARCH, REMESH_WIDTHS = "granite-3-8b", dict(d_model=66, d_ff=130)
REMESH_OPT = {"port": "adamw", "jax": "adafactor"}
REMESH_MESHES = {"4x1": (4, 1), "1x4": (1, 4)}


def case_cfg(arch: str, **widths):
    return configs.get_smoke(arch).replace(param_dtype="float32",
                                           compute_dtype="float32", **widths)


def optimizer(name: str):
    return getattr(T, name)(T.warmup_cosine(*SCHEDULE))


def init_state(cfg, opt_name: str, compress: bool = False, device="cpu"):
    """The case's first state: the model drawn from ``torch.Generator``
    seed 0 (the same numbers on every rank and in the test process)."""
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(device)
    return T.init_train_state(model, optimizer(opt_name), compress=compress)


def batch_at(cfg, i: int) -> dict:
    return TokenPipeline(cfg.vocab_size, BATCH, SEQ, seed=0).batch_at(i)


def one_process(cid: str) -> dict:
    """The case's steps without ``grad_shardings``, in this process."""
    arch, opt_name, kw = CASES[cid]
    cfg = case_cfg(arch)
    state = init_state(cfg, opt_name, kw.get("compress_grads", False))
    step = T.build_train_step(cfg, optimizer(opt_name), **kw)
    out = {"loss": [], "grad_norm": []}
    for i in range(STEPS):
        state, m = step(state, batch_at(cfg, i))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["params"] = convert.lm_params_to_numpy(state.params)
    return out


def _held(tree) -> dict:
    """path -> numpy of every tensor a placed tree holds (stacks stacked)."""
    out = {}
    for f in ("params", "opt_state", "ef"):
        for path, v in SH.tree_leaves(getattr(tree, f)).items():
            t = torch.stack(list(v)) if isinstance(v, M.LayerStack) else v
            out[(f,) + path] = t.detach().cpu().numpy()
    return out


def _indices(pls) -> dict:
    """path -> this rank's slices (start, stop) of every placed leaf."""
    out = {}
    for f in ("params", "opt_state", "ef"):
        for path, pl in (getattr(pls, f) or {}).items():
            out[(f,) + path] = [(s.start, s.stop) for s in pl.held]
    return out


def train_case(mesh, cid: str) -> dict:
    """The case's steps on ``mesh``: every metric, the wire bytes of each
    step, the bytes held against ``device_bytes``, this rank's slices and
    the whole state gathered."""
    arch, opt_name, kw = CASES[cid]
    cfg = case_cfg(arch)
    state = init_state(cfg, opt_name, kw.get("compress_grads", False))
    specs = SH.state_specs(state, cfg.fsdp, mesh)
    want = sum(SH.device_bytes(SH.tree_leaves(getattr(state, f)), getattr(specs, f), mesh)
               for f in ("params", "opt_state", "ef") if getattr(state, f) is not None)
    pls = SH.named(mesh, specs, state)
    placed = SH.place(state, pls)
    out = {"held_bytes": SH.held_bytes(placed), "device_bytes": want + 4,
           "loss": [], "grad_norm": [], "wire_bytes": []}
    step = T.build_train_step(cfg, optimizer(opt_name), grad_shardings=pls.params,
                              donate=True, **kw)
    for i in range(STEPS):
        mesh.stats.reset()
        placed, m = step(placed, batch_at(cfg, i))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["wire_bytes"].append(dict(mesh.stats.wire_bytes))
    out["held"], out["index"] = _held(placed), _indices(pls)
    full = convert.train_state_to_numpy(placed, pls)
    out["params"], out["opt_state"] = full["params"], full["opt_state"]
    # convert places the numpy state it reads back, slice for slice
    again = convert.train_state_from_numpy(cfg, full, placements=pls)
    out["convert_round_trip"] = all(
        np.array_equal(v, out["held"][k]) for k, v in _held(again).items())
    return out


def seeded_grads(params) -> dict:
    """path -> a gradient of each param leaf (numpy, stacks stacked),
    drawn from seed 1."""
    rng = np.random.default_rng(1)
    return {path: (0.01 * rng.standard_normal(SH.leaf_shape(v))).astype(np.float32)
            for path, v in M.param_leaves(params).items()}


def update_case(mesh, opt_name: str) -> dict:
    """Clip and one optimizer update (step 1) on identical gradients:
    on ``mesh`` from the placed state (gathered after), or with ``mesh``
    None in one process."""
    cfg = case_cfg("granite-3-8b")
    state = init_state(cfg, opt_name)
    opt = optimizer(opt_name)
    grads = seeded_grads(state.params)
    pls = None
    if mesh is not None:
        pls = SH.named(mesh, SH.state_specs(state, cfg.fsdp, mesh), state)
        state = SH.place(state, pls)
    g = {}
    for path, leaf in M.param_leaves(state.params).items():
        t = torch.from_numpy(grads[path]) if pls is None else pls.params[path].shard(grads[path])
        g[path] = M.LayerStack(t.unbind(0)) if isinstance(leaf, M.LayerStack) else t
    placements = None if pls is None else pls.params
    g, gn = T.clip_by_global_norm(g, 1.0, placements=placements)
    new, _ = opt.update(g, state.opt_state, state.params,
                        torch.tensor(1, dtype=torch.int32), placements=placements)
    if pls is not None:
        new = SH.gather(new, pls.params)
    return {"grad_norm": float(gn),
            "params": {k: (torch.stack(list(v)) if isinstance(v, M.LayerStack) else v).numpy()
                       for k, v in new.items()}}


def dtensor_case(mesh) -> bool:
    """Each placed leaf (a layer's row of a stack) as a ``DTensor`` over a
    ``DeviceMesh`` of the mesh's ranks in its axis order: DTensor's own
    ``full_tensor()`` equals the whole leaf, so its placements name the
    split the slices make."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    dmesh = DeviceMesh("cpu", torch.arange(mesh.size).reshape(mesh.devices_shape),
                       mesh_dim_names=mesh.axis_names)
    cfg = case_cfg("dbrx-132b")
    model = init_state(cfg, "adamw").params
    pls = SH.tree_named(mesh, model)
    ok = True
    for path, leaf in M.param_leaves(model).items():
        pl, full = pls[path], leaf
        if isinstance(leaf, M.LayerStack):
            pl, full = pl.row(), leaf[0]
        d = DTensor.from_local(pl.shard(full), dmesh, pl.placements,
                               run_check=False, shape=full.shape,
                               stride=full.stride())
        ok &= tuple(d.shape) == tuple(full.shape)
        ok &= torch.equal(d.full_tensor(), full.detach())
    return bool(ok)


def constrain_case(mesh) -> dict:
    """``shard.constrain`` under ``use_mesh_axes`` with a ProcessMesh: the
    identity on values, the kind's spec validated (an unknown kind or a
    batch axis the mesh lacks raises ``KeyError``, as JAX's does)."""
    from repro_torch.models import shard

    x = torch.zeros(2, 8, 64)
    out = {}
    with shard.use_mesh_axes(mesh, ("data",), "model"):
        out["identity"] = shard.constrain(x, "act_bsd") is x
        out["shards"] = shard.batch_shards()
        for name, fn in (("kind", lambda: shard.constrain(x, "nope")),):
            try:
                fn()
                out[name] = None
            except KeyError as e:
                out[name] = str(e)
    with shard.use_mesh_axes(mesh, ("pod", "data"), "model"):
        try:
            shard.constrain(x, "act_bsd")
            out["axis"] = None
        except KeyError as e:
            out["axis"] = str(e)
    return out


def _mesh_cli(argv) -> tuple:
    """(exit code, stderr's last line) of ``launch.train`` in this rank."""
    import contextlib
    import io

    from repro_torch.launch import train as train_cli

    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            code = train_cli.main(argv)
    except SystemExit as e:
        code = e.code
    return code, err.getvalue().strip().splitlines()[-1:]


def remesh_case(rank, mesh, dirs: dict) -> dict:
    """Save the odd-width state from the 2x2 grid after one step (rank
    0), then restore it and the JAX package's checkpoint onto 4x1 and
    1x4: each rank's slices and the demoted leaves."""
    import torch.distributed as dist

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.ft.remesh import remesh_restore

    cfg = case_cfg(REMESH_ARCH, **REMESH_WIDTHS)
    state = init_state(cfg, REMESH_OPT["port"])
    pls = SH.named(mesh, SH.state_specs(state, cfg.fsdp, mesh), state)
    step = T.build_train_step(cfg, optimizer(REMESH_OPT["port"]),
                              grad_shardings=pls.params, donate=True)
    placed, _ = step(SH.place(state, pls), batch_at(cfg, 0))
    full = SH.gather(placed, pls)
    if rank.rank == 0:
        ckpt.save(full, dirs["port"], 1)
    dist.barrier()
    out = {}
    for src, opt_name in REMESH_OPT.items():
        like = T.init_train_state(M.init_params(cfg, None, "meta"),
                                  optimizer(opt_name))
        for mname, shape in REMESH_MESHES.items():
            m = rank.mesh(shape, AXES)
            got, used, demoted = remesh_restore(
                like, dirs[src], m, SH.state_specs(like, cfg.fsdp, m))
            out[(src, mname)] = {"step": used, "demoted": demoted,
                                 "held": _held(got),
                                 "index": _indices(SH.named(
                                     m, SH.state_specs(like, cfg.fsdp, m), like))}
    return out


def rank_main(rank, dirs: dict) -> dict:
    """Every case on the 2x2 grid, ``launch.train``'s body and its
    ``--mesh`` exits, then the restores."""
    from repro_torch.launch.train import train_on_mesh

    mesh = rank.mesh(GRID, AXES)
    out = {"cases": {cid: train_case(mesh, cid) for cid in CASES},
           "update": {o: update_case(mesh, o) for o in ("adamw", "adafactor")},
           "dtensor": dtensor_case(mesh), "constrain": constrain_case(mesh)}
    res = train_on_mesh(mesh, case_cfg("granite-3-8b"), steps=3,
                        batch=BATCH, seq=SEQ)
    out["cli"] = {k: res[k] for k in ("losses", "held_bytes", "device_bytes")}
    out["mesh_exit"] = {m: _mesh_cli(["--arch", "granite-3-8b", "--smoke",
                                      "--mesh", m, "--device", "cpu"])
                        for m in ("single", "multi")}
    out["remesh"] = remesh_case(rank, mesh, dirs)
    return out
