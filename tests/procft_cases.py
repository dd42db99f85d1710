"""Rank side of ``tests/test_torch_procft.py``; no tests of its own.

The spawned ranks import this module by name (``tests/`` and the repo root
are on their ``sys.path``) and run :func:`rank_main` on a 4-rank
``ProcessMesh``; the test process runs the same case functions on the
one-process ``TileMesh`` grid and the one-process training loop, and
holds each rank to them.  Neither side imports JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil

import numpy as np
import scipy.sparse as sp
import torch

import chip_smoke as CHIP
from repro_torch import ft
from repro_torch import train as T
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_smoke
from repro_torch.core import AzulEngine, SolveSpec
from repro_torch.data import TokenPipeline
from repro_torch.data.matrices import laplacian_2d
from repro_torch.launch import sharding as SH
from repro_torch.launch import solve as solve_cli
from repro_torch.launch.train import make_optimizer
from repro_torch.models import model as M
from repro_torch.obs import clock
from test_torch_dist_cases import MESHES

# the corrupted operands: every value kind on both grids of PROC_FT
CORRUPT_KINDS = ("nan", "bitflip", "halo_drop", "halo_perturb")
CORRUPT_GRIDS = {"4x1": CHIP._L16, "2x2": CHIP._L32}
# launch.solve --processes --inject KIND on the 2x2 grid (under a faked
# torchrun environment in each rank, and spawned from the test process)
CLI_KINDS = ("nan", "bitflip", "halo_drop", "halo_perturb", "delay")
CLI_ARGV = ["--matrix", "lap2d_32", "--method", "pcg_tol", "--max-iters",
            "400", "--mesh-shape", "2x2", "--inject-at", "25",
            "--inject-seed", "1", "--ft-chunk", "25"]

# training: the f32 smoke config of granite-3-8b on the 2x2 grid, AdamW
# on launch.train's schedule, STEPS steps of BATCH x SEQ, a checkpoint
# every SAVE_EVERY steps; a failure injected at FAIL_AT, a NaN loss forced
# once at NAN_AT
ARCH, OPT = "granite-3-8b", "adamw"
GRID, AXES = (2, 2), ("data", "model")
BATCH, SEQ, STEPS, SAVE_EVERY, FAIL_AT, NAN_AT = 4, 16, 6, 2, 3, 3
LR = 3e-3
# the placed saves held byte for byte to the one-process save: f32 and
# bf16 params
SAVE_DTYPES = ("float32", "bfloat16")


def cli_argv(kind: str) -> list:
    return ["--device", "cpu", *CLI_ARGV, "--inject", kind]


# -- solves ---------------------------------------------------------------------


def engine(mesh, case: dict) -> AzulEngine:
    _, _, ra, ca = MESHES[case["mesh"]]
    return AzulEngine(laplacian_2d(case["grid"]), mesh=mesh, mode=case["mode"],
                      row_axes=ra, col_axes=ca, dtype=np.float64)


def rhs(case: dict) -> np.ndarray:
    m = laplacian_2d(case["grid"])
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    return a @ np.random.default_rng(case["x_seed"]).standard_normal(m.shape[0])


def summary(rep) -> list:
    """chip_smoke.ft_summary's fields, as lists."""
    return [rep.status, rep.iterations, rep.chunks, rep.restarts,
            [[f["label"], f["global_iter"], f["bad_iter"]] for f in rep.faults]]


def ft_solve(eng, case: dict, checkpoint_dir=None, fault: bool = True) -> dict:
    """One PROC_FT case through ``ft.SolveRestartManager`` (with a
    ``StepTimer``, under a fake clock: no chunk is a straggler)."""
    mgr = ft.SolveRestartManager(
        eng, SolveSpec(method=case["method"], tol=CHIP.PROC_FT_TOL,
                       max_iters=CHIP.PROC_FT_BUDGET),
        chunk=case["chunk"], max_restarts=case.get("max_restarts", 3),
        checkpoint_dir=checkpoint_dir, timer=ft.StepTimer())
    inj = (ft.FaultInjector(eng, ft.FaultSpec(**case["fault"]))
           if fault and case["fault"] is not None else None)
    with clock.override(clock.FakeClock()):
        rep = mgr.solve(rhs(case), injector=inj)
    return {"report": summary(rep), "resumed_from": rep.resumed_from,
            "x": rep.x, "stragglers": rep.straggler_chunks,
            "fired": 0 if inj is None else inj.fired}


def corrupted(eng, kind: str) -> np.ndarray:
    return ft.FaultInjector(eng, ft.FaultSpec(kind=kind, seed=2,
                                              count=4))._corrupt


def _writes_counted():
    """Count this process's checkpoint writes (``_save_flat`` calls)."""
    calls = []
    orig = ckpt._save_flat

    def counted(flat, directory, step, keep):
        calls.append(step)
        return orig(flat, directory, step, keep)

    ckpt._save_flat = counted
    return calls


def solve_cases(rank, dirs: dict) -> dict:
    out = {"ft": [], "corrupt": {}, "cli": {}}
    meshes = {name: rank.mesh(MESHES[name][0], MESHES[name][1])
              for name in ("2x2", "4x1")}
    engines = {}

    def eng_of(case):
        key = (case["grid"], case["mesh"], case["mode"])
        if key not in engines:
            engines[key] = engine(meshes[case["mesh"]], case)
        return engines[key]

    for case, _ in CHIP.PROC_FT:
        out["ft"].append(ft_solve(eng_of(case), case))
    for mname, case in CORRUPT_GRIDS.items():
        eng = eng_of(case)
        out["corrupt"][mname] = {k: corrupted(eng, k) for k in CORRUPT_KINDS}
    # the checkpointed case: gives up, then a fresh manager resumes; only
    # rank 0 writes
    case = CHIP.PROC_FT_CKPT[0]
    writes = _writes_counted()
    out["ckpt"] = [ft_solve(eng_of(case), case, dirs["solve_grid"])]
    if rank.rank == 0:          # what the run that gave up left, kept
        shutil.copytree(dirs["solve_grid"], dirs["solve_grid_gave_up"])
    out["ckpt"].append(ft_solve(eng_of(case), case, dirs["solve_grid"],
                                fault=False))
    # a one-process grid's checkpoint resumes on the process grid
    out["ckpt_from_tile"] = ft_solve(eng_of(case), case, dirs["solve_tile"],
                                     fault=False)
    out["writes"] = list(writes)
    # launch.solve --processes under torchrun's environment: the group
    # exists, so the CLI joins it
    os.environ.update(RANK=str(rank.rank), WORLD_SIZE=str(rank.size))
    for kind in CLI_KINDS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                clock.override(clock.FakeClock()):
            code = solve_cli.main(cli_argv(kind) + ["--processes"])
        text = buf.getvalue()
        out["cli"][kind] = (code, json.loads(text) if text else None)
    return out


# -- training -------------------------------------------------------------------


def cfg_of(dtype: str = "float32"):
    return get_smoke(ARCH).replace(param_dtype=dtype, compute_dtype=dtype)


def optimizer():
    return make_optimizer(OPT, LR, STEPS)


def pipe(cfg) -> TokenPipeline:
    return TokenPipeline(cfg.vocab_size, BATCH, SEQ, seed=0)


def seed_state(cfg, device="cpu"):
    """launch.train's seed-0 state (the numbers ``placed_state`` cuts to
    each rank's slices)."""
    model = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                          device)
    return T.init_train_state(model, optimizer())


def nan_once(step_fn, at: int, batches):
    """``step_fn`` reporting a NaN loss the first time it is given batch
    ``at`` (tests/test_torch_train_ft.py's)."""
    bad = batches.batch_at(at)["tokens"]
    seen = []

    def step(state, batch):
        new, m = step_fn(state, batch)
        if not seen and np.array_equal(np.asarray(batch["tokens"]), bad):
            seen.append(1)
            m = dict(m, loss=m["loss"] * float("nan"))
        return new, m

    step.donate = step_fn.donate
    return step


def counts(res) -> list:
    return [res.resumed_from, int(res.state.step), len(res.losses),
            res.nan_rollbacks]


def placements(mesh, state, cfg):
    return SH.named(mesh, SH.state_specs(state, cfg.fsdp, mesh), state)


def held(tree) -> dict:
    """flat checkpoint key -> numpy of every tensor a placed tree holds."""
    out = {}
    for key, v in ckpt._flatten(tree).items():
        t = torch.stack(list(v)) if isinstance(v, M.LayerStack) else v
        t = torch.as_tensor(t).detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        out[key] = t.cpu().numpy().copy()
    return out


def indices(pls) -> dict:
    """flat checkpoint key -> this rank's slices (start, stop)."""
    return {k: [(s.start, s.stop) for s in pl.held]
            for k, pl in ckpt._flatten(pls).items()}


def train_cases(rank, dirs: dict) -> dict:
    from repro_torch.launch.train import train_on_mesh

    mesh = rank.mesh(GRID, AXES)
    cfg = cfg_of()
    out = {}
    # resume: train_on_mesh with a failure injected, then again on the
    # same directory
    kw = dict(steps=STEPS, batch=BATCH, seq=SEQ, lr=LR, optimizer=OPT,
              ckpt_dir=dirs["train_grid"], save_every=SAVE_EVERY)
    try:
        train_on_mesh(mesh, cfg, inject_failure_at=FAIL_AT, **kw)
        out["raised"] = None
    except RuntimeError as e:
        out["raised"] = str(e)
    res = train_on_mesh(mesh, cfg, **kw)
    out["resume"] = {k: res[k] for k in ("losses", "resumed_from",
                                         "nan_rollbacks")}
    out["resume"]["step"] = int(res["state"].step)
    out["resume"]["checkpoint"] = res["checkpoint"]
    # the JAX package's first state, restored onto the grid, trained under
    # the manager with a NaN forced once
    like = T.init_train_state(M.init_params(cfg, None, "meta"), optimizer())
    pls = placements(mesh, like, cfg)
    mgr = ckpt.CheckpointManager(dirs["jax_init"], mesh=mesh)
    state, used = mgr.restore(like, pls)
    out["jax_restored"] = {"step": used, "held": held(state),
                           "index": indices(pls)}
    step_fn = T.build_train_step(cfg, optimizer(), grad_shardings=pls.params,
                                 donate=True)
    rm = ft.RestartManager(dirs["train_nan"], save_every=SAVE_EVERY)
    res = rm.run(state, nan_once(step_fn, NAN_AT, pipe(cfg)), pipe(cfg), STEPS,
                 placements=pls)
    out["nan"] = {"counts": counts(res), "losses": res.losses}
    # the donating step with nothing to roll back to raises on every rank
    state, _ = mgr.restore(like, pls)
    rm = ft.RestartManager(dirs["train_raise"], save_every=100)
    try:
        rm.run(state, nan_once(step_fn, 1, pipe(cfg)), pipe(cfg), 3,
               placements=pls)
        out["donate_raise"] = None
    except RuntimeError as e:
        out["donate_raise"] = str(e)
    # a placed state's save: the one-process save's files (test side)
    for dtype in SAVE_DTYPES:
        c = cfg_of(dtype)
        whole = seed_state(c)
        p = placements(mesh, whole, c)
        placed = SH.place(whole, p)
        d = os.path.join(dirs["save"], dtype)
        if dtype == "float32":
            ckpt.save(placed, d, 1, placements=p)
        else:
            m = ckpt.CheckpointManager(d, mesh=mesh)
            m.save_async(placed, 1, p)
            m.wait()
            out["save_stats"] = dict(m.stats)
            mesh.barrier()
    return out


def rank_main(rank, dirs: dict) -> dict:
    """Every case on this rank: the solves, then the training."""
    torch.manual_seed(0)
    return {"rank": rank.rank, "solve": solve_cases(rank, dirs),
            "train": train_cases(rank, dirs)}
