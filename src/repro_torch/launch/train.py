"""End-to-end training entry point of the port (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
        --smoke --steps 100 --batch 8 --seq 128 --ckpt-dir ckpt

    # the published config on one card, Adafactor
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
        --optimizer adafactor --batch 4 --seq 1024 --steps 5

The JAX launcher's flags and closing JSON (``arch``, ``steps``,
``loss_first``, ``loss_last``, ``mean_step_ms``, ``tokens_per_s``), plus
``losses`` and ``step_ms``, every step's.  The model is drawn on
``--device`` (default ``cuda``; ``--device cpu`` runs on the CPU, and a
CUDA request without a card raises) from ``torch.Generator`` seed 0; the
step donates its state (``build_train_step(..., donate=True)``, the JAX
launcher's ``donate_argnums=(0,)``).  Each step's time includes reading its
loss back, so it is the step's time on the device.  With ``--ckpt-dir``
the loop runs under ``ft.RestartManager`` (periodic async checkpoints, NaN
guard, resume).

``--mesh single|multi`` builds the JAX launcher's production mesh, (16,
16) over ("data", "model") or (2, 16, 16) over ("pod", "data", "model"),
as a ``launch.mesh.ProcessMesh`` of the group ``torchrun`` set up (a
rank a tile: 256 or 512 ranks; another world size, or no group, exits 2
naming the ranks needed), places the state by ``state_specs`` and
``sharding.named`` (each rank draws its slices alone, never the whole
state: :func:`placed_state`) and trains it with ``grad_shardings``
(:func:`train_on_mesh`, which the tests and ``chip_smoke.py`` call on a
2x2 grid): the split step, each rank computing its own heads, ``d_ff``
columns, experts, vocab rows, SSD heads and RG-LRU width; rank 0 prints
the step lines and the closing JSON, with ``"processes"`` and
``"split_kinds"`` (the step's table of what splits over ``model``,
``models.shard.split_kinds``: by layer kind its parts ``heads``, ``kv``,
``mlp``, ``experts``, ``shared`` and ``lru``, each true or false, and
``vocab``).
Both paths run one loop, :func:`train_loop`.
``--dist-backend`` is ``gloo`` (ranks may share a card) or ``nccl`` (a
card a rank; written, not yet run).  ``--ckpt-dir`` with ``--mesh`` runs
the placed state under ``ft.RestartManager`` on every rank
(``train_on_mesh(ckpt_dir=)``): every ``--save-every`` steps the state is
gathered leaf by leaf and rank 0 writes the whole leaves (the files of a
one-process save of the same state), a rerun resumes from the newest
valid step with each rank's slices restored onto its placements, and the
NaN guard rolls back; rank 0's closing JSON adds ``resumed_from`` and
``nan_rollbacks``.

    torchrun --nproc_per_node 256 -m repro_torch.launch.train \
        --arch granite-3-8b --mesh single --dist-backend nccl \
        --ckpt-dir ckpt --save-every 50
"""

from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np
import torch

from .mesh import AXES, BACKENDS


def make_optimizer(name: str, lr: float, steps: int):
    """``--optimizer``'s optimizer on the launcher's schedule,
    ``warmup_cosine(lr, min(20, steps // 5 + 1), steps)``."""
    from ..train import adafactor, adamw, warmup_cosine

    opt_fn = adamw if name == "adamw" else adafactor
    return opt_fn(warmup_cosine(lr, min(20, steps // 5 + 1), steps))


def train_loop(state, step_fn, pipe, steps: int, *, verbose: bool = True,
               on_step=None):
    """``steps`` steps of ``step_fn`` from ``state`` on ``pipe``'s batches,
    as the JAX launcher's loop: each step's time ends with reading its
    loss back, ``StepTimer`` flags stragglers, and with ``verbose`` the
    stragglers and every 20th and the last step's loss are printed.
    ``on_step(i, metrics)`` is called after each step.  Returns the final
    state, the losses and the steps' times in seconds."""
    from ..ft import StepTimer
    from ..obs import clock

    timer = StepTimer()
    losses, times = [], []
    for i in range(steps):
        t0 = clock.now()
        state, metrics = step_fn(state, pipe.batch_at(i))
        losses.append(float(metrics["loss"]))
        dt = clock.now() - t0
        times.append(dt)
        rep = timer.observe(i, dt)
        if on_step is not None:
            on_step(i, metrics)
        if verbose and rep.is_straggler:
            print(f"[straggler] step {i}: {dt:.3f}s vs median {rep.median:.3f}s")
        if verbose and (i % 20 == 0 or i == steps - 1):
            print(f"step {i:5d} loss {losses[-1]:.4f} ({dt*1e3:.0f} ms)")
    return state, losses, times


def placed_state(mesh, cfg, opt, compress: bool = False,
                 ep_stationary: bool = False):
    """The launcher's seed-0 train state of ``cfg`` placed on ``mesh`` by
    ``state_specs`` (``ep_stationary``: its expert-stationary rules) and
    ``sharding.named``, built so that this process never holds the whole
    of it: each param is cut to the rank's slice as it is drawn
    (``init_params(placements=)``), and the optimizer state (and the int8
    error feedback) starts from those slices.  Returns the state, its
    placements and ``sharding.device_bytes`` of the specs (the bytes the
    state must hold)."""
    from ..models import model as M
    from ..train import init_train_state
    from . import sharding as SH

    shapes = init_train_state(M.init_params(cfg, None, "meta"), opt,
                              compress=compress)
    specs = SH.state_specs(shapes, cfg.fsdp, mesh, ep_stationary=ep_stationary)
    pls = SH.named(mesh, specs, shapes)
    fields = [f for f in ("params", "opt_state", "ef") if getattr(shapes, f) is not None]
    want = sum(SH.device_bytes(SH.tree_leaves(getattr(shapes, f)), getattr(specs, f), mesh)
               for f in fields) + shapes.step.element_size()
    dev = mesh.device
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                           placements=pls.params)
    state = init_train_state(params, opt, compress=compress)
    for f in fields:
        for path, leaf in SH.tree_leaves(getattr(state, f)).items():
            if SH.leaf_shape(leaf) != getattr(pls, f)[path].local_shape:
                raise ValueError(f"{f} {path}: {SH.leaf_shape(leaf)} built, the "
                                 f"placement holds {getattr(pls, f)[path].local_shape}")
    return state, pls, want


def train_on_mesh(mesh, cfg, *, steps: int, batch: int, seq: int,
                  lr: float = 3e-3, grad_accum: int = 1,
                  compress_grads: bool = False, optimizer: str = "adamw",
                  verbose: bool = False, ckpt_dir: str = "",
                  save_every: int = 50,
                  inject_failure_at: int | None = None,
                  seq_parallel: bool = False,
                  ep_stationary: bool = False) -> dict:
    """Train ``cfg`` on every rank of ``mesh`` (a ``ProcessMesh``): the
    state of :func:`placed_state` (the one-process launcher's numbers, cut
    to the rank's slices), ``steps`` donated steps with ``grad_shardings``
    on ``TokenPipeline(seed=0)`` batches in :func:`train_loop`;
    ``seq_parallel`` and ``ep_stationary`` are the step's options
    (``train.build_train_step``; the JAX launcher has no flag for them,
    its dry run's ``--variant`` reaches them, as ``launch.dryrun``'s
    does).  Returns
    ``losses`` and ``grad_norms``, ``step_ms`` (each step ended by reading
    its loss), ``wire_bytes`` (``mesh.stats``' bytes this rank received, a
    dict a step), ``stage_s``/``comm_s`` a step, ``held_bytes`` (the
    rank's state), ``device_bytes`` (``sharding.device_bytes`` of the
    specs), ``split_kinds`` (the step's table of what splits over
    ``model``), on a card ``fwd_bwd_ms`` (each step's forward and backward
    passes by CUDA events), ``build_peak_bytes`` (``max_memory_allocated`` while
    the state was built, above what was allocated before) and ``peak_bytes`` (over the steps, from the
    placed state on), the final ``state`` and its ``placements``.

    With ``ckpt_dir`` the steps run under ``ft.RestartManager(ckpt_dir,
    save_every)`` on the placed state (``run(..., placements=)``, every
    rank: resume from the newest valid checkpoint, saves of the whole
    leaves by rank 0, the NaN guard; ``inject_failure_at`` is its test
    hook) in place of :func:`train_loop`, and the result adds
    ``resumed_from``, ``nan_rollbacks`` and ``checkpoint`` (the manager's
    ``stats`` of its last save and restore); ``losses`` are then the
    steps this call took, from the resumed step on."""
    from ..data import TokenPipeline
    from ..train import build_train_step
    from . import sharding as SH

    dev = mesh.device
    cuda = dev.type == "cuda"
    opt = make_optimizer(optimizer, lr, steps)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    state, pls, want = placed_state(mesh, cfg, opt, compress_grads, ep_stationary)
    out = {"grad_norms": [], "wire_bytes": [], "stage_s": [], "comm_s": [],
           "held_bytes": SH.held_bytes(state), "device_bytes": want,
           "build_peak_bytes": torch.cuda.max_memory_allocated(dev) - base
           if cuda else None}
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    step_fn = build_train_step(cfg, opt, grad_accum=grad_accum,
                               compress_grads=compress_grads,
                               grad_shardings=pls.params, donate=True,
                               seq_parallel=seq_parallel,
                               ep_stationary=ep_stationary)
    out["split_kinds"] = step_fn.split_kinds

    out["fwd_bwd_ms"] = []

    def on_step(i, metrics):
        out["grad_norms"].append(float(metrics["grad_norm"]))
        if cuda:
            e0, e1 = step_fn.fwd_bwd_events
            out["fwd_bwd_ms"].append(e0.elapsed_time(e1))
        out["wire_bytes"].append(dict(mesh.stats.wire_bytes))
        out["stage_s"].append(mesh.stats.stage_s)
        out["comm_s"].append(mesh.stats.comm_s)
        mesh.stats.reset()

    pipe = TokenPipeline(cfg.vocab_size, batch, seq, seed=0)
    mesh.stats.reset()
    if ckpt_dir:
        from ..ft import RestartManager

        def observed(st, b):
            # a step's wire bytes are its own, not a save's between steps
            mesh.stats.reset()
            new, metrics = step_fn(st, b)
            on_step(None, metrics)
            return new, metrics

        observed.donate = step_fn.donate
        rm = RestartManager(ckpt_dir, save_every=save_every)
        res = rm.run(state, observed, pipe, steps,
                     inject_failure_at=inject_failure_at, placements=pls)
        state, out["losses"], times = res.state, res.losses, res.step_times
        out["resumed_from"], out["nan_rollbacks"] = (res.resumed_from,
                                                    res.nan_rollbacks)
        out["checkpoint"] = dict(rm.mgr.stats)
    else:
        state, out["losses"], times = train_loop(
            state, step_fn, pipe, steps, verbose=verbose, on_step=on_step)
    out["step_ms"] = [1e3 * t for t in times]
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else None
    out["state"], out["placements"] = state, pls
    return out


def _mesh_main(ap, args, cfg) -> dict | None:
    """``--mesh``: the production mesh of the group torchrun set up; rank
    0's closing JSON fields (None on the other ranks)."""
    import torch.distributed as dist

    from .mesh import leave_process_group, make_process_mesh

    multi = args.mesh == "multi"
    shape = (2, 16, 16) if multi else (16, 16)
    axes = AXES["multi" if multi else "single"]
    need = math.prod(shape)
    if dist.is_initialized():
        have = f"the process group has {dist.get_world_size()}"
        world = dist.get_world_size()
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        have = f"torchrun started {world}"
    else:
        world, have = None, "there is no process group and no torchrun environment"
    if world != need:
        ap.error(f"--mesh {args.mesh}: the production mesh {shape} over {axes} "
                 f"needs {need} ranks, a rank a tile (torchrun --nproc_per_node "
                 f"{need}, or {need} ranks over several hosts); {have}")
    mesh = make_process_mesh(shape, axes, backend=args.dist_backend,
                             device=args.device)
    res = train_on_mesh(mesh, cfg, steps=args.steps, batch=args.batch,
                        seq=args.seq, lr=args.lr, grad_accum=args.grad_accum,
                        compress_grads=args.compress_grads,
                        optimizer=args.optimizer, verbose=mesh.rank == 0,
                        ckpt_dir=args.ckpt_dir, save_every=args.save_every)
    leave_process_group(mesh)
    return None if mesh.rank else res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--mesh", default="", choices=("", "single", "multi"))
    ap.add_argument("--optimizer", default="adamw", choices=("adamw", "adafactor"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model trains; cuda raises without a card")
    ap.add_argument("--dist-backend", default="gloo", choices=BACKENDS,
                    help="torch.distributed backend of --mesh: gloo (ranks "
                         "may share a card) or nccl (a card a rank)")
    args = ap.parse_args(argv)

    from ..configs import get, get_smoke, names
    from ..data import TokenPipeline
    from ..device import resolve_device
    from ..ft import RestartManager
    from ..models import model as M
    from ..train import build_train_step, init_train_state

    if args.arch not in names():
        ap.error(f"--arch {args.arch!r}: unknown architecture; available: "
                 f"{', '.join(names())}")
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    if args.mesh:
        res = _mesh_main(ap, args, cfg)
        if res is not None:
            extra = {"processes": 16 * 16 * (2 if args.mesh == "multi" else 1),
                     "split_kinds": res["split_kinds"]}
            if args.ckpt_dir:
                extra |= {k: res[k] for k in ("resumed_from", "nan_rollbacks")}
            _print_result(cfg, args, res["losses"],
                          [t / 1e3 for t in res["step_ms"]], extra)
        return 0
    dev = resolve_device(args.device)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = make_optimizer(args.optimizer, args.lr, args.steps)
    state = init_train_state(params, opt, compress=args.compress_grads)
    del params
    train_step = build_train_step(cfg, opt, grad_accum=args.grad_accum,
                                  compress_grads=args.compress_grads,
                                  donate=True)
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq, seed=0)

    if args.ckpt_dir:
        rm = RestartManager(args.ckpt_dir, save_every=args.save_every)
        res = rm.run(state, train_step, pipe, total_steps=args.steps)
        losses, times = res.losses, res.step_times
    else:
        state, losses, times = train_loop(state, train_step, pipe, args.steps)
    del state
    _print_result(cfg, args, losses, times)
    return 0


def _print_result(cfg, args, losses, times, extra=None) -> None:
    """The JAX launcher's closing JSON, plus ``losses`` and ``step_ms``
    and ``extra`` (on a mesh ``processes`` and ``split_kinds``, with
    ``--ckpt-dir`` ``resumed_from`` and ``nan_rollbacks``)."""
    out = {
        "arch": cfg.name, "steps": len(losses),
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "mean_step_ms": 1e3 * float(np.mean(times[1:])) if len(times) > 1 else None,
        "tokens_per_s": args.batch * args.seq / float(np.mean(times[1:]))
        if len(times) > 1 else None,
        "losses": losses, "step_ms": [1e3 * t for t in times],
    }
    out |= extra or {}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    raise SystemExit(main())
