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
guard, resume).  ``--mesh single|multi`` exits 2: placing the state on a
process grid is not ported (ROADMAP Queue 1 item 11b, on items 10-11).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


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
    args = ap.parse_args(argv)

    from ..configs import get, get_smoke, names
    from ..data import TokenPipeline
    from ..device import resolve_device
    from ..ft import RestartManager, StepTimer
    from ..models import model as M
    from ..obs import clock
    from ..train import (adafactor, adamw, build_train_step,
                         init_train_state, warmup_cosine)

    if args.mesh:
        ap.error(f"--mesh {args.mesh}: placing the state on a process grid "
                 "(launch.mesh.ProcessMesh) is not ported (ROADMAP Queue 1 "
                 "item 11b, on items 10-11); the port trains on one card")
    if args.arch not in names():
        ap.error(f"--arch {args.arch!r}: unknown architecture; available: "
                 f"{', '.join(names())}")
    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt_fn = adamw if args.optimizer == "adamw" else adafactor
    opt = opt_fn(warmup_cosine(args.lr, min(20, args.steps // 5 + 1), args.steps))
    state = init_train_state(params, opt, compress=args.compress_grads)
    del params
    train_step = build_train_step(cfg, opt, grad_accum=args.grad_accum,
                                  compress_grads=args.compress_grads,
                                  donate=True)

    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq, seed=0)
    timer = StepTimer()

    if args.ckpt_dir:
        rm = RestartManager(args.ckpt_dir, save_every=args.save_every)
        res = rm.run(state, train_step, pipe, total_steps=args.steps)
        losses, times = res.losses, res.step_times
    else:
        losses, times = [], []
        for i in range(args.steps):
            t0 = clock.now()
            state, metrics = train_step(state, pipe.batch_at(i))
            losses.append(float(metrics["loss"]))
            dt = clock.now() - t0
            times.append(dt)
            rep = timer.observe(i, dt)
            if rep.is_straggler:
                print(f"[straggler] step {i}: {dt:.3f}s vs median {rep.median:.3f}s")
            if i % 20 == 0 or i == args.steps - 1:
                print(f"step {i:5d} loss {losses[-1]:.4f} ({dt*1e3:.0f} ms)")
    del state

    print(json.dumps({
        "arch": cfg.name, "steps": len(losses),
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "mean_step_ms": 1e3 * float(np.mean(times[1:])) if len(times) > 1 else None,
        "tokens_per_s": args.batch * args.seq / float(np.mean(times[1:]))
        if len(times) > 1 else None,
        "losses": losses, "step_ms": [1e3 * t for t in times],
    }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
