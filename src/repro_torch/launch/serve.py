"""Serving entry point of the port: the always-on sparse-solve service,
and LM generation over the model zoo.

    # LM generation: prefill + greedy decode, then the slot server
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --batch 4 --prompt-len 32 --gen 16 --slots

    # submit RHS against registered operators, drain the continuous-
    # batching tick loop (on the card: one captured plan per bucket)
    PYTHONPATH=src python -m repro_torch.launch.serve --solver \
        --matrix lap2d_32 --requests 12 --coalesce 8 --method pcg_tol

    # several resident operators in one process, round-robin traffic
    PYTHONPATH=src python -m repro_torch.launch.serve --solver \
        --operators lap2d_32,banded_1k --requests 12

    # load generator: open-loop Poisson arrivals at 50 req/s
    PYTHONPATH=src python -m repro_torch.launch.serve --solver \
        --matrix lap2d_32 --load-gen open --rate 50 --requests 40

    # on a 2x2 tile grid (every tile on the one device)
    PYTHONPATH=src python -m repro_torch.launch.serve --solver \
        --matrix lap2d_32 --mesh-shape 2x2 --requests 12

    # the same grid one process a tile: 4 ranks spawned here (or the
    # ranks of torchrun), rank 0 prints
    PYTHONPATH=src python -m repro_torch.launch.serve --solver \
        --matrix lap2d_32 --mesh-shape 2x2 --processes --dist-backend gloo

The ``--solver`` path of ``repro.launch.serve``, with its flags and its
printed JSON fields, plus ``degraded_batches`` (always 0 on the card,
where a kernel failure raises) and, under ``--load-gen``,
``verify_rel_residual``: the largest true relative residual
``||b - A x|| / ||b||`` of the outcomes.  ``--device cpu`` runs the kernels' plain versions
(the default ``cuda`` raises without a card).  ``--mesh-shape RxC``
serves every operator on an R x C tile grid (``launch.mesh.make_mesh``
over ("data", "model") on the ``--device``).  With ``--processes`` the
grid runs one process a tile (``launch.mesh.ProcessMesh`` over
``--dist-backend``): the R*C ranks are spawned here through
``launch.procs``, or, under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` in
the environment), this process is one of them.  Every rank runs the
service as one program (rank 0's clock decides every tick); rank 0 prints
the one-process grid's JSON with ``"processes": R*C`` added and alone
serves ``--metrics-port``.

``--arch NAME`` (any of ``repro_torch.configs.names()``; ``--smoke`` for
the reduced same-family config) builds the model on ``--device`` from
``--seed``, generates ``--gen`` tokens for ``--batch`` random prompts of
``--prompt-len`` tokens and prints the JAX package's JSON keys (``arch``,
``batch``, ``gen``, ``wall_s``, ``tokens_per_s``, and with ``--slots``
``slot_server_completed``).

:func:`serve_on_mesh` runs the same generation on every rank of a
``launch.mesh.ProcessMesh`` (a function, as ``launch.train.
train_on_mesh`` is; the JAX launcher has no flag for it either): the
params placed by ``param_specs`` (``fsdp``, or weights-stationary under
the ``nofsdp`` variant), the caches by ``cache_specs``, the JAX package's
sharded serving cells (``repro.launch.dryrun``'s prefill and decode).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def _grid_shape(args) -> tuple:
    shape = tuple(int(x) for x in args.mesh_shape.split("x"))
    if len(shape) != 2:
        raise SystemExit("--mesh-shape must be RxC, e.g. 2x2")
    return shape


def _solver_main(args, argv: list) -> int:
    """``--solver``: one process, or with ``--processes`` every rank of a
    process grid; prints the JSON of :func:`solver_verdict`."""
    if not args.processes:
        out, rc = solver_verdict(args)
        print(json.dumps(out, indent=1))
        return rc
    if not args.mesh_shape:
        raise SystemExit("--processes needs --mesh-shape")
    shape = _grid_shape(args)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        from .mesh import leave_process_group, make_process_mesh

        mesh = make_process_mesh(shape, ("data", "model"),
                                 backend=args.dist_backend, device=args.device)
        out, rc = solver_verdict(args, mesh)
        if mesh.rank == 0:
            print(json.dumps(out, indent=1), flush=True)
        leave_process_group(mesh)
        return rc
    from . import procs

    out, rc = procs.run(_rank_verdict, shape[0] * shape[1], (argv,),
                        backend=args.dist_backend, device=args.device)[0]
    print(json.dumps(out, indent=1))
    return rc


def _rank_verdict(rank, argv: list) -> tuple:
    """A spawned rank of ``--solver --processes``: its (JSON, exit code)."""
    args = _parser().parse_args(argv)
    return solver_verdict(args, rank.mesh(_grid_shape(args),
                                          ("data", "model")))


def solver_verdict(args, mesh=None) -> tuple:
    """Serve sparse solves through :class:`repro_torch.serve.SolveService`:
    register one operator per ``--operators`` name (or ``--matrix``),
    submit ``--requests`` RHS round-robin, and drain the continuous-
    batching tick loop -- or hand the service to the load generator
    (``--load-gen open|closed``).  Returns (the printed JSON, the exit
    code); ``mesh`` is a rank's ``ProcessMesh`` under ``--processes``."""
    import scipy.sparse as sp

    from ..core.plan import SolveSpec
    from ..data.matrices import suite
    from ..obs import clock, start_metrics_server
    from ..serve import SolveService, run_load

    names = [s for s in (args.operators.split(",") if args.operators
                         else [args.matrix]) if s]
    mats = suite("small")
    if any(name not in mats for name in names):
        mats.update(suite("large"))
    for name in names:
        if name not in mats:
            raise SystemExit(
                f"unknown matrix {name!r}; available: {', '.join(sorted(mats))}"
            )

    metrics_srv = None
    if args.metrics_port is not None and (mesh is None or mesh.rank == 0):
        # scrape target up BEFORE any work so a poller sees the whole run
        metrics_srv = start_metrics_server(port=args.metrics_port)
        print(f"metrics: {metrics_srv.url}", flush=True)
    grid = {} if mesh is None else {"processes": mesh.size}
    if mesh is None and args.mesh_shape:
        from .mesh import make_mesh
        mesh = make_mesh(_grid_shape(args), ("data", "model"),
                         device=args.device)
    try:
        # one frozen spec drives every operator's warm pool; the service
        # builds per-(operator, bucket) plans from it
        spec = SolveSpec(method=args.method, iters=args.iters, tol=args.tol,
                         layout=args.layout)
        svc = SolveService(max_batch=args.coalesce, chunk=args.chunk,
                           device=args.device)
        for name in names:
            svc.register_operator(name, mats[name], spec=spec,
                                  precond=args.precond, dtype=np.float64,
                                  layout=args.layout, reorder=args.reorder,
                                  mesh=mesh)

        rng = np.random.default_rng(0)
        if args.load_gen:
            m0 = mats[names[0]]
            n0 = m0.shape[0]
            rhs = rng.standard_normal((min(args.requests, 32), n0))
            # keep every request and outcome, to hold each outcome to its
            # true residual below
            sent, seen = {}, {}
            submit, tick = svc.submit, svc.tick

            def recording_submit(b, *a, **kw):
                rid = submit(b, *a, **kw)
                sent[rid] = b
                return rid

            def recording_tick():
                out = tick()
                seen.update(out)
                return out

            svc.submit, svc.tick = recording_submit, recording_tick
            res = run_load(svc, lambda i: rhs[i % rhs.shape[0]],
                           operator=names[0], mode=args.load_gen,
                           requests=args.requests, rate=args.rate,
                           concurrency=args.concurrency)
            a0 = sp.csr_matrix((m0.data, m0.indices, m0.indptr),
                               shape=m0.shape)
            rel = [float(np.linalg.norm(sent[rid] - a0 @ o.x)
                         / np.linalg.norm(sent[rid]))
                   for rid, o in seen.items()]
            res.update({"matrix": names[0], "n": n0, "method": args.method,
                        "degraded_batches": svc.stats["degraded_batches"],
                        "verify_rel_residual": max(rel, default=-1.0),
                        **grid})
            return res, 0

        x_true, ids = {}, []
        for i in range(args.requests):
            name = names[i % len(names)]
            m = mats[name]
            a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
            xt = rng.standard_normal(m.shape[0])
            rid = svc.submit(a @ xt, name)
            x_true[rid] = xt
            ids.append(rid)

        t0 = clock.now()
        done = svc.drain()
        dt = clock.now() - t0
        err = max(float(np.abs(done[rid].x - x_true[rid]).max())
                  for rid in ids)
        out = {
            "operators": names, "requests": args.requests,
            "coalesce": args.coalesce, "chunk": args.chunk,
            "ticks": svc.stats["ticks"], "chunks": svc.stats["chunks"],
            "rebuckets": svc.stats["rebuckets"],
            "bucket_plans": svc.stats["plans"],
            "resident_bytes": svc.resident_bytes(),
            "wall_s": round(dt, 3),
            "solves_per_s": round(args.requests / dt, 2),
            "verify_maxerr": err,
            "degraded_batches": svc.stats["degraded_batches"],
        }
        if args.method.endswith("tol"):
            its = [done[rid].iters for rid in ids]
            out["tol"] = args.tol
            out["iters_mean"] = round(float(np.mean(its)), 2)
            out["iters_max"] = int(np.max(its))
        out.update(grid)
        return out, 0
    finally:
        if metrics_srv is not None:
            metrics_srv.close()


def _arch_main(args, ap) -> int:
    """Generate for ``--batch`` prompts with the ``--arch`` model (and with
    ``--slots`` drain them through a ``SlotServer``); print the JSON."""
    from ..configs import get, get_smoke, names
    from ..device import resolve_device
    from ..models import model as M
    from ..obs import clock
    from ..serve import SlotServer, generate

    if args.arch not in names():
        ap.error(f"--arch {args.arch!r}: unknown architecture; available: "
                 f"{', '.join(names())}")
    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                           dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab_size, size=(args.batch, args.prompt_len))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = clock.now()
    out = generate(params, cfg, torch.as_tensor(prompts, device=dev),
                   steps=args.gen)
    sync()
    dt = clock.now() - t0
    print("generated:", out[:, :8].cpu().numpy(), "...")
    result = {
        "arch": cfg.name, "batch": args.batch, "gen": args.gen,
        "wall_s": round(dt, 3),
        "tokens_per_s": round(args.batch * args.gen / dt, 1),
    }
    if args.slots:
        srv = SlotServer(params, cfg, batch_slots=args.batch,
                         max_len=args.prompt_len + args.gen + 8)
        ids = [srv.submit(prompts[i], args.gen) for i in range(args.batch)]
        done = {}
        while len(done) < len(ids):
            done.update(srv.step())
        result["slot_server_completed"] = len(done)
    print(json.dumps(result, indent=1))
    return 0


def serve_on_mesh(mesh, cfg, *, batch: int, prompt_len: int, gen: int,
                  variant: str = "", max_len: int | None = None,
                  feed=None) -> dict:
    """Generate ``gen`` tokens for ``batch`` prompts of ``prompt_len``
    tokens on every rank of ``mesh`` (a ``ProcessMesh``), as
    ``--arch`` does in one process: the model drawn from seed 0, each
    param cut to the rank's slice as it is drawn (``init_params(
    placements=)``, placed by ``param_specs(..., cfg.fsdp, ep_stationary=)``),
    the caches allocated as the rank's slices of ``cache_specs``
    (``init_caches(placements=)``), the rank's rows of the launcher's
    prompts (``default_rng(0)``, ids from 1),
    ``serve.generate`` under ``serve.engine.on_mesh``.  ``variant``:
    ``launch.dryrun``'s flags ``int8kv``, ``nofsdp`` (``cfg.fsdp`` off:
    weights-stationary serving), ``sp`` and ``ep``.  ``max_len`` defaults to ``prompt_len + gen``
    (capped at ``cfg.max_seq_len``); ``feed`` ((batch, gen - 1) ids)
    decodes those (``generate``'s teacher forcing).

    Returns ``tokens`` (batch, gen) gathered whole (numpy), ``prefill_ms``
    and ``decode_ms`` (one a decode step, each ended by a device sync,
    the pick of its input token included), and for the prefill then
    each decode step ``wire_bytes`` (``mesh.stats``' bytes this rank
    received, by call), ``stage_s`` and ``comm_s``; ``held_bytes`` (the
    rank's params and caches) and ``device_bytes`` (``sharding.
    device_bytes`` of the specs), ``max_len``, and on a card
    ``peak_bytes`` (``max_memory_allocated`` from the placed params on);
    ``logits``, the prefill's and each step's last position ((batch, V)
    numpy, gathered whole outside the timed step), and ``caches`` (path
    -> the whole leaf after the last step, numpy)."""
    from ..models import model as M
    from ..obs import clock
    from ..serve.engine import generate, on_mesh
    from . import sharding as SH
    from .dryrun import _parse_variant
    from .mesh import batch_axes

    var = _parse_variant(variant)
    if var["int8kv"]:
        cfg = cfg.replace(kv_cache_dtype="int8")
    if var["nofsdp"]:
        cfg = cfg.replace(fsdp=False)
    ep = var["ep"]
    max_len = max_len or min(cfg.max_seq_len, prompt_len + gen)
    dev = mesh.device
    cuda = dev.type == "cuda"
    baxes = batch_axes(mesh)

    shapes = M.init_params(cfg, None, "meta")
    p_specs = SH.param_specs(shapes, cfg.fsdp, mesh, ep)
    pls = SH.named(mesh, p_specs, shapes)
    c_leaves = SH.cache_leaves(M.init_caches(cfg, batch, max_len, "meta"))
    c_specs = SH.cache_specs(c_leaves, baxes, cfg.seq_shard_decode)
    c_pls = SH.named(mesh, c_specs, c_leaves)
    want = (SH.device_bytes(SH.tree_leaves(shapes), p_specs, mesh)
            + SH.device_bytes(c_leaves, c_specs, mesh))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                           placements=pls)

    def rows_of(a):
        a = np.asarray(a)
        return SH.Placement(mesh, (baxes, None), a.shape).shard(a).long()

    tokens = rows_of(np.random.default_rng(0).integers(1, cfg.vocab_size,
                                                       size=(batch, prompt_len)))
    out = {"max_len": max_len, "wire_bytes": [], "stage_s": [], "comm_s": [],
           "step_ms": [], "logits": [], "held_bytes": SH.held_bytes(params),
           "device_bytes": want}
    kept = {}
    clock_at = [0.0]

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def on_step(i, logits, caches):
        sync()
        out["step_ms"].append(1e3 * (clock.now() - clock_at[0]))
        out["wire_bytes"].append({k: v for k, v in mesh.stats.wire_bytes.items() if v})
        out["stage_s"].append(mesh.stats.stage_s)
        out["comm_s"].append(mesh.stats.comm_s)
        if i == 0:
            out["held_bytes"] += SH.held_bytes(SH.cache_leaves(caches))
        lg = logits[:, -1].float()
        spec = (baxes, "model" if lg.shape[-1] < cfg.vocab_size else None)
        whole = SH.Placement(mesh, spec, (batch, cfg.vocab_size)).gather(lg)
        out["logits"].append(whole.cpu().numpy())
        kept["caches"] = caches
        mesh.stats.reset()
        sync()
        clock_at[0] = clock.now()

    with on_mesh(params, cfg, pls, c_pls, max_len, seq_parallel=var["sp"],
                 ep_stationary=ep):
        mesh.stats.reset()
        sync()
        clock_at[0] = clock.now()
        got = generate(params, cfg, tokens, gen, max_len=max_len,
                       feed=None if feed is None else rows_of(feed),
                       on_step=on_step)
    out["prefill_ms"], out["decode_ms"] = out["step_ms"][0], out["step_ms"][1:]
    del out["step_ms"]
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else None
    out["tokens"] = SH.Placement(mesh, (baxes, None), (batch, gen)).gather(
        got).cpu().numpy()
    as_np = lambda t: (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    out["caches"] = {
        "/".join(map(str, path)): np.stack([as_np(t) for t in
                                            c_pls[path].gather_leaf(leaf)])
        for path, leaf in SH.cache_leaves(kept["caches"]).items()}
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="LM generation with this architecture "
                         "(repro_torch.configs.names())")
    ap.add_argument("--smoke", action="store_true",
                    help="--arch: the reduced same-family config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--slots", action="store_true",
                    help="exercise the SlotServer continuous-batching path")
    ap.add_argument("--seed", type=int, default=0,
                    help="--arch: seed of the random weights")
    ap.add_argument("--solver", action="store_true",
                    help="serve sparse solves (continuous-batching service)")
    ap.add_argument("--matrix", default="lap2d_32")
    ap.add_argument("--operators", default="",
                    help="comma-separated suite matrices to register as "
                         "resident operators (overrides --matrix)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--coalesce", type=int, default=8,
                    help="max RHS coalesced into one batched solve")
    ap.add_argument("--chunk", type=int, default=25,
                    help="iterations per continuous-batching chunk")
    ap.add_argument("--load-gen", default="", choices=("", "open", "closed"),
                    help="run the load generator instead of a fixed drain")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="open-loop offered load, requests/second")
    ap.add_argument("--concurrency", type=int, default=4,
                    help="closed-loop client population")
    ap.add_argument("--method", default="pcg_tol",
                    help="pcg_tol (tolerance-stopped) | pcg | cg | ...")
    ap.add_argument("--precond", default="jacobi")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--tol", type=float, default=1e-8,
                    help="relative residual target for --method pcg_tol")
    ap.add_argument("--mesh-shape", default="",
                    help="e.g. 2x2 -- a tile grid; empty = one device")
    ap.add_argument("--processes", action="store_true",
                    help="--solver: run the --mesh-shape grid one process "
                         "a tile (spawned here, or the ranks of torchrun)")
    ap.add_argument("--dist-backend", default="gloo",
                    choices=("gloo", "nccl"),
                    help="torch.distributed backend of --processes: gloo "
                         "stages messages through host memory (ranks may "
                         "share a card); nccl needs a card a rank")
    ap.add_argument("--layout", default="auto",
                    choices=("auto", "halo", "dense"),
                    help="tile-grid comm layout (halo = the compiled pull "
                         "schedule; one device: dense)")
    ap.add_argument("--reorder", default="none", choices=("none", "rcm"),
                    help="bandwidth-reducing RCM reordering")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="expose Prometheus /metrics (+ /metrics.json, "
                         "/trace.json) on this port for the run; 0 picks "
                         "an ephemeral port (printed at startup)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda runs the hand-written kernels; cpu runs "
                         "their plain PyTorch versions")
    return ap


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = _parser()
    args = ap.parse_args(argv)

    if args.solver:
        return _solver_main(args, argv)
    if args.arch is None:
        ap.error("--arch is required unless --solver is given")
    return _arch_main(args, ap)


if __name__ == "__main__":
    raise SystemExit(main())
