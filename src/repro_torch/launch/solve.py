"""Sparse-solver driver of the port: one solve end to end.

    PYTHONPATH=src python -m repro_torch.launch.solve --matrix lap2d_32 \
        --method pcg_tol --tol 1e-8

    # on a 2x2 tile grid (2d blocks, the compiled halo schedule where it
    # pays; every tile on the one device)
    PYTHONPATH=src python -m repro_torch.launch.solve --matrix lap2d_32 \
        --method pcg_tol --mesh-shape 2x2 --mode 2d --layout auto

runs on the card (``--device cuda``, the default), where the solve is a
plan whose loop round is captured as a CUDA graph and replayed
(``core.loop``); ``--device cpu`` runs the kernels' plain versions on the
host.  ``--format`` picks the storage
format (``auto`` runs the per-matrix rule); ``--matrix stencil:lap2d_1024``
(or ``stencil:lap3d_64``) solves a matrix-free stencil operator.  The
flags and the printed JSON fields are those of ``repro.launch.solve`` for
the options ported so far (``device`` is added); ``b = A x_true`` with
``x_true`` from ``default_rng(0)`` (``b = engine.spmv(x_true)`` for a
stencil), the solve in float64.  ``--mesh-shape RxC`` solves on a tile
grid (``launch.mesh.make_mesh`` over ("data", "model") on ``--device``)
with ``--mode``, ``--layout``, ``--reorder`` and ``--balance``, and the
JSON adds the plan's modeled NoC record (``noc``).

One process a tile:

    # the 2x2 grid as 4 ranks (launch.procs spawns them; gloo stages
    # the messages through host memory, so they may share the card)
    PYTHONPATH=src python -m repro_torch.launch.solve --matrix lap2d_32 \
        --method pcg_tol --mesh-shape 2x2 --processes --dist-backend gloo

``--processes`` runs the ``--mesh-shape`` grid on a
``launch.mesh.ProcessMesh``: it spawns R*C ranks (``launch.procs``), or,
under ``torchrun`` (``RANK``/``WORLD_SIZE`` in the environment), joins
the group torchrun set up.  Rank 0 prints the verdict, the one-process
grid's with ``"processes": R*C`` added.  ``--dist-backend nccl`` needs a
card a rank.

Fault tolerance, as in ``repro.launch.solve``:

    # inject a NaN into the streamed values at iteration 15 and let the
    # chunked restart driver detect it, roll back, and reconverge:
    PYTHONPATH=src python -m repro_torch.launch.solve --matrix lap2d_32 \
        --method pcg_tol --max-iters 400 --inject nan --inject-at 15 \
        --ft-chunk 20

``--inject`` runs ``ft.SolveRestartManager`` with a ``ft.FaultInjector``
(chunks of ``--ft-chunk`` iterations of one injectable plan; a ``delay``
fault sleeps 0.5 s) and prints its report; ``--checkpoint-dir`` persists
the solver state every chunk, and a rerun resumes from it.  The exit code
is 1 unless the report says ``converged``.  The ``halo_*`` kinds need a
tile grid (``--mesh-shape``) and raise without one.  With ``--processes``
every rank runs the restart manager (``ft.SolveRestartManager`` on its
``ProcessMesh``: the faults drawn over the whole grid, each rank
corrupting its own tile; only rank 0 writes ``--checkpoint-dir``); rank
0 prints the one-process grid's report with ``"processes": R*C`` added,
and every rank exits 1 unless it says ``converged``:

    PYTHONPATH=src python -m repro_torch.launch.solve --matrix lap2d_32 \
        --method pcg_tol --mesh-shape 2x2 --processes --inject halo_drop \
        --inject-at 15 --ft-chunk 20 --checkpoint-dir ckpt
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import scipy.sparse as sp

from ..core import registry


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--matrix", default="lap2d_32")
    ap.add_argument("--method", default="pcg",
                    choices=registry.solver_names())
    ap.add_argument("--precond", default="jacobi",
                    choices=("jacobi", "block_ic0", "none"))
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--tol", type=float, default=1e-8,
                    help="relative residual target (the *_tol methods)")
    ap.add_argument("--max-iters", type=int, default=None,
                    help="iteration cap of the *_tol methods (default: "
                         "--iters)")
    ap.add_argument("--fused", default="auto", choices=("auto", "on", "off"),
                    help="fused-substrate knob (auto = on where supported)")
    ap.add_argument("--format", default="auto", dest="fmt",
                    choices=("auto", "ell", "sell", "hyb", "bcsr"),
                    help="operator storage format (auto = per-matrix "
                         "rule; a tile grid streams padded ELL)")
    ap.add_argument("--mode", default="2d", choices=("1d", "2d"))
    ap.add_argument("--mesh-shape", default="",
                    help="e.g. 2x2 -- a tile grid; empty = one device")
    ap.add_argument("--processes", action="store_true",
                    help="run the --mesh-shape grid one process a tile "
                         "(spawned here, or the ranks of torchrun)")
    ap.add_argument("--dist-backend", default="gloo",
                    choices=("gloo", "nccl"),
                    help="torch.distributed backend of --processes: gloo "
                         "stages messages through host memory (ranks may "
                         "share a card); nccl needs a card a rank")
    ap.add_argument("--layout", default="auto",
                    choices=("auto", "halo", "dense"),
                    help="tile-grid comm layout: halo = the compiled pull "
                         "schedule, dense = blanket collectives, auto = "
                         "halo where it moves fewer bytes")
    ap.add_argument("--reorder", default="none", choices=("none", "rcm"),
                    help="bandwidth-reducing RCM reordering (shrinks halos)")
    ap.add_argument("--balance", default="nnz", choices=("nnz", "rows"),
                    help="row-block load balance (nnz = prefix-sum splits)")
    ap.add_argument("--no-guard", action="store_true",
                    help="disable in-loop numerical health guards (status "
                         "reports 'unguarded')")
    ap.add_argument("--inject", default="",
                    choices=("", "nan", "bitflip", "halo_drop",
                             "halo_perturb", "delay"),
                    help="inject a deterministic fault (ft.inject) and "
                         "recover via the chunked restart driver")
    ap.add_argument("--inject-at", type=int, default=10,
                    help="global solver iteration the fault fires at")
    ap.add_argument("--inject-seed", type=int, default=0)
    ap.add_argument("--ft-chunk", type=int, default=25,
                    help="restart-driver chunk size (iterations between "
                         "verify/checkpoint points)")
    ap.add_argument("--checkpoint-dir", default="",
                    help="persist solver state every chunk; reruns resume")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda runs the hand-written kernels; cpu runs "
                         "their plain PyTorch versions")
    return ap


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if args.processes:
        return _processes(args, argv)
    out, rc = verdict(args)
    print(json.dumps(out, indent=1))
    return rc


def _processes(args, argv) -> int:
    """``--processes``: the solve on every rank of a process grid; rank 0
    prints the verdict."""
    if not args.mesh_shape:
        raise SystemExit("--processes needs --mesh-shape")
    shape = tuple(int(x) for x in args.mesh_shape.split("x"))
    size = int(np.prod(shape))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        from .mesh import leave_process_group, make_process_mesh

        mesh = make_process_mesh(shape, ("data", "model")[: len(shape)],
                                 backend=args.dist_backend,
                                 device=args.device)
        out, rc = verdict(args, mesh)
        if mesh.rank == 0:
            print(json.dumps(out, indent=1), flush=True)
        leave_process_group(mesh)
        return rc
    from . import procs

    out, rc = procs.run(_rank_verdict, size, (argv,),
                        backend=args.dist_backend, device=args.device)[0]
    print(json.dumps(out, indent=1))
    return rc


def _rank_verdict(rank, argv: list) -> tuple:
    """A spawned rank of ``--processes``: its (verdict, exit code)."""
    args = _parser().parse_args(argv)
    shape = tuple(int(x) for x in args.mesh_shape.split("x"))
    return verdict(args, rank.mesh(shape, ("data", "model")[: len(shape)]))


def verdict(args, mesh=None) -> tuple:
    """(the printed JSON, the exit code) of one solve; ``mesh`` a rank's
    ``ProcessMesh`` under ``--processes``."""
    from ..core.engine import AzulEngine
    from ..core.plan import SolveSpec
    from ..data.matrices import suite

    if args.matrix.startswith("stencil:"):
        # a matrix-free operator, e.g. stencil:lap2d_1024: no assembled CSR
        from ..core.stencil import lap2d_stencil, lap3d_stencil
        kind, _, size = args.matrix[len("stencil:"):].partition("_")
        m = {"lap2d": lap2d_stencil, "lap3d": lap3d_stencil}[kind](int(size))
    else:
        mats = suite("small")
        if args.matrix not in mats:
            mats.update(suite("large"))
        m = mats[args.matrix]

    if mesh is None and args.mesh_shape:
        from .mesh import make_mesh
        shape = tuple(int(x) for x in args.mesh_shape.split("x"))
        mesh = make_mesh(shape, ("data", "model")[: len(shape)],
                         device=args.device)

    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(m.shape[0])
    fused = {"auto": "auto", "on": True, "off": False}[args.fused]
    eng = AzulEngine(m, mesh=mesh, mode=args.mode, precond=args.precond,
                     balance=args.balance, dtype=np.float64, fused=fused,
                     layout=args.layout, reorder=args.reorder,
                     format=args.fmt, device=args.device)
    if hasattr(m, "indptr"):
        a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
        b = a @ x_true
        nnz = m.nnz
    else:
        b = np.asarray(eng.spmv(x_true))   # matrix-free: no CSR to multiply
        nnz = m.nnz_equiv

    spec = SolveSpec(method=args.method, iters=args.iters, tol=args.tol,
                     max_iters=args.max_iters, fused=fused,
                     layout=args.layout, guard=not args.no_guard)
    if args.inject:
        # the fault-injected solve through the chunked restart driver:
        # detect, roll back to the last verified state, reconverge
        from ..ft import (FaultInjector, FaultSpec, SolveRestartManager,
                          StepTimer)
        mgr = SolveRestartManager(
            eng, spec, chunk=args.ft_chunk,
            checkpoint_dir=args.checkpoint_dir or None, timer=StepTimer())
        inj = FaultInjector(eng, FaultSpec(
            kind=args.inject, iteration=args.inject_at,
            seed=args.inject_seed, delay_s=0.5))
        rep = mgr.solve(b, injector=inj)
        rel = float(np.linalg.norm(rep.x - x_true) / np.linalg.norm(x_true))
        out = {
            "matrix": args.matrix, "n": m.shape[0], "nnz": nnz,
            "method": args.method, "precond": args.precond,
            "mode": eng.mode, "injected": args.inject,
            "injected_at": args.inject_at,
            "status": rep.status, "iterations": rep.iterations,
            "chunks": rep.chunks, "restarts": rep.restarts,
            "faults": rep.faults, "resumed_from": rep.resumed_from,
            "straggler_chunks": rep.straggler_chunks,
            "rel_residual": rep.rel_residual, "rel_error": rel,
            "device": str(eng.device),
        }
        if args.processes:
            out["processes"] = mesh.size
        return out, 0 if rep.status == "converged" else 1

    plan = eng.plan(spec)
    x, norms = plan(b)
    rel = float(np.linalg.norm(x - x_true) / np.linalg.norm(x_true))
    out = {
        "matrix": args.matrix, "n": m.shape[0], "nnz": nnz,
        "method": args.method, "precond": args.precond,
        "iters": args.iters, "mode": eng.mode,
        "substrate": plan.info["substrate"],
        "fused": bool(plan.spec.fused),
        "format": plan.info["format"],
        "layout": plan.info["layout"],
        "reorder": plan.info["reorder"],
        "final_residual": float(norms[-1]),
        "rel_error": rel,
        "status": plan.last_status_names,
        "bad_iter": int(plan.last_bad_iter),
        "device": str(eng.device),
    }
    if "noc" in plan.info:
        out["noc"] = plan.info["noc"]
    if plan.spec.tol is not None:
        out["tol"] = plan.spec.tol
        out["iters_run"] = int(plan.last_iters)
    if args.processes:
        out["processes"] = mesh.size
    return out, 0


if __name__ == "__main__":
    raise SystemExit(main())
