"""Serving entry point of the port: the always-on sparse-solve service.

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

The ``--solver`` path of ``repro.launch.serve``, with its flags and its
printed JSON fields, plus ``degraded_batches`` (always 0 on the card,
where a kernel failure raises) and, under ``--load-gen``,
``verify_rel_residual``: the largest true relative residual
``||b - A x|| / ||b||`` of the outcomes.  ``--device cpu`` runs the kernels' plain versions
(the default ``cuda`` raises without a card).  The LM generation demo
(``--arch``) and distributed meshes (``--mesh-shape``) are not ported:
both exit non-zero naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _solver_main(args) -> int:
    """Serve sparse solves through :class:`repro_torch.serve.SolveService`:
    register one operator per ``--operators`` name (or ``--matrix``),
    submit ``--requests`` RHS round-robin, and drain the continuous-
    batching tick loop -- or hand the service to the load generator
    (``--load-gen open|closed``)."""
    import scipy.sparse as sp

    from ..core.plan import SolveSpec
    from ..data.matrices import suite
    from ..obs import clock, start_metrics_server
    from ..serve import SolveService, run_load

    mats = suite("small")
    mats.update(suite("large"))
    names = [s for s in (args.operators.split(",") if args.operators
                         else [args.matrix]) if s]
    for name in names:
        if name not in mats:
            raise SystemExit(
                f"unknown matrix {name!r}; available: {', '.join(sorted(mats))}"
            )

    metrics_srv = None
    if args.metrics_port is not None:
        # scrape target up BEFORE any work so a poller sees the whole run
        metrics_srv = start_metrics_server(port=args.metrics_port)
        print(f"metrics: {metrics_srv.url}")
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
                                  layout=args.layout, reorder=args.reorder)

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
                        "verify_rel_residual": max(rel, default=-1.0)})
            print(json.dumps(res, indent=1))
            return 0

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
        print(json.dumps(out, indent=1))
        return 0
    finally:
        if metrics_srv is not None:
            metrics_srv.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="LM generation demo: not ported (ROADMAP Queue 1 "
                         "item 11)")
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
                    help="distributed meshes: not ported (ROADMAP Queue 1 "
                         "item 10)")
    ap.add_argument("--layout", default="auto",
                    choices=("auto", "halo", "dense"),
                    help="distributed comm layout (one device: dense)")
    ap.add_argument("--reorder", default="none", choices=("none", "rcm"),
                    help="bandwidth-reducing RCM reordering")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="expose Prometheus /metrics (+ /metrics.json, "
                         "/trace.json) on this port for the run; 0 picks "
                         "an ephemeral port (printed at startup)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda runs the hand-written kernels; cpu runs "
                         "their plain PyTorch versions")
    args = ap.parse_args(argv)

    if args.mesh_shape:
        ap.error("--mesh-shape: distributed meshes are not ported yet "
                 "(ROADMAP Queue 1 item 10)")
    if args.arch is not None:
        ap.error("--arch: the LM generation demo is not ported yet "
                 "(ROADMAP Queue 1 item 11)")
    if not args.solver:
        ap.error("--solver is required (the LM demo, --arch, is ROADMAP "
                 "Queue 1 item 11)")
    return _solver_main(args)


if __name__ == "__main__":
    raise SystemExit(main())
