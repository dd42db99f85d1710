"""Sparse-solver driver of the port: one local solve end to end.

    PYTHONPATH=src python -m repro_torch.launch.solve --matrix lap2d_32 \
        --method pcg_tol --tol 1e-8

runs on the card (``--device cuda``, the default); ``--device cpu`` runs
the kernels' plain versions on the host.  ``--format`` picks the storage
format (``auto`` runs the per-matrix rule); ``--matrix stencil:lap2d_1024``
(or ``stencil:lap3d_64``) solves a matrix-free stencil operator.  The
flags and the printed JSON fields are those of ``repro.launch.solve`` for
the options ported so far (``device`` is added); ``b = A x_true`` with
``x_true`` from ``default_rng(0)`` (``b = engine.spmv(x_true)`` for a
stencil), the solve in float64.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import scipy.sparse as sp


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--matrix", default="lap2d_32")
    ap.add_argument("--method", default="pcg", choices=("pcg", "pcg_tol"))
    ap.add_argument("--precond", default="jacobi",
                    choices=("jacobi", "block_ic0", "none"))
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--tol", type=float, default=1e-8,
                    help="relative residual target (pcg_tol)")
    ap.add_argument("--max-iters", type=int, default=None,
                    help="iteration cap for pcg_tol (default: --iters)")
    ap.add_argument("--fused", default="auto", choices=("auto", "on", "off"),
                    help="fused-substrate knob (auto = on where supported)")
    ap.add_argument("--format", default="auto", dest="fmt",
                    choices=("auto", "ell", "sell", "hyb", "bcsr"),
                    help="operator storage format (auto = per-matrix rule)")
    ap.add_argument("--no-guard", action="store_true",
                    help="disable in-loop numerical health guards (status "
                         "reports 'unguarded')")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda runs the hand-written kernels; cpu runs "
                         "their plain PyTorch versions")
    args = ap.parse_args(argv)

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

    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(m.shape[0])
    fused = {"auto": "auto", "on": True, "off": False}[args.fused]
    eng = AzulEngine(m, precond=args.precond, dtype=np.float64, fused=fused,
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
                     guard=not args.no_guard)
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
    if plan.spec.tol is not None:
        out["tol"] = plan.spec.tol
        out["iters_run"] = int(plan.last_iters)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
