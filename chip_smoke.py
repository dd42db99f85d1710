#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Phases (one output line or more each; any failure exits non-zero and
prints no result line):

1. build    -- compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
               (nvcc, sm_90a) and load them; print the build time and the
               card's name and power limit.
2. kernels  -- hold each kernel against its plain PyTorch version on the
               card, in float64 and float32, at ragged sizes and at the
               main-path shape (1,048,576 x 8); the batched kernels at
               k = 1, 3 and 8 (k = 8 at the main shape).  Tolerance,
               because only the summation order differs: max |kernel -
               plain| <= rtol * max |plain| with rtol 1e-12 (float64) and
               1e-5 (float32); p', x', r' and z bitwise equal.  Lane
               independence: lane j of a k = 8 batched call equals the
               k = 1 call on lane j's inputs bit for bit, every output.
3. parity   -- lap2d_32 and banded_1k, float64 Jacobi pcg_tol at tol 1e-8,
               against the JAX package's iteration counts (94 and 9); the
               card may sum in another order, so +-1 iteration passes.
               Then the same batched at k = 4 against the JAX package's
               per-lane counts (PARITY_BATCHED), +-1 a lane, every lane
               converged.
4. main     -- the full-size main path through the normal entry points:
               laplacian_2d(1024) (n = 1,048,576), ``AzulEngine`` ->
               ``plan(SolveSpec(method="pcg_tol", tol=1e-8,
               max_iters=10000))`` -> ``plan(b)`` in float64, with
               ``b = A x_true`` and ``x_true`` from ``default_rng(0)`` as
               ``launch/solve.py`` builds it.  Launch counts are zeroed
               just before and read just after; both per-iteration kernels
               must run once per iteration and ell_spmv at least once, and
               the true relative residual ``||b - A x|| / ||b||`` (scipy,
               float64, on the host) must be <= 1e-7.  Then the same solve
               on the reference substrate (``fused=False``: plain PyTorch
               on the card) must end with the same status within 1% of
               the iterations.  Where the guarded solve stops on the stall
               guard (no new best residual for STALL_WINDOW iterations),
               the unguarded solve must reach the tolerance.
               Then the batched main path: k = 8 right-hand sides
               ``B = X_true A^T``, ``X_true = default_rng(0)
               .standard_normal((8, n))`` (so lane 0 solves the b above),
               through ``plan(SolveSpec(method="pcg_tol", batch=8, ...))``,
               launch counts zeroed just before and read just after: the
               two batched per-iteration kernels once per loop step,
               ell_spmm at least once, no 1-D kernel.  Every lane's true
               relative residual <= 1e-7; lanes 0 and 5 solved again as
               k = 1 plans end with the same count, status and bad_iter
               and a bitwise-equal trace; lane 0 ends as the 1-D solve
               did, within 1% of its iterations; the reference substrate
               gives the same statuses within 1%.
5. times    -- each kernel at the main-path shape (k = 8 for the batched
               ones): CUDA-event time of a CUDA-graph replay (median of
               five windows), the time when launched from Python, the
               plain version's time, the least time the card could take
               (bytes / 3.35 TB/s, or operations / peak rate), and one
               PyTorch CSR product as the library yardstick where there
               is one.  Then fixed-iteration pcg (100 iterations) at
               lap2d_1024 for k = 1, 4, 8, 16: us per iteration and per
               right-hand side per iteration.

The last three lines are the kernels JSON, the card's
``nvidia-smi --query-gpu=name,power.limit`` line, and the result JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}   # non-tensor-core peaks
RTOL = {"float64": 1e-12, "float32": 1e-5}
PARITY = {"lap2d_32": 94, "banded_1k": 9}           # JAX package, CPU f64
# per-lane counts of the JAX package (CPU, f64, Jacobi pcg_tol, tol 1e-8)
# for B = default_rng(0).standard_normal((4, n)), one fresh rng per matrix
PARITY_BATCHED = {"lap2d_32": (102, 98, 102, 102), "banded_1k": (9, 9, 9, 9)}
MAIN_BATCH = 8                     # launch/serve.py --coalesce default
BATCH_LANES_AGAIN = (0, 5)         # lanes re-solved as k = 1 plans
SWEEP_BATCHES = (1, 4, 8, 16)
SWEEP_ITERS = 100
MAIN_GRID = 1024                   # laplacian_2d(1024): n = 1,048,576
MAIN_TOL = 1e-8
MAIN_MAX_ITERS = 10000
MAIN_MAX_TRUE_RESIDUAL = 1e-7      # ||b - A x|| / ||b|| in f64 on the host

SOURCES = {
    "ell_spmv": ("src/repro_torch/kernels/csrc/ell_spmv.cu",
                 "src/repro/kernels/ell_spmv.py:53"),
    "ell_spmv_pfold_dot": ("src/repro_torch/kernels/csrc/spmv_dot.cu",
                           "src/repro/kernels/spmv_dot.py:217"),
    "cg_update": ("src/repro_torch/kernels/csrc/vecops.cu",
                  "src/repro/kernels/vecops.py:157"),
    "ell_spmm": ("src/repro_torch/kernels/csrc/ell_spmv.cu",
                 "src/repro/kernels/ell_spmv.py:106"),
    "ell_spmm_pfold_dot": ("src/repro_torch/kernels/csrc/spmv_dot.cu",
                           "src/repro/kernels/spmv_dot.py:296"),
    "cg_update_batched": ("src/repro_torch/kernels/csrc/vecops.cu",
                          "src/repro/kernels/vecops.py:124"),
}
SOURCES_BATCHED = ("ell_spmm", "ell_spmm_pfold_dot", "cg_update_batched")


def say(*parts) -> None:
    print(*parts, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def longest_stall(norms) -> int:
    """Longest run of iterations with no new best residual norm (the
    quantity the solver's stall guard compares with STALL_WINDOW)."""
    best, since, worst = float("inf"), 0, 0
    for v in norms:
        since = 0 if v < best else since + 1
        best = min(best, v)
        worst = max(worst, since)
    return worst


def _median_ms(run, reps: int, windows: int) -> float:
    """CUDA events around ``run()`` (which does ``reps`` calls); the median
    over ``windows`` runs, per call."""
    import torch

    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return sorted(times)[len(times) // 2]


def eager_ms(fn, reps: int = 50, windows: int = 5) -> float:
    """Milliseconds per call launched from Python back to back: device time
    plus whatever host time the launches leave the card idle."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return _median_ms(lambda: [fn() for _ in range(reps)], reps, windows)


def device_ms(fn, reps: int = 20, windows: int = 5) -> float:
    """Milliseconds per call on the card alone: ``reps`` calls captured in
    one CUDA graph and replayed, so no host time sits between launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_ms(graph.replay, reps, windows)


def compare(name: str, got, want, dtype: str) -> float:
    """max |got - want| over a tuple of outputs; raises past the tolerance
    (relative to max |want| of each output)."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        if not err <= RTOL[dtype] * max(scale, 1e-300):
            raise AssertionError(f"{name} output {i}: max abs err {err:.3e} "
                                 f"vs scale {scale:.3e} (rtol {RTOL[dtype]})")
        worst = max(worst, err)
    return worst


def random_ell(rows: int, width: int, nnz_per_row: int, dtype, gen):
    """A random square padded-ELL operator on the card: ``nnz_per_row``
    random columns and values per row, zero padding to ``width``."""
    import torch

    dev = gen.device
    cols = torch.zeros(rows, width, dtype=torch.int32, device=dev)
    vals = torch.zeros(rows, width, dtype=dtype, device=dev)
    cols[:, :nnz_per_row] = torch.randint(0, rows, (rows, nnz_per_row),
                                          generator=gen, device=dev,
                                          dtype=torch.int32)
    vals[:, :nnz_per_row] = torch.randn(rows, nnz_per_row, generator=gen,
                                        device=dev, dtype=dtype)
    return cols, vals


def check_kernels(cols, vals, dtype: str, gen, label: str) -> dict:
    """Each kernel against its plain version on one operator; returns the
    max abs error per kernel."""
    import torch
    from repro_torch.kernels import ell_spmv, spmv_dot, vecops

    rows = cols.shape[0]
    td = vals.dtype
    vec = lambda: torch.randn(rows, generator=gen, device=vals.device, dtype=td)
    x, z, p, r, ap = vec(), vec(), vec(), vec(), vec()
    dinv = vec().abs() + 0.5
    errs = {}
    errs["ell_spmv"] = compare(
        f"ell_spmv {label}", (ell_spmv.ell_spmv(cols, vals, x),),
        (ell_spmv.ell_spmv_plain(cols, vals, x),), dtype)
    e = 0.0
    for beta in (0.0, 0.37):
        bt = torch.tensor(beta, dtype=td, device=vals.device)
        got = spmv_dot.ell_spmv_pfold_dot(cols, vals, z, p, bt)
        want = spmv_dot.ell_spmv_pfold_dot_plain(cols, vals, z, p, bt)
        e = max(e, compare(f"ell_spmv_pfold_dot {label} beta={beta}",
                           got, want, dtype))
        if not torch.equal(got[0], want[0]):
            raise AssertionError("ell_spmv_pfold_dot: p' differs from z + beta*p")
    errs["ell_spmv_pfold_dot"] = e
    e = 0.0
    alpha = torch.tensor(0.61, dtype=td, device=vals.device)
    for dv in (dinv, None):
        got = vecops.cg_update(alpha, x, r, p, ap, dv)
        want = vecops.cg_update_plain(alpha, x, r, p, ap, dv)
        e = max(e, compare(f"cg_update {label} dinv={dv is not None}",
                           got, want, dtype))
        for i in range(3):
            if not torch.equal(got[i], want[i]):
                raise AssertionError(f"cg_update output {i} is not bitwise "
                                     "equal to the plain version")
    errs["cg_update"] = e
    return errs


def check_batched_kernels(cols, vals, dtype: str, gen, label: str,
                          ks=(1, 3, 8)) -> dict:
    """Each batched kernel against its plain version at each k, then lane
    independence at the widest k: lane j equals the k = 1 call on lane j's
    inputs bit for bit, every output.  Returns the max abs error per
    kernel."""
    import torch
    from repro_torch.kernels import ell_spmv, spmv_dot, vecops

    rows = cols.shape[0]
    td, dev = vals.dtype, vals.device
    lanes = lambda k: torch.randn(k, rows, generator=gen, device=dev, dtype=td)
    dinv = torch.randn(rows, generator=gen, device=dev, dtype=td).abs() + 0.5
    errs = {"ell_spmm": 0.0, "ell_spmm_pfold_dot": 0.0, "cg_update_batched": 0.0}
    for k in ks:
        x, z, p, r, ap = (lanes(k) for _ in range(5))
        beta = torch.linspace(0.0, 0.9, k, dtype=td, device=dev)   # holds a 0
        alpha = torch.linspace(0.1, 0.9, k, dtype=td, device=dev).reshape(k, 1)
        tag = f"{label} k={k}"
        errs["ell_spmm"] = max(errs["ell_spmm"], compare(
            f"ell_spmm {tag}", (ell_spmv.ell_spmm(cols, vals, x),),
            (ell_spmv.ell_spmm_plain(cols, vals, x),), dtype))
        got = spmv_dot.ell_spmm_pfold_dot(cols, vals, z, p, beta)
        want = spmv_dot.ell_spmm_pfold_dot_plain(cols, vals, z, p, beta)
        errs["ell_spmm_pfold_dot"] = max(errs["ell_spmm_pfold_dot"], compare(
            f"ell_spmm_pfold_dot {tag}", got, want, dtype))
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"ell_spmm_pfold_dot {tag}: P' differs from "
                                 "Z + beta*P")
        for dv in (dinv, None):
            got = vecops.cg_update_batched(alpha, x, r, p, ap, dv)
            want = vecops.cg_update_plain(alpha, x, r, p, ap, dv)
            errs["cg_update_batched"] = max(errs["cg_update_batched"], compare(
                f"cg_update_batched {tag} dinv={dv is not None}", got, want,
                dtype))
            for i in range(3):
                if not torch.equal(got[i], want[i]):
                    raise AssertionError(f"cg_update_batched {tag}: output {i} "
                                         "is not bitwise equal to the plain "
                                         "version")
    k = ks[-1]              # lane independence on the last, widest inputs

    def outputs(sl):
        return (ell_spmv.ell_spmm(cols, vals, x[sl]),
                *spmv_dot.ell_spmm_pfold_dot(cols, vals, z[sl], p[sl], beta[sl]),
                *vecops.cg_update_batched(alpha[sl], x[sl], r[sl], p[sl],
                                          ap[sl], dinv),
                *vecops.cg_update_batched(alpha[sl], x[sl], r[sl], p[sl],
                                          ap[sl]))

    wide = outputs(slice(0, k))
    for j in range(k):
        sl = slice(j, j + 1)
        for i, (w, one) in enumerate(zip(wide, outputs(sl))):
            if not torch.equal(w[sl], one):
                raise AssertionError(f"lane independence {label}: lane {j} of "
                                     f"k={k}, output {i}, differs from k=1")
    return errs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    import numpy as np
    import scipy.sparse as sp

    from repro_torch.core.engine import AzulEngine
    from repro_torch.core.plan import SolveSpec
    from repro_torch.core.solvers import STALL_WINDOW
    from repro_torch.data.matrices import laplacian_2d, suite
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import ell_spmv, spmv_dot, vecops
    from repro_torch.obs.clock import now

    failed: list[str] = []
    card = torch.cuda.get_device_name(0)
    smi = smi_line()
    say(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")

    # -- 1. build ------------------------------------------------------------
    t0 = now()
    build.library()
    build_s = now() - t0
    log = (build.BUILD_ROOT / build.build_key() / "build.log")
    for line in log.read_text().splitlines() if log.exists() else ():
        if "registers" in line or "spill" in line or line.startswith("=="):
            say("  nvcc:", line.strip())
    say(f"build ok: {build_s:.1f} s into {build.BUILD_ROOT / build.build_key()}")
    say(f"card: {smi}")

    # -- 2. kernels vs plain versions ---------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    m_main = laplacian_2d(MAIN_GRID)
    main_errs = {}
    try:
        for dname, np_dt in (("float64", np.float64), ("float32", np.float32)):
            td = getattr(torch, dname)
            for rows, width, k in ((1000, 5, 5), (4099, 8, 7)):
                cols, vals = random_ell(rows, width, k, td, gen)
                errs = check_kernels(cols, vals, dname, gen,
                                     f"{dname} {rows}x{width}")
                errs |= check_batched_kernels(cols, vals, dname, gen,
                                              f"{dname} {rows}x{width}")
                say(f"kernels {dname} {rows}x{width}: max abs err "
                    + json.dumps({k2: float(v) for k2, v in errs.items()}))
            eng = AzulEngine(m_main, dtype=np_dt)
            errs = check_kernels(eng.ell.cols, eng.ell.vals, dname, gen,
                                 f"{dname} main")
            errs |= check_batched_kernels(eng.ell.cols, eng.ell.vals, dname,
                                          gen, f"{dname} main",
                                          ks=(MAIN_BATCH,))
            say(f"kernels {dname} main {tuple(eng.ell.cols.shape)}: max abs "
                "err " + json.dumps({k2: float(v) for k2, v in errs.items()}))
            if dname == "float64":
                main_errs = errs
            del eng
        say("kernels ok (rtol f64 1e-12, f32 1e-5: summation order; batched "
            "lanes independent of k, bitwise); launches so far "
            + json.dumps(ops.launch_counts()))
    except Exception:
        traceback.print_exc()
        failed.append("kernels")

    # -- 3. parity on the small suite ---------------------------------------
    try:
        rng = np.random.default_rng(0)
        mats = suite("small")
        for name, want in PARITY.items():
            m = mats[name]
            a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
            b = a @ rng.standard_normal(m.shape[0])
            eng = AzulEngine(m, dtype=np.float64)
            plan = eng.plan(SolveSpec(method="pcg_tol", tol=1e-8, max_iters=400))
            plan(b)
            got = int(plan.last_iters)
            say(f"parity {name}: {got} iterations (JAX package: {want}), "
                f"status {plan.last_status_names}")
            if abs(got - want) > 1 or plan.last_status_names != "converged":
                raise AssertionError(f"parity {name}: {got} iterations, "
                                     f"status {plan.last_status_names}")
        for name, want in PARITY_BATCHED.items():
            m = mats[name]
            b = np.random.default_rng(0).standard_normal((len(want), m.shape[0]))
            eng = AzulEngine(m, dtype=np.float64)
            plan = eng.plan(SolveSpec(method="pcg_tol", tol=1e-8, max_iters=400,
                                      batch=len(want)))
            plan(b)
            got = [int(i) for i in plan.last_iters]
            say(f"parity batched {name} k={len(want)}: {got} iterations (JAX "
                f"package: {list(want)}), status {plan.last_status_names}")
            if (any(abs(g - w) > 1 for g, w in zip(got, want))
                    or plan.last_status_names != ["converged"] * len(want)):
                raise AssertionError(f"parity batched {name}: {got}, "
                                     f"{plan.last_status_names}")
    except Exception:
        traceback.print_exc()
        failed.append("parity")

    # -- 4. the full-size main path -----------------------------------------
    launches, us_per_iter = {}, None
    try:
        m = m_main
        a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
        x_true = np.random.default_rng(0).standard_normal(m.shape[0])
        b = a @ x_true
        t0 = now()
        eng = AzulEngine(m, dtype=np.float64)
        setup_s = now() - t0
        say(f"main: n={eng.n} nnz={m.nnz} ell={tuple(eng.ell.cols.shape)} "
            f"resident={eng.device_bytes()} bytes, engine build {setup_s:.2f} s")

        def solve(label: str, **knobs) -> dict:
            """One plan(b) on the main path; launch counts are zeroed just
            before it and read just after."""
            plan = eng.plan(SolveSpec(method="pcg_tol", tol=MAIN_TOL,
                                      max_iters=MAIN_MAX_ITERS, **knobs))
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = now()
            x, norms = plan(b)
            torch.cuda.synchronize()
            wall = now() - t0
            iters = int(plan.last_iters)
            out = {
                "substrate": plan.info["substrate"], "guard": plan.spec.guard,
                "iters_run": iters, "status": plan.last_status_names,
                "bad_iter": int(plan.last_bad_iter),
                "rel_error": float(np.linalg.norm(x - x_true)
                                   / np.linalg.norm(x_true)),
                "true_rel_residual": float(np.linalg.norm(b - a @ x)
                                           / np.linalg.norm(b)),
                "longest_stall": longest_stall(norms[: iters + 1]),
                "wall_s": wall, "us_per_iter": wall / max(iters, 1) * 1e6,
                "launches": ops.launch_counts(),
            }
            say(f"main {label}: " + json.dumps(out))
            if not out["true_rel_residual"] <= MAIN_MAX_TRUE_RESIDUAL:
                raise AssertionError(f"main {label}: true relative residual "
                                     f"{out['true_rel_residual']:.3e}")
            return out

        fused = solve("fused")
        launches, iters = fused["launches"], fused["iters_run"]
        us_per_iter = fused["us_per_iter"]
        if (launches["ell_spmv_pfold_dot"] != iters
                or launches["cg_update"] != iters or launches["ell_spmv"] < 1):
            raise AssertionError(f"launch counts {launches} for {iters} iterations")
        ref = solve("reference", fused=False)
        if (abs(ref["iters_run"] - iters) > 0.01 * iters
                or ref["status"] != fused["status"]
                or any(ref["launches"].values())):
            raise AssertionError(f"reference substrate: {ref['iters_run']} "
                                 f"iterations, status {ref['status']}, vs "
                                 f"{iters}, {fused['status']}")
        if fused["status"] != "converged":
            # the guard's stall window (100 iterations with no new best
            # residual) can end the solve on the residual plateaus of large
            # Laplacians; the unguarded solve must then reach the tolerance
            lean = solve("unguarded", guard=False)
            if not (lean["iters_run"] < MAIN_MAX_ITERS
                    and fused["status"] == "stagnated"
                    and lean["longest_stall"] >= STALL_WINDOW):
                raise AssertionError(f"main path: status {fused['status']}, "
                                     f"unguarded {lean}")
    except Exception:
        traceback.print_exc()
        failed.append("main")

    # -- 4b. the full-size batched main path --------------------------------
    launches_b, us_per_iter_b = {}, None
    try:
        k = MAIN_BATCH
        x_lanes = np.random.default_rng(0).standard_normal((k, m_main.shape[0]))
        B = (a @ x_lanes.T).T                # lane j: b_j = A x_lanes[j]
        say(f"main batched: k={k}; lane 0 is the 1-D solve's x_true: "
            f"{np.array_equal(x_lanes[0], x_true)}, its b: "
            f"{np.array_equal(B[0], b)}")

        def solve_batched(label: str, lanes=None, **knobs):
            """One batched plan(B) on the main path (the rows ``lanes`` of B,
            or all); launch counts zeroed just before, read just after."""
            Bk = B if lanes is None else B[list(lanes)]
            plan = eng.plan(SolveSpec(method="pcg_tol", tol=MAIN_TOL,
                                      max_iters=MAIN_MAX_ITERS,
                                      batch=Bk.shape[0], **knobs))
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = now()
            X, norms = plan(Bk)
            torch.cuda.synchronize()
            wall = now() - t0
            iters = np.asarray(plan.last_iters)
            steps = int(iters.max())
            res = (np.linalg.norm(Bk - (a @ X.T).T, axis=1)
                   / np.linalg.norm(Bk, axis=1))
            out = {
                "substrate": plan.info["substrate"], "k": Bk.shape[0],
                "iters_run": iters.tolist(), "loop_steps": steps,
                "status": plan.last_status_names,
                "bad_iter": np.asarray(plan.last_bad_iter).tolist(),
                "true_rel_residual": res.tolist(),
                "wall_s": wall, "us_per_iter": wall / max(steps, 1) * 1e6,
                "us_per_iter_per_rhs": wall / max(steps, 1) * 1e6 / Bk.shape[0],
                "launches": ops.launch_counts(),
            }
            say(f"main batched {label}: " + json.dumps(out))
            if not np.all(res <= MAIN_MAX_TRUE_RESIDUAL):
                raise AssertionError(f"main batched {label}: true relative "
                                     f"residuals {res}")
            return out, iters, norms

        fb, iters_b, norms_b = solve_batched("fused")
        launches_b, steps = fb["launches"], fb["loop_steps"]
        us_per_iter_b = fb["us_per_iter"]
        one_d = ("ell_spmv", "ell_spmv_pfold_dot", "cg_update")
        if (launches_b["ell_spmm_pfold_dot"] != steps
                or launches_b["cg_update_batched"] != steps
                or launches_b["ell_spmm"] < 1
                or any(launches_b[nm] for nm in one_d)):
            raise AssertionError(f"batched launch counts {launches_b} for "
                                 f"{steps} loop steps")
        for j in BATCH_LANES_AGAIN:
            solo, it1, norms1 = solve_batched(f"lane {j} alone", lanes=(j,))
            it = int(iters_b[j])
            if (it1[0] != it or solo["status"][0] != fb["status"][j]
                    or solo["bad_iter"][0] != fb["bad_iter"][j]
                    or not np.array_equal(norms1[: it + 1, 0],
                                          norms_b[: it + 1, j])):
                raise AssertionError(f"lane {j}: k={k} gives {it} iterations, "
                                     f"{fb['status'][j]}; alone {solo}")
        if (fb["status"][0] != fused["status"]
                or abs(int(iters_b[0]) - iters) > 0.01 * iters):
            raise AssertionError(f"lane 0: {iters_b[0]} iterations, "
                                 f"{fb['status'][0]}; 1-D solve {iters}, "
                                 f"{fused['status']}")
        ref_b, iters_ref, _ = solve_batched("reference", fused=False)
        if (ref_b["status"] != fb["status"]
                or np.any(np.abs(iters_ref - iters_b) > 0.01 * iters_b)
                or any(ref_b["launches"].values())):
            raise AssertionError(f"batched reference substrate: {ref_b}")
        say(f"main batched ok: {us_per_iter_b:.1f} us per iteration, "
            f"{us_per_iter_b / k:.1f} us per RHS per iteration (1-D: "
            f"{us_per_iter:.1f})")
    except Exception:
        traceback.print_exc()
        failed.append("main batched")

    # -- 5. times at the main-path shape ------------------------------------
    rows_out = []
    try:
        eng = AzulEngine(m_main, dtype=np.float64)
        cols, vals = eng.ell.cols, eng.ell.vals
        rows, w = cols.shape
        e = vals.element_size()
        k = MAIN_BATCH
        gen = torch.Generator(device="cuda").manual_seed(1)
        vec = lambda *lead: torch.randn(*lead, rows, generator=gen,
                                        device="cuda", dtype=torch.float64)
        x, z, p, r, ap = vec(), vec(), vec(), vec(), vec()
        X, Z, P, R, AP = (vec(k) for _ in range(5))
        dinv = eng._dinv_pad
        beta = torch.tensor(0.37, dtype=torch.float64, device="cuda")
        alpha = torch.tensor(0.61, dtype=torch.float64, device="cuda")
        betas = torch.linspace(0.1, 0.9, k, dtype=torch.float64, device="cuda")
        alphas = torch.linspace(0.2, 0.8, k, dtype=torch.float64,
                                device="cuda").reshape(k, 1)
        a = sp.csr_matrix((m_main.data, m_main.indices, m_main.indptr),
                          shape=m_main.shape)
        a_lib = torch.sparse_csr_tensor(
            torch.as_tensor(a.indptr, dtype=torch.int64),
            torch.as_tensor(a.indices, dtype=torch.int64),
            torch.as_tensor(a.data, dtype=torch.float64),
            size=a.shape).to("cuda")
        X_nk = X[:, : a.shape[0]].T.contiguous()      # the (n, k) dense operand
        mat_bytes = rows * w * (4 + e)
        # name -> (kernel, plain, bytes, flops, library call or None)
        work = {
            "ell_spmv": (lambda: ell_spmv.ell_spmv(cols, vals, x),
                         lambda: ell_spmv.ell_spmv_plain(cols, vals, x),
                         mat_bytes + 2 * rows * e, 2 * rows * w, "csr @ x"),
            "ell_spmv_pfold_dot": (
                lambda: spmv_dot.ell_spmv_pfold_dot(cols, vals, z, p, beta),
                lambda: spmv_dot.ell_spmv_pfold_dot_plain(cols, vals, z, p, beta),
                mat_bytes + 4 * rows * e + 2 * e, 2 * rows * w + 4 * rows,
                "csr @ x"),
            "cg_update": (
                lambda: vecops.cg_update(alpha, x, r, p, ap, dinv),
                lambda: vecops.cg_update_plain(alpha, x, r, p, ap, dinv),
                8 * rows * e + 3 * e, 9 * rows, None),
            "ell_spmm": (
                lambda: ell_spmv.ell_spmm(cols, vals, X),
                lambda: ell_spmv.ell_spmm_plain(cols, vals, X),
                mat_bytes + 2 * k * rows * e, 2 * rows * w * k, "csr @ X"),
            "ell_spmm_pfold_dot": (
                lambda: spmv_dot.ell_spmm_pfold_dot(cols, vals, Z, P, betas),
                lambda: spmv_dot.ell_spmm_pfold_dot_plain(cols, vals, Z, P, betas),
                mat_bytes + 4 * k * rows * e + 2 * k * e,
                2 * rows * w * k + 4 * k * rows, "csr @ X"),
            "cg_update_batched": (
                lambda: vecops.cg_update_batched(alphas, X, R, P, AP, dinv),
                lambda: vecops.cg_update_plain(alphas, X, R, P, AP, dinv),
                (7 * k + 1) * rows * e + 3 * k * e, 9 * k * rows, None),
        }
        times = {name: (device_ms(kern), eager_ms(kern), device_ms(plain))
                 for name, (kern, plain, *_) in work.items()}
        # the library yardsticks (never called by the port): one CSR matvec
        # and one CSR @ (n, k) dense product, timed last because a capture
        # they refuse may leave the stream unusable for further captures
        lib = {}
        for tag, fn in (("csr @ x", lambda: a_lib @ x[: a.shape[0]]),
                        ("csr @ X", lambda: a_lib @ X_nk)):
            try:
                lib[tag] = device_ms(fn)
            except RuntimeError as exc:
                say(f"library {tag} not capturable ({exc}); timed eagerly")
                torch.cuda.synchronize()
                lib[tag] = eager_ms(fn)
        for name, (_, _, nbytes, flops, lib_tag) in work.items():
            ms, ms_eager, plain_ms = times[name]
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS["float64"] * 1e3
            src, replaces = SOURCES[name]
            counts = launches_b if name in SOURCES_BATCHED else launches
            rows_out.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": counts.get(name, 0),
                "max_abs_err": main_errs.get(name),
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib.get(lib_tag),
            })
            say(f"time {name}{f' k={k}' if name in SOURCES_BATCHED else ''}: "
                f"{ms:.4f} ms on the card, {ms_eager:.4f} ms launched from "
                f"Python (plain {plain_ms:.4f} ms, bound "
                f"{max(t_bytes, t_ops):.4f} ms, library "
                f"{lib_tag and lib[lib_tag]})")
        for label, names, wall_us, lanes in (
                ("1-D", ("ell_spmv_pfold_dot", "cg_update"), us_per_iter, 1),
                (f"k={k}", ("ell_spmm_pfold_dot", "cg_update_batched"),
                 us_per_iter_b, k)):
            dev_us = 1e3 * sum(times[nm][0] for nm in names)
            say(f"per iteration {label}: {dev_us:.1f} us in the two kernels on "
                f"the card against {wall_us:.1f} us of wall time in the main "
                f"solve ({wall_us / lanes:.1f} us per RHS): "
                f"{100 * (1 - dev_us / wall_us):.0f}% of the wall time is "
                "outside them (host loop, scalar ops, the per-iteration sync)")

        # fixed-iteration pcg at each batch width: us per iteration, and per
        # RHS, against the per-iteration kernels' byte bound per RHS.  A
        # plan call also copies B in and X out; timing SWEEP_ITERS and 0
        # iterations and taking the difference leaves the iterations alone.
        B_sweep = np.random.default_rng(1).standard_normal(
            (max(SWEEP_BATCHES), eng.n))

        def wall(plan, bk) -> float:
            plan(bk)                             # warm the allocator
            torch.cuda.synchronize()
            t0 = now()
            plan(bk)
            torch.cuda.synchronize()
            return now() - t0

        for kk in SWEEP_BATCHES:
            bk = B_sweep[:kk]
            plan = eng.plan(SolveSpec(method="pcg", iters=SWEEP_ITERS, batch=kk))
            run_s = wall(plan, bk)
            setup_s = wall(eng.plan(SolveSpec(method="pcg", iters=0, batch=kk)), bk)
            us = (run_s - setup_s) / SWEEP_ITERS * 1e6
            # one matrix stream; 4k vectors in the p-fold, 7k + 1 in the update
            bound_us = (mat_bytes + (11 * kk + 1) * rows * e) \
                / HBM_BYTES_PER_S * 1e6
            statuses = sorted(set(plan.last_status_names))
            say(f"sweep pcg k={kk}: {us:.1f} us per iteration, {us / kk:.1f} "
                f"us per RHS per iteration (bound {bound_us / kk:.1f} us per "
                f"RHS; {1e3 * run_s:.1f} ms for {SWEEP_ITERS} iterations, "
                f"{1e3 * setup_s:.1f} ms for 0), status {statuses}")
            if statuses != ["maxiter"]:
                raise AssertionError(f"sweep k={kk}: status {statuses}")
    except Exception:
        traceback.print_exc()
        failed.append("times")

    if failed:
        say("FAILED phases: " + ", ".join(failed))
        return 1
    say(json.dumps({"kernels": rows_out}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
