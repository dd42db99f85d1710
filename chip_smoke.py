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
               main-path shape (1,048,576 x 8).  Tolerance, because only the
               summation order differs: max |kernel - plain| <= rtol *
               max |plain| with rtol 1e-12 (float64) and 1e-5 (float32).
3. parity   -- lap2d_32 and banded_1k, float64 Jacobi pcg_tol at tol 1e-8,
               against the JAX package's iteration counts (94 and 9); the
               card may sum in another order, so +-1 iteration passes.
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
5. times    -- each kernel at the main-path shape: CUDA-event time (median
               of five windows), the plain version's time, the least time
               the card could take (bytes / 3.35 TB/s, or operations /
               peak rate), and one PyTorch CSR matvec as the library
               yardstick where there is one.

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
}


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
                say(f"kernels {dname} {rows}x{width}: max abs err "
                    + json.dumps({k2: float(v) for k2, v in errs.items()}))
            eng = AzulEngine(m_main, dtype=np_dt)
            errs = check_kernels(eng.ell.cols, eng.ell.vals, dname, gen,
                                 f"{dname} main")
            say(f"kernels {dname} main {tuple(eng.ell.cols.shape)}: max abs "
                "err " + json.dumps({k2: float(v) for k2, v in errs.items()}))
            if dname == "float64":
                main_errs = errs
            del eng
        say("kernels ok (rtol f64 1e-12, f32 1e-5: summation order); "
            "launches so far " + json.dumps(ops.launch_counts()))
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

    # -- 5. times at the main-path shape ------------------------------------
    rows_out = []
    try:
        eng = AzulEngine(m_main, dtype=np.float64)
        cols, vals = eng.ell.cols, eng.ell.vals
        rows, w = cols.shape
        e = vals.element_size()
        gen = torch.Generator(device="cuda").manual_seed(1)
        vec = lambda: torch.randn(rows, generator=gen, device="cuda",
                                  dtype=torch.float64)
        x, z, p, r, ap = vec(), vec(), vec(), vec(), vec()
        dinv = eng._dinv_pad
        beta = torch.tensor(0.37, dtype=torch.float64, device="cuda")
        alpha = torch.tensor(0.61, dtype=torch.float64, device="cuda")
        a = sp.csr_matrix((m_main.data, m_main.indices, m_main.indptr),
                          shape=m_main.shape)
        a_lib = torch.sparse_csr_tensor(
            torch.as_tensor(a.indptr, dtype=torch.int64),
            torch.as_tensor(a.indices, dtype=torch.int64),
            torch.as_tensor(a.data, dtype=torch.float64),
            size=a.shape).to("cuda")
        mat_bytes = rows * w * (4 + e)
        work = {
            "ell_spmv": (lambda: ell_spmv.ell_spmv(cols, vals, x),
                         lambda: ell_spmv.ell_spmv_plain(cols, vals, x),
                         mat_bytes + 2 * rows * e, 2 * rows * w, True),
            "ell_spmv_pfold_dot": (
                lambda: spmv_dot.ell_spmv_pfold_dot(cols, vals, z, p, beta),
                lambda: spmv_dot.ell_spmv_pfold_dot_plain(cols, vals, z, p, beta),
                mat_bytes + 4 * rows * e + 2 * e, 2 * rows * w + 4 * rows,
                True),
            "cg_update": (
                lambda: vecops.cg_update(alpha, x, r, p, ap, dinv),
                lambda: vecops.cg_update_plain(alpha, x, r, p, ap, dinv),
                8 * rows * e + 3 * e, 9 * rows, False),
        }
        times = {name: (device_ms(kern), eager_ms(kern), device_ms(plain))
                 for name, (kern, plain, *_) in work.items()}
        # the library yardstick (never called by the port): one CSR matvec,
        # timed last because a capture it refuses may leave the stream
        # unusable for further captures
        try:
            lib_ms = device_ms(lambda: a_lib @ x)
        except RuntimeError as exc:
            say(f"library CSR matvec not capturable ({exc}); timed eagerly")
            torch.cuda.synchronize()
            lib_ms = eager_ms(lambda: a_lib @ x)
        for name, (_, _, nbytes, flops, has_lib) in work.items():
            ms, ms_eager, plain_ms = times[name]
            lib = lib_ms if has_lib else None
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS["float64"] * 1e3
            src, replaces = SOURCES[name]
            rows_out.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches.get(name, 0),
                "max_abs_err": main_errs.get(name),
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib,
            })
            say(f"time {name}: {ms:.4f} ms on the card, {ms_eager:.4f} ms "
                f"launched from Python (plain {plain_ms:.4f} ms, bound "
                f"{max(t_bytes, t_ops):.4f} ms, library {lib})")
        per_iter = 1e3 * (times["ell_spmv_pfold_dot"][0] + times["cg_update"][0])
        say(f"per iteration: {per_iter:.1f} us in the two kernels on the card "
            f"against {us_per_iter:.1f} us of wall time in the main solve: "
            f"{100 * (1 - per_iter / us_per_iter):.0f}% of the wall time is "
            "outside them (host loop, scalar ops, the per-iteration sync)")
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
