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
               ``sptrsv_solve_dot`` in both types on random lower-triangular
               matrices (n = 1000 and 4099, two densities), a 2047-row
               chain, a diagonal, and lap2d_1024's two IC(0) factors, with
               and without the dot weight: x and pp within the same
               tolerance, padded rows of x exactly 0, a second run bitwise
               equal.  ``bcsr_spmm`` in both types at the JAX kernel tests'
               (bm, bn, R) sweep on random matrices and at lap2d_1024's
               8 x 8 blocks with R = 1 and 8: within the tolerance; a
               second launch, the row-major and the lanes-major layout, and
               lane j against the R = 1 call bitwise equal; an x one block
               column short must raise.
3. parity   -- lap2d_32 and banded_1k, float64 Jacobi pcg_tol at tol 1e-8,
               against the JAX package's iteration counts (94 and 9); the
               card may sum in another order, so +-1 iteration passes.
               Then the same batched at k = 4 against the JAX package's
               per-lane counts (PARITY_BATCHED), +-1 a lane, every lane
               converged.  Then both again with ``precond="block_ic0"``
               (PARITY_IC0: 32 and 1; PARITY_IC0_BATCHED at k = 4).
               Then the format portfolio (PARITY_FORMATS): lap2d_32,
               skew_1k, rmat_1k and skew_spd(96, hubs=3, hub_nnz=30) under
               format="auto" (the JAX package's choice) and each of ell,
               sell, hyb, bcsr, on the fused and the reference substrate:
               within one iteration of the JAX package's count, converged,
               bcsr_spmm launched once per matvec on BCSR and no ELL kernel
               off ELL; block_ic0 streaming A from HYB (PARITY_IC0_HYB).
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
               Then the block-IC(0) main path: the same b through
               ``AzulEngine(m, precond="block_ic0", dtype=float64)`` (the
               engine build, host IC(0) and both level schedules, printed
               on its own line) -> ``plan(SolveSpec(method="pcg_tol",
               tol=1e-8, max_iters=10000))`` -> ``plan(b)``, counts zeroed
               just before and read just after: sptrsv_solve_dot
               2 x (loop steps + 1), the p-fold and the update once a
               step, ell_spmv at least once; converged within 1% of the
               JAX package's 457 iterations; true relative residual
               <= 1e-7.  Then lap2d_256 on the fused and on the reference
               substrate (plain torch, a Python loop over the levels):
               the same status, iterations within 1% of each other and of
               the JAX package's 164.
               Then the BCSR main path: the same b through
               ``AzulEngine(m, format="bcsr")`` (8 x 8 blocks), one RHS and
               k = 8: bcsr_spmm launched loop steps + 1 times (every
               matvec, the initial residual included), no ELL kernel, the
               true relative residual <= 1e-7 on every lane; its count
               printed beside the ELL main path's.  Then the skewed main
               path: skew_spd(2^20, hubs=8, hub_nnz=256, seed=3) under
               format="auto" (which must pick HYB), SolveSpec(format="ell")
               and ``AzulEngine(m, format="sell")``, the same b, counts
               within one of each other, wall per step of each; the SELL
               and HYB matvecs repeat bit for bit and lane j of k = 8
               equals its solo call; k = 8 on HYB.  Then the matrix-free
               ``lap2d_stencil(1024)`` with the same b.
5. times    -- each kernel at the main-path shape (k = 8 for the batched
               ones): CUDA-event time of a CUDA-graph replay (median of
               five windows), the time when launched from Python, the
               plain version's time, the least time the card could take
               (bytes / 3.35 TB/s, or operations / peak rate), and one
               PyTorch CSR product as the library yardstick where there
               is one.  Then fixed-iteration pcg (100 iterations) at
               lap2d_1024 for k = 1, 4, 8, 16: us per iteration and per
               right-hand side per iteration.  Then sptrsv_solve_dot at
               the lap2d_1024 factor shape (each factor, the 2047-row
               chain, its plain version, torch's sparse CSR
               ``triangular_solve`` as the library yardstick) and the
               block-IC(0) main path's us per iteration split into the two
               solves, the p-fold, the update and the rest.  Then
               bcsr_spmm at lap2d_1024's 8 x 8 blocks, R = 1 and 8: graph
               replay, eager, plain, bound, and torch's sparse BSR @ dense
               (else CSR @ dense) as the library yardstick.  Last, the warm
               cost of a loop step on each format (unguarded fixed-iteration
               pcg, 100 steps minus 0, k = 1 and 8, two passes in reversed
               order): lap2d_1024 on ell, bcsr, sell, hyb and the stencil,
               the skewed matrix on hyb, sell and ell; and each plain
               format matvec's time on the card.

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
# block_ic0 counts of the JAX package (CPU, f64, pcg_tol, tol 1e-8), for the
# same b as PARITY (1-D) and as PARITY_BATCHED (k = 4)
PARITY_IC0 = {"lap2d_32": 32, "banded_1k": 1}
PARITY_IC0_BATCHED = {"lap2d_32": (35, 35, 35, 34), "banded_1k": (1, 1, 1, 1)}
MAIN_BATCH = 8                     # launch/serve.py --coalesce default
BATCH_LANES_AGAIN = (0, 5)         # lanes re-solved as k = 1 plans
SWEEP_BATCHES = (1, 4, 8, 16)
SWEEP_ITERS = 100
MAIN_GRID = 1024                   # laplacian_2d(1024): n = 1,048,576
MAIN_TOL = 1e-8
MAIN_MAX_ITERS = 10000
MAIN_MAX_TRUE_RESIDUAL = 1e-7      # ||b - A x|| / ||b|| in f64 on the host
# block_ic0 pcg_tol counts of the JAX package (CPU, f64, tol 1e-8, the main
# path's b): lap2d_1024 on the kernels, lap2d_256 on both substrates
MAIN_IC0_ITERS = 457
REF_IC0_GRID, REF_IC0_ITERS = 256, 164
CHAIN_ROWS = 2047                  # the levels of lap2d_1024's factors
# the format portfolio.  Per-format parity: the JAX package's pcg_tol count
# (CPU, f64, tol 1e-8, Jacobi) and its format="auto" choice, b = A x with x
# from a fresh default_rng(0) per matrix; every format reaches the count.
# skew_96 is skew_spd(96, hubs=3, hub_nnz=30, seed=1).
PARITY_FORMATS = {"lap2d_32": ("ell", 94), "skew_1k": ("hyb", 19),
                  "rmat_1k": ("hyb", 16), "skew_96": ("hyb", 19)}
PARITY_IC0_HYB = {"skew_1k": 4}    # block_ic0 streaming A from HYB
FORMATS = ("ell", "sell", "hyb", "bcsr")
ELL_KERNELS = ("ell_spmv", "ell_spmv_pfold_dot", "ell_spmm",
               "ell_spmm_pfold_dot")
# bcsr_spmm's checks: the JAX kernel tests' (bm, bn, R) sweep
BCSR_SWEEP = ((8, 16, 4), (8, 128, 8), (16, 32, 16))
# the skewed main path: the suite's skew_* family at 2^20 rows, hub_nnz cut
# from the generator's default 2n/5 to 256 so that the padded ELL the
# engine always builds (1,048,576 x 264) fits
SKEW_N, SKEW_HUBS, SKEW_HUB_NNZ, SKEW_SEED = 1 << 20, 8, 256, 3

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
    "sptrsv_solve_dot": ("src/repro_torch/kernels/csrc/sptrsv.cu",
                         "src/repro/kernels/sptrsv.py:132"),
    "bcsr_spmm": ("src/repro_torch/kernels/csrc/bcsr_spmm.cu",
                  "src/repro/kernels/bcsr_spmm.py:45"),
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


def triangular_cases():
    """Host CSR lower-triangular matrices for the sptrsv_solve_dot checks:
    random ones with a dominant diagonal (n = 1000 and 4099, two
    densities), a CHAIN_ROWS-row bidiagonal chain (one row a level), a
    diagonal (one level)."""
    import numpy as np
    import scipy.sparse as sp
    from repro_torch.core.formats import csr_from_scipy

    out = {}
    for n in (1000, 4099):
        for dens in (0.003, 0.01):
            a = sp.random(n, n, density=dens, random_state=n, format="csr")
            low = sp.tril(a, -1).tocsr()
            diag = np.asarray(abs(low).sum(axis=1)).ravel() + 1.0
            out[f"random {n} density {dens}"] = csr_from_scipy(
                (low + sp.diags(diag)).tocsr())
    out[f"chain {CHAIN_ROWS}"] = csr_from_scipy(sp.diags(
        [np.full(CHAIN_ROWS - 1, -0.5), np.ones(CHAIN_ROWS)], [-1, 0]).tocsr())
    out["diagonal 1000"] = csr_from_scipy(sp.diags(
        np.linspace(1.0, 3.0, 1000)).tocsr())
    return out


def factor_inputs(ell, rows, n: int, dtype: str, gen):
    """(ELL in ``dtype``, schedule rows, dinv, b, wdot, pack) for one
    lower-triangular factor on the card: random b and wdot, zero in the
    padded rows."""
    import torch
    from repro_torch.core.formats import ELL
    from repro_torch.core.precond import _inv_diag
    from repro_torch.kernels import ops

    td = getattr(torch, dtype)
    ell = ELL(ell.cols, ell.vals.to(td), ell.n_rows, ell.n_cols)
    dev = ell.vals.device
    rp = ell.cols.shape[0]
    b = torch.zeros(rp, dtype=td, device=dev)
    w = torch.zeros(rp, dtype=td, device=dev)
    b[:n] = torch.randn(n, generator=gen, device=dev, dtype=td)
    w[:n] = torch.randn(n, generator=gen, device=dev, dtype=td)
    return (ell, rows, _inv_diag(ell, td), b, w,
            ops.sptrsv_solve_pack(ell.cols, rows, n))


def check_sptrsv(ell, rows, n: int, dtype: str, gen, label: str) -> float:
    """sptrsv_solve_dot against its plain version on one factor, with and
    without the dot weight: x and pp within the tolerance, padded rows of
    x exactly 0, a second launch bitwise equal.  Returns the max abs
    error."""
    import torch
    from repro_torch.kernels import sptrsv

    ell, rows, dinv, b, w, pack = factor_inputs(ell, rows, n, dtype, gen)
    cols, vals = ell.cols, ell.vals
    err = 0.0
    for wd in (w, None):
        tag = f"sptrsv_solve_dot {label} {'with' if wd is not None else 'no'} dot"
        x, pp = sptrsv.sptrsv_solve_dot(cols, vals, dinv, b, pack, wd)
        x2, pp2 = sptrsv.sptrsv_solve_dot(cols, vals, dinv, b, pack, wd)
        if not (torch.equal(x, x2) and torch.equal(pp, pp2)):
            raise AssertionError(f"{tag}: two launches differ")
        if bool((x[n:] != 0).any()):
            raise AssertionError(f"{tag}: a padded row of x is not 0")
        want = sptrsv.sptrsv_solve_dot_plain(
            cols, vals, dinv, b, rows, torch.zeros_like(w) if wd is None else w, n)
        err = max(err, compare(tag, (x, pp.reshape(1)),
                               (want[0], want[1].reshape(1)), dtype))
    return err


def random_bcsr(n: int, density: float, bm: int, bn: int, seed: int):
    """A random square matrix with a unit diagonal as BCSR of (bm, bn)
    blocks on the card (float64), and its block-column count."""
    import numpy as np
    import scipy.sparse as sp
    from repro_torch.core.formats import bcsr_from_csr, csr_from_scipy

    a = sp.random(n, n, density=density, random_state=seed, format="csr")
    a.setdiag(1.0)
    m = bcsr_from_csr(csr_from_scipy(a.tocsr()), bm=bm, bn=bn,
                      dtype=np.float64, device="cuda")
    return m.block_cols, m.blocks, -(-n // bn)


def check_bcsr(bc, blocks, nbc: int, r: int, dtype: str, gen,
               label: str) -> float:
    """bcsr_spmm against its plain version on one operator at R lanes:
    within the tolerance; a second launch and the lanes-major layout (the
    solver's (R, n) seen through .T) bitwise equal; lane j bitwise the
    R = 1 call on lane j.  Returns the max abs error."""
    import torch
    from repro_torch.kernels import bcsr_spmm

    bl = blocks.to(getattr(torch, dtype))
    bn = bl.shape[3]
    x = torch.randn(r, nbc * bn, generator=gen, device="cuda",
                    dtype=bl.dtype).T                 # lanes-major view
    y = bcsr_spmm.bcsr_spmm(bc, bl, x, nbc=nbc)
    err = compare(f"bcsr_spmm {label}", (y,),
                  (bcsr_spmm.bcsr_spmm_plain(bc, bl, x),), dtype)
    if not torch.equal(y, bcsr_spmm.bcsr_spmm(bc, bl, x, nbc=nbc)):
        raise AssertionError(f"bcsr_spmm {label}: two launches differ")
    if not torch.equal(y, bcsr_spmm.bcsr_spmm(bc, bl, x.contiguous(), nbc=nbc)):
        raise AssertionError(f"bcsr_spmm {label}: the row-major layout differs")
    for j in range(r if r > 1 else 0):
        one = bcsr_spmm.bcsr_spmm(bc, bl, x[:, j: j + 1].contiguous(), nbc=nbc)
        if not torch.equal(y[:, j: j + 1], one):
            raise AssertionError(f"bcsr_spmm {label}: lane {j} of R={r} "
                                 "differs from the R = 1 call")
    return err


def check_row_sums(obj, mv, mm, k: int, gen, label: str) -> None:
    """A SELL/HYB matvec on the card uses no float atomics: two calls are
    bitwise equal and lane j of a k-wide call is bitwise its (n,) call."""
    import torch

    x = torch.randn(k, obj.rows_padded, generator=gen, device="cuda",
                    dtype=obj.vals.dtype)
    wide = mm(obj, x)
    if not torch.equal(wide, mm(obj, x)):
        raise AssertionError(f"{label}: two calls differ")
    for j in range(k):
        if not torch.equal(wide[j], mv(obj, x[j])):
            raise AssertionError(f"{label}: lane {j} of k={k} differs from "
                                 "its solo call")


def warm_wall(plan, b) -> float:
    """Seconds of one ``plan(b)`` after a warm-up call, ended by a sync."""
    import torch
    from repro_torch.obs.clock import now

    plan(b)                                  # warm the allocator
    torch.cuda.synchronize()
    t0 = now()
    plan(b)
    torch.cuda.synchronize()
    return now() - t0


def warm_step_us(eng, b, fmt: str, steps: int = SWEEP_ITERS) -> float:
    """Warm microseconds a loop step of unguarded fixed-iteration pcg on
    ``eng`` with ``SolveSpec(format=fmt)``: the wall of ``steps`` steps
    minus the wall of 0 steps (which leaves the copies in and out and the
    initial residual out)."""
    from repro_torch.core.plan import SolveSpec

    k = None if b.ndim == 1 else b.shape[0]
    run = warm_wall(eng.plan(SolveSpec(method="pcg", iters=steps, batch=k,
                                       format=fmt, guard=False)), b)
    zero = warm_wall(eng.plan(SolveSpec(method="pcg", iters=0, batch=k,
                                        format=fmt, guard=False)), b)
    return (run - zero) / steps * 1e6


def solve_main(eng, a, b, x_true, label: str, **knobs) -> dict:
    """One ``plan(b)`` of a main-path pcg_tol solve on ``eng``; launch
    counts are zeroed just before it and read just after.  Raises past
    MAIN_MAX_TRUE_RESIDUAL (``a`` is the scipy matrix)."""
    import numpy as np
    import torch
    from repro_torch.core.plan import SolveSpec
    from repro_torch.kernels import ops
    from repro_torch.obs.clock import now

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
        "substrate": plan.info["substrate"], "format": plan.info["format"],
        "guard": plan.spec.guard, "iters_run": iters, "status": plan.last_status_names,
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


def solve_main_batched(eng, a, B, label: str, lanes=None, **knobs):
    """One batched ``plan(B)`` of a main-path pcg_tol solve on ``eng`` (the
    rows ``lanes`` of B, or all); launch counts zeroed just before, read
    just after.  Raises past MAIN_MAX_TRUE_RESIDUAL on any lane.  Returns
    (summary, per-lane iterations, trace)."""
    import numpy as np
    import torch
    from repro_torch.core.plan import SolveSpec
    from repro_torch.kernels import ops
    from repro_torch.obs.clock import now

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
        "substrate": plan.info["substrate"], "format": plan.info["format"],
        "k": Bk.shape[0], "iters_run": iters.tolist(), "loop_steps": steps,
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    import numpy as np
    import scipy.sparse as sp

    from repro_torch.core import spops
    from repro_torch.core.engine import AzulEngine
    from repro_torch.core.plan import SolveSpec
    from repro_torch.core.solvers import STALL_WINDOW
    from repro_torch.core.stencil import lap2d_stencil
    from repro_torch.core.substrate import format_stream_ops
    from repro_torch.data.matrices import laplacian_2d, rmat_spd, skew_spd, suite
    from repro_torch.kernels.autotune import modeled_format_words
    from repro_torch.core.formats import ell_from_csr
    from repro_torch.core.levels import build_schedule
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import bcsr_spmm, ell_spmv, spmv_dot, sptrsv, vecops
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

    ic0_state: dict = {}

    def ic0_engine():
        """The lap2d_1024 block-IC(0) engine, built once: its host IC(0)
        and level schedules take tens of seconds.  Phase 4 prints the
        build time."""
        if "eng" not in ic0_state:
            t0 = now()
            ic0_state["eng"] = AzulEngine(m_main, precond="block_ic0",
                                          dtype=np.float64)
            ic0_state["build_s"] = now() - t0
        return ic0_state["eng"]

    # -- 2b. sptrsv_solve_dot against its plain version ---------------------
    try:
        tri = triangular_cases()
        f = ic0_engine()._ic0
        for dname in ("float64", "float32"):
            errs = {}
            for label, m in tri.items():
                sched = build_schedule(m)
                ell = ell_from_csr(m, row_pad=8, width_pad=8, dtype=np.float64)
                errs[f"{label} ({sched.n_levels} levels)"] = check_sptrsv(
                    ell, torch.from_numpy(sched.rows).cuda(), m.shape[0],
                    dname, gen, f"{dname} {label}")
            for label, ell, sched in (("L", f.ell_l, f.sched_l),
                                      ("reversed U", f.ell_u_rev, f.sched_u_rev)):
                key = f"lap2d_1024 {label} ({sched.n_levels} levels)"
                errs[key] = check_sptrsv(ell, sched.rows, f.n, dname, gen,
                                         f"{dname} lap2d_1024 {label}")
                if dname == "float64":
                    main_errs["sptrsv_solve_dot"] = max(
                        main_errs.get("sptrsv_solve_dot", 0.0), errs[key])
            say(f"sptrsv_solve_dot {dname}: max abs err " + json.dumps(errs))
        say("sptrsv_solve_dot ok (rtol f64 1e-12, f32 1e-5; padded rows 0; "
            "second launch bitwise equal)")
    except Exception:
        traceback.print_exc()
        failed.append("kernels sptrsv_solve_dot")

    # -- 2c. bcsr_spmm against its plain version ----------------------------
    bcsr_state: dict = {}

    def bcsr_engine():
        """The lap2d_1024 BCSR engine, built once: the engine (padded ELL,
        inverse diagonal), then its 8 x 8 blocks at the first plan."""
        if "eng" not in bcsr_state:
            t0 = now()
            eng = AzulEngine(m_main, dtype=np.float64, format="bcsr")
            t1 = now()
            eng.plan(SolveSpec(method="pcg_tol", tol=MAIN_TOL,
                               max_iters=MAIN_MAX_ITERS))
            bcsr_state.update(eng=eng, build_s=t1 - t0, blocks_s=now() - t1)
        return bcsr_state["eng"]

    try:
        obj = bcsr_engine()._format_obj("bcsr")
        nbc_main = -(-obj.n_cols // obj.bn)
        for dname in ("float64", "float32"):
            errs = {}
            for bm, bn, r in BCSR_SWEEP:
                bc, bl, nbc = random_bcsr(4099, 0.003, bm, bn, seed=bm * bn + r)
                key = f"random 4099 {bm}x{bn} R={r}"
                errs[key] = check_bcsr(bc, bl, nbc, r, dname, gen,
                                       f"{dname} {key}")
            for r in (1, MAIN_BATCH):
                key = f"lap2d_1024 8x8 R={r}"
                errs[key] = check_bcsr(obj.block_cols, obj.blocks, nbc_main, r,
                                       dname, gen, f"{dname} {key}")
                if dname == "float64" and r == 1:
                    main_errs["bcsr_spmm"] = errs[key]
            say(f"bcsr_spmm {dname}: max abs err " + json.dumps(errs))
        short = torch.zeros((nbc_main - 1) * obj.bn, 1, dtype=torch.float64,
                            device="cuda")
        try:
            bcsr_spmm.bcsr_spmm(obj.block_cols, obj.blocks, short, nbc=nbc_main)
        except ValueError as exc:
            say(f"bcsr_spmm with x one block column short raised: {exc}")
        else:
            raise AssertionError("bcsr_spmm took x with a wrong nbc")
        say("bcsr_spmm ok (rtol f64 1e-12, f32 1e-5; two launches, both "
            "layouts and lane j vs R = 1 bitwise equal)")
    except Exception:
        traceback.print_exc()
        failed.append("kernels bcsr_spmm")

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

    # -- 3b. block-IC(0) parity ---------------------------------------------
    try:
        rng = np.random.default_rng(0)
        mats = suite("small")
        for name, want in PARITY_IC0.items():
            m = mats[name]
            a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
            b = a @ rng.standard_normal(m.shape[0])
            eng = AzulEngine(m, precond="block_ic0", dtype=np.float64)
            plan = eng.plan(SolveSpec(method="pcg_tol", tol=1e-8, max_iters=400))
            plan(b)
            got = int(plan.last_iters)
            say(f"parity block_ic0 {name}: {got} iterations (JAX package: "
                f"{want}), status {plan.last_status_names}, substrate "
                f"{plan.info['substrate']}")
            if (abs(got - want) > 1 or plan.last_status_names != "converged"
                    or plan.info["substrate"] != "fused_ic0"):
                raise AssertionError(f"parity block_ic0 {name}: {got}")
        for name, want in PARITY_IC0_BATCHED.items():
            m = mats[name]
            b = np.random.default_rng(0).standard_normal((len(want), m.shape[0]))
            eng = AzulEngine(m, precond="block_ic0", dtype=np.float64)
            plan = eng.plan(SolveSpec(method="pcg_tol", tol=1e-8, max_iters=400,
                                      batch=len(want)))
            plan(b)
            got = [int(i) for i in plan.last_iters]
            say(f"parity block_ic0 batched {name} k={len(want)}: {got} "
                f"iterations (JAX package: {list(want)}), status "
                f"{plan.last_status_names}")
            if (any(abs(g - w) > 1 for g, w in zip(got, want))
                    or plan.last_status_names != ["converged"] * len(want)):
                raise AssertionError(f"parity block_ic0 batched {name}: {got}")
    except Exception:
        traceback.print_exc()
        failed.append("parity block_ic0")

    # -- 3c. the format portfolio at suite size ------------------------------
    try:
        mats = dict(suite("small"))
        mats["skew_96"] = skew_spd(96, hubs=3, hub_nnz=30, seed=1)
        for name, (auto_fmt, want) in PARITY_FORMATS.items():
            m = mats[name]
            a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
            b = a @ np.random.default_rng(0).standard_normal(m.shape[0])
            got = {}
            for fmt in ("auto",) + FORMATS:
                eng = AzulEngine(m, dtype=np.float64, format=fmt)
                res = {}
                for fused in (True, False):
                    plan = eng.plan(SolveSpec(method="pcg_tol", tol=1e-8,
                                              max_iters=400, fused=fused))
                    ops.reset_launch_counts()
                    x, _ = plan(b)
                    lc = ops.launch_counts()
                    steps = int(plan.last_iters)
                    res[fused] = (steps, plan.last_status_names, x)
                    resolved = plan.info["format"]
                    if resolved != (auto_fmt if fmt == "auto" else fmt):
                        raise AssertionError(f"{name} format={fmt}: resolved "
                                             f"{resolved}")
                    # the matvec closure is the format's on both substrates:
                    # bcsr_spmm once per matvec; ELL kernels only on ELL
                    want_bcsr = steps + 1 if resolved == "bcsr" else 0
                    if (lc["bcsr_spmm"] != want_bcsr
                            or (fused and lc["cg_update"] != steps)
                            or (not fused and lc["cg_update"])
                            or ((resolved != "ell" or not fused)
                                and any(lc[k] for k in ELL_KERNELS))):
                        raise AssertionError(f"{name} {resolved} fused={fused}: "
                                             f"launches {lc} for {steps} steps")
                (sf, stf, xf), (sr, sr_status, xr) = res[True], res[False]
                got[fmt] = sf
                say(f"parity formats {name} format={fmt} -> {resolved}: {sf} "
                    f"iterations fused, {sr} reference (JAX package: {want}), "
                    f"status {stf}/{sr_status}, x bitwise equal across "
                    f"substrates: {bool(np.array_equal(xf, xr))}")
                if (abs(sf - want) > 1 or abs(sr - want) > 1
                        or stf != "converged" or sr_status != "converged"):
                    raise AssertionError(f"parity formats {name} {fmt}: {sf}, "
                                         f"{sr} vs {want}")
        for name, want in PARITY_IC0_HYB.items():
            m = mats[name]
            a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
            b = a @ np.random.default_rng(0).standard_normal(m.shape[0])
            eng = AzulEngine(m, precond="block_ic0", dtype=np.float64,
                             format="hyb")
            plan = eng.plan(SolveSpec(method="pcg_tol", tol=1e-8, max_iters=400))
            ops.reset_launch_counts()
            plan(b)
            lc = ops.launch_counts()
            steps = int(plan.last_iters)
            say(f"parity block_ic0 x hyb {name}: {steps} iterations (JAX "
                f"package: {want}), status {plan.last_status_names}, "
                f"substrate {plan.info['substrate']}, launches {json.dumps(lc)}")
            if (abs(steps - want) > 1 or plan.last_status_names != "converged"
                    or plan.info["substrate"] != "fused_ic0"
                    or plan.info["format"] != "hyb"
                    or lc["sptrsv_solve_dot"] != 2 * (steps + 1)
                    or any(lc[k] for k in ELL_KERNELS)):
                raise AssertionError(f"block_ic0 x hyb {name}: {steps}, {lc}")
        say("parity formats ok (every format within one iteration of the JAX "
            "package's count on both substrates; the card's dots sum in "
            "another order than the CPU's)")
    except Exception:
        traceback.print_exc()
        failed.append("parity formats")

    # -- 4. the full-size main path -----------------------------------------
    launches, us_per_iter, main_runs = {}, None, {}
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
            return solve_main(eng, a, b, x_true, label, **knobs)

        fused = solve("fused")
        main_runs["ell"] = fused
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
            return solve_main_batched(eng, a, B, label, lanes, **knobs)

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

    # -- 4c. the block-IC(0) main path --------------------------------------
    launches_ic0, ic0_main = {}, None
    try:
        m = m_main
        a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
        x_true = np.random.default_rng(0).standard_normal(m.shape[0])
        b = a @ x_true
        eng_ic0 = ic0_engine()
        f = eng_ic0._ic0
        say(f"main block_ic0: engine build {ic0_state['build_s']:.2f} s "
            "(host IC(0) and both level schedules)")
        say(f"main block_ic0: n={f.n}, L factor ell "
            f"{tuple(f.ell_l.cols.shape)}, {f.sched_l.n_levels} levels of L "
            f"and {f.sched_u_rev.n_levels} of reversed U, widest "
            f"{int(f.sched_l.counts.max())}; resident={eng_ic0.device_bytes()} "
            "bytes")
        ic0_main = solve_main(eng_ic0, a, b, x_true, "block_ic0 fused")
        launches_ic0, steps = ic0_main["launches"], ic0_main["iters_run"]
        if (launches_ic0["sptrsv_solve_dot"] != 2 * (steps + 1)
                or launches_ic0["ell_spmv_pfold_dot"] != steps
                or launches_ic0["cg_update"] != steps
                or launches_ic0["ell_spmv"] < 1
                or ic0_main["substrate"] != "fused_ic0"):
            raise AssertionError(f"block_ic0 launch counts {launches_ic0} for "
                                 f"{steps} steps on {ic0_main['substrate']}")
        if (ic0_main["status"] != "converged"
                or abs(steps - MAIN_IC0_ITERS) > 0.01 * MAIN_IC0_ITERS):
            raise AssertionError(f"block_ic0 main path: {steps} iterations, "
                                 f"{ic0_main['status']} (JAX package: "
                                 f"{MAIN_IC0_ITERS}, converged)")
        # the reference substrate loops over the levels in Python: at
        # lap2d_1024 that is minutes, so it runs at lap2d_256
        m = laplacian_2d(REF_IC0_GRID)
        a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
        x_true = np.random.default_rng(0).standard_normal(m.shape[0])
        b = a @ x_true
        t0 = now()
        eng = AzulEngine(m, precond="block_ic0", dtype=np.float64)
        say(f"main block_ic0 lap2d_{REF_IC0_GRID}: engine build "
            f"{now() - t0:.2f} s")
        fz = solve_main(eng, a, b, x_true, f"block_ic0 lap2d_{REF_IC0_GRID} fused")
        rf = solve_main(eng, a, b, x_true,
                        f"block_ic0 lap2d_{REF_IC0_GRID} reference", fused=False)
        if (rf["status"] != fz["status"] or fz["status"] != "converged"
                or abs(rf["iters_run"] - fz["iters_run"]) > 0.01 * fz["iters_run"]
                or abs(fz["iters_run"] - REF_IC0_ITERS) > 0.01 * REF_IC0_ITERS
                or abs(rf["iters_run"] - REF_IC0_ITERS) > 0.01 * REF_IC0_ITERS
                or rf["substrate"] != "reference" or any(rf["launches"].values())):
            raise AssertionError(f"lap2d_{REF_IC0_GRID}: fused {fz}, "
                                 f"reference {rf} (JAX package: {REF_IC0_ITERS})")
        say(f"main block_ic0 ok: {steps} iterations (JAX package: "
            f"{MAIN_IC0_ITERS}), {ic0_main['us_per_iter']:.1f} us per iteration")
    except Exception:
        traceback.print_exc()
        failed.append("main block_ic0")

    # -- 4d. the BCSR main path at lap2d_1024 --------------------------------
    launches_bcsr, bcsr_main = {}, None
    try:
        m = m_main
        a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
        x_true = np.random.default_rng(0).standard_normal(m.shape[0])
        b = a @ x_true
        eng_b = bcsr_engine()
        obj = eng_b._format_obj("bcsr")
        say(f"main bcsr: engine build {bcsr_state['build_s']:.2f} s (padded "
            f"ELL, inverse diagonal), 8x8 blocks {bcsr_state['blocks_s']:.2f} s "
            f"at the first plan; blocks {tuple(obj.blocks.shape)}, "
            f"{obj.blocks.numel()} stored values for {m.nnz} nonzeros; "
            f"resident={eng_b.device_bytes()} bytes")
        bcsr_main = solve_main(eng_b, a, b, x_true, "bcsr fused")
        launches_bcsr, steps = bcsr_main["launches"], bcsr_main["iters_run"]
        others = {k: v for k, v in launches_bcsr.items()
                  if v and k not in ("bcsr_spmm", "cg_update")}
        if (launches_bcsr["bcsr_spmm"] != steps + 1
                or launches_bcsr["cg_update"] != steps or others
                or bcsr_main["format"] != "bcsr"):
            raise AssertionError(f"bcsr launch counts {launches_bcsr} for "
                                 f"{steps} steps")
        ell = main_runs.get("ell", {})
        say(f"main bcsr: {steps} iterations, {bcsr_main['status']} (ELL "
            f"main path: {ell.get('iters_run')}, {ell.get('status')}); "
            f"{bcsr_main['us_per_iter']:.1f} us per step (ELL "
            f"{ell.get('us_per_iter', float('nan')):.1f}), bcsr_spmm "
            f"launches {launches_bcsr['bcsr_spmm']} = steps + 1")
        x_lanes = np.random.default_rng(0).standard_normal((MAIN_BATCH,
                                                            m.shape[0]))
        B = (a @ x_lanes.T).T
        fb, _, _ = solve_main_batched(eng_b, a, B, "bcsr fused")
        lb, steps_b = fb["launches"], fb["loop_steps"]
        if (lb["bcsr_spmm"] != steps_b + 1
                or lb["cg_update_batched"] != steps_b
                or any(lb[k] for k in ELL_KERNELS + ("cg_update",))):
            raise AssertionError(f"bcsr batched launch counts {lb} for "
                                 f"{steps_b} loop steps")
        say(f"main bcsr ok: k={MAIN_BATCH} {fb['us_per_iter_per_rhs']:.1f} us "
            "per RHS per loop step")
    except Exception:
        traceback.print_exc()
        failed.append("main bcsr")

    # -- 4e. the skewed main path: format="auto" (HYB), sell, ell ------------
    skew_state: dict = {}
    try:
        t0 = now()
        m = skew_spd(SKEW_N, hubs=SKEW_HUBS, hub_nnz=SKEW_HUB_NNZ, seed=SKEW_SEED)
        gen_s = now() - t0
        a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
        rn = np.diff(m.indptr)
        x_true = np.random.default_rng(0).standard_normal(m.shape[0])
        b = a @ x_true
        say(f"skew: skew_spd({SKEW_N}, hubs={SKEW_HUBS}, hub_nnz={SKEW_HUB_NNZ}, "
            f"seed={SKEW_SEED}): nnz={m.nnz}, longest row {int(rn.max())}, "
            f"median row {float(np.median(rn))}, generated in {gen_s:.2f} s")
        t0 = now()
        eng_auto = AzulEngine(m, dtype=np.float64)
        t1 = now()
        eng_auto.plan(SolveSpec(method="pcg_tol", tol=MAIN_TOL,
                                max_iters=MAIN_MAX_ITERS))
        t2 = now()
        hyb = eng_auto._format_obj("hyb")
        say(f"skew auto: format_choice {eng_auto.format_choice}, modeled words "
            f"{json.dumps(eng_auto.format_words)}; engine build {t1 - t0:.2f} s "
            f"(padded ELL {tuple(eng_auto.ell.cols.shape)}), HYB at the first "
            f"plan {t2 - t1:.2f} s (core width {hyb.core_width}, tail "
            f"{hyb.n_tail}); resident={eng_auto.device_bytes()} bytes")
        if eng_auto.format_choice != "hyb":
            raise AssertionError(f"format rule chose {eng_auto.format_choice}")
        # the ELL the engine would build eagerly for the power-law family
        # at the same size (host only: it is not built)
        rm = rmat_spd(SKEW_N, 8.0, seed=4)
        rw = modeled_format_words(rm)
        say(f"rmat_spd({SKEW_N}, 8.0, seed=4), not built: nnz={rm.nnz}, "
            f"longest row {int(np.diff(rm.indptr).max())}; modeled words "
            f"{json.dumps(rw)}: its padded ELL would hold {rw['ell'] // 2} "
            f"slots ({rw['ell'] // 2 * 12} bytes in f64)")
        del rm
        runs = {"hyb": solve_main(eng_auto, a, b, x_true, "skew auto (hyb)")}
        runs["ell"] = solve_main(eng_auto, a, b, x_true,
                                 "skew ell (SolveSpec format)", format="ell")
        t0 = now()
        eng_sell = AzulEngine(m, dtype=np.float64, format="sell")
        eng_sell.plan(SolveSpec(method="pcg_tol", tol=MAIN_TOL,
                                max_iters=MAIN_MAX_ITERS))
        sell = eng_sell._format_obj("sell")
        say(f"skew sell: engine build and SELL {now() - t0:.2f} s "
            f"({sell.n_stored} stored entries)")
        runs["sell"] = solve_main(eng_sell, a, b, x_true, "skew sell")
        for fmt, run in runs.items():
            lc, steps = run["launches"], run["iters_run"]
            if fmt == "ell":
                bad = (lc["ell_spmv_pfold_dot"] != steps or lc["ell_spmv"] < 1)
            else:
                bad = any(lc[k] for k in ELL_KERNELS + ("bcsr_spmm",))
            if bad or lc["cg_update"] != steps or run["format"] != fmt:
                raise AssertionError(f"skew {fmt}: launches {lc} for {steps}")
        its = {fmt: run["iters_run"] for fmt, run in runs.items()}
        say("skew per step (us, wall of the solve over its steps): "
            + json.dumps({fmt: {"iters": run["iters_run"],
                                "status": run["status"],
                                "us_per_iter": run["us_per_iter"],
                                "wall_s": run["wall_s"]}
                          for fmt, run in runs.items()}))
        if max(its.values()) - min(its.values()) > 1:
            raise AssertionError(f"skew iteration counts differ: {its}")
        gen_r = torch.Generator(device="cuda").manual_seed(3)
        check_row_sums(hyb, spops.spmv_hyb_padded, spops.spmm_hyb_padded,
                       MAIN_BATCH, gen_r, "hyb matvec skew")
        check_row_sums(sell, spops.spmv_sell_flat, spops.spmm_sell_flat,
                       MAIN_BATCH, gen_r, "sell matvec skew")
        say(f"skew: SELL and HYB matvecs repeat bit for bit, lane j of "
            f"k={MAIN_BATCH} equals its solo call")
        del eng_sell, sell
        X = np.random.default_rng(0).standard_normal((MAIN_BATCH, m.shape[0]))
        fb, _, _ = solve_main_batched(eng_auto, a, (a @ X.T).T,
                                      "skew auto (hyb)")
        lb = fb["launches"]
        if (lb["cg_update_batched"] != fb["loop_steps"] or fb["format"] != "hyb"
                or any(lb[k] for k in ELL_KERNELS + ("bcsr_spmm",))):
            raise AssertionError(f"skew hyb batched launches {lb}")
        say(f"main skew ok: {its} iterations; k={MAIN_BATCH} on hyb "
            f"{fb['us_per_iter_per_rhs']:.1f} us per RHS per loop step (a "
            "solve this short carries its plan's first-call costs; phase 5d "
            "times warm steps)")
        skew_state.update(eng=eng_auto, m=m)
        del hyb
    except Exception:
        traceback.print_exc()
        failed.append("main skew")

    # -- 4f. the matrix-free stencil at lap2d_1024 ---------------------------
    try:
        m = m_main
        a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
        x_true = np.random.default_rng(0).standard_normal(m.shape[0])
        b = a @ x_true
        t0 = now()
        eng_st = AzulEngine(lap2d_stencil(MAIN_GRID), dtype=np.float64)
        say(f"main stencil: engine build {now() - t0:.3f} s, resident="
            f"{eng_st.device_bytes()} bytes; A x_true through the stencil vs "
            f"the stored matrix: max abs diff "
            f"{float(np.abs(eng_st.spmv(x_true) - b).max()):.3e}")
        st = solve_main(eng_st, a, b, x_true, "stencil")
        lc = st["launches"]
        if (st["format"] != "stencil" or lc["cg_update"] != st["iters_run"]
                or any(v for k, v in lc.items() if k != "cg_update")):
            raise AssertionError(f"stencil launches {lc}")
        ell = main_runs.get("ell", {})
        say(f"main stencil ok: {st['iters_run']} iterations, {st['status']} "
            f"(stored lap2d_1024 on ELL: {ell.get('iters_run')}, "
            f"{ell.get('status')}); {st['us_per_iter']:.1f} us per step")
    except Exception:
        traceback.print_exc()
        failed.append("main stencil")

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

        for kk in SWEEP_BATCHES:
            bk = B_sweep[:kk]
            plan = eng.plan(SolveSpec(method="pcg", iters=SWEEP_ITERS, batch=kk))
            run_s = warm_wall(plan, bk)
            setup_s = warm_wall(eng.plan(SolveSpec(method="pcg", iters=0,
                                                   batch=kk)), bk)
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

    # -- 5b. sptrsv_solve_dot times at the lap2d_1024 factor shape ----------
    try:
        f = ic0_engine()._ic0
        gen = torch.Generator(device="cuda").manual_seed(2)
        e = 8                                          # float64
        solves = {}
        for label, ell, sched, with_dot in (
                ("L", f.ell_l, f.sched_l, False),
                ("reversed U", f.ell_u_rev, f.sched_u_rev, True)):
            ell, rows, dinv, bb, w, pack = factor_inputs(ell, sched.rows, f.n,
                                                         "float64", gen)
            wd = w if with_dot else None
            rp, wf = ell.cols.shape
            nbytes = (rp * wf * (4 + e) + (3 + with_dot) * rp * e
                      + 4 * (pack.level_rows.numel() + pack.level_ptr.numel()))
            solves[label] = dict(
                run=lambda ell=ell, dinv=dinv, bb=bb, pack=pack, wd=wd:
                    sptrsv.sptrsv_solve_dot(ell.cols, ell.vals, dinv, bb, pack, wd),
                plain=lambda ell=ell, dinv=dinv, bb=bb, rows=rows, w=w, wd=wd:
                    sptrsv.sptrsv_solve_dot_plain(
                        ell.cols, ell.vals, dinv, bb, rows,
                        torch.zeros_like(w) if wd is None else w, f.n),
                ell=ell, bb=bb, levels=pack.n_levels,
                blocks=sptrsv.grid_blocks(pack, torch.float64, bb.device),
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, nbytes=nbytes)
        chain = triangular_cases()[f"chain {CHAIN_ROWS}"]
        cell = ell_from_csr(chain, row_pad=8, width_pad=8, dtype=np.float64)
        cargs = factor_inputs(cell, torch.from_numpy(
            build_schedule(chain).rows).cuda(), CHAIN_ROWS, "float64", gen)
        chain_run = lambda: sptrsv.sptrsv_solve_dot(
            cargs[0].cols, cargs[0].vals, cargs[2], cargs[3], cargs[5], cargs[4])
        # a launch runs for milliseconds, so events around eager launches
        # hold the device time; the graph replay below is tried last
        for label, sv in solves.items():
            sv["events_ms"] = eager_ms(sv["run"], reps=10, windows=5)
            sv["plain_ms"] = eager_ms(sv["plain"], reps=1, windows=3)
        chain_ms = eager_ms(chain_run, reps=10, windows=5)
        # the library yardstick (never called by the port): torch's sparse
        # CSR triangular solve of the same factor (no dot), timed eagerly
        u = solves["reversed U"]
        cols_h = u["ell"].cols[: f.n].cpu().numpy()
        vals_h = u["ell"].vals[: f.n].cpu().numpy()
        keep = vals_h != 0
        u_csr = sp.csr_matrix((vals_h[keep], cols_h[keep],
                               np.concatenate([[0], np.cumsum(keep.sum(1))])),
                              shape=(f.n, f.n))
        lib_ms = None
        try:
            a_lib = torch.sparse_csr_tensor(
                torch.as_tensor(u_csr.indptr, dtype=torch.int64),
                torch.as_tensor(u_csr.indices, dtype=torch.int64),
                torch.as_tensor(u_csr.data), size=u_csr.shape).to("cuda")
            b_col = u["bb"][: f.n].reshape(-1, 1).contiguous()
            lib = lambda: torch.triangular_solve(b_col, a_lib, upper=False)
            x_lib = lib().solution[:, 0]
            x_k, _ = u["run"]()
            say(f"library triangular_solve vs kernel: max abs diff "
                f"{float((x_lib - x_k[: f.n]).abs().max()):.3e}")
            lib_ms = eager_ms(lib, reps=3, windows=3)
        except Exception as exc:           # a yardstick only: report it
            torch.cuda.synchronize()
            say(f"library triangular_solve on sparse CSR not available: {exc!r}")
        # the block-IC(0) step's other two kernels: the p-fold and the
        # identity update (no dinv) at the operator's shape
        eng_ic0 = ic0_engine()
        acols, avals = eng_ic0.ell.cols, eng_ic0.ell.vals
        vec = lambda: torch.randn(acols.shape[0], generator=gen,
                                  device="cuda", dtype=torch.float64)
        x, z, p, r, ap = vec(), vec(), vec(), vec(), vec()
        beta = torch.tensor(0.37, dtype=torch.float64, device="cuda")
        alpha = torch.tensor(0.61, dtype=torch.float64, device="cuda")
        step_us = {
            "p-fold": 1e3 * device_ms(lambda: spmv_dot.ell_spmv_pfold_dot(
                acols, avals, z, p, beta)),
            "update": 1e3 * device_ms(lambda: vecops.cg_update(
                alpha, x, r, p, ap, None)),
        }
        # last, since a refused capture may leave the stream unusable for
        # further captures: the solves as a CUDA-graph replay
        how = "CUDA events around eager launches"
        for label, sv in solves.items():
            sv["ms"] = sv["events_ms"]
        try:
            graph_ms = {label: device_ms(sv["run"], reps=10, windows=5)
                        for label, sv in solves.items()}
            for label, sv in solves.items():
                sv["ms"] = graph_ms[label]
            how = "CUDA-graph replay"
        except Exception as exc:
            torch.cuda.synchronize()
            say(f"sptrsv_solve_dot: a cooperative launch was not captured in "
                f"a CUDA graph ({exc!r}); times are {how}")
        for label, sv in solves.items():
            say(f"time sptrsv_solve_dot lap2d_1024 {label}: {sv['ms']:.4f} ms "
                f"({how}), {sv['events_ms']:.4f} ms launched from Python, "
                f"{sv['levels']} levels on {sv['blocks']} blocks "
                f"({1e3 * sv['ms'] / sv['levels']:.3f} us a level); plain "
                f"{sv['plain_ms']:.4f} ms, bound {sv['bound_ms']:.4f} ms "
                f"({sv['nbytes']} bytes)")
        say(f"time sptrsv_solve_dot chain of {CHAIN_ROWS} one-row levels: "
            f"{chain_ms:.4f} ms ({1e3 * chain_ms / CHAIN_ROWS:.3f} us a "
            "level, events around eager launches)")
        say(f"library torch.triangular_solve (sparse CSR, reversed U, no dot): "
            f"{lib_ms} ms")
        rows_out.append({
            "name": "sptrsv_solve_dot", "route": "cuda",
            "source": SOURCES["sptrsv_solve_dot"][0],
            "replaces": SOURCES["sptrsv_solve_dot"][1],
            "launches": launches_ic0.get("sptrsv_solve_dot", 0),
            "max_abs_err": main_errs.get("sptrsv_solve_dot"),
            "ms": u["ms"], "plain_ms": u["plain_ms"], "bound_ms": u["bound_ms"],
            "bound_by": "bytes", "library_ms": lib_ms,
        })
        if ic0_main is not None:
            # the block-IC(0) step: two solves, the p-fold, the update, and
            # the rest (flips, pads, the host loop and its sync)
            parts = {"two solves": 1e3 * sum(sv["ms"] for sv in solves.values()),
                     **step_us}
            wall_us = ic0_main["us_per_iter"]
            parts["rest"] = wall_us - sum(parts.values())
            say("per iteration block_ic0 (us): " + json.dumps(parts)
                + f" of {wall_us:.1f} us wall per iteration")
    except Exception:
        traceback.print_exc()
        failed.append("times sptrsv_solve_dot")

    # -- 5c. bcsr_spmm times at lap2d_1024's 8 x 8 blocks -------------------
    try:
        obj = bcsr_engine()._format_obj("bcsr")
        bc, bl = obj.block_cols, obj.blocks
        nbr, w, bm, bn = bl.shape
        nbc = -(-obj.n_cols // bn)
        e = bl.element_size()
        gen = torch.Generator(device="cuda").manual_seed(4)
        n = m_main.shape[0]
        a = sp.csr_matrix((m_main.data, m_main.indices, m_main.indptr),
                          shape=m_main.shape)
        cases = {}
        for r in (1, MAIN_BATCH):
            X = torch.randn(r, nbc * bn, generator=gen, device="cuda",
                            dtype=bl.dtype).T          # the solver layout
            kern = lambda X=X: bcsr_spmm.bcsr_spmm(bc, bl, X, nbc=nbc)
            plain = lambda X=X: bcsr_spmm.bcsr_spmm_plain(bc, bl, X)
            nbytes = (bl.numel() * e + bc.numel() * 4 + nbc * bn * r * e
                      + nbr * bm * r * e)
            flops = 2 * bl.numel() * r
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS["float64"] * 1e3
            cases[r] = dict(X=X, kern=kern, ms=device_ms(kern),
                            eager=eager_ms(kern), plain_ms=device_ms(plain),
                            nbytes=nbytes, bound_ms=max(t_bytes, t_ops),
                            bound_by="bytes" if t_bytes >= t_ops
                            else "operations")
        # the library yardsticks (never called by the port), timed last: a
        # capture they refuse may leave the stream unusable for captures
        libs = {}
        try:
            bsr = a.tobsr(blocksize=(bm, bn))
            libs["torch sparse BSR @ dense"] = torch.sparse_bsr_tensor(
                torch.as_tensor(bsr.indptr, dtype=torch.int64),
                torch.as_tensor(bsr.indices, dtype=torch.int64),
                torch.as_tensor(bsr.data), size=a.shape).to("cuda")
        except Exception as exc:
            say(f"library: no sparse BSR tensor on the card ({exc!r})")
        libs["torch sparse CSR @ dense"] = torch.sparse_csr_tensor(
            torch.as_tensor(a.indptr, dtype=torch.int64),
            torch.as_tensor(a.indices, dtype=torch.int64),
            torch.as_tensor(a.data), size=a.shape).to("cuda")
        for r, c in cases.items():
            Xd = c["X"][:n].contiguous()
            c["lib_ms"] = c["lib"] = None
            for tag, mat in libs.items():
                try:
                    fn = lambda mat=mat, Xd=Xd: mat @ Xd
                    diff = float((fn() - c["kern"]()[:n]).abs().max())
                    torch.cuda.synchronize()
                    c["lib_ms"], c["lib"] = eager_ms(fn), tag
                    say(f"library {tag} R={r}: runs in float64, max abs diff "
                        f"to the kernel {diff:.3e}")
                    break
                except Exception as exc:
                    torch.cuda.synchronize()
                    say(f"library {tag} R={r} not available: {exc!r}")
        for r, c in cases.items():
            try:
                c["lib_ms"] = device_ms(lambda: libs[c["lib"]] @ c["X"][:n]
                                        .contiguous()) if c["lib"] else None
                c["lib_how"] = "CUDA-graph replay"
            except Exception as exc:
                torch.cuda.synchronize()
                c["lib_how"] = f"eager, not capturable ({type(exc).__name__})"
            say(f"time bcsr_spmm lap2d_1024 {bm}x{bn} R={r}: {c['ms']:.4f} ms "
                f"on the card, {c['eager']:.4f} ms launched from Python (plain "
                f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms by "
                f"{c['bound_by']} ({c['nbytes']} bytes), library {c['lib']}: "
                f"{c['lib_ms']} ms, {c.get('lib_how')})")
        c = cases[1]
        rows_out.append({
            "name": "bcsr_spmm", "route": "cuda",
            "source": SOURCES["bcsr_spmm"][0],
            "replaces": SOURCES["bcsr_spmm"][1],
            "launches": launches_bcsr.get("bcsr_spmm", 0),
            "max_abs_err": main_errs.get("bcsr_spmm"),
            "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["lib_ms"],
        })
        if bcsr_main is not None:
            wall_us = bcsr_main["us_per_iter"]
            dev_us = 1e3 * c["ms"]
            say(f"per iteration bcsr: {dev_us:.1f} us in bcsr_spmm on the card "
                f"against {wall_us:.1f} us of wall time per step (the fold's "
                "torch ops, cg_update, the host loop and its sync are the rest)")
    except Exception:
        traceback.print_exc()
        failed.append("times bcsr_spmm")

    # -- 5d. warm per-step cost of each format ------------------------------
    try:
        gen = torch.Generator(device="cuda").manual_seed(5)
        eng_ell = AzulEngine(m_main, dtype=np.float64)
        eng_st = AzulEngine(lap2d_stencil(MAIN_GRID), dtype=np.float64)
        cells = [("lap2d_1024", eng_ell, "ell"), ("lap2d_1024", bcsr_engine(), "bcsr"),
                 ("lap2d_1024", eng_ell, "sell"), ("lap2d_1024", eng_ell, "hyb"),
                 ("lap2d_1024", eng_st, "stencil")]
        if "eng" in skew_state:
            cells += [("skew_2^20", skew_state["eng"], f)
                      for f in ("hyb", "sell", "ell")]
        per_step = {}
        for k in (1, MAIN_BATCH):
            for order in (cells, cells[::-1]):       # two passes, reversed
                for mat, eng, fmt in order:
                    bk = np.random.default_rng(1).standard_normal(
                        (k, eng.n) if k > 1 else (eng.n,))
                    per_step.setdefault(f"{mat} {fmt} k={k}", []).append(
                        warm_step_us(eng, bk, fmt))
        say("per step by format (us, warm unguarded pcg, "
            f"{SWEEP_ITERS} steps minus 0, two passes): "
            + json.dumps(per_step))
        # the plain matvecs of the format layer on the card (graph replay)
        mv = {}
        for mat, eng, fmt in cells:
            if fmt in ("ell", "bcsr"):
                continue
            fobj = eng.stencil if fmt == "stencil" else eng._format_obj(fmt)
            matvec = format_stream_ops(fobj, fmt, eng.n_pad)[0]
            for k in (1, MAIN_BATCH):
                x = torch.randn(*((k,) if k > 1 else ()), eng.n_pad,
                                generator=gen, device="cuda",
                                dtype=torch.float64)
                mv[f"{mat} {fmt} k={k}"] = device_ms(lambda: matvec(x))
        say("plain matvec by format on the card (ms, CUDA-graph replay): "
            + json.dumps(mv))
        skew_state.clear()
    except Exception:
        traceback.print_exc()
        failed.append("times formats")

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
