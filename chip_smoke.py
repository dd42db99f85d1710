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
               k = 1, 3 and 8 (k = 8 at the main shape); ell_spmv's y
               bitwise equal across its variants (the first slice's
               group design among them) and to lane 0 of ell_spmm; the
               p-fold kernels' outputs bitwise equal across their variants.
               Tolerance,
               because only the summation order differs: max |kernel -
               plain| <= rtol * max |plain| with rtol 1e-12 (float64) and
               1e-5 (float32); p', x', r' and z bitwise equal.  Lane
               independence: lane j of a k = 8 batched call equals the
               k = 1 call on lane j's inputs bit for bit, every output.
               ``sptrsv_solve_dot`` in both types on random lower-triangular
               matrices (n = 1000 and 4099, two densities), a 2047-row
               chain, a diagonal, and lap2d_1024's two IC(0) factors, with
               and without the dot weight, both variants (cluster where
               the shape admits it, cooperative): x and pp within
               the same tolerance, padded rows of x exactly 0, a second run
               bitwise equal.  ``bcsr_spmm`` in both types at the JAX kernel tests'
               (bm, bn, R) sweep on random matrices and at lap2d_1024's
               8 x 8 blocks with R = 1 and 8: within the tolerance; a
               second launch, the row-major and the lanes-major layout, and
               lane j against the R = 1 call bitwise equal; an x one block
               column short must raise.  The four kernels that only
               ``kernels.ops`` reaches, in both types: ``ell_spmv_dot``,
               ``ell_spmm_dot`` (k = 3, and k = 8 at the main shape; the
               JAX layout (rows_p, k) and the transposed view of the
               solver's (k, rows_p), Y in x's layout) and ``axpy_dot`` at
               the ragged sizes and the main shape: within the tolerance,
               axpy_dot's z bitwise y + a*x, the two layouts, lane j vs
               the k = 1 call and a second launch bitwise equal.
               ``sptrsv_level_step``: tests/test_kernels.py's level-by-
               level solves (n = 24 and 72) against scipy; on every
               triangular case above and lap2d_1024's L factor (2047
               levels) each level against its plain version from the same
               x, the functional and in-place solves bitwise equal, and
               the solved x against sptrsv_solve_dot's, within the
               tolerance.
3. parity   -- lap2d_32 and banded_1k, float64 Jacobi pcg_tol at tol 1e-8,
               against the JAX package's iteration counts (94 and 9); the
               card may sum in another order, so +-1 iteration passes.
               Then the same batched at k = 4 against the JAX package's
               per-lane counts (PARITY_BATCHED), +-1 a lane, every lane
               converged.  Then both again with ``precond="block_ic0"``
               (PARITY_IC0: 32 and 1; PARITY_IC0_BATCHED at k = 4).
               Then pcg_pipelined_tol with Jacobi and block_ic0, 1-D and
               k = 4, against the same tables (the JAX package's
               pipelined counts equal pcg_tol's), +-1 a lane: the matvec
               kernel launched loop steps + 2 times (two matvecs at
               start-up), block_ic0's sptrsv_solve_dot twice per psolve;
               cg and jacobi (100 iterations) on lap2d_32: trace and x on
               the fused substrate allclose to the reference one's and to
               the CPU's.
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
               ``launch/solve.py`` builds it.  Every plan of this phase
               is called twice: the first call builds it (captures its
               loop as one CUDA graph; a ``capture`` line gives that
               call's wall, the capture's, the node count of a step and
               its launches) and the second, warm call is the one timed.
               Launch counts -- each kernel adds one to its wrapper's
               count on the card as it starts, so a replayed launch
               counts -- are zeroed just before it and read just after,
               and must equal the first call's; both per-iteration kernels
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
               Then the pipelined main path: ``plan(SolveSpec(method=
               "pcg_pipelined_tol", tol=1e-8, max_iters=10000))`` at
               lap2d_1024 with the same b, counts zeroed just before and
               read just after: ell_spmv loop steps + 2 times and no other
               kernel; the same status rule as pcg_tol's (converged with
               the true residual <= 1e-7, or stagnated with the unguarded
               solve reaching the tolerance); the reference substrate the
               same status within 1% of the iterations; us per iteration
               and wall beside pcg_tol's from this run.  Then the same
               solve at k = 8 (``B = X_true A^T`` as in the batched main
               path), counts zeroed just before and read just after:
               ell_spmm max(iters) + 2 times and no other kernel; lanes 0
               and 5 solved again as k = 1 plans end with the same count,
               status and bad_iter and a bitwise-equal trace; lane 0 ends
               as the one-RHS pipelined solve did, within 1% of its
               iterations.  Then the
               ``kernels.ops`` API at the main-path shapes, counts zeroed
               just before and read just after: ell_spmv_dot, ell_spmm_dot
               (k = 8), axpy_dot once each, and the level-by-level solve
               of lap2d_1024's L factor (one sptrsv_level_step a level).
               Then the compiled plans (phase 4i): on each of the slice's
               paths -- lap2d_1024 on ELL (one RHS and k = 8), block-IC(0),
               BCSR (one RHS and k = 8), pcg_pipelined_tol (one RHS and
               k = 8) and the stencil -- a plan called PLAN_CALLS times
               must have one build (``traces == 1``, ``assert_steady``)
               and one capture, its capture time unchanged after the
               first call, replay its captured loop once a call, launch
               each kernel (as the kernels counted on the card) once per
               loop step taken (and the start-up matvecs) and nothing in
               the steps a round skips, reach the iteration counts of the
               main path (MAIN_LANES; block-IC(0) 457), and equal bit for
               bit -- x, trace, iters, status, bad_iter -- the same solver
               function called directly outside the plan, whose rounds run
               eagerly; wall and us per step of both are printed.  Last,
               the round length: the same two plans built with loop.CHUNK = 1 (a
               WHILE pass a step, the state copied back every step)
               against CHUNK = 32, each on a fresh engine and timed
               warm twice in mirrored order: capture time, nodes of a
               step, us a step, and the result bitwise equal.
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
               format matvec's time on the card.  Last, the kernels.ops
               kernels at the main shape (graph replay, eager, plain,
               bound, and one PyTorch call of the same function: CSR @ x
               then torch.dot; CSR @ dense (n, 8) then (X * Y).sum(0);
               torch.add then torch.dot), sptrsv_level_step at the widest
               level of lap2d_1024's L and the whole 2047-launch solve
               eager and as one graph beside sptrsv_solve_dot's, and one
               Jacobi pipelined step by part (graph replays).
               The A/B phases: ell_spmv at 1,048,576 x 8 (f64, f32) and at
               the skewed 2^20 ELL (W = 264), the first slice's group design
               against the kept variant, each timed twice in mirrored order
               beside torch's CSR @ x, y bitwise equal; sptrsv_solve_dot's
               variants on lap2d_1024's two factors, the 2047-row chain,
               the random cases and striped factors of 128 levels 256 to
               8192 rows wide (the cluster/cooperative threshold), in
               mirrored order, beside torch's sparse CSR triangular_solve;
               ell_spmv_pfold_dot and ell_spmm_pfold_dot (k = 1, 2, 4, 8,
               16) at 1,048,576 x 8 (f64, f32) and at the skewed 2^20 ELL
               (W = 264): the first slice's group design against the kept
               variant (and, where that is rows, rows on a grid of a row
               a thread), twice in mirrored order,
               beside torch's CSR product and the composed library
               function (add, product, dot), with the byte bound; P', Y
               and pap bitwise the first design's, every lane bitwise the
               k = 1 call and the 1-D kernel on that lane, a second launch
               bitwise equal.  Phase 5i, the batched gathers: bcsr_spmm at
               lap2d_1024's 8 x 8 blocks, R = 1, 2, 4, 8 and 16, f64 and
               f32, the first design (variant="first") against each new
               variant, torch's sparse BSR @ dense beside them; ell_spmm
               at 1,048,576 x 8 (f64, f32) and the skewed 2^20 ELL
               (W = 264), k = 1, 2, 4, 8 and 16, the first design
               (variant="group") against the kept variant, torch's CSR @
               dense (n, k) beside them; each timed twice in mirrored
               order, with the byte bound; Y bitwise the first design's, a
               second launch bitwise equal, every lane bitwise the
               one-lane call on that lane (and ell_spmv's y).

6. service -- the solve service (``repro_torch.serve.SolveService``) on
               captured plans.  6a: the SERVICE_PARITY scripts (lap2d_32,
               banded_1k, lap3d_22: some requests, a few ticks, the rest
               joining mid-solve) against the JAX service's per-request
               iterations (+-1) and statuses, no chunk degraded; one
               injected chunk failure raised to the caller, with no
               plain (reference) plan built and ``degraded_batches``
               still 0.  6b: laplacian_3d(100)
               (n = 1,000,000), f64 Jacobi pcg_tol at tol 1e-8, max_batch
               8, chunk 25, budget 20,000: drain SERVE_DRAIN requests
               ``b = A x_true`` (x_true from default_rng(0)), then
               ``run_load`` open loop (Poisson) at half the drained
               solves/s for SERVE_LOAD requests on the same right-hand
               sides: every request converged, true relative residual
               <= 1e-7 (scipy, host), every load outcome bitwise the
               drained solve of its b, every pool plan built and captured
               once, ``degraded_batches`` 0; one tick's launches (a k_pad
               = 8 chunk) equal a direct call of the same chunk plan;
               solves/s, latency from submit (p50 and max over the
               requests, too few for a p99), the chunk's wall against the plan's
               time on the card (CUDA events) and the copies, the
               iterations of one uninterrupted solve, plans and capture
               seconds, resident bytes.  6e: the ``repro_serve_*`` and
               ``repro_plan_*`` families in ``render_prometheus()`` and
               the metrics server's /metrics, /metrics.json, /trace.json;
               their counts against ``stats`` and the plans' executions;
               a chunk under ``obs.disabled()`` bitwise the instrumented
               one.  6c: a request joining a running cohort equals its
               solo solve bit for bit (x, res_norms) on laplacian_3d(100)
               (after two ticks) and on laplacian_2d(1024) under a budget
               of 200 (buckets 1 -> 2 -> 4, both ``maxiter``); a (1, n)
               chunk launches the batched kernels and no 1-D one; the
               batched kernels' lanes independent of k at k = 2 and 4.
               6d: both full-size operators under a memory limit that
               holds one, requests alternating: evictions and reloads,
               reserved memory lower after every eviction (empty_cache),
               each reloaded plan captured once, the same bits after a
               reload.  6f: ``python -m repro_torch.launch.serve --solver
               --operators lap2d_96,banded_10k --requests 12 --iters 2000
               --tol 1e-10`` as a subprocess (exit 0, verify_maxerr <=
               1e-6), and again with ``--load-gen open --rate 50
               --requests 40`` (40 converged, no retrace, the outcomes'
               largest true relative residual <= 1e-8); both with
               ``degraded_batches`` 0.

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
SOURCES.update({
    "ell_spmv_dot": ("src/repro_torch/kernels/csrc/spmv_dot.cu",
                     "src/repro/kernels/spmv_dot.py:67"),
    "ell_spmm_dot": ("src/repro_torch/kernels/csrc/spmv_dot.cu",
                     "src/repro/kernels/spmv_dot.py:134"),
    "axpy_dot": ("src/repro_torch/kernels/csrc/vecops.cu",
                 "src/repro/kernels/vecops.py:49"),
    "sptrsv_level_step": ("src/repro_torch/kernels/csrc/sptrsv.cu",
                          "src/repro/kernels/sptrsv.py:64"),
})
SOURCES_BATCHED = ("ell_spmm", "ell_spmm_pfold_dot", "cg_update_batched")
# the kernels no solver path launches: the kernels.ops API reaches them
OPS_ONLY = ("ell_spmv_dot", "ell_spmm_dot", "axpy_dot", "sptrsv_level_step")
# tests/test_kernels.py's level-step solves: n, density, random_state
LEVEL_JAX_CASES = ((24, 0.2, 3), (72, 0.2, 3))
PIPE_METHOD = "pcg_pipelined_tol"
# the per-lane iteration counts of the lap2d_1024 main path (Jacobi
# pcg_tol and pcg_pipelined_tol, ELL, BCSR and the stencil alike): lane 0
# is the one-RHS solve (the same counts as before the loop ran on the card)
MAIN_LANES = (1190, 1241, 1624, 1301, 1669, 1494, 1658, 1548)
PLAN_CALLS = 3                     # calls of each plan in phase 4i
# phase 6, the solve service.  SERVICE_PARITY: the JAX package's service
# (CPU, f64, SERVICE_OPERATOR) on fixed scripts -- submit `first` requests,
# tick `ticks` times, submit the rest mid-solve, drain -- per request its
# iterations and status; b = A x with the x rows from default_rng(0)
SERVICE_OPERATOR = dict(method="pcg_tol", tol=1e-8, iters=400,
                        precond="jacobi", dtype="float64")
SERVICE_PARITY = {
    "lap2d_32": dict(chunk=8, max_batch=4, first=2, ticks=3, rest=4,
                     iters=(308, 285, 319, 330, 313, 321),
                     status=("converged",) * 6),
    "banded_1k": dict(chunk=8, max_batch=4, first=3, ticks=1, rest=3,
                      iters=(9, 9, 9, 9, 9, 9), status=("converged",) * 6),
    "lap3d_22": dict(chunk=25, max_batch=8, first=3, ticks=2, rest=5,
                     iters=(107, 107, 84, 109, 101, 106, 107, 101),
                     status=("converged",) * 8),
}
# the full-size service: laplacian_3d(100), n = 1,000,000 (an HPCG local
# grid), Jacobi pcg_tol at tol 1e-8, launch/serve.py's chunk
SERVE_GRID = 100
SERVE_BATCH, SERVE_CHUNK, SERVE_BUDGET = 8, 25, 20000
# requests drained, then run_load's: cut from 64 each to keep phase 6 near
# 90 s on the card (64 and 64 took 30.3 s and 63.0 s; 32 and 32, 17.3 s
# and 40.2 s)
SERVE_DRAIN, SERVE_LOAD = 32, 16
JOIN_BUDGET = 200                    # lap2d_1024's bitwise join: maxiter


def service_script(svc, m, script: dict) -> list:
    """Run one SERVICE_PARITY script on ``svc`` (either package's service,
    with ``m`` registered as its only operator); the outcomes in submit
    order."""
    import numpy as np
    import scipy.sparse as sp

    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    first = script["first"]
    xs = np.random.default_rng(0).standard_normal(
        (first + script["rest"], m.shape[0]))
    ids = [svc.submit(a @ x) for x in xs[:first]]
    done = {}
    for _ in range(script["ticks"]):
        done.update(svc.tick())
    ids += [svc.submit(a @ x) for x in xs[first:]]
    done.update(svc.drain())
    return [done[r] for r in ids]


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


def rotating(fn, arg_sets):
    """A call that runs ``fn`` on the next of ``arg_sets`` each time: the
    timed calls read inputs that the previous calls left out of L2."""
    state = {"i": 0}

    def call():
        args = arg_sets[state["i"] % len(arg_sets)]
        state["i"] += 1
        return fn(*args)

    return call


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


def csr_on_card(m, dtype):
    """The host CSR matrix ``m`` as a torch sparse CSR tensor on the card:
    the library yardstick of the A/B phases (never called by the port)."""
    import torch

    return torch.sparse_csr_tensor(
        torch.as_tensor(m.indptr, dtype=torch.int64),
        torch.as_tensor(m.indices, dtype=torch.int64),
        torch.as_tensor(m.data, dtype=dtype), size=m.shape).to("cuda")


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
    y = ell_spmv.ell_spmv(cols, vals, x)
    errs["ell_spmv"] = compare(f"ell_spmv {label}", (y,),
                               (ell_spmv.ell_spmv_plain(cols, vals, x),), dtype)
    # every variant the width admits, the first slice's group design among
    # them, and lane 0 of ell_spmm: the same bits
    same = {"ell_spmm lane 0": ell_spmv.ell_spmm(cols, vals, x[None])[0]}
    variants = (ell_spmv.SPMV_VARIANTS
                if ell_spmv.spmv_variant(cols.shape[1]) == "rows"
                else ("group",))
    for variant in variants:
        same[variant] = ell_spmv.ell_spmv(cols, vals, x, variant=variant)
    for name, other in same.items():
        if not torch.equal(y, other):
            raise AssertionError(f"ell_spmv {label}: y differs from {name}")
    e = 0.0
    for beta in (0.0, 0.37):
        bt = torch.tensor(beta, dtype=td, device=vals.device)
        got = spmv_dot.ell_spmv_pfold_dot(cols, vals, z, p, bt)
        want = spmv_dot.ell_spmv_pfold_dot_plain(cols, vals, z, p, bt)
        e = max(e, compare(f"ell_spmv_pfold_dot {label} beta={beta}",
                           got, want, dtype))
        if not torch.equal(got[0], want[0]):
            raise AssertionError("ell_spmv_pfold_dot: p' differs from z + beta*p")
        # every variant the width admits, the first design among them
        for variant in variants:
            other = spmv_dot.ell_spmv_pfold_dot(cols, vals, z, p, bt,
                                                variant=variant)
            if not all(torch.equal(a, b) for a, b in zip(got, other)):
                raise AssertionError(f"ell_spmv_pfold_dot {label}: the "
                                     f"{variant} variant differs")
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
        first = spmv_dot.ell_spmm_pfold_dot(cols, vals, z, p, beta,
                                            variant="group")
        if not all(torch.equal(a, b) for a, b in zip(got, first)):
            raise AssertionError(f"ell_spmm_pfold_dot {tag}: differs from the "
                                 "first design (variant='group')")
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
    # lane independence on the last, widest inputs
    check_lanes(cols, vals, (x, z, p, r, ap, beta, alpha), dinv, label)
    return errs


def check_lanes(cols, vals, inputs, dinv, label: str) -> None:
    """Lane independence of the batched kernels: on ``inputs`` (x, z, p,
    r, ap of shape (k, rows), beta (k,), alpha (k, 1)) lane j of each
    output equals the k = 1 call on lane j's inputs bit for bit."""
    import torch
    from repro_torch.kernels import ell_spmv, spmv_dot, vecops

    x, z, p, r, ap, beta, alpha = inputs
    k = x.shape[0]

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


def mirrored_ms(runs: dict) -> dict:
    """Each of ``runs`` timed as CUDA-graph replays twice, in turns, the
    second pass in the reverse order."""
    order = list(runs)
    t = {k: [] for k in order}
    for name in order + order[::-1]:
        t[name].append(device_ms(runs[name]))
    return t


def pfold_ab_cell(cols, vals, m, gen, label: str) -> dict:
    """Phase 5h on one operator: ell_spmv_pfold_dot and ell_spmm_pfold_dot
    at k = 1, 2, 4, 8 and 16, the first slice's design (variant="group")
    against the kept variant (and the rows kernel on a grid of a row a
    thread, where rows is kept), each timed twice in mirrored order beside
    torch's CSR product and the composed library function.  Raises unless P', Y and pap equal the first design's bit for
    bit, a second launch repeats them, every lane of every batch equals
    the k = 1 call and the 1-D kernel on that lane, bit for bit."""
    import torch
    from repro_torch.kernels import ell_spmv, spmv_dot

    rows, w = cols.shape
    td, e, n = vals.dtype, vals.element_size(), m.shape[0]
    lib = csr_on_card(m, td)
    kept = ell_spmv.spmv_variant(w)
    mat_bytes = rows * w * (4 + e)
    vec = lambda *lead: torch.randn(*lead, rows, generator=gen, device="cuda",
                                    dtype=td)

    def same(got, want, what):
        for i, (g, x) in enumerate(zip(got, want)):
            if not torch.equal(g, x):
                raise AssertionError(f"5h {label} {what}: output {i} differs")

    def row_a_thread(call):
        """The kept variant on the grid of a row a thread (the first rows
        design's grid), the A/B of rows_grid."""
        def run():
            saved = spmv_dot.rows_grid
            spmv_dot.rows_grid = lambda r, wd, sms=132: -(-r // 256)
            try:
                return call()
            finally:
                spmv_dot.rows_grid = saved
        return run

    out = {"W": w, "kept": kept}
    z, p = vec(), vec()
    beta = torch.tensor(0.37, dtype=td, device="cuda")
    one = lambda v=None: spmv_dot.ell_spmv_pfold_dot(cols, vals, z, p, beta,
                                                     variant=v)
    first = one("group")
    same(one(), first, "1-D kept vs the first design")
    same(one(), first, "1-D second launch")
    runs = {"first design (group)": lambda: one("group"),
            f"kept ({kept})": one}
    if kept == "rows":
        runs["rows, a row a thread"] = row_a_thread(one)
        same(runs["rows, a row a thread"](), first, "1-D a row a thread")
    zn, pn_ = z[:n], p[:n]
    runs["torch CSR @ x"] = lambda: lib @ zn
    runs["composed: torch.add, CSR @ x, torch.dot"] = lambda: (
        lambda q: torch.dot(q, lib @ q))(torch.add(zn, pn_, alpha=0.37))
    out["1-D"] = dict(bound_ms=(mat_bytes + 4 * rows * e + 2 * e)
                      / HBM_BYTES_PER_S * 1e3, ms=mirrored_ms(runs))
    for k in (1, 2, 4, 8, 16):
        Z, P = vec(k), vec(k)
        betas = torch.linspace(0.1, 0.9, k, dtype=td, device="cuda")
        bat = lambda v=None, Z=Z, P=P, betas=betas: spmv_dot.ell_spmm_pfold_dot(
            cols, vals, Z, P, betas, variant=v)
        first = bat("group")
        got = bat()
        same(got, first, f"k={k} kept vs the first design")
        same(bat(), got, f"k={k} second launch")
        for j in range(k):
            s = slice(j, j + 1)
            lane = tuple(t[s] for t in got)
            same(spmv_dot.ell_spmm_pfold_dot(cols, vals, Z[s], P[s], betas[s]),
                 lane, f"k={k} lane {j} vs k=1")
            flat = spmv_dot.ell_spmv_pfold_dot(cols, vals, Z[j], P[j], betas[j])
            same((flat[0], flat[1], flat[2].reshape(1)), (lane[0][0], lane[1][0],
                 lane[2]), f"k={k} lane {j} vs the 1-D kernel")
        runs = {"first design (group)": lambda bat=bat: bat("group"),
                f"kept ({kept})": bat}
        if kept == "rows":
            runs["rows, a row a thread"] = row_a_thread(bat)
            same(runs["rows, a row a thread"](), got, f"k={k} a row a thread")
        Zt, Pt = Z[:, :n].T.contiguous(), P[:, :n].T.contiguous()
        runs["torch CSR @ dense (n, k)"] = lambda Zt=Zt: lib @ Zt
        runs["composed: torch.addcmul, CSR @ dense, (P' * Y).sum(0)"] = (
            lambda Zt=Zt, Pt=Pt, b=betas: (lambda q: (q * (lib @ q)).sum(0))(
                torch.addcmul(Zt, b, Pt)))
        out[f"k={k}"] = dict(bound_ms=(mat_bytes + 4 * k * rows * e + 2 * k * e)
                             / HBM_BYTES_PER_S * 1e3, ms=mirrored_ms(runs))
    return out


def lanes_bitwise(one_lane, got_lane, lanes: int, what: str) -> None:
    """For every lane j: the one-lane call ``one_lane(j)`` equals lane j of
    a multi-lane call's result, ``got_lane(j)``, bit for bit."""
    import torch

    for j in range(lanes):
        if not torch.equal(one_lane(j), got_lane(j)):
            raise AssertionError(f"5i {what}: lane {j} differs from its "
                                 "one-lane call")


def timed_library(fn) -> list:
    """A library call's time twice (CUDA-graph replays, else eager where
    the call refuses capture): the yardstick beside an A/B cell."""
    import torch

    try:
        return [device_ms(fn), device_ms(fn)]
    except Exception:
        torch.cuda.synchronize()
        return [eager_ms(fn), eager_ms(fn)]


def bcsr_ab_cell(bc, bl, nbc: int, lib, n: int, gen, label: str) -> dict:
    """Phase 5i on one BCSR operator: bcsr_spmm at R = 1, 2, 4, 8 and 16,
    the first slice's design (variant="first") against each new variant,
    each timed twice in mirrored order, torch's BSR @ dense beside them.
    Raises unless every variant's Y equals the first design's bit for
    bit, a second launch repeats it, and every lane equals the one-lane
    call on that lane."""
    import torch
    from repro_torch.kernels import bcsr_spmm

    nbr, w, bm, bn = bl.shape
    e = bl.element_size()
    out = {"kept": None}
    for r in (1, 2, 4, 8, 16):
        X = torch.randn(r, nbc * bn, generator=gen, device="cuda",
                        dtype=bl.dtype).T           # the solver layout
        call = lambda X, v=None: bcsr_spmm.bcsr_spmm(bc, bl, X, nbc=nbc,
                                                     variant=v)
        first = call(X, "first")
        out["kept"] = bcsr_spmm.pick_variant(
            bm, bn, bl.dtype, bcsr_spmm.x_vectorized(X),
            bl.data_ptr() % 16 == 0)
        runs = {"first design": lambda X=X: call(X, "first")}
        for v in bcsr_spmm.BCSR_VARIANTS:
            if v == "first":
                continue
            got = call(X, v)
            if not torch.equal(got, first):
                raise AssertionError(f"5i bcsr {label} R={r} {v}: Y differs "
                                     "from the first design's")
            if not torch.equal(call(X, v), got):
                raise AssertionError(f"5i bcsr {label} R={r} {v}: a second "
                                     "launch differs")
            lanes_bitwise(lambda j, v=v: call(X[:, j: j + 1], v),
                          lambda j: got[:, j: j + 1], r,
                          f"bcsr {label} R={r} {v}")
            runs[v + (" (kept)" if v == out["kept"] else "")] = (
                lambda X=X, v=v: call(X, v))
        nbytes = bl.numel() * e + bc.numel() * 4 + (nbc * bn + nbr * bm) * r * e
        Xd = X[:n].contiguous()
        out[f"R={r}"] = dict(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                             ms=mirrored_ms(runs),
                             library_ms=timed_library(lambda: lib @ Xd))
    return out


def ell_spmm_ab_cell(cols, vals, m, gen, label: str) -> dict:
    """Phase 5i on one ELL operator: ell_spmm at k = 1, 2, 4, 8 and 16, the
    first slice's design (variant="group") against the kept variant, each
    timed twice in mirrored order, torch's CSR @ dense (n, k) beside them.
    Raises unless Y equals the first design's bit for bit, a second launch
    repeats it, and every lane equals the k = 1 call and ell_spmv on that
    lane."""
    import torch
    from repro_torch.kernels import ell_spmv

    rows, w = cols.shape
    e, n = vals.element_size(), m.shape[0]
    lib = csr_on_card(m, vals.dtype)
    kept = ell_spmv.spmv_variant(w)
    out = {"W": w, "kept": kept}
    for k in (1, 2, 4, 8, 16):
        X = torch.randn(k, rows, generator=gen, device="cuda", dtype=vals.dtype)
        call = lambda X, v=None: ell_spmv.ell_spmm(cols, vals, X, variant=v)
        first = call(X, "group")
        got = call(X)
        for what, y in (("kept", got), ("second launch", call(X))):
            if not torch.equal(y, first):
                raise AssertionError(f"5i ell_spmm {label} k={k} {what}: Y "
                                     "differs from the first design's")
        lanes_bitwise(lambda j: call(X[j: j + 1]), lambda j: got[j: j + 1],
                      k, f"ell_spmm {label} k={k}")
        lanes_bitwise(lambda j: ell_spmv.ell_spmv(cols, vals, X[j]),
                      lambda j: got[j], k, f"ell_spmm {label} k={k} vs ell_spmv")
        runs = {"first design (group)": lambda X=X: call(X, "group")}
        if kept != "group":
            runs[f"kept ({kept})"] = lambda X=X: call(X)
        Xt = X[:, :n].T.contiguous()
        runs["torch CSR @ dense (n, k)"] = lambda Xt=Xt: lib @ Xt
        out[f"k={k}"] = dict(bound_ms=(rows * w * (4 + e) + 2 * k * rows * e)
                             / HBM_BYTES_PER_S * 1e3, ms=mirrored_ms(runs))
    return out


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
    kept = sptrsv.solve_variant(pack.n_levels, pack.max_width, cols.shape[1])
    for wd in (w, None):
        want = sptrsv.sptrsv_solve_dot_plain(
            cols, vals, dinv, b, rows, torch.zeros_like(w) if wd is None else w, n)
        for variant in sptrsv.SOLVE_VARIANTS:
            if variant == "cluster" and kept != "cluster":
                continue                # the schedule or the width is too wide
            tag = (f"sptrsv_solve_dot {label} {variant} "
                   f"{'with' if wd is not None else 'no'} dot")
            x, pp = sptrsv.sptrsv_solve_dot(cols, vals, dinv, b, pack, wd,
                                            variant=variant)
            x2, pp2 = sptrsv.sptrsv_solve_dot(cols, vals, dinv, b, pack, wd,
                                              variant=variant)
            if not (torch.equal(x, x2) and torch.equal(pp, pp2)):
                raise AssertionError(f"{tag}: two launches differ")
            if bool((x[n:] != 0).any()):
                raise AssertionError(f"{tag}: a padded row of x is not 0")
            e = compare(tag, (x, pp.reshape(1)), (want[0], want[1].reshape(1)),
                        dtype)
            if variant == kept:
                err = max(err, e)
    return err


def launch_shape(pack, width: int, device) -> str:
    """The sptrsv_solve_dot variant the wrapper picks for a pack, and its
    grid."""
    import torch
    from repro_torch.kernels import sptrsv

    kept = sptrsv.solve_variant(pack.n_levels, pack.max_width, width)
    if kept == "cluster":
        blocks, threads = sptrsv.cluster_geometry(pack.max_width, width=width)
        return f"cluster of {blocks} blocks x {threads} threads"
    return (f"cooperative, {sptrsv.grid_blocks(pack, torch.float64, device)}"
            " blocks")


def check_ops_only_kernels(cols, vals, dtype: str, gen, label: str,
                           k: int) -> dict:
    """ell_spmv_dot, ell_spmm_dot (k lanes, in the JAX layout (rows_p, k)
    and as the transposed view of the solver's (k, rows_p)) and axpy_dot
    against their plain versions on one operator: within the tolerance;
    axpy_dot's z bitwise the plain z; the two layouts, lane j against the
    k = 1 call and a second launch bitwise equal.  Returns the max abs
    error per kernel."""
    import torch
    from repro_torch.kernels import spmv_dot, vecops

    rows = cols.shape[0]
    td, dev = vals.dtype, vals.device
    vec = lambda *lead: torch.randn(*lead, rows, generator=gen, device=dev,
                                    dtype=td)
    x, y = vec(), vec()
    errs = {}
    got = spmv_dot.ell_spmv_dot(cols, vals, x)
    want = spmv_dot.ell_spmv_dot_plain(cols, vals, x)
    errs["ell_spmv_dot"] = compare(f"ell_spmv_dot {label}",
                                   (got[0], got[1].reshape(1)),
                                   (want[0], want[1].reshape(1)), dtype)
    again = spmv_dot.ell_spmv_dot(cols, vals, x)
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        raise AssertionError(f"ell_spmv_dot {label}: two launches differ")
    xs = vec(k)                                  # (k, rows): solver layout
    outs = []
    errs["ell_spmm_dot"] = 0.0
    for tag, xk in (("row-major", xs.T.contiguous()), ("transposed view", xs.T)):
        got = spmv_dot.ell_spmm_dot(cols, vals, xk)
        want = spmv_dot.ell_spmm_dot_plain(cols, vals, xk)
        errs["ell_spmm_dot"] = max(errs["ell_spmm_dot"], compare(
            f"ell_spmm_dot {label} k={k} {tag}", got, want, dtype))
        again = spmv_dot.ell_spmm_dot(cols, vals, xk)
        if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
            raise AssertionError(f"ell_spmm_dot {label} {tag}: two launches "
                                 "differ")
        if k > 1 and got[0].stride() != xk.stride():
            raise AssertionError(f"ell_spmm_dot {label} {tag}: Y strides "
                                 f"{got[0].stride()} vs x {xk.stride()}")
        outs.append(got)
    if not (torch.equal(outs[0][0], outs[1][0])
            and torch.equal(outs[0][1], outs[1][1])):
        raise AssertionError(f"ell_spmm_dot {label}: the layouts differ")
    for j in range(k):
        yj, pj = spmv_dot.ell_spmm_dot(cols, vals, xs[j: j + 1].T)
        if not (torch.equal(yj, outs[0][0][:, j: j + 1])
                and torch.equal(pj, outs[0][1][j: j + 1])):
            raise AssertionError(f"ell_spmm_dot {label}: lane {j} of k={k} "
                                 "differs from the k = 1 call")
    a = torch.tensor(0.61, dtype=td, device=dev)
    got = vecops.axpy_dot(a, x, y)
    want = vecops.axpy_dot_plain(a, x, y)
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"axpy_dot {label}: z is not bitwise y + a*x")
    errs["axpy_dot"] = compare(f"axpy_dot {label}", (got[1].reshape(1),),
                               (want[1].reshape(1),), dtype)
    if not torch.equal(got[1], vecops.axpy_dot(a, x, y)[1]):
        raise AssertionError(f"axpy_dot {label}: two launches differ")
    return errs


def factor_diag(ell):
    """A factor's diagonal (n_rows,), 1.0 where absent: what
    sptrsv_level_step divides by."""
    import torch
    from repro_torch.core.spops import extract_diag_ell

    d = extract_diag_ell(ell)
    return torch.where(d == 0, 1.0, d)


def level_solve(cols, vals, diag, b, rows, n: int, inplace: bool):
    """x (n + 1,) solved level by level with sptrsv_level_step: through
    ``ops`` (a new x each level), or in place (``out=x``)."""
    import torch
    from repro_torch.kernels import ops, sptrsv

    x = torch.zeros(n + 1, dtype=vals.dtype, device=vals.device)
    for lv in rows:
        if inplace:
            sptrsv.sptrsv_level_step(cols, vals, diag, b, x, lv, out=x)
        else:
            x = ops.sptrsv_level_step(cols, vals, diag, b, x, lv)
    return x


def check_level_step(ell, rows, n: int, dtype: str, gen, label: str):
    """sptrsv_level_step on one factor: each level against its plain
    version from the same x, within the tolerance; the functional and the
    in-place solves, and a second in-place solve, bitwise equal; the
    solved x within RTOL x max|x| of sptrsv_solve_dot's (which multiplies
    by the inverse diagonal).  Returns (max abs error of a level, of the
    solve)."""
    import torch
    from repro_torch.kernels import ops, sptrsv

    ell, rows, dinv, b, _, pack = factor_inputs(ell, rows, n, dtype, gen)
    cols, vals = ell.cols, ell.vals
    diag = factor_diag(ell)
    x = torch.zeros(n + 1, dtype=vals.dtype, device=vals.device)
    err = 0.0
    for lv in torch.as_tensor(rows, device=vals.device):
        got = ops.sptrsv_level_step(cols, vals, diag, b, x, lv)
        err = max(err, compare(f"sptrsv_level_step {label}", (got,),
                               (sptrsv.sptrsv_level_step_plain(
                                   cols, vals, diag, b, x, lv),), dtype))
        x = got
    rows = torch.as_tensor(rows, device=vals.device)
    x_in = level_solve(cols, vals, diag, b, rows, n, inplace=True)
    if not (torch.equal(x, x_in)
            and torch.equal(x_in, level_solve(cols, vals, diag, b, rows, n,
                                              inplace=True))):
        raise AssertionError(f"sptrsv_level_step {label}: the functional and "
                             "in-place solves, or two solves, differ")
    xs, _ = sptrsv.sptrsv_solve_dot(cols, vals, dinv, b, pack)
    solve_err = compare(f"sptrsv_level_step {label} solve vs sptrsv_solve_dot",
                        (x[:n],), (xs[:n],), dtype)
    return err, solve_err


def level_jax_case(n: int, density: float, seed: int, dtype: str):
    """tests/test_kernels.py's level-step solve on the card: the same
    lower-triangular matrix and b, solved level by level through ops,
    against scipy's solve_triangular.  Returns the max abs error."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from scipy.linalg import solve_triangular
    from repro_torch.core.formats import csr_from_scipy, ell_from_csr
    from repro_torch.core.levels import build_schedule

    a = sp.random(n, n, density=density, random_state=seed, format="csr")
    low = (sp.tril(a, k=-1) + sp.eye(n) * 2.0).tocsr()
    m = csr_from_scipy(low)
    ell = ell_from_csr(m, row_pad=8, width_pad=8,
                       dtype=getattr(np, dtype), device="cuda")
    b = np.random.default_rng(4).standard_normal(n)
    bp = torch.zeros(ell.rows_padded, dtype=ell.vals.dtype, device="cuda")
    bp[:n] = torch.from_numpy(b).to(bp)
    rows = torch.from_numpy(build_schedule(m).rows).cuda()
    x = level_solve(ell.cols, ell.vals, factor_diag(ell), bp, rows, n,
                    inplace=False)
    want = torch.from_numpy(solve_triangular(low.toarray(), b, lower=True))
    return compare(f"sptrsv_level_step {dtype} n={n} vs scipy",
                   (x[:n].double().cpu(),), (want,), dtype)


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


def first_call(plan, b, label: str) -> dict:
    """The plan's first call, which builds it (captures its loop round):
    its wall, the capture's, and the launches it counted.  Prints them on
    a line of their own."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.obs.clock import now

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = now()
    plan(b)
    torch.cuda.synchronize()
    out = {"first_call_s": now() - t0, "capture_s": plan.cell.capture_s,
           "captures": plan.cell.captures,
           "step_nodes": plan.cell.step_nodes, "traces": plan.traces,
           "launches": ops.launch_counts()}
    say(f"capture {label}: " + json.dumps(out))
    return out


def solve_main(eng, a, b, x_true, label: str, method: str = "pcg_tol",
               warm: bool = True, **knobs) -> dict:
    """One ``plan(b)`` of a main-path tolerance solve (``method``, pcg_tol
    by default) on ``eng``, after the plan's first call (the capture)
    unless ``warm`` is False; launch counts are zeroed just before it and
    read just after.  Raises past MAIN_MAX_TRUE_RESIDUAL (``a`` is the
    scipy matrix)."""
    import numpy as np
    import torch
    from repro_torch.core.plan import SolveSpec
    from repro_torch.kernels import ops
    from repro_torch.obs.clock import now

    plan = eng.plan(SolveSpec(method=method, tol=MAIN_TOL,
                              max_iters=MAIN_MAX_ITERS, **knobs))
    first = first_call(plan, b, label) if warm else {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    replays = plan.cell.replays
    t0 = now()
    x, norms = plan(b)
    torch.cuda.synchronize()
    wall = now() - t0
    iters = int(plan.last_iters)
    out = {
        "method": plan.spec.method,
        "substrate": plan.info["substrate"], "format": plan.info["format"],
        "guard": plan.spec.guard, "iters_run": iters, "status": plan.last_status_names,
        "bad_iter": int(plan.last_bad_iter),
        "rel_error": float(np.linalg.norm(x - x_true)
                           / np.linalg.norm(x_true)),
        "true_rel_residual": float(np.linalg.norm(b - a @ x)
                                   / np.linalg.norm(b)),
        "longest_stall": longest_stall(norms[: iters + 1]),
        "wall_s": wall, "us_per_iter": wall / max(iters, 1) * 1e6,
        "warm": warm, "replays": plan.cell.replays - replays,
        "traces": plan.traces, "capture_s": plan.cell.capture_s,
        "step_nodes": plan.cell.step_nodes,
        "launches": ops.launch_counts(),
    }
    if warm and first["launches"] != out["launches"]:
        raise AssertionError(f"main {label}: the first call launched "
                             f"{first['launches']}, the warm one "
                             f"{out['launches']}")
    say(f"main {label}: " + json.dumps(out))
    if not out["true_rel_residual"] <= MAIN_MAX_TRUE_RESIDUAL:
        raise AssertionError(f"main {label}: true relative residual "
                             f"{out['true_rel_residual']:.3e}")
    return out


def solve_main_batched(eng, a, B, label: str, lanes=None,
                       method: str = "pcg_tol", **knobs):
    """One batched ``plan(B)`` of a main-path tolerance solve (``method``,
    pcg_tol by default) on ``eng`` (the rows ``lanes`` of B, or all);
    launch counts zeroed just before, read just after.  Raises past
    MAIN_MAX_TRUE_RESIDUAL on any lane.  Returns (summary, per-lane
    iterations, trace)."""
    import numpy as np
    import torch
    from repro_torch.core.plan import SolveSpec
    from repro_torch.kernels import ops
    from repro_torch.obs.clock import now

    Bk = B if lanes is None else B[list(lanes)]
    plan = eng.plan(SolveSpec(method=method, tol=MAIN_TOL,
                              max_iters=MAIN_MAX_ITERS,
                              batch=Bk.shape[0], **knobs))
    first = first_call(plan, Bk, f"batched {label}")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    replays = plan.cell.replays
    t0 = now()
    X, norms = plan(Bk)
    torch.cuda.synchronize()
    wall = now() - t0
    iters = np.asarray(plan.last_iters)
    steps = int(iters.max())
    res = (np.linalg.norm(Bk - (a @ X.T).T, axis=1)
           / np.linalg.norm(Bk, axis=1))
    out = {
        "method": plan.spec.method,
        "substrate": plan.info["substrate"], "format": plan.info["format"],
        "k": Bk.shape[0], "iters_run": iters.tolist(), "loop_steps": steps,
        "status": plan.last_status_names,
        "bad_iter": np.asarray(plan.last_bad_iter).tolist(),
        "true_rel_residual": res.tolist(),
        "wall_s": wall, "us_per_iter": wall / max(steps, 1) * 1e6,
        "us_per_iter_per_rhs": wall / max(steps, 1) * 1e6 / Bk.shape[0],
        "replays": plan.cell.replays - replays,
        "traces": plan.traces, "capture_s": plan.cell.capture_s,
        "step_nodes": plan.cell.step_nodes,
        "launches": ops.launch_counts(),
    }
    if first["launches"] != out["launches"]:
        raise AssertionError(f"main batched {label}: the first call launched "
                             f"{first['launches']}, the warm one "
                             f"{out['launches']}")
    say(f"main batched {label}: " + json.dumps(out))
    if not np.all(res <= MAIN_MAX_TRUE_RESIDUAL):
        raise AssertionError(f"main batched {label}: true relative "
                             f"residuals {res}")
    return out, iters, norms


def service_phase(m_main, failed: list) -> None:
    """Phase 6: the solve service on the card (module docstring).  Each
    sub-phase that fails adds its name to ``failed``."""
    import gc
    import os
    import urllib.request

    import numpy as np
    import scipy.sparse as sp
    import torch

    from repro_torch import obs
    from repro_torch.core.engine import AzulEngine
    from repro_torch.core.plan import SolveSpec
    from repro_torch.data.matrices import laplacian_3d, suite
    from repro_torch.kernels import ops
    from repro_torch.obs.clock import now
    from repro_torch.serve import SolveService, run_load

    t_phase = now()
    op_kw = dict(SERVICE_OPERATOR, dtype=np.float64)

    def pool_plans(svc):
        return [(flavor, k, plan) for op in svc._operators.values()
                for flavor, pool in op.pools.items()
                for k, plan in sorted(pool.items())]

    def steady(svc, label: str) -> dict:
        """Every pool plan built and captured once; the bucket -> capture
        seconds of the continuous-batching plans."""
        caps = {}
        for flavor, k, plan in pool_plans(svc):
            plan.assert_steady()
            captures = int(plan.engine.device.type == "cuda")
            if plan.traces != 1 or plan.cell.captures != captures:
                raise AssertionError(
                    f"{label}: {flavor} plan k_pad={k} traces {plan.traces}, "
                    f"captures {plan.cell.captures}")
            caps[f"{flavor}{k}"] = plan.cell.capture_s
        if svc.stats["degraded_batches"]:
            raise AssertionError(f"{label}: degraded_batches "
                                 f"{svc.stats['degraded_batches']}")
        return caps

    def csr(m):
        return sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)

    def true_rel(a, b, x) -> float:
        return float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))

    # -- 6a. parity with the JAX service ------------------------------------
    try:
        t0 = now()
        mats = suite("small")
        mats["lap3d_22"] = suite("large")["lap3d_22"]
        for name, script in SERVICE_PARITY.items():
            svc = SolveService(max_batch=script["max_batch"],
                               chunk=script["chunk"])
            svc.register_operator(name, mats[name], **op_kw)
            outs = service_script(svc, mats[name], script)
            iters = tuple(o.iters for o in outs)
            status = tuple(o.status for o in outs)
            caps = steady(svc, f"service parity {name}")
            say(f"service parity {name}: iters {list(iters)} (JAX "
                f"{list(script['iters'])}), status {sorted(set(status))}, "
                f"rebuckets {svc.stats['rebuckets']}, chunks "
                f"{svc.stats['chunks']}, plans {sorted(caps)}, degraded "
                f"{svc.stats['degraded_batches']}")
            if status != script["status"] or any(
                    abs(a - b) > 1 for a, b in zip(iters, script["iters"])):
                raise AssertionError(f"service parity {name}: {iters} "
                                     f"{status} vs {script}")
        # one deliberate fault: a fused chunk that raises on the card
        # raises to the caller; no plain plan is built to answer it
        class Boom:
            info, traces, calls = {"fused": True}, 1, 0

            def __call__(self, batch, x0=None):
                Boom.calls += 1
                raise RuntimeError("injected fused-chunk failure")

        svc = SolveService(max_batch=4, chunk=8)
        svc.register_operator("banded_1k", mats["banded_1k"], **op_kw)
        op = svc._operators["banded_1k"]
        op.pools["cb"][1] = Boom()
        svc.submit(csr(mats["banded_1k"]) @ np.ones(mats["banded_1k"].shape[0]))
        try:
            svc.drain()
            raised = "nothing"
        except RuntimeError as e:
            raised = str(e)
        plain = {f: sorted(op.pools[f]) for f in ("ref", "cb_ref")}
        say(f"service injected fault: raised {raised!r} after {Boom.calls} "
            f"call(s), plain plans built {plain}, degraded_batches "
            f"{svc.stats['degraded_batches']}")
        if ("injected" not in raised or Boom.calls != 1 or any(plain.values())
                or svc.stats["degraded_batches"]):
            raise AssertionError("service injected fault")
        say(f"service parity ok ({now() - t0:.1f} s; +-1 iteration a request, "
            "statuses equal, no degraded chunk)")
    except Exception:
        traceback.print_exc()
        failed.append("service parity")

    # -- 6b. full size: laplacian_3d(100), n = 1,000,000 ---------------------
    m3 = laplacian_3d(SERVE_GRID)
    a3 = csr(m3)
    n3 = m3.shape[0]
    t0 = now()
    eng3 = AzulEngine(m3, dtype=np.float64)
    build3 = now() - t0
    spec3 = SolveSpec(method="pcg_tol", tol=MAIN_TOL, max_iters=SERVE_BUDGET)
    xs3 = np.random.default_rng(0).standard_normal((SERVE_DRAIN, n3))
    B3 = np.ascontiguousarray((a3 @ xs3.T).T)
    say(f"service lap3d_{SERVE_GRID}: n={n3} nnz={m3.nnz} ell="
        f"{tuple(eng3.ell.cols.shape)} resident={eng3.device_bytes()} bytes, "
        f"engine build {build3:.2f} s")
    svc = None
    drained = {}
    try:
        svc = SolveService(max_batch=SERVE_BATCH, chunk=SERVE_CHUNK,
                           queue_max=None)
        svc.register_operator("lap3d_100", engine=eng3, spec=spec3)
        label = svc._obs_label
        fam = obs.REGISTRY.get
        ex0 = fam("repro_solve_executions_total").value(method="pcg_tol")
        cold0 = fam("repro_plan_compile_seconds").labels(method="pcg_tol").count
        warm0 = fam("repro_solve_seconds").labels(method="pcg_tol").count
        retr0 = fam("repro_plan_retraces_total").value()
        submitted = {}
        for i in range(SERVE_DRAIN):
            submitted[svc.submit(B3[i])] = now()
        ops.reset_launch_counts()
        t0 = now()
        done = svc.tick()               # one chunk at k_pad = 8 (a capture)
        tick_launches = ops.launch_counts()
        finished = {rid: now() for rid in done}
        while svc.pending() or svc.active():
            out = svc.tick()
            done.update(out)
            finished.update({rid: now() for rid in out})
        drain_s = now() - t0
        drained = {i: done[rid] for i, rid in enumerate(submitted)}
        waits = np.array([finished[r] - submitted[r] for r in submitted])
        its = [o.iters for o in drained.values()]
        rel = [true_rel(a3, B3[i], o.x) for i, o in drained.items()]
        bad = [i for i, o in drained.items() if o.status != "converged"]
        lat = fam("repro_serve_request_seconds").labels(service=label)
        say(f"service drain: {SERVE_DRAIN} requests in {drain_s:.3f} s "
            f"({SERVE_DRAIN / drain_s:.2f} solves/s), iters {min(its)}-"
            f"{max(its)} (mean {np.mean(its):.1f}), true rel residual max "
            f"{max(rel):.3e}, chunks {svc.stats['chunks']}, ticks "
            f"{svc.stats['ticks']}, rebuckets {svc.stats['rebuckets']}; "
            f"latency from submit over {len(waits)} requests: p50 "
            f"{np.percentile(waits, 50) * 1e3:.1f} ms, max "
            f"{waits.max() * 1e3:.1f} ms")
        if bad or max(rel) > MAIN_MAX_TRUE_RESIDUAL:
            raise AssertionError(f"service drain: not converged {bad}, "
                                 f"max true rel residual {max(rel)}")

        # open loop at half the drained rate; every outcome kept
        seen: dict = {}
        sent_at: dict = {}
        done_at: dict = {}
        tick, submit = svc.tick, svc.submit

        def recording_submit(*a, **kw):
            rid = submit(*a, **kw)
            sent_at[rid] = now()
            return rid

        def recording_tick():
            out = tick()
            seen.update(out)
            done_at.update({rid: now() for rid in out})
            return out

        svc.tick, svc.submit = recording_tick, recording_submit
        base = svc._next_id
        rate = 0.5 * SERVE_DRAIN / drain_s
        load = run_load(svc, lambda i: B3[i % SERVE_DRAIN], mode="open",
                        requests=SERVE_LOAD, rate=rate, seed=0)
        del svc.tick, svc.submit
        # a p99 of SERVE_LOAD samples is not one: the tail is the max
        waits = np.array([done_at[r] - sent_at[r] for r in seen])
        say("service load (run_load, latency from the scheduled arrival; "
            "its p99_ms left out): " + json.dumps(
                {k: v for k, v in load.items() if k != "p99_ms"}))
        say(f"service load latency from submit over {len(waits)} requests: "
            f"p50 {np.percentile(waits, 50) * 1e3:.1f} ms, max "
            f"{waits.max() * 1e3:.1f} ms")
        for rid, o in seen.items():
            i = (rid - base) % SERVE_DRAIN
            if o.status != "converged" or not np.array_equal(
                    o.x, drained[i].x) or not np.array_equal(
                    o.res_norms, drained[i].res_norms):
                raise AssertionError(
                    f"service load: request {rid} ({o.status}) differs from "
                    f"the drained solve of the same b")
        if (load["completed"] != SERVE_LOAD or load["rejected"]
                or load["retraces"] or len(seen) != SERVE_LOAD):
            raise AssertionError(f"service load: {load}")
        caps = steady(svc, "service lap3d_100")

        # 6e (counts): the metric families against stats and the plans
        execs = sum(p.executions for _, _, p in pool_plans(svc))
        ev = fam("repro_serve_events_total")
        counts = {
            "executions": (fam("repro_solve_executions_total")
                           .value(method="pcg_tol") - ex0, execs,
                           svc.stats["chunks"]),
            "captured calls": (fam("repro_plan_compile_seconds").labels(
                method="pcg_tol").count - cold0, len(caps)),
            "warm calls": (fam("repro_solve_seconds").labels(
                method="pcg_tol").count - warm0, execs - len(caps)),
            "retraces": (fam("repro_plan_retraces_total").value() - retr0, 0),
            "chunk histogram": (fam("repro_serve_chunk_seconds").labels(
                service=label).count, svc.stats["chunks"]),
            "latency histogram": (lat.count, svc.stats["completed"],
                                  SERVE_DRAIN + SERVE_LOAD),
        }
        for key in ("requests", "admitted", "completed", "ticks", "chunks"):
            counts[f"events {key}"] = (ev.value(service=label, event=key),
                                       svc.stats[key])
        say("service metrics vs stats and plans: " + json.dumps(counts))
        if any(len(set(v)) != 1 for v in counts.values()):
            raise AssertionError(f"service metrics disagree: {counts}")

        # one chunk in the service launched what a direct call launches
        plan8 = svc.plan_for("lap3d_100", SERVE_BATCH, "cb")
        x0 = np.stack([drained[i].x for i in range(SERVE_BATCH)])
        batch = B3[:SERVE_BATCH]
        ops.reset_launch_counts()
        plan8(batch, x0=x0)
        direct = ops.launch_counts()
        say(f"service chunk launches: one tick {json.dumps(tick_launches)}; "
            f"direct call of the k_pad={SERVE_BATCH} chunk plan "
            f"{json.dumps(direct)}")
        batched = ("ell_spmm", "ell_spmm_pfold_dot", "cg_update_batched")
        if (tick_launches != direct or direct["ell_spmm"] < 1
                or direct["ell_spmm_pfold_dot"] != SERVE_CHUNK
                or direct["cg_update_batched"] != SERVE_CHUNK
                or any(v for k, v in direct.items() if k not in batched)):
            raise AssertionError("service chunk launches")

        # where a chunk's wall goes: the plan on the card, the copies
        x0z = np.zeros_like(batch)
        walls, dev, copies = [], [], []
        for _ in range(3):
            t0 = now()
            plan8(batch, x0=x0z)
            walls.append(now() - t0)
            t0 = now()
            bd, xd = eng3.to_device_vec(batch), eng3.to_device_vec(x0z)
            torch.cuda.synchronize()
            t_in = now() - t0
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            res = plan8.fn(bd, xd)
            stop.record()
            stop.synchronize()
            dev.append(start.elapsed_time(stop) * 1e-3)
            t0 = now()
            eng3.from_device_vec(res.x)
            copies.append(t_in + now() - t0)
        chunk_hist = fam("repro_serve_chunk_seconds").labels(service=label)
        wall, on_card, cp = (float(np.median(v)) for v in (walls, dev, copies))
        say(f"service chunk (k_pad={SERVE_BATCH}, {SERVE_CHUNK} steps, "
            f"n={n3}), medians of 3: plan call wall {wall * 1e3:.2f} ms; "
            f"measured apart, the plan on the card {on_card * 1e3:.2f} ms "
            f"and the copies in and out {cp * 1e3:.2f} ms ({cp / wall:.1%} "
            f"of the call); the service's mean chunk wall "
            f"{chunk_hist.sum / chunk_hist.count * 1e3:.2f} ms over "
            f"{chunk_hist.count} chunks (captures included)")

        # the restarts: one uninterrupted solve of request 0
        plain = eng3.plan(spec3)
        plain(B3[0])
        t0 = now()
        plain(B3[0])
        plain_s = now() - t0
        say(f"service restarts: request 0 takes {drained[0].iters} "
            f"iterations in chunks of {SERVE_CHUNK}, {int(plain.last_iters)} "
            f"as one solve ({plain.last_status_names}, {plain_s:.3f} s warm "
            f"on the card)")
        say(f"service plans: {len(caps)} ({', '.join(caps)}), capture s "
            f"{json.dumps({k: round(v or 0.0, 4) for k, v in caps.items()})}; "
            f"resident_bytes {svc.resident_bytes()}")

        # 6e: the endpoint and the bits of an instrumented chunk
        srv = obs.start_metrics_server(port=0)
        try:
            got = {}
            for path in ("/metrics", "/metrics.json", "/trace.json"):
                with urllib.request.urlopen(
                        f"http://{srv.host}:{srv.port}{path}",
                        timeout=30) as r:
                    got[path] = r.read().decode()
        finally:
            srv.close()
        text = obs.render_prometheus()
        families = [f"repro_{f}" for f in (
            "serve_events_total", "serve_rejects_total",
            "serve_outcomes_total", "serve_queue_depth", "serve_queue_peak",
            "serve_resident_bytes", "serve_operators_resident",
            "serve_tick_seconds", "serve_chunk_seconds",
            "serve_request_seconds", "plan_cache_hits_total",
            "plan_cache_misses_total", "plan_retraces_total",
            "plan_build_seconds", "solve_executions_total",
            "plan_compile_seconds", "solve_seconds", "plan_format_total",
            "engine_device_bytes", "ft_straggler_flags_total")]
        missing = [f for f in families
                   if f"# TYPE {f} " not in text
                   or f"# TYPE {f} " not in got["/metrics"]]
        snap = json.loads(got["/metrics.json"])
        spans = json.loads(got["/trace.json"])["traceEvents"]
        kinds = sorted({e["cat"] for e in spans})
        with obs.disabled():
            x_bare, n_bare = plan8(batch, x0=x0)
        x_inst, n_inst = plan8(batch, x0=x0)
        same = np.array_equal(x_bare, x_inst) and np.array_equal(n_bare,
                                                                 n_inst)
        say(f"service observability: {len(families)} families in "
            f"render_prometheus and /metrics (missing {missing}), "
            f"/metrics.json {len(snap)} families, /trace.json {len(spans)} "
            f"spans of kinds {kinds}; instrumented chunk == bare chunk "
            f"bitwise: {same}")
        if missing or not same or "chunk" not in kinds or "tick" not in kinds:
            raise AssertionError("service observability")
    except Exception:
        traceback.print_exc()
        failed.append("service full size")

    # -- 6c. bitwise join at full width ---------------------------------------
    eng2 = None
    a2 = csr(m_main)
    try:
        rng = np.random.default_rng(1)
        eng2 = AzulEngine(m_main, dtype=np.float64)
        rhs2 = (a2 @ rng.standard_normal((4, m_main.shape[0])).T).T
        cases = (
            ("lap3d_100", eng3, spec3, B3[:2], (1, 2)),
            ("lap2d_1024", eng2,
             SolveSpec(method="pcg_tol", tol=MAIN_TOL, max_iters=JOIN_BUDGET),
             rhs2, (1, 2, 4)))
        for name, eng, spec, rhs, buckets in cases:
            solo = SolveService(max_batch=SERVE_BATCH, chunk=SERVE_CHUNK)
            solo.register_operator(name, engine=eng, spec=spec)
            solo.submit(rhs[1])
            ops.reset_launch_counts()
            ref = solo.drain()[0]
            one = ops.launch_counts()
            svc_j = SolveService(max_batch=SERVE_BATCH, chunk=SERVE_CHUNK)
            svc_j.register_operator(name, engine=eng, spec=spec)
            ids = [svc_j.submit(rhs[0])]
            svc_j.tick()
            if len(buckets) == 2:
                svc_j.tick()                      # joins after two ticks
                ids.append(svc_j.submit(rhs[1]))
            else:
                ids.append(svc_j.submit(rhs[1]))  # k_pad 1 -> 2
                svc_j.tick()
                ids += [svc_j.submit(r) for r in rhs[2:]]   # -> 4
            done = svc_j.drain()
            got = done[ids[1]]
            used = sorted(svc_j._operators[name].pools["cb"])
            steady(solo, f"join {name} solo")
            steady(svc_j, f"join {name}")
            bits = (np.array_equal(got.x, ref.x)
                    and np.array_equal(got.res_norms, ref.res_norms))
            say(f"service join {name}: joined request {got.iters} iters "
                f"{got.status}, solo {ref.iters} {ref.status}, buckets "
                f"{used}; x and res_norms bitwise equal: {bits}; the solo "
                f"(1, n) chunks launched {json.dumps({k: v for k, v in one.items() if v})}")
            if (not bits or got.iters != ref.iters or used != list(buckets)
                    or one.get("ell_spmv_pfold_dot") or one.get("cg_update")
                    or one.get("ell_spmv") or not one.get("ell_spmm_pfold_dot")
                    or one.get("cg_update_batched") != one.get(
                        "ell_spmm_pfold_dot")):
                raise AssertionError(f"service join {name}")
            if name == "lap3d_100" and drained and not np.array_equal(
                    ref.x, drained[1].x):
                raise AssertionError("service join lap3d_100: the solo solve "
                                     "differs from the drained cohort's")
            if name == "lap2d_1024" and {o.status for o in done.values()} != {
                    "maxiter"}:
                raise AssertionError("service join lap2d_1024: statuses")
        # the batched kernels' lanes at k = 2 and 4 on lap3d_100's operator
        gen = torch.Generator(device="cuda").manual_seed(6)
        cols, vals = eng3.ell.cols, eng3.ell.vals
        rows = cols.shape[0]
        for k in (2, 4):
            lanes = [torch.randn(k, rows, generator=gen, device="cuda",
                                 dtype=torch.float64) for _ in range(5)]
            beta = torch.linspace(0.0, 0.9, k, dtype=torch.float64,
                                  device="cuda")
            alpha = torch.linspace(0.1, 0.9, k, dtype=torch.float64,
                                   device="cuda").reshape(k, 1)
            check_lanes(cols, vals, (*lanes, beta, alpha), eng3._dinv_pad,
                        f"lap3d_100 k={k}")
        say(f"service join ok: bits equal to the solo solves; batched "
            f"kernels' lanes independent of k at k = 2 and 4 ({rows} rows)")
    except Exception:
        traceback.print_exc()
        failed.append("service join")

    # -- 6d. eviction under a memory budget -----------------------------------
    try:
        sizes = {"lap3d_100": eng3.device_bytes(),
                 "lap2d_1024": (eng2 or AzulEngine(m_main, dtype=np.float64)
                                ).device_bytes()}
        limit = max(sizes.values()) + min(sizes.values()) // 2
        svc_e = SolveService(max_batch=SERVE_BATCH, chunk=SERVE_CHUNK,
                             memory_limit=limit)
        drops = []
        evict = svc_e._evict

        def measured_evict(op):
            plans = op.plan_count()
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_reserved()
            evict(op)
            gc.collect()
            torch.cuda.empty_cache()
            drops.append({"operator": op.name, "plans": plans,
                          "reserved_before": before,
                          "reserved_after": torch.cuda.memory_reserved(),
                          "operator_bytes": op.bytes})

        svc_e._evict = measured_evict
        reg = dict(op_kw, iters=SERVE_BUDGET)
        svc_e.register_operator("lap3d_100", m3, **reg)
        svc_e.register_operator("lap2d_1024", m_main, **reg)
        b2 = a2 @ np.random.default_rng(0).standard_normal(m_main.shape[0])
        outs = []
        for name, b, cap in (("lap2d_1024", b2, JOIN_BUDGET),
                             ("lap3d_100", B3[0], None),
                             ("lap2d_1024", b2, JOIN_BUDGET)):
            rid = svc_e.submit(b, name, max_iters=cap)
            out = svc_e.drain()[rid]
            steady(svc_e, f"eviction {name}")
            outs.append(out)
        del svc_e._evict
        say(f"service eviction: limit {limit} bytes for {json.dumps(sizes)}; "
            f"evictions {svc_e.stats['evictions']}, reloads "
            f"{svc_e.stats['reloads']}; " + json.dumps(drops))
        say("service eviction outcomes: " + json.dumps(
            [(o.operator, o.iters, o.status) for o in outs]))
        freed = [d for d in drops if d["plans"]]
        if (svc_e.stats["evictions"] < 1 or svc_e.stats["reloads"] < 1
                or not freed or any(d["reserved_after"] >= d["reserved_before"]
                                    for d in drops)
                or outs[0].status != "maxiter" or outs[1].status != "converged"
                or not np.array_equal(outs[0].x, outs[2].x)
                or (drained and not np.array_equal(outs[1].x, drained[0].x))):
            raise AssertionError("service eviction")
    except Exception:
        traceback.print_exc()
        failed.append("service eviction")
    del eng2
    say(f"service phases 6a-6e: {now() - t_phase:.1f} s")

    # -- 6f. the CLI -----------------------------------------------------------
    try:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--solver",
               "--operators", "lap2d_96,banded_10k", "--requests", "12",
               "--iters", "2000", "--tol", "1e-10"]
        for extra in ([], ["--load-gen", "open", "--rate", "50",
                           "--requests", "40"]):
            t0 = now()
            r = subprocess.run(cmd + extra, env=env, capture_output=True,
                               text=True, timeout=600, cwd=ROOT)
            if r.returncode != 0:
                raise AssertionError(f"launch.serve {extra}: exit "
                                     f"{r.returncode}\n{r.stderr[-3000:]}")
            out = json.loads(r.stdout)
            say(f"service CLI {' '.join(extra) or 'drain'} ({now() - t0:.1f} "
                f"s): " + json.dumps(out))
            if extra:
                ok = (out["completed"] == 40 and not out["rejected"]
                      and not out["retraces"]
                      and out["statuses"] == {"converged": 40}
                      and 0 < out["verify_rel_residual"] <= 1e-8)
            else:
                ok = out["verify_maxerr"] <= 1e-6
            ok = ok and out["degraded_batches"] == 0
            if not ok:
                raise AssertionError(f"launch.serve {extra}: {out}")
    except Exception:
        traceback.print_exc()
        failed.append("service CLI")
    say(f"service phase: {now() - t_phase:.1f} s")


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
    from repro_torch.core.formats import csr_from_scipy, ell_from_csr
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

    # -- 2d. the kernels reached through kernels.ops only ---------------------
    try:
        tri = triangular_cases()
        f = ic0_engine()._ic0
        for dname, np_dt in (("float64", np.float64), ("float32", np.float32)):
            td = getattr(torch, dname)
            for rows, width, k in ((1000, 5, 5), (4099, 8, 7)):
                cols, vals = random_ell(rows, width, k, td, gen)
                errs = check_ops_only_kernels(cols, vals, dname, gen,
                                              f"{dname} {rows}x{width}", k=3)
                say(f"ops kernels {dname} {rows}x{width}: max abs err "
                    + json.dumps(errs))
            eng = AzulEngine(m_main, dtype=np_dt)
            errs = check_ops_only_kernels(eng.ell.cols, eng.ell.vals, dname,
                                          gen, f"{dname} main", k=MAIN_BATCH)
            say(f"ops kernels {dname} main {tuple(eng.ell.cols.shape)} "
                f"k={MAIN_BATCH}: max abs err " + json.dumps(errs))
            if dname == "float64":
                main_errs.update(errs)
            del eng
            errs = {f"n={n} vs scipy": level_jax_case(n, dens, seed, dname)
                    for n, dens, seed in LEVEL_JAX_CASES}
            for label, m in tri.items():
                sched = build_schedule(m)
                ell = ell_from_csr(m, row_pad=8, width_pad=8, dtype=np.float64)
                errs[f"{label} ({sched.n_levels} levels)"] = check_level_step(
                    ell, torch.from_numpy(sched.rows).cuda(), m.shape[0],
                    dname, gen, f"{dname} {label}")
            key = f"lap2d_1024 L ({f.sched_l.n_levels} levels)"
            errs[key] = check_level_step(f.ell_l, f.sched_l.rows, f.n, dname,
                                         gen, f"{dname} lap2d_1024 L")
            if dname == "float64":
                main_errs["sptrsv_level_step"] = errs[key][0]
            say(f"sptrsv_level_step {dname}: max abs err (a level, the solve "
                "vs sptrsv_solve_dot) " + json.dumps(errs))
        say("ops kernels ok (rtol f64 1e-12, f32 1e-5; axpy_dot's z, the "
            "layouts, lane j vs k = 1, second launches and the in-place solve "
            "bitwise equal)")
    except Exception:
        traceback.print_exc()
        failed.append("kernels ops-only")

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

    # -- 3d. the rest of the registry: pipelined, cg, jacobi ---------------
    try:
        mats = suite("small")
        for precond, table, table_b in (
                ("jacobi", PARITY, PARITY_BATCHED),
                ("block_ic0", PARITY_IC0, PARITY_IC0_BATCHED)):
            rng = np.random.default_rng(0)
            for name, want in table.items():
                m = mats[name]
                a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
                b = a @ rng.standard_normal(m.shape[0])
                eng = AzulEngine(m, precond=precond, dtype=np.float64)
                plan = eng.plan(SolveSpec(method=PIPE_METHOD, tol=1e-8,
                                          max_iters=400))
                ops.reset_launch_counts()
                plan(b)
                lc = ops.launch_counts()
                got = int(plan.last_iters)
                say(f"parity {PIPE_METHOD} {precond} {name}: {got} iterations "
                    f"(JAX package: {want}), status {plan.last_status_names}, "
                    f"substrate {plan.info['substrate']}, launches "
                    + json.dumps({k2: v for k2, v in lc.items() if v}))
                ic0 = precond == "block_ic0"
                if (abs(got - want) > 1 or plan.last_status_names != "converged"
                        or lc["ell_spmv"] != got + 2
                        or lc["sptrsv_solve_dot"] != (2 * (got + 2) if ic0 else 0)
                        or lc["ell_spmv_pfold_dot"] or lc["cg_update"]):
                    raise AssertionError(f"parity {PIPE_METHOD} {precond} "
                                         f"{name}: {got}, {lc}")
            for name, want in table_b.items():
                m = mats[name]
                b = np.random.default_rng(0).standard_normal((len(want),
                                                              m.shape[0]))
                eng = AzulEngine(m, precond=precond, dtype=np.float64)
                plan = eng.plan(SolveSpec(method=PIPE_METHOD, tol=1e-8,
                                          max_iters=400, batch=len(want)))
                ops.reset_launch_counts()
                plan(b)
                lc = ops.launch_counts()
                got = [int(i) for i in plan.last_iters]
                say(f"parity {PIPE_METHOD} {precond} batched {name} "
                    f"k={len(want)}: {got} iterations (JAX package: "
                    f"{list(want)}), status {plan.last_status_names}")
                if (any(abs(g - w) > 1 for g, w in zip(got, want))
                        or plan.last_status_names != ["converged"] * len(want)
                        or lc["ell_spmm"] != max(got) + 2):
                    raise AssertionError(f"parity {PIPE_METHOD} {precond} "
                                         f"batched {name}: {got}, {lc}")
        # cg and jacobi, 100 iterations on lap2d_32: the fused substrate
        # (jacobi: the reference one, its only) against the reference one
        # on the card and against the CPU
        m = mats["lap2d_32"]
        a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
        b = a @ np.random.default_rng(0).standard_normal(m.shape[0])
        eng = AzulEngine(m, dtype=np.float64)
        cpu = AzulEngine(m, dtype=np.float64, device="cpu")
        for method, status in (("cg", "maxiter"), ("jacobi", "unguarded")):
            spec = dict(method=method, iters=SWEEP_ITERS)
            xc, nc = cpu.plan(SolveSpec(**spec))(b)
            runs = {}
            for fused in (True, False):
                plan = eng.plan(SolveSpec(**spec, fused=fused))
                ops.reset_launch_counts()
                x, norms = plan(b)
                runs[fused] = (x, norms, plan.last_status_names,
                               plan.info["substrate"], ops.launch_counts())
            (xf, nf, sf, kf, lf), (xr, nr, sr, kr, lr) = runs[True], runs[False]
            diff = float(np.abs(xf - xr).max())
            say(f"{method} lap2d_32 iters={SWEEP_ITERS}: substrates {kf}/{kr}, "
                f"status {sf}/{sr}, final residual {nf[-1]:.6e} / {nr[-1]:.6e} "
                f"(CPU {nc[-1]:.6e}), max |x_fused - x_ref| {diff:.3e}, "
                f"max |x_card - x_cpu| {float(np.abs(xf - xc).max()):.3e}")
            want_kind = "fused" if method == "cg" else "reference"
            want_lf = ({"ell_spmv": 1, "ell_spmv_pfold_dot": SWEEP_ITERS,
                        "cg_update": SWEEP_ITERS} if method == "cg" else {})
            if (sf != status or sr != status or kf != want_kind
                    or {k2: v for k2, v in lf.items() if v} != want_lf
                    or any(lr.values())):
                raise AssertionError(f"{method}: {kf}, {sf}/{sr}, {lf}, {lr}")
            for x_, n_ in ((xr, nr), (xc, nc)):
                np.testing.assert_allclose(xf, x_, rtol=1e-8, atol=1e-10)
                np.testing.assert_allclose(nf, n_, rtol=0,
                                           atol=1e-8 * np.linalg.norm(b))
        say("parity pipelined, cg, jacobi ok")
    except Exception:
        traceback.print_exc()
        failed.append("parity pipelined, cg, jacobi")

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
                        f"block_ic0 lap2d_{REF_IC0_GRID} reference",
                        warm=False, fused=False)
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

    # -- 4g. the pipelined main path ------------------------------------------
    pipe_main = None
    try:
        m = m_main
        a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
        x_true = np.random.default_rng(0).standard_normal(m.shape[0])
        b = a @ x_true
        eng = AzulEngine(m, dtype=np.float64)

        def solve_pipe(label: str, **knobs) -> dict:
            return solve_main(eng, a, b, x_true, f"{PIPE_METHOD} {label}",
                              method=PIPE_METHOD, **knobs)

        pipe_main = solve_pipe("fused")
        lc, steps = pipe_main["launches"], pipe_main["iters_run"]
        if (lc["ell_spmv"] != steps + 2
                or any(v for k2, v in lc.items() if k2 != "ell_spmv")):
            raise AssertionError(f"{PIPE_METHOD} launches {lc} for {steps} "
                                 "steps")
        ref = solve_pipe("reference", fused=False)
        if (ref["status"] != pipe_main["status"]
                or abs(ref["iters_run"] - steps) > 0.01 * steps
                or any(ref["launches"].values())):
            raise AssertionError(f"{PIPE_METHOD} reference: {ref['iters_run']}"
                                 f", {ref['status']} vs {steps}, "
                                 f"{pipe_main['status']}")
        if pipe_main["status"] != "converged":
            # the rule of pcg_tol's main path: a stall-guard stop must be a
            # plateau the unguarded solve gets past to the tolerance
            lean = solve_pipe("unguarded", guard=False)
            if not (lean["iters_run"] < MAIN_MAX_ITERS
                    and pipe_main["status"] == "stagnated"
                    and lean["longest_stall"] >= STALL_WINDOW):
                raise AssertionError(f"{PIPE_METHOD}: status "
                                     f"{pipe_main['status']}, unguarded {lean}")
        pcg = main_runs.get("ell", {})
        say(f"main {PIPE_METHOD} ok: {steps} iterations, {pipe_main['status']}, "
            f"{pipe_main['us_per_iter']:.1f} us per iteration, "
            f"{pipe_main['wall_s']:.3f} s; pcg_tol in this run: "
            f"{pcg.get('iters_run')} iterations, {pcg.get('status')}, "
            f"{pcg.get('us_per_iter', float('nan')):.1f} us per iteration, "
            f"{pcg.get('wall_s', float('nan')):.3f} s")
    except Exception:
        traceback.print_exc()
        failed.append("main pipelined")

    # -- 4g2. the pipelined main path at k = 8: ell_spmm every step ---------
    pipe_batched = None
    try:
        m = m_main
        a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
        k = MAIN_BATCH
        x_lanes = np.random.default_rng(0).standard_normal((k, m.shape[0]))
        B = (a @ x_lanes.T).T                # lane 0 is the 1-D solve's b
        eng = AzulEngine(m, dtype=np.float64)

        def solve_pipe_batched(label: str, lanes=None):
            return solve_main_batched(eng, a, B, f"{PIPE_METHOD} {label}",
                                      lanes, method=PIPE_METHOD)

        pipe_batched, iters_p, norms_p = solve_pipe_batched("fused")
        lc, steps = pipe_batched["launches"], pipe_batched["loop_steps"]
        if (lc["ell_spmm"] != steps + 2
                or any(v for k2, v in lc.items() if k2 != "ell_spmm")):
            raise AssertionError(f"{PIPE_METHOD} k={k} launches {lc} for "
                                 f"{steps} loop steps")
        for j in BATCH_LANES_AGAIN:
            solo, it1, norms1 = solve_pipe_batched(f"lane {j} alone", (j,))
            it = int(iters_p[j])
            if (it1[0] != it or solo["status"][0] != pipe_batched["status"][j]
                    or solo["bad_iter"][0] != pipe_batched["bad_iter"][j]
                    or not np.array_equal(norms1[: it + 1, 0],
                                          norms_p[: it + 1, j])):
                raise AssertionError(f"{PIPE_METHOD} lane {j}: k={k} gives "
                                     f"{it} iterations, "
                                     f"{pipe_batched['status'][j]}; alone "
                                     f"{solo}")
        if pipe_main is not None and (
                pipe_batched["status"][0] != pipe_main["status"]
                or abs(int(iters_p[0]) - pipe_main["iters_run"])
                > 0.01 * pipe_main["iters_run"]):
            raise AssertionError(f"{PIPE_METHOD} lane 0: {iters_p[0]}, "
                                 f"{pipe_batched['status'][0]}; one RHS "
                                 f"{pipe_main['iters_run']}, "
                                 f"{pipe_main['status']}")
        say(f"main {PIPE_METHOD} k={k} ok: lanes {iters_p.tolist()} "
            f"{pipe_batched['status']} (one RHS: "
            f"{pipe_main and pipe_main['iters_run']}, "
            f"{pipe_main and pipe_main['status']}); ell_spmm launched "
            f"{lc['ell_spmm']} = max(iters) + 2 times; "
            f"{pipe_batched['us_per_iter']:.1f} us per loop step, "
            f"{pipe_batched['us_per_iter_per_rhs']:.1f} us per RHS")
        del eng
    except Exception:
        traceback.print_exc()
        failed.append("main pipelined batched")

    # -- 4h. the kernels.ops API at the main-path shapes ---------------------
    ops_launches = {}
    try:
        eng = AzulEngine(m_main, dtype=np.float64)
        cols, vals = eng.ell.cols, eng.ell.vals
        f = ic0_engine()._ic0
        gen = torch.Generator(device="cuda").manual_seed(6)
        vec = lambda *lead: torch.randn(*lead, cols.shape[0], generator=gen,
                                        device="cuda", dtype=torch.float64)
        x, y = vec(), vec()
        X = vec(MAIN_BATCH).T.contiguous()           # the JAX layout (n, k)
        bl = torch.zeros(f.ell_l.rows_padded, dtype=torch.float64,
                         device="cuda")
        bl[: f.n] = vec()[: f.n]
        diag = factor_diag(f.ell_l)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = now()
        yv, pap = ops.ell_spmv_dot(cols, vals, x)
        Y, paps = ops.ell_spmm_dot(cols, vals, X)
        z, zz = ops.axpy_dot(0.61, x, y)
        xl = level_solve(f.ell_l.cols, f.ell_l.vals, diag, bl, f.sched_l.rows,
                         f.n, inplace=False)
        torch.cuda.synchronize()
        wall = now() - t0
        ops_launches = ops.launch_counts()
        want = {"ell_spmv_dot": 1, "ell_spmm_dot": 1, "axpy_dot": 1,
                "sptrsv_level_step": f.sched_l.n_levels}
        got = {k2: v for k2, v in ops_launches.items() if v}
        finite = all(bool(torch.isfinite(t).all())
                     for t in (yv, pap, Y, paps, z, zz, xl))
        say(f"main ops: ell_spmv_dot, ell_spmm_dot (k={MAIN_BATCH}), axpy_dot "
            f"at {tuple(cols.shape)} and the level-by-level solve over "
            f"lap2d_1024's L factor through kernels.ops: launches "
            f"{json.dumps(got)}, {wall:.3f} s, outputs finite {finite}, "
            f"shapes {tuple(Y.shape)} {tuple(paps.shape)} {tuple(xl.shape)}")
        if got != want or not finite or Y.shape != X.shape:
            raise AssertionError(f"main ops: launches {got}, want {want}")
    except Exception:
        traceback.print_exc()
        failed.append("main ops")

    # -- 4i. compiled plans: the captured round against a direct call -------
    try:
        from repro_torch.core import registry
        from repro_torch.core.solvers import ensure_status

        m = m_main
        a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
        x_lanes = np.random.default_rng(0).standard_normal((MAIN_BATCH,
                                                            m.shape[0]))
        B = (a @ x_lanes.T).T
        b = B[0]                             # the one-RHS main path's b
        eng_ell = AzulEngine(m, dtype=np.float64)
        eng_st = AzulEngine(lap2d_stencil(MAIN_GRID), dtype=np.float64)
        k = MAIN_BATCH
        paths = (
            ("ell", eng_ell, "pcg_tol", None,
             lambda s: {"ell_spmv": 1, "ell_spmv_pfold_dot": s, "cg_update": s}),
            (f"ell k={k}", eng_ell, "pcg_tol", k,
             lambda s: {"ell_spmm": 1, "ell_spmm_pfold_dot": s,
                        "cg_update_batched": s}),
            ("block_ic0", ic0_engine(), "pcg_tol", None,
             lambda s: {"ell_spmv": 1, "ell_spmv_pfold_dot": s, "cg_update": s,
                        "sptrsv_solve_dot": 2 * (s + 1)}),
            ("bcsr", bcsr_engine(), "pcg_tol", None,
             lambda s: {"bcsr_spmm": s + 1, "cg_update": s}),
            (f"bcsr k={k}", bcsr_engine(), "pcg_tol", k,
             lambda s: {"bcsr_spmm": s + 1, "cg_update_batched": s}),
            (PIPE_METHOD, eng_ell, PIPE_METHOD, None,
             lambda s: {"ell_spmv": s + 2}),
            (f"{PIPE_METHOD} k={k}", eng_ell, PIPE_METHOD, k,
             lambda s: {"ell_spmm": s + 2}),
            ("stencil", eng_st, "pcg_tol", None, lambda s: {"cg_update": s}),
        )
        for label, eng, method, batch, want_of in paths:
            rhs = b if batch is None else B
            plan = eng.plan(SolveSpec(method=method, tol=MAIN_TOL,
                                      max_iters=MAIN_MAX_ITERS, batch=batch))
            built = []                       # (captures, capture_s) a call
            for _ in range(PLAN_CALLS - 1):
                plan(rhs)
                built.append((plan.cell.captures, plan.cell.capture_s))
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            replays = plan.cell.replays
            t0 = now()
            x, norms = plan(rhs)
            torch.cuda.synchronize()
            wall = now() - t0
            lc = {k2: v for k2, v in ops.launch_counts().items() if v}
            replayed = plan.cell.replays - replays
            built.append((plan.cell.captures, plan.cell.capture_s))
            plan.assert_steady()
            # the same solver function called directly, outside the plan:
            # its rounds run eagerly
            bd = eng.to_device_vec(rhs)
            ops.reset_launch_counts()
            t0 = now()
            res = ensure_status(registry.get_solver(method).run(
                plan.context, bd, torch.zeros_like(bd)), bd)
            xd = eng.from_device_vec(res.x)
            direct_wall = now() - t0
            direct_lc = {k2: v for k2, v in ops.launch_counts().items() if v}
            iters = np.atleast_1d(np.asarray(plan.last_iters))
            steps = int(iters.max())
            same = {
                "x": xd.tobytes() == x.tobytes(),
                "trace": res.res_norms.tobytes() == norms.tobytes(),
                "iters": np.array_equal(res.iters, plan.last_iters),
                "status": np.array_equal(res.status, plan.last_status),
                "bad_iter": np.array_equal(res.bad_iter, plan.last_bad_iter),
            }
            want_iters = (MAIN_IC0_ITERS,) if label == "block_ic0" else (
                MAIN_LANES[:1] if batch is None else MAIN_LANES)
            out = {
                "method": method, "format": plan.info["format"],
                "substrate": plan.info["substrate"], "k": batch or 1,
                "iters": iters.tolist(), "status": plan.last_status_names,
                "executions": plan.executions, "traces": plan.traces,
                "captures": plan.cell.captures, "replays": replayed,
                "capture_s": plan.cell.capture_s,
                "step_nodes": plan.cell.step_nodes, "wall_s": wall,
                "us_per_iter": wall / max(steps, 1) * 1e6,
                "direct_wall_s": direct_wall,
                "direct_us_per_iter": direct_wall / max(steps, 1) * 1e6,
                "launches": lc, "direct_launches": direct_lc,
                "bitwise_equal": same,
            }
            say(f"plan {label}: " + json.dumps(out))
            if (not all(same.values()) or plan.traces != 1 or replayed != 1
                    or built != [(1, built[0][1])] * PLAN_CALLS
                    or built[0][1] is None
                    or lc != want_of(steps)
                    or tuple(iters.tolist()) != tuple(want_iters)):
                raise AssertionError(f"plan {label}: {out} (launches want "
                                     f"{want_of(steps)}, iterations want "
                                     f"{want_iters})")
        # the round length: the same plans captured with loop.CHUNK = 1 (a
        # WHILE pass a step: the state copied back every step) on a fresh
        # engine, against eng_ell's CHUNK plans; each timed warm twice in
        # mirrored order, the results bitwise equal
        from repro_torch.core import loop
        eng_one = AzulEngine(m, dtype=np.float64)
        for label, batch in (("ell", None), (f"ell k={k}", k)):
            rhs = b if batch is None else B
            spec = SolveSpec(method="pcg_tol", tol=MAIN_TOL,
                             max_iters=MAIN_MAX_ITERS, batch=batch)
            plans = {loop.CHUNK: eng_ell.plan(spec)}
            saved, loop.CHUNK = loop.CHUNK, 1
            try:
                plans[1] = eng_one.plan(spec)
                plans[1](rhs)                # the capture, at CHUNK = 1
            finally:
                loop.CHUNK = saved
            walls = {c: [] for c in plans}
            outs = {}
            for c in (1, saved, saved, 1):
                torch.cuda.synchronize()
                t0 = now()
                outs[c] = plans[c](rhs)
                torch.cuda.synchronize()
                walls[c].append(now() - t0)
            steps = max(int(np.max(plans[saved].last_iters)), 1)
            ab = {f"chunk {c}": {
                "capture_s": p.cell.capture_s,
                "step_nodes": p.cell.step_nodes,
                "us_per_step": [w / steps * 1e6 for w in walls[c]]}
                for c, p in plans.items()}
            ab["steps"] = steps
            ab["bitwise_equal"] = all(
                u.tobytes() == v.tobytes()
                for u, v in zip(outs[1], outs[saved]))
            say(f"round length plan {label}: " + json.dumps(ab))
            if not ab["bitwise_equal"]:
                raise AssertionError(f"round length {label}: CHUNK 1 and "
                                     f"{saved} disagree")
        say(f"compiled plans ok: {len(paths)} paths replay their captured "
            f"loop (one build and one capture each after {PLAN_CALLS} "
            "calls), bitwise equal to a direct call of the solver, launches "
            "per solve as the kernels counted them on the card")
        del eng_ell, eng_st, eng_one
    except Exception:
        traceback.print_exc()
        failed.append("compiled plans")

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
            if name == "ell_spmm" and pipe_batched is not None:
                counts = pipe_batched["launches"]   # every pipelined step
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
                "outside them (the guards' and the stop test's small ops, "
                "the partial sums, the conditional nodes and the round's "
                "copies, the copies in and out)")

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
    sptrsv_times: dict = {}            # phase 5e sets the level step beside
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
                blocks=launch_shape(pack, ell.cols.shape[1], bb.device),
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
                f"{sv['levels']} levels, {sv['blocks']} "
                f"({1e3 * sv['ms'] / sv['levels']:.3f} us a level); plain "
                f"{sv['plain_ms']:.4f} ms, bound {sv['bound_ms']:.4f} ms "
                f"({sv['nbytes']} bytes)")
        say(f"time sptrsv_solve_dot chain of {CHAIN_ROWS} one-row levels: "
            f"{chain_ms:.4f} ms ({1e3 * chain_ms / CHAIN_ROWS:.3f} us a "
            "level, events around eager launches)")
        say(f"library torch.triangular_solve (sparse CSR, reversed U, no dot): "
            f"{lib_ms} ms")
        sptrsv_times.update({label: sv["ms"] for label, sv in solves.items()},
                            how=how, library=lib_ms)
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
            # the rest (flips, pads, the guards' small ops, the copies)
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
                "torch ops, cg_update, the guards' small ops and the copies "
                "are the rest)")
    except Exception:
        traceback.print_exc()
        failed.append("times bcsr_spmm")

    # -- 5f. ell_spmv: the first slice's design against the redesign ------
    try:
        gen = torch.Generator(device="cuda").manual_seed(8)
        eng = AzulEngine(m_main, dtype=np.float64)
        cases = [("lap2d_1024 f64", eng.ell.cols, eng.ell.vals, m_main),
                 ("lap2d_1024 f32", eng.ell.cols, eng.ell.vals.float(), m_main)]
        if "eng" in skew_state:
            se = skew_state["eng"]
            cases.append(("skew_2^20 f64", se.ell.cols, se.ell.vals,
                          skew_state["m"]))
        ab = {}
        for label, cols, vals, m in cases:
            rows, w = cols.shape
            x = torch.randn(rows, generator=gen, device="cuda", dtype=vals.dtype)
            lib = csr_on_card(m, vals.dtype)
            kept = ell_spmv.spmv_variant(w)
            old = ell_spmv.ell_spmv(cols, vals, x, variant="group")
            runs = {"old (group)": lambda: ell_spmv.ell_spmv(
                        cols, vals, x, variant="group"),
                    f"new ({kept}, kept)": lambda: ell_spmv.ell_spmv(cols, vals, x)}
            for name, fn in runs.items():
                if not torch.equal(fn(), old):
                    raise AssertionError(f"ell_spmv {label} {name}: y differs "
                                         "from the first slice's design")
            e = vals.element_size()
            nbytes = rows * w * (4 + e) + 2 * rows * e
            runs["torch CSR @ x"] = lambda: lib @ x[: m.shape[0]]
            ab[label] = dict(W=w, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                             ms=mirrored_ms(runs))
        say("A/B ell_spmv (ms, CUDA-graph replays, each timed twice in "
            "mirrored order; bound = bytes / 3.35 TB/s): " + json.dumps(ab))
        del eng
    except Exception:
        traceback.print_exc()
        failed.append("A/B ell_spmv")

    # -- 5h. the p-fold gathers: the first slice's design against the redesign
    try:
        gen = torch.Generator(device="cuda").manual_seed(10)
        eng = AzulEngine(m_main, dtype=np.float64)
        cases = [("lap2d_1024 f64", eng.ell.cols, eng.ell.vals, m_main),
                 ("lap2d_1024 f32", eng.ell.cols, eng.ell.vals.float(), m_main)]
        if "eng" in skew_state:
            se = skew_state["eng"]
            cases.append(("skew_2^20 f64", se.ell.cols, se.ell.vals,
                          skew_state["m"]))
        ab = {label: pfold_ab_cell(cols, vals, m, gen, label)
              for label, cols, vals, m in cases}
        say("A/B p-fold (ms, CUDA-graph replays, each timed twice in mirrored "
            "order; bound = bytes / 3.35 TB/s; P', Y and pap bitwise the first "
            "design's, lanes bitwise the k = 1 and 1-D calls): "
            + json.dumps(ab))
        for label, cell in ab.items():
            for key in ("1-D", "k=8"):
                c = cell[key]
                kept_ms = min(c["ms"][f"kept ({cell['kept']})"])
                first_ms = min(c["ms"]["first design (group)"])
                say(f"  {label} {key}: kept {cell['kept']} {kept_ms:.4f} ms "
                    f"({100 * c['bound_ms'] / kept_ms:.0f}% of its "
                    f"{c['bound_ms']:.4f} ms bound), first design "
                    f"{first_ms:.4f} ms")
        del eng
    except Exception:
        traceback.print_exc()
        failed.append("A/B p-fold")

    # -- 5i. the batched gathers: bcsr_spmm and ell_spmm, first vs redesign
    try:
        gen = torch.Generator(device="cuda").manual_seed(12)
        obj = bcsr_engine()._format_obj("bcsr")
        nbc = -(-obj.n_cols // obj.bn)
        a = sp.csr_matrix((m_main.data, m_main.indices, m_main.indptr),
                          shape=m_main.shape)
        bsr = a.tobsr(blocksize=(obj.bm, obj.bn))
        ab = {}
        for dname in ("float64", "float32"):
            td = getattr(torch, dname)
            lib = torch.sparse_bsr_tensor(
                torch.as_tensor(bsr.indptr, dtype=torch.int64),
                torch.as_tensor(bsr.indices, dtype=torch.int64),
                torch.as_tensor(bsr.data).to(td), size=a.shape).to("cuda")
            ab[f"bcsr lap2d_1024 8x8 f{dname[5:]}"] = bcsr_ab_cell(
                obj.block_cols, obj.blocks.to(td), nbc, lib, m_main.shape[0],
                gen, dname)
            del lib
        eng = AzulEngine(m_main, dtype=np.float64)
        cases = [("lap2d_1024 f64", eng.ell.cols, eng.ell.vals, m_main),
                 ("lap2d_1024 f32", eng.ell.cols, eng.ell.vals.float(), m_main)]
        if "eng" in skew_state:
            se = skew_state["eng"]
            cases.append(("skew_2^20 f64", se.ell.cols, se.ell.vals,
                          skew_state["m"]))
        for label, cols, vals, m in cases:
            ab[f"ell_spmm {label}"] = ell_spmm_ab_cell(cols, vals, m, gen, label)
        say("A/B batched gathers (ms, CUDA-graph replays, each timed twice in "
            "mirrored order; bound = bytes / 3.35 TB/s; Y bitwise the first "
            "design's, lanes bitwise the one-lane calls): " + json.dumps(ab))
        for label, cell in ab.items():
            for key, c in cell.items():
                if not isinstance(c, dict):
                    continue
                kept = [v for nm, v in c["ms"].items()
                        if "kept" in nm] or [c["ms"][next(iter(c["ms"]))]]
                kept_ms = min(kept[0])
                first_ms = min(next(iter(c["ms"].values())))
                say(f"  {label} {key}: kept {cell['kept']} {kept_ms:.4f} ms "
                    f"({100 * c['bound_ms'] / kept_ms:.0f}% of its "
                    f"{c['bound_ms']:.4f} ms bound), first design "
                    f"{first_ms:.4f} ms")
        del eng
    except Exception:
        traceback.print_exc()
        failed.append("A/B batched gathers")

    # -- 5g. sptrsv_solve_dot: every variant on every factor ----------------
    try:
        gen = torch.Generator(device="cuda").manual_seed(9)
        f = ic0_engine()._ic0
        factors = [("lap2d_1024 L", f.ell_l, f.sched_l.rows, f.n, False),
                   ("lap2d_1024 reversed U", f.ell_u_rev, f.sched_u_rev.rows,
                    f.n, True)]
        for label, m in triangular_cases().items():
            if label.startswith("diagonal"):
                continue
            ell = ell_from_csr(m, row_pad=8, width_pad=8, dtype=np.float64)
            factors.append((label, ell, torch.from_numpy(
                build_schedule(m).rows).cuda(), m.shape[0], True))
        # the threshold sweep: striped factors of `levels` levels of `width`
        # rows, row (i, j) reading (i - 1, j) and (i - 1, (j + 1) % width)
        levels = 128
        for width in (256, 1024, 2048, 4096, 8192):
            n = levels * width
            i = np.arange(width, n)
            lo = i - width
            hi = (i // width - 1) * width + (i % width + 1) % width
            low = sp.csr_matrix((np.concatenate([np.full(n, 2.0),
                                                 np.full(2 * (n - width), -0.4)]),
                                 (np.concatenate([np.arange(n), i, i]),
                                  np.concatenate([np.arange(n), lo, hi]))),
                                shape=(n, n))
            ell = ell_from_csr(csr_from_scipy(low), row_pad=8, width_pad=8,
                               dtype=np.float64)
            sched = np.arange(n, dtype=np.int32).reshape(levels, width)
            factors.append((f"striped {levels} x {width}", ell,
                            torch.from_numpy(sched).cuda(), n, True))
        table = {}
        for label, ell, rows, n, with_dot in factors:
            ell, rows, dinv, bb, w, pack = factor_inputs(ell, rows, n,
                                                         "float64", gen)
            wd = w if with_dot else None
            cols, vals = ell.cols, ell.vals
            kept = sptrsv.solve_variant(pack.n_levels, pack.max_width,
                                        cols.shape[1])
            names = ["cooperative"] + (["cluster"] if kept == "cluster"
                                       else [])
            want = sptrsv.sptrsv_solve_dot(cols, vals, dinv, bb, pack, wd,
                                           variant="cooperative")
            for v in names[1:]:
                got = sptrsv.sptrsv_solve_dot(cols, vals, dinv, bb, pack, wd,
                                              variant=v)
                compare(f"sptrsv_solve_dot {label} {v} vs cooperative",
                        (got[0], got[1].reshape(1)),
                        (want[0], want[1].reshape(1)), "float64")
            t = {v: [] for v in names}
            for v in names + names[::-1]:             # in turns, both ways
                fn = lambda v=v: sptrsv.sptrsv_solve_dot(cols, vals, dinv, bb,
                                                         pack, wd, variant=v)
                try:
                    t[v].append(device_ms(fn, reps=3, windows=3))
                except RuntimeError:
                    torch.cuda.synchronize()
                    t[v].append(eager_ms(fn, reps=3, windows=3))
            lib_ms = None
            try:
                keep = ell.vals[:n].cpu().numpy() != 0
                low = sp.csr_matrix(
                    (ell.vals[:n].cpu().numpy()[keep],
                     ell.cols[:n].cpu().numpy()[keep],
                     np.concatenate([[0], np.cumsum(keep.sum(1))])), shape=(n, n))
                a_lib = torch.sparse_csr_tensor(
                    torch.as_tensor(low.indptr, dtype=torch.int64),
                    torch.as_tensor(low.indices, dtype=torch.int64),
                    torch.as_tensor(low.data), size=low.shape).to("cuda")
                b_col = bb[:n].reshape(-1, 1).contiguous()
                lib_ms = eager_ms(lambda: torch.triangular_solve(
                    b_col, a_lib, upper=False), reps=2, windows=3)
            except Exception as exc:         # a yardstick only: report it
                torch.cuda.synchronize()
                lib_ms = repr(exc)[:80]
            table[label] = dict(
                levels=pack.n_levels, widest=pack.max_width, W=cols.shape[1],
                kept=kept, dot=with_dot,
                us_per_level={v: [1e3 * ms / pack.n_levels for ms in t[v]]
                              for v in names},
                ms=t, torch_triangular_solve_ms=lib_ms)
        say("A/B sptrsv_solve_dot (ms a solve, CUDA-graph replays, each timed "
            "twice in mirrored order; f64): " + json.dumps(table))
        for label, row in table.items():
            say(f"  {label}: {row['levels']} levels, widest {row['widest']}, "
                f"kept {row['kept']}: " + ", ".join(
                    f"{v} {min(us):.3f} us a level"
                    for v, us in row["us_per_level"].items()))
    except Exception:
        traceback.print_exc()
        failed.append("A/B sptrsv_solve_dot")

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

    # -- 5e. the kernels.ops kernels' times; the pipelined step -----------
    try:
        from repro_torch.core import solvers, substrate

        eng = AzulEngine(m_main, dtype=np.float64)
        cols, vals = eng.ell.cols, eng.ell.vals
        rows, w = cols.shape
        e = vals.element_size()
        k = MAIN_BATCH
        mat_bytes = rows * w * (4 + e)
        gen = torch.Generator(device="cuda").manual_seed(7)
        vec = lambda *lead: torch.randn(*lead, rows, generator=gen,
                                        device="cuda", dtype=torch.float64)
        x, y = vec(), vec()
        Xs = vec(k)                                  # the solver layout
        X = Xs.T.contiguous()                        # the JAX layout
        a = sp.csr_matrix((m_main.data, m_main.indices, m_main.indptr),
                          shape=m_main.shape)
        a_lib = torch.sparse_csr_tensor(
            torch.as_tensor(a.indptr, dtype=torch.int64),
            torch.as_tensor(a.indices, dtype=torch.int64),
            torch.as_tensor(a.data, dtype=torch.float64),
            size=a.shape).to("cuda")
        alpha = torch.tensor(0.61, dtype=torch.float64, device="cuda")
        pairs = [(vec(), vec()) for _ in range(4)]
        # name -> (kernel, plain, bytes, flops, library call): bytes read
        # each input once and write each output once; the library call
        # computes the same function with PyTorch's own operators
        work = {
            "ell_spmv_dot": (
                lambda: spmv_dot.ell_spmv_dot(cols, vals, x),
                lambda: spmv_dot.ell_spmv_dot_plain(cols, vals, x),
                mat_bytes + 2 * rows * e + e, 2 * rows * w + 2 * rows,
                lambda: torch.dot(x, a_lib @ x)),
            "ell_spmm_dot": (
                lambda: spmv_dot.ell_spmm_dot(cols, vals, X),
                lambda: spmv_dot.ell_spmm_dot_plain(cols, vals, X),
                mat_bytes + 2 * k * rows * e + k * e,
                2 * rows * w * k + 2 * k * rows,
                lambda: (X * (a_lib @ X)).sum(0)),
            # x, y and z (25 MB) would stay in the 50 MB L2 across
            # back-to-back calls: each call takes the next of four (x, y)
            # pairs, 101 MB in all, so that it reads them from memory
            "axpy_dot": (
                rotating(lambda u, v: vecops.axpy_dot(alpha, u, v), pairs),
                rotating(lambda u, v: vecops.axpy_dot_plain(alpha, u, v), pairs),
                3 * rows * e + 2 * e, 4 * rows,
                rotating(lambda u, v: (lambda zv: torch.dot(zv, zv))(
                    torch.add(v, u, alpha=0.61)), pairs)),
        }
        times = {name: (device_ms(kern), eager_ms(kern), device_ms(plain))
                 for name, (kern, plain, *_) in work.items()}
        view_ms = device_ms(lambda: spmv_dot.ell_spmm_dot(cols, vals, Xs.T))
        lib = {}
        for name, (*_, lib_fn) in work.items():      # timed last, as in 5
            try:
                lib[name] = device_ms(lib_fn)
            except RuntimeError as exc:
                say(f"library for {name} not capturable ({exc}); timed eagerly")
                torch.cuda.synchronize()
                lib[name] = eager_ms(lib_fn)
        for name, (_, _, nbytes, flops, _) in work.items():
            ms, ms_eager, plain_ms = times[name]
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS["float64"] * 1e3
            src_file, replaces = SOURCES[name]
            rows_out.append({
                "name": name, "route": "cuda", "source": src_file,
                "replaces": replaces, "launches": ops_launches.get(name, 0),
                "max_abs_err": main_errs.get(name),
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib[name],
            })
            say(f"time {name}{f' k={k}' if name == 'ell_spmm_dot' else ''}: "
                f"{ms:.4f} ms on the card, {ms_eager:.4f} ms launched from "
                f"Python (plain {plain_ms:.4f} ms, bound "
                f"{max(t_bytes, t_ops):.4f} ms ({nbytes} bytes), library "
                f"{lib[name]:.4f} ms)")
        say(f"time ell_spmm_dot k={k} on the transposed view of the solver's "
            f"(k, n): {view_ms:.4f} ms on the card (row-major: "
            f"{times['ell_spmm_dot'][0]:.4f} ms)")

        # sptrsv_level_step: one level at the widest of lap2d_1024's L
        # factor, then the whole solve, one launch a level
        f = ic0_engine()._ic0
        ell, sched = f.ell_l, f.sched_l
        lcols, lvals, n = ell.cols, ell.vals, f.n
        diag = factor_diag(ell)
        bl = torch.zeros(ell.rows_padded, dtype=torch.float64, device="cuda")
        bl[:n] = vec()[:n]
        srows = torch.as_tensor(sched.rows, device="cuda")
        widest = int(np.argmax(sched.counts))
        lv = srows[widest]
        xs = torch.zeros(n + 1, dtype=torch.float64, device="cuda")
        one = lambda: sptrsv.sptrsv_level_step(lcols, lvals, diag, bl, xs, lv,
                                               out=xs)
        one_ms, one_eager = device_ms(one), eager_ms(one)
        one_plain = eager_ms(lambda: sptrsv.sptrsv_level_step_plain(
            lcols, lvals, diag, bl, xs, lv), reps=10, windows=3)
        # what one level needs: its distinct factor rows (cols, vals, b,
        # diag), the x entries they gather, the ids, the values written
        w_l = lcols.shape[1]
        lr = torch.clamp(lv.long(), max=lcols.shape[0] - 1)
        u_rows = torch.unique(lr)
        u_x = torch.unique(torch.clamp(lcols[u_rows].long(), max=n))
        u_out = torch.unique(lv[lv <= n])
        nbytes = (u_rows.numel() * w_l * (4 + e) + 2 * u_rows.numel() * e
                  + lv.numel() * 4 + u_x.numel() * e + u_out.numel() * e)
        one_bound = nbytes / HBM_BYTES_PER_S * 1e3

        def full():
            xs.zero_()
            for lvl in srows:
                sptrsv.sptrsv_level_step(lcols, lvals, diag, bl, xs, lvl, out=xs)

        full_eager = eager_ms(full, reps=2, windows=3)
        try:
            full_graph, full_how = device_ms(full, reps=1, windows=5), "one graph"
        except RuntimeError as exc:
            torch.cuda.synchronize()
            full_graph, full_how = None, f"not capturable ({exc!r})"
        say(f"time sptrsv_level_step lap2d_1024 L, widest level {widest} "
            f"({int(sched.counts[widest])} rows of {lv.numel()} ids, w={w_l}): "
            f"{one_ms:.5f} ms on the card, {one_eager:.5f} ms launched from "
            f"Python (plain {one_plain:.4f} ms, eager: its boolean scatter "
            f"syncs; bound {one_bound:.6f} ms, {nbytes} bytes)")
        say(f"time level-by-level solve of lap2d_1024's L ({sched.n_levels} "
            f"launches): {full_eager:.4f} ms launched from Python, "
            f"{full_graph} ms as {full_how}; sptrsv_solve_dot on the same "
            f"factor: {sptrsv_times.get('L')} ms ({sptrsv_times.get('how')}), "
            f"torch triangular_solve (reversed U): "
            f"{sptrsv_times.get('library')} ms")
        rows_out.append({
            "name": "sptrsv_level_step", "route": "cuda",
            "source": SOURCES["sptrsv_level_step"][0],
            "replaces": SOURCES["sptrsv_level_step"][1],
            "launches": ops_launches.get("sptrsv_level_step", 0),
            "max_abs_err": main_errs.get("sptrsv_level_step"),
            "ms": one_ms, "plain_ms": one_plain, "bound_ms": one_bound,
            "bound_by": "bytes", "library_ms": None,
        })

        # one Jacobi pipelined step at lap2d_1024 on the card, by part
        sub = substrate.fused_local_substrate(cols, vals, eng._dinv_pad)
        state, _ = solvers._pipe_start(sub, vec(), None)
        step1 = torch.ones((), dtype=torch.int32, device="cuda")   # k > 0
        vs = [vec() for _ in range(10)]
        beta = torch.tensor(0.3, dtype=torch.float64, device="cuda")
        parts = {
            "step": device_ms(lambda: solvers._pipe_step(sub, step1, state)),
            "matvec (ell_spmv)": device_ms(lambda: sub.matvec(vs[0])),
            "psolve (r * dinv)": device_ms(lambda: sub.psolve(vs[0])),
            "pipe_update": device_ms(lambda: substrate.pipe_update(
                beta, alpha, *vs)),
            "pipe_dots": device_ms(lambda: sub.pipe_dots(*vs[:3])),
        }
        parts_us = {k2: 1e3 * v for k2, v in parts.items()}
        parts_us["scalars and the rest on the card"] = parts_us["step"] - sum(
            v for k2, v in parts_us.items() if k2 != "step")
        if pipe_main is not None:
            parts_us["wall per step"] = pipe_main["us_per_iter"]
            parts_us["host (wall - step on the card)"] = (
                pipe_main["us_per_iter"] - parts_us["step"])
        say(f"per iteration {PIPE_METHOD} jacobi (us, CUDA-graph replays at "
            f"{tuple(cols.shape)}): " + json.dumps(parts_us))
    except Exception:
        traceback.print_exc()
        failed.append("times ops-only")

    # -- 6. the solve service ------------------------------------------------
    service_phase(m_main, failed)

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
