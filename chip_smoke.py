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
               x and bitwise against the first design (``variant=
               "first"``), the functional and in-place solves bitwise
               equal, the in-place solve bitwise the first design's, and
               the solved x against sptrsv_solve_dot's, within the
               tolerance; on lap2d_1024's L, the in-place solve with a
               torch op rewriting b on the stream before each level (a
               copy, or a multiply by 1; b is NaN between levels), eager
               and as one CUDA graph, bitwise the solve without it: the
               new design's programmatic wait orders its reads after
               that op.
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
               <= 1e-7.  Then lap2d_128 on the fused and on the reference
               substrate (plain torch, a Python loop over the levels):
               the same status, iterations within 1% of each other and of
               the JAX package's 96.
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
               level of lap2d_1024's L (20 in one graph) and the whole
               2047-launch solve as one graph, the first design against
               the new one in mirrored order (first, new, new, first; the
               new one without programmatic dependent launch and with
               scalar row loads between), eager beside, and
               sptrsv_solve_dot's; and one Jacobi pipelined step by part
               (graph replays).
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
               1e-6), and beside it (both at once) with ``--load-gen open
               --rate 50 --requests 40`` (40 converged, no retrace, the
               outcomes' largest true relative residual <= 1e-8); both
               with ``degraded_batches`` 0.

7. ft      -- fault-tolerant solves (``repro_torch.ft``) on the service's
               operator, laplacian_3d(100) (n = 1,000,000), f64 Jacobi
               pcg_tol at tol 1e-8, budget 20,000, chunks of 25, b = A
               x_true (x_true from default_rng(0)).  7a: the chunk-sized
               injectable plan against the plain one: a clean call bitwise
               the plain plan's (x, trace; a warm start too) with its
               launch counts; a NaN operand breaks down at iteration 0;
               the next clean call bitwise the clean result; engine.spmv
               and the engine's values unchanged; one value buffer,
               16-byte aligned, not the engine's; one build, one capture.
               Times: a clean and a corrupted chunk's wall, the plan on the
               card (CUDA events), the value copy-in from the host and
               device to device, the vectors' copies, the host audit.  7b:
               a clean chunked solve, then a nan and a bitflip fault at
               iteration 100 (seed 1), each detected in its chunk, rolled
               back and converged, true relative residual <= 100 x tol
               (scipy, host); launch counts zeroed just before and read
               just after each: ell_spmv once a chunk, the p-fold and the
               update once a loop step, no other kernel.  7c: a stuck-at
               nan gives up after max_restarts + 1 = 4 restarts with the
               fault's label.  7d: checkpoints in a temporary directory
               and a nan at iteration 150: converged, and a fresh manager
               resumes (resumed_from > 0); a checkpoint save's time.  7e:
               a 0.5 s delay at iteration 100 is flagged by StepTimer, with
               no restart.  7f: ``python -m repro_torch.launch.solve``
               with FT_CLI (lap2d_96, --inject nan --inject-at 10
               --ft-chunk 25 --max-iters 2000) exits 0, converged, with a
               restart.  7g: the FT_PARITY scenarios at lap2d_16 against
               the JAX package's reports: statuses, restarts and fault
               labels equal, iterations and chunks +-1.  Last, the
               injectable plan's traces and captures (1 and 1) over the
               whole phase, and the times beside the card's name and power
               limit, the fault-tolerant solve's wall and iterations
               against one uninterrupted warm plan(b) among them.
8. grid     -- the tile grid (``AzulEngine(mesh=make_mesh(...))``, every
               tile on the card) at laplacian_3d(100), n = 1,000,000, f64
               Jacobi pcg_tol, tol 1e-8: a 2x2 2d grid and a 4-tile 1d grid
               (4x1, mode "1d"), each with layout halo and dense.  8a: the
               stacked-tile ``ell_spmv`` (the (4*rows_p, 8) blocks with
               columns offset into the (4, m) buffer), ``ell_spmm`` (k =
               8) and ``cg_update`` (1-D and k = 8) against their plain
               versions, rtol 1e-12.  8b: ``spmv`` against the local
               engine's within 1e-12 x max|y|; halo == dense bitwise.
               8c: each grid plan's iterations and status within one of
               the local engine's on the card, true relative residual <=
               1e-7 (scipy, host), traces == 1 over 3 calls, its launch
               counts per solve (zeroed just before the third call, read
               just after: the kernels of the path, each > 0) and
               ``hlo_summary()``.  8d: k = 8 on the 2x2 grid, per-lane
               counts within one of the local k = 8's; lane 0 solved alone
               (a k = 1 batch, as phase 4) with lane 0's count and status
               and its residual trace bitwise.  8e:
               ``pcg_pipelined_tol`` on the 1d halo grid (the overlapped
               interior/frontier matvec) and dense: equal counts, bitwise
               equal x; ``hlo_summary`` all-reduce 2 for ``pcg_pipelined``
               against pcg's 4.  8f: block-IC(0) on the 2x2 grid at
               laplacian_2d(512) (cut from 1024: the host IC(0) of the
               tiles' blocks): converged, true residual <= 1e-7, two
               ``sptrsv_solve_dot`` a step.  8g: DIST_PARITY and
               DIST_PARITY_IC0 within one.  8h: microseconds a loop step,
               grid against local, one RHS and k = 8 (warm unguarded pcg,
               GRID_STEPS steps minus 0, medians of 3 calls), the guarded pcg_tol
               wall over its iterations, the step's graph nodes and the NoC
               gathers' words, each NoC stage's time on the card, beside
               the card's name and power limit.  Phase 8 also solves 8p's
               references: ``proc_spec``'s runs and the parity cases' x.
8p. procgrid -- the tile grid one process a tile (``launch.mesh.
               ProcessMesh``, ``launch.procs``): the kernel library built,
               then 4 gloo ranks on the one card (2x2 2d and 4x1 1d meshes
               over one group) and, beside their start, 8 ranks for the
               multipod (2, 2, 2) mesh.  The 4 build laplacian_3d(100)'s
               engines and solve the Jacobi parity cases, wait for the 8,
               then run the main path with their
               launch counts zeroed just before and read just after:
               ``proc_spec``'s PROC_STEPS steps of unguarded ``pcg`` (a
               quarter of an eager round) on 2x2 dense, 2x2 halo and 1d-4 halo, one RHS
               and k = 8, each x within PROC_RTOL of phase 8's one-process
               solve, and the block-IC(0) parity solve; every rank
               launches ``ell_spmv``, ``ell_spmm``, ``cg_update``,
               ``cg_update_batched`` and ``sptrsv_solve_dot``.  Then the
               DIST_PARITY (+ DIST_PARITY_IC0) cases on every mesh: counts
               within one of the JAX package's, x within PROC_RTOL of
               phase 8's.  Every rank's x bitwise equal (digests), every
               plan eager with traces 1; each halo rank's received pull
               bytes a step equal to the comm plan's modeled halo words x
               8 exactly.  The times: µs a step (PROC_STEPS steps minus 0, one
               call each, rank 0's host clock), its staging and gloo parts
               and the bytes received by NoC call, beside phase 8's
               one-process grid and local step, the card's name and power
               limit.  Any rank's failure fails the phase.
9. lm       -- LM serving (``repro_torch.models``, ``serve.generate``,
               ``SlotServer``, ``launch.serve --arch``); no CUDA kernel of
               the port's own (attention, MoE dispatch and the scans are
               plain torch, as plain jnp in the JAX package).  9a: every
               architecture's smoke config in f32, weights from LM_SEED
               converted to the card (``convert.lm_params_*``): prefill
               logits and LM_DECODE_STEPS greedy decode steps on the card
               within LM_RTOL x max|cpu| of the port's CPU run, the tokens
               equal.  9b: ``launch.serve --arch granite-3-8b --batch 4
               --prompt-len 32 --gen 16 --slots`` in process (the
               published config, 40 layers, bf16; exit 0,
               slot_server_completed 4, peak memory); then the same
               model: weight bytes, peak memory, prefill ms (host clock,
               synced), decode ms a step (median of 15) against the
               weights' bytes bound, tokens/s, the kernels one decode step
               launches (``torch.profiler``) and their time on the card,
               decode logits against forward on the same tokens.  9d: the
               same weights decoding into an int8 KV cache: each of
               LM_INT8_STEPS decode steps' logits within LM_INT8_BOUND x
               max|ref| of forward on the same tokens.  9c: dbrx-132b's
               published config cut to LM_MOE_LAYERS layers (16 experts of
               d_ff 10752 at d_model 6144), bf16: prefill and decode times,
               the prefill's drops, decode drop-free (every assignment
               kept); then the same weights in f32 prefill on the card and
               on the CPU with the same experts and the same drops in
               every layer.
10. train   -- LM training (``models.model.loss_fn``, ``train``,
               ``ft.RestartManager``, ``launch.train``), after phases 1-9
               have released what they hold (their plans, graphs and pools:
               ``memory_reserved`` is printed first); autograd over the
               plain-torch layers, no CUDA kernel of the port's own.  10a:
               every smoke config in f32 with the same params on the card
               and the CPU (``convert``) and the same ``TokenPipeline``
               batch: loss and grad_norm within TRAIN_RTOL relative, every
               grad within TRAIN_RTOL x max|grad| of its leaf; then two
               ``build_train_step`` steps (step 0 has lr 0 under the
               warmup; step 1 is the first update) with AdamW and with
               Adafactor: losses within TRAIN_RTOL; each optimizer's
               update on identical grads (the CPU's, from the CPU's state
               copied to the card) within TRAIN_RTOL x max|p|; the params
               after step 1 TRAIN_PARAM_SHARE of the elements within it
               and every one within 2 lr (both updates normalise the
               gradient, so f32 noise in a near-zero grad moves its
               element differently); granite's
               smoke config with
               grad_accum 2 and with int8 compression by loss and
               grad_norm.  10b: ``launch.train --arch granite-3-8b
               --optimizer adafactor --batch 4 --seq 1024 --steps 3`` in
               process (the published config, 8,372,187,136 params, bf16,
               remat on): every loss finite, loss_first near ln(vocab),
               the warm step (median of steps 2-3), tokens/s, the share of
               the 989.4 TFLOP/s bf16 peak (6 N T model FLOPs a step),
               peak memory; then the same step in parts on the card (CUDA
               events: forward+backward, clip, optimizer) and under
               ``torch.profiler`` (kernels a step, their time); then
               h2o-danube-1.8b with AdamW at the same shape.  10c:
               tests/test_substrates.py's restart scenario on the card
               (granite smoke in f32: a failure at step 9, a checkpoint
               every 4 steps, a second run: resumed_from 8, step 12, the
               params bit for bit an uninterrupted run's) and a NaN loss
               reported once at step 6: one rollback in
               ``repro_ft_rollbacks_total``, the loop on to step 11.  10d:
               granite-3-8b's published width cut to 4 layers, bf16, 4 x
               1024: the grads with remat bit for bit those without, and
               the peak memory of each.
11. roofline -- after phase 10, in a frame of its own; the card's name,
               power limit and ``total_memory`` on its first line.  11a:
               ``roofline.analyze`` rows (the H100's figures: 989.4
               TFLOP/s bf16, 3.35 TB/s, 80 GB) of the LM cells 9b and 10b
               measure: granite-3-8b decode at batch 4 over 9b's 48-slot
               cache and prefill 4 x 32, granite-3-8b training 4 x 1024
               (Adafactor, remat) and h2o-danube-1.8b training 4 x 1024
               (AdamW): analytic FLOPs, bytes, each term, the bound, the
               measured time, the share of the bf16 peak (model FLOPs over
               time x peak) and the roofline fraction; the training floor
               (6 N T at the peak) must be 208.0 ms and the decode bound
               5.00 ms, within 1%.  11b: ``launch.dryrun`` of both
               training cells on the card's 1 x 1 mesh (the meta device):
               argument bytes of params, optimizer state and step equal to
               what phase 10's state holds on the card; counted over
               analytic FLOPs inside [0.85, 1.00]; the peak estimate
               (arguments plus the step's peak of live bytes) within 3% of
               10b's ``max_memory_allocated``.  11c: ``kernels.autotune``
               (CUDA events, 20 calls after a warm one; the cache in a
               temporary directory) on ``ell_spmv`` and ``ell_spmm``
               (k = 8) at 1,048,576 x W, W = 12 and 16 ("rows" against
               "group"), and on ``bcsr_spmm`` over lap2d_1024's 4 x 4 and
               16 x 16 blocks at R = 1 and 8 ("smem" against "first"):
               each candidate's µs, the winner, the bytes bound; every
               candidate must run, ``lookup`` return the winner and
               ``ell_spmv.pick_variant`` (the rows-or-group wrappers'
               rule, which consults the cache) pick it.  Then the launch
               floors: one CUDA graph of LEVEL_PROBE one-element adds
               (``sptrsv_level_step``'s 2,047 levels) replayed, its time
               over the nodes: a graph node's own cost; and one graph of
               LEVEL_PROBE no-work kernels chained by programmatic
               dependent launch, the node floor under the level step's
               new design.
12. meshtrain -- the LM train state on a process grid: 4 gloo ranks on
               the card (``launch.procs``) as a 2x2 (data, model)
               ``ProcessMesh``, each running ``launch.train.
               train_on_mesh`` (the state placed by ``state_specs`` and
               ``sharding.named``, cut to the rank's slices, trained with
               ``grad_shardings``: the split step, each rank running its
               own heads, d_ff columns, experts, vocab rows, SSD heads and
               RG-LRU width where they divide,
               ``models.shard.split_kinds``); no CUDA kernel of the port's
               own.  The one-process counterparts run first, on the card.
               12a: the f32 smoke configs of granite-3-8b and dbrx-132b
               (experts a rank) with AdamW and Adafactor,
               deepseek-v3-671b (MLA, a shared expert, MTP) with
               Adafactor, paligemma-3b (kv = 1 whole on every rank, tied
               tables), recurrentgemma-9b (split RG-LRU layers and MLPs
               beside split attention) and mamba2-370m (split SSD heads)
               with AdamW, MESH_PARITY_STEPS steps of MESH_PARITY_SHAPE
               from the same seed-0 state:
               losses and grad_norm within MESH_RTOL of the one-process
               step, the params gathered after within MESH_PARAM_TOL x
               max|p|, every rank's metrics and gathered params bitwise
               equal and each rank's slices bitwise the gathered state's,
               each rank's held bytes equal to ``sharding.device_bytes``,
               the bytes a rank receives each step equal to
               ``roofline.collect.train_step_bytes`` exactly.  12b:
               granite-3-8b's published width cut to MESH_FULL_LAYERS
               layers, bf16, Adafactor, MESH_FULL_SHAPE: the losses within
               MESH_FULL_LOSS_RTOL of the one-process step's and bitwise
               equal across ranks, held bytes and wire bytes as in 12a,
               each rank's ``max_memory_allocated`` while it builds its
               state at most its ``device_bytes`` plus two of the largest
               whole f32 draw (no rank holds the whole state); ms a step
               (median of steps 2-3) with its staging and gloo parts
               (``mesh.stats``), the wire bytes by call against
               ``train_step_bytes``, each rank's forward+backward time by
               CUDA events, each rank's ``max_memory_allocated`` over the
               steps against its ``device_bytes``, beside the card's name
               and power limit.  12c: the same checks and numbers for
               MESH_FULL's two other cells, the mamba2 and RG-LRU splits
               at full width: mamba2-370m's published width cut to 16 of
               48 layers (32 SSD heads) with AdamW, and recurrentgemma-9b's
               published width cut to one (rec, rec, attn) unit with
               Adafactor, with the step's ``split_kinds`` table.  12a's
               last five cases run the step's options (the dry run's
               ``--variant``): granite-3-8b AdamW ``sp``, dbrx-132b
               Adafactor ``ep``, deepseek-v3-671b Adafactor ``sp,ep``,
               mamba2-370m AdamW ``sp``, recurrentgemma-9b AdamW ``sp``,
               each held to the same one-process step as its arch and
               optimizer, with the same checks.  12d: 12b's granite cell
               with ``sp``, and dbrx-132b's published width cut to one
               layer, bf16, Adafactor, with ``ep`` (its 16 expert banks
               over the grid, four a rank, never gathered): the checks and
               numbers of 12b, dbrx's wire bytes at most MESH_EP_MAX_BYTES
               a rank a step, each beside ``collect``'s bytes of the same
               cell without its variant.
13. procft  -- fault tolerance on a process grid: 4 gloo ranks on the card
               (``launch.procs``, one spawn, PROC_DEADLINE_S), while the
               parent runs the one-process grid's references on the card
               (``TileMesh``) and then lets the ranks time 13b.  13a: the
               PROC_FT scenarios (tests/test_torch_dist_serve.py's
               FT_SCENARIOS on the 1d 4x1 grid; nan and bitflip at 25 on
               the 2d 2x2 grid of laplacian_2d(32)) and PROC_FT_CKPT (a
               checkpointed solve that gives up, then a fresh manager
               that resumes from its directory) through
               ``ft.SolveRestartManager`` on every rank: each report equal
               to the one-process grid's and to the JAX package's
               (constants), x within PROC_RTOL of the one-process grid's,
               the ranks' reports and x bitwise equal; each rank's launch
               counts (zeroed just before, read just after) printed, with
               ``ell_spmv`` and ``cg_update`` above 0 on every rank.  13b:
               laplacian_3d(PROC_GRID) on the 2x2 halo grid, f64 Jacobi
               pcg_tol 1e-8 in chunks of FT_CHUNK, a halo_perturb at FT_AT
               (seed 1), checkpointed: converged, with the one-process 2x2
               grid's report; the wall beside the uninterrupted grid
               solve's, a chunk's plan call, audit and checkpoint save
               (rank 0's host clock) and the bytes a rank receives in a
               chunk (``mesh.stats``).  13c: granite-3-8b at its published
               width cut to PROC_FT_TRAIN_LAYERS layers, bf16, Adafactor,
               MESH_FULL_SHAPE: ``train_on_mesh(ckpt_dir=,
               save_every=1)`` for PROC_FT_TRAIN_STEPS steps with a
               failure injected at step 1, then a fresh placed state that
               the manager resumes from step 1, then an uninterrupted run:
               the resumed step's loss and the final state (every tensor
               each rank holds) bitwise the uninterrupted run's; leaves of
               each kind read back from the last checkpoint bitwise what
               was saved; the checkpoint's bytes the whole state's; rank
               0 alone holding host copies; save ms (gathers and write),
               restore ms, rank 0's host bytes and each rank's peak RSS
               (VmHWM) and card peak.  Then the f32 smoke config (AdamW,
               PROC_FT_SMOKE_STEPS steps, a NaN forced at PROC_FT_NAN_AT,
               a checkpoint every PROC_FT_SAVE_EVERY steps) under the
               manager on the placed state: counts equal to the
               one-process manager's on the card, losses within
               MESH_RTOL, ranks equal.
14. procserve -- the solve service on a process grid, on the ranks of
               phase 13's spawn after 13c (its checks fail "procserve").
               14a: SERVICE_PARITY's PROC_SERVE script on the 2x2 halo
               ``ProcessMesh``: per request the iterations and status of
               the one-process grid's service on the card and of the JAX
               package's 2x2-mesh service (SERVICE_PARITY), x within
               PROC_SERVE_RTOL x max|x| of the one-process grid's, the
               ranks bitwise equal; ``launch.serve PROC_SERVE_ARGV
               --processes`` under torchrun's environment in the ranks:
               rank 0's JSON the one-process grid's with ``processes``
               added.  14b: laplacian_3d(PROC_GRID) on the 2x2 halo grid
               (13b's engine), f64 Jacobi pcg_tol 1e-8, max_batch
               SERVE_BATCH, chunks of SERVE_CHUNK, PROC_SERVE_DRAIN
               requests drained: converged with the one-process grid's iterations
               (its drain runs after the ranks end), x within PROC_RTOL,
               ranks bitwise; solves/s, latency p50 and max, a chunk's
               wall on rank 0 by part (the drain's mean chunk, host
               copies timed apart, the mean chunk less those copies, the
               tick's clock collectives), the bytes a rank receives a
               tick (``mesh.stats``), each rank's
               ``max_memory_allocated`` over the drain, beside the
               one-process grid's drain.  Each part's launches a rank
               (zeroed just before, read just after: 14b's at the first
               submit and the last tick), ``ell_spmm`` and
               ``cg_update_batched`` above 0 on every rank.

15. meshserve -- LM serving on a process grid, on the ranks of phase
               12's spawn after 12d (``launch.serve.serve_on_mesh``: the
               params placed by ``param_specs``, the caches by
               ``cache_specs``, their sequence over ``model``; its checks
               fail "meshserve").  15a: the CPU tests' f32 smoke cases
               (SERVE_MESH: granite-3-8b as GQA with fsdp, nofsdp, int8kv
               and sp, deepseek-v3-671b, dbrx-132b ep, mamba2-370m,
               recurrentgemma-9b's wrapping ring) against the one-process
               generation on the card: tokens equal, each step's logits
               within SERVE_MESH_RTOL of max|logit|, the ranks' bitwise
               equal, the prefill's and each decode step's wire bytes
               ``roofline.collect.serve_step_bytes``' and held bytes
               ``device_bytes``, exactly.  15b: granite-3-8b published
               (SERVE_FULL: 40 layers, bf16, weights-stationary
               ``nofsdp``), SERVE_FULL_SHAPE, on the 2x2 grid, decoding
               the one-process run's tokens (teacher forcing), held to
               the f32 run on the same weights: the grid's largest step's
               logit error against it within SERVE_FULL_F32_FACTOR times
               the largest of the one-process bf16 runs' (the whole batch
               and its halves); the error against the one-process bf16
               run beside SERVE_FULL_RTOL (printed, not held: bf16's own
               floor lies above it), the argmax agreement, prefill ms and
               decode ms a step with
               staging, gloo and rest, bytes by call against
               ``serve_step_bytes``, held bytes against ``device_bytes``
               and each rank's peak, beside the card's name and power
               limit and the one-process run's times.

The last three lines are the kernels JSON, the card's
``nvidia-smi --query-gpu=name,power.limit`` line, and the result JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import traceback
from concurrent.futures import ThreadPoolExecutor
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
# phase 8, the tile grid.  DIST_PARITY: the JAX package's distributed
# engine (CPU, f64, 8 forced host devices; Jacobi pcg_tol, tol 1e-8,
# max_iters 2000, layout auto, b = A x with x from default_rng(0)) on
# (matrix, mesh, mode); tests/test_torch_dist_serve.py computes them anew
# and checks these constants.  DIST_MESHES: shape, axes, row_axes, col_axes.
DIST_MESHES = {
    "2x2": ((2, 2), ("data", "model"), ("data",), ("model",)),
    "4x1": ((4, 1), ("data", "model"), ("data",), ("model",)),
    "mp": ((2, 2, 2), ("pod", "data", "model"), ("pod", "data"), ("model",)),
}
DIST_PARITY = {
    ("lap2d_32", "2x2", "2d"): 94, ("lap2d_32", "4x1", "2d"): 94,
    ("lap2d_32", "4x1", "1d"): 94, ("banded_1k", "2x2", "2d"): 9,
    ("banded_1k", "4x1", "2d"): 9, ("banded_1k", "4x1", "1d"): 9,
    ("lap2d_32", "mp", "2d"): 94,
}
# phase 8p: the JAX package's block-IC(0) count on the 2x2 grid (the
# DIST_PARITY setting, precond block_ic0); tests/test_torch_procmesh.py
# checks it against JAX's
DIST_PARITY_IC0 = {("lap2d_32", "2x2", "2d"): 40}
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
# path's b): lap2d_1024 on the kernels, lap2d_128 on both substrates
MAIN_IC0_ITERS = 457
REF_IC0_GRID, REF_IC0_ITERS = 128, 96
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
PLAN_CALLS = 2                     # calls of each plan in phase 4i
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
# and 40.2 s); then from 32 and 16 (21.3 s and 29.5 s) to make room for
# phase 12 in the script's time limit
SERVE_DRAIN, SERVE_LOAD = 16, 8
JOIN_BUDGET = 200                    # lap2d_1024's bitwise join: maxiter
# phase 7, fault-tolerant solves: the service's operator, f64 Jacobi pcg_tol
# at tol 1e-8 in chunks of launch/serve.py's 25, the faults at iteration 100
# (150 with checkpoints) with seed 1
FT_CHUNK, FT_AT, FT_AT_CKPT, FT_DELAY_S = 25, 100, 150, 0.5
FT_CLI = ["--matrix", "lap2d_96", "--method", "pcg_tol", "--max-iters", "2000",
          "--inject", "nan", "--inject-at", "10", "--ft-chunk", "25"]
# FT_PARITY: the CPU tests' SolveRestartManager scenarios at lap2d_16 (tol
# 1e-8, max_iters 400, b = A x with x from default_rng(0)) and the JAX
# package's reports (CPU, f64): status, iterations, chunks, restarts and each
# fault's (label, global_iter, bad_iter).  fault None runs clean.
_NAN, _FLIP = dict(kind="nan", seed=1), dict(kind="bitflip", seed=1)
_J, _IC = dict(precond="jacobi", chunk=20), dict(precond="block_ic0", chunk=5)
_AT25, _AT12 = dict(iteration=25), dict(iteration=12)
FT_PARITY = (
    (dict(method="pcg_tol", **_J, fault=None),
     ("converged", 73, 4, 0, ())),
    (dict(method="pcg_tol", **_J, fault=dict(**_NAN, **_AT25)),
     ("converged", 73, 5, 1, (("breakdown", 20, 0),))),
    (dict(method="pcg_tol", **_J, fault=dict(**_FLIP, **_AT25)),
     ("converged", 73, 5, 1, (("breakdown", 20, 0),))),
    (dict(method="pcg_pipelined_tol", **_J, fault=dict(**_NAN, **_AT25)),
     ("converged", 73, 5, 1, (("breakdown", 20, 0),))),
    (dict(method="pcg_pipelined_tol", **_J, fault=dict(**_FLIP, **_AT25)),
     ("converged", 73, 5, 1, (("breakdown", 20, 0),))),
    (dict(method="pcg_tol", **_IC, fault=dict(**_NAN, **_AT12)),
     ("converged", 27, 7, 1, (("breakdown", 10, 0),))),
    (dict(method="pcg_tol", **_IC, fault=dict(**_FLIP, **_AT12)),
     ("converged", 27, 7, 1, (("breakdown", 10, 0),))),
    (dict(method="pcg_pipelined_tol", **_IC, fault=dict(**_NAN, **_AT12)),
     ("converged", 27, 7, 1, (("breakdown", 10, 0),))),
    (dict(method="pcg_pipelined_tol", **_IC, fault=dict(**_FLIP, **_AT12)),
     ("converged", 27, 7, 1, (("breakdown", 10, 0),))),
    # an exponent flip that stays finite: the audit's silent corruption
    (dict(method="pcg_tol", **_J, fault=dict(**_FLIP, bit=60, count=2, **_AT25)),
     ("converged", 73, 5, 1, (("silent_corruption", 20, None),))),
    (dict(method="pcg_pipelined_tol", **_J,
          fault=dict(**_FLIP, bit=60, count=2, **_AT25)),
     ("converged", 99, 5, 0, ())),
    # a low exponent flip: slower, and no fault
    (dict(method="pcg_tol", **_J,
          fault=dict(kind="bitflip", seed=2, bit=53, count=2, **_AT25)),
     ("converged", 119, 6, 0, ())),
    # stuck at NaN: max_restarts 2, then the fault's label
    (dict(method="pcg_tol", **_J, max_restarts=2,
          fault=dict(**_NAN, iteration=0, transient=False)),
     ("breakdown", 0, 3, 3, (("breakdown", 0, 0),) * 3)),
)
FT_LABELS = ("breakdown", "diverged", "stagnated", "silent_corruption",
             "nonfinite_x")

# phase 9, LM serving.  Weights from LM_SEED (torch.Generator), prompts
# from default_rng(LM_SEED) as launch/serve.py --arch draws them.
LM_SEED = 0
LM_DECODE_STEPS = 8                 # 9a: greedy decode steps on both devices
LM_PARITY_SHAPE = (2, 24)           # 9a: prompts (batch, length)
LM_RTOL = 1e-4                      # 9a: max |card - cpu| <= LM_RTOL max |cpu|
LM_FULL = "granite-3-8b"            # 9b: the published config, bf16
LM_FULL_ARGV = ["--arch", LM_FULL, "--batch", "4", "--prompt-len", "32",
                "--gen", "16", "--slots", "--seed", str(LM_SEED)]
LM_MOE = "dbrx-132b"                # 9c: the published config, LM_MOE_LAYERS
LM_MOE_LAYERS = 1                   # (2 until the 12c cells came)
LM_INT8_BOUND = 6e-2                # 9d: tests/test_models.py::test_int8_kv_cache_close
LM_INT8_STEPS = 4

# phase 10, LM training.  Weights from TRAIN_SEED (torch.Generator, as
# launch/train.py draws them), batches from TokenPipeline(seed=0).
TRAIN_SEED = 0
TRAIN_RTOL = 1e-4                   # 10a: card against CPU, f32
TRAIN_LR = 3e-3                     # 10a: warmup_cosine(TRAIN_LR, 1, 10)
# 10a: the params after the first update.  Both optimizers normalise the
# gradient (AdamW's first update is sign-like, m^/sqrt(v^) ~ sign(g);
# Adafactor divides by the factored RMS), so an element whose grad sits in
# f32 noise moves by a different amount on each device, up to 2 lr; and a
# leaf that starts at zero (the QKV biases) has max|p| ~ lr after it.  The
# optimizer's arithmetic is held on identical grads instead (TRAIN_RTOL);
# the params TRAIN_PARAM_SHARE of the elements within TRAIN_RTOL x max|p|
# of their leaf, every one within 2 lr
TRAIN_PARAM_SHARE = 0.999
TRAIN_SHAPE = (2, 32)               # 10a: (batch, seq)
TRAIN_FULL = "granite-3-8b"         # 10b: the published config, bf16
TRAIN_STEPS = 3                     # 10b: launch.train's steps and the parts'
                                    # (3, not 5: time for phase 12)
TRAIN_FULL_ARGV = ["--arch", TRAIN_FULL, "--optimizer", "adafactor",
                   "--batch", "4", "--seq", "1024", "--steps", str(TRAIN_STEPS)]
TRAIN_ADAMW = "h2o-danube-1.8b"     # 10b: the launcher's default AdamW
TRAIN_ADAMW_ARGV = ["--arch", TRAIN_ADAMW, "--batch", "4", "--seq", "1024",
                    "--steps", str(TRAIN_STEPS)]
TRAIN_REMAT_LAYERS = 4              # 10d: granite's width, 4 layers
BF16_PEAK_FLOPS = 989.4e12          # H100 SXM dense bf16 (data sheet)

# phase 11, the roofline, the dry run and the timer.  11a: the floors
# PERF.md reached by hand, reproduced by roofline.analyze to ROOF_TOL;
# 11b: the dry run on "card" (meta device) against phase 10: counted over
# analytic FLOPs inside DRY_FLOP_BAND (what the count leaves out:
# launch/dryrun.py), its peak estimate within DRY_PEAK_TOL of
# max_memory_allocated; 11c: kernels.autotune at the two cases PERF.md
# had not measured
ROOF_FLOORS_MS = {("train", TRAIN_FULL): 208.0, ("decode", LM_FULL): 5.00}
ROOF_TOL = 0.01
DRY_FLOP_BAND = (0.85, 1.00)
DRY_PEAK_TOL = 0.03
TIMER_WIDTHS = (12, 16)             # the rows kernels' W
TIMER_BLOCKS = (4, 16)              # bcsr_spmm's bm = bn, on lap2d_1024
TIMER_REPS = 20
LEVEL_PROBE = 2047                  # 11c: nodes of the launch-floor graph

# phase 12, the LM train state on a process grid: 4 gloo ranks on the card
# as a 2x2 (data, model) ProcessMesh.  12a: the f32 smoke configs against
# the one-process step on the card; loss and grad_norm rtol 1e-5 (the CPU
# tests' tolerances: only the order of f32 sums differs), the params after
# the steps within MESH_PARAM_TOL x max|p| (AdamW's early updates are
# sign-like, so a near-zero grad moves its element up to 2 lr apart: the
# 1e-4 the CPU tests hold AdamW's params to; Adafactor is smooth in g).
# 12b: granite-3-8b's published width cut to MESH_FULL_LAYERS layers, bf16,
# Adafactor; its losses within MESH_FULL_LOSS_RTOL of the one-process step
# on the card: bf16 rounds at 2^-8 = 3.9e-3, and the two runs round the
# sharded batch's products and the gradient sums differently.
# 12c: the mamba2 and RG-LRU splits at full width, as 12b: mamba2-370m's
# published width cut to 16 of 48 layers (32 SSD heads), AdamW;
# recurrentgemma-9b's published width cut to one (rec, rec, attn) unit,
# Adafactor.
MESH_GRID, MESH_AXES = (2, 2), ("data", "model")
MESH_STEPS = 2                      # 12b, 12c, 12d
MESH_PARITY_STEPS = 2               # 12a: an update and a step after it
                                    # (3 would not fit eight configs)
# (arch, optimizer, variant): the variant's tokens are the dry run's, "sp"
# (seq_parallel) and "ep" (ep_stationary), the step's options; a variant's
# case is held to the same one-process step as its arch and optimizer's
MESH_PARITY = (("granite-3-8b", "adamw", ""), ("granite-3-8b", "adafactor", ""),
               ("dbrx-132b", "adamw", ""), ("dbrx-132b", "adafactor", ""),
               ("deepseek-v3-671b", "adafactor", ""), ("paligemma-3b", "adamw", ""),
               ("recurrentgemma-9b", "adamw", ""), ("mamba2-370m", "adamw", ""),
               ("granite-3-8b", "adamw", "sp"), ("dbrx-132b", "adafactor", "ep"),
               ("deepseek-v3-671b", "adafactor", "sp,ep"),
               ("mamba2-370m", "adamw", "sp"), ("recurrentgemma-9b", "adamw", "sp"))
MESH_PARITY_SHAPE = (4, 32)
MESH_RTOL = 1e-5
MESH_PARAM_TOL = {"adamw": 1e-4, "adafactor": 1e-5}
MESH_FULL_LAYERS = 2
MESH_FULL_SHAPE = (4, 512)
MESH_FULL_LOSS_RTOL = 2e-2
# the full-width cells: label -> (arch, layers kept (None: all), optimizer,
# variant).  12d: 12b's granite cell with sp, and dbrx-132b's published
# width cut to one layer with ep (its 16 experts over the 2x2 grid, four a
# rank, never gathered), beside collect's bytes of the cell without the
# variant (dbrx's step without ep moves 6.2 GB a rank: too slow on gloo);
# MESH_EP_MAX_BYTES bounds what a rank of 12d ep receives in a step
MESH_FULL = {"12b": (TRAIN_FULL, MESH_FULL_LAYERS, "adafactor", ""),
             "12c ssm": ("mamba2-370m", 16, "adamw", ""),
             "12c rec": ("recurrentgemma-9b", 3, "adafactor", ""),
             "12d sp": (TRAIN_FULL, MESH_FULL_LAYERS, "adafactor", "sp"),
             "12d ep": ("dbrx-132b", 1, "adafactor", "ep")}
MESH_EP_MAX_BYTES = 2e9
MESH_DEADLINE_S = 600.0

# phase 15, LM serving on a process grid (in phase 12's spawn).  15a: the
# cases of tests/test_torch_meshserve.py (id -> (arch, the dry run's
# variant, max_len (None: prompt + tokens), the smoke config's changes)),
# f32, SERVE_MESH_SHAPE (batch, prompt, tokens); only the order of f32 sums
# differs from the one-process run, so 1e-4 of max|logit| as on the CPU.
# 15b: SERVE_FULL (arch, layers kept (None: all), variant) at
# SERVE_FULL_SHAPE in bf16; the grid decodes the one-process run's tokens,
# so that a near-tie cannot end the comparison.  The reference is the
# one-process run in f32 on the same (bf16-drawn) weights.  A bf16 run at
# 40 layers lies 1.6-2.1e-2 of max|logit| from it on an H100 (PERF.md),
# and the grid is a bf16 run too, with a rank's GEMM shapes and one more
# bf16 rounding a row-parallel sum (its partials, as the JAX package's
# sharded cells sum them); so its largest step's error against the f32
# run is held to SERVE_FULL_F32_FACTOR times the largest of the
# one-process bf16 runs' (the whole batch and its two halves, each its
# own GEMM shapes), measured beside it: on an H100 the three bf16 runs'
# largest errors were 1.95-2.09e-2 (the grid's 2.04e-2), a spread of
# 1.07, and a step's two one-process errors 0.85-1.08 of each other
# (PERF.md), so 1.25 passes any of them and no grid 25% worse.
# SERVE_FULL_RTOL, against the bf16 run, is printed: bf16's own floor
# lies above it.
# A 15b rank holds half of the published 16.7 GB of weights (nofsdp: split
# over model alone); SERVE_FULL_MARGIN is what a rank and the parent need
# beside the weights (their CUDA contexts, the caches, the activations).
SERVE_MESH = {
    "granite_fsdp": ("granite-3-8b", "", None, {"n_kv_heads": 2}),
    "granite_nofsdp": ("granite-3-8b", "nofsdp", None, {"n_kv_heads": 2}),
    "granite_int8kv": ("granite-3-8b", "int8kv", None, {"n_kv_heads": 2}),
    "granite_sp": ("granite-3-8b", "sp", None, {"n_kv_heads": 2}),
    "deepseek": ("deepseek-v3-671b", "", None, {}),
    "dbrx_ep": ("dbrx-132b", "ep", None, {}),
    "mamba2": ("mamba2-370m", "", None, {}),
    "recurrentgemma_wrap": ("recurrentgemma-9b", "", 20, {}),
}
SERVE_MESH_SHAPE = (4, 16, 8)
SERVE_MESH_RTOL = 1e-4
SERVE_FULL = ("granite-3-8b", None, "nofsdp")
SERVE_FULL_SHAPE = (4, 32, 16)
SERVE_FULL_RTOL = 2e-2
SERVE_FULL_F32_FACTOR = 1.25
SERVE_FULL_MARGIN = 4e9

# phase 13, fault tolerance on a process grid: 4 gloo ranks on the card.
# 13a, PROC_FT: (case, the JAX package's report) -- the scenarios of
# tests/test_torch_dist_serve.py's FT_SCENARIOS (laplacian_2d(16) on the 1d
# 4x1 grid, b = A x with x from default_rng(1)), then nan and bitflip at
# iteration 25, seed 1, on the 2d 2x2 grid of laplacian_2d(32) (x from
# default_rng(0), launch/solve.py's b); f64 Jacobi, tol 1e-8, max_iters 400.
# A report is ft_summary's (status, iterations, chunks, restarts, each
# fault's (label, global_iter, bad_iter)), the JAX package's on the CPU
# (8 forced host devices); tests/test_torch_procft.py computes them anew.
# PROC_FT_CKPT: a checkpointed solve on the 2x2 grid that gives up (a stuck
# NaN from iteration 50, max_restarts 1), then a fresh manager on its
# directory with no fault, which resumes (its report and resumed_from).
_L16 = dict(grid=16, mesh="4x1", mode="1d", x_seed=1, chunk=20)
_L32 = dict(grid=32, mesh="2x2", mode="2d", x_seed=0, chunk=FT_CHUNK)
PROC_FT = (
    (dict(_L16, method="pcg_tol", fault=dict(kind="halo_perturb", seed=2,
                                             count=4, iteration=15)),
     ("converged", 72, 5, 1, (("breakdown", 0, 2),))),
    (dict(_L16, method="pcg_pipelined_tol",
          fault=dict(kind="halo_perturb", seed=3, count=8, iteration=30)),
     ("converged", 72, 5, 1, (("breakdown", 20, 1),))),
    (dict(_L16, method="pcg_tol", fault=None),
     ("converged", 72, 4, 0, ())),
    (dict(_L32, method="pcg_tol", fault=dict(kind="nan", seed=1, iteration=25)),
     ("converged", 165, 8, 1, (("breakdown", 25, 0),))),
    (dict(_L32, method="pcg_tol", fault=dict(kind="bitflip", seed=1,
                                             iteration=25)),
     ("converged", 165, 8, 1, (("breakdown", 25, 0),))),
)
PROC_FT_CKPT = (
    dict(_L32, method="pcg_tol", max_restarts=1,
         fault=dict(kind="nan", seed=1, iteration=50, transient=False)),
    ("breakdown", 50, 4, 2, (("breakdown", 50, 0),) * 2),
    (("converged", 115, 5, 0, ()), 50),
)
PROC_FT_TOL, PROC_FT_BUDGET = 1e-8, 400
# 13b: laplacian_3d(PROC_GRID) on the 2x2 halo grid, f64 Jacobi pcg_tol 1e-8
# in chunks of FT_CHUNK, a halo_perturb at FT_AT, seed 1, checkpointed (the
# service's operator, laplacian_3d(SERVE_GRID) = 8p's cell, until the 12c
# cells came: PERF.md section 4); 13c: granite-3-8b at its
# published width cut to PROC_FT_TRAIN_LAYERS layers (12b's 2 until the 12c
# cells came), bf16, Adafactor,
# MESH_FULL_SHAPE, a checkpoint every step: PROC_FT_TRAIN_STEPS steps with
# a failure injected at step 1, then a fresh placed state resumed from it;
# PROC_FT_SMOKE: the f32 smoke config, AdamW, a NaN forced at step
# PROC_FT_NAN_AT, a checkpoint every PROC_FT_SAVE_EVERY steps
PROC_GRID = 48                      # 13b and 14b: n = 110,592
PROC_FT_TRAIN_STEPS, PROC_FT_TRAIN_LAYERS = 2, 1
PROC_FT_DEADLINE_S = 480.0          # phase 13 and 14's spawn (2 x 8p's)
PROC_FT_SMOKE_STEPS, PROC_FT_NAN_AT, PROC_FT_SAVE_EVERY = 6, 3, 2
PROC_FT_SMOKE_SHAPE = (4, 32)
# phase 14, the solve service on a process grid (in phase 13's spawn).  14a:
# SERVICE_PARITY's PROC_SERVE script on the 2x2 grid (halo) against the
# one-process grid's service on the card and the JAX package's 2x2-mesh
# service (SERVICE_PARITY's counts; tests/test_torch_procserve.py computes
# them anew), x within PROC_SERVE_RTOL x max|x|; launch.serve
# PROC_SERVE_ARGV once with --processes.  14b: laplacian_3d(PROC_GRID) on
# the 2x2 halo grid (13b's engine), Jacobi pcg_tol MAIN_TOL, max_batch
# SERVE_BATCH, chunks of SERVE_CHUNK, PROC_SERVE_DRAIN requests drained (one
# batch at k_pad 4; 8 until the 12c cells came, see PERF.md section 4)
PROC_SERVE = "lap2d_32"
PROC_SERVE_RTOL = 1e-12
PROC_SERVE_ARGV = ["--solver", "--matrix", PROC_SERVE, "--mesh-shape", "2x2"]
PROC_SERVE_DRAIN = 4
PROC_SERVE_TIMES = ("wall_s", "solves_per_s")    # the CLI JSON's wall times
PROC_SERVE_KERNELS = ("ell_spmv", "ell_spmm", "cg_update", "cg_update_batched")


def ft_scenario(engines: dict, case: dict, b):
    """Run one FT_PARITY scenario with either package (``engines`` maps a
    precond to its lap2d_16 engine; ``ft``/``SolveSpec`` from its
    package); the FTSolveReport."""
    eng, ft, spec_cls = engines[case["precond"]]
    mgr = ft.SolveRestartManager(
        eng, spec_cls(method=case["method"], tol=1e-8, max_iters=400),
        chunk=case["chunk"], max_restarts=case.get("max_restarts", 3))
    inj = (None if case["fault"] is None
           else ft.FaultInjector(eng, ft.FaultSpec(**case["fault"])))
    return mgr.solve(b, injector=inj)


def ft_summary(rep) -> tuple:
    """The FT_PARITY fields of a report."""
    return (rep.status, rep.iterations, rep.chunks, rep.restarts,
            tuple((f["label"], f["global_iter"], f["bad_iter"])
                  for f in rep.faults))


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


def ft_phase(failed: list) -> None:
    """Phase 7: fault-tolerant solves on the card (module docstring).
    Each sub-phase that fails adds its name to ``failed``."""
    import os
    import tempfile

    import numpy as np
    import scipy.sparse as sp
    import torch

    from repro_torch import ft
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.engine import AzulEngine
    from repro_torch.core.plan import SolveSpec
    from repro_torch.data.matrices import laplacian_2d, laplacian_3d
    from repro_torch.kernels import ops
    from repro_torch.obs.clock import now

    t_phase = now()
    m = laplacian_3d(SERVE_GRID)
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    n = m.shape[0]
    x_true = np.random.default_rng(0).standard_normal(n)
    b = a @ x_true
    bnorm = float(np.linalg.norm(b))
    t0 = now()
    eng = AzulEngine(m, dtype=np.float64)
    say(f"ft engine laplacian_3d({SERVE_GRID}) (n={n}, ELL "
        f"{tuple(eng.ell.vals.shape)}): {now() - t0:.2f} s")
    spec = SolveSpec(method="pcg_tol", tol=MAIN_TOL, max_iters=SERVE_BUDGET)
    slack = ft.SolveRestartManager.TRUE_RESIDUAL_SLACK * MAIN_TOL
    chunk_kw = dict(method="pcg_tol", tol=MAIN_TOL, max_iters=FT_CHUNK)
    times: dict = {}

    def true_rel(x) -> float:
        return float(np.linalg.norm(b - a @ x) / bnorm)

    def manager(**kw):
        return ft.SolveRestartManager(eng, spec, chunk=FT_CHUNK, **kw)

    def injector(kind, at=FT_AT, **kw):
        return ft.FaultInjector(eng, ft.FaultSpec(kind=kind, iteration=at,
                                                  seed=1, **kw))

    def summary(rep) -> dict:
        return {"status": rep.status, "iterations": rep.iterations,
                "chunks": rep.chunks, "restarts": rep.restarts,
                "faults": rep.faults, "resumed_from": rep.resumed_from,
                "straggler_chunks": rep.straggler_chunks,
                "rel_residual": rep.rel_residual}

    def med_wall(fn, reps=3) -> float:
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = now()
            fn()
            torch.cuda.synchronize()
            walls.append(now() - t0)
        return float(np.median(walls))

    # -- 7a. the injectable plan's contract ----------------------------------
    plan = None
    try:
        plain = eng.plan(SolveSpec(**chunk_kw))
        plan = eng.plan(SolveSpec(injectable=True, **chunk_kw))
        bad = injector("nan").vals_for(FT_AT, FT_AT + FT_CHUNK)
        xs = np.random.default_rng(1).standard_normal(n)
        y0, vals0, ptr = eng.spmv(xs), eng.ell.vals.clone(), plan.vals.data_ptr()
        plain(b)
        ops.reset_launch_counts()
        x_ref, n_ref = plain(b)
        want = ops.launch_counts()
        t0 = now()
        plan(b)                                    # builds: captures once
        build_s = now() - t0
        ops.reset_launch_counts()
        x1, n1 = plan(b)
        got = ops.launch_counts()
        plan(b, vals=bad)
        st_bad, bad_it = plan.last_status_names, int(plan.last_bad_iter)
        x2, n2 = plan(b)
        xw_ref, nw_ref = plain(b, x0=x_ref)
        xw, nw = plan(b, x0=x_ref)
        checks = {
            "clean == plain (x, trace)": x1.tobytes() == x_ref.tobytes()
            and n1.tobytes() == n_ref.tobytes(),
            "launches == plain": got == want,
            "corrupted: breakdown at 0": (st_bad, bad_it) == ("breakdown", 0),
            "clean after corrupt == plain": x2.tobytes() == x_ref.tobytes()
            and n2.tobytes() == n_ref.tobytes(),
            "warm start == plain": xw.tobytes() == xw_ref.tobytes()
            and nw.tobytes() == nw_ref.tobytes(),
            "engine.spmv unchanged": eng.spmv(xs).tobytes() == y0.tobytes(),
            "engine values unchanged": bool(torch.equal(eng.ell.vals, vals0)),
            "one buffer, 16-byte aligned, not the engine's":
                plan.vals.data_ptr() == ptr and ptr % 16 == 0
                and ptr != eng.ell.vals.data_ptr(),
            "traces 1, captures 1": (plan.traces, plan.cell.captures) == (1, 1),
        }
        say(f"ft 7a injectable chunk plan ({FT_CHUNK} steps; first call "
            f"{build_s:.3f} s, capture {plan.cell.capture_s} s): "
            f"launches a call {json.dumps(got)} (plain {json.dumps(want)}); "
            + json.dumps(checks))
        if not all(checks.values()):
            raise AssertionError(f"injectable plan contract: {checks}")
        # where a chunk's time goes
        bd, xd = eng.to_device_vec(b), eng.to_device_vec(x_ref)
        times["chunk_clean_ms"] = 1e3 * med_wall(lambda: plan(b, x0=x_ref))
        times["plan_on_card_ms"] = _median_ms(lambda: plan.fn(bd, xd), 1, 3)
        times["plan_on_card_steps"] = int(plan.fn(bd, xd).iters)
        # a corrupted chunk breaks down before its loop: no steps
        times["chunk_corrupted_ms"] = 1e3 * med_wall(
            lambda: plan(b, x0=x_ref, vals=bad))
        times["copy_in_host_ms"] = 1e3 * med_wall(lambda: plan._load_vals(bad))

        def d2d():
            plan._vals_clean = False
            plan._load_vals(None)

        times["copy_in_d2d_ms"] = _median_ms(d2d, 1, 3)
        times["vectors_in_out_ms"] = 1e3 * med_wall(
            lambda: (eng.to_device_vec(b),
                     eng.from_device_vec(eng.to_device_vec(x_ref))))
        mgr = manager()
        times["audit_ms"] = 1e3 * med_wall(lambda: mgr._true_rel(x_ref, b, bnorm))
        plan(b)                                    # leave the buffer clean
    except Exception:
        traceback.print_exc()
        failed.append("ft injectable plan")

    # -- 7b. transient faults recover ----------------------------------------
    try:
        plain = eng.plan(spec)
        plain(b)
        t0 = now()
        xu, _ = plain(b)
        times["uninterrupted_s"] = now() - t0
        times["uninterrupted_iters"] = int(plain.last_iters)
        times["uninterrupted_status"] = plain.last_status_names
        t0 = now()
        rep = manager().solve(b)
        times["ft_clean_s"] = now() - t0
        times["ft_clean_iters"] = rep.iterations
        times["ft_clean_chunks"] = rep.chunks
        say("ft 7b clean chunked solve: " + json.dumps(summary(rep)))
        if rep.status != "converged" or rep.restarts or true_rel(rep.x) > slack:
            raise AssertionError(f"clean chunked solve: {summary(rep)}")
        for kind in ("nan", "bitflip"):
            inj = injector(kind)
            ops.reset_launch_counts()
            t0 = now()
            rep = manager(timer=ft.StepTimer()).solve(b, injector=inj)
            wall = now() - t0
            counts = ops.launch_counts()
            times[f"ft_{kind}_s"] = wall
            say(f"ft 7b {kind} at {FT_AT} ({wall:.3f} s, fired {inj.fired}, "
                f"true rel residual {true_rel(rep.x):.4g}, launches "
                f"{json.dumps(counts)}): " + json.dumps(summary(rep)))
            steps = counts.get("ell_spmv_pfold_dot", 0)
            # ell_spmv once a chunk (its initial residual), the step
            # kernels once a loop step: the good chunks' iterations, and
            # at most a chunk's for each faulted one
            ok = (inj.fired >= 1 and rep.restarts >= 1
                  and rep.faults[0]["global_iter"] == FT_AT // FT_CHUNK * FT_CHUNK
                  and rep.faults[0]["label"] in FT_LABELS
                  and rep.status == "converged" and rep.rel_residual <= slack
                  and true_rel(rep.x) <= slack
                  and counts.get("ell_spmv", 0) == rep.chunks
                  and rep.iterations <= steps
                  <= rep.iterations + FT_CHUNK * rep.restarts
                  and counts.get("cg_update", 0) == steps
                  and not any(v for k, v in counts.items() if k not in (
                      "ell_spmv", "ell_spmv_pfold_dot", "cg_update")))
            if not ok:
                raise AssertionError(f"{kind} fault: {summary(rep)} {counts}")
    except Exception:
        traceback.print_exc()
        failed.append("ft transient faults")

    # -- 7c. a persistent fault gives up --------------------------------------
    try:
        rep = manager().solve(b, injector=injector("nan", transient=False))
        say("ft 7c persistent nan: " + json.dumps(summary(rep)))
        if (rep.restarts != 3 + 1 or rep.status not in FT_LABELS
                or len(rep.faults) != 4):
            raise AssertionError(f"persistent fault: {summary(rep)}")
    except Exception:
        traceback.print_exc()
        failed.append("ft persistent fault")

    # -- 7d. checkpoints survive ----------------------------------------------
    try:
        with tempfile.TemporaryDirectory() as d:
            ckdir = os.path.join(d, "solve")
            t0 = now()
            rep = manager(checkpoint_dir=ckdir).solve(
                b, injector=injector("nan", at=FT_AT_CKPT))
            times["ft_checkpointed_s"] = now() - t0
            rep2 = manager(checkpoint_dir=ckdir).solve(b)
            say(f"ft 7d checkpointed, nan at {FT_AT_CKPT}: "
                + json.dumps(summary(rep)) + "; a fresh manager: "
                + json.dumps(summary(rep2)))
            if (rep.status != "converged" or rep.restarts < 1
                    or true_rel(rep.x) > slack or rep2.status != "converged"
                    or not rep2.resumed_from or true_rel(rep2.x) > slack):
                raise AssertionError(f"checkpoints: {summary(rep)} "
                                     f"{summary(rep2)}")
            cm = CheckpointManager(os.path.join(d, "timed"))
            snap, total = [], []
            for k in range(3):
                t0 = now()
                cm.save_async({"x": rep.x, "r": b - eng.spmv(rep.x),
                               "k": np.int64(k)}, k)
                snap.append(now() - t0)
                cm.wait()
                total.append(now() - t0)
            times["checkpoint_save_call_ms"] = 1e3 * float(np.median(snap))
            times["checkpoint_save_ms"] = 1e3 * float(np.median(total))
    except Exception:
        traceback.print_exc()
        failed.append("ft checkpoints")

    # -- 7e. a delay is flagged ------------------------------------------------
    try:
        inj = injector("delay", delay_s=FT_DELAY_S)
        rep = manager(timer=ft.StepTimer()).solve(b, injector=inj)
        say(f"ft 7e delay {FT_DELAY_S} s at {FT_AT}: " + json.dumps(summary(rep)))
        if (not rep.straggler_chunks or rep.restarts or inj.fired != 1
                or rep.status != "converged"):
            raise AssertionError(f"delay: {summary(rep)}")
    except Exception:
        traceback.print_exc()
        failed.append("ft delay")

    # -- 7f. the CLI -------------------------------------------------------------
    try:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = now()
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.solve",
                            *FT_CLI], env=env, capture_output=True, text=True,
                           timeout=600, cwd=ROOT)
        say(f"ft 7f launch.solve {' '.join(FT_CLI)} ({now() - t0:.1f} s): exit "
            f"{r.returncode} " + r.stdout.replace("\n", " "))
        out = json.loads(r.stdout) if r.returncode == 0 else {}
        if (r.returncode != 0 or out["status"] != "converged"
                or out["restarts"] < 1 or out["device"] != "cuda"):
            raise AssertionError(f"launch.solve --inject: {r.stderr[-3000:]}")
    except Exception:
        traceback.print_exc()
        failed.append("ft CLI")

    # -- 7g. parity with the JAX package's reports at lap2d_16 ----------------
    try:
        m16 = laplacian_2d(16)
        a16 = sp.csr_matrix((m16.data, m16.indices, m16.indptr), shape=m16.shape)
        b16 = a16 @ np.random.default_rng(0).standard_normal(m16.shape[0])
        engines = {pre: (AzulEngine(m16, precond=pre, dtype=np.float64,
                                    format="ell"), ft, SolveSpec)
                   for pre in ("jacobi", "block_ic0")}
        bad_cases = []
        for case, want in FT_PARITY:
            got = ft_summary(ft_scenario(engines, case, b16))
            ok = (got[0] == want[0] and got[3] == want[3]
                  and abs(got[1] - want[1]) <= 1 and abs(got[2] - want[2]) <= 1
                  and [f[0] for f in got[4]] == [f[0] for f in want[4]])
            if not ok:
                bad_cases.append((case, got, want))
        say(f"ft 7g parity: {len(FT_PARITY) - len(bad_cases)} of "
            f"{len(FT_PARITY)} lap2d_16 scenarios as the JAX package's "
            "(status, restarts, fault labels equal; iterations, chunks +-1)")
        if bad_cases:
            raise AssertionError(f"ft parity: {bad_cases}")
    except Exception:
        traceback.print_exc()
        failed.append("ft parity")

    if plan is not None:
        say(f"ft injectable chunk plan after phase 7: traces {plan.traces}, "
            f"captures {plan.cell.captures}, replays {plan.cell.replays}")
        if plan.traces != 1 or plan.cell.captures != 1:
            failed.append("ft one capture")
    if "ft_clean_s" in times and "uninterrupted_s" in times:
        times["ft_clean_over_uninterrupted"] = (times["ft_clean_s"]
                                                / times["uninterrupted_s"])
    say(f"ft times (laplacian_3d({SERVE_GRID}), f64, chunk {FT_CHUNK}; "
        f"{smi_line()}): " + json.dumps(times))
    say(f"ft phase: {now() - t_phase:.1f} s")


GRID_MESHES = (("2x2", "2d"), ("4x1", "1d"))
GRID_IC0 = 512                      # laplacian_2d(512) block-IC(0) grid
GRID_STEPS = 100                    # loop steps of phase 8's step timing (100,
                                    # not 300: time for phase 12)
GRID_KERNELS = ("ell_spmv", "ell_spmm", "cg_update", "cg_update_batched",
                "sptrsv_solve_dot")


def noc_words(eng, layout: str) -> int:
    """Words the NoC stages of one grid matvec write on the card (the
    index gathers, the halo concatenation, the reduce-scatter's gather
    and adds), for one RHS; the dense 2d one includes the mesh
    transpose."""
    n_pad, tiles, h = eng.n_pad, eng.tiles, eng.comm_plan.halo_width
    words = 0
    if eng.mode == "2d" and eng.pr > 1 and eng.pc > 1:
        words += n_pad                                    # mesh transpose
    if layout == "halo":
        words += h * n_pad + (1 + h) * n_pad              # pulls, the cat
    else:
        words += tiles * eng._buffer_len("dense")         # all-gather
    if eng.mode == "2d":
        words += eng.pc * n_pad + (eng.pc - 1) * n_pad    # scatter, adds
    return words


def grid_phase(failed: list) -> dict:
    """Phase 8: the tile grid on the card (module docstring).  Each
    sub-phase that fails adds its name to ``failed``.  Returns phase 8p's
    references: x of its full-size solves ("<mesh> <layout> k=<lanes>
    pcg", ``proc_spec``) and of the parity cases ("parity
    <matrix>|<mesh>|<mode>|<precond>") on the one-process grid, and 8h's
    times ("times")."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from repro_torch.core.engine import AzulEngine, _block_apply
    from repro_torch.core.plan import SolveSpec
    from repro_torch.data.matrices import laplacian_2d, laplacian_3d, suite
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs.clock import now

    t_phase = now()
    m = laplacian_3d(SERVE_GRID)
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    n = m.shape[0]
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(n)
    b = a @ x_true
    B = a @ rng.standard_normal((MAIN_BATCH, n)).T
    B = np.ascontiguousarray(B.T)
    bnorm = float(np.linalg.norm(b))
    spec = dict(method="pcg_tol", tol=MAIN_TOL, max_iters=SERVE_BUDGET)
    meshes = {name: make_mesh(*DIST_MESHES[name][:2])
              for name, _ in GRID_MESHES}
    t0 = now()
    loc = AzulEngine(m, dtype=np.float64, format="ell")
    engs = {}
    for name, mode in GRID_MESHES:
        _, _, ra, ca = DIST_MESHES[name]
        engs[name] = AzulEngine(m, mesh=meshes[name], mode=mode, row_axes=ra,
                                col_axes=ca, dtype=np.float64)
    say(f"grid engines laplacian_3d({SERVE_GRID}) (n={n}): local and "
        + ", ".join(f"{k} {e.mode} (blocks {tuple(e.vals.shape)}, halo "
                    f"deltas {e.comm_plan.deltas}, auto layout "
                    f"{e._op_layout()})" for k, e in engs.items())
        + f": {now() - t0:.2f} s")

    # -- 8a. the kernels at the stacked-tile shapes ---------------------------
    try:
        gen = torch.Generator(device="cuda").manual_seed(8)
        errs = {}
        for name, eng in engs.items():
            for lay in ("dense", "halo"):
                cols = eng._kernel_cols(lay)
                vals = eng._flat_vals(eng.vals)
                m_buf = eng._buffer_len(lay)
                xb = torch.randn(eng.tiles * m_buf, dtype=torch.float64,
                                 device="cuda", generator=gen)
                want = ref.ell_spmv_ref(cols, vals, xb)
                errs[f"ell_spmv {name} {lay} {tuple(cols.shape)} x "
                     f"{eng.tiles}x{m_buf}"] = compare(
                    "ell_spmv", (ops.ell_spmv(cols, vals, xb),), (want,),
                    "float64")
                xk = torch.randn(MAIN_BATCH, eng.tiles * m_buf,
                                 dtype=torch.float64, device="cuda",
                                 generator=gen)
                got = ops.ell_spmm(cols, vals, xk)
                errs[f"ell_spmm {name} {lay} k={MAIN_BATCH}"] = compare(
                    "ell_spmm", (got,), (ref.ell_spmm_ref(cols, vals, xk),),
                    "float64")
                lane = ops.ell_spmv(cols, vals, xk[0].contiguous())
                if not torch.equal(lane, got[0]):
                    raise AssertionError("grid ell_spmm lane 0 != ell_spmv")
        eng = engs["2x2"]
        vs = [torch.randn(eng.n_pad, dtype=torch.float64, device="cuda",
                          generator=gen) for _ in range(4)]
        alpha = torch.tensor(0.37, dtype=torch.float64, device="cuda")
        got = ops.cg_update(alpha, *vs, eng._dinv_pad)
        want = ref.cg_update_ref(alpha, *vs, eng._dinv_pad)
        errs["cg_update grid n_pad"] = compare("cg_update", got, want,
                                               "float64")
        vk = [torch.randn(MAIN_BATCH, eng.n_pad, dtype=torch.float64,
                          device="cuda", generator=gen) for _ in range(4)]
        ak = torch.rand(MAIN_BATCH, 1, dtype=torch.float64, device="cuda",
                        generator=gen)
        got = ops.cg_update(ak, *vk, eng._dinv_pad)
        want = ref.cg_update_ref(ak, *vk, eng._dinv_pad)
        errs[f"cg_update_batched grid k={MAIN_BATCH}"] = compare(
            "cg_update_batched", got, want, "float64")
        say("grid 8a kernels at the stacked-tile shapes (max abs err, rtol "
            "1e-12): " + json.dumps(errs))
    except Exception:
        traceback.print_exc()
        failed.append("grid kernels")

    # -- 8b. spmv -------------------------------------------------------------
    try:
        y_loc = loc.spmv(x_true)
        scale = float(np.abs(y_loc).max())
        for name, eng in engs.items():
            ys = {}
            for lay in ("dense", "halo"):
                eng.layout = lay
                ys[lay] = eng.spmv(x_true)
            eng.layout = "auto"
            err = float(np.abs(ys["dense"] - y_loc).max())
            if err > 1e-12 * scale:
                raise AssertionError(f"grid {name} spmv err {err}")
            if not np.array_equal(ys["dense"], ys["halo"]):
                raise AssertionError(f"grid {name} spmv halo != dense")
            say(f"grid 8b spmv {name}: max |y - y_local| {err:.3e} "
                f"(<= 1e-12 x {scale:.3e}), halo == dense bitwise")
    except Exception:
        traceback.print_exc()
        failed.append("grid spmv")

    def true_rel(x) -> float:
        return float(np.linalg.norm(b - a @ x) / bnorm)

    def step_us(eng, rhs, lay=None) -> float:
        """Warm µs a step of unguarded ``pcg`` on ``lay`` (None: the
        engine's): the median wall of GRID_STEPS steps minus the median
        wall of 0 steps (the copies in and out), three calls each."""
        k = None if rhs.ndim == 1 else rhs.shape[0]
        kw = dict(method="pcg", batch=k, guard=False, layout=lay)
        run = eng.plan(SolveSpec(iters=GRID_STEPS, **kw))
        zero = eng.plan(SolveSpec(iters=0, **kw))
        walls = {p: float(np.median([warm_wall(p, rhs) for _ in range(3)]))
                 for p in (run, zero)}
        return (walls[run] - walls[zero]) / GRID_STEPS * 1e6

    # -- 8c. solves, 8h times --------------------------------------------------
    times: dict = {}
    refs: dict = {"times": times}
    try:
        lplan = loc.plan(SolveSpec(**spec))
        lplan(b)
        want_it = int(lplan.last_iters)
        times["local"] = step_us(loc, b)
        times["local pcg_tol us/iter"] = warm_wall(lplan, b) / want_it * 1e6
        times["local nodes"] = lplan.cell.step_nodes
        say(f"grid 8c local: {want_it} iterations, "
            f"{lplan.last_status_names}")
        for name, eng in engs.items():
            for lay in ("dense", "halo"):
                plan = eng.plan(SolveSpec(layout=lay, **spec))
                first = first_call(plan, b, f"grid {name} {lay}")
                plan(b)
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                x, _ = plan(b)
                launches = ops.launch_counts()
                it = int(plan.last_iters)
                rel = true_rel(x)
                hlo = plan.hlo_summary()["count_by_op"]
                say(f"grid 8c {name} {lay}: {it} iterations (local {want_it}),"
                    f" {plan.last_status_names}, true rel residual {rel:.3e},"
                    f" traces {plan.traces}, captures {plan.cell.captures}, "
                    f"launches per solve {json.dumps(launches)}, hlo "
                    f"{json.dumps(hlo)}, step nodes {first['step_nodes']}")
                if (abs(it - want_it) > 1
                        or plan.last_status_names != "converged"
                        or rel > MAIN_MAX_TRUE_RESIDUAL or plan.traces != 1):
                    raise AssertionError(f"grid {name} {lay} solve")
                if launches.get("ell_spmv", 0) < 1 or launches.get(
                        "cg_update", 0) < it:
                    raise AssertionError(f"grid {name} {lay} launches")
                if lay == "halo" and "all-gather" in hlo:
                    raise AssertionError("a halo plan gathered")
                times[f"{name} {lay}"] = step_us(eng, b, lay)
                times[f"{name} {lay} pcg_tol us/iter"] = (
                    warm_wall(plan, b) / it * 1e6)
                times[f"{name} {lay} nodes"] = first["step_nodes"]
                times[f"{name} {lay} noc words"] = noc_words(eng, lay)
    except Exception:
        traceback.print_exc()
        failed.append("grid solves")

    # -- 8d. k = 8 --------------------------------------------------------------
    try:
        lplan = loc.plan(SolveSpec(batch=MAIN_BATCH, **spec))
        lplan(B)
        want_k = np.asarray(lplan.last_iters)
        times[f"local k={MAIN_BATCH}"] = step_us(loc, B)
        eng = engs["2x2"]
        plan = eng.plan(SolveSpec(batch=MAIN_BATCH, **spec))
        first_call(plan, B, f"grid 2x2 k={MAIN_BATCH}")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        X, nk = plan(B)
        launches = ops.launch_counts()
        got_k = np.asarray(plan.last_iters)
        # lane 0 alone, a k = 1 batch, as phase 4 re-solves its lanes: its
        # count, status and residual trace up to its count bitwise lane
        # 0's (the batch steps on while any lane is active, so x moves on)
        solo = eng.plan(SolveSpec(batch=1, **spec))
        _, n1 = solo(B[:1])
        it0 = int(got_k[0])
        alone = (int(solo.last_iters[0]) == it0
                 and solo.last_status_names == plan.last_status_names[:1]
                 and np.array_equal(n1[: it0 + 1, 0], nk[: it0 + 1, 0]))
        say(f"grid 8d 2x2 k={MAIN_BATCH}: iterations {got_k.tolist()} "
            f"(local {want_k.tolist()}), statuses {plan.last_status_names}, "
            f"launches {json.dumps(launches)}, lane 0 alone (k = 1): "
            f"{int(solo.last_iters[0])} iterations, trace bitwise {alone}")
        if (np.abs(got_k - want_k).max() > 1 or plan.traces != 1
                or set(plan.last_status_names) != {"converged"}
                or not alone
                or launches.get("ell_spmm", 0) < 1
                or launches.get("cg_update_batched", 0) < 1):
            raise AssertionError("grid k = 8")
        times[f"2x2 dense k={MAIN_BATCH}"] = step_us(eng, B, "dense")
        times[f"2x2 halo k={MAIN_BATCH}"] = step_us(eng, B, "halo")
    except Exception:
        traceback.print_exc()
        failed.append("grid batched")

    # -- 8e. the overlapped pipelined plan --------------------------------------
    try:
        eng = engs["4x1"]
        out = {}
        for lay in ("halo", "dense"):
            plan = eng.plan(SolveSpec(method=PIPE_METHOD, tol=MAIN_TOL,
                                      max_iters=SERVE_BUDGET, layout=lay))
            plan(b)
            x, _ = plan(b)
            out[lay] = (x, int(plan.last_iters), plan.last_status_names,
                        plan.info["noc"]["comm_overlap"])
        ar = {meth: eng.plan(SolveSpec(method=meth, iters=60, layout="halo"))
              .hlo_summary()["count_by_op"] for meth in ("pcg_pipelined",
                                                         "pcg")}
        say(f"grid 8e {PIPE_METHOD} 1d: halo (overlap "
            f"{out['halo'][3]}) {out['halo'][1]} iterations, dense "
            f"{out['dense'][1]}, x bitwise {np.array_equal(out['halo'][0], out['dense'][0])}; "
            f"hlo pcg_pipelined {json.dumps(ar['pcg_pipelined'])}, pcg "
            f"{json.dumps(ar['pcg'])}")
        if (out["halo"][1] != out["dense"][1] or not out["halo"][3]
                or not np.array_equal(out["halo"][0], out["dense"][0])
                or out["halo"][2] != "converged"
                or ar["pcg_pipelined"].get("all-reduce") != 2
                or ar["pcg"].get("all-reduce") != 4
                or "all-gather" in ar["pcg_pipelined"]):
            raise AssertionError("grid pipelined overlap")
    except Exception:
        traceback.print_exc()
        failed.append("grid pipelined")

    # -- 8f. block-IC(0) on the 2x2 grid ----------------------------------------
    try:
        mi = laplacian_2d(GRID_IC0)
        ai = sp.csr_matrix((mi.data, mi.indices, mi.indptr), shape=mi.shape)
        bi = ai @ np.random.default_rng(1).standard_normal(mi.shape[0])
        t0 = now()
        eng = AzulEngine(mi, mesh=meshes["2x2"], precond="block_ic0",
                         dtype=np.float64)
        build_s = now() - t0
        plan = eng.plan(SolveSpec(**spec))
        plan(bi)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        x, _ = plan(bi)
        launches = ops.launch_counts()
        it = int(plan.last_iters)
        rel = float(np.linalg.norm(bi - ai @ x) / np.linalg.norm(bi))
        say(f"grid 8f block_ic0 laplacian_2d({GRID_IC0}) 2x2: engine "
            f"{build_s:.2f} s, {it} iterations, {plan.last_status_names}, "
            f"true rel residual {rel:.3e}, substrate "
            f"{plan.info['substrate']}, launches {json.dumps(launches)}")
        if (plan.last_status_names != "converged"
                or rel > MAIN_MAX_TRUE_RESIDUAL
                or launches.get("sptrsv_solve_dot", 0) < 2 * it):
            raise AssertionError("grid block_ic0")
        times["2x2 block_ic0 laplacian_2d(512)"] = step_us(eng, bi)
    except Exception:
        traceback.print_exc()
        failed.append("grid block_ic0")

    # -- 8g. DIST_PARITY ---------------------------------------------------------
    try:
        mats = suite("small")
        bad = []
        for (mat, mname, mode), want in DIST_PARITY.items():
            mm = mats[mat]
            am = sp.csr_matrix((mm.data, mm.indices, mm.indptr),
                               shape=mm.shape)
            bm = am @ np.random.default_rng(0).standard_normal(mm.shape[0])
            shape, axes, ra, ca = DIST_MESHES[mname]
            eng = AzulEngine(mm, mesh=make_mesh(shape, axes), mode=mode,
                             row_axes=ra, col_axes=ca, dtype=np.float64)
            plan = eng.plan(SolveSpec(method="pcg_tol", tol=1e-8,
                                      max_iters=2000))
            refs[f"parity {mat}|{mname}|{mode}|jacobi"] = plan(bm)[0]
            got = int(plan.last_iters)
            if abs(got - want) > 1 or plan.last_status_names != "converged":
                bad.append((mat, mname, mode, got))
        for key, want in DIST_PARITY_IC0.items():
            shape, axes, ra, ca = DIST_MESHES[key[1]]
            x, plan = parity_solve(make_mesh(shape, axes), key, "block_ic0",
                                   ra, ca)
            refs["parity " + "|".join(key + ("block_ic0",))] = x
            if (abs(int(plan.last_iters) - want) > 1
                    or plan.last_status_names != "converged"):
                bad.append(key + (int(plan.last_iters),))
        say(f"grid 8g DIST_PARITY (+ DIST_PARITY_IC0): "
            f"{len(DIST_PARITY) + len(DIST_PARITY_IC0) - len(bad)} of "
            f"{len(DIST_PARITY) + len(DIST_PARITY_IC0)} within one of the "
            "JAX package's counts")
        if bad:
            raise AssertionError(f"DIST_PARITY {bad}")
    except Exception:
        traceback.print_exc()
        failed.append("grid parity")

    # -- phase 8p's references: its full-size solves on the one-process grid --
    try:
        for name, lay in PROC_CASES:
            for rhs, lanes in ((b, 1), (B, MAIN_BATCH)):
                plan = engs[name].plan(SolveSpec(**proc_spec(lay, lanes)))
                refs[f"{name} {lay} k={lanes} pcg"] = plan(rhs)[0]
    except Exception:
        traceback.print_exc()
        failed.append("grid 8p references")

    # -- 8h. NoC stage times -------------------------------------------------------
    try:
        for name, eng in engs.items():
            for lay in ("dense", "halo"):
                gather, scatter = eng._comm(lay)
                xv = torch.randn(eng.n_pad, dtype=torch.float64,
                                 device="cuda")
                yp = torch.randn(eng.tiles * eng.br, dtype=torch.float64,
                                 device="cuda")
                cols = eng._kernel_cols(lay)
                vals = eng._flat_vals(eng.vals)
                xb = gather(xv)
                times[f"{name} {lay} gather us"] = 1e3 * device_ms(
                    lambda: gather(xv))
                times[f"{name} {lay} block apply us"] = 1e3 * device_ms(
                    lambda: _block_apply(cols, vals, xb))
                if eng.mode == "2d":            # 1d: no scatter stage
                    times[f"{name} {lay} scatter us"] = 1e3 * device_ms(
                        lambda: scatter(yp))
        say(f"grid 8h microseconds a loop step (unguarded pcg, warm) and "
            f"per NoC stage on {smi_line()}: " + json.dumps(times))
    except Exception:
        traceback.print_exc()
        failed.append("grid times")
    say(f"grid phase: {now() - t_phase:.1f} s")
    return refs



PROC_CASES = (("2x2", "dense"), ("2x2", "halo"), ("4x1", "halo"))
PROC_MODES = {"2x2": "2d", "4x1": "1d"}
PROC_STEPS = 8                      # 8p's full-size solves: a quarter round of pcg
PROC_DEADLINE_S = 240.0             # the parent's deadline for a spawn
PROC_RTOL = 1e-10                   # x against the one-process grid's, f64
PROC_KERNELS = ("ell_spmv", "ell_spmm", "cg_update", "cg_update_batched",
                "sptrsv_solve_dot")


def _digest(x) -> str:
    import hashlib

    return hashlib.sha1(x.tobytes()).hexdigest()


def proc_spec(lay: str, lanes: int) -> dict:
    """8p's full-size solve (and phase 8's reference of it): PROC_STEPS
    steps of unguarded ``pcg`` on layout ``lay``, one RHS or a batch."""
    return dict(method="pcg", iters=PROC_STEPS, guard=False, layout=lay,
                batch=None if lanes == 1 else lanes)


def parity_cases(mname: str) -> list:
    """((matrix, mesh, mode), precond, the JAX package's count) of
    DIST_PARITY and DIST_PARITY_IC0 on mesh ``mname``."""
    return ([(k, "jacobi", v) for k, v in DIST_PARITY.items()
             if k[1] == mname]
            + [(k, "block_ic0", v) for k, v in DIST_PARITY_IC0.items()
               if k[1] == mname])


def parity_solve(mesh, key, pc: str, ra, ca) -> tuple:
    """One parity case on ``mesh``: (x, plan), f64 pcg_tol 1e-8."""
    import numpy as np
    import scipy.sparse as sp

    from repro_torch.core.engine import AzulEngine
    from repro_torch.core.plan import SolveSpec
    from repro_torch.data.matrices import suite

    mat, _, mode = key
    mm = suite("small")[mat]
    am = sp.csr_matrix((mm.data, mm.indices, mm.indptr), shape=mm.shape)
    bm = am @ np.random.default_rng(0).standard_normal(mm.shape[0])
    eng = AzulEngine(mm, mesh=mesh, mode=mode, row_axes=ra, col_axes=ca,
                     precond=pc, dtype=np.float64)
    plan = eng.plan(SolveSpec(method="pcg_tol", tol=1e-8, max_iters=2000))
    x, _ = plan(bm)
    return x, plan


def _proc_parity(rank, mname: str, only=None) -> dict:
    """The parity cases of mesh ``mname`` (preconditioner ``only``, or
    all) on a rank: {"matrix|mesh|mode|precond": result}."""
    shape, axes, ra, ca = DIST_MESHES[mname]
    mesh = rank.mesh(shape, axes)
    got = {}
    for key, pc, _ in parity_cases(mname):
        if only is not None and pc != only:
            continue
        x, plan = parity_solve(mesh, key, pc, ra, ca)
        got["|".join(key + (pc,))] = dict(
            iters=int(plan.last_iters), status=plan.last_status_names,
            digest=_digest(x), loop=plan.info["loop"], traces=plan.traces,
            x=x if rank.rank == 0 else None)
    return got


def _proc_step(eng, rhs, lay: str) -> dict:
    """A full-size solve on a rank, timed: ``proc_spec``'s PROC_STEPS
    steps minus 0 (one call each, the 0-step plan's warm call before;
    each call's wall on the host clock ends in the copy of x to the
    host), the staging and gloo parts and the bytes the rank received a
    step, by NoC call (``mesh.stats``, steps minus 0); x's digest, and x
    on rank 0."""
    from repro_torch.core.plan import SolveSpec
    from repro_torch.obs.clock import now

    lanes = 1 if rhs.ndim == 1 else rhs.shape[0]
    plans = {n: eng.plan(SolveSpec(**dict(proc_spec(lay, lanes), iters=n)))
             for n in (PROC_STEPS, 0)}
    plans[0](rhs)                       # the allocator's first calls
    walls, stats = {}, {}
    for n, plan in plans.items():
        eng.mesh.stats.reset()
        t0 = now()
        x, _ = plan(rhs)
        walls[n] = now() - t0
        stats[n] = eng.mesh.stats.as_dict()
        if n:
            got = {"digest": _digest(x), "traces": plan.traces,
                   "loop": plan.info["loop"],
                   "x": x if eng.mesh.rank == 0 else None}
    run, zero = stats[PROC_STEPS], stats[0]
    step = (walls[PROC_STEPS] - walls[0]) / PROC_STEPS * 1e6
    stage = (run["stage_s"] - zero["stage_s"]) / PROC_STEPS * 1e6
    comm = (run["comm_s"] - zero["comm_s"]) / PROC_STEPS * 1e6
    got["us"], got["staging_us"], got["gloo_us"] = step, stage, comm
    got["rest_us"] = step - stage - comm
    got["wire_bytes"] = {op: (v - zero["wire_bytes"].get(op, 0)) / PROC_STEPS
                         for op, v in run["wire_bytes"].items()}
    got["calls"] = {op: (v - zero["calls"].get(op, 0)) / PROC_STEPS
                    for op, v in run["calls"].items()}
    return got


def procgrid_rank(rank, what: str, t_spawn: float, go: str = "") -> dict:
    """A rank of phase 8p (module docstring).  ``what`` "mp": the
    multipod DIST_PARITY case on 8 ranks; "main": on 4 ranks, the engines
    at laplacian_3d(SERVE_GRID) and the Jacobi parity cases on 2x2 and
    4x1, then, once the file ``go`` exists (the 8 ranks are done: nothing
    else runs while these are timed), the main path -- ``proc_spec``'s
    full-size solves, one RHS and k = MAIN_BATCH on each PROC_CASES grid
    (timed), and the block-IC(0) parity solve, launch counts zeroed just
    before and read just after."""
    import time
    import numpy as np
    import scipy.sparse as sp

    from repro_torch.core.engine import AzulEngine
    from repro_torch.data.matrices import laplacian_3d
    from repro_torch.kernels import ops
    from repro_torch.obs.clock import now

    out = {"rank": rank.rank, "start_s": now() - t_spawn}
    if what == "mp":
        out["parity"] = _proc_parity(rank, "mp")
        return out
    t0 = now()
    m = laplacian_3d(SERVE_GRID)
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    n = m.shape[0]
    rng = np.random.default_rng(0)
    b = a @ rng.standard_normal(n)
    B = np.ascontiguousarray((a @ rng.standard_normal((MAIN_BATCH, n)).T).T)
    engs = {}
    for name, mode in PROC_MODES.items():
        shape, axes, ra, ca = DIST_MESHES[name]
        engs[name] = AzulEngine(m, mesh=rank.mesh(shape, axes), mode=mode,
                                row_axes=ra, col_axes=ca, dtype=np.float64)
    out["build_s"] = now() - t0
    # the Jacobi parity cases, untimed, while the 8 ranks may still run
    t0 = now()
    out["parity"] = {}
    for name in PROC_MODES:
        out["parity"] |= _proc_parity(rank, name, only="jacobi")
    out["parity_s"] = now() - t0
    t0 = now()
    while not os.path.exists(go):
        if now() - t0 > PROC_DEADLINE_S:
            raise TimeoutError(f"no {go} after {PROC_DEADLINE_S} s")
        time.sleep(0.05)
    out["wait_s"] = now() - t0
    # the main path, the launch counts zeroed just before, read just after
    t0 = now()
    ops.reset_launch_counts()
    out["times"] = {}
    for name, lay in PROC_CASES:
        eng = engs[name]
        model = eng.comm_plan.model()
        for rhs, lanes in ((b, 1), (B, MAIN_BATCH)):
            got = _proc_step(eng, rhs, lay)
            got["model_bytes"] = model[f"bytes_per_iter_{lay}"] * lanes
            got["model_halo_bytes"] = (model["gather_words_halo"]
                                       * eng.comm_plan.itemsize * lanes)
            out["times"][f"{name} {lay} k={lanes}"] = got
    out["parity"] |= _proc_parity(rank, "2x2", only="block_ic0")
    out["launches"] = ops.launch_counts()
    out["main_s"] = now() - t0
    return out


def procgrid_phase(failed: list, refs: dict) -> None:
    """Phase 8p: the tile grid one process a tile (module docstring); the
    one-process grid's solves and times are phase 8's ``refs``."""
    import numpy as np

    from repro_torch.launch import procs
    from repro_torch.obs.clock import now

    t_phase = now()
    res, bad = [], []

    def check(key: str, got: list, ref, want_it=None) -> str:
        """Hold rank 0's x to the one-process grid's and every rank's
        digest, loop and traces to rank 0's; a line for the log."""
        r0 = got[0]
        line = f"{key}: loop {r0['loop']}, traces {r0['traces']}"
        if want_it is not None:
            line += (f", {r0['iters']} iterations (JAX {want_it}), "
                     f"{r0['status']}")
            if abs(r0["iters"] - want_it) > 1 or r0["status"] != "converged":
                bad.append(f"{key}: counts")
        if ref is None:
            bad.append(f"{key}: no one-process reference")
        else:
            rel = float(np.abs(r0["x"] - ref).max() / np.abs(ref).max())
            line += f", max |x - x_grid| / max |x_grid| {rel:.3e}"
            if rel > PROC_RTOL:
                bad.append(f"{key}: x")
        if r0["loop"] != "eager" or r0["traces"] != 1 or any(
                g[k] != r0[k] for g in got for k in ("digest", "iters")
                if k in r0):
            bad.append(f"{key}: ranks differ, or not eager once")
        return line

    def multipod(go: str) -> list:
        """The 8 ranks' run, then the file ``go`` (even when it fails)."""
        try:
            return procs.run(procgrid_rank, 8, ("mp", now()), backend="gloo",
                             device="cuda", timeout_s=PROC_DEADLINE_S)
        finally:
            Path(go).touch()

    # the 8 ranks run while the 4 start and build their engines; the 4
    # wait for them before their main path
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as ex:
        go = os.path.join(tmp, "go")
        t0 = now()
        mp_run = ex.submit(multipod, go)
        try:
            res = procs.run(procgrid_rank, 4, ("main", now(), go),
                            backend="gloo", device="cuda",
                            timeout_s=2 * PROC_DEADLINE_S)
            say(f"procgrid 8p 4 gloo ranks on the card: {now() - t0:.1f} s "
                "(slowest rank: " + ", ".join(
                    f"{k} {max(r[k + '_s'] for r in res):.1f} s" for k in (
                        "start", "build", "parity", "wait", "main")) + ")")
            for key in res[0]["times"]:
                say("procgrid 8p " + check(
                    key, [r["times"][key] for r in res],
                    refs.get(f"{key} pcg")))
            for r in res:
                missing = [k for k in PROC_KERNELS
                           if r["launches"].get(k, 0) < 1]
                if missing:
                    bad.append(f"rank {r['rank']} launched no {missing}")
            say("procgrid 8p launches per rank on the main path: "
                + json.dumps([{k: r["launches"][k] for k in PROC_KERNELS}
                              for r in res]))
        except Exception:
            traceback.print_exc()
            failed.append("procgrid main path")
        try:
            res8 = mp_run.result()
        except Exception:
            traceback.print_exc()
            failed.append("procgrid multipod")
            res8 = []

    try:
        say(f"procgrid 8p 8 gloo ranks on the card (beside the 4's start): "
            f"slowest start {max(r['start_s'] for r in res8):.1f} s")
        for ranks in (res, res8):
            for key in (ranks[0]["parity"] if ranks else ()):
                mat, mname, mode, pc = key.split("|")
                table = DIST_PARITY if pc == "jacobi" else DIST_PARITY_IC0
                say("procgrid 8p parity " + check(
                    key, [r["parity"][key] for r in ranks],
                    refs.get(f"parity {key}"), table[(mat, mname, mode)]))
        done = {k for ranks in (res, res8) for k in
                (ranks[0]["parity"] if ranks else ())}
        want = {"|".join(k + (pc,)) for name in DIST_MESHES
                for k, pc, _ in parity_cases(name)}
        if want - done:
            bad.append(f"parity cases not run: {sorted(want - done)}")
    except Exception:
        traceback.print_exc()
        failed.append("procgrid parity")

    try:
        if not res:
            raise AssertionError("no process-grid times (8p's ranks failed)")
        times = refs.get("times", {})
        rows = {}
        for key, got in res[0]["times"].items():
            name, lay, k = key.split()
            rows[key] = {f: v for f, v in got.items()
                         if f not in ("x", "digest", "loop", "traces")}
            rows[key]["tile_mesh_us"] = times.get(
                f"{name} {lay}" if k == "k=1" else f"{name} {lay} {k}")
            rows[key]["local_us"] = times.get("local" if k == "k=1"
                                              else f"local {k}")
            for r in res:
                pulled = r["times"][key]["wire_bytes"].get("pull_shard")
                if lay == "halo" and pulled != got["model_halo_bytes"]:
                    bad.append(f"{key} rank {r['rank']}: pulled {pulled} "
                               f"bytes a step, model "
                               f"{got['model_halo_bytes']}")
        say(f"procgrid 8p µs a loop step (unguarded pcg, {PROC_STEPS} steps "
            f"minus 0, one call each; rank 0's wall, staging and gloo on the "
            f"host clock; wire = bytes rank 0 received a step) on "
            f"{smi_line()}: " + json.dumps(rows))
    except Exception:
        traceback.print_exc()
        failed.append("procgrid times")
    if bad:
        say(f"procgrid 8p FAILED checks: {bad}")
        failed.append("procgrid checks")
    say(f"procgrid phase: {now() - t_phase:.1f} s")


def lm_prompts(cfg, shape, seed: int = LM_SEED):
    """Prompt ids from default_rng(seed), and for a prefix-LM config its
    precomputed prefix embeddings (normal, f32), as numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=shape)
    pfx = (rng.standard_normal((shape[0], cfg.n_prefix_tokens, cfg.d_model))
           .astype(np.float32) if cfg.prefix_lm else None)
    return toks, pfx


def lm_greedy(M, params, cfg, toks, pfx, steps: int, device: str):
    """Prefill then ``steps`` greedy decode steps on ``device``: (prefill
    logits, [decode logits], tokens (B, steps + 1)), all on the host."""
    import torch

    t = torch.as_tensor(toks, device=device)
    f = None if pfx is None else torch.as_tensor(pfx, device=device)
    npfx = 0 if pfx is None else pfx.shape[1]
    lg, caches, pos = M.prefill(params, cfg, tokens=t, prefix_embeds=f,
                                max_len=npfx + toks.shape[1] + steps)
    first = lg.float().cpu()
    tok = lg[:, -1].argmax(-1)[:, None]
    out, dec = [tok.cpu()], []
    for i in range(steps):
        lg, caches = M.decode_step(params, cfg, caches, tok, pos + i)
        dec.append(lg.float().cpu())
        tok = lg[:, -1].argmax(-1)[:, None]
        out.append(tok.cpu())
    return first, dec, torch.cat(out, 1)


def rel_err(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def lm_phase(failed: list) -> dict:
    """Phase 9: LM serving (``repro_torch.models``, ``serve.generate``,
    ``SlotServer``, ``launch.serve --arch``).  Each sub-phase that fails
    adds its name to ``failed``.  Returns 9b's measurements of
    granite-3-8b (empty where 9b failed)."""
    import contextlib
    import io

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import convert
    from repro_torch.configs import get, get_smoke, names
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import model as M
    from repro_torch.models.blocks import Init
    from repro_torch.models.moe import capacity, route
    from repro_torch.obs.clock import now

    t_phase = now()
    smi = smi_line()

    # -- 9a: every architecture's smoke config in f32, card against CPU ----
    try:
        with torch.inference_mode():
            for name in names():
                cfg = get_smoke(name).replace(param_dtype="float32",
                                              compute_dtype="float32")
                cpu = M.init_params(cfg, torch.Generator().manual_seed(LM_SEED),
                                    "cpu")
                card = convert.lm_params_from_numpy(
                    cfg, convert.lm_params_to_numpy(cpu), "cuda")
                toks, pfx = lm_prompts(cfg, LM_PARITY_SHAPE)
                want = lm_greedy(M, cpu, cfg, toks, pfx, LM_DECODE_STEPS, "cpu")
                got = lm_greedy(M, card, cfg, toks, pfx, LM_DECODE_STEPS, "cuda")
                e_pre = rel_err(got[0], want[0])
                e_dec = max(rel_err(g, w) for g, w in zip(got[1], want[1]))
                if not (e_pre <= LM_RTOL and e_dec <= LM_RTOL):
                    raise AssertionError(f"{name}: prefill {e_pre:.3e}, decode "
                                         f"{e_dec:.3e} (rtol {LM_RTOL})")
                if not torch.equal(got[2], want[2]):
                    raise AssertionError(f"{name}: greedy tokens differ: card "
                                         f"{got[2].tolist()} cpu {want[2].tolist()}")
                say(f"lm parity {name}: prefill logits {e_pre:.2e}, decode "
                    f"{e_dec:.2e} of max|cpu|; {LM_DECODE_STEPS} greedy tokens "
                    f"equal ({M.param_count(card)} params, f32)")
                del cpu, card
    except Exception:
        traceback.print_exc()
        failed.append("lm parity")

    # -- 9b: granite-3-8b at its published width, through launch.serve ----
    full = {}
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # what the earlier phases still hold; peaks below are above it
        base = torch.cuda.memory_allocated()
        buf = io.StringIO()
        t0 = now()
        with contextlib.redirect_stdout(buf):
            rc = serve_cli.main(LM_FULL_ARGV)
        cli_s = now() - t0
        text = buf.getvalue()
        res = json.loads(text[text.index("{"):])
        peak_cli = torch.cuda.max_memory_allocated() - base
        if rc != 0 or res["slot_server_completed"] != 4 or res["batch"] != 4 \
                or res["gen"] != 16 or res["arch"] != LM_FULL:
            raise AssertionError(f"launch.serve {LM_FULL_ARGV}: rc {rc}, {res}")
        say(f"lm serve {' '.join(LM_FULL_ARGV)}: {json.dumps(res)}; "
            f"{cli_s:.1f} s of command, peak {peak_cli / 1e9:.2f} GB above "
            f"the {base / 1e9:.2f} GB the earlier phases hold")

        cfg = get(LM_FULL)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = now()
        params = M.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(LM_SEED), "cuda")
        torch.cuda.synchronize()
        init_s = now() - t0
        wbytes = sum(p.numel() * p.element_size() for p in params.parameters())
        bound_ms = wbytes / HBM_BYTES_PER_S * 1e3
        toks, _ = lm_prompts(cfg, (4, 32))
        t = torch.as_tensor(toks, device="cuda")
        steps = 16
        with torch.inference_mode():
            pre_ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = now()
                lg, caches, pos = M.prefill(params, cfg, tokens=t,
                                            max_len=32 + steps)
                torch.cuda.synchronize()
                pre_ms.append((now() - t0) * 1e3)
            tok = lg[:, -1].argmax(-1)[:, None]
            seq, dec_ms, dec_logits = [tok], [], []
            for i in range(steps - 1):
                torch.cuda.synchronize()
                t0 = now()
                lg, caches = M.decode_step(params, cfg, caches, tok, pos + i)
                torch.cuda.synchronize()
                dec_ms.append((now() - t0) * 1e3)
                dec_logits.append(lg.float())
                tok = lg[:, -1].argmax(-1)[:, None]
                seq.append(tok)
            # one more step under the profiler: kernels launched, their time
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                lg, caches = M.decode_step(params, cfg, caches, tok,
                                           pos + steps - 1)
                torch.cuda.synchronize()
            evs = prof.events()
            kern = [e for e in evs
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.name.startswith(("Memcpy", "Memset"))]
            api = sum(1 for e in evs if e.name in (
                "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx"))
            kern_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
            if not kern and not api:
                raise AssertionError("the profiler saw no launch in a decode step")
            # decode against forward on the same tokens (bf16, not a gate)
            all_toks = torch.cat([t] + seq[:-1], 1)
            h, _ = M.forward(params, cfg, tokens=all_toks)
            ref = M.logits_from_hidden(params, cfg, h[:, 32:]).float()
            e_bf16 = max(rel_err(d[:, 0], ref[:, i])
                         for i, d in enumerate(dec_logits))
        peak = torch.cuda.max_memory_allocated() - base
        med = float(np.median(dec_ms))
        full = {"weight_bytes": wbytes, "params": M.param_count(params),
                "peak_bytes": peak, "peak_bytes_cli": peak_cli,
                "earlier_phases_bytes": base,
                "init_s": init_s, "prefill_ms": pre_ms,
                "decode_ms_median": med, "decode_ms": dec_ms,
                "bound_ms": bound_ms,
                "decode_tokens_per_s": 4 / med * 1e3,
                "cli_tokens_per_s": res["tokens_per_s"],
                "kernels_per_step": len(kern), "launch_calls_per_step": api,
                "kernel_ms_per_step": kern_ms,
                "decode_vs_forward_bf16": e_bf16}
        say(f"lm full {LM_FULL} (40 layers, d_model 4096, 32/8 heads, d_ff "
            f"12800, vocab 49155, bf16; batch 4, prompt 32): "
            + json.dumps(full))
        say(f"lm full: decode {med:.3f} ms a step (median of {len(dec_ms)}) "
            f"against the {bound_ms:.3f} ms bytes bound ({wbytes} weight "
            f"bytes / 3.35 TB/s; {bound_ms / med:.1%}); {len(kern)} kernels "
            f"({api} launch calls) a step, {kern_ms:.3f} ms of them on the "
            f"card; prefill {min(pre_ms):.3f} ms (warm); peak "
            f"{peak / 1e9:.3f} GB; on {smi}")

        # -- 9d: the same weights decoding into an int8 KV cache ------------
        cfg8 = cfg.replace(kv_cache_dtype="int8")
        with torch.inference_mode():
            lg, caches, pos = M.prefill(params, cfg8, tokens=t,
                                        max_len=32 + LM_INT8_STEPS)
            if caches[0][0]["k"].dtype != torch.int8:
                raise AssertionError("int8 cache not int8")
            tok = lg[:, -1].argmax(-1)[:, None]
            seq8, dl8 = [], []
            for i in range(LM_INT8_STEPS):
                seq8.append(tok)
                lg, caches = M.decode_step(params, cfg8, caches, tok, pos + i)
                dl8.append(lg.float())
                tok = lg[:, -1].argmax(-1)[:, None]
            h, _ = M.forward(params, cfg, tokens=torch.cat([t] + seq8, 1))
            ref = M.logits_from_hidden(params, cfg, h[:, 32:]).float()
            e8 = [rel_err(d[:, 0], ref[:, i]) for i, d in enumerate(dl8)]
        if not max(e8) < LM_INT8_BOUND:
            raise AssertionError(f"int8 KV decode vs forward {e8} "
                                 f"(bound {LM_INT8_BOUND})")
        say(f"lm int8 kv {LM_FULL}: decode logits vs forward on the same "
            f"tokens, max err / max|ref| {[round(e, 5) for e in e8]} over "
            f"{LM_INT8_STEPS} steps (< {LM_INT8_BOUND}; the bf16 cache: "
            f"{e_bf16:.5f})")
        del params, caches, h, ref
    except Exception:
        traceback.print_exc()
        failed.append("lm full width")

    # -- 9c: dbrx-132b at its published width, LM_MOE_LAYERS layers -------
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        cfg = get(LM_MOE).replace(n_layers=LM_MOE_LAYERS)
        params = M.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(LM_SEED), "cuda")
        wbytes = sum(p.numel() * p.element_size() for p in params.parameters())
        seen = []                       # each MoE router's logits, in order

        def keep_logits(mod, inp, out):
            seen.append(out.float().cpu())

        def record(layers):
            for layer in layers:
                if layer.kind == "attn_moe":
                    layer.ffn.router.register_forward_hook(keep_logits)

        record([lay for group in params.groups for lay in group])
        n_moe = sum(lay.kind == "attn_moe" for g in params.groups for lay in g)
        toks, _ = lm_prompts(cfg, (4, 32))
        t = torch.as_tensor(toks, device="cuda")
        k, e = cfg.top_k, cfg.n_experts
        cap = capacity(32, k, e, cfg.moe_capacity_factor)
        steps = 8
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = now()
            lg, caches, pos = M.prefill(params, cfg, tokens=t, max_len=32 + steps)
            torch.cuda.synchronize()
            moe_pre_ms = (now() - t0) * 1e3
            drops = [int((~route(l, k, cap)["keep"]).sum()) for l in seen]
            seen.clear()
            tok = lg[:, -1].argmax(-1)[:, None]
            moe_dec = []
            for i in range(steps):
                torch.cuda.synchronize()
                t0 = now()
                lg, caches = M.decode_step(params, cfg, caches, tok, pos + i)
                torch.cuda.synchronize()
                moe_dec.append((now() - t0) * 1e3)
                tok = lg[:, -1].argmax(-1)[:, None]
            dec_routes = [route(l, k, l.shape[1]) for l in seen]
            seen.clear()
        if not all(r["keep"].all() and r["idx"].shape[:2] == (1, 4)
                   for r in dec_routes):
            raise AssertionError("decode dropped an assignment")
        peak = torch.cuda.max_memory_allocated() - base

        # prefill's assignments in f32, card against CPU, the same weights
        # (the bf16 ones upcast).  The CPU holds the f32 model (15.5 GB a
        # layer); the card runs the same prefill a layer at a time, one
        # layer's f32 weights (12.7 GB) on it at once: the plans phases 1-8
        # keep leave too little room for a whole f32 model
        cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
        cpu = M.init_params(cfg32, None, "cpu")
        with torch.no_grad():
            for pc, pg in zip(cpu.parameters(), params.parameters()):
                pc.copy_(pg)
        del params, caches
        torch.cuda.empty_cache()
        record([lay for group in cpu.groups for lay in group])
        with torch.inference_mode():
            t0 = now()
            M.prefill(cpu, cfg32, tokens=torch.as_tensor(toks), max_len=32)
            cpu_s = now() - t0
            on_cpu = [route(l, k, cap) for l in seen]
            seen.clear()
            x = cpu.embed.table.to("cuda")[t]
            for group in cpu.groups:
                for layer in group:
                    lay = M.Layer(layer.kind, cfg32,
                                  Init(None, "cuda", torch.float32))
                    for pg, pc in zip(lay.parameters(), layer.parameters()):
                        pg.copy_(pc)
                    record([lay])
                    x, _ = lay.prefill(x, cfg32, 32)
                    del lay
                    torch.cuda.empty_cache()
            on_card = [route(l, k, cap) for l in seen]
        if len(on_card) != n_moe or len(on_cpu) != n_moe:
            raise AssertionError(f"routes seen: {len(on_card)}, {len(on_cpu)}")
        for li, (a, b) in enumerate(zip(on_card, on_cpu)):
            if not (torch.equal(a["idx"], b["idx"])
                    and torch.equal(a["keep"], b["keep"])):
                raise AssertionError(f"MoE layer {li}: f32 prefill assignments "
                                     "differ between the card and the CPU")
        drops32 = [int((~r["keep"]).sum()) for r in on_card]
        say(f"lm moe {LM_MOE} (published width, n_layers {LM_MOE_LAYERS}: 16 experts of "
            f"d_ff 10752 at d_model 6144, top-4; bf16, {wbytes} weight bytes, "
            f"peak {peak / 1e9:.3f} GB above the earlier phases): prefill "
            f"4 x 32 {moe_pre_ms:.3f} ms "
            f"(first call; capacity {cap} a sequence, dropped {drops} of "
            f"{4 * 32 * k} assignments a layer), decode "
            f"{float(np.median(moe_dec)):.3f} ms a step (median of {steps}; "
            f"bound {wbytes / HBM_BYTES_PER_S * 1e3:.3f} ms), drop-free; f32 "
            f"prefill on the card and the CPU ({cpu_s:.1f} s): the same "
            f"experts and the same drops ({drops32}) in every layer")
        del cpu, x
    except Exception:
        traceback.print_exc()
        failed.append("lm moe")
    torch.cuda.empty_cache()
    say(f"lm phase: {now() - t_phase:.1f} s")
    return full


def train_batch(cfg, shape, step: int = 0, seed: int = TRAIN_SEED) -> dict:
    """``TokenPipeline(seed)``'s batch ``step`` at (batch, seq), and for a
    prefix-LM config prefix embeddings from default_rng(seed), numpy."""
    import numpy as np

    from repro_torch.data import TokenPipeline

    b = TokenPipeline(cfg.vocab_size, shape[0], shape[1], seed=seed).batch_at(step)
    if cfg.prefix_lm:
        b["prefix_embeds"] = np.random.default_rng(seed).standard_normal(
            (shape[0], cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return b


def leaf_errs(got: dict, want: dict) -> float:
    """The largest over leaves of max|got - want| / max|want| (a stack's
    layers together), ``got`` on any device, ``want`` on the CPU."""
    from repro_torch.train.optim import rows

    worst = 0.0
    for path, leaf in want.items():
        w = [t.detach().float() for t in rows(leaf)]
        g = [t.detach().float().cpu() for t in rows(got[path])]
        scale = max(max(float(t.abs().max()) for t in w), 1e-30)
        err = max(float((a - b).abs().max()) for a, b in zip(g, w))
        worst = max(worst, err / scale)
    return worst


def same_grads_update(cfg, opt, state, batch) -> float:
    """The optimizer's update on identical grads: the CPU's clipped grads
    of ``batch`` and the CPU ``state`` (a copy of it on the card) through
    ``opt.update`` on both devices; the largest leaf's max|card - cpu| /
    max|cpu| of the new params."""
    from repro_torch import convert
    from repro_torch import train as T
    from repro_torch.models import model as M
    from repro_torch.models.model import LayerStack
    from repro_torch.train.step import as_batch, value_and_grad

    _, grads = value_and_grad(cfg, state.params, as_batch(batch, "cpu"))
    grads, _ = T.clip_by_global_norm(grads, 1.0)
    want, _ = opt.update(grads, state.opt_state, M.param_leaves(state.params),
                         state.step)
    card = convert.train_state_from_numpy(
        cfg, convert.train_state_to_numpy(state), "cuda")
    grads = {k: LayerStack(t.cuda() for t in v) if isinstance(v, LayerStack)
             else v.cuda() for k, v in grads.items()}
    got, _ = opt.update(grads, card.opt_state, M.param_leaves(card.params),
                        card.step)
    return leaf_errs(got, want)


def param_diffs(got, want) -> tuple:
    """(largest leaf's max|got - want| / max|want|, the largest absolute
    difference, the share of elements within TRAIN_RTOL x max|want| of
    their leaf) of two models' params."""
    from repro_torch.models import model as M
    from repro_torch.train.optim import rows

    worst, d_max, close, total = 0.0, 0.0, 0, 0
    g_leaves = M.param_leaves(got)
    for path, leaf in M.param_leaves(want).items():
        w = [t.detach().float() for t in rows(leaf)]
        g = [t.detach().float().cpu() for t in rows(g_leaves[path])]
        scale = max(max(float(t.abs().max()) for t in w), 1e-30)
        for a, b in zip(g, w):
            d = (a - b).abs()
            worst = max(worst, float(d.max()) / scale)
            d_max = max(d_max, float(d.max()))
            close += int((d <= TRAIN_RTOL * scale).sum())
            total += d.numel()
    return worst, d_max, close / total


def cli_json(main, argv) -> tuple:
    """(exit code, closing JSON, seconds) of an in-process CLI run."""
    import contextlib
    import io

    from repro_torch.obs.clock import now

    buf = io.StringIO()
    t0 = now()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    text = buf.getvalue()
    return rc, json.loads(text[text.index("{"):]), now() - t0


def train_phase(failed: list) -> dict:
    """Phase 10: LM training (``models.model.loss_fn``, ``train``,
    ``ft.RestartManager``, ``launch.train``).  Each sub-phase that fails
    adds its name to ``failed``.  Returns 10b's measurements by arch:
    ``full_run``'s dict and ``held``, the bytes the step's state holds
    on the card (params, optimizer state, step)."""
    import math
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import convert, obs
    from repro_torch import train as T
    from repro_torch.configs import get, get_smoke, names
    from repro_torch.data import TokenPipeline
    from repro_torch.ft import RestartManager
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.sharding import tree_leaves
    from repro_torch.models import model as M
    from repro_torch.obs.clock import now
    from repro_torch.train.step import as_batch, value_and_grad

    t_phase = now()
    smi = smi_line()
    torch.cuda.synchronize()
    say(f"train phase: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved "
        "after phases 1-9 released theirs")
    f32 = lambda c: c.replace(param_dtype="float32", compute_dtype="float32")

    # -- 10a: every smoke config in f32, card against CPU ------------------
    try:
        for name in names():
            cfg = f32(get_smoke(name))
            cpu = M.init_params(cfg, torch.Generator().manual_seed(TRAIN_SEED),
                                "cpu")
            card = convert.lm_params_from_numpy(
                cfg, convert.lm_params_to_numpy(cpu), "cuda")
            b = train_batch(cfg, TRAIN_SHAPE)
            out = {}
            for dev, params in (("cpu", cpu), ("cuda", card)):
                loss, grads = value_and_grad(cfg, params, as_batch(b, dev))
                _, gn = T.clip_by_global_norm(grads, 1.0)
                out[dev] = (float(loss), float(gn), grads)
            e_loss = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
            e_gn = abs(out["cuda"][1] - out["cpu"][1]) / abs(out["cpu"][1])
            e_g = leaf_errs(out["cuda"][2], out["cpu"][2])
            if not (e_loss <= TRAIN_RTOL and e_gn <= TRAIN_RTOL
                    and e_g <= TRAIN_RTOL):
                raise AssertionError(f"{name}: loss {e_loss:.3e}, grad_norm "
                                     f"{e_gn:.3e}, grads {e_g:.3e}")
            steps = {}
            for opt_name in ("adamw", "adafactor"):
                opt = getattr(T, opt_name)(T.warmup_cosine(TRAIN_LR, 1, 10))
                step = T.build_train_step(cfg, opt)
                st = {"cpu": T.init_train_state(cpu, opt),
                      "cuda": T.init_train_state(card, opt)}
                for i in range(2):
                    bi = train_batch(cfg, TRAIN_SHAPE, i)
                    if i == 1:
                        e_same = same_grads_update(cfg, opt, st["cpu"], bi)
                    m = {}
                    for dev in st:
                        st[dev], m[dev] = step(st[dev], bi)
                    e = abs(float(m["cuda"]["loss"]) - float(m["cpu"]["loss"]))
                    if e > TRAIN_RTOL * abs(float(m["cpu"]["loss"])):
                        raise AssertionError(f"{name} {opt_name} step {i}: loss "
                                             f"{float(m['cuda']['loss'])} vs "
                                             f"{float(m['cpu']['loss'])}")
                e_p, d_max, share = param_diffs(st["cuda"].params, st["cpu"].params)
                ok = (e_same <= TRAIN_RTOL and share >= TRAIN_PARAM_SHARE
                      and d_max <= 2 * TRAIN_LR)
                if not ok:
                    raise AssertionError(
                        f"{name} {opt_name}: update on identical grads "
                        f"{e_same:.3e} of max|p|; params after step 1 {e_p:.3e} "
                        f"of max|p|, {share:.5f} of them within {TRAIN_RTOL}, "
                        f"largest difference {d_max:.3e} (2 lr = {2 * TRAIN_LR})")
                steps[opt_name] = (e_same, e_p, share)
            aw, af = steps["adamw"], steps["adafactor"]
            say(f"train parity {name}: loss {e_loss:.2e}, grad_norm {e_gn:.2e}, "
                f"grads {e_g:.2e} of max|cpu| (leaf by leaf); the update on "
                f"identical grads: adamw {aw[0]:.2e}, adafactor {af[0]:.2e}; "
                f"params after step 1: adafactor {af[1]:.2e} ({af[2]:.5f} "
                f"within {TRAIN_RTOL}), adamw {aw[1]:.2e} ({aw[2]:.5f}) "
                f"({M.param_count(card)} params, f32)")
            del cpu, card, out
        cfg = f32(get_smoke(TRAIN_FULL))
        cpu = M.init_params(cfg, torch.Generator().manual_seed(TRAIN_SEED), "cpu")
        card = convert.lm_params_from_numpy(cfg, convert.lm_params_to_numpy(cpu),
                                            "cuda")
        for kw in ({"grad_accum": 2}, {"compress_grads": True}):
            opt = T.adamw(T.warmup_cosine(3e-3, 1, 10))
            step = T.build_train_step(cfg, opt, **kw)
            comp = kw.get("compress_grads", False)
            st = {"cpu": T.init_train_state(cpu, opt, compress=comp),
                  "cuda": T.init_train_state(card, opt, compress=comp)}
            errs = []
            for i in range(3):
                bi = train_batch(cfg, (4, 32), i)
                m = {}
                for dev in st:
                    st[dev], m[dev] = step(st[dev], bi)
                e = [abs(float(m["cuda"][k]) - float(m["cpu"][k]))
                     / abs(float(m["cpu"][k])) for k in ("loss", "grad_norm")]
                if max(e) > TRAIN_RTOL:
                    raise AssertionError(f"{TRAIN_FULL} {kw} step {i}: loss, "
                                         f"grad_norm rel err {e}")
                errs.append(max(e))
            say(f"train parity {TRAIN_FULL} {kw}: loss and grad_norm over 3 "
                f"steps within {max(errs):.2e}")
        del cpu, card, st
    except Exception:
        traceback.print_exc()
        failed.append("train parity")

    # -- 10b: granite-3-8b at its published config, through launch.train --
    def full_run(arch, argv, label):
        cfg = get(arch)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rc, res, cli_s = cli_json(train_cli.main, argv)
        peak = torch.cuda.max_memory_allocated() - base
        losses = res["losses"]
        if rc != 0 or res["arch"] != arch or res["steps"] != TRAIN_STEPS \
                or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"launch.train {argv}: rc {rc}, {res}")
        n = M.param_count(M.init_params(cfg, None, "meta"))
        batch, seq = int(argv[argv.index("--batch") + 1]), int(argv[argv.index("--seq") + 1])
        tokens = batch * seq
        warm = float(np.median(res["step_ms"][1:]))
        flops = 6 * n * tokens
        floor_ms = flops / BF16_PEAK_FLOPS * 1e3
        out = {"params": n, "tokens_per_step": tokens, "losses": losses,
               "loss_first": res["loss_first"], "loss_last": res["loss_last"],
               "ln_vocab": math.log(cfg.vocab_size), "step_ms": res["step_ms"],
               "warm_step_ms": warm, "tokens_per_s": tokens / warm * 1e3,
               "cli_mean_step_ms": res["mean_step_ms"],
               "model_flops_per_step": flops, "bf16_floor_ms": floor_ms,
               "bf16_floor_ms_with_recompute": floor_ms * 8 / 6 if cfg.remat else floor_ms,
               "peak_share": floor_ms / warm, "peak_bytes": peak,
               "cli_s": cli_s}
        say(f"train {label} {' '.join(argv)}: " + json.dumps(out))
        say(f"train {label}: warm step {warm:.1f} ms (median of steps "
            f"2-{TRAIN_STEPS}), "
            f"{tokens / warm * 1e3:.0f} tokens/s, {floor_ms / warm:.1%} of the "
            f"989.4 TFLOP/s bf16 peak (6 N T = {flops:.3e} FLOPs, floor "
            f"{floor_ms:.1f} ms), loss {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"(ln V = {math.log(cfg.vocab_size):.4f}), peak "
            f"{peak / 1e9:.2f} GB; on {smi}")
        return cfg, out

    def step_parts(cfg, opt, argv, label):
        """The launcher's donated step in its parts, timed by CUDA events
        (median of the steps after one warm-up), then one step under the
        profiler."""
        batch, seq = int(argv[argv.index("--batch") + 1]), int(argv[argv.index("--seq") + 1])
        params = M.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(TRAIN_SEED), "cuda")
        state = T.init_train_state(params, opt)
        del params
        nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
        held = {"params": nbytes(state.params.parameters()),
                "opt_state": nbytes(tree_leaves(state.opt_state).values()),
                "step": nbytes([state.step])}
        pipe = TokenPipeline(cfg.vocab_size, batch, seq, seed=0)
        leaves = M.param_leaves(state.params)
        parts = {"forward+backward": [], "clip": [], "optimizer": [], "step": []}
        for i in range(TRAIN_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            b = as_batch(pipe.batch_at(i), "cuda")
            ev[0].record()
            loss, grads = value_and_grad(cfg, state.params, b, leaves)
            ev[1].record()
            with torch.no_grad():
                grads, _ = T.clip_by_global_norm(grads, 1.0, inplace=True)
                ev[2].record()
                _, opt_state = opt.update(grads, state.opt_state, leaves,
                                          state.step, inplace=True)
            ev[3].record()
            del grads
            state = state._replace(opt_state=opt_state, step=state.step + 1)
            torch.cuda.synchronize()
            if i:
                for k, (a, z) in zip(("forward+backward", "clip", "optimizer"),
                                     zip(ev, ev[1:])):
                    parts[k].append(a.elapsed_time(z))
                parts["step"].append(ev[0].elapsed_time(ev[3]))
        med = {k: float(np.median(v)) for k, v in parts.items()}
        step = T.build_train_step(cfg, opt, donate=True)
        b = pipe.batch_at(TRAIN_STEPS)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, m = step(state, b)
            torch.cuda.synchronize()
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name: dict = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        kern_ms = sum(by_name.values())
        if not kern:
            raise AssertionError("the profiler saw no kernel in a train step")
        say(f"train {label} step parts on the card (ms, CUDA events, median of "
            f"{TRAIN_STEPS - 1}): " + json.dumps(med) + f"; under the profiler one step "
            f"launched {len(kern)} kernels, {kern_ms:.1f} ms of them on the "
            f"card; the largest: "
            + json.dumps([(k[:60], round(v, 2)) for k, v in top]))
        del state
        return held

    trained = {}
    try:
        cfg, full = full_run(TRAIN_FULL, TRAIN_FULL_ARGV, "full")
        if abs(full["loss_first"] - full["ln_vocab"]) > 1.0:
            raise AssertionError(f"loss_first {full['loss_first']} is not near "
                                 f"ln V = {full['ln_vocab']}")
        held = step_parts(cfg, T.adafactor(T.warmup_cosine(3e-3, 2, 5)),
                          TRAIN_FULL_ARGV, "full")
        trained[TRAIN_FULL] = dict(full, held=held)
    except Exception:
        traceback.print_exc()
        failed.append("train full width")
    torch.cuda.empty_cache()
    try:
        cfg, out = full_run(TRAIN_ADAMW, TRAIN_ADAMW_ARGV, "adamw")
        held = step_parts(cfg, T.adamw(T.warmup_cosine(3e-3, 2, 5)),
                          TRAIN_ADAMW_ARGV, "adamw")
        trained[TRAIN_ADAMW] = dict(out, held=held)
    except Exception:
        traceback.print_exc()
        failed.append("train adamw")
    torch.cuda.empty_cache()

    # -- 10c: the training RestartManager on the card --------------------
    try:
        cfg = f32(get_smoke(TRAIN_FULL))
        params = M.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(TRAIN_SEED), "cuda")
        opt = T.adamw(T.warmup_cosine(3e-3, 5, 100))
        state = T.init_train_state(params, opt)
        step = T.build_train_step(cfg, opt, grad_accum=2)
        pipe = TokenPipeline(cfg.vocab_size, batch=8, seq_len=16, seed=0)
        with tempfile.TemporaryDirectory() as d:
            rm = RestartManager(f"{d}/run", save_every=4)
            try:
                rm.run(state, step, pipe, total_steps=12, inject_failure_at=9)
                raise AssertionError("the injected failure did not raise")
            except RuntimeError as exc:
                if "injected failure at step 9" not in str(exc):
                    raise
            res = rm.run(state, step, pipe, total_steps=12)
            clean = RestartManager(f"{d}/clean", save_every=4).run(
                state, step, pipe, total_steps=12)
            bad = pipe.batch_at(6)["tokens"]
            seen = []

            def nan_once(st, batch):
                new, m = step(st, batch)
                if not seen and np.array_equal(batch["tokens"], bad):
                    seen.append(1)
                    m = dict(m, loss=m["loss"] * float("nan"))
                return new, m

            rollbacks = obs.REGISTRY.get("repro_ft_rollbacks_total")
            r0 = rollbacks.value()
            nres = RestartManager(f"{d}/nan", save_every=4).run(
                state, nan_once, pipe, total_steps=12)
        got = (res.resumed_from, int(res.state.step), len(res.losses))
        if got != (8, 12, 4):
            raise AssertionError(f"resume: (resumed_from, step, losses) {got}")
        same = all(torch.equal(a, b) for a, b in zip(
            res.state.params.parameters(), clean.state.params.parameters()))
        if not same or res.losses != clean.losses[8:]:
            raise AssertionError("the resumed run differs from an "
                                 "uninterrupted one")
        ngot = (nres.nan_rollbacks, int(nres.state.step), len(nres.losses),
                rollbacks.value() - r0)
        if ngot != (1, 11, 13, 1):
            raise AssertionError(f"NaN rollback: (rollbacks, step, losses, "
                                 f"counter) {ngot}")
        say(f"train restart {TRAIN_FULL} smoke f32 on the card: resumed_from 8, "
            f"step 12, params bit for bit an uninterrupted run's; NaN at step "
            f"6: 1 rollback (repro_ft_rollbacks_total +1), restored to step 4, "
            f"on to step 11 with 13 losses; steps "
            f"{1e3 * float(np.median(clean.step_times)):.2f} ms (median)")
        del params, state, res, clean, nres
    except Exception:
        traceback.print_exc()
        failed.append("train restart")

    # -- 10d: remat at granite's width, 4 layers ---------------------------
    try:
        cfg = get(TRAIN_FULL).replace(n_layers=TRAIN_REMAT_LAYERS)
        params = M.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(TRAIN_SEED), "cuda")
        b = as_batch(TokenPipeline(cfg.vocab_size, 4, 1024, seed=0).batch_at(0),
                     "cuda")
        out = {}
        for remat in (True, False):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            loss, grads = value_and_grad(cfg.replace(remat=remat), params, b)
            torch.cuda.synchronize()
            out[remat] = (float(loss), grads,
                          torch.cuda.max_memory_allocated() - base)
            del grads
        same = out[True][0] == out[False][0] and all(
            torch.equal(a, c) for path in out[True][1]
            for a, c in zip(T.optim.rows(out[True][1][path]),
                            T.optim.rows(out[False][1][path])))
        if not same:
            e = max(float((a - c).abs().max()) / max(float(c.abs().max()), 1e-30)
                    for path in out[True][1]
                    for a, c in zip(T.optim.rows(out[True][1][path]),
                                    T.optim.rows(out[False][1][path])))
            raise AssertionError(f"remat grads differ from no remat: loss "
                                 f"{out[True][0]} vs {out[False][0]}, grads "
                                 f"{e:.3e} of max|grad|")
        say(f"train remat {TRAIN_FULL} width, {TRAIN_REMAT_LAYERS} layers, bf16, "
            f"4 x 1024: loss {out[True][0]:.4f}, grads with remat bit for bit "
            f"those without; peak above the weights: remat "
            f"{out[True][2] / 1e9:.2f} GB, no remat {out[False][2] / 1e9:.2f} GB")
        del params, out
    except Exception:
        traceback.print_exc()
        failed.append("train remat")
    torch.cuda.empty_cache()
    say(f"train phase: {now() - t_phase:.1f} s")
    return trained


def roofline_phase(failed: list, lm: dict, trained: dict) -> None:
    """Phase 11: ``roofline.analyze`` on the LM cells phases 9b and 10b
    measured (11a), ``launch.dryrun`` on the card's 1 x 1 mesh against
    phase 10 (11b) and ``kernels.autotune`` at the rows kernels' W = 12
    and 16 and ``bcsr_spmm``'s bn = 4 and 16 (11c).  Each sub-phase that
    fails adds its name to ``failed``."""
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.core.formats import bcsr_arrays_from_csr
    from repro_torch.data.matrices import laplacian_2d
    from repro_torch.kernels import autotune, bcsr_spmm, ell_spmv
    from repro_torch.launch import dryrun
    from repro_torch.obs.clock import now
    from repro_torch.roofline import analyze as RA

    t_phase = now()
    smi = smi_line()
    total = torch.cuda.get_device_properties(0).total_memory
    say(f"roofline phase: {torch.cuda.get_device_name(0)}, total_memory "
        f"{total} bytes ({total / 1e9:.2f} GB; the model's HBM_BYTES "
        f"{RA.HBM_BYTES / 1e9:.0f} GB); peaks {RA.PEAK_FLOPS / 1e12:.1f} "
        f"TFLOP/s bf16, {RA.HBM_BW / 1e12:.2f} TB/s, link "
        f"{RA.LINK_BW / 1e9:.0f} GB/s; on {smi}")

    # -- 11a: roofline rows of the measured LM cells -------------------------
    try:
        cells = [
            ("decode", LM_FULL, 48, 4, lm.get("decode_ms_median"),
             "9b decode, median"),
            ("prefill", LM_FULL, 32, 4,
             min(lm["prefill_ms"]) if lm.get("prefill_ms") else None,
             "9b prefill, warm"),
            ("train", TRAIN_FULL, 1024, 4,
             trained.get(TRAIN_FULL, {}).get("warm_step_ms"),
             "10b adafactor, remat"),
            ("train", TRAIN_ADAMW, 1024, 4,
             trained.get(TRAIN_ADAMW, {}).get("warm_step_ms"),
             "10b adamw, remat"),
        ]
        bad = []
        for kind, arch, seq, batch, ms, what in cells:
            cfg = get(arch)
            row = RA.roofline_row({"arch": arch, "shape": f"{kind}_{batch}x{seq}",
                                   "mesh": "card", "devices": 1, "kind": kind,
                                   "seq": seq, "global_batch": batch}, cfg)
            ana = RA.analytic_cell(cfg, kind, seq, batch)
            floor_ms = row.model_flops / RA.PEAK_FLOPS * 1e3
            bound_ms = row.t_bound() * 1e3
            out = {"arch": arch, "kind": kind, "batch": batch, "seq": seq,
                   "analytic_flops": ana["flops"], "model_flops": ana["model_flops"],
                   "hbm_bytes": ana["hbm_bytes"],
                   "t_compute_ms": row.t_compute * 1e3,
                   "t_memory_ms": row.t_memory * 1e3,
                   "t_collective_ms": row.t_collective * 1e3,
                   "dominant": row.dominant, "bound_ms": bound_ms,
                   "model_floor_ms": floor_ms,
                   "frac_of_roofline": row.frac_of_roofline(),
                   "measured_ms": ms, "measured": what}
            if ms is not None:
                out["bf16_peak_share"] = row.model_flops / (ms * 1e-3 * RA.PEAK_FLOPS)
                out["bound_over_measured"] = bound_ms / ms
            else:
                bad.append(f"{arch} {kind}: not measured (its phase failed)")
            want = ROOF_FLOORS_MS.get((kind, arch))
            if want is not None:
                got = floor_ms if kind == "train" else bound_ms
                out["perf_md_floor_ms"] = want
                if abs(got - want) > ROOF_TOL * want:
                    bad.append(f"{arch} {kind}: floor {got:.3f} ms, PERF.md {want}")
            say("roofline " + json.dumps(out) + f"; on {smi}")
        if bad:
            raise AssertionError("; ".join(bad))
        say(f"roofline ok: the {ROOF_FLOORS_MS[('train', TRAIN_FULL)]} ms "
            f"training floor and the {ROOF_FLOORS_MS[('decode', LM_FULL)]} ms "
            f"decode floor reproduced within {ROOF_TOL:.0%}")
    except Exception:
        traceback.print_exc()
        failed.append("roofline")

    # -- 11b: the dry run on the card's mesh against phase 10 ----------------
    try:
        bad = []
        for arch, opt in ((TRAIN_FULL, "adafactor"), (TRAIN_ADAMW, "adamw")):
            res = dryrun.run_cell(arch, ("train", 1024, 4), "card",
                                  variant="ga1", optimizer=opt)
            mem, parts = res["memory_analysis"], res["argument_bytes_by_part"]
            row = RA.roofline_row(res, get(arch))
            ratio = res["counted_flops"] / row.analytic_flops
            state = parts["params"] + parts["opt_state"] + parts["step"]
            got = trained.get(arch, {})
            held = got.get("held")
            peak = got.get("peak_bytes")
            out = {"arch": arch, "optimizer": opt, "argument_bytes": parts,
                   "state_bytes": state, "held_on_card": held,
                   "counted_flops": res["counted_flops"],
                   "analytic_flops": row.analytic_flops,
                   "counted_over_analytic": ratio,
                   "temp_bytes": mem["temp_size_in_bytes"],
                   "peak_estimate_bytes": row.hbm_used,
                   "max_memory_allocated": peak,
                   "peak_estimate_over_measured":
                       row.hbm_used / peak if peak else None,
                   "fits_hbm": row.fits_hbm, "meta_run_s": res["run_s"]}
            say("dryrun card " + json.dumps(out) + f"; on {smi}")
            if held is None or peak is None:
                bad.append(f"{arch}: phase 10 did not measure it")
                continue
            if sum(held.values()) != state or held["params"] != parts["params"] \
                    or held["opt_state"] != parts["opt_state"]:
                bad.append(f"{arch}: argument bytes {parts} vs held {held}")
            if not DRY_FLOP_BAND[0] <= ratio <= DRY_FLOP_BAND[1]:
                bad.append(f"{arch}: counted / analytic FLOPs {ratio:.4f} "
                           f"outside {DRY_FLOP_BAND}")
            if abs(row.hbm_used / peak - 1) > DRY_PEAK_TOL:
                bad.append(f"{arch}: peak estimate {row.hbm_used} vs "
                           f"max_memory_allocated {peak}")
        if bad:
            raise AssertionError("; ".join(bad))
        say(f"dryrun ok: argument bytes equal the state on the card, counted "
            f"FLOPs inside {DRY_FLOP_BAND} of analytic_cell, peak estimates "
            f"within {DRY_PEAK_TOL:.0%} of max_memory_allocated")
    except Exception:
        traceback.print_exc()
        failed.append("dryrun")

    # -- 11c: the timer at the rows kernels' W = 12, 16 and bcsr bn = 4, 16 --
    prev = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    try:
        with tempfile.TemporaryDirectory() as d:
            os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(d, "autotune.json")
            autotune.clear_memo()
            gen = torch.Generator(device="cuda").manual_seed(0)
            results = []

            def tune(op, shape, cands, build, bytes_):
                timings = []
                best = autotune.autotune(op, shape, torch.float64, cands, build,
                                         reps=TIMER_REPS, timings=timings)
                us = {c["variant"]: t for c, t in timings}
                if best is None or any(t is None for t in us.values()):
                    raise AssertionError(f"{op} {shape}: a variant failed: {us}")
                if autotune.lookup(op, shape, torch.float64) != best:
                    raise AssertionError(f"{op} {shape}: lookup != {best}")
                results.append({"op": op, "shape": list(shape), "us": us,
                                "winner": best["variant"],
                                "bound_us": bytes_ / HBM_BYTES_PER_S * 1e6})
                say("timer " + json.dumps(results[-1]) + f"; on {smi}")
                return best["variant"]

            n = MAIN_GRID * MAIN_GRID
            for w in TIMER_WIDTHS:
                cols, vals = random_ell(n, w, w, torch.float64, gen)
                x = torch.randn(n, generator=gen, device="cuda", dtype=torch.float64)
                X = torch.randn(MAIN_BATCH, n, generator=gen, device="cuda",
                                dtype=torch.float64)
                mat = cols.numel() * 4 + vals.numel() * 8
                cands = [{"variant": v} for v in ell_spmv.SPMV_VARIANTS]
                won = tune("ell_spmv", (n, w), cands,
                           lambda variant: lambda: ell_spmv.ell_spmv(cols, vals, x, variant),
                           mat + 2 * n * 8)
                won_k = tune("ell_spmm", (n, w, MAIN_BATCH), cands,
                             lambda variant: lambda: ell_spmv.ell_spmm(cols, vals, X, variant),
                             mat + 2 * MAIN_BATCH * n * 8)
                # the wrappers now launch the recorded winners
                picked = (ell_spmv.pick_variant("ell_spmv", cols, vals, None),
                          ell_spmv.pick_variant("ell_spmm", cols, vals, None,
                                                MAIN_BATCH))
                if picked != (won, won_k):
                    raise AssertionError(f"W = {w}: the wrappers pick {picked}, "
                                         f"the timer recorded {(won, won_k)}")
                del cols, vals, x, X
            m = laplacian_2d(MAIN_GRID)
            for b in TIMER_BLOCKS:
                bc, bl = bcsr_arrays_from_csr(m, bm=b, bn=b, dtype=np.float64)
                bc, bl = torch.from_numpy(bc).cuda(), torch.from_numpy(bl).cuda()
                nbr, w = bc.shape
                nbc = -(-n // b)
                for r in (1, MAIN_BATCH):
                    X = torch.randn(r, nbc * b, generator=gen, device="cuda",
                                    dtype=torch.float64).T   # the solver layout
                    cands = [{"variant": v} for v in bcsr_spmm.BCSR_VARIANTS]
                    tune("bcsr_spmm", (nbr, w, b, b, r), cands,
                         lambda variant, X=X: lambda: bcsr_spmm.bcsr_spmm(
                             bc, bl, X, nbc=nbc, variant=variant),
                         bl.numel() * 8 + bc.numel() * 4 + (nbc * b + nbr * b) * r * 8)
                del bc, bl
            losers = [r for r in results if r["winner"] != (
                "rows" if r["op"] != "bcsr_spmm" else "smem")]
            say(f"timer ok: {len(results)} cases, the cache in a temporary "
                f"directory; the variant the shape rule picks lost in "
                f"{len(losers)}: " + json.dumps(
                    [(r["op"], r["shape"], r["winner"]) for r in losers])
                + "; ell_spmv and ell_spmm pick the recorded winners")
        launch_floor(smi)
    except Exception:
        traceback.print_exc()
        failed.append("timer")
    finally:
        if prev is None:
            os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE", None)
        else:
            os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = prev
        autotune.clear_memo()
    torch.cuda.empty_cache()
    say(f"roofline phase: {now() - t_phase:.1f} s")


def launch_floor(smi: str) -> dict:
    """11c's probe: a CUDA graph of LEVEL_PROBE one-element in-place adds,
    and one of LEVEL_PROBE no-work kernels each launched programmatic-
    dependent on the one before (csrc/sptrsv.cu pdl_noop_kernel: the
    wait and the trigger, one count), each replayed TIMER_REPS times after
    a warm replay; the microseconds a node, by CUDA events (the counts
    checked from the tensors' values).  The second is the floor under a
    chain of sptrsv_level_step's new design."""
    import gc

    import torch
    from repro_torch.kernels import build, sptrsv

    dev = torch.device("cuda")
    sptrsv.pdl_ready(dev)
    probe = torch.zeros(1, device="cuda")
    count = torch.zeros(1, dtype=torch.int64, device="cuda")
    noop = build.plain_entry("repro_pdl_noop")

    def pdl_one():
        build.check(noop(count.data_ptr(), 1, build.stream_handle(dev)),
                    "pdl_noop")

    us = {}
    for name, one, tensor in (("add", lambda: probe.add_(1.0), probe),
                              ("pdl", pdl_one, count)):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            one()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                for _ in range(LEVEL_PROBE):
                    one()
        finally:
            gc.enable()
        graph.replay()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(TIMER_REPS):
            graph.replay()
        e1.record()
        torch.cuda.synchronize()
        want = 1 + LEVEL_PROBE * (1 + TIMER_REPS)
        if float(tensor) != want:
            raise AssertionError(f"launch floor ({name}): {float(tensor)} "
                                 f"nodes ran, {want} launched")
        us[name] = e0.elapsed_time(e1) * 1e3 / (TIMER_REPS * LEVEL_PROBE)
        del graph
    say(f"launch floor: a graph of {LEVEL_PROBE} one-element adds replays in "
        f"{us['add'] * LEVEL_PROBE / 1e3:.4f} ms, {us['add']:.4f} us a node; "
        f"{LEVEL_PROBE} no-work kernels chained by programmatic dependent "
        f"launch in {us['pdl'] * LEVEL_PROBE / 1e3:.4f} ms, {us['pdl']:.4f} "
        f"us a node (sptrsv_level_step's bytes bound 0.0428 us a level); "
        f"on {smi}")
    return us


def mesh_reference(cfg, opt_name: str, shape, steps: int = MESH_STEPS) -> dict:
    """The one-process counterpart of ``launch.train.train_on_mesh`` on the
    card: the same seed-0 model, optimizer and batches, ``steps``
    donated steps in the launcher's own ``train_loop``; losses, grad
    norms, each step's ms (ended by reading its loss) and (f32) the params
    as numpy."""
    import torch

    from repro_torch import convert
    from repro_torch import train as T
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import make_optimizer, train_loop
    from repro_torch.models import model as M

    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    opt = make_optimizer(opt_name, 3e-3, steps)
    state = T.init_train_state(params, opt)
    del params
    out = {"grad_norms": []}
    state, out["losses"], times = train_loop(
        state, T.build_train_step(cfg, opt, donate=True),
        TokenPipeline(cfg.vocab_size, *shape, seed=0), steps, verbose=False,
        on_step=lambda i, m: out["grad_norms"].append(float(m["grad_norm"])))
    out["step_ms"] = [1e3 * t for t in times]
    if cfg.param_dtype == "float32":
        out["params"] = convert.lm_params_to_numpy(state.params)
    return out


def _held_is_gathered(state, full, pls) -> bool:
    """Every tensor this rank holds equals its slice of the gathered
    state, bit for bit (the slices other ranks sent equal this rank's)."""
    import torch

    from repro_torch.launch.sharding import tree_leaves
    from repro_torch.models.model import LayerStack

    whole = lambda v: torch.stack(list(v)) if isinstance(v, LayerStack) else v
    for f in ("params", "opt_state"):
        mine, got = tree_leaves(getattr(state, f)), tree_leaves(getattr(full, f))
        for path, pl in getattr(pls, f).items():
            if not torch.equal(whole(mine[path]).cpu(), whole(got[path])[pl.held]):
                return False
    return True


def mesh_full_cfg(label: str):
    """The config of MESH_FULL's cell ``label``: the published one, cut to
    its layers."""
    from repro_torch.configs import get

    arch, layers, _, _ = MESH_FULL[label]
    return get(arch) if layers is None else get(arch).replace(n_layers=layers)


def mesh_options(variant: str) -> dict:
    """The train step's options of a phase-12 variant ("sp", "ep",
    "sp,ep"; the dry run's tokens)."""
    toks = set(filter(None, variant.split(",")))
    return {"seq_parallel": "sp" in toks, "ep_stationary": "ep" in toks}


def mesh_case_key(arch: str, opt_name: str, variant: str) -> str:
    return f"{arch} {opt_name}" + (f" {variant}" if variant else "")


def meshtrain_rank(rank, t_spawn: float, feed=None) -> dict:
    """A rank of phase 12 (module docstring): ``launch.train.
    train_on_mesh`` on the 2x2 grid, 12a's smoke configs (gathered after)
    then MESH_FULL's cells (12b, 12c, 12d); then phase 15's serving
    (:func:`meshserve_rank`; ``feed``, 15b's teacher-forced tokens, None
    where the parent could not make them)."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_smoke
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.train import train_on_mesh
    from repro_torch.obs.clock import now

    keep = ("losses", "grad_norms", "step_ms", "wire_bytes", "stage_s",
            "comm_s", "held_bytes", "device_bytes", "build_peak_bytes",
            "peak_bytes", "fwd_bwd_ms", "split_kinds")
    out = {"rank": rank.rank, "start_s": now() - t_spawn, "parity": {}, "full": {}}
    mesh = rank.mesh(MESH_GRID, MESH_AXES)
    t0 = now()
    for arch, opt_name, variant in MESH_PARITY:
        cfg = get_smoke(arch).replace(param_dtype="float32", compute_dtype="float32")
        res = train_on_mesh(mesh, cfg, steps=MESH_PARITY_STEPS, batch=MESH_PARITY_SHAPE[0],
                            seq=MESH_PARITY_SHAPE[1], optimizer=opt_name,
                            **mesh_options(variant))
        full = SH.gather(res["state"], res["placements"])
        got = {k: res[k] for k in keep}
        got["params"] = convert.lm_params_to_numpy(full.params)
        got["held_is_gathered"] = _held_is_gathered(res["state"], full, res["placements"])
        out["parity"][mesh_case_key(arch, opt_name, variant)] = got
        del res, full
    out["parity_s"] = now() - t0
    for label, (_, _, opt_name, variant) in MESH_FULL.items():
        torch.cuda.empty_cache()
        t0 = now()
        res = train_on_mesh(mesh, mesh_full_cfg(label), steps=MESH_STEPS,
                            batch=MESH_FULL_SHAPE[0], seq=MESH_FULL_SHAPE[1],
                            optimizer=opt_name, **mesh_options(variant))
        out["full"][label] = {k: res[k] for k in keep}
        out["full"][label]["s"] = now() - t0
        del res
    torch.cuda.empty_cache()
    try:
        out["serve"] = meshserve_rank(mesh, feed)
    except Exception:
        out["serve"] = {"error": traceback.format_exc()}
    return out


def serve_mesh_cfg(cid: str):
    """15a's case ``cid``: its f32 smoke config, before its variant."""
    from repro_torch.configs import get_smoke

    arch, _, _, widths = SERVE_MESH[cid]
    return get_smoke(arch).replace(param_dtype="float32", compute_dtype="float32",
                                   **widths)


def serve_full_cfg():
    from repro_torch.configs import get

    arch, layers, _ = SERVE_FULL
    return get(arch) if layers is None else get(arch).replace(n_layers=layers)


def meshserve_rank(mesh, feed) -> dict:
    """Phase 15 on a rank of phase 12's spawn (module docstring):
    ``serve_on_mesh`` for 15a's cases, then 15b."""
    import torch

    from repro_torch.launch.serve import serve_on_mesh
    from repro_torch.obs.clock import now

    keep = ("tokens", "logits", "wire_bytes", "stage_s", "comm_s", "held_bytes",
            "device_bytes", "prefill_ms", "decode_ms", "peak_bytes", "max_len")
    out = {"parity": {}}
    t0 = now()
    b, s, g = SERVE_MESH_SHAPE
    for cid, (_, variant, ml, _) in SERVE_MESH.items():
        res = serve_on_mesh(mesh, serve_mesh_cfg(cid), batch=b, prompt_len=s, gen=g,
                            variant=variant, max_len=ml)
        out["parity"][cid] = {k: res[k] for k in keep}
    out["parity_s"] = now() - t0
    if feed is None:
        return out
    torch.cuda.empty_cache()
    t0 = now()
    b, s, g = SERVE_FULL_SHAPE
    res = serve_on_mesh(mesh, serve_full_cfg(), batch=b, prompt_len=s, gen=g,
                        variant=SERVE_FULL[2], feed=feed)
    out["full"] = {k: res[k] for k in keep}
    out["full"]["s"] = now() - t0
    return out


def serve_reference(cfg, shape, max_len=None, keep_params: bool = False) -> dict:
    """The one-process generation on the card of ``serve_on_mesh``'s run:
    the seed-0 model, its prompts (``default_rng(0)``, ids from 1),
    greedy; tokens, each step's last logits (f32 numpy), the prefill's
    and each decode step's ms (each ended by a sync) and the peak memory
    above what was allocated before (and with ``keep_params`` the
    model)."""
    import numpy as np
    import torch

    from repro_torch.models import model as M
    from repro_torch.obs.clock import now
    from repro_torch.serve import generate

    b, s, g = shape
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompts = np.random.default_rng(0).integers(1, cfg.vocab_size, size=(b, s))
    out = {"logits": [], "ms": []}
    t = [0.0]

    def on_step(i, logits, caches):
        torch.cuda.synchronize()
        out["ms"].append(1e3 * (now() - t[0]))
        out["logits"].append(logits[:, -1].float().cpu().numpy())
        t[0] = now()

    t[0] = now()
    toks = generate(params, cfg, torch.as_tensor(prompts, device="cuda"), g,
                    max_len=max_len, on_step=on_step)
    out["tokens"] = toks.cpu().numpy()
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    if keep_params:
        out["params"] = params
        return out
    del params
    torch.cuda.empty_cache()
    return out


def serve_full_reference(cfg) -> dict:
    """15b's one-process references (module docstring): the bf16 run of
    :func:`serve_reference`, then on the same weights its halves of the
    batch and the f32 run (the weights cast up), both decoding its
    tokens; ``bf16_vs_f32`` (``{"batch", "halves"}``: each step's logit
    error of the bf16 runs against the f32 run) and ``halves_vs_bf16``."""
    import numpy as np
    import torch

    from repro_torch.models import model as M
    from repro_torch.serve import generate

    b, s, g = SERVE_FULL_SHAPE
    out = serve_reference(cfg, SERVE_FULL_SHAPE, keep_params=True)
    params = out.pop("params")
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, size=(b, s)), device="cuda")
    toks = torch.as_tensor(out["tokens"], device="cuda")

    def forced(p, c, rows):
        got = []
        generate(p, c, prompts[rows], g, feed=toks[rows, :g - 1],
                 on_step=lambda i, lg, _: got.append(lg[:, -1].float().cpu().numpy()))
        return got

    halves = [forced(params, cfg, slice(0, b // 2)), forced(params, cfg, slice(b // 2, b))]
    with torch.no_grad():
        for prm in params.parameters():
            prm.data = prm.data.float()
    out["f32_logits"] = forced(params, cfg.replace(param_dtype="float32",
                                                   compute_dtype="float32"), slice(0, b))
    del params
    torch.cuda.empty_cache()
    halves = [np.concatenate(h) for h in zip(*halves)]
    out["halves_vs_bf16"] = logit_errs(halves, out["logits"])
    out["bf16_vs_f32"] = {"batch": logit_errs(out["logits"], out["f32_logits"]),
                          "halves": logit_errs(halves, out["f32_logits"])}
    return out


def logit_errs(got, want) -> list:
    """Each step's max |got - want| over max |want|."""
    import numpy as np

    return [float(np.abs(a - w).max() / np.abs(w).max()) for a, w in zip(got, want)]


def meshserve_refs(failed: list) -> tuple:
    """Phase 15's one-process references on the card (15a's cases, then
    15b's run where the ranks' weights fit beside what the card holds)
    and 15b's teacher-forced tokens (None where 15b cannot run); a
    failure adds "meshserve" to ``failed``."""
    import torch

    from repro_torch.launch.dryrun import _parse_variant
    from repro_torch.models import model as M

    refs, feed = {}, None
    try:
        for cid, (_, variant, ml, _) in SERVE_MESH.items():
            cfg = serve_mesh_cfg(cid)
            if _parse_variant(variant)["int8kv"]:
                cfg = cfg.replace(kv_cache_dtype="int8")
            refs[cid] = serve_reference(cfg, SERVE_MESH_SHAPE, ml)
        free, total_mem = torch.cuda.mem_get_info()
        cfg = serve_full_cfg()
        weights = 2 * M.param_count(M.init_params(cfg, None, "meta"))
        need = 4 * (weights / 2 + SERVE_FULL_MARGIN)
        say(f"meshserve 15b: {free / 1e9:.1f} of {total_mem / 1e9:.1f} GB free "
            f"before the spawn; the ranks need about {need / 1e9:.1f} GB "
            f"({weights / 2e9:.2f} GB of weights a rank)")
        if free < max(need, weights + SERVE_FULL_MARGIN):
            raise RuntimeError("15b does not fit: cut SERVE_FULL's layers")
        refs["full"] = serve_full_reference(cfg)
        feed = refs["full"]["tokens"][:, :SERVE_FULL_SHAPE[2] - 1]
    except Exception:
        traceback.print_exc()
        failed.append("meshserve")
    return refs, feed


def meshserve_report(ranks: list, refs: dict, smi: str) -> list:
    """Phase 15's checks and lines (module docstring); the failed parts."""
    import numpy as np

    from repro_torch.launch.dryrun import _parse_variant
    from repro_torch.launch.sharding import MeshShape
    from repro_torch.models import model as M
    from repro_torch.roofline.collect import serve_step_bytes

    bad = []
    if any("error" in r["serve"] for r in ranks):
        say("meshserve rank error: " + next(r["serve"]["error"] for r in ranks
                                           if "error" in r["serve"]))
        return ["meshserve ranks"]
    grid = MeshShape(dict(zip(MESH_AXES, MESH_GRID)))

    def model_bytes(cfg, variant, shape, max_len):
        var = _parse_variant(variant)
        if var["int8kv"]:
            cfg = cfg.replace(kv_cache_dtype="int8")
        if var["nofsdp"]:
            cfg = cfg.replace(fsdp=False)
        params = M.init_params(cfg, None, "meta")
        kw = dict(max_len=max_len, seq_parallel=var["sp"], ep_stationary=var["ep"])
        pre = serve_step_bytes(cfg, params, grid, "prefill", shape[0], shape[1], **kw)
        dec = serve_step_bytes(cfg, params, grid, "decode", shape[0], shape[1],
                               pick=True, **kw)
        return pre, dec

    def err(got, want):
        return max(float(np.abs(a - w).max() / np.abs(w).max())
                   for a, w in zip(got, want))

    b, s, g = SERVE_MESH_SHAPE
    for cid, (arch, variant, ml, _) in SERVE_MESH.items():
        got = [r["serve"]["parity"][cid] for r in ranks]
        r0, ref = got[0], refs[cid]
        pre, dec = model_bytes(serve_mesh_cfg(cid), variant, SERVE_MESH_SHAPE,
                               r0["max_len"])
        pre_t, dec_t = pre.pop("total_bytes"), dec.pop("total_bytes")
        e = err(r0["logits"], ref["logits"])
        same = all(all(np.array_equal(a, c) for a, c in zip(x["logits"], r0["logits"]))
                   and np.array_equal(x["tokens"], r0["tokens"]) for x in got)
        ok = (np.array_equal(r0["tokens"], ref["tokens"]) and e <= SERVE_MESH_RTOL
              and same and all(x["held_bytes"] == x["device_bytes"] for x in got)
              and all(x["wire_bytes"][0] == pre and all(w == dec for w in x["wire_bytes"][1:])
                      for x in got))
        if not ok:
            bad.append(f"15a {cid}")
        say(f"meshserve 15a {cid} ({arch}{', ' + variant if variant else ''}, f32 "
            f"smoke, {b} x {s}, {g} tokens, max_len {r0['max_len']}, 2x2, 4 gloo ranks): "
            f"tokens equal the one-process run's on the card "
            f"{bool(np.array_equal(r0['tokens'], ref['tokens']))}; logits {e:.2e} of "
            f"max|logit| (tol {SERVE_MESH_RTOL}); ranks bitwise {same}; held "
            f"{[x['held_bytes'] for x in got]} = device_bytes {r0['device_bytes']}; "
            f"prefill bytes {sum(r0['wire_bytes'][0].values())} (model {pre_t}), a "
            f"decode step {sum(r0['wire_bytes'][1].values())} (model {dec_t}) "
            f"{r0['wire_bytes'][1]}; prefill {r0['prefill_ms']:.1f} ms, decode "
            f"{float(np.median(r0['decode_ms'])):.1f} ms a step")
    say(f"meshserve 15a: {ranks[0]['serve']['parity_s']:.1f} s on rank 0")
    if "full" not in ranks[0]["serve"] or "full" not in refs:
        return bad + ["15b not run"]
    got = [r["serve"]["full"] for r in ranks]
    r0, ref = got[0], refs["full"]
    b, s, g = SERVE_FULL_SHAPE
    arch, layers, variant = SERVE_FULL
    cfg = serve_full_cfg()
    pre, dec = model_bytes(cfg, variant, SERVE_FULL_SHAPE, r0["max_len"])
    pre_t, dec_t = pre.pop("total_bytes"), dec.pop("total_bytes")
    errs = logit_errs(r0["logits"], ref["logits"])
    errs32 = logit_errs(r0["logits"], ref["f32_logits"])
    bf16 = max(max(e) for e in ref["bf16_vs_f32"].values())
    tol32 = SERVE_FULL_F32_FACTOR * bf16
    agree = float(np.mean([np.mean(np.argmax(a, -1) == np.argmax(w, -1))
                           for a, w in zip(r0["logits"], ref["logits"])]))
    dms = float(np.median(r0["decode_ms"]))
    stage = 1e3 * float(np.median(r0["stage_s"][1:]))
    comm = 1e3 * float(np.median(r0["comm_s"][1:]))
    ok = (max(errs32) <= tol32
          and all(np.isfinite(x).all() for x in r0["logits"])
          and all(x["held_bytes"] == x["device_bytes"] for x in got)
          and all(x["wire_bytes"][0] == pre and all(w == dec for w in x["wire_bytes"][1:])
                  for x in got))
    if not ok:
        bad.append("15b")
    full = {"arch": arch, "layers": cfg.n_layers, "variant": variant,
            "shape": SERVE_FULL_SHAPE, "max_logit_rel_err": max(errs),
            "logit_rel_err": errs, "within_plan_rtol": max(errs) <= SERVE_FULL_RTOL,
            "halves_vs_bf16": ref["halves_vs_bf16"], "logit_rel_err_f32": errs32,
            "bf16_vs_f32": ref["bf16_vs_f32"], "tol_f32": tol32,
            "f32_ratio": max(errs32) / bf16,
            "argmax_agreement": agree,
            "prefill_ms": r0["prefill_ms"], "decode_ms": r0["decode_ms"],
            "decode_ms_median": dms, "stage_ms": stage, "gloo_ms": comm,
            "rest_ms": dms - stage - comm,
            "prefill_bytes": r0["wire_bytes"][0], "decode_bytes": r0["wire_bytes"][1],
            "model_prefill": pre, "model_decode": dec,
            "held_bytes": [x["held_bytes"] for x in got],
            "device_bytes": r0["device_bytes"],
            "peak_bytes": [x["peak_bytes"] for x in got],
            "one_process_ms": ref["ms"], "one_process_peak_bytes": ref["peak_bytes"],
            "cell_s": r0["s"]}
    say("meshserve 15b " + json.dumps(full))
    say(f"meshserve 15b {arch} ({cfg.n_layers} layers, published width, bf16, "
        f"{variant}, {b} x {s}, {g} tokens teacher-forced) on 2x2, 4 gloo ranks on "
        f"one card: prefill {r0['prefill_ms']:.1f} ms, decode {dms:.1f} ms a step "
        f"(median; staging {stage:.1f}, gloo {comm:.1f}, rest {dms - stage - comm:.1f}; "
        f"the one-process run's {ref['ms'][0]:.1f} and "
        f"{float(np.median(ref['ms'][1:])):.1f}); a rank receives "
        f"{sum(r0['wire_bytes'][1].values()) / 1e3:.1f} kB a decode step (model "
        f"{dec_t / 1e3:.1f}) and {sum(r0['wire_bytes'][0].values()) / 1e6:.2f} MB in "
        f"the prefill (model {pre_t / 1e6:.2f}); logits within {max(errs32):.2e} of "
        f"max|logit| of the f32 run's (tol {tol32:.2e}: {SERVE_FULL_F32_FACTOR} x the "
        f"one-process bf16 runs' {bf16:.2e}; ratio {max(errs32) / bf16:.3f}), "
        f"{max(errs):.2e} of the bf16 run's (within {SERVE_FULL_RTOL}: "
        f"{max(errs) <= SERVE_FULL_RTOL}; its halves {max(ref['halves_vs_bf16']):.2e}), "
        f"argmax agreement {agree:.4f}; held "
        f"{[x['held_bytes'] for x in got]} against device_bytes {r0['device_bytes']}; "
        f"peaks {[round(x['peak_bytes'] / 1e9, 2) for x in got]} GB; on {smi}")
    return bad


def meshtrain_full(label: str, got: list, ref: dict, ranks: list, model_bytes,
                   smi: str) -> bool:
    """Checks and prints MESH_FULL's cell ``label`` (``got``: each rank's
    ``train_on_mesh`` numbers, ``ref``: the one-process step's on the card);
    True where every check holds."""
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.models import model as M

    arch, layers, opt_name, variant = MESH_FULL[label]
    cfg = mesh_full_cfg(label)
    r0 = got[0]
    opts = mesh_options(variant)
    total, want = model_bytes(cfg, opt_name, MESH_FULL_SHAPE, **opts)
    without = model_bytes(cfg, opt_name, MESH_FULL_SHAPE)[0] if variant else None
    # a rank builds its state one drawn tensor at a time: its slices
    # and at most one whole f32 draw and that draw's slice
    meta = M.init_params(cfg, None, "meta")
    draw = 4 * max(p.numel() for p in meta.parameters())
    e_loss = float(np.max(np.abs(np.subtract(r0["losses"], ref["losses"]))
                          / np.abs(ref["losses"])))
    warm = float(np.median(r0["step_ms"][1:]))
    stage = 1e3 * float(np.median(r0["stage_s"][1:]))
    comm = 1e3 * float(np.median(r0["comm_s"][1:]))
    ok = (e_loss <= MESH_FULL_LOSS_RTOL
          and all(np.isfinite(g["losses"]).all() for g in got)
          and all(g["losses"] == r0["losses"] for g in got)
          and all(g["held_bytes"] == g["device_bytes"] for g in got)
          and all(w == want for g in got for w in g["wire_bytes"])
          and all(g["build_peak_bytes"] <= g["device_bytes"] + 2 * draw
                  for g in got)
          and (not opts["ep_stationary"]
               or sum(r0["wire_bytes"][1].values()) <= MESH_EP_MAX_BYTES))
    full = {"params": M.param_count(meta), "optimizer": opt_name,
            "losses": r0["losses"], "one_process_losses": ref["losses"],
            "one_process_step_ms": ref["step_ms"],
            "loss_rel_err": e_loss, "step_ms": [g["step_ms"] for g in got],
            "warm_step_ms": warm, "stage_ms": stage, "gloo_ms": comm,
            "rest_ms": warm - stage - comm,
            "wire_bytes_per_step": r0["wire_bytes"][1], "model_bytes": total,
            "model_by_call": want, "variant": variant,
            "model_bytes_without_variant": without,
            "split_kinds": r0["split_kinds"],
            "fwd_bwd_ms": [g["fwd_bwd_ms"] for g in got],
            "held_bytes": [g["held_bytes"] for g in got],
            "device_bytes": r0["device_bytes"],
            "build_peak_bytes": [g["build_peak_bytes"] for g in got],
            "build_bound_bytes": r0["device_bytes"] + 2 * draw,
            "peak_bytes": [g["peak_bytes"] for g in got],
            "rank_start_s": [r["start_s"] for r in ranks],
            "cell_s": r0["s"], "reference_s": ref["s"]}
    say(f"meshtrain {label} " + json.dumps(full))
    cut = "all" if layers is None else f"{layers} of {get(arch).n_layers}"
    beside = "" if without is None else (
        f"; {variant}: the same cell without it is modelled at "
        f"{without / 1e6:.1f} MB a rank a step, {total / without:.3f} of it kept")
    say(f"meshtrain {label} {arch} ({cut} layers, published width, bf16, "
        f"{opt_name}{', ' + variant if variant else ''}, {MESH_FULL_SHAPE[0]} x "
        f"{MESH_FULL_SHAPE[1]}) on 2x2, 4 gloo ranks "
        f"on one card: {warm:.1f} ms a step (median of steps 2-{MESH_STEPS}; staging "
        f"{stage:.1f}, gloo {comm:.1f}, rest {warm - stage - comm:.1f}; the "
        f"one-process step {float(np.median(ref['step_ms'][1:])):.1f}); a rank "
        f"receives {sum(r0['wire_bytes'][1].values()) / 1e6:.1f} MB a step (model "
        f"{total / 1e6:.1f}; by call "
        f"{ {k: round(v / 1e6, 3) for k, v in r0['wire_bytes'][1].items()} } MB); "
        f"forward+backward by CUDA events "
        f"{[round(float(np.median(g['fwd_bwd_ms'][1:])), 1) for g in got]} ms a rank; "
        f"building the state peaks at "
        f"{[round(g['build_peak_bytes'] / 1e9, 2) for g in got]} GB, the steps at "
        f"{[None if g['peak_bytes'] is None else round(g['peak_bytes'] / 1e9, 2) for g in got]} GB; "
        f"held {[g['held_bytes'] for g in got]} bytes against device_bytes "
        f"{r0['device_bytes']} a rank; losses "
        f"{[round(x, 4) for x in r0['losses']]} against the one-process "
        f"{[round(x, 4) for x in ref['losses']]} ({e_loss:.2e}, tol "
        f"{MESH_FULL_LOSS_RTOL}); split {r0['split_kinds']}{beside}; on {smi}")
    return ok


def meshtrain_phase(failed: list) -> None:
    """Phase 12: the LM train state on a 2x2 process grid (module
    docstring).  Any check that fails adds "meshtrain" to ``failed``."""
    import numpy as np
    import torch

    from repro_torch import train as T
    from repro_torch.configs import get_smoke
    from repro_torch.launch import procs
    from repro_torch.launch.sharding import MeshShape
    from repro_torch.models import model as M
    from repro_torch.obs.clock import now
    from repro_torch.roofline.collect import train_step_bytes

    t_phase = now()
    smi = smi_line()
    try:
        f32 = lambda c: c.replace(param_dtype="float32", compute_dtype="float32")
        cases = {mesh_case_key(a, o, v): (f32(get_smoke(a)), o, v)
                 for a, o, v in MESH_PARITY}
        t0 = now()
        # one reference an (arch, optimizer): the variants' numbers are the
        # step's without them
        refs = {}
        for a, o, _ in MESH_PARITY:
            if (a, o) not in refs:
                refs[a, o] = mesh_reference(f32(get_smoke(a)), o, MESH_PARITY_SHAPE,
                                            MESH_PARITY_STEPS)
        full_refs = {}
        for label, (arch, layers, opt_name, _) in MESH_FULL.items():
            same = next((k for k, c in MESH_FULL.items() if k in full_refs
                         and c[:3] == (arch, layers, opt_name)), None)
            if same is not None:
                full_refs[label] = full_refs[same]
                continue
            t1 = now()
            full_refs[label] = mesh_reference(mesh_full_cfg(label), opt_name,
                                              MESH_FULL_SHAPE)
            full_refs[label]["s"] = now() - t1
            torch.cuda.empty_cache()
        ref_s = now() - t0
        # phase 15's references on the card, before the ranks start
        t0 = now()
        serve_refs, feed = meshserve_refs(failed)
        serve_ref_s = now() - t0
        t0 = now()
        ranks = procs.run(meshtrain_rank, MESH_GRID[0] * MESH_GRID[1], (t0, feed),
                          backend="gloo", device="cuda", timeout_s=MESH_DEADLINE_S)
        run_s = now() - t0
        grid = MeshShape(dict(zip(MESH_AXES, MESH_GRID)))

        def model_bytes(cfg, opt_name, shape, **opts):
            state = T.init_train_state(M.init_params(cfg, None, "meta"),
                                       getattr(T, opt_name)(T.warmup_cosine(1e-3, 1, 2)))
            want = train_step_bytes(cfg, state, grid, batch=shape, **opts)
            return want.pop("total_bytes"), want

        bad = []
        rel = lambda a, b: float(np.max(np.abs(np.subtract(a, b)) / np.abs(b)))
        for key, (cfg, opt_name, variant) in cases.items():
            ref = refs[key.split(" ")[0], opt_name]
            got = [r["parity"][key] for r in ranks]
            r0 = got[0]
            e_loss, e_gn = rel(r0["losses"], ref["losses"]), rel(r0["grad_norms"], ref["grad_norms"])
            e_p = max(float(np.abs(r0p - w).max() / np.abs(w).max())
                      for r0p, w in zip(_np_leaves(r0["params"]), _np_leaves(ref["params"])))
            total, want = model_bytes(cfg, opt_name, MESH_PARITY_SHAPE,
                                      **mesh_options(variant))
            same = all(g["losses"] == r0["losses"] and g["grad_norms"] == r0["grad_norms"]
                       and all(np.array_equal(a, b) for a, b in
                               zip(_np_leaves(g["params"]), _np_leaves(r0["params"])))
                       for g in got)
            if not (e_loss <= MESH_RTOL and e_gn <= MESH_RTOL
                    and e_p <= MESH_PARAM_TOL[opt_name] and same
                    and all(g["held_is_gathered"] for g in got)
                    and all(g["held_bytes"] == g["device_bytes"] for g in got)
                    and all(w == want for g in got for w in g["wire_bytes"])):
                bad.append(key)
            say(f"meshtrain 12a {key} (f32 smoke, {MESH_PARITY_STEPS} steps, 2x2, 4 gloo "
                f"ranks): loss {e_loss:.2e}, grad_norm {e_gn:.2e} of the one-process "
                f"step's; params {e_p:.2e} of max|p| (tol {MESH_PARAM_TOL[opt_name]}); "
                f"ranks bitwise equal {same}; held bytes "
                f"{[g['held_bytes'] for g in got]} = device_bytes "
                f"{r0['device_bytes']}; wire bytes a step {sum(r0['wire_bytes'][0].values())} "
                f"(model {total}) {r0['wire_bytes'][0]}; split {r0['split_kinds']}")
        for label in MESH_FULL:
            if not meshtrain_full(label, [r["full"][label] for r in ranks],
                                  full_refs[label], ranks, model_bytes, smi):
                bad.append(label)
        say(f"meshtrain times: references {ref_s:.1f} s (phase 15's "
            f"{serve_ref_s:.1f}), ranks {run_s:.1f} s (12a "
            f"{ranks[0]['parity_s']:.1f} s on rank 0)")
        try:
            served = meshserve_report(ranks, serve_refs, smi)
        except Exception:
            traceback.print_exc()
            served = ["meshserve report"]
        if served:
            say(f"phase 15 checks failed: {served}")
            if "meshserve" not in failed:
                failed.append("meshserve")
        if bad:
            raise AssertionError(f"phase 12 checks failed: {bad}")
    except Exception:
        traceback.print_exc()
        failed.append("meshtrain")
    say(f"meshtrain phase: {now() - t_phase:.1f} s")


def ft_grid_solve(engines: dict, meshes: dict, case: dict, ckdir=None,
                  fault: bool = True):
    """One PROC_FT case on ``meshes[case["mesh"]]`` (a TileMesh or a rank's
    ProcessMesh; its engine built once into ``engines``): the
    FTSolveReport of ``ft.SolveRestartManager``."""
    import numpy as np
    import scipy.sparse as sp

    from repro_torch import ft
    from repro_torch.core.engine import AzulEngine
    from repro_torch.core.plan import SolveSpec
    from repro_torch.data.matrices import laplacian_2d

    m = laplacian_2d(case["grid"])
    key = (case["grid"], case["mesh"], case["mode"])
    if key not in engines:
        _, _, ra, ca = DIST_MESHES[case["mesh"]]
        engines[key] = AzulEngine(m, mesh=meshes[case["mesh"]],
                                  mode=case["mode"], row_axes=ra, col_axes=ca,
                                  dtype=np.float64)
    eng = engines[key]
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    b = a @ np.random.default_rng(case["x_seed"]).standard_normal(m.shape[0])
    mgr = ft.SolveRestartManager(
        eng, SolveSpec(method=case["method"], tol=PROC_FT_TOL,
                       max_iters=PROC_FT_BUDGET),
        chunk=case["chunk"], max_restarts=case.get("max_restarts", 3),
        checkpoint_dir=ckdir)
    inj = (ft.FaultInjector(eng, ft.FaultSpec(**case["fault"]))
           if fault and case["fault"] is not None else None)
    return mgr.solve(b, injector=inj)


def proc_ft_cases(engines: dict, meshes: dict, root: str, rank: int = 0) -> dict:
    """13a's solves on ``meshes``: each PROC_FT case, then PROC_FT_CKPT's
    two runs on one directory under ``root``; each report's fields, x's
    digest and (``rank`` 0) x."""
    def row(rep):
        return {"summary": ft_summary(rep), "resumed_from": rep.resumed_from,
                "digest": _digest(rep.x), "x": rep.x if rank == 0 else None}

    got = [row(ft_grid_solve(engines, meshes, case)) for case, _ in PROC_FT]
    case, d = PROC_FT_CKPT[0], os.path.join(root, "13a")
    got.append(row(ft_grid_solve(engines, meshes, case, d)))
    got.append(row(ft_grid_solve(engines, meshes, case, d, fault=False)))
    return got


def nan_once(step_fn, at: int, pipe):
    """``step_fn`` reporting a NaN loss the first time it is given batch
    ``at`` (tests/test_torch_train_ft.py's)."""
    import numpy as np

    bad = pipe.batch_at(at)["tokens"]
    seen = []

    def step(state, batch):
        new, m = step_fn(state, batch)
        if not seen and np.array_equal(np.asarray(batch["tokens"]), bad):
            seen.append(1)
            m = dict(m, loss=m["loss"] * float("nan"))
        return new, m

    step.donate = step_fn.donate
    return step


def proc_ft_smoke(mesh, root: str) -> dict:
    """13c's f32 smoke case under ``ft.RestartManager``: on ``mesh`` (a
    rank's ProcessMesh) the placed state, else the one-process state on
    the card; the counts (resumed_from, final step, losses kept,
    rollbacks) and the losses."""
    import torch

    from repro_torch import ft
    from repro_torch import train as T
    from repro_torch.configs import get_smoke
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import make_optimizer, placed_state
    from repro_torch.models import model as M

    cfg = get_smoke(TRAIN_FULL).replace(param_dtype="float32",
                                        compute_dtype="float32")
    opt = make_optimizer("adamw", 3e-3, PROC_FT_SMOKE_STEPS)
    if mesh is None:
        state = T.init_train_state(M.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"), opt)
        pls, kw = None, {}
    else:
        state, pls, _ = placed_state(mesh, cfg, opt)
        kw = {"grad_shardings": pls.params}
    step_fn = T.build_train_step(cfg, opt, donate=True, **kw)
    pipe = TokenPipeline(cfg.vocab_size, *PROC_FT_SMOKE_SHAPE, seed=0)
    rm = ft.RestartManager(os.path.join(root, "13c_smoke"),
                           save_every=PROC_FT_SAVE_EVERY)
    res = rm.run(state, nan_once(step_fn, PROC_FT_NAN_AT, pipe), pipe,
                 PROC_FT_SMOKE_STEPS, placements=pls)
    return {"counts": [res.resumed_from, int(res.state.step), len(res.losses),
                       res.nan_rollbacks], "losses": res.losses}


def proc_ft_full_engine(mesh):
    """13b's engine on ``mesh`` and its b: laplacian_3d(PROC_GRID) on the
    2x2 halo grid, b = A x with x from default_rng(0)."""
    import numpy as np
    import scipy.sparse as sp

    from repro_torch.core.engine import AzulEngine
    from repro_torch.data.matrices import laplacian_3d

    m = laplacian_3d(PROC_GRID)
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    b = a @ np.random.default_rng(0).standard_normal(m.shape[0])
    _, _, ra, ca = DIST_MESHES["2x2"]
    return AzulEngine(m, mesh=mesh, mode="2d", row_axes=ra, col_axes=ca,
                      dtype=np.float64, layout="halo"), b


def proc_ft_full(eng, b, ckdir: str, timer: bool = False):
    """13b's fault-tolerant solve: f64 Jacobi pcg_tol at MAIN_TOL in chunks
    of FT_CHUNK, a halo_perturb at FT_AT (seed 1), checkpointed into
    ``ckdir``; (the manager, the report)."""
    from repro_torch import ft
    from repro_torch.core.plan import SolveSpec

    mgr = ft.SolveRestartManager(
        eng, SolveSpec(method="pcg_tol", tol=MAIN_TOL, max_iters=SERVE_BUDGET),
        chunk=FT_CHUNK, checkpoint_dir=ckdir,
        timer=ft.StepTimer() if timer else None)
    inj = ft.FaultInjector(eng, ft.FaultSpec(kind="halo_perturb",
                                             iteration=FT_AT, seed=1))
    return mgr, mgr.solve(b, injector=inj)


def proc_serve_parity(mesh) -> dict:
    """14a's script on ``mesh`` (a rank's ProcessMesh, or the one-process
    TileMesh) in the halo layout: per request its iterations and status,
    x end to end and its digest, and the service's counts."""
    import numpy as np

    from repro_torch.data.matrices import suite
    from repro_torch.serve import SolveService

    script = SERVICE_PARITY[PROC_SERVE]
    m = suite("small")[PROC_SERVE]
    svc = SolveService(max_batch=script["max_batch"], chunk=script["chunk"],
                       device=mesh.device)
    svc.register_operator(PROC_SERVE, m, layout="halo", mesh=mesh,
                          **dict(SERVICE_OPERATOR, dtype=np.float64))
    outs = service_script(svc, m, script)
    x = np.concatenate([o.x for o in outs])
    return {"iters": tuple(int(o.iters) for o in outs),
            "status": tuple(o.status for o in outs), "x": x,
            "digest": _digest(x), "ticks": svc.stats["ticks"],
            "chunks": svc.stats["chunks"]}


def proc_serve_cli(processes: bool) -> tuple:
    """``launch.serve PROC_SERVE_ARGV`` in this process (with
    ``--processes``: a rank under torchrun's environment, which joins the
    group): (exit code, the JSON it printed, or None)."""
    import contextlib
    import io

    from repro_torch.launch import serve as serve_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = serve_cli.main(PROC_SERVE_ARGV
                              + (["--processes"] if processes else []))
    text = buf.getvalue()
    return code, json.loads(text[text.index("{"):]) if "{" in text else None


def proc_serve_rhs(n: int):
    """14b's PROC_SERVE_DRAIN right-hand sides: b = A x, the x rows from
    default_rng(0) (phase 6's first rows)."""
    import numpy as np
    import scipy.sparse as sp

    from repro_torch.data.matrices import laplacian_3d

    m = laplacian_3d(PROC_GRID)
    a = sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)
    xs = np.random.default_rng(0).standard_normal((PROC_SERVE_DRAIN, n))
    return np.ascontiguousarray((a @ xs.T).T)


def proc_serve_drain(eng, rhs, keep_x: bool) -> dict:
    """14b on ``eng`` (a rank's grid engine or the one-process grid's):
    the rows of ``rhs`` submitted and drained through a service; solves/s,
    each request's latency from submit (this process's clock), the
    outcomes (x where ``keep_x``), the bytes this rank received each tick
    by NoC call (``mesh.stats``, a process grid), the kernel launches and
    the card's peak allocation of the drain alone (counts and peak reset
    just before the first submit, read just after the last tick), and,
    a chunk's wall by part: the drain's chunks (the service's own
    ``repro_serve_chunk_seconds``, its mean), the host copies in and
    out at the first batch's k_pad timed apart after the drain, the mean
    chunk less those copies (``program_est``: not timed inside a chunk),
    and the clock collectives a tick and a chunk add (``_agreed``)."""
    import numpy as np
    import torch

    from repro_torch.core.plan import SolveSpec
    from repro_torch.kernels import ops
    from repro_torch.obs.clock import now
    from repro_torch.serve import SolveService
    from repro_torch.serve.service import _M_CHUNK_S

    grid = eng.mesh.per_process
    svc = SolveService(max_batch=SERVE_BATCH, chunk=SERVE_CHUNK,
                       queue_max=None, device=eng.device)
    svc.register_operator("lap3d", engine=eng, spec=SolveSpec(
        method="pcg_tol", tol=MAIN_TOL, max_iters=SERVE_BUDGET))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    sent = {svc.submit(row): now() for row in rhs}
    done, finished, ticks = {}, {}, []
    t0 = now()
    while svc.pending() or svc.active():
        if grid:
            eng.mesh.stats.reset()
        out = svc.tick()
        if grid:
            ticks.append(dict(eng.mesh.stats.wire_bytes))
        done.update(out)
        finished.update({rid: now() for rid in out})
    drain_s = now() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    lat = np.array([finished[r] - sent[r] for r in sent]) * 1e3
    x = np.concatenate([done[r].x for r in sent])
    got = {"drain_s": drain_s, "solves_per_s": len(sent) / drain_s,
           "p50_ms": float(np.percentile(lat, 50)), "max_ms": float(lat.max()),
           "iters": [int(done[r].iters) for r in sent],
           "status": [done[r].status for r in sent], "digest": _digest(x),
           "x": x if keep_x else None, "ticks": svc.stats["ticks"],
           "chunks": svc.stats["chunks"], "tick_bytes": ticks,
           "launches": launches, "peak_bytes": peak}
    chunk = _M_CHUNK_S.labels(service=svc._obs_label)
    chunk_s = chunk.sum / chunk.count
    k_pad = svc._bucket(len(rhs), SERVE_BATCH)
    batch = np.zeros((k_pad, eng.n))
    batch[: len(rhs)] = rhs[:k_pad]
    t0 = now()
    xd = eng.to_device_vec(batch), eng.to_device_vec(batch)
    torch.cuda.synchronize()
    eng.from_device_vec(xd[1])
    copies = now() - t0
    t0 = now()
    svc._agreed(now())
    svc._agreed(now(), 0.0)
    clock = now() - t0
    got["split_ms"] = {"chunk_mean": chunk_s * 1e3,
                       "program_est": (chunk_s - copies) * 1e3,
                       "host_copies": copies * 1e3, "tick_clock": clock * 1e3}
    return got


def proc_serve_rank(mesh, eng, rank: int, size: int) -> dict:
    """Phase 14 on a rank of phase 13's spawn: 14a's script and CLI, then
    14b's drain on ``eng`` (13b's engine); each part's launch counts
    zeroed just before it and read just after, and its wall."""
    from repro_torch.kernels import ops
    from repro_torch.obs.clock import now

    out = {}
    t0 = now()
    ops.reset_launch_counts()
    out["a"] = proc_serve_parity(mesh)
    out["a_launches"] = ops.launch_counts()
    out["a_s"] = now() - t0
    if rank:
        out["a"]["x"] = None
    t0 = now()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size))
    out["cli"] = proc_serve_cli(True)
    out["cli_s"] = now() - t0
    t0 = now()
    out["b"] = proc_serve_drain(eng, proc_serve_rhs(eng.n), keep_x=rank == 0)
    out["b_launches"] = out["b"]["launches"]
    out["b_s"] = now() - t0
    return out


def procserve_report(ranks: list, refs: dict, smi: str) -> list:
    """Phase 14's checks and lines: the ranks' results (``ranks[r]
    ["serve"]``) against the one-process grid's (``refs``); the names of
    the checks that failed."""
    import numpy as np

    say(f"procserve 14 on {smi}")
    bad = []
    rs = [r["serve"] for r in ranks]
    s0, script = rs[0], SERVICE_PARITY[PROC_SERVE]
    # -- 14a
    got, one = s0["a"], refs["s_a"]
    rel = float(np.abs(got["x"] - one["x"]).max() / np.abs(one["x"]).max())
    same = all(r["a"]["digest"] == got["digest"] and r["a"]["iters"] == got["iters"]
               and r["a"]["status"] == got["status"] for r in rs)
    if not (got["iters"] == one["iters"] == script["iters"]
            and got["status"] == one["status"] == script["status"]
            and rel <= PROC_SERVE_RTOL and same):
        bad.append("14a parity")
    say(f"procserve 14a {PROC_SERVE} script (chunk {script['chunk']}, max_batch "
        f"{script['max_batch']}) on the 2x2 halo grid, 4 gloo ranks: iters "
        f"{list(got['iters'])} (one-process grid {list(one['iters'])}, JAX "
        f"{list(script['iters'])}), status {sorted(set(got['status']))}, x "
        f"{rel:.2e} of the one-process grid's, ranks bitwise {same}, "
        f"{got['ticks']} ticks / {got['chunks']} chunks in {s0['a_s']:.1f} s "
        f"(one-process grid {refs['s_a_s']:.1f} s)")
    (code, many), (ocode, one_json) = s0["cli"], refs["s_cli"]
    ok = code == ocode == 0 and many is not None and one_json is not None
    if ok:
        many = dict(many)
        ok = many.pop("processes", None) == 4 and set(many) == set(one_json)
        for k, v in (one_json.items() if ok else ()):
            if k == "verify_maxerr":
                ok = ok and abs(many[k] - v) <= 1e-6 * abs(v)
            elif k not in PROC_SERVE_TIMES:
                ok = ok and many[k] == v
        ok = ok and all(r["cli"] == (0, None) for r in rs[1:])
    if not ok:
        bad.append("14a launch.serve --processes")
    say(f"procserve 14a launch.serve {' '.join(PROC_SERVE_ARGV)} --processes: "
        f"rank 0 {json.dumps(s0['cli'][1])}; one process {json.dumps(one_json)}; "
        f"{'as' if ok else 'NOT as'} the one-process grid's with processes "
        f"added ({s0['cli_s']:.1f} s)")
    # -- 14b
    got, one = s0["b"], refs["s_b"]
    rel = float(np.abs(got["x"] - one["x"]).max() / np.abs(one["x"]).max())
    same = all(r["b"]["digest"] == got["digest"] and r["b"]["iters"] == got["iters"]
               for r in rs)
    if not (got["status"] == one["status"] == ["converged"] * PROC_SERVE_DRAIN
            and got["iters"] == one["iters"] and rel <= PROC_RTOL and same):
        bad.append("14b drain")
    per_tick = [sum(t.values()) for t in got["tick_bytes"]]
    say(f"procserve 14b laplacian_3d({PROC_GRID}) 2x2 halo, {PROC_SERVE_DRAIN} "
        f"requests, max_batch {SERVE_BATCH}, chunk {SERVE_CHUNK}, 4 gloo ranks on "
        f"{smi}: " + json.dumps({
            "solves_per_s": got["solves_per_s"], "drain_s": got["drain_s"],
            "latency_p50_ms": got["p50_ms"], "latency_max_ms": got["max_ms"],
            "iters": got["iters"], "one_process_iters": one["iters"],
            "x_rel": rel, "ranks_bitwise": same,
            "ticks": got["ticks"], "chunks": got["chunks"],
            "chunk_split_ms_rank0": got["split_ms"],
            "wire_bytes_a_tick_rank0": {"mean": float(np.mean(per_tick)),
                                        "max": max(per_tick),
                                        "second_tick": got["tick_bytes"][1]
                                        if len(per_tick) > 1 else None},
            "wire_bytes_a_tick_mean": [float(np.mean([sum(t.values())
                                                      for t in r["b"]["tick_bytes"]]))
                                       for r in rs],
            "max_memory_allocated": [r["b"]["peak_bytes"] for r in rs],
            "one_process_grid": {"solves_per_s": one["solves_per_s"],
                                 "drain_s": one["drain_s"],
                                 "latency_p50_ms": one["p50_ms"],
                                 "latency_max_ms": one["max_ms"],
                                 "chunk_split_ms": one["split_ms"]},
            "wall_s": [r["b_s"] for r in rs]}))
    # -- the launches: every rank ran the grid's kernels in each part
    for part in ("a", "b"):
        counts = [r[f"{part}_launches"] for r in rs]
        need = ("ell_spmm", "cg_update_batched")
        if not all(c.get(k, 0) > 0 for c in counts for k in need):
            bad.append(f"14{part} launches")
        say(f"procserve 14{part} launches a rank: " + json.dumps(
            [{k: c.get(k, 0) for k in PROC_SERVE_KERNELS} for c in counts]))
    return bad


def _held_equal(a, b) -> bool:
    """Every tensor two placed states hold bit for bit equal."""
    import torch

    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.models.model import LayerStack

    fa, fb = _flatten(a), _flatten(b)
    whole = lambda v: torch.stack(list(v)) if isinstance(v, LayerStack) else v
    return fa.keys() == fb.keys() and all(
        torch.equal(whole(fa[k]), whole(fb[k])) for k in fa)


def procft_rank(rank, t_spawn: float, root: str, go: str) -> dict:
    """A rank of phase 13 (module docstring): 13a's solves on the 2x2 and
    4x1 grids, then (once the file ``go`` exists: the parent's references
    are done) 13b's full-size solve and 13c's training."""
    import gc
    import time

    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get
    from repro_torch.core.plan import SolveSpec
    from repro_torch.kernels import ops
    from repro_torch.launch.sharding import tree_leaves
    from repro_torch.launch.train import train_on_mesh
    from repro_torch.obs.clock import now

    r = rank.rank
    out = {"rank": r, "start_s": now() - t_spawn}
    meshes = {name: rank.mesh(*DIST_MESHES[name][:2]) for name in ("2x2", "4x1")}
    mesh = meshes["2x2"]
    # -- 13a: the launch counts zeroed just before, read just after
    t0 = now()
    ops.reset_launch_counts()
    out["a"] = proc_ft_cases({}, meshes, root, r)
    out["a_launches"] = ops.launch_counts()
    out["a_s"] = now() - t0
    # -- 13b
    t0 = now()
    eng, b = proc_ft_full_engine(mesh)
    out["b_build_s"] = now() - t0
    t0 = now()
    while not os.path.exists(go):
        if now() - t0 > PROC_DEADLINE_S:
            raise TimeoutError(f"no {go} after {PROC_DEADLINE_S} s")
        time.sleep(0.05)
    out["wait_s"] = now() - t0
    plain = eng.plan(SolveSpec(method="pcg_tol", tol=MAIN_TOL,
                               max_iters=SERVE_BUDGET))
    t0 = now()
    plain(b)
    out["b_uninterrupted"] = {"s": now() - t0, "iters": int(plain.last_iters),
                              "status": plain.last_status_names}
    del plain
    ops.reset_launch_counts()
    t0 = now()
    mgr, rep = proc_ft_full(eng, b, os.path.join(root, "13b"), timer=True)
    out["b_s"] = now() - t0
    out["b_launches"] = ops.launch_counts()
    out["b"] = {"summary": ft_summary(rep), "digest": _digest(rep.x),
                "x": rep.x if r == 0 else None,
                "rel_residual": rep.rel_residual,
                "stragglers": rep.straggler_chunks}
    # a chunk by part, on this rank's host clock: the plan call (a chunk of
    # FT_CHUNK steps from zero), the audit, a checkpoint save to disk
    bnorm = float(np.linalg.norm(b))
    eng.mesh.stats.reset()
    t0 = now()
    mgr._plan(b)
    parts = {"plan_call_s": now() - t0,
             "wire_bytes": sum(eng.mesh.stats.wire_bytes.values())}
    t0 = now()
    mgr._true_rel(rep.x, b, bnorm)
    parts["audit_s"] = now() - t0
    t0 = now()
    mgr._save(rep.x, b, 10 ** 6)
    mgr.mgr.wait()
    parts["save_s"] = now() - t0
    out["b_parts"] = parts
    del mgr, meshes                 # 13b's engine serves again in 14b
    gc.collect()
    torch.cuda.empty_cache()
    # -- 13c: a failure at step 1, a fresh state resumed, an uninterrupted run
    cfg = get(TRAIN_FULL).replace(n_layers=PROC_FT_TRAIN_LAYERS)
    kw = dict(steps=PROC_FT_TRAIN_STEPS, batch=MESH_FULL_SHAPE[0],
              seq=MESH_FULL_SHAPE[1], optimizer="adafactor")
    d = os.path.join(root, "13c")
    t0 = now()
    try:
        train_on_mesh(mesh, cfg, ckpt_dir=d, save_every=1, inject_failure_at=1,
                      **kw)
        out["c_raised"] = None
    except RuntimeError as e:
        out["c_raised"] = str(e)
    out["c_failed_run_s"] = now() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = now()
    res = train_on_mesh(mesh, cfg, ckpt_dir=d, save_every=1, **kw)
    out["c_resumed_s"] = now() - t0
    out["c"] = {k: res[k] for k in ("losses", "resumed_from", "nan_rollbacks",
                                    "checkpoint", "peak_bytes", "step_ms",
                                    "held_bytes")}
    # restored == saved, leaf by leaf for a few leaves of each kind (bf16
    # params, the f32 optimizer state, the step): step 2 read back onto
    # the placements against the state the resumed run saved
    pls, state = res["placements"], res["state"]
    pick, like, whole = {}, {}, state.step.element_size()
    for f in ("params", "opt_state"):
        leaves, held = tree_leaves(getattr(pls, f)), tree_leaves(getattr(state, f))
        for path, pl in leaves.items():
            t = held[path][0] if isinstance(held[path], list) else held[path]
            whole += int(np.prod(pl.shape)) * t.element_size()
        for path in sorted(leaves, key=str)[:: max(1, len(leaves) // 3)]:
            pick[("." + f,) + tuple(path)] = leaves[path]
            like[("." + f,) + tuple(path)] = held[path]
    got, used = CheckpointManager(d, mesh=mesh).restore(like, pick)
    out["c_restored"] = {"step": used, "leaves": len(pick),
                         "equal": _held_equal(got, like)}
    out["c_state_bytes"] = whole
    if r == 0:
        with open(os.path.join(d, f"step_{used:08d}", "manifest.json")) as f:
            man = json.load(f)
        out["c_ckpt_bytes"] = sum(
            int(np.prod(v["shape"])) * (2 if v["dtype"] == "bfloat16"
                                        else np.dtype(v["dtype"]).itemsize)
            for v in man["leaves"].values())
    # this process's peak RSS since it started (ru_maxrss would carry the
    # parent's across the spawn's exec); None where the kernel's status
    # file has no VmHWM line (not measured)
    with open("/proc/self/status") as f:
        hwm = [int(line.split()[1]) * 1024 for line in f
               if line.startswith("VmHWM:")]
    out["c_host_peak_bytes"] = hwm[0] if hwm else None
    saved_state = state
    del res, state, got, like
    gc.collect()
    torch.cuda.empty_cache()
    t0 = now()
    ref = train_on_mesh(mesh, cfg, **kw)
    out["c_reference_s"] = now() - t0
    out["c_reference_losses"] = ref["losses"]
    out["c_final_equal"] = _held_equal(ref["state"], saved_state)
    del ref, saved_state
    gc.collect()
    torch.cuda.empty_cache()
    t0 = now()
    out["c_smoke"] = proc_ft_smoke(mesh, root)
    out["c_smoke_s"] = now() - t0
    gc.collect()
    torch.cuda.empty_cache()
    # -- 14: the solve service on the grid
    t0 = now()
    out["serve"] = proc_serve_rank(mesh, eng, r, rank.size)
    out["serve_s"] = now() - t0
    return out


def procft_phase(failed: list) -> None:
    """Phase 13: fault tolerance on a 2x2 process grid (module docstring).
    Any check that fails adds "procft" to ``failed``."""
    import numpy as np

    from repro_torch.launch import procs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs.clock import now

    t_phase = now()
    smi = smi_line()
    bad = []
    from repro_torch.kernels import build

    build.library()             # here, before the ranks' thread needs it
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as ex:
        go = os.path.join(tmp, "go")
        ranks_dir = os.path.join(tmp, "ranks")
        t0 = now()
        run = ex.submit(procs.run, procft_rank, 4, (t0, ranks_dir, go),
                        backend="gloo", device="cuda",
                        timeout_s=PROC_FT_DEADLINE_S)
        # the one-process grid's references on the card (13a-13c's and
        # 14's), while the ranks start and run 13a
        refs = {}
        try:
            meshes = {name: make_mesh(*DIST_MESHES[name][:2])
                      for name in ("2x2", "4x1")}
            t1 = now()
            refs["a"] = proc_ft_cases({}, meshes, os.path.join(tmp, "one"))
            refs["a_s"] = now() - t1
            t1 = now()
            one_eng, b = proc_ft_full_engine(meshes["2x2"])
            _, rep = proc_ft_full(one_eng, b, os.path.join(tmp, "one", "13b"))
            refs["b"] = {"summary": ft_summary(rep), "x": rep.x,
                         "s": now() - t1}
            refs["c_smoke"] = proc_ft_smoke(None, os.path.join(tmp, "one"))
            # 14a's one-process grid references
            t1 = now()
            refs["s_a"] = proc_serve_parity(meshes["2x2"])
            refs["s_a_s"] = now() - t1
            refs["s_cli"] = proc_serve_cli(False)
            # 14b's one-process grid drain, on 13b's engine
            t1 = now()
            refs["s_b"] = proc_serve_drain(one_eng, proc_serve_rhs(one_eng.n),
                                           keep_x=True)
            refs["s_b_s"] = now() - t1
        except Exception:
            traceback.print_exc()
            failed.append("procft one-process references")
        finally:
            one_eng = None
            Path(go).touch()
        try:
            ranks = run.result()
        except Exception:
            traceback.print_exc()
            failed.append("procft ranks")
            ranks = []
        run_s = now() - t0
    if not ranks or not all(k in refs for k in ("a", "b", "c_smoke")):
        say(f"procft phase: {now() - t_phase:.1f} s")
        return
    r0 = ranks[0]
    try:
        # -- 13a
        names = [f"{c['mesh']} {c['method']} {(c['fault'] or {}).get('kind')}"
                 for c, _ in PROC_FT] + ["2x2 ckpt gave up", "2x2 ckpt resumed"]
        wants = ([w for _, w in PROC_FT] + [PROC_FT_CKPT[1], PROC_FT_CKPT[2][0]])
        rows = []
        for i, (name, want) in enumerate(zip(names, wants)):
            got, one = r0["a"][i], refs["a"][i]
            rel = float(np.abs(got["x"] - one["x"]).max() / np.abs(one["x"]).max())
            same = all(r["a"][i]["digest"] == got["digest"]
                       and r["a"][i]["summary"] == got["summary"] for r in ranks)
            ok = (got["summary"] == one["summary"] == want and rel <= PROC_RTOL
                  and same)
            if i == len(names) - 1:
                ok = ok and got["resumed_from"] == one["resumed_from"] \
                    == PROC_FT_CKPT[2][1]
            if not ok:
                bad.append(f"13a {name}")
            rows.append(f"{name}: {got['summary']} (one-process grid "
                        f"{'same' if got['summary'] == one['summary'] else one['summary']}, "
                        f"JAX {'same' if got['summary'] == want else want}), x "
                        f"{rel:.2e}, ranks bitwise {same}")
        launches = [{k: r["a_launches"].get(k, 0) for k in ("ell_spmv", "cg_update")}
                    for r in ranks]
        if not all(v > 0 for d in launches for v in d.values()):
            bad.append("13a launches")
        say("procft 13a (4 gloo ranks on the card; reports as the one-process grid's "
            "on the card and the JAX package's): " + "; ".join(rows))
        say(f"procft 13a launches a rank: {json.dumps([r['a_launches'] for r in ranks])}")
        # -- 13b
        got, one = r0["b"], refs["b"]
        rel = float(np.abs(got["x"] - one["x"]).max() / np.abs(one["x"]).max())
        same = all(r["b"]["digest"] == got["digest"] and r["b"]["summary"] == got["summary"]
                   and r["b"]["stragglers"] == got["stragglers"] for r in ranks)
        if not (got["summary"] == one["summary"] and got["summary"][0] == "converged"
                and same):
            bad.append("13b")
        say(f"procft 13b laplacian_3d({PROC_GRID}) 2x2 halo, halo_perturb at {FT_AT} "
            f"(chunk {FT_CHUNK}, checkpointed), 4 gloo ranks on {smi}: "
            + json.dumps({
                "report": got["summary"], "one_process_report": one["summary"],
                "x_rel": rel, "ranks_bitwise": same,
                "stragglers": got["stragglers"], "wall_s": r0["b_s"],
                "uninterrupted": r0["b_uninterrupted"],
                "one_process_ft_s": one["s"], "chunk_parts_rank0": r0["b_parts"],
                "wire_bytes_a_chunk": [r["b_parts"]["wire_bytes"] for r in ranks],
                "launches": [r["b_launches"] for r in ranks],
                "build_s": [r["b_build_s"] for r in ranks],
                "wait_s": [r["wait_s"] for r in ranks]}))
        # -- 13c
        c = r0["c"]
        ckpt = c["checkpoint"]
        ok = (all(r["c_raised"] == "injected failure at step 1" for r in ranks)
              and c["resumed_from"] == 1 and c["nan_rollbacks"] == 0
              and c["losses"] == r0["c_reference_losses"][1:]
              and all(r["c"]["losses"] == c["losses"] for r in ranks)
              and all(r["c_final_equal"] and r["c_restored"]["equal"] for r in ranks)
              and r0["c_ckpt_bytes"] == r0["c_state_bytes"]
              and all(r["c"]["checkpoint"]["host_bytes"] == 0 for r in ranks[1:])
              and ckpt["host_bytes"] == r0["c_state_bytes"])
        if not ok:
            bad.append("13c")
        say(f"procft 13c {TRAIN_FULL} ({PROC_FT_TRAIN_LAYERS} of 40 layers, bf16, Adafactor, "
            f"{MESH_FULL_SHAPE[0]} x {MESH_FULL_SHAPE[1]}, 2x2) on {smi}: " + json.dumps({
                "raised": [r["c_raised"] for r in ranks],
                "resumed_from": c["resumed_from"], "resumed_losses": c["losses"],
                "uninterrupted_losses": r0["c_reference_losses"],
                "resumed_final_state_bitwise": [r["c_final_equal"] for r in ranks],
                "restored_leaves_bitwise": [r["c_restored"] for r in ranks],
                "checkpoint_bytes": r0["c_ckpt_bytes"],
                "state_bytes": r0["c_state_bytes"],
                "save_ms": 1e3 * (ckpt["gather_s"] + ckpt["write_s"]),
                "save_gather_ms": 1e3 * ckpt["gather_s"],
                "save_write_ms": 1e3 * ckpt["write_s"],
                "restore_ms": [1e3 * r["c"]["checkpoint"]["restore_s"] for r in ranks],
                "rank0_host_bytes": ckpt["host_bytes"],
                "host_peak_bytes": [r["c_host_peak_bytes"] for r in ranks],
                "card_peak_bytes": [r["c"]["peak_bytes"] for r in ranks],
                "held_bytes": [r["c"]["held_bytes"] for r in ranks],
                "step_ms": c["step_ms"],
                "failed_run_s": r0["c_failed_run_s"], "resumed_run_s": r0["c_resumed_s"],
                "reference_s": r0["c_reference_s"]}))
        s, one = r0["c_smoke"], refs["c_smoke"]
        e = float(np.max(np.abs(np.subtract(s["losses"], one["losses"]))
                         / np.abs(one["losses"])))
        if not (s["counts"] == one["counts"] and s["counts"][3] == 1 and e <= MESH_RTOL
                and all(r["c_smoke"] == s for r in ranks)):
            bad.append("13c smoke")
        say(f"procft 13c f32 smoke {TRAIN_FULL}, AdamW, NaN at {PROC_FT_NAN_AT}, "
            f"save_every {PROC_FT_SAVE_EVERY}: counts {s['counts']} (one process "
            f"{one['counts']}), losses {e:.2e} of the one-process manager's (tol {MESH_RTOL})")
        say(f"procft 13 times: ranks {run_s:.1f} s (slowest start "
            f"{max(r['start_s'] for r in ranks):.1f}, 13a {r0['a_s']:.1f}, 13b build "
            f"{r0['b_build_s']:.1f} wait {r0['wait_s']:.1f} solve {r0['b_s']:.1f}, 13c "
            f"{r0['c_failed_run_s']:.1f} + {r0['c_resumed_s']:.1f} + "
            f"{r0['c_reference_s']:.1f} + smoke {r0['c_smoke_s']:.1f}); "
            f"one-process references 13a {refs['a_s']:.1f} s, 13b {refs['b']['s']:.1f} s")
    except Exception:
        traceback.print_exc()
        bad.append("checks raised")
    if bad:
        say(f"procft 13 FAILED checks: {bad}")
        failed.append("procft")
    # -- 14: the solve service on the grid
    try:
        bad = procserve_report(ranks, refs, smi)
    except Exception:
        traceback.print_exc()
        bad = ["checks raised"]
    say(f"procserve 14 times: ranks {json.dumps([round(r['serve_s'], 1) for r in ranks])} s "
        f"(rank 0: 14a {r0['serve']['a_s']:.1f}, cli {r0['serve']['cli_s']:.1f}, "
        f"14b {r0['serve']['b_s']:.1f}); one-process grid 14a "
        f"{refs['s_a_s']:.1f} s, 14b {refs['s_b_s']:.1f} s")
    if bad:
        say(f"procserve 14 FAILED checks: {bad}")
        failed.append("procserve")
    say(f"procft phase (13 and 14): {now() - t_phase:.1f} s")


def _np_leaves(tree) -> list:
    """The numpy leaves of a nested dict/list tree, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _np_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _np_leaves(v)]
    return [tree]


def say_phase(label: str, t0: float) -> float:
    """Print ``label: N s`` since ``t0``; the time now."""
    from repro_torch.obs.clock import now

    t = now()
    say(f"{label}: {t - t0:.1f} s")
    return t


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


def level_solve(cols, vals, diag, b, rows, n: int, inplace: bool,
                variant=None):
    """x (n + 1,) solved level by level with sptrsv_level_step: through
    ``ops`` (a new x each level), or in place (``out=x``) with the
    wrapper's ``variant``."""
    import torch
    from repro_torch.kernels import ops, sptrsv

    x = torch.zeros(n + 1, dtype=vals.dtype, device=vals.device)
    for lv in rows:
        if inplace:
            sptrsv.sptrsv_level_step(cols, vals, diag, b, x, lv, out=x,
                                     variant=variant)
        else:
            x = ops.sptrsv_level_step(cols, vals, diag, b, x, lv)
    return x


def check_level_rewrite(cols, vals, diag, b, rows, n: int, label: str) -> str:
    """The in-place level solve with ``b`` rewritten on the stream before
    each level -- a copy (a memcpy) on odd levels, a multiply by 1 (a
    kernel) on even ones, and NaN written over it after each level -- eager
    and captured into one CUDA graph (replayed on an x of 7s): both
    bitwise the solve without the rewrites.  A read of b that came before
    the rewrite had landed would see NaN.  Returns what was checked."""
    import gc

    import torch
    from repro_torch.kernels import sptrsv

    want = level_solve(cols, vals, diag, b, rows, n, inplace=True)
    bw, nan = b.clone(), torch.full_like(b, float("nan"))
    x = torch.zeros(n + 1, dtype=vals.dtype, device=vals.device)

    def chain():
        x.zero_()
        for i, lv in enumerate(rows):
            if i % 2:
                bw.copy_(b)
            else:
                torch.mul(b, 1.0, out=bw)
            sptrsv.sptrsv_level_step(cols, vals, diag, bw, x, lv, out=x)
            bw.copy_(nan)

    chain()
    if not torch.equal(x, want):
        raise AssertionError(f"sptrsv_level_step {label}: the eager solve "
                             "with b rewritten before each level differs")
    graph = torch.cuda.CUDAGraph()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            chain()
    finally:
        gc.enable()
    x.fill_(7.0)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(x, want):
        raise AssertionError(f"sptrsv_level_step {label}: the graph of the "
                             "solve with b rewritten before each level differs")
    del graph
    aligned = (cols.data_ptr() | vals.data_ptr()) % 16 == 0
    return (f"variant {sptrsv.level_step_variant(cols.shape[1], vals.dtype, aligned)}"
            f", b rewritten before each of {len(rows)} levels: eager and "
            "graph bitwise the solve without it")


def check_level_step(ell, rows, n: int, dtype: str, gen, label: str):
    """sptrsv_level_step on one factor: each level against its plain
    version from the same x, within the tolerance, and bitwise against the
    first design; the functional and the in-place solves, a second
    in-place solve and the first design's in-place solve bitwise equal;
    the solved x within RTOL x max|x| of sptrsv_solve_dot's (which
    multiplies by the inverse diagonal).  Returns (max abs error of a
    level, of the solve)."""
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
        if not torch.equal(got, sptrsv.sptrsv_level_step(
                cols, vals, diag, b, x, lv, variant="first")):
            raise AssertionError(f"sptrsv_level_step {label}: a level differs "
                                 "from the first design's bits")
        x = got
    rows = torch.as_tensor(rows, device=vals.device)
    x_in = level_solve(cols, vals, diag, b, rows, n, inplace=True)
    if not (torch.equal(x, x_in)
            and torch.equal(x_in, level_solve(cols, vals, diag, b, rows, n,
                                              inplace=True))
            and torch.equal(x_in, level_solve(cols, vals, diag, b, rows, n,
                                              inplace=True, variant="first"))):
        raise AssertionError(f"sptrsv_level_step {label}: the functional and "
                             "in-place solves, two solves, or the first "
                             "design's solve differ")
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

    # -- 6f. the CLI: the drain and the load generator side by side ------------
    try:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--solver",
               "--operators", "lap2d_96,banded_10k", "--requests", "12",
               "--iters", "2000", "--tol", "1e-10"]
        extras = ([], ["--load-gen", "open", "--rate", "50", "--requests", "40"])
        t0 = now()
        with ThreadPoolExecutor(len(extras)) as ex:
            runs = list(ex.map(lambda extra: subprocess.run(
                cmd + extra, env=env, capture_output=True, text=True,
                timeout=600, cwd=ROOT), extras))
        for extra, r in zip(extras, runs):
            if r.returncode != 0:
                raise AssertionError(f"launch.serve {extra}: exit "
                                     f"{r.returncode}\n{r.stderr[-3000:]}")
            out = json.loads(r.stdout)
            say(f"service CLI {' '.join(extra) or 'drain'} (both {now() - t0:.1f} "
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
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    failed: list[str] = []
    card, smi, rows_out, lm = earlier_phases(failed)
    # phases 1-9's engines, plans, graphs and pools go with their frame
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- 10. LM training ----------------------------------------------------------
    trained = train_phase(failed)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 11. the roofline, the dry run and the timer -----------------------------
    roofline_phase(failed, lm, trained)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 12. the LM train state on a process grid (and 15, LM serving there) ------
    meshtrain_phase(failed)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 13. fault tolerance on a process grid ------------------------------------
    procft_phase(failed)

    if failed:
        say("FAILED phases: " + ", ".join(failed))
        return 1
    say(json.dumps({"kernels": rows_out}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


def earlier_phases(failed: list) -> tuple:
    """Phases 1-9; returns (card name, nvidia-smi line, the kernels JSON
    rows, phase 9b's measurements).  Everything they build lives in this
    frame and goes with it."""
    import torch
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

    card = torch.cuda.get_device_name(0)
    smi = smi_line()
    say(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")
    t_mark = now()

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

    t_mark = say_phase("phase 1 (build)", t_mark)
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
            lvals = f.ell_l.vals.to(getattr(torch, dname))
            bl = torch.zeros(lvals.shape[0], dtype=lvals.dtype, device="cuda")
            bl[:f.n] = torch.randn(f.n, generator=gen, device="cuda",
                                   dtype=lvals.dtype)
            say(f"sptrsv_level_step {dname} lap2d_1024 L: " + check_level_rewrite(
                f.ell_l.cols, lvals, factor_diag(f.ell_l).to(lvals.dtype), bl,
                torch.as_tensor(f.sched_l.rows, device="cuda"), f.n,
                f"{dname} lap2d_1024 L"))
            del lvals, bl
            if dname == "float64":
                main_errs["sptrsv_level_step"] = errs[key][0]
            say(f"sptrsv_level_step {dname}: max abs err (a level, the solve "
                "vs sptrsv_solve_dot) " + json.dumps(errs))
        say("ops kernels ok (rtol f64 1e-12, f32 1e-5; axpy_dot's z, the "
            "layouts, lane j vs k = 1, second launches, the in-place solve, "
            "the level step's first design and its solve with b rewritten "
            "bitwise equal)")
    except Exception:
        traceback.print_exc()
        failed.append("kernels ops-only")

    t_mark = say_phase("phases 2-2d (kernels)", t_mark)
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

    t_mark = say_phase("phases 3-3d (parity)", t_mark)
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
        # lap2d_1024 that is minutes, so it runs at lap2d_128
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

    t_mark = say_phase("phases 4-4i (main path)", t_mark)
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
        # factor, then the whole solve, one launch a level: the first
        # design against the new one in mirrored order (first, new, new,
        # first), the levers of the new one between
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
        w_l = lcols.shape[1]
        new_v = sptrsv.level_step_variant(
            w_l, lvals.dtype, (lcols.data_ptr() | lvals.data_ptr()) % 16 == 0)

        def one_of(variant, pdl=True):
            return lambda: sptrsv.sptrsv_level_step(
                lcols, lvals, diag, bl, xs, lv, out=xs, variant=variant,
                pdl=pdl)

        def full_of(variant, pdl=True):
            def full():
                xs.zero_()
                for lvl in srows:
                    sptrsv.sptrsv_level_step(lcols, lvals, diag, bl, xs, lvl,
                                             out=xs, variant=variant, pdl=pdl)
            return full

        # (label, variant, pdl) in run order: the A/B mirrored, and between
        # its halves the new design without PDL and with scalar row loads
        cases = [("first", "first", True), (new_v, new_v, True),
                 (f"{new_v} no PDL", new_v, False), ("wave", "wave", True),
                 (new_v, new_v, True), ("first", "first", True)]
        runs = [(label, device_ms(one_of(variant, pdl)),
                 device_ms(full_of(variant, pdl), reps=1, windows=5))
                for label, variant, pdl in cases]
        best = lambda label, i: min(r[i] for r in runs if r[0] == label)
        one_ms, full_graph = best(new_v, 1), best(new_v, 2)
        one_first, full_first = best("first", 1), best("first", 2)
        one_eager = eager_ms(one_of(None))
        full_eager = eager_ms(full_of(None), reps=2, windows=3)
        one_plain = eager_ms(lambda: sptrsv.sptrsv_level_step_plain(
            lcols, lvals, diag, bl, xs, lv), reps=10, windows=3)
        # what one level needs: its distinct factor rows (cols, vals, b,
        # diag), the x entries they gather, the ids, the values written
        lr = torch.clamp(lv.long(), max=lcols.shape[0] - 1)
        u_rows = torch.unique(lr)
        u_x = torch.unique(torch.clamp(lcols[u_rows].long(), max=n))
        u_out = torch.unique(lv[lv <= n])
        nbytes = (u_rows.numel() * w_l * (4 + e) + 2 * u_rows.numel() * e
                  + lv.numel() * 4 + u_x.numel() * e + u_out.numel() * e)
        one_bound = nbytes / HBM_BYTES_PER_S * 1e3
        say(f"time sptrsv_level_step lap2d_1024 L, widest level {widest} "
            f"({int(sched.counts[widest])} rows of {lv.numel()} ids, w={w_l}), "
            f"(ms a level, 20 in one graph; ms the {sched.n_levels}-level "
            f"solve as one graph) in run order: " + json.dumps(runs))
        say(f"time sptrsv_level_step lap2d_1024 L: {new_v} {one_ms:.5f} ms a "
            f"level on the card (first design {one_first:.5f}), "
            f"{one_eager:.5f} ms launched from Python (plain {one_plain:.4f} "
            f"ms, eager: its boolean scatter syncs; bound {one_bound:.6f} ms, "
            f"{nbytes} bytes; node floors in phase 11c)")
        say(f"time level-by-level solve of lap2d_1024's L ({sched.n_levels} "
            f"launches): {full_graph:.4f} ms as one graph (first design "
            f"{full_first:.4f} ms), {full_eager:.4f} ms launched from Python; "
            f"sptrsv_solve_dot on the same factor: {sptrsv_times.get('L')} ms "
            f"({sptrsv_times.get('how')}), torch triangular_solve (reversed "
            f"U): {sptrsv_times.get('library')} ms")
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

    say_phase("phases 5-5i (times, A/B)", t_mark)

    # -- 6. the solve service ------------------------------------------------
    service_phase(m_main, failed)

    # -- 7. fault-tolerant solves ---------------------------------------------
    ft_phase(failed)

    # -- 8. the tile grid ------------------------------------------------------
    refs = grid_phase(failed)

    # -- 8p. the tile grid one process a tile -----------------------------------
    procgrid_phase(failed, refs)
    del refs

    # -- 9. LM serving -----------------------------------------------------------
    lm = lm_phase(failed)
    return card, smi, rows_out, lm


if __name__ == "__main__":
    sys.exit(main())
