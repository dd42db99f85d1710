"""Fault-tolerant training loops and solves (port of ``repro.ft.restart``).

``RestartManager`` runs (or resumes) a training loop: periodic async
checkpoints, resume from the newest *valid* checkpoint, deterministic data
replay (the pipeline is a pure function of (seed, step)), and a NaN guard
that rolls back to the previous checkpoint and skips the offending batch.
The loop is orchestration only: the math stays in the train step.  With a
donating step (``build_train_step(..., donate=True)``) a NaN loss has
already been written into the state, so a rollback with no checkpoint to
restore raises instead of carrying on.

On a process grid (a state placed by ``launch.sharding.named`` on a
``launch.mesh.ProcessMesh``, ``run(..., placements=)``) the loop runs on
every rank: the checkpoints hold whole leaves (each save gathers the
state leaf by leaf on every rank and rank 0 writes; a restore puts each
rank's slices back onto the placements, as ``ft.remesh_restore`` does),
``latest_step`` is rank 0's, broadcast, and the NaN guard reads the
loss, which the placed step sums in rank order -- so every rank takes
the same decisions, and they are the one-process loop's.

``SolveRestartManager`` drives a tolerance-mode plan in fixed-size chunks
(restarted CG: each chunk warm-starts from the current iterate -- a few
more iterations, full recoverability), verifies every chunk against the
CLEAN operator, and on a detected fault rolls back to the last known-good
state (checkpoint on disk when configured, in memory otherwise) and runs
the chunk again.  Detection is layered:

  1. the in-loop guards' structured status (breakdown/diverged/stagnated
     -- NaN, indefinite operators, residual blow-up);
  2. non-finite entries in the returned iterate;
  3. a true-residual audit: ||b - A x|| under the engine's *clean*
     operator (``engine.spmv``) must agree with the recurrence's claimed
     residual to a factor of TRUE_RESIDUAL_SLACK -- this catches SILENT
     corruption (an exponent bit-flip that never produces a NaN: the
     recurrence "converges" against the corrupted operator while the true
     residual stands still).

Every chunk is one call of ONE chunk-sized injectable plan,
``plan(b, x0=x, vals=v)``: on the card it is captured once as a CUDA graph
and replayed for clean and corrupted chunks alike (the plan copies ``v``
into its own value buffer).  As in the JAX package, the iterate comes back
to the host every chunk and the audit runs ``engine.spmv`` on it.

On a process grid (an engine on a ``ProcessMesh``) every rank runs the
same chunk loop on its eager injectable plan: ``plan`` and
``engine.spmv`` take and return the global vectors, the same bits on
every rank, so every rank reaches the same verdict.  A chunk's time for
the ``StepTimer`` is the slowest rank's (a max over the ranks), as the
JAX package's one controller times one wall.  Only rank 0 writes the
checkpoints; before any rank reads one, rank 0's writer is drained and
the ranks meet at a barrier, and whether to resume is rank 0's answer.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..checkpoint.manager import CheckpointManager, grid_of
from ..obs import REGISTRY as _OBS
from ..obs import clock as _clock
from ..obs import span as _span

__all__ = ["RestartManager", "TrainLoopResult",
           "SolveRestartManager", "FTSolveReport"]

# -- observability (host-side; see repro_torch.obs) ---------------------------
_M_FT_FAULTS = _OBS.counter(
    "repro_ft_faults_total",
    "faults detected by the chunked solve audit, by structured label",
    ("label",))
_M_FT_RESTARTS = _OBS.counter(
    "repro_ft_restarts_total",
    "rollback-and-retry recoveries taken by SolveRestartManager")
_M_FT_ROLLBACKS = _OBS.counter(
    "repro_ft_rollbacks_total",
    "NaN-guard rollbacks taken by the training RestartManager")


@dataclass
class TrainLoopResult:
    state: object
    losses: list
    resumed_from: int | None
    nan_rollbacks: int
    step_times: list


class RestartManager:
    def __init__(self, ckpt_dir: str, save_every: int = 50, keep: int = 3,
                 guard_nan: bool = True, skip_bad_batch: bool = True):
        self.mgr = CheckpointManager(ckpt_dir, keep=keep)
        self.save_every = save_every
        self.guard_nan = guard_nan
        self.skip_bad_batch = skip_bad_batch

    def run(self, state, train_step, pipeline, total_steps: int,
            inject_failure_at: int | None = None,
            placements=None) -> TrainLoopResult:
        """Run (or resume) training to ``total_steps``.

        ``inject_failure_at``: test hook -- raises RuntimeError at the given
        step to exercise the restart path (tests call run() twice).  Each
        step's loss is read back to the host (the NaN guard needs it), so
        ``step_times`` are the steps' times on the device.
        ``placements``: the state's placements (``launch.sharding.named``'s
        tree, as ``launch.train.placed_state`` returns it) where ``state``
        is placed on a process grid; every rank of the grid calls ``run``
        (module docstring).
        """
        grid = grid_of(placements)
        if grid is not None:
            self.mgr.mesh = grid
        resumed = self.mgr.latest_step()
        if resumed is not None:
            state, _ = self.mgr.restore(state, placements)
            start = int(state.step)
        else:
            start = 0

        losses, times = [], []
        rollbacks = 0
        step = start
        while step < total_steps:
            if inject_failure_at is not None and step == inject_failure_at:
                self.mgr.wait()
                raise RuntimeError(f"injected failure at step {step}")
            batch = pipeline.batch_at(step)
            t0 = _clock.now()
            new_state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            times.append(_clock.now() - t0)

            if self.guard_nan and not np.isfinite(loss):
                rollbacks += 1
                _M_FT_ROLLBACKS.inc()
                self.mgr.wait()     # an in-flight save counts as the last
                prev = self.mgr.latest_step()
                if prev is not None:
                    state, _ = self.mgr.restore(state, placements)
                    step = int(state.step)
                elif getattr(train_step, "donate", False):
                    raise RuntimeError(
                        f"NaN loss at step {step}: the donating step has "
                        "written it into the state and there is no "
                        "checkpoint to roll back to")
                if self.skip_bad_batch:
                    step += 1   # skip-ahead past the poisoned batch
                continue

            state = new_state
            losses.append(loss)
            step += 1
            if step % self.save_every == 0 or step == total_steps:
                self.mgr.save_async(state, step, placements)
        self.mgr.wait()
        return TrainLoopResult(state, losses, resumed, rollbacks, times)


# -- fault-tolerant solves -----------------------------------------------------
#
# The training RestartManager above recovers a *training loop*; the solve
# counterpart below recovers a *linear solve*.


@dataclass
class FTSolveReport:
    """Outcome of a fault-tolerant chunked solve."""

    x: np.ndarray
    rel_residual: float          # true ||b - A x|| / ||b|| (clean operator)
    status: str                  # 'converged' | 'maxiter' | fault name
    iterations: int              # productive iterations (bad chunks excluded)
    chunks: int                  # chunk executions, including re-runs
    restarts: int                # rollback-and-retry recoveries taken
    faults: list                 # one record per detected fault
    resumed_from: int | None     # checkpoint step a fresh solve resumed at
    straggler_chunks: list       # chunk indices the StepTimer flagged


class SolveRestartManager:
    """Chunked, checkpointed, fault-detecting driver around a SolvePlan.

    Parameters
    ----------
    engine : AzulEngine      the solver engine (clean operator)
    spec : SolveSpec         a *tolerance-method* spec (pcg_tol /
                             pcg_pipelined_tol); its tol and max_iters
                             give the overall solve contract
    chunk : int              iterations per chunk (checkpoint/verify
                             granularity)
    max_restarts : int       recovery attempts before giving up
    checkpoint_dir : str | None
                             persist (x, r, k) every ``save_every`` chunks;
                             a fresh ``solve`` on the same RHS resumes from
                             the newest valid checkpoint, and fault
                             recovery restores from disk (falling back to
                             the in-memory good state)
    timer : StepTimer | None per-chunk wall-time watchdog (delay faults
                             and real stragglers land in
                             ``report.straggler_chunks``)
    """

    TRUE_RESIDUAL_SLACK = 100.0

    def __init__(self, engine, spec, chunk: int = 25, max_restarts: int = 3,
                 checkpoint_dir: str | None = None, save_every: int = 1,
                 timer=None):
        from dataclasses import replace as replace_spec

        from ..core.plan import SolveSpec
        from ..core.registry import get_solver
        if not isinstance(spec, SolveSpec):
            raise TypeError("spec must be a SolveSpec")
        if not get_solver(spec.method).tolerance:
            raise ValueError(
                f"method {spec.method!r} is not a tolerance method; the "
                "chunked restart driver needs a convergence test to know "
                "when the solve is done")
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.engine = engine
        self.spec = spec
        self.chunk = int(chunk)
        self.max_restarts = int(max_restarts)
        self.tol = float(spec.tol if spec.tol is not None else 1e-8)
        self.budget = int(spec.max_iters if spec.max_iters is not None
                          else spec.iters)
        self.timer = timer
        self.mgr = (CheckpointManager(checkpoint_dir, mesh=engine.mesh)
                    if checkpoint_dir else None)
        self.save_every = int(save_every)
        # one chunk-sized injectable plan, built once, reused for every
        # chunk and every recovery re-run (clean and corrupted chunks run
        # the SAME program -- vals is a per-call operand)
        self._plan = engine.plan(replace_spec(
            spec, injectable=True, iters=self.chunk, tol=self.tol,
            max_iters=self.chunk))

    # -- internals ----------------------------------------------------------

    def _slowest(self, dt: float) -> float:
        """A chunk's wall time, the slowest rank's on a process grid."""
        mesh = self.engine.mesh
        if mesh is None or not mesh.per_process:
            return dt
        return float(mesh.host_gather([dt], "ft_chunk_s").max())

    def _true_rel(self, x: np.ndarray, b: np.ndarray, bnorm: float) -> float:
        return float(np.linalg.norm(b - self.engine.spmv(x)) / bnorm)

    def _audit(self, x, status_name: str, rel_claimed: float,
               rel_true: float) -> str | None:
        """Returns the fault label for a bad chunk, None when clean."""
        if status_name in ("breakdown", "diverged", "stagnated"):
            return status_name
        if not np.all(np.isfinite(x)):
            return "nonfinite_x"
        floor = max(rel_claimed, self.tol)
        if rel_true > self.TRUE_RESIDUAL_SLACK * floor:
            return "silent_corruption"
        return None

    def _save(self, x: np.ndarray, b: np.ndarray, k: int) -> None:
        if self.mgr is not None:
            r = b - self.engine.spmv(x)
            self.mgr.save_async({"x": x, "r": r, "k": np.int64(k)}, k)

    def _restore(self, b: np.ndarray, good: tuple) -> tuple:
        """Last known-good (x, k): the newest valid checkpoint when one is
        configured and present, else the in-memory copy."""
        if self.mgr is not None:
            self.mgr.wait()
            if self.mgr.latest_step() is not None:
                like = {"x": np.zeros_like(b), "r": np.zeros_like(b),
                        "k": np.int64(0)}
                tree, _ = self.mgr.restore(like)
                return np.asarray(tree["x"]), int(tree["k"])
        return good

    # -- the driver ---------------------------------------------------------

    def solve(self, b, injector=None, x0=None) -> FTSolveReport:
        """Fault-tolerant solve of A x = b to the spec's tolerance.

        ``injector`` (:class:`repro_torch.ft.inject.FaultInjector`) corrupts
        the chunks its FaultSpec schedules; None runs clean.  The clean
        path produces the same iterate trajectory as an uninterrupted solve
        restarted every ``chunk`` iterations.  A chunk whose plan raises
        (a kernel failure on the card) propagates: only a guard status or
        the audit starts a restart.
        """
        b = np.asarray(b, dtype=self.engine.dtype)
        bnorm = float(np.linalg.norm(b))
        bnorm = bnorm if bnorm > 0 else 1.0
        x = (np.zeros_like(b) if x0 is None
             else np.asarray(x0, dtype=b.dtype))
        k = 0
        resumed = None
        if self.mgr is not None and self.mgr.latest_step() is not None:
            x, k = self._restore(b, (x, k))
            resumed = k
        good = (x.copy(), k)
        restarts, chunks = 0, 0
        faults: list = []
        stragglers: list = []
        status = "maxiter"

        while k < self.budget:
            lo, hi = k, k + self.chunk
            # the chunk wall-time window includes injector side effects, so
            # a ``delay`` fault's sleep lands in the StepTimer observation
            t0 = _clock.now()
            with _span("ft_chunk", kind="ft_chunk", global_iter=lo):
                if injector is not None:
                    injector.on_chunk(lo, hi)
                vals = (injector.vals_for(lo, hi) if injector is not None
                        else None)
                x2, norms = self._plan(b, x0=x, vals=vals)
            dt = _clock.now() - t0
            chunks += 1
            if self.timer is not None:
                rep = self.timer.observe(chunks, self._slowest(dt))
                if rep.is_straggler:
                    stragglers.append(chunks)
            sname = self._plan.last_status_names
            it_chunk = int(np.asarray(self._plan.last_iters))
            rel_claimed = float(np.asarray(norms)[it_chunk] / bnorm)
            rel_true = self._true_rel(np.asarray(x2), b, bnorm)
            label = self._audit(np.asarray(x2), sname, rel_claimed, rel_true)

            if label is not None:
                bad_it = int(np.asarray(self._plan.last_bad_iter))
                faults.append({"chunk": chunks, "global_iter": lo,
                               "label": label,
                               "bad_iter": bad_it if bad_it >= 0 else None,
                               "rel_true": rel_true})
                _M_FT_FAULTS.inc(label=label)
                restarts += 1
                _M_FT_RESTARTS.inc()
                if restarts > self.max_restarts:
                    status = label
                    break
                if injector is not None:
                    injector.restart()
                x, k = self._restore(b, good)
                continue                       # re-run from the good state

            x, k = np.asarray(x2), k + max(it_chunk, 1)
            good = (x.copy(), k)
            if self.mgr is not None and chunks % self.save_every == 0:
                self._save(x, b, k)
            if (sname == "converged"
                    and rel_true <= self.TRUE_RESIDUAL_SLACK * self.tol):
                status = "converged"
                break

        if self.mgr is not None:
            self.mgr.wait()
        return FTSolveReport(
            x=x, rel_residual=self._true_rel(x, b, bnorm), status=status,
            iterations=k - (resumed or 0), chunks=chunks, restarts=restarts,
            faults=faults, resumed_from=resumed,
            straggler_chunks=stragglers)
