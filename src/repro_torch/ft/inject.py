"""Deterministic fault injection for sparse solves (port of
``repro.ft.inject``; numpy only, a copy of the JAX package's module).

Azul's functional-verification story is a fault story: one corrupted SRAM
word, one dropped NoC message, or one straggling PE silently poisons a
whole CG solve.  This module reproduces those hardware fault modes *in
software*, deterministically, against the real solve programs: all it
does is hand a corrupted *value operand* to an ``injectable=True``
:class:`~repro_torch.core.plan.SolvePlan`.  Such a plan reads the packed
ELL values from a buffer of its own and copies each call's operand into
it, so the program -- on the card, the captured CUDA graph -- is the same
one for clean and corrupted calls.

Fault model (``FaultSpec.kind``):

``nan``           a poisoned SRAM read: ``count`` seeded entries of the
                  packed values become NaN.
``bitflip``       a single-event upset: XOR ``bit`` of the IEEE
                  representation of ``count`` seeded stored nonzeros
                  (default bit 62 -- top exponent bit, a silent
                  many-orders-of-magnitude value change that does NOT
                  produce a NaN, exercising the divergence/true-residual
                  detectors rather than the non-finite one).
``halo_drop``     a dropped NoC message: ``count`` seeded entries that
                  reference *remote* shards (``engine.halo_entry_mask()``)
                  are zeroed -- the tile computes with a stale/absent halo
                  contribution.
``halo_perturb``  a corrupted NoC payload: those same remote-referencing
                  entries are scaled by ``scale``.
``delay``         a straggling tile: no numeric corruption; the injector
                  sleeps ``delay_s`` at the chunk boundary where the fault
                  fires, so ``ft.straggler.StepTimer`` flags it.

Faults are *scheduled*: ``iteration`` names the (0-based, global) solver
iteration at which the fault appears.  The chunked restart driver
(:class:`repro_torch.ft.restart.SolveRestartManager`) asks the injector for the
value operand of each chunk; a ``transient`` fault corrupts only the chunk
containing ``iteration`` (a retry after restart sees clean values -- the
SEU model), a persistent one corrupts every chunk from there on (a stuck
bit).  Entry selection is a pure function of ``seed``, so every run of the
same spec corrupts the same words.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

__all__ = ["FaultSpec", "FaultInjector", "corrupt_vals", "FAULT_KINDS"]

FAULT_KINDS = ("nan", "bitflip", "halo_drop", "halo_perturb", "delay")

# kinds whose target set is "entries referencing remote shards" -- they
# need an engine with a distributed layout to resolve the halo entry mask
_HALO_KINDS = ("halo_drop", "halo_perturb")


@dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault: what, where (iteration), and how bad.

    ``iteration`` is the 0-based global solver iteration the fault fires
    at; ``seed`` drives entry selection; ``count`` is how many stored
    nonzeros are hit.  ``bit`` (bitflip), ``scale`` (halo_perturb) and
    ``delay_s`` (delay) parameterize the respective kinds.  ``transient``
    chooses SEU semantics (clean after restart) over stuck-at.
    """

    kind: str = "nan"
    iteration: int = 0
    seed: int = 0
    count: int = 1
    bit: int = 62
    scale: float = 1e6
    delay_s: float = 0.0
    transient: bool = True

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        if self.count < 1:
            raise ValueError("count must be >= 1")
        if self.iteration < 0:
            raise ValueError("iteration must be >= 0")


def _pick_entries(eligible: np.ndarray, count: int, seed: int) -> np.ndarray:
    """Seeded flat indices into the packed value buffer: a deterministic
    sample of ``count`` positions from the eligible set."""
    idx = np.flatnonzero(eligible)
    if idx.size == 0:
        raise ValueError("no eligible entries to corrupt (empty mask)")
    rng = np.random.default_rng(seed)
    take = min(count, idx.size)
    return rng.choice(idx, size=take, replace=False)


def corrupt_vals(vals: np.ndarray, spec: FaultSpec,
                 halo_mask: np.ndarray | None = None) -> np.ndarray:
    """Return a corrupted copy of the packed ELL ``vals`` under ``spec``.

    ``halo_mask`` (same shape as ``vals``, bool) marks entries that
    reference remote shards; required for the ``halo_*`` kinds, ignored
    otherwise.  ``delay`` faults do not touch values and return the input
    unchanged (no copy).
    """
    if spec.kind == "delay":
        return vals
    out = np.array(vals, copy=True)
    if spec.kind in _HALO_KINDS:
        if halo_mask is None:
            raise ValueError(
                f"fault kind {spec.kind!r} needs the halo entry mask "
                "(engine.halo_entry_mask()); local plans have no halo")
        eligible = np.asarray(halo_mask, bool).reshape(-1)
    else:
        # storage faults hit real stored nonzeros, not ELL padding slots
        eligible = out.reshape(-1) != 0
    pos = _pick_entries(eligible, spec.count, spec.seed)
    flat = out.reshape(-1)
    if spec.kind == "nan":
        flat[pos] = np.nan
    elif spec.kind == "bitflip":
        info = np.finfo(out.dtype)
        ibits = np.uint64(1) << np.uint64(spec.bit) if info.bits == 64 \
            else np.uint32(1) << np.uint32(spec.bit % 32)
        iview = flat.view(np.uint64 if info.bits == 64 else np.uint32)
        iview[pos] = iview[pos] ^ ibits
    elif spec.kind == "halo_drop":
        flat[pos] = 0.0
    elif spec.kind == "halo_perturb":
        flat[pos] = flat[pos] * spec.scale
    return out


class FaultInjector:
    """Schedule a :class:`FaultSpec` against one engine's solve chunks.

    The chunked drivers (restart manager, deadline-serving path) call
    :meth:`vals_for` with each chunk's global iteration window and pass
    the result as the plan's per-call ``vals`` operand; :meth:`on_chunk`
    realizes ``delay`` faults as an actual sleep the StepTimer can see.
    ``restart()`` tells the injector a recovery restart happened --
    transient faults stop firing after that.

    On a process grid (an engine on a ``launch.mesh.ProcessMesh``) every
    rank builds its injector with the same spec: the entries are drawn
    over the whole grid's stacked layout (``engine.grid_vals_template``),
    so the ranks' corrupted tiles, stacked in rank order, are the
    one-process grid's corrupted operand, and each rank's ``vals_for``
    is its own tile of it (``engine.vals_template``'s layout).
    """

    def __init__(self, engine, spec: FaultSpec):
        self.engine = engine
        self.spec = spec
        self.fired = 0
        self._suppressed = False
        self._clean = engine.vals_template()
        self._corrupt = None
        if spec.kind != "delay":
            # the draws over every tile of the grid, as the one-process
            # grid makes them; a rank of a process grid keeps its tile's
            mask = (engine.grid_halo_entry_mask()
                    if spec.kind in _HALO_KINDS else None)
            bad = corrupt_vals(engine.grid_vals_template(), spec, mask)
            tiles = slice(None) if engine.mesh is None else engine.mesh.local
            self._corrupt = np.ascontiguousarray(bad[tiles])

    def fires_in(self, start: int, stop: int) -> bool:
        """Does the fault hit the chunk covering iterations [start, stop)?"""
        if self._suppressed:
            return False
        if self.spec.transient:
            return start <= self.spec.iteration < stop
        return stop > self.spec.iteration      # persistent: from there on

    def vals_for(self, start: int, stop: int) -> np.ndarray | None:
        """The value operand for this chunk: corrupted if the fault fires,
        None (clean baked-in values) otherwise."""
        if self._corrupt is not None and self.fires_in(start, stop):
            self.fired += 1
            return self._corrupt
        return None

    def on_chunk(self, start: int, stop: int) -> None:
        """Chunk-boundary side effects: the ``delay`` kind sleeps here."""
        if (self.spec.kind == "delay" and self.spec.delay_s > 0
                and self.fires_in(start, stop)):
            self.fired += 1
            time.sleep(self.spec.delay_s)

    def restart(self) -> None:
        """A recovery restart happened: transient faults are now gone."""
        if self.spec.transient:
            self._suppressed = True
