"""The solve loop on the device: ``while_loop`` and a plan's capture cell.

Port of the JAX package's ``lax.while_loop`` / ``lax.scan`` use in
``repro.core.solvers``.  :func:`while_loop` keeps the loop's state on the
vectors' device and runs it in rounds of ``CHUNK`` steps, each step gated
on the device by ``live = cond(state)``.  Gated steps change nothing: the
JAX loop would have exited before them.

Two ways to run the loop:

* eagerly (the solver functions called on their own, and every solve on
  the CPU): each step runs ``body`` and keeps the old value of every
  entry where ``live`` is false (``torch.where`` on the 0-d flag; an entry
  the body returns as the very tensor it was given passes through), and
  the host reads ``cond`` once a round.  Where the state is on the CPU,
  or a plan runs its loop uncaptured by design (a process grid's, below),
  the host reads ``live`` every step instead and the loop ends at the
  first step it is false: the round's later steps would all be gated and
  change nothing, so the result is the same bit for bit;
* from a CUDA graph, inside a plan (a :class:`ProgramCell` that
  captures is active and the state is on the card): the loop is captured once, as a WHILE node
  (``kernels.graph.loop``) whose body is a round -- each step in a
  conditional node (``kernels.graph.cond``) whose IF body is ``body`` and
  whose ELSE body copies the entries the body replaced back from the
  step's input, then the state the round left copied into the buffers
  the next round reads -- and every later call replays it.  The card runs
  the loop to its end; the host reads nothing until the results.  A gated
  step launches its ELSE body's copies and nothing of ``body``.

``cond`` and ``body`` must read per-call values only through the state:
a captured loop reads the state's buffers, and anything else it closes
over is what it was at capture.  An entry may be updated in place (the
solvers' residual trace is); the body must then keep the update
harmless where ``live`` is false, since no select undoes it.

A plan on a process grid (``launch.mesh.ProcessMesh``) runs its loop
eagerly on the card too (``ProgramCell(capture=False)``): its messages go
through host-side collectives, which a CUDA graph cannot hold.  Every rank
reads the same flag a round -- ``cond`` reads only reduced values -- so
every rank runs the same steps and meets the others in every collective.

Launch counts need nothing here: each kernel counts its own launches on
the card (``kernels.build.launch_counter``), a replayed one included.
"""

from __future__ import annotations

import contextvars
import gc
from contextlib import contextmanager

import torch

from ..obs.clock import now

__all__ = ["CHUNK", "while_loop", "when", "ProgramCell", "tracing"]

# Steps a round runs: eagerly the host reads the loop's flag once a round;
# captured, a round is one pass of the WHILE node's body, which copies the
# state back once.
CHUNK = 32

_ACTIVE = contextvars.ContextVar("repro_torch_program", default=None)
_TRACING = contextvars.ContextVar("repro_torch_tracing", default=False)


@contextmanager
def tracing():
    """Inside the block every :func:`while_loop` runs its body exactly
    once, whatever ``cond`` says, and returns that state: a program run
    this way passes through its set-up, one body of each loop and its
    tail once each, as a lowered JAX program holds them
    (``SolvePlan.hlo_summary`` counts the collectives of such a run)."""
    token = _TRACING.set(True)
    try:
        yield
    finally:
        _TRACING.reset(token)


def _signature(tensors) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)


class ProgramCell:
    """The builds of one plan's program, and its captured loops.

    ``traces`` counts builds, as ``jax.jit`` counts traces: a call builds
    when it brings an input signature (shapes, dtypes, device of ``b`` and
    ``x0``) the program has not run with, or when it captures a loop on
    the card -- which a plan does once, on its first call.  On the CPU
    there is nothing to capture, and a build is a new signature.
    ``captures`` counts the loops captured, ``capture_s`` is the wall of
    the last capture, ``step_nodes`` the node count of its step body,
    ``replays`` the graph replays so far (one a call).  With
    ``capture=False`` the loops run eagerly wherever the state lies, and
    a build is a new signature, as on the CPU."""

    def __init__(self, capture: bool = True):
        self.capture = capture
        self.traces = 0
        self.captures = 0
        self.replays = 0
        self.capture_s = None
        self.step_nodes = None
        self._seen: set = set()
        self._loops: dict = {}
        self._key = None
        self._ordinal = 0

    @contextmanager
    def running(self, *inputs: torch.Tensor):
        """Run the program on ``inputs``; :func:`while_loop` inside
        captures or replays this cell's loops.  Counts a build where the
        call brought a new signature or captured a loop."""
        sig = _signature(inputs)
        new = sig not in self._seen
        self._seen.add(sig)
        captures = self.captures
        token = _ACTIVE.set(self)
        self._key, self._ordinal = sig, 0
        try:
            yield
        finally:
            _ACTIVE.reset(token)
            if new or self.captures != captures:
                self.traces += 1

    def _loop(self, cond, body, state):
        key = (self._key, self._ordinal)
        self._ordinal += 1
        graph = self._loops.get(key)
        if graph is None:
            t0 = now()
            with torch.cuda.device(state[0].device):
                graph = _Captured(cond, body, state)
            self._loops[key] = graph
            self.captures += 1
            self.capture_s = now() - t0
            self.step_nodes = graph.step_nodes
        return graph


def _gate(live: torch.Tensor, new, old) -> tuple:
    return tuple(n if n is o else torch.where(live, n, o)
                 for n, o in zip(new, old))


def _check(new, old) -> tuple:
    new = tuple(new)
    if len(new) != len(old) or any(
            n.shape != o.shape or n.dtype != o.dtype or n.device != o.device
            for n, o in zip(new, old)):
        raise ValueError("while_loop: body must return the state's structure, "
                         "shapes, dtypes and devices")
    return new


def while_loop(cond, body, state):
    """``lax.while_loop(cond, body, state)`` on the state's device.

    ``state`` is a tuple of tensors; ``cond(state)`` gives a 0-d bool
    tensor and ``body(state)`` the next state, of the same structure,
    shapes and dtypes.  Returns the state at the first step whose ``cond``
    is false, as ``lax.while_loop`` does; see the module docstring for the
    rounds and the capture."""
    state = tuple(state)
    if _TRACING.get():
        return _check(body(state), state)
    cell = _ACTIVE.get()
    if cell is not None and cell.capture and state[0].is_cuda:
        graph = cell._loop(cond, body, state)
        with torch.cuda.device(state[0].device):
            cell.replays += 1
            return graph.run(state)
    # the flag is on the host already (the CPU), or read every step anyway
    # (a process grid's messages): stop at the step that ends the loop
    stop = not state[0].is_cuda or (cell is not None and not cell.capture)
    while bool(cond(state)):
        for _ in range(CHUNK):
            live = cond(state)
            if stop and not bool(live):
                break
            state = _gate(live, _check(body(state), state), state)
    return state


def when(pred: torch.Tensor, fn) -> None:
    """Run ``fn()`` -- in-place updates that change nothing where ``pred``
    is false -- only where ``pred`` holds: in a captured loop as an IF
    node on the card, else every time."""
    if pred.is_cuda and torch.cuda.is_current_stream_capturing():
        from ..kernels import graph

        graph.cond(pred, fn)
    else:
        fn()


def _fresh(new, old) -> tuple:
    """``new`` with every entry that would alias another slot's tensor --
    an entry of ``old`` in another slot, or one ``new`` holds twice where
    ``old`` does not -- copied: the pass-through and the copy back write
    each slot's tensor on its own."""
    out = []
    for j, n in enumerate(new):
        if n is not old[j] and (
                any(n is o for o in old)
                or any(n is m and old[i] is not old[j]
                       for i, m in enumerate(out))):
            n = n.clone()
        out.append(n)
    return tuple(out)


def _pass(out, old) -> None:
    """The ELSE body of a step: the state passes through unchanged."""
    for n, o in zip(out, old):
        if n is not o:
            n.copy_(o)


@contextmanager
def _no_gc():
    """Hold Python's cycle collector off while a capture is under way: a
    collected plan's memory pool must not be freed inside a capture."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


class _Captured:
    """One loop as a CUDA graph: a WHILE node on ``cond(inp)`` whose body
    runs ``CHUNK`` gated steps from ``inp``, copies the state they left
    into ``inp`` and sets the node's flag from ``cond(inp)``.  ``inp``
    holds the state a replay starts from and ends with; ``step_nodes`` is
    the node count of a step's IF body (its launches and copies, a nested
    conditional counting one)."""

    def __init__(self, cond, body, state):
        from ..kernels import build, graph

        build.prepare(state[0].device)
        self.inp = tuple(t.clone() for t in state)
        # first use of every kernel and cache ahead of the capture, with
        # nothing launched: a throwaway capture of one step
        # (a pool is freed only once no capture is under way)
        warm, warm_pool = torch.cuda.CUDAGraph(), torch.cuda.MemPool()
        with _no_gc(), torch.cuda.graph(warm, capture_error_mode="relaxed"):
            with torch.cuda.use_mem_pool(warm_pool):
                self._round(cond, body, 1, [])
        del warm, warm_pool
        self.pool = torch.cuda.MemPool()    # the bodies' tensors
        self.graph = torch.cuda.CUDAGraph()
        nodes: list = []
        with _no_gc(), torch.cuda.graph(self.graph):
            with torch.cuda.use_mem_pool(self.pool):
                graph.loop(cond(self.inp),
                           lambda: self._round(cond, body, CHUNK, nodes))
        self.step_nodes = nodes[0]

    def _round(self, cond, body, n: int, nodes: list) -> torch.Tensor:
        """Capture ``n`` gated steps from ``inp`` and the copy back into
        ``inp``; returns ``cond(inp)``."""
        from ..kernels import graph

        state = self.inp
        for _ in range(n):
            live = cond(state)
            old = state
            state = graph.cond(
                live, lambda: _fresh(_check(body(old), old), old),
                lambda out: _pass(out, old), nodes)
        _pass(self.inp, state)
        return cond(self.inp)

    def run(self, state):
        _pass(self.inp, state)
        self.graph.replay()
        return self.inp
