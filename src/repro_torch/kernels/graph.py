"""Conditional nodes in a CUDA graph that PyTorch is capturing.

:func:`cond` puts an IF node (with an ELSE body where one is given) into
the graph the current stream captures, :func:`loop` a WHILE node, and
each captures its bodies from a side stream; ``csrc/graph.cu`` adds the
node and the one-thread kernel that sets its handle from a bool on the
card.  A replay then runs the IF body where the flag is true and the
ELSE body where it is false, and the WHILE body until the flag its last
pass set is false, without the host reading a flag.  The solve loop
(``core.loop``) captures its loop as one WHILE node over a round of
steps, each step in an IF node.

Allocations inside a body go to the memory pool the caller routes this
thread's allocations to (``torch.cuda.use_mem_pool``): PyTorch's own
capture pool takes only the capturing stream's.
"""

from __future__ import annotations

import ctypes
from contextlib import contextmanager

import torch

from . import build

__all__ = ["cond", "loop"]

_SIDE: dict = {}        # (device index, nesting depth) -> side stream
_DEPTH = [0]


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    key = (device.index, _DEPTH[0])
    if key not in _SIDE:
        _SIDE[key] = torch.cuda.Stream(device)
    return _SIDE[key]


@contextmanager
def _body(stream: torch.cuda.Stream, graph: int):
    """Capture the work issued inside into the body ``graph``."""
    build.check(build.plain_entry("repro_graph_body_begin")(
        stream.cuda_stream, graph), "graph body begin")
    ok = False
    try:
        with torch.cuda.stream(stream):
            yield
        ok = True
    finally:
        err = build.plain_entry("repro_graph_body_end")(stream.cuda_stream)
        if ok:
            build.check(err, "graph body end")


def _node(pred: torch.Tensor, kind: int, n_bodies: int):
    """Add a conditional node of ``kind`` (0 IF, 1 WHILE) on ``pred`` to
    the graph the current stream captures; returns (bodies, handle)."""
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError("graph: the current stream is not capturing")
    _check_pred(pred)
    bodies = (ctypes.c_void_p * 2)()
    handle = ctypes.c_uint64(0)
    build.check(build.plain_entry("repro_graph_cond")(
        torch.cuda.current_stream(pred.device).cuda_stream, pred.data_ptr(),
        kind, n_bodies, bodies, ctypes.byref(handle)), "graph cond")
    return bodies, handle.value


def _check_pred(pred: torch.Tensor) -> None:
    if pred.dtype != torch.bool or pred.numel() != 1 or not pred.is_cuda:
        raise ValueError(f"graph: a condition must be one bool on the card, "
                         f"got {pred.dtype} {tuple(pred.shape)} on "
                         f"{pred.device}")


def _nodes(graph: int) -> int:
    n = ctypes.c_int64(0)
    build.check(build.plain_entry("repro_graph_nodes")(graph, ctypes.byref(n)),
                "graph nodes")
    return n.value


def cond(pred: torch.Tensor, then_fn, else_fn=None, nodes: list | None = None):
    """Capture ``then_fn()`` as the IF body of a conditional node on
    ``pred`` (a one-element bool tensor on the card) and, where given,
    ``else_fn(out)`` as its ELSE body, ``out`` being what ``then_fn``
    returned; returns ``out``.  The node goes into the graph that the
    current stream is capturing, after everything captured so far.
    ``nodes``, where given, gets the IF body's node count appended.
    Raises if that stream is not capturing."""
    bodies, _ = _node(pred, 0, 1 if else_fn is None else 2)
    side = _side_stream(pred.device)
    _DEPTH[0] += 1
    try:
        with _body(side, bodies[0]):
            out = then_fn()
        if nodes is not None:
            nodes.append(_nodes(bodies[0]))
        if else_fn is not None:
            with _body(side, bodies[1]):
                else_fn(out)
    finally:
        _DEPTH[0] -= 1
    return out


def loop(pred: torch.Tensor, body_fn) -> None:
    """Capture a WHILE node on ``pred`` (a one-element bool tensor on the
    card) whose body is ``body_fn()``: the body runs while the flag holds,
    the flag being ``pred`` before the first pass and, after each pass,
    the one-element bool tensor ``body_fn`` returned.  The node goes into
    the graph that the current stream is capturing; raises if it is not
    capturing."""
    bodies, handle = _node(pred, 1, 1)
    side = _side_stream(pred.device)
    _DEPTH[0] += 1
    try:
        with _body(side, bodies[0]):
            again = body_fn()
            _check_pred(again)
            build.check(build.plain_entry("repro_graph_set")(
                side.cuda_stream, handle, again.data_ptr()), "graph set")
    finally:
        _DEPTH[0] -= 1
