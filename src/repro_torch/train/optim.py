"""Optimizers of the port (port of ``repro.train.optim``): AdamW and
Adafactor, the warmup-cosine schedule and global-norm clipping, written as
plain torch with the JAX package's arithmetic -- no ``torch.optim``.

AdamW keeps f32 (m, v) moments -> 12 bytes/param with the params;
Adafactor factors the second moment into row/column statistics of the
last two dims, so its state is a small fraction of the params' size.

Everything works on the JAX tree's leaves (``models.model.param_leaves``):
a dict path -> tensor, where a layer group's leaf is a ``LayerStack`` of
its layers' tensors, standing for the stack the JAX tree holds.  Gradients
come keyed the same way.  The optimizer state is the JAX package's tree
(nested dicts and lists under the same keys), a group's state stacked on
a leading axis (L, ...), so its tree, shapes and checkpoint keys are the
JAX package's.  Where the JAX arithmetic reduces over a whole leaf --
Adafactor's update clipping ``rms = sqrt(mean(u*u))`` and the int8
gradient compression's ``amax`` (``train.step``) -- the reduction runs
over all layers of a stack; elementwise work runs a layer at a time, so
the f32 temporaries are one layer's.

Scalars (lr, bias corrections, Adafactor's beta) are 0-d f32 tensors on
the params' device, computed from the step counter as JAX computes them
(``step.astype(float32)``); no host read.  ``update(..., inplace=True)``
writes new params and state into the tensors it was given (the donated
step); by default it returns new tensors and leaves its inputs as they
were.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..models.model import LayerStack, Model, param_leaves

__all__ = ["adamw", "adafactor", "warmup_cosine", "clip_by_global_norm",
           "Optimizer", "leaves_of", "rows", "tree_get", "tree_from_paths",
           "stacked_zeros"]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable   # (grads, state, params, step, inplace=False) -> (new_params, new_state)


# -- the JAX tree's leaves -----------------------------------------------------


def leaves_of(params) -> dict:
    """The leaves dict of a ``Model`` (``param_leaves``), or ``params``
    when it already is one."""
    return param_leaves(params) if isinstance(params, Model) else params


def rows(leaf) -> list:
    """The per-layer tensors of a leaf: a ``LayerStack``'s, or the tensor."""
    return list(leaf) if isinstance(leaf, LayerStack) else [leaf]


def _state_rows(t: torch.Tensor, leaf) -> list:
    """The per-layer views of the state tensor ``t`` of ``leaf``."""
    return list(t.unbind(0)) if isinstance(leaf, LayerStack) else [t]


def _shape(leaf) -> tuple:
    """The JAX leaf's shape: a stack's is (L, *layer shape)."""
    if isinstance(leaf, LayerStack):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


def stacked_zeros(leaf, shape=None) -> torch.Tensor:
    """f32 zeros of the JAX leaf's shape (or ``shape``) on its device."""
    dev = rows(leaf)[0].device
    return torch.zeros(_shape(leaf) if shape is None else shape,
                       dtype=torch.float32, device=dev)


def tree_from_paths(items: dict):
    """The nested dicts and lists whose leaves sit at ``items``' paths
    (an int step is a list index)."""
    root: dict = {}
    for path, value in items.items():
        node = root
        for q, nxt in zip(path[:-1], path[1:]):
            if isinstance(node, list):
                while len(node) <= q:
                    node.append(None)
                if node[q] is None:
                    node[q] = [] if isinstance(nxt, int) else {}
                node = node[q]
            else:
                node = node.setdefault(q, [] if isinstance(nxt, int) else {})
        if isinstance(node, list):
            while len(node) <= path[-1]:
                node.append(None)
        node[path[-1]] = value
    return root


def tree_get(tree, path):
    for q in path:
        tree = tree[q]
    return tree


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def _fresh(state, inplace: bool):
    """``state`` itself to write into, or a copy of it to leave it be."""
    return state if inplace else _map_tree(torch.clone, state)


# -- schedule and clipping -------------------------------------------------------


def warmup_cosine(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    def lr(step):
        step = step.float()
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak_lr + (1 - floor) * peak_lr * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return lr


def _all_dims(pl) -> tuple:
    return tuple(range(len(pl.shape)))


def clip_by_global_norm(grads: dict, max_norm: float, inplace: bool = False,
                        placements: dict | None = None):
    """(grads scaled to global norm <= ``max_norm``, the norm before).  The
    norm sums each leaf's f32 squares in leaf order; each grad is scaled
    in f32 and cast back to its dtype (in place with ``inplace``).  With
    ``placements`` (path -> ``launch.sharding.Placement``) each grad is a
    rank's slice and each leaf's sum of squares is added over its slices
    (``Placement.sum_over``) before the leaves are."""
    total = None
    for path, leaf in grads.items():
        sq = None
        for g in rows(leaf):
            s = torch.sum(torch.square(g.float()))
            sq = s if sq is None else sq + s
        if placements is not None:
            sq = placements[path].sum_over(sq, _all_dims(placements[path]), "clip")
        total = sq if total is None else total + sq
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    out = {}
    for path, leaf in grads.items():
        new = []
        for g in rows(leaf):
            v = (g.float() * scale).to(g.dtype)
            new.append(g.copy_(v) if inplace else v)
        out[path] = LayerStack(new) if isinstance(leaf, LayerStack) else new[0]
    return out, gn


# -- AdamW ---------------------------------------------------------------------


def adamw(lr_fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def init(params):
        leaves = leaves_of(params)
        return {"m": tree_from_paths({k: stacked_zeros(v) for k, v in leaves.items()}),
                "v": tree_from_paths({k: stacked_zeros(v) for k, v in leaves.items()})}

    def update(grads, state, params, step, inplace=False, placements=None):
        del placements           # elementwise: a rank's slices update alone
        params = leaves_of(params)
        lr = lr_fn(step)
        t = step.float() + 1.0
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        state = _fresh(state, inplace)
        new_p = {}
        with torch.no_grad():
            for path, leaf in params.items():
                ms = _state_rows(tree_get(state["m"], path), leaf)
                vs = _state_rows(tree_get(state["v"], path), leaf)
                out = []
                for g, m, v, p in zip(rows(grads[path]), ms, vs, rows(leaf)):
                    g = g.float()
                    m.mul_(b1).add_((1 - b1) * g)
                    v.mul_(b2).add_((1 - b2) * g * g)
                    mh = m / bc1
                    vh = v / bc2
                    pf = p.float()
                    step_ = lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * pf)
                    new = (pf - step_).to(p.dtype)
                    out.append(p.copy_(new) if inplace else new)
                new_p[path] = LayerStack(out) if isinstance(leaf, LayerStack) else out[0]
        return new_p, state

    return Optimizer(init, update)


# -- Adafactor -----------------------------------------------------------------


def adafactor(lr_fn, decay=0.8, eps=1e-30, clip_thresh=1.0, weight_decay=0.0) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern).  Leaves of two
    or more dims (a stack counts its layer axis) keep per-row/per-col EMAs
    of g^2 over the last two dims; 0/1-D leaves keep a full v.

    ``update(..., placements=)`` (path -> ``launch.sharding.Placement``)
    takes a rank's slices of grads, params and state: a mean over a dim
    that the placement splits, and the per-leaf RMS, add the other
    slices' partial sums (``Placement.sum_over``)."""

    def init(params):
        st = {}
        for path, leaf in leaves_of(params).items():
            shape = _shape(leaf)
            if len(shape) >= 2:
                st[path] = {"vr": stacked_zeros(leaf, shape[:-1]),
                            "vc": stacked_zeros(leaf, shape[:-2] + shape[-1:])}
            else:
                st[path] = {"v": stacked_zeros(leaf)}
        return {"f": tree_from_paths(st)}

    def _mean(x, dim, upl, keepdim=False, of=None):
        """The whole leaf's mean of ``x`` over ``dim`` (the leaf's dim
        ``of``, default ``dim``) from this rank's slice."""
        of = (dim if of is None else of) % len(upl.shape) if upl is not None else None
        if upl is None or not upl.dim_axes((of,)):
            return torch.mean(x, dim=dim, keepdim=keepdim)
        part = torch.sum(x, dim=dim, keepdim=keepdim)
        return upl.sum_over(part, (of,), "adafactor") / upl.shape[of]

    def _denom(vr, upl):
        """mean(vr, -1) over the whole leaf, clamped (vr's last dim is the
        leaf's dim -2)."""
        return torch.clamp(_mean(vr, -1, upl, keepdim=True, of=-2), min=eps)

    def _v_est(vr, vc, denom):
        return (vr[..., None] * vc[..., None, :]) / denom[..., None]

    def _apply(p, u, lr, scale):
        """The new value of param ``p`` from its unclipped update ``u``."""
        u = u / scale
        pf = p.float()
        newp = pf - lr * u
        if weight_decay:
            newp = newp - lr * weight_decay * pf
        return newp.to(p.dtype)

    def update(grads, state, params, step, inplace=False, placements=None):
        params = leaves_of(params)
        lr = lr_fn(step)
        t = step.float() + 1.0
        beta = 1.0 - t ** (-decay)
        state = _fresh(state, inplace)
        new_p = {}
        with torch.no_grad():
            for path, leaf in params.items():
                s = tree_get(state["f"], path)
                ps, gs = rows(leaf), rows(grads[path])
                stacked = isinstance(leaf, LayerStack)
                pl = None if placements is None else placements[path]
                upl = pl
                if stacked and ps[0].ndim < 2:
                    # a stack of vectors: factored across layers x width,
                    # as one (L, d) leaf
                    ps = [torch.stack(ps)]
                    gs = [torch.stack(gs)]
                    srows = [s]
                elif stacked:
                    # factored over each layer's last two dims: a layer at
                    # a time, the clipping RMS over the whole stack
                    srows = [{"vr": r, "vc": c}
                             for r, c in zip(s["vr"].unbind(0), s["vc"].unbind(0))]
                    upl = None if pl is None else pl.row()
                else:
                    srows = [s]
                # pass 1: the second-moment EMAs and sum(u*u) over the leaf
                ssq, dens = None, []
                for g, sr in zip(gs, srows):
                    g = g.float()
                    g2 = g * g + eps
                    if "vr" in sr:
                        sr["vr"].mul_(beta).add_((1 - beta) * _mean(g2, -1, upl))
                        sr["vc"].mul_(beta).add_((1 - beta) * _mean(g2, -2, upl))
                        dens.append(_denom(sr["vr"], upl))
                        u = g / torch.sqrt(_v_est(sr["vr"], sr["vc"], dens[-1]))
                    else:
                        sr["v"].mul_(beta).add_((1 - beta) * g2)
                        u = g / torch.sqrt(sr["v"])
                    del g2
                    q = torch.sum(u * u)
                    ssq = q if ssq is None else ssq + q
                if pl is not None:
                    ssq = pl.sum_over(ssq, _all_dims(pl), "adafactor")
                # update clipping (RMS <= clip_thresh), then pass 2
                rms = torch.sqrt(ssq / math.prod(_shape(leaf) if pl is None else pl.shape))
                scale = torch.clamp(rms / clip_thresh, min=1.0)
                out = []
                for i, (g, sr, p) in enumerate(zip(gs, srows, ps)):
                    g = g.float()
                    if "vr" in sr:
                        u = g / torch.sqrt(_v_est(sr["vr"], sr["vc"], dens[i]))
                    else:
                        u = g / torch.sqrt(sr["v"])
                    out.append(_apply(p, u, lr, scale))
                if stacked and leaf[0].ndim < 2:
                    out = list(out[0].unbind(0))
                if inplace:
                    out = [p.copy_(v) for p, v in zip(rows(leaf), out)]
                new_p[path] = LayerStack(out) if stacked else out[0]
        return new_p, state

    return Optimizer(init, update)
