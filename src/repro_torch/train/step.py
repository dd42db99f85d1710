"""Training-step builder of the port (port of ``repro.train.step``):
autograd through ``models.model.loss_fn``, global-norm clipping and the
optimizer update, with optional microbatch gradient accumulation and
int8 gradient compression with error feedback.

``build_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``.  By default the step is functional, as the JAX step is: it
returns a new ``TrainState`` and leaves the one it was given as it was, so
a caller may keep the old state (``ft.RestartManager`` keeps it after a
NaN loss).  ``donate=True`` is the port of the JAX launcher's
``jax.jit(..., donate_argnums=(0,))``: the step writes the new params and
optimizer state into the tensors of the state it was given (on one card
at granite-3-8b's width, the difference between one copy of the params
and state and two), and the caller must not use that state again.

The gradients are PyTorch autograd's over the model's plain-torch layers
(the JAX package differentiates plain jnp with ``jax.value_and_grad``;
no kernel of the port is on this path).  The params require grad only for
the length of the backward pass.  Metrics (``loss``, ``grad_norm``,
``step``) stay device tensors: the step reads nothing back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import model as M
from .optim import (LayerStack, Optimizer, _fresh, _state_rows,
                    clip_by_global_norm, rows, stacked_zeros,
                    tree_from_paths, tree_get)

__all__ = ["TrainState", "build_train_step", "init_train_state",
           "value_and_grad", "as_batch"]


class TrainState(NamedTuple):
    params: M.Model
    opt_state: dict
    step: torch.Tensor
    ef: dict | None = None      # error-feedback residuals (compression)


def init_train_state(params: M.Model, optimizer: Optimizer,
                     compress: bool = False) -> TrainState:
    leaves = M.param_leaves(params)
    ef = None
    if compress:
        ef = tree_from_paths({k: stacked_zeros(v) for k, v in leaves.items()})
    return TrainState(params, optimizer.init(leaves),
                      torch.zeros((), dtype=torch.int32, device=params.device),
                      ef)


def _compress_grads(grads: dict, ef, inplace: bool):
    """int8 quantize->dequantize with error feedback; returns (g~, new_ef).
    Each JAX leaf has one scale, ``max|g + e| / 127`` over all its layers;
    ``torch.round`` rounds half to even, as ``jnp.round``.  The grads are
    overwritten (they are the step's own); ``ef`` only with ``inplace``."""
    ef = _fresh(ef, inplace)
    for path, leaf in grads.items():
        es = _state_rows(tree_get(ef, path), leaf)
        amax = None
        for g, e in zip(rows(leaf), es):
            a = torch.max(torch.abs(g.float() + e))
            amax = a if amax is None else torch.maximum(amax, a)
        scale = torch.clamp(amax, min=1e-12) / 127.0
        for g, e in zip(rows(leaf), es):
            g32 = g.float() + e
            deq = torch.clamp(torch.round(g32 / scale), -127, 127) * scale
            e.copy_(g32 - deq)
            g.copy_(deq.to(g.dtype))
    return grads, ef


def as_batch(batch: dict, device) -> dict:
    """``batch``'s arrays as tensors on ``device`` (token ids as int64)."""
    out = {}
    for k, v in batch.items():
        if v is not None:
            t = torch.as_tensor(v, device=device)
            out[k] = t.long() if k in ("tokens", "labels") else t
    return out


def value_and_grad(cfg, params: M.Model, batch: dict, leaves=None):
    """(loss, grads) of ``loss_fn`` on ``batch`` (tensors on the params'
    device) by autograd: grads keyed as ``param_leaves(params)`` (or
    ``leaves``), a stack's as a ``LayerStack``, zeros for a param the loss
    does not reach.  The params require grad for the backward pass only."""
    leaves = M.param_leaves(params) if leaves is None else leaves
    flat = [t for leaf in leaves.values() for t in rows(leaf)]
    try:
        for t in flat:
            t.requires_grad_(True)
        with torch.enable_grad():
            loss, _ = M.loss_fn(params, cfg, batch["tokens"], batch["labels"],
                                mask=batch.get("mask"),
                                prefix_embeds=batch.get("prefix_embeds"))
            gs = torch.autograd.grad(loss, flat, allow_unused=True)
    finally:
        for t in flat:
            t.requires_grad_(False)
    it = iter(torch.zeros_like(t) if g is None else g for t, g in zip(flat, gs))
    grads = {}
    for path, leaf in leaves.items():
        got = [next(it) for _ in rows(leaf)]
        grads[path] = LayerStack(got) if isinstance(leaf, LayerStack) else got[0]
    return loss.detach(), grads


def build_train_step(
    cfg,
    optimizer: Optimizer,
    grad_accum: int = 1,
    max_grad_norm: float = 1.0,
    compress_grads: bool = False,
    grad_shardings=None,
    donate: bool = False,
):
    """Returns train_step(state, batch) -> (state, metrics).

    batch: {"tokens": (B, S) ints, "labels": (B, S) ints, "mask": optional
    (B, S) f32, "prefix_embeds": optional}, numpy arrays or tensors (moved
    to the params' device).  With ``grad_accum > 1`` the batch's leading
    dim is split into microbatches, run in order on the same params; their
    f32 gradients are summed in that order, then divided.

    ``grad_shardings`` places gradients across cards in the JAX package; on
    one card there is nothing to constrain, and a tree here raises until
    gradients are placed on a ``ProcessMesh`` (ROADMAP Queue 1 item 11b,
    on item 10's process grid).
    ``donate``: update the given state's tensors in place (module
    docstring).
    """
    if grad_shardings is not None:
        raise NotImplementedError(
            "grad_shardings: gradients sharded across cards wait for their "
            "placement on a ProcessMesh (ROADMAP Queue 1 item 11b, on item "
            "10's process grid); one card has nothing to constrain")

    def train_step(state: TrainState, batch):
        params = state.params
        leaves = M.param_leaves(params)
        batch = as_batch(batch, params.device)
        if grad_accum > 1:
            mbs = [{k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                                 *v.shape[1:])[i] for k, v in batch.items()}
                   for i in range(grad_accum)]
            gsum, lsum = None, torch.zeros((), dtype=torch.float32,
                                           device=params.device)
            for mb in mbs:
                loss, g = value_and_grad(cfg, params, mb, leaves)
                if gsum is None:
                    gsum = {k: LayerStack(x.float() for x in v)
                            if isinstance(v, LayerStack) else v.float()
                            for k, v in g.items()}
                else:
                    for k, v in g.items():
                        for a, b in zip(rows(gsum[k]), rows(v)):
                            a.add_(b.float())
                lsum = lsum + loss
                del g
            for v in gsum.values():
                for a in rows(v):
                    a.div_(grad_accum)
            grads, loss = gsum, lsum / grad_accum
        else:
            loss, grads = value_and_grad(cfg, params, batch, leaves)

        ef = state.ef
        with torch.no_grad():
            if compress_grads and ef is not None:
                grads, ef = _compress_grads(grads, ef, inplace=donate)
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm, inplace=True)
            new_leaves, new_opt = optimizer.update(
                grads, state.opt_state, leaves, state.step, inplace=donate)
        del grads
        new_params = params if donate else M.replace_params(params, new_leaves)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": state.step}
        return TrainState(new_params, new_opt, state.step + 1, ef), metrics

    train_step.donate = donate
    return train_step

