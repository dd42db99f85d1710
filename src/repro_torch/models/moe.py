"""Mixture-of-Experts layer (port of ``repro.models.moe``): DBRX 16e/top-4,
DeepSeek-V3 1 shared + 256e/top-8.

Token-choice routing with per-group capacity, the JAX semantics exactly:

* prefill routes each sequence as a group with capacity
  ``min(max(int(t * k / e * cf), k), t)``; an assignment's slot in its
  expert is its position in the cumulative sum over the group's
  token-major ``t * k`` assignments, and assignments at or past the
  capacity are dropped (contribute zero);
* decode (one token a sequence) routes the whole batch as one group with
  capacity ``t``: nothing is dropped;
* the top-k gates are renormalised to sum to one; shared experts add a
  dense MLP; the Switch-style load-balance aux loss is returned.

Dispatch scatters tokens into a (G, E, C, D) buffer, the experts run as
batched products over E, and combine gathers back -- plain torch, as the
JAX package writes it in plain jnp.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import shard
from .blocks import MLP, Init, Linear, _gelu

__all__ = ["MoE", "moe_apply", "route", "capacity"]


class MoE(nn.Module):
    """``{"router", "wi", "wo"[, "wg"][, "shared"]}``: ``wi``/``wg`` are
    (E, D, F), ``wo`` (E, F, D), drawn N(0, 1/D) as in the JAX init."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        d = cfg.d_model
        ffe = cfg.d_ff_expert or cfg.d_ff
        e = cfg.n_experts
        s = 1.0 / math.sqrt(d)
        self.router = Linear(d, e, init)
        self.wi = init.normal((e, d, ffe), s)
        self.wo = init.normal((e, ffe, d), s)
        if cfg.act in ("swiglu", "geglu"):
            self.wg = init.normal((e, d, ffe), s)
        if cfg.n_shared_experts:
            self.shared = MLP(d, cfg.n_shared_experts * ffe, cfg.act, init)


def _expert_ffn(p: MoE, xb, act):
    """xb: (G, E, C, D) -> (G, E, C, D), per-expert weights batched on E."""
    h = torch.einsum("gecd,edf->gecf", xb, p.wi.to(xb.dtype))
    if act == "swiglu":
        g = torch.einsum("gecd,edf->gecf", xb, p.wg.to(xb.dtype))
        h = F.silu(g) * h
    elif act == "geglu":
        g = torch.einsum("gecd,edf->gecf", xb, p.wg.to(xb.dtype))
        h = _gelu(g) * h
    else:
        h = _gelu(h)
    return torch.einsum("gecf,efd->gecd", h, p.wo.to(xb.dtype))


def capacity(t: int, k: int, e: int, cf: float) -> int:
    """Slots an expert takes from a prefill group of ``t`` tokens."""
    return min(max(int(t * k / e * cf), k), t)


def route(logits: torch.Tensor, k: int, cap: int) -> dict:
    """Routing of one call from its router logits (G, T, E): ``probs``,
    renormalised ``gates`` and expert ``idx`` (G, T, k), and per
    token-major assignment (G, T*k) its slot ``pos`` in its expert and
    ``keep`` = pos < cap."""
    g, t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat = F.one_hot(idx, e).reshape(g, t * k, e)       # (G, T*k, E)
    pos = torch.cumsum(flat, dim=1) - flat
    pos = torch.sum(flat * pos, dim=-1)                 # (G, T*k)
    return {"probs": probs, "gates": gates, "idx": idx, "pos": pos,
            "keep": pos < cap}


def moe_apply(p: MoE, x, cfg, capacity_factor: float | None = None):
    """x: (B, S, D) -> (y, aux_loss).  Routing groups = sequences (prefill,
    capacity-dropped) or the whole batch (decode, drop-free).  With a
    rank's E/m experts (``wi``'s leading dim below ``cfg.n_experts``) the
    rank runs those and the combine adds ``y`` over ``model``."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cf = capacity_factor if capacity_factor is not None else cfg.moe_capacity_factor

    if s == 1:  # decode: one group over the batch, drop-free capacity
        xg = x.reshape(1, b, d)
        g, t = 1, b
        cap = t
    else:
        xg = x
        g, t = b, s
        cap = capacity(t, k, e, cf)

    r = route(p.router(xg), k, cap)
    keep, e_flat = r["keep"], r["idx"].reshape(g, t * k)
    pos_c = torch.clamp(r["pos"], max=cap - 1)
    gates = r["gates"]

    # experts a rank: given a rank's E/m expert banks (the train step on a
    # ProcessMesh) it fills and runs their buffers alone; every rank along
    # model routes the same way, and the tokens and gates enter the rank's
    # experts through shard.to_model
    el = p.wi.shape[0]
    split = el < e
    if split:
        e0 = shard.model_index() * el
        mine = (e_flat >= e0) & (e_flat < e0 + el)
        keep = keep & mine
        e_flat = torch.where(mine, e_flat - e0, 0)
        xd, gates = shard.to_model(xg), shard.to_model(gates)
    else:
        xd = xg

    # dispatch: scatter tokens into the (G, E, C, D) expert buffers
    x_rep = torch.repeat_interleave(xd, k, dim=1)       # (G, T*k, D)
    x_rep = torch.where(keep[..., None], x_rep, torch.zeros_like(x_rep))
    buf = xg.new_zeros((g, el, cap, d))
    gi = torch.arange(g, device=x.device)[:, None].expand(g, t * k)
    buf.index_put_((gi, e_flat, pos_c), x_rep, accumulate=True)
    buf = shard.constrain(buf, "moe_buf", e)

    yb = shard.constrain(_expert_ffn(p, buf, cfg.act), "moe_buf", e)  # (G,E,C,D)

    # combine: gather back and weight by gates
    y_tok = shard.constrain(yb[gi, e_flat, pos_c], "batch_only")  # (G,T*k,D)
    y_tok = torch.where(keep[..., None], y_tok, torch.zeros_like(y_tok))
    gates_flat = gates.reshape(g, t * k, 1).to(y_tok.dtype)
    y = torch.sum((y_tok * gates_flat).reshape(g, t, k, d), dim=2)
    if split:
        y = shard.from_model(y, "moe_combine")

    if s == 1:
        y = y.reshape(b, 1, d)

    if hasattr(p, "shared"):
        y = y + p.shared(x)

    # Switch-style load-balance aux: E * sum_e f_e * P_e.  On a ProcessMesh
    # f_e is the whole batch's (the shards' mean) and a rank adds its share
    # of P_e's mean, so the ranks' aux terms add up to the whole batch's.
    nb = shard.batch_shards()
    me = torch.mean(r["probs"], dim=(0, 1))             # (E,)
    ce = torch.mean(F.one_hot(r["idx"], e).float().sum(dim=2), dim=(0, 1)) / k
    ce = shard.batch_sum(ce) / nb
    aux = e * torch.sum(me * ce) * cfg.router_aux_coef / nb
    return y, aux
