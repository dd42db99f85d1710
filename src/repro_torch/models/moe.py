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

On a ``launch.mesh.ProcessMesh`` (the train step's split over ``model``)
a rank given E/m expert banks runs those: every rank along ``model``
routes its batch shard alike, fills the buffers of its own experts and
adds ``y`` over ``model`` in the combine.  With ``ep_stationary`` the
banks never move and the tokens do (the JAX package's rule, the paper's
discipline of keeping the operand still):

* E divides by the batch axes times ``model`` (d m): the placement gives
  a rank E/(d m) whole banks, ``(data, model)`` major to minor.  The
  buffer of a ``model`` index's E/m experts (d chunks, one an owner along
  ``data``) goes by one all-to-all over ``data`` to the ranks that own
  them (``shard.expert_dispatch``); each runs its banks over every batch
  shard's groups, and the outputs come back by the reverse all-to-all
  (``shard.expert_return``);
* E divides by m only: a rank holds E/m banks and their ffn columns over
  ``data``; the buffers are gathered over ``data`` (``shard.
  batch_gather``), the rank's columns give a partial output, and the
  partials are reduce-scattered back to their batch shards
  (``shard.batch_scatter``).

Either way no expert weight is gathered, and a bank's gradient stays on
its rank.  Under ``shard.seq_parallel`` the layer hands ``moe_apply``
the whole sequence (a routing group is a sequence), and the aux term's
gradient flows through the rank's tokens alone
(``shard.own_tokens_grad``).
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


def _own_experts(e_flat, el: int, spread: bool):
    """(mine, slot) of each assignment's expert on this rank's buffer: its
    ``model`` index's experts, E/m slots; ``spread`` (``ep_stationary``'s
    E/(d m) banks a rank, ``(data, model)`` major to minor) numbers them
    by the owner's ``data`` coordinate, then the bank."""
    m, j = shard.model_shards(), shard.model_index()
    if not spread:
        e0 = j * el
        return (e_flat >= e0) & (e_flat < e0 + el), e_flat - e0
    own = e_flat // el
    return own % m == j, (own // m) * el + e_flat % el


def moe_apply(p: MoE, x, cfg, capacity_factor: float | None = None,
              with_aux: bool = True):
    """x: (B, S, D) -> (y, aux_loss).  Routing groups = sequences (prefill,
    capacity-dropped) or the whole batch (decode, drop-free).  With a
    rank's E/m experts (``wi``'s leading dim below ``cfg.n_experts``) the
    rank runs those and the combine adds ``y`` over ``model``; with
    ``ep_stationary`` as the module docstring says.  ``with_aux=False``
    (serving, which drops the aux loss) returns None for it and adds
    nothing over the batch shards.

    On a ``ProcessMesh`` a decode step's group is the rank's B/d tokens
    where the JAX package's is the whole batch: the capacity is the
    group's size either way, so no assignment is dropped and each token's
    output is the same."""
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
    ep = split and shard.ep_stationary()
    spread = ep and el * shard.model_shards() < e     # E/(d m) banks a rank
    if ep and p.wi.shape[1] != d:
        raise ValueError("ep_stationary: the expert banks must be placed by "
                         "state_specs(..., ep_stationary=True)")
    if split:
        mine, slot = _own_experts(e_flat, el, spread)
        keep = keep & mine
        e_flat = torch.where(mine, slot, 0)
        xd, gates = shard.to_model(xg), shard.to_model(gates)
    else:
        xd = xg

    # dispatch: scatter tokens into the (G, E, C, D) expert buffers
    x_rep = torch.repeat_interleave(xd, k, dim=1)       # (G, T*k, D)
    x_rep = torch.where(keep[..., None], x_rep, torch.zeros_like(x_rep))
    ne = e // shard.model_shards() if split else el   # the buffer's experts
    buf = xg.new_zeros((g, ne, cap, d))
    gi = torch.arange(g, device=x.device)[:, None].expand(g, t * k)
    buf.index_put_((gi, e_flat, pos_c), x_rep, accumulate=True)
    if spread:
        buf = shard.expert_dispatch(buf)
    elif ep:
        buf = shard.batch_gather(buf)
    buf = shard.constrain(buf, "moe_buf", e)

    yb = shard.constrain(_expert_ffn(p, buf, cfg.act), "moe_buf", e)  # (G,E,C,D)
    if spread:
        yb = shard.expert_return(yb)
    elif ep:
        yb = shard.batch_scatter(yb)

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
        sh = p.shared(x)
        if sh.shape[1] != y.shape[1]:        # under seq_parallel: one split, one whole
            sh, y = (shard.seq_local(t) if t.shape[1] == s else t for t in (sh, y))
        y = y + sh
    if not with_aux:
        return y, None

    # Switch-style load-balance aux: E * sum_e f_e * P_e.  On a ProcessMesh
    # f_e is the whole batch's (the shards' mean) and a rank adds its share
    # of P_e's mean, so the ranks' aux terms add up to the whole batch's.
    nb = shard.batch_shards()
    me = torch.mean(shard.own_tokens_grad(r["probs"]), dim=(0, 1))   # (E,)
    ce = torch.mean(F.one_hot(r["idx"], e).float().sum(dim=2), dim=(0, 1)) / k
    ce = shard.batch_sum(ce) / nb
    aux = e * torch.sum(me * ce) * cfg.router_aux_coef / nb
    return y, aux
