"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427;
port of ``repro.models.rglru``).

The recurrent branch: conv1d + Real-Gated Linear Recurrent Unit

    r_t = sigmoid(W_a x_t)             (recurrence gate)
    i_t = sigmoid(W_x x_t)             (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full sequence runs the linear recurrence as a log-depth parallel scan
over (a, b) pairs, as the JAX package's ``associative_scan`` does (the tree
differs, so sums may differ in the last bits); decode is the O(1) step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import shard
from .blocks import Init, Linear, _gelu
from .ssm import _conv1d_causal

__all__ = ["RGLRU", "rglru_forward", "rglru_decode", "init_rglru_state",
           "linear_scan"]

_C = 8.0


class RGLRU(nn.Module):
    """``{"in_x", "in_g", "conv_w", "conv_b", "w_a", "w_x", "lam", "out"}``."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        d = cfg.d_model
        w = cfg.lru_width or d
        self.in_x = Linear(d, w, init)
        self.in_g = Linear(d, w, init)
        self.conv_w = init.normal((cfg.conv1d_width, w), 0.2)
        self.conv_b = init.zeros((w,))
        self.w_a = Linear(w, w, init)
        self.w_x = Linear(w, w, init)
        self.lam = init.uniform((w,), 0.9, 0.999)
        self.out = Linear(w, d, init)


def _gates(p: RGLRU, xc, whole=None, lam=None):
    """(a, b) of the recurrence at ``xc``.  On a rank of a split layer
    ``whole`` is every rank's ``xc`` (``w_a``/``w_x`` hold all their input
    rows and the rank's output columns) and ``lam`` the rank's slice."""
    whole = xc if whole is None else whole
    lam = p.lam if lam is None else lam
    r = torch.sigmoid(p.w_a(whole).float())
    i = torch.sigmoid(p.w_x(whole).float())
    log_a = -_C * F.softplus(lam.float()) * r
    a = torch.exp(log_a)
    gated_x = i * xc.float()
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated_x
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, in log2(S)
    doubling steps (Hillis-Steele): after the step with offset o each
    (a_t, b_t) composes the o-longer window ending at t."""
    s = a.shape[1]
    off = 1
    while off < s:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        b = torch.cat([b[:, :off], b[:, off:] + a[:, off:] * b_prev], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a_prev], dim=1)
        off *= 2
    return b


def rglru_forward(p: RGLRU, x, cfg, return_state=False):
    """x: (B, S, D) -> (B, S, D).  Parallel scan over the recurrence.
    Given a rank's W/m columns of ``in_x`` (the train step on a
    ``ProcessMesh``), it runs the rank's slice of the lru width:
    column-parallel ``in_x``/``in_g`` after ``shard.to_model``, its conv
    channels, ``conv_b`` and ``lam``, the gates from every rank's conv
    output (``shard.model_concat``, ``lru_gather``), the scan on its
    width, row-parallel ``out``."""
    w = cfg.lru_width or cfg.d_model
    k = p.in_x.w.shape[1]
    split = k < w
    conv_b, lam = p.conv_b, p.lam
    if split:
        x = shard.to_model(x)
        r = shard.model_index()
        conv_b, lam = conv_b[r * k:(r + 1) * k], lam[r * k:(r + 1) * k]
    xb = shard.constrain(p.in_x(x), "act_bsf", w)
    gate = shard.constrain(p.in_g(x), "act_bsf", w)
    xc, _ = _conv1d_causal(p.conv_w.to(x.dtype), conv_b.to(x.dtype), xb)
    a, b = _gates(p, xc, shard.model_concat(xc, "lru_gather") if split else xc,
                  lam)                                  # (B, S, W) f32
    a = shard.constrain(a, "act_bsf", w)
    b = shard.constrain(b, "act_bsf", w)
    h = linear_scan(a, b)
    y = (h * _gelu(gate.float())).to(x.dtype)
    out = p.out.row(y) if split else p.out(y)
    if return_state:
        return out, {"h": h[:, -1]}
    return out


def init_rglru_state(batch, cfg, dtype=torch.float32, device="cuda"):
    w = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, w), dtype=dtype,
                            device=device),
    }


def rglru_decode(p: RGLRU, x, cfg, state):
    """One-token step.  x: (B, 1, D).  Given a rank's W/m columns of
    ``in_x`` it runs the rank's slice of the lru width as
    :func:`rglru_forward` does, on its slice of the ``h`` and ``conv``
    states (``cache_specs`` puts their width over ``model`` too)."""
    w = cfg.lru_width or cfg.d_model
    k = p.in_x.w.shape[1]
    split = k < w
    conv_b, lam = p.conv_b, p.lam
    if split:
        x = shard.to_model(x)
        r = shard.model_index()
        conv_b, lam = conv_b[r * k:(r + 1) * k], lam[r * k:(r + 1) * k]
    xb = p.in_x(x)
    gate = p.in_g(x)
    xc, conv_state = _conv1d_causal(
        p.conv_w.to(x.dtype), conv_b.to(x.dtype), xb,
        state["conv"].to(x.dtype))
    a, b = _gates(p, xc, shard.model_concat(xc, "lru_gather") if split else xc,
                  lam)                                  # (B, 1, W)
    h = a[:, 0] * state["h"] + b[:, 0]
    y = (h[:, None] * _gelu(gate.float())).to(x.dtype)
    out = p.out.row(y) if split else p.out(y)
    return out, {"h": h, "conv": conv_state.to(state["conv"].dtype)}
