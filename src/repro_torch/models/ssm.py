"""Mamba-2 (SSD, state-space duality) block (port of ``repro.models.ssm``).

The chunked SSD algorithm of Dao & Gu (arXiv:2405.21060): within
length-Q chunks the recurrence is a masked matmul (the dual quadratic
form); across chunks a loop carries the (H, P, N) state.  Decode is the
O(1) recurrent step on the same state, kept in f32.

Layer I/O matches mamba_ssm's Mamba2: in_proj -> [z | xBC | dt], causal
conv1d over xBC, SSD core, gated RMSNorm, out_proj.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import shard
from .blocks import Init, Linear, Norm, pad_dim1, rms_norm

__all__ = ["SSM", "ssm_forward", "ssm_decode", "init_ssm_state", "ssd_chunked"]


def _dims(cfg):
    din = cfg.ssm_expand * cfg.d_model
    return din, shard.ssd_heads(cfg), cfg.ssm_headdim, cfg.ssm_d_state


class SSM(nn.Module):
    """``{"in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "D", "norm",
    "out_proj"}``."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        d = cfg.d_model
        din, nh, hp, n = _dims(cfg)
        conv_dim = din + 2 * n
        self.in_proj = Linear(d, 2 * din + 2 * n + nh, init)
        self.conv_w = init.normal((cfg.ssm_d_conv, conv_dim), 0.2)
        self.conv_b = init.zeros((conv_dim,))
        self.dt_bias = init.zeros((nh,))
        self.A_log = init.const(torch.log(torch.linspace(1.0, 16.0, nh)))
        self.D = init.ones((nh,))
        self.norm = Norm(din, "rmsnorm", init)
        self.out_proj = Linear(din, d, init)


def _segsum(a):
    """Stable 'segment sum' producing the lower-triangular cumulative-decay
    matrix: out[i, j] = sum_{j < k <= i} a[k] (=-inf above diagonal)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, d, -math.inf)


def ssd_chunked(x, dt, a, b, c, chunk, init_state=None):
    """SSD core.  x: (B,L,H,P); dt: (B,L,H); a: (H,) (negative);
    b, c: (B,L,N) (ngroups=1, broadcast over heads).
    Returns y: (B,L,H,P), final state (B,H,P,N)."""
    bb, l, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, l)
    l_pad = -(-l // q) * q
    # zero-pad: dt == 0 on padding makes it state-neutral (decay 1, input
    # contribution 0), so the final state and y[:l] are exact.
    x, dt, b, c = (pad_dim1(t, l_pad - l) for t in (x, dt, b, c))
    l_true, l = l, l_pad
    nc = l // q

    a_dt = a[None, None, :] * dt                        # (B,L,H) negative decay
    xr = x.reshape(bb, nc, q, h, p)
    br = b.reshape(bb, nc, q, n)
    cr = c.reshape(bb, nc, q, n)
    ar = a_dt.reshape(bb, nc, q, h).permute(0, 1, 3, 2)  # (B,C,H,Q)
    dtr = dt.reshape(bb, nc, q, h)

    a_cs = torch.cumsum(ar, dim=-1)                     # (B,C,H,Q)
    ell = torch.exp(_segsum(ar))                        # (B,C,H,Q,Q) intra decay

    # 1) intra-chunk (dual quadratic form)
    y_diag = torch.einsum("bcln,bcsn,bchls,bcsh,bcshp->bclhp",
                          cr, br, ell, dtr, xr)

    # 2) chunk states (input contribution to end-of-chunk state)
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)     # (B,C,H,Q)
    states = torch.einsum("bcln,bchl,bclh,bclhp->bchpn",
                          br, decay_states, dtr, xr)

    # 3) inter-chunk recurrence (a loop over chunks)
    chunk_decay = torch.exp(a_cs[..., -1])              # (B,C,H)
    s = (x.new_zeros((bb, h, p, n)) if init_state is None
         else init_state.to(x.dtype))
    prev = []
    for ci in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev = torch.stack(prev, 1)                         # (B,C,H,P,N) state before chunk

    # 4) state -> output within chunk
    state_decay = torch.exp(a_cs)                       # (B,C,H,Q)
    y_off = torch.einsum("bcln,bchpn,bchl->bclhp", cr, prev, state_decay)

    y = (y_diag + y_off).reshape(bb, l, h, p)[:, :l_true]
    return y, s


def _conv1d_causal(w, bias, x, state=None):
    """Depthwise causal conv.  x: (B, L, C); w: (K, C).  With ``state``
    (B, K-1, C) runs one decode step (L == 1) and returns the new state."""
    k = w.shape[0]
    if state is not None:
        xw = torch.cat([state, x], dim=1)               # (B, K, C)
        y = torch.einsum("bkc,kc->bc", xw, w)[:, None, :] + bias
        return y, xw[:, 1:]
    xp = torch.cat([x.new_zeros((x.shape[0], k - 1, x.shape[2])), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k)) + bias
    return y, None


def _ssd_inputs(xbc, dt, dt_bias, a_log, n: int):
    """x, B, C of the conv output ``xbc`` ([x | B | C], B and C ``n``
    wide), softplus(dt + dt_bias) and A = -exp(A_log)."""
    xbc = F.silu(xbc)
    din = xbc.shape[-1] - 2 * n
    xs = xbc[..., :din]
    b = xbc[..., din:din + n]
    c = xbc[..., din + n:]
    dt = F.softplus(dt.float() + dt_bias.float())
    a = -torch.exp(a_log.float())
    return xs, b, c, dt, a


def _rank_params(p: SSM, x, cfg, dl: int):
    """This rank's share of a layer split over ``model`` (``out_proj``
    holds its ``dl`` = din/m rows; ``in_proj``, the conv and the head
    vectors arrive whole, since JAX's column split of ``in_proj`` runs over
    [z | x | B | C | dt] and its conv split over [x | B | C], neither on a
    rank's heads): ``x``'s projection by its columns of z, x and dt beside
    the whole B and C (after ``shard.to_model``), its conv channels of x
    beside B's and C's, its heads' ``dt_bias``/``A_log``/``D`` and its
    slice of the gated norm's ``scale``."""
    din, nh, hp, n = _dims(cfg)
    h, r = dl // hp, shard.model_index()
    own = lambda t, lo, k: t[..., lo + r * k:lo + (r + 1) * k]
    w = p.in_proj.w
    w = torch.cat([own(w, 0, dl), own(w, din, dl), w[:, 2 * din:2 * din + 2 * n],
                   own(w, 2 * din + 2 * n, h)], -1)
    conv = [torch.cat([own(t, 0, dl), t[..., din:]], -1) for t in (p.conv_w, p.conv_b)]
    return (shard.to_model(x) @ w.to(x.dtype), *conv, own(p.dt_bias, 0, h),
            own(p.A_log, 0, h), own(p.D, 0, h), own(p.norm.scale, 0, dl))


def ssm_forward(p: SSM, x, cfg, return_state=False):
    """Full-sequence Mamba-2 block.  x: (B, S, D).  Given a rank's din/m
    rows of ``out_proj`` (the train step on a ``ProcessMesh``), it runs the
    rank's SSD heads (:func:`_rank_params`): the gated norm's sum of
    squares added over ``model``, ``out_proj`` row-parallel."""
    din, nh, hp, n = _dims(cfg)
    dl = p.out_proj.w.shape[0]
    split = dl < din
    if split:
        zxbcdt, conv_w, conv_b, dt_bias, a_log, d, scale = _rank_params(p, x, cfg, dl)
    else:
        zxbcdt = p.in_proj(x)
        conv_w, conv_b, dt_bias, a_log, d, scale = (
            p.conv_w, p.conv_b, p.dt_bias, p.A_log, p.D, p.norm.scale)
    z, xbc, dt = (zxbcdt[..., :dl], zxbcdt[..., dl:2 * dl + 2 * n],
                  zxbcdt[..., 2 * dl + 2 * n:])
    xbc, _ = _conv1d_causal(conv_w.to(x.dtype), conv_b.to(x.dtype), xbc)
    xs, b, c, dt, a = _ssd_inputs(xbc, dt, dt_bias, a_log, n)

    xh = shard.constrain(xs.reshape(*xs.shape[:-1], dl // hp, hp), "ssd_heads", nh)
    y, state = ssd_chunked(xh.float(), dt, a, b.float(), c.float(),
                           cfg.ssm_chunk)
    y = shard.constrain(y, "ssd_heads", nh)
    y = y + xh.float() * d.float()[:, None]
    y = y.reshape(*xs.shape[:-1], dl).to(x.dtype)
    y = rms_norm(scale, y * F.silu(z), whole=din if split else None)
    out = p.out_proj.row(y) if split else p.out_proj(y)
    if return_state:
        return out, state
    return out


def init_ssm_state(batch, cfg, dtype=torch.float32, device="cuda"):
    din, nh, hp, n = _dims(cfg)
    return {
        "ssd": torch.zeros((batch, nh, hp, n), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.ssm_d_conv - 1, din + 2 * n),
                            dtype=dtype, device=device),
    }


def ssm_decode(p: SSM, x, cfg, state):
    """One-token recurrent step.  x: (B, 1, D).

    Given a rank's din/m rows of ``out_proj`` it runs the rank's SSD heads
    as :func:`ssm_forward` does (:func:`_rank_params`), on its heads of
    the ``ssd`` state.  The conv state's channels [x | B | C] are split
    evenly over ``model`` by ``cache_specs``, which does not line up with
    the rank's x channels beside the whole B and C: one gather over
    ``model`` (``conv_gather``) brings every rank's state and new x
    channels, the rank convolves its own channels and keeps its share of
    the new state."""
    din, nh, hp, n = _dims(cfg)
    conv_dim = din + 2 * n
    dl = p.out_proj.w.shape[0]
    split = dl < din
    if split:
        zxbcdt, conv_w, conv_b, dt_bias, a_log, d, scale = _rank_params(p, x, cfg, dl)
    else:
        zxbcdt = p.in_proj(x)
        conv_w, conv_b, dt_bias, a_log, d, scale = (
            p.conv_w, p.conv_b, p.dt_bias, p.A_log, p.D, p.norm.scale)
    z, xbc, dt = (zxbcdt[..., :dl], zxbcdt[..., dl:2 * dl + 2 * n],
                  zxbcdt[..., 2 * dl + 2 * n:])
    cs = state["conv"]
    c_loc = cs.shape[-1]
    if not split and c_loc == conv_dim:
        xbc, conv_state = _conv1d_causal(conv_w.to(x.dtype), conv_b.to(x.dtype),
                                         xbc, cs.to(x.dtype))
    else:
        xbc, conv_state = _placed_conv(cs, xbc, conv_w, conv_b, dl, din, split)
    xs, b, c, dt, a = _ssd_inputs(xbc, dt, dt_bias, a_log, n)

    xh = xs.reshape(-1, dl // hp, hp).float()           # (B,H,P)
    dt1 = dt[:, 0]                                      # (B,H)
    dec = torch.exp(a[None] * dt1)                      # (B,H)
    # state update: s = dec*s + dt * x (outer) b
    upd = torch.einsum("bh,bhp,bn->bhpn", dt1, xh, b[:, 0].float())
    s_new = state["ssd"].float() * dec[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", c[:, 0].float(), s_new)
    y = y + xh * d.float()[:, None]
    y = y.reshape(-1, 1, dl).to(x.dtype)
    y = rms_norm(scale, y * F.silu(z), whole=din if split else None)
    out = p.out_proj.row(y) if split else p.out_proj(y)
    return out, {"ssd": s_new.to(state["ssd"].dtype),
                 "conv": conv_state.to(state["conv"].dtype)}


def _placed_conv(cs, xbc, conv_w, conv_b, dl: int, din: int, split: bool):
    """:func:`ssm_decode`'s conv step on a rank (its docstring): ``cs`` the
    rank's share of the (B, K-1, C) state (or all of it), ``xbc`` the new
    input of the rank's channels [x_r | B | C] (or all of them).  Returns
    the conv output of those channels and the rank's share of the new
    state, both in ``xbc``'s dtype."""
    bsz, km1, c_loc = cs.shape
    cdt = xbc.dtype
    conv_dim = din + xbc.shape[-1] - dl
    m, r = shard.model_shards(), shard.model_index()
    state_split = c_loc < conv_dim
    send = ([cs.float().reshape(bsz, -1)] if state_split else []) + (
        [xbc[:, 0, :dl].float()] if split else [])
    got = shard.model_gather(torch.cat(send, -1), 1, "conv_gather")
    got = got.reshape(bsz, m, -1)
    off = km1 * c_loc if state_split else 0
    whole = (torch.cat(list(got[:, :, :off].reshape(bsz, m, km1, c_loc).unbind(1)), -1)
             if state_split else cs)
    x_all = got[:, :, off:].reshape(bsz, din) if split else xbc[:, 0, :din].float()
    row = torch.cat([x_all.to(cdt), xbc[:, 0, dl:]], -1)
    window = torch.cat([whole.to(cdt), row[:, None]], 1)          # (B, K, C)
    mine = (torch.cat([window[..., r * dl:(r + 1) * dl], window[..., din:]], -1)
            if split else window)
    y = torch.einsum("bkc,kc->bc", mine, conv_w.to(cdt))[:, None, :] + conv_b.to(cdt)
    new = window[:, 1:]
    return y, (new[..., r * c_loc:(r + 1) * c_loc] if state_split else new)
