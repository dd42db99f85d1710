"""Attention (port of ``repro.models.attention``): GQA/MQA/MHA with RoPE,
QKV bias, sliding window and prefix-LM, MLA (DeepSeek-V3 multi-head latent
attention), the chunked online-softmax ``flash_attention``, and decode
over (optionally int8-quantised) KV caches.

``flash_attention`` is the JAX package's plain online softmax, chunk for
chunk: queries in tiles of ``q_chunk``, keys and values streamed in tiles
of ``kv_chunk``, f32 running max and sum, the guard for a tile whose every
score is masked, the optional softcap; it never forms the (Sq x Sk)
score matrix.  No library attention is used, so the CPU tests hold the
arithmetic to JAX's.

KV caches are dicts of tensors, written in place: a ring buffer of ``W``
slots (``W`` = the sliding window, or the cache length), token ``pos`` in
slot ``pos % W``; with int8, per-(token, head) symmetric codes and f32
scales (``quantize_kv``, round half to even as ``jnp.round``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from . import shard
from .blocks import Init, Linear, Norm, apply_rope, pad_dim1

__all__ = [
    "Attention", "attn_forward", "attn_decode",
    "MLA", "mla_forward", "mla_decode",
    "flash_attention", "init_kv_cache", "init_mla_cache",
    "quantize_kv", "dequantize_kv",
]

_INT32_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# flash attention (plain torch, chunked online softmax)
# ---------------------------------------------------------------------------


def _mask(qpos, kpos, causal, window, prefix_len):
    """(..., Sq, Sk) boolean allowed-mask from position vectors."""
    qp = qpos[..., :, None]
    kp = kpos[..., None, :]
    ok = torch.ones(qpos.shape[:-1] + (qpos.shape[-1], kpos.shape[-1]),
                    dtype=torch.bool, device=qpos.device)
    if causal:
        ok = kp <= qp
        if prefix_len:
            ok = ok | ((kp < prefix_len) & (qp < prefix_len))
    if window is not None:
        ok = ok & (kp > qp - window)
    return ok


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    prefix_len: int = 0, softcap: float | None = None,
                    q_chunk: int = 512, kv_chunk: int = 1024,
                    q_offset: int = 0):
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D) with H % KV == 0.
    Returns (B, Sq, H, D).  Never materializes (Sq x Sk)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    qc = min(q_chunk, sq)
    kc = min(kv_chunk, sk)
    nq = -(-sq // qc)
    nk = -(-sk // kc)
    sq_p, sk_p = nq * qc, nk * kc
    dev = q.device

    qp = pad_dim1(q, sq_p - sq).reshape(b, nq, qc, kv, g, d)
    kp_ = pad_dim1(k, sk_p - sk).reshape(b, nk, kc, kv, d)
    vp = pad_dim1(v, sk_p - sk).reshape(b, nk, kc, kv, d)
    qpos = q_offset + torch.arange(sq_p, device=dev)
    kpos = torch.arange(sk_p, device=dev)
    kpos = torch.where(kpos < sk, kpos, _INT32_MAX)     # pad -> never allowed

    outs = []
    for i in range(nq):
        qi = qp[:, i].float()                           # (b, qc, kv, g, d)
        qpos_i = qpos[i * qc:(i + 1) * qc]
        m = torch.full((b, qc, kv, g), -math.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((b, qc, kv, g), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, qc, kv, g, d), dtype=torch.float32, device=dev)
        for j in range(nk):
            kj, vj = kp_[:, j], vp[:, j]                # (b, kc, kv, d)
            s = torch.einsum("bqkgd,bckd->bqkgc", qi, kj.float()) * scale
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            ok = _mask(qpos_i, kpos[j * kc:(j + 1) * kc], causal, window,
                       prefix_len)[None, :, None, None, :]
            s = torch.where(ok, s, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked tiles (m_new == -inf)
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(ok, p, 0.0)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqkgc,bckd->bqkgd", p, vj.float())
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs, 1).reshape(b, sq_p, h, d)[:, :sq]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache (optionally int8), decode attention
# ---------------------------------------------------------------------------


def quantize_kv(x: torch.Tensor):
    """Per-(token, head) symmetric int8: x (B,S,KV,D) -> (q, scale)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.float() * scale).to(dtype)


def init_kv_cache(batch, max_len, n_kv, hd, dtype=torch.bfloat16, quant=False,
                  device="cuda"):
    """Ring-buffer KV cache.  ``max_len`` = window size for SWA archs."""
    shape = (batch, max_len, n_kv, hd)
    if quant:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device),
            "v_s": torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _cache_write(cache, k_new, v_new, pos: int, window: int | None = None):
    """Write one token (B,1,KV,D) at ring slot pos % W, in place.  On a
    cache whose slots are split over ``model`` (a placed serving run,
    ``shard.cache_slots``) only the rank that holds the slot writes it,
    at its own index; the others write nothing (the JAX package's masked
    select)."""
    w_loc = cache["k"].shape[1]
    w, lo = shard.cache_slots(w_loc, window)
    slot = pos % w - lo
    if not 0 <= slot < w_loc:
        return cache
    if "k_s" in cache:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        cache["k"][:, slot] = kq[:, 0]
        cache["v"][:, slot] = vq[:, 0]
        cache["k_s"][:, slot] = ks[:, 0]
        cache["v_s"][:, slot] = vs[:, 0]
        return cache
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    return cache


def _cache_read(cache, dtype):
    if "k_s" in cache:
        return (dequantize_kv(cache["k"], cache["k_s"], dtype),
                dequantize_kv(cache["v"], cache["v_s"], dtype))
    return cache["k"].to(dtype), cache["v"].to(dtype)


def _prime_kv_cache(cache, k, v, window: int | None = None):
    """Prefill: the last ``min(W, S)`` tokens of k/v (B,S,KV,D) into their
    ring slots ``(S - nkeep + arange(nkeep)) % W``.

    In a placed serving run k/v may be the rank's KV/m heads and the
    cache the rank's W/m slots of every head: the rank builds the whole
    ring of its heads, and one ``all_to_all`` over ``model`` turns heads
    into slots (``shard.kv_exchange``); with whole k/v it keeps its
    slots; with whole slots it gathers the heads (``kv_write``)."""
    sq, w_loc = k.shape[1], cache["k"].shape[1]
    w, lo = shard.cache_slots(w_loc, window)
    nkeep = min(w, sq)
    slots = (sq - nkeep + torch.arange(nkeep, device=k.device)) % w
    if "k_s" in cache:
        kq, ks = quantize_kv(k[:, -nkeep:])
        vq, vs = quantize_kv(v[:, -nkeep:])
        vals = {"k": kq, "v": vq, "k_s": ks, "v_s": vs}
    else:
        vals = {"k": k[:, -nkeep:].to(cache["k"].dtype),
                "v": v[:, -nkeep:].to(cache["v"].dtype)}
    heads_split = k.shape[2] < cache["k"].shape[2]
    if w_loc == w and not heads_split:
        for name, t in vals.items():
            cache[name][:, slots] = t
        return cache
    # the rank's ring of its heads, each dtype's tensors in one message
    groups = [[n for n in vals if vals[n].dtype == dt]
              for dt in dict.fromkeys(t.dtype for t in vals.values())]
    for names in groups:
        lasts = [vals[n].shape[-1] for n in names]
        t = torch.cat([vals[n] for n in names], -1)
        ring = t.new_zeros((t.shape[0], w) + tuple(t.shape[2:]))
        ring[:, slots] = t
        if heads_split and w_loc < w:
            ring = shard.kv_exchange(ring, 1, 2)
        elif heads_split:
            ring = shard.model_gather(ring, 2, "kv_write")
        else:
            ring = ring[:, lo:lo + w_loc]
        for n, part in zip(names, torch.split(ring, lasts, -1)):
            cache[n].copy_(part)
    return cache


# ---------------------------------------------------------------------------
# standard (GQA) attention layer
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """``{"wq", "wk", "wv", "wo"}``, QKV bias per ``cfg.qkv_bias``."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = Linear(d, h * hd, init, bias=cfg.qkv_bias)
        self.wk = Linear(d, kvh * hd, init, bias=cfg.qkv_bias)
        self.wv = Linear(d, kvh * hd, init, bias=cfg.qkv_bias)
        self.wo = Linear(h * hd, d, init)


def _qkv(p: Attention, x, cfg, pos, keep_kv: bool = False):
    """q, k, v of the heads ``p`` holds.  Given a rank's H/m heads of
    ``wq`` (a split over ``model`` on a ``ProcessMesh``), q is the rank's
    heads (after ``shard.to_model``); k and v are its kv heads where
    ``wk``/``wv`` are split too, else computed whole on every rank (their
    gradient added over ``model``) and cut to the groups of the rank's q
    heads.  ``keep_kv``: also return (k, v) before that cut (the rank's
    kv heads, or all of them), which the caches take."""
    b, s, _ = x.shape
    hd = cfg.hd
    h, kvh = p.wq.w.shape[1] // hd, p.wk.w.shape[1] // hd
    split = h < cfg.n_heads
    xs = shard.to_model(x) if split else x
    q = shard.constrain(p.wq(xs).reshape(b, s, h, hd), "heads", cfg.n_heads)
    if split and kvh == cfg.n_kv_heads:
        kv = shard.to_model(torch.cat([p.wk(x), p.wv(x)], -1))
        k, v = kv[..., :kvh * hd], kv[..., kvh * hd:]
    else:
        k, v = p.wk(xs), p.wv(xs)
    k = shard.constrain(k.reshape(b, s, kvh, hd), "kv")
    v = shard.constrain(v.reshape(b, s, kvh, hd), "kv")
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    kept = (k, v)
    if split and kvh == cfg.n_kv_heads:
        k, v = _rank_groups(k, h, cfg), _rank_groups(v, h, cfg)
    return (q, k, v, kept) if keep_kv else (q, k, v)


def _rank_groups(t, h: int, cfg):
    """The kv heads of whole ``t`` (B, S, KV, D) that this rank's ``h`` q
    heads attend to: their one group's head where they lie in one group,
    else one head a q head."""
    g = cfg.n_heads // cfg.n_kv_heads
    h0 = shard.model_index() * h
    if g % h == 0:
        return t[:, :, h0 // g:h0 // g + 1]
    return t.repeat_interleave(g, dim=2)[:, :, h0:h0 + h]


def _positions(b: int, s: int, device):
    return torch.arange(s, device=device).expand(b, s)


def attn_forward(p: Attention, x, cfg, pos=None, return_kv=False):
    """Full-sequence attention (prefill).  x: (B, S, D)."""
    b, s, _ = x.shape
    if pos is None:
        pos = _positions(b, s, x.device)
    q, k, v, kept = _qkv(p, x, cfg, pos, keep_kv=True)
    o = flash_attention(
        q, k, v, causal=True, window=cfg.sliding_window,
        prefix_len=cfg.n_prefix_tokens if cfg.prefix_lm else 0,
        softcap=cfg.logit_softcap,
    )
    o = o.reshape(b, s, -1)
    o = p.wo.row(o) if q.shape[2] < cfg.n_heads else p.wo(o)
    if return_kv:
        return o, kept
    return o


def _partials(s, valid, v, einsum: str):
    """This rank's softmax partials over its slots (``shard.
    softmax_combine``): the weighted values, the running max and the sum
    of the weights of the f32 scores ``s`` (slots last), masked by
    ``valid``."""
    s = torch.where(valid, s, -math.inf)
    mx = s.amax(dim=-1)
    safe = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    pe = torch.where(valid, torch.exp(s - safe[..., None]), 0.0)
    return torch.einsum(einsum, pe, v), mx, pe.sum(dim=-1)


def attn_decode(p: Attention, x, cfg, cache, pos: int):
    """One-token decode.  x: (B, 1, D); pos: the current index.  The cache
    is a ring buffer of W slots; attention runs over all of it, each slot
    masked by the absolute position it holds.

    In a placed serving run the cache may hold the rank's W/m slots of
    every kv head (``shard.cache_slots``): the new token's k/v is made
    whole where the rank computed its kv heads (``kv_write``) and the
    slot's owner writes it, q is gathered over ``model`` (``q_gather``),
    each rank scores its slots of every head (the mask from the global
    slot indices) and the partials merge over ``model``
    (``shard.softmax_combine``), which hands each rank its heads for the
    row-parallel ``wo``."""
    b = x.shape[0]
    hd = cfg.hd
    posv = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q, _, _, (k_new, v_new) = _qkv(p, x, cfg, posv, keep_kv=True)
    h = q.shape[2]
    split = h < cfg.n_heads
    if k_new.shape[2] < cache["k"].shape[2]:
        kv = shard.model_gather(torch.cat([k_new, v_new], -1), 2, "kv_write")
        k_new, v_new = kv[..., :hd], kv[..., hd:]
    cache = _cache_write(cache, k_new, v_new, pos, cfg.sliding_window)
    k, v = _cache_read(cache, torch.float32)     # (B, W, KV, D)
    w_loc = k.shape[1]
    w, lo = shard.cache_slots(w_loc, cfg.sliding_window)
    # ring-buffer absolute positions: slot t holds token pos - ((pos - t) % W)
    slots = lo + torch.arange(w_loc, device=x.device)
    age = (pos - slots) % w
    valid = (pos - age) >= 0
    if cfg.sliding_window:
        valid = valid & (age < cfg.sliding_window)
    if w_loc < w:
        qa = shard.model_gather(q, 2, "q_gather") if split else q
        kvh, nh = cfg.n_kv_heads, cfg.n_heads
        s = torch.einsum("bqkgd,bckd->bqkgc",
                         qa.reshape(b, 1, kvh, nh // kvh, hd).float(), k) / math.sqrt(hd)
        if cfg.logit_softcap:
            s = cfg.logit_softcap * torch.tanh(s / cfg.logit_softcap)
        acc, mx, sm = _partials(s, valid[None, None, None, None, :], v,
                                "bqkgc,bckd->bqkgd")
        o = shard.softmax_combine(acc.reshape(b, nh, hd), mx.reshape(b, nh),
                                  sm.reshape(b, nh), to_heads=split)
        o = o.reshape(b, 1, -1).to(x.dtype)
        return (p.wo.row(o) if split else p.wo(o)), cache
    if split:
        k, v = _rank_groups(k, h, cfg), _rank_groups(v, h, cfg)
    kvh = k.shape[2]
    g = h // kvh
    s = torch.einsum("bqkgd,bckd->bqkgc",
                     q.reshape(b, 1, kvh, g, hd).float(), k) / math.sqrt(hd)
    if cfg.logit_softcap:
        s = cfg.logit_softcap * torch.tanh(s / cfg.logit_softcap)
    s = torch.where(valid[None, None, None, None, :], s, -math.inf)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgc,bckd->bqkgd", pr, v)
    o = o.reshape(b, 1, h * hd).to(x.dtype)
    return (p.wo.row(o) if split else p.wo(o)), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# ---------------------------------------------------------------------------


class MLA(nn.Module):
    """``{"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}``."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
        nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        self.wq_a = Linear(d, qr, init)
        self.q_norm = Norm(qr, "rmsnorm", init)
        self.wq_b = Linear(qr, h * (nope + rope), init)
        self.wkv_a = Linear(d, kr + rope, init)
        self.kv_norm = Norm(kr, "rmsnorm", init)
        self.wkv_b = Linear(kr, h * (nope + vd), init)
        self.wo = Linear(h * vd, d, init)


def _mla_qkv(p: MLA, x, cfg, pos):
    """q (nope, rope parts), the latent c_kv and the shared k_rope of the
    heads ``p`` holds: with a rank's H/m heads of ``wq_b`` (the train step
    on a ``ProcessMesh``) the latent query enters them through
    ``shard.to_model``."""
    b, s, _ = x.shape
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    kr = cfg.kv_lora_rank
    h = p.wq_b.w.shape[1] // (nope + rope)

    cq = p.q_norm(p.wq_a(x))
    if h < cfg.n_heads:
        cq = shard.to_model(cq)
    q = shard.constrain(p.wq_b(cq).reshape(b, s, h, nope + rope), "heads",
                        cfg.n_heads)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)

    kv_a = p.wkv_a(x)                                   # (B, S, kr + rope)
    c_kv = p.kv_norm(kv_a[..., :kr])
    k_rope = apply_rope(kv_a[..., None, kr:], pos, cfg.rope_theta)  # (B,S,1,rope)
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(p: MLA, x, cfg, pos=None):
    """Full-sequence MLA (prefill): expand K, V from the latent and run
    flash attention with KV heads == H (the heads ``p`` holds: a rank's
    H/m on a ``ProcessMesh``, whose latent and k_rope enter them through
    ``shard.to_model`` and whose ``wo`` is row-parallel)."""
    b, s, _ = x.shape
    nope, vd, kr = cfg.qk_nope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    h = p.wkv_b.w.shape[1] // (nope + vd)
    split = h < cfg.n_heads
    if pos is None:
        pos = _positions(b, s, x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, pos)
    if split:
        lat = shard.to_model(torch.cat([c_kv, k_rope[:, :, 0]], dim=-1))
        c_kv, k_rope = lat[..., :kr], lat[..., None, kr:]
    kv = shard.constrain(p.wkv_b(c_kv).reshape(b, s, h, nope + vd), "heads",
                         cfg.n_heads)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, k_rope.expand(b, s, h, cfg.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    # pad V's head_dim up to K's so flash can run one pass; slice after.
    dq = q.shape[-1]
    v_pad = torch.cat([v, v.new_zeros(v.shape[:-1] + (dq - vd,))], dim=-1)
    o = flash_attention(q, k, v_pad, causal=True)[..., :vd].reshape(b, s, h * vd)
    return p.wo.row(o) if split else p.wo(o)


def init_mla_cache(batch, max_len, cfg, dtype=torch.bfloat16, device="cuda"):
    """Latent cache: c_kv (kr) + k_rope (rope) per token -- the MLA win."""
    return {
        "ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "kr": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                          device=device),
    }


def mla_decode(p: MLA, x, cfg, cache, pos: int):
    """Absorbed-form MLA decode: scores and values computed directly in the
    latent space (per-head absorption of wkv_b), O(kr) per cached token.
    The latent cache is written at slot ``pos`` (no ring: a ``pos`` past
    the cache writes nothing, as the JAX package's masked select).

    With a rank's H/m heads (``wq_b``/``wkv_b``/``wo`` split over
    ``model``) it runs those; in a placed serving run whose latent cache
    holds the rank's S/m slots (``shard.cache_slots``) the slot's owner
    writes the new latent, the heads' absorbed queries are gathered over
    ``model`` (``q_gather``), each rank scores its slots of every head
    and the partial contexts merge over ``model``
    (``shard.softmax_combine``), back to the rank's heads."""
    b = x.shape[0]
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kr = cfg.kv_lora_rank
    h = p.wkv_b.w.shape[1] // (nope + vd)
    split = h < cfg.n_heads
    posv = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(p, x, cfg, posv)

    s_loc = cache["ckv"].shape[1]
    s_all, lo = shard.cache_slots(s_loc)
    if 0 <= pos - lo < s_loc:
        cache["ckv"][:, pos - lo] = c_kv_new[:, 0].to(cache["ckv"].dtype)
        cache["kr"][:, pos - lo] = k_rope_new[:, 0, 0].to(cache["kr"].dtype)

    wkv = p.wkv_b.w.reshape(kr, h, nope + vd)
    w_uk = wkv[..., :nope]                              # (kr, H, nope)
    w_uv = wkv[..., nope:]                              # (kr, H, vd)

    # absorb: q_eff (B, H, kr) = q_nope . w_uk
    q_eff = torch.einsum("bqhn,khn->bhk", q_nope.float(), w_uk.float())
    ckv = cache["ckv"].float()                          # (B, S, kr)
    krope = cache["kr"].float()                         # (B, S, rope)
    scale = 1.0 / math.sqrt(nope + rope)
    mask = lo + torch.arange(s_loc, device=x.device) <= pos
    if s_loc < s_all:
        qq = torch.cat([q_eff, q_rope[:, 0].float()], -1)
        if split:
            qq = shard.model_gather(qq, 1, "q_gather")
        s = (torch.einsum("bhk,bsk->bhs", qq[..., :kr], ckv)
             + torch.einsum("bhr,bsr->bhs", qq[..., kr:], krope)) * scale
        acc, mx, sm = _partials(s, mask[None, None, :], ckv, "bhs,bsk->bhk")
        ctx = shard.softmax_combine(acc, mx, sm, to_heads=split)
    else:
        s_lat = torch.einsum("bhk,bsk->bhs", q_eff, ckv)
        s_rope = torch.einsum("bqhr,bsr->bhs", q_rope.float(), krope)
        s = (s_lat + s_rope) * scale
        s = torch.where(mask[None, None, :], s, -math.inf)
        pr = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhs,bsk->bhk", pr, ckv)     # context in latent space
    o = torch.einsum("bhk,khv->bhv", ctx, w_uv.float())
    o = o.reshape(b, 1, h * vd).to(x.dtype)
    return (p.wo.row(o) if split else p.wo(o)), cache
