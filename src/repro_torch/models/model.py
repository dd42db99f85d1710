"""The composable LM stack (port of ``repro.models.model``): init, forward,
prefill and decode for every assigned architecture, built from the family
blocks.

``init_params(cfg, generator, device)`` returns a ``Model``: an
``nn.Module`` whose ``groups`` hold one ``ModuleList`` of ``Layer``s per
``cfg.layer_groups()`` entry -- the ``unit:`` groups of recurrentgemma
(each ``Layer`` holds its sub-blocks ``l0``, ``l1``, ...), deepseek's
``first_dense_layers`` then its MoE layers -- where the JAX package stacks
each group's params on a leading axis and runs ``lax.scan`` over it.  The
functions below take ``(params, cfg, ...)`` as the JAX ones do, so one
``Model`` serves any config of its shapes (``cfg.replace(kv_cache_dtype=
"int8")`` decodes the same weights into an int8 cache).

Caches are ``[group][layer]`` lists of dicts (a ``unit:`` layer's dict is
keyed by sub-block); attention caches are written in place, so
``decode_step`` returns the list it was given, updated.  The same layer
code serves forward, prefill and decode, so prefill + decode reproduces
forward (tests/test_torch_models.py).

Training: ``forward(..., train=True)`` runs each ``Layer`` under
``torch.utils.checkpoint`` when ``cfg.remat`` (the port of the JAX
package's per-layer ``jax.checkpoint``), and ``loss_fn`` is the JAX
package's next-token loss, chunked over the sequence, with the MoE aux and
the MTP heads' losses; autograd takes its gradients.
:func:`param_leaves` names a model's tensors by the JAX tree's leaves (a
group's layers together, as the ``LayerStack`` the JAX tree stacks on a
leading axis), which the optimizers and checkpoints work in, and
:func:`replace_params` builds a model over new tensors.
"""

from __future__ import annotations

import copy
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import shard
from .attention import (
    MLA, Attention, _mla_qkv, _positions, _prime_kv_cache, attn_decode,
    attn_forward, init_kv_cache, init_mla_cache, mla_decode, mla_forward,
)
from .blocks import MLP, Embed, Init, Linear, Norm, dtype_of
from .config import ModelConfig
from .moe import MoE, moe_apply
from .rglru import RGLRU, init_rglru_state, rglru_decode, rglru_forward
from .ssm import SSM, init_ssm_state, ssm_decode, ssm_forward

__all__ = [
    "Model", "Layer", "LayerStack", "init_params", "forward", "loss_fn",
    "logits_from_hidden", "prefill", "decode_step", "init_caches",
    "param_count", "jax_path", "param_leaves", "replace_params",
]


# ---------------------------------------------------------------------------
# per-layer modules: init / apply / prefill / decode
# ---------------------------------------------------------------------------


def _split_kinds(kind: str) -> list[str]:
    return kind[5:].split(",") if kind.startswith("unit:") else [kind]


class Layer(nn.Module):
    """One block of ``kind``: ``{"norm1", "mix"[, "norm2", "ffn"]}``, or for
    a ``unit:`` kind its sub-blocks ``{"l0", "l1", ...}``."""

    def __init__(self, kind: str, cfg: ModelConfig, init: Init):
        super().__init__()
        self.kind = kind
        if kind.startswith("unit:"):
            for i, s in enumerate(_split_kinds(kind)):
                self.add_module(f"l{i}", Layer(s, cfg, init))
            return
        d = cfg.d_model
        self.norm1 = Norm(d, cfg.norm, init)
        if kind == "ssm":
            self.mix = SSM(cfg, init)
            return
        if kind == "rec":
            self.mix = RGLRU(cfg, init)
        elif kind in ("attn_mlp", "attn_moe", "attn"):
            self.mix = (MLA if cfg.use_mla else Attention)(cfg, init)
        else:
            raise ValueError(kind)
        self.norm2 = Norm(d, cfg.norm, init)
        if kind == "attn_moe":
            self.ffn = MoE(cfg, init)
        else:
            self.ffn = MLP(d, cfg.d_ff, cfg.act, init)

    def subs(self) -> list["Layer"]:
        return [getattr(self, f"l{i}")
                for i in range(len(_split_kinds(self.kind)))]

    def _ffn(self, x, cfg, with_aux: bool = True):
        h2 = shard.seq_gather(self.norm2(x))
        if self.kind == "attn_moe":
            y, aux = moe_apply(self.ffn, h2, cfg, with_aux=with_aux)
        else:
            y, aux = self.ffn(h2), None
        return x + _stream(y, x), aux

    def forward(self, x, cfg: ModelConfig):
        """Full-sequence application -> (x, aux).  Under
        ``shard.seq_parallel`` ``x`` is the rank's tokens: each part runs
        on its normed input's whole sequence (``shard.seq_gather``) and
        hands back the rank's tokens."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.kind.startswith("unit:"):
            for sub in self.subs():
                x, a = sub(x, cfg)
                aux = aux + a
            return x, aux
        h = shard.seq_gather(self.norm1(x))
        if self.kind == "ssm":
            return x + _stream(ssm_forward(self.mix, h, cfg), x), aux
        if self.kind == "rec":
            y = rglru_forward(self.mix, h, cfg)
        else:
            y = (mla_forward if cfg.use_mla else attn_forward)(self.mix, h, cfg)
        x, a = self._ffn(x + _stream(y, x), cfg)
        return x, (aux if a is None else a)

    def decode(self, x, cfg: ModelConfig, cache, pos: int):
        """One-token step -> (x, cache)."""
        if self.kind.startswith("unit:"):
            new = {}
            for i, sub in enumerate(self.subs()):
                x, new[f"l{i}"] = sub.decode(x, cfg, cache[f"l{i}"], pos)
            return x, new
        h = self.norm1(x)
        if self.kind == "ssm":
            y, cache = ssm_decode(self.mix, h, cfg, cache)
            return x + y, cache
        if self.kind == "rec":
            y, cache = rglru_decode(self.mix, h, cfg, cache)
        elif cfg.use_mla:
            y, cache = mla_decode(self.mix, h, cfg, cache, pos)
        else:
            y, cache = attn_decode(self.mix, h, cfg, cache, pos)
        x, _ = self._ffn(x + y, cfg, with_aux=False)
        return x, cache

    def prefill(self, x, cfg: ModelConfig, max_len: int, cache=None):
        """Full-sequence application that also returns the primed cache,
        written into ``cache`` where given (in a placed serving run, the
        rank's share of it: ``init_caches(placements=)``).  Under
        ``shard.seq_parallel`` ``x`` is the rank's tokens, as in
        :meth:`forward`."""
        if self.kind.startswith("unit:"):
            caches = {}
            for i, sub in enumerate(self.subs()):
                x, caches[f"l{i}"] = sub.prefill(
                    x, cfg, max_len, None if cache is None else cache[f"l{i}"])
            return x, caches
        b = x.shape[0]
        h = shard.seq_gather(self.norm1(x))
        sq = h.shape[1]
        if cache is None:
            cache = init_layer_cache(self.kind, cfg, b, max_len, x.dtype, x.device)
        if self.kind == "ssm":
            y, state = ssm_forward(self.mix, h, cfg, return_state=True)
            din = cfg.ssm_expand * cfg.d_model
            conv_dim = din + 2 * cfg.ssm_d_state
            xbc = self.mix.in_proj(h)[..., din:din + conv_dim]
            conv = _last_rows(xbc, cfg.ssm_d_conv - 1)
            return x + _stream(y, x), _fill(cache, {"ssd": state, "conv": conv})
        if self.kind == "rec":
            y, state = rglru_forward(self.mix, h, cfg, return_state=True)
            conv = _last_rows(self.mix.in_x(h), cfg.conv1d_width - 1)
            cache = _fill(cache, {"h": state["h"], "conv": conv})
        elif cfg.use_mla:
            pos = _positions(b, sq, x.device)
            y = mla_forward(self.mix, h, cfg)
            _, _, c_kv, k_rope = _mla_qkv(self.mix, h, cfg, pos)
            s_loc = cache["ckv"].shape[1]
            _, lo = shard.cache_slots(s_loc)
            n = max(0, min(sq - lo, s_loc))
            cache["ckv"][:, :n] = c_kv[:, lo:lo + n].to(cache["ckv"].dtype)
            cache["kr"][:, :n] = k_rope[:, lo:lo + n, 0].to(cache["kr"].dtype)
        else:
            y, (k, v) = attn_forward(self.mix, h, cfg, return_kv=True)
            cache = _prime_kv_cache(cache, k, v, cfg.sliding_window)
        x, _ = self._ffn(x + _stream(y, x), cfg, with_aux=False)
        return x, cache


def _fill(cache: dict, got: dict) -> dict:
    """``cache`` (a layer's state) with each entry set from ``got``: the
    whole value, or this rank's share of its last dim where the cache
    holds a share (the width ``cache_specs`` splits over ``model``)."""
    r = shard.model_index()
    for k, v in got.items():
        n = cache[k].shape[-1]
        cache[k].copy_(v if v.shape[-1] == n else v[..., r * n:(r + 1) * n])
    return cache


def _stream(y, x):
    """A part's output ``y`` on the residual stream ``x``'s tokens: a split
    part's sum already is (``shard.from_model``); a whole part's output
    of the whole sequence is cut to the rank's (``shard.seq_local``)."""
    return y if y.shape[1] == x.shape[1] else shard.seq_local(y)


def init_layer_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                     dtype, device):
    if kind.startswith("unit:"):
        return {f"l{i}": init_layer_cache(s, cfg, batch, max_len, dtype, device)
                for i, s in enumerate(_split_kinds(kind))}
    if kind == "ssm":
        return init_ssm_state(batch, cfg, torch.float32, device)
    if kind == "rec":
        return init_rglru_state(batch, cfg, dtype, device)
    if cfg.use_mla:
        return init_mla_cache(batch, max_len, cfg, dtype, device)
    w = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    return init_kv_cache(batch, w, cfg.n_kv_heads, cfg.hd, dtype,
                         quant=cfg.kv_cache_dtype == "int8", device=device)


def _last_rows(t, kw: int):
    """The last ``kw`` rows of dim 1, zero-padded in front when shorter."""
    sq = t.shape[1]
    if sq >= kw:
        return t[:, sq - kw:, :]
    return torch.cat([t.new_zeros((t.shape[0], kw - sq, t.shape[2])), t], 1)


class _MTPHead(nn.Module):
    """``{"proj", "block", "norm"}``: a next^2-token head (deepseek-v3).
    Serving leaves it unused; ``loss_fn`` adds its loss, 0.3 times the CE
    of the token ``k`` further on, as the JAX package does."""

    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        self.proj = Linear(2 * cfg.d_model, cfg.d_model, init, scale=0.02)
        self.block = Layer("attn_mlp", cfg, init)
        self.norm = Norm(cfg.d_model, cfg.norm, init)


class Model(nn.Module):
    """``{"embed", "groups", "final_norm"[, "head"][, "mtp"]}``."""

    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        self.embed = Embed(cfg.vocab_size, cfg.d_model, init)
        self.groups = nn.ModuleList(
            nn.ModuleList(Layer(kind, cfg, init) for _ in range(count))
            for kind, count in cfg.layer_groups())
        self.final_norm = Norm(cfg.d_model, cfg.norm, init)
        if not cfg.tie_embeddings:
            self.head = Embed(cfg.vocab_size, cfg.d_model, init)
        if cfg.mtp_depth:
            self.mtp = nn.ModuleList(_MTPHead(cfg, init)
                                     for _ in range(cfg.mtp_depth))

    @property
    def device(self) -> torch.device:
        return self.embed.table.device


# ---------------------------------------------------------------------------
# whole-model init / apply
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda", placements: dict | None = None) -> Model:
    """The model of ``cfg`` in ``cfg.param_dtype`` on ``device``, drawn from
    ``generator`` (a ``torch.Generator`` on that device) with the JAX init's
    distributions and scales.  ``generator=None`` leaves the values
    uninitialised; on ``device="meta"`` that builds the shapes alone.

    ``placements`` (path -> ``launch.sharding.Placement`` of each
    :func:`param_leaves` leaf, as ``sharding.named`` gives them) cuts each
    tensor to the slice this process holds as soon as it is drawn, so the
    process never holds more than its slices and one whole tensor: the
    values are the whole init's, sliced."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if generator is not None and generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    keep = None
    if placements is not None:
        order = iter(_draw_placements(cfg, placements))
        keep = lambda t: next(order).shard(t)
    return Model(cfg, Init(generator, dev, dtype_of(cfg.param_dtype), keep))


class _DrawOrder(Init):
    """A shapes-only init (``meta``) that records its parameters in the
    order they are drawn."""

    def __init__(self, dtype):
        super().__init__(None, "meta", dtype)
        self.drawn = []

    def _param(self, t: torch.Tensor) -> nn.Parameter:
        p = super()._param(t)
        self.drawn.append(p)
        return p


def _draw_placements(cfg: ModelConfig, placements: dict) -> list:
    """The placement of each tensor ``Model(cfg, ...)`` draws, in draw
    order: its leaf's, or for a layer of a stacked leaf that leaf's
    ``row()``."""
    order = _DrawOrder(dtype_of(cfg.param_dtype))
    where = {}
    for name, prm in Model(cfg, order).named_parameters():
        path, layer = jax_path(name)
        pl = placements[tuple(path)]
        where[id(prm)] = pl if layer is None else pl.row()
    return [where[id(p)] for p in order.drawn]


def _lookup(table, cfg, tokens, dtype):
    """The rows of ``table`` (cast to ``dtype``) at ``tokens``.  Given a
    rank's V/m vocab rows (the train step on a ``ProcessMesh``): its rows
    where a token falls in them, zeros elsewhere, added over ``model``
    (one rank's row and zeros: the sum is exact).  Under
    ``shard.seq_parallel`` the rows of the rank's tokens: the sum a
    reduce-scatter, or a whole table's rows of every token cut to the
    rank's (``shard.seq_split``)."""
    v = table.shape[0]
    if v == cfg.vocab_size:
        return shard.seq_split(table.to(dtype)[tokens])
    v0 = shard.model_index() * v
    mine = (tokens >= v0) & (tokens < v0 + v)
    rows = table.to(dtype)[torch.where(mine, tokens - v0, 0)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return shard.from_model(rows, "vocab_embed")


def _embed_tokens(params: Model, cfg, tokens):
    cdt = dtype_of(cfg.compute_dtype)
    emb = _lookup(params.embed.table, cfg, tokens, cdt)
    if cfg.norm == "rmsnorm" and cfg.family in ("vlm",):
        emb = emb * torch.tensor(math.sqrt(float(cfg.d_model)), dtype=cdt)
    return emb


def _embed_inputs(params, cfg, tokens=None, input_embeds=None,
                  prefix_embeds=None):
    cdt = dtype_of(cfg.compute_dtype)
    parts = []
    if prefix_embeds is not None:
        parts.append(prefix_embeds.to(cdt))
    if input_embeds is not None:
        parts.append(input_embeds.to(cdt))
    if tokens is not None:
        parts.append(_embed_tokens(params, cfg, tokens))
    if shard.seq_parallel() and (tokens is None or len(parts) > 1):
        raise ValueError("sequence parallelism takes token inputs alone "
                         "(no prefix or input embeddings)")
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return shard.constrain(x, "act_bsd")


def forward(params: Model, cfg: ModelConfig, tokens=None, input_embeds=None,
            prefix_embeds=None, train=False):
    """Full-sequence forward -> (hidden (B,S,D), aux).  With ``train`` and
    ``cfg.remat`` each layer keeps only its input for the backward pass and
    runs again there (no layer draws random numbers, so the recompute
    gives the same values)."""
    x = _embed_inputs(params, cfg, tokens, input_embeds, prefix_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = train and cfg.remat
    call = shard.layer_call()
    for group in params.groups:
        for layer in group:
            if call is not None:
                x, a = call(layer, x, cfg)
            elif remat:
                x, a = checkpoint(layer, x, cfg, use_reentrant=False)
            else:
                x, a = layer(x, cfg)
            x = shard.constrain(x, "act_bsd")
            aux = aux + a
    x = params.final_norm(x)
    return x, aux


def logits_from_hidden(params: Model, cfg, x):
    """(..., V) logits of hidden ``x``; given a rank's V/m rows of the
    table, the rank's vocab columns (``x`` enters them through
    ``shard.to_model``)."""
    table = (params.embed if cfg.tie_embeddings else params.head).table
    if table.shape[0] < cfg.vocab_size:
        x = shard.to_model(x)
    return shard.constrain(x @ table.to(x.dtype).T, "logits", cfg.vocab_size)


def _token_nll(params: Model, cfg, x, labels):
    """Each token's f32 NLL of ``labels`` under the logits of hidden
    ``x``: ``logsumexp - gold``.  With the rank's vocab columns alone
    (vocab-parallel): the max over ``model``, then the sums of
    ``exp(logit - max)`` and of the gold logit (from the rank that owns
    it, zeros elsewhere) over ``model``, each added in coordinate order,
    so every rank gets the same bits."""
    lg = logits_from_hidden(params, cfg, x).float()
    vl = lg.shape[-1]
    if vl == cfg.vocab_size:
        gold = torch.gather(lg, -1, labels[..., None])[..., 0]
        return torch.logsumexp(lg, dim=-1) - gold
    v0 = shard.model_index() * vl
    mx = shard.model_max(lg.detach().amax(dim=-1), "vocab_ce")
    mine = (labels >= v0) & (labels < v0 + vl)
    gold = torch.gather(lg, -1, torch.where(mine, labels - v0, 0)[..., None])[..., 0]
    gold = torch.where(mine, gold, torch.zeros_like(gold))
    se = torch.exp(lg - mx[..., None]).sum(dim=-1)
    both = shard.model_add(torch.stack([se, gold]), "vocab_ce")
    return mx + torch.log(both[0]) - both[1]


def _ce_total(params: Model, cfg, x, labels, mask, chunk: int):
    """[sum of the masked NLL, sum of the mask] of hidden ``x`` against
    ``labels`` (B, S), in sequence chunks of ``chunk`` tokens where they
    divide S (else one), the same on every rank along ``model``.  Under
    ``shard.seq_parallel`` ``x`` holds the rank's tokens, and the
    cross-entropy takes the whole sequence: the rank's vocab columns
    through ``shard.seq_gather``, a whole table through
    ``shard.seq_whole``."""
    table = (params.embed if cfg.tie_embeddings else params.head).table
    split = table.shape[0] < cfg.vocab_size
    x = shard.seq_gather(x) if split else shard.seq_whole(x)
    s = x.shape[1]
    c = min(chunk, s)
    nc = s // c if s % c == 0 else 1
    c = s // nc
    tot = torch.zeros(2, dtype=torch.float32, device=x.device)
    for i in range(nc):
        lc, mc = labels[:, i * c:(i + 1) * c], mask[:, i * c:(i + 1) * c]
        nll = _token_nll(params, cfg, x[:, i * c:(i + 1) * c], lc) * mc
        tot = tot + torch.stack([nll.sum(), mc.sum()])
    return tot


def _shift(t, k: int):
    """``t[:, k:]`` zero-padded back to its length at the end of dim 1."""
    return torch.cat([t[:, k:], t.new_zeros((t.shape[0], k))], 1)


def loss_fn(params: Model, cfg: ModelConfig, tokens, labels, mask=None,
            prefix_embeds=None, loss_chunk: int = 1024):
    """Next-token CE (+ MoE aux + MTP losses) -> (loss, {"aux": aux}).

    The CE runs in sequence chunks, so the (B, S, V) f32 logits never
    exist at once: ``c = min(loss_chunk, S)`` tokens a chunk when that
    divides S, else one chunk; each chunk gives ``[sum nll, sum mask]``,
    the chunks are summed in order, and the loss is ``sum nll / max(sum
    mask, 1)``.  A vision prefix is dropped before the CE.  On a
    ``ProcessMesh`` (``shard.use_mesh_axes``) the mask's sum is the whole
    batch's (``shard.batch_sum``), so the ranks' losses add up to the
    loss of the whole batch."""
    x, aux = forward(params, cfg, tokens=tokens, prefix_embeds=prefix_embeds,
                     train=True)
    npfx = prefix_embeds.shape[1] if prefix_embeds is not None else 0
    x_txt = x[:, npfx:] if npfx else x
    b, s = labels.shape
    labels = labels.long()
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    tot = _ce_total(params, cfg, x_txt, labels, mask, loss_chunk)
    loss = tot[0] / torch.clamp(shard.batch_sum(tot[1]), min=1.0)

    if cfg.mtp_depth and hasattr(params, "mtp"):
        # MTP: predict token t+1+k from [h_t ; emb(tok_{t+k})] (deepseek-v3)
        h = x_txt
        for k, mp in enumerate(params.mtp, start=1):
            emb_next = _lookup(params.embed.table, cfg, _shift(tokens, k), h.dtype)
            h = mp.proj(torch.cat([h, emb_next], dim=-1))
            h, _ = mp.block(h, cfg)
            h = mp.norm(h)
            # blocks.cross_entropy's masked mean in one chunk,
            # vocab-parallel where the table is split
            tk = _ce_total(params, cfg, h, _shift(labels, k), _shift(mask, k), s)
            loss = loss + 0.3 * (tk[0] / torch.clamp(shard.batch_sum(tk[1]), min=1.0))
    return loss + aux, {"aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device="cuda",
                placements: dict | None = None):
    """Empty caches for ``batch`` sequences of up to ``max_len`` tokens, in
    the compute dtype, on ``device``.  ``placements`` (path ->
    ``launch.sharding.Placement`` of each ``sharding.cache_leaves`` leaf
    of these caches, as ``sharding.named`` of ``cache_specs`` gives
    them) allocates each tensor as the slice this process holds."""
    dtype = dtype_of(cfg.compute_dtype)
    if placements is None:
        return [[init_layer_cache(kind, cfg, batch, max_len, dtype, device)
                 for _ in range(count)] for kind, count in cfg.layer_groups()]
    whole = init_caches(cfg, batch, max_len, "meta")
    return [[_placed_cache(c, (g,), placements, device) for c in layers]
            for g, layers in enumerate(whole)]


def _placed_cache(tree, path: tuple, placements: dict, device):
    if isinstance(tree, dict):
        return {k: _placed_cache(v, path + (k,), placements, device)
                for k, v in tree.items()}
    pl = placements[path].row()
    if pl.shape != tuple(tree.shape):
        raise ValueError(f"cache {path}: placed for {pl.shape}, the caches of "
                         f"this call are {tuple(tree.shape)}")
    return torch.zeros(pl.local_shape, dtype=tree.dtype, device=device)


def prefill(params: Model, cfg: ModelConfig, tokens=None, input_embeds=None,
            prefix_embeds=None, max_len: int | None = None):
    """Run the prompt; return (last-token logits (B, 1, V), caches, next
    position).  In a placed serving run (``serve.engine.on_mesh``) the
    rank's rows, its share of the compute and of the caches (logits: its
    vocab columns where the tables split); ``seq_parallel`` where
    ``model`` divides the prompt."""
    run = shard.serve_runner()
    args = (cfg, tokens, input_embeds, prefix_embeds, max_len)
    if run is None:
        return _prefill(params, *args)
    n = sum(t.shape[1] for t in (prefix_embeds, input_embeds, tokens)
            if t is not None)
    with shard.sequence_split(shard.seq_splits(n, shard.model_shards())):
        return run.top(params, _prefill, *args)


def _layer_call(run, layer, method: str, *args):
    return getattr(layer, method)(*args) if run is None else \
        run.layer(layer, method, *args)


def _prefill(params: Model, cfg, tokens, input_embeds, prefix_embeds, max_len):
    x = _embed_inputs(params, cfg, tokens, input_embeds, prefix_embeds)
    s = x.shape[1] * (shard.model_shards() if shard.seq_parallel() else 1)
    max_len = max_len or cfg.max_seq_len
    run = shard.serve_runner()
    pls = shard.cache_placements()
    placed = None if pls is None else init_caches(
        cfg, x.shape[0] * shard.batch_shards(), max_len, x.device, placements=pls)
    caches = []
    for g, group in enumerate(params.groups):
        cg = []
        for i, layer in enumerate(group):
            c = None if placed is None else placed[g][i]
            x, c = _layer_call(run, layer, "prefill", x, cfg, max_len, c)
            cg.append(c)
        caches.append(cg)
    x = shard.seq_last(params.final_norm(x))
    return logits_from_hidden(params, cfg, x), caches, s


def decode_step(params: Model, cfg: ModelConfig, caches, tokens, pos: int):
    """One decode step.  tokens: (B, 1) integer ids; pos: the index being
    written.  Returns (logits (B, 1, V), caches).  In a placed serving run
    as :func:`prefill` says, the stream whole (one token)."""
    run = shard.serve_runner()
    if run is None:
        return _decode_step(params, cfg, caches, tokens, pos)
    with shard.sequence_split(False):
        return run.top(params, _decode_step, cfg, caches, tokens, pos)


def _decode_step(params: Model, cfg, caches, tokens, pos: int):
    run = shard.serve_runner()
    x = _embed_tokens(params, cfg, tokens)
    for group, cg in zip(params.groups, caches):
        for i, layer in enumerate(group):
            x, cg[i] = _layer_call(run, layer, "decode", x, cfg, cg[i], pos)
    x = params.final_norm(x)
    return logits_from_hidden(params, cfg, x), caches


def param_count(params: Model) -> int:
    return sum(p.numel() for p in params.parameters())


# ---------------------------------------------------------------------------
# the JAX tree's leaves of a Model
# ---------------------------------------------------------------------------


class LayerStack(list):
    """One leaf of the JAX param tree that stacks a layer group on a
    leading axis: the group's tensors, one a layer, in layer order.  Tree
    walkers that expand plain lists and tuples take it as one leaf."""


def jax_path(name: str):
    """(path into the JAX tree, layer index on the leaf's leading axis or
    None) of a ``Model`` parameter name: ``groups.<g>.<i>.<rest>`` is
    ``tree["groups"][g][rest...][i]``."""
    parts = name.split(".")
    if parts[0] == "groups":
        return ["groups", int(parts[1])] + parts[3:], int(parts[2])
    return [int(q) if q.isdigit() else q for q in parts], None


def param_leaves(params: Model) -> dict:
    """``params``' tensors as the JAX tree's leaves, in its leaf order: path
    (a tuple) -> the parameter, or for a layer group's leaf the
    ``LayerStack`` of its layers' parameters."""
    out: dict = {}
    for name, prm in params.named_parameters():
        path, layer = jax_path(name)
        if layer is None:
            out[tuple(path)] = prm
        else:
            out.setdefault(tuple(path), LayerStack()).append(prm)
    return {k: out[k] for k in sorted(out)}


def replace_params(params: Model, leaves: dict) -> Model:
    """A new ``Model`` of ``params``' structure over the tensors of
    ``leaves`` (keyed as :func:`param_leaves` returns them), which are
    used, not copied.  ``params`` is left as it is."""
    memo = {}
    for name, prm in params.named_parameters():
        path, layer = jax_path(name)
        t = leaves[tuple(path)]
        memo[id(prm)] = nn.Parameter(t if layer is None else t[layer],
                                     requires_grad=prm.requires_grad)
    return copy.deepcopy(params, memo)
