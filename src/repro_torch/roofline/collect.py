"""Collective bytes of one train step on a process grid (the port's
counterpart of ``repro.roofline.collect``).

The JAX module parses the compiled HLO of a step for its collectives; the
port has no compiler to read, but it has the design of its own sharded
step (``train.step``, on a ``launch.mesh.ProcessMesh``), and this module
counts what that design puts on the wire: the bytes one rank receives in
one step, by the name of the ``ProcessMesh`` call that moves them (the
keys of ``mesh.stats.wire_bytes``).  Every rank receives the same bytes.
For a leaf whose spec, validated on the mesh, splits it over axes of
``p`` tiles in all (``launch.sharding.Placement``), and the ``b`` tiles
of the batch axes, each micro-batch:

* ``param_gather``: each layer's params gathered twice (the forward, and
  the backward's recompute), every other param once: ``(p - 1)`` times
  the slice's bytes a gather, where a param of a part the step splits
  over ``model`` (``models.shard.split_kinds``) is gathered over the
  batch axes alone (``p`` the tiles of those), but for those a rank cuts
  its share from (``train.step._CUT``), gathered whole;
* ``grad_reduce_scatter``: every param's gradient (its dtype) to its
  slice, ``(b - 1)`` slices, a ``_CUT`` param's ``(b m - 1)`` (added over
  ``model`` too);
* ``batch_sum``: the loss's mask count (1 f32), each MoE layer's routing
  fractions (``E`` f32, in the forward and again in the recompute), each
  MTP head's count; ``(b - 1)`` of each;

* the sums over ``model`` of the split compute (``m - 1`` of each, in
  the tensor's dtype; ``B`` the rank's rows of the micro-batch, ``S``
  its tokens, ``D`` d_model), each split layer's in its forward, again
  in its recompute, and once in its backward (an MTP head's block:
  forward and backward): ``tp_fwd`` one (B, S, D) a row-parallel
  product (attention's ``wo``, the MLP's and the shared experts' ``wo``),
  ``moe_combine`` one (B, S, D) a split MoE; ``tp_bwd`` one (B, S, D) a
  column-parallel input (GQA attention, MLP, shared experts, the MoE's
  tokens, the logits, mamba2's ``in_proj``, RG-LRU's ``in_x``/``in_g``),
  and (B, S, 2 KV hd) for whole k and v, (B, S, q_lora_rank) and (B, S,
  kv_lora_rank + rope) for MLA's latents (in place of its input's), (B,
  S, top_k) f32 for the MoE's gates (mamba2's ``out_proj`` and RG-LRU's
  ``out`` are row-parallel products); ``norm_sum`` one (B, S) f32 a
  mamba2 layer's gated norm, in the backward too; ``lru_gather`` one (B,
  S, W/m) an RG-LRU layer (its conv output gathered; in the backward one
  ``all_to_all`` of the same size); with the tables' rows split,
  ``vocab_embed`` one (B, S, D) a lookup (the tokens and each MTP head's)
  and ``vocab_ce`` three (B, S) f32 a cross-entropy (the max, the sum of
  exp and the gold logit);

With ``seq_parallel`` (where m > 1 divides S; ``S/m`` a rank's tokens)
the sums over ``model`` above give way to the sequence's crossings, each
``(m - 1)`` times a (B, S/m, D) slice in the compute dtype, per layer in
its forward, recompute and backward (an MTP head's block: forward and
backward): ``sp_gather`` one a layer's part (its mixer, its MLP or MoE:
the normed input's all-gather, its gradient's reduce-scatter),
``sp_scatter`` one a split part's row-parallel sum (attention's or the
mixer's ``wo``, the MLP's, the MoE's combine and its shared experts', a
split vocab's lookups: a reduce-scatter, the gradient's all-gather);
``norm_sum``, ``lru_gather`` and ``vocab_ce`` stay, over the whole
sequence; a cross-entropy gathers its hidden sequence (``sp_gather``:
both ways for a split vocab; forward only for a whole one, whose lookups
gather their gradient backward, ``sp_gather`` too); no ``tp_bwd``.
Every param no split part owns but a whole vocab's tables adds its
gradient over ``model`` too (``(b m - 1)`` slices).

With ``ep_stationary`` the expert banks add nothing to ``param_gather``
or ``grad_reduce_scatter`` (``pod`` aside), and each split MoE layer
moves its dispatch buffers over ``data`` (``d`` ranks), ``(d - 1)``
times (G, E/m, C, D) / d a call where the experts spread over ``data``
and ``model`` (``ep_dispatch`` and ``ep_return``: all-to-alls), else
``(d - 1)`` times (G, E/m, C, D) (``ep_gather``, ``ep_scatter``), each
in the layer's forward, recompute and backward; G the rank's rows, C the
capacity of a group of S tokens.

and once a step ``batch_sum`` of the micro-batches' losses (``ga`` f32),
``clip`` one f32 a leaf, ``compress`` (int8 compression) one f32 a leaf,
each ``(p - 1)`` times, and ``adafactor``: a factored leaf's partial row
and column means and its row means' partial sums where the dim they
reduce is split (f32, over the tiles that split that dim), and one f32 a
leaf for its RMS.  AdamW moves nothing.  Checked against
``mesh.stats.wire_bytes`` of real steps (tests/test_torch_meshtrain.py,
tests/test_torch_tpsplit.py; ``chip_smoke.py`` phase 12) and of
``launch.dryrun``'s stand-in.

:func:`serve_step_bytes` counts one prefill or one decode step of the
placed serving run (``serve.engine.on_mesh``; ``launch.serve.
serve_on_mesh``) the same way, forward only, ``B`` the rank's rows and
``S`` the prompt's tokens (1 for a decode step):

* ``param_gather``: each param the step reads (the layers', the tables
  and the final norm; not the MTP heads) gathered once, as above (none
  under ``fsdp=False`` but for what must be whole on every rank);
* the split's sums over ``model`` of a forward (``tp_fwd``,
  ``moe_combine``, ``norm_sum``, ``lru_gather``, ``vocab_embed``; under
  ``seq_parallel``, where it splits a prefill's prompt, ``sp_gather``
  and ``sp_scatter`` as above, plus one (B, 1, D) ``sp_gather`` of the
  last token), and ``ep_stationary``'s dispatch calls (a decode step's
  group is the rank's B tokens, its capacity B);
* the caches, whose sequence (W slots: ``max_len``, a sliding window's
  ring capped at its window) ``cache_specs`` puts over ``model`` where m
  divides it: a prefill whose rank computed its KV/m heads turns them
  into its slots by one ``kv_exchange`` (an all-to-all of the ring, (B,
  W/m, KV/m, 2 hd) received from each other rank, in the cache's dtype;
  int8 codes and f32 scales in two), or with whole slots gathers them
  (``kv_write``, (B, W, KV/m, ...)); a decode step gathers the new
  token's k/v heads (``kv_write``, (B, 1, KV/m, 2 hd)), and over split
  slots the queries (``q_gather``: (B, H/m, hd), MLA's absorbed (B, H/m,
  kv_lora_rank + rope) f32) and the softmax partials (``decode_combine``:
  (B, H/m, dv + 2) f32 from each rank by one all-to-all, or (B, H, dv +
  2) by a gather where the heads do not split); mamba2's conv state and
  new x channels (``conv_gather``: (B, (K-1) C/m + din/m) f32);
* with ``pick`` (a decode step of ``serve_on_mesh``, which picks its
  input token from the last logits) the argmax over a split vocab
  (``vocab_argmax``, (B, 2) f64).
"""

from __future__ import annotations

import math
from collections import Counter

__all__ = ["train_step_bytes", "serve_step_bytes"]

_F32 = 4


def _mesh_size(mesh) -> int:
    return math.prod(int(v) for v in dict(mesh.shape).values())


def _split(pl, dim: int) -> int:
    """Tiles that split ``dim`` of a placement's leaf."""
    return math.prod(int(pl.mesh.shape[a]) for a in pl.dim_axes((dim % len(pl.shape),)))


def _tiles(pl) -> int:
    return math.prod(int(pl.mesh.shape[a]) for a in pl.axes)


def train_step_bytes(cfg, state, mesh, specs=None, grad_accum: int = 1,
                     compress_grads: bool = False, batch=None,
                     seq_parallel: bool = False, ep_stationary: bool = False) -> dict:
    """``{call: bytes}`` one rank receives in one step of the sharded train
    step of ``state`` (a ``TrainState``; shapes and dtypes are read, so it
    may live on ``meta``) placed by ``specs`` (default
    ``state_specs(state, cfg.fsdp, mesh, ep_stationary=)``) on ``mesh`` (a
    ``ProcessMesh`` or a ``MeshShape``), plus ``"total_bytes"``.
    ``batch``, the whole batch's (rows, tokens a row), sizes the sums over
    ``model``; it is needed wherever the mesh has more than one rank
    along ``model``.  ``seq_parallel``, ``ep_stationary``: the step's
    options (``train.build_train_step``)."""
    from ..launch.mesh import batch_axes
    from ..launch.sharding import (Placement, _itemsize, leaf_shape,
                                   state_specs, tree_leaves)
    from ..models.shard import seq_splits
    from ..train.step import _gather_over, _split_table

    specs = (state_specs(state, cfg.fsdp, mesh, ep_stationary=ep_stationary)
             if specs is None else specs)
    baxes = batch_axes(mesh)
    b = math.prod(int(mesh.shape[a]) for a in baxes)
    m = int(dict(mesh.shape).get("model", 1))
    table = _split_table(cfg, mesh)
    sp = bool(seq_parallel) and batch is not None and seq_splits(batch[1], m)
    opts = {"seq_parallel": sp, "ep_stationary": bool(ep_stationary)}
    leaves = tree_leaves(state.params)
    adafactor = "f" in state.opt_state
    out: Counter = Counter()
    for path, leaf in leaves.items():
        shape = leaf_shape(leaf)
        pl = Placement(mesh, specs.params[path], shape)
        size = _itemsize(leaf)
        stacked = path[0] == "groups"
        rows = shape[0] if stacked else 1
        row_bytes = math.prod(pl.local_shape[1:] if stacked else pl.local_shape) * size
        gathers = 2 if stacked else 1
        if stacked:
            kind = cfg.layer_groups()[path[1]][0]
            over, sums = _gather_over(table, kind, ".".join(map(str, path[2:])),
                                      pl, baxes, **opts)
        else:
            over, sums = _gather_over(table, None, ".".join(map(str, path)), pl,
                                      baxes, **opts)
        p = _tiles(pl) if over is None else math.prod(int(mesh.shape[a]) for a in over)
        s = math.prod(int(mesh.shape[a]) for a in sums)
        out["param_gather"] += grad_accum * gathers * rows * (p - 1) * row_bytes
        out["grad_reduce_scatter"] += grad_accum * rows * (s - 1) * row_bytes
        p_all = _tiles(pl)
        out["clip"] += (p_all - 1) * _F32
        if compress_grads:
            out["compress"] += (p_all - 1) * _F32
        if adafactor:
            out["adafactor"] += (p_all - 1) * _F32 + _factored_bytes(pl, stacked)
    if m > 1:
        if batch is None:
            raise ValueError(f"train_step_bytes: {m} ranks along 'model' split "
                             "the compute; pass batch=(rows, seq)")
        split = _sp_bytes if sp else _split_bytes
        for call, n in split(cfg, table, batch[0] // (b * grad_accum),
                             batch[1], m).items():
            out[call] += grad_accum * (m - 1) * n
        if ep_stationary:
            d = int(dict(mesh.shape).get("data", 1))
            for call, n in _ep_bytes(cfg, table, batch[0] // (b * grad_accum),
                                     batch[1], m, d, _mesh_size(mesh)).items():
                out[call] += grad_accum * (d - 1) * n
    moe = sum(n for kind, n in cfg.layer_groups() if kind == "attn_moe")
    per_micro = 1 + 2 * moe * cfg.n_experts + cfg.mtp_depth
    out["batch_sum"] += (b - 1) * _F32 * (grad_accum * per_micro + grad_accum)
    got = {k: v for k, v in out.items() if v}
    got["total_bytes"] = sum(got.values())
    return got


def _split_bytes(cfg, table: dict, rows: int, seq: int, m: int) -> dict:
    """``{call: bytes}`` of one rank's part of the sums over ``model`` in
    one micro-batch of ``rows`` x ``seq`` tokens (module docstring) with
    ``m`` ranks along ``model``, to be multiplied by ``m - 1``."""
    from ..models.blocks import dtype_of

    c = dtype_of(cfg.compute_dtype).itemsize
    tok = rows * seq
    act = tok * cfg.d_model * c
    out: Counter = Counter()

    def layer(kind: str, fwd: int):
        parts = table["layers"][kind]
        if kind == "ssm":
            if parts["heads"]:
                out["tp_fwd"] += fwd * act
                out["tp_bwd"] += act
                out["norm_sum"] += (fwd + 1) * tok * _F32
            return
        if parts.get("lru"):
            out["tp_fwd"] += fwd * act
            out["tp_bwd"] += act
            out["lru_gather"] += (fwd + 1) * tok * (cfg.lru_width or cfg.d_model) // m * c
        if parts.get("heads"):
            out["tp_fwd"] += fwd * act
            if cfg.use_mla:
                out["tp_bwd"] += tok * c * (cfg.q_lora_rank + cfg.kv_lora_rank
                                            + cfg.qk_rope_dim)
            else:
                out["tp_bwd"] += act
                if not parts["kv"]:
                    out["tp_bwd"] += tok * c * 2 * cfg.n_kv_heads * cfg.hd
        for part in ("mlp", "shared"):
            if parts.get(part):
                out["tp_fwd"] += fwd * act
                out["tp_bwd"] += act
        if parts.get("experts"):
            out["moe_combine"] += fwd * act
            out["tp_bwd"] += act + tok * cfg.top_k * _F32

    for kind, fwd in _layers(cfg):
        layer(kind, fwd)
    if table["vocab"]:
        heads = 1 + cfg.mtp_depth
        out["vocab_embed"] += heads * act
        out["vocab_ce"] += heads * 3 * tok * _F32
        out["tp_bwd"] += heads * act
    return out


def _layers(cfg):
    """(layer kind, forwards) of every layer the step runs: each of a
    group's layers (a ``unit:`` layer's sub-blocks) in its forward and
    recompute, each MTP head's block once."""
    for kind, n in cfg.layer_groups():
        for _ in range(n):
            for k in (kind[5:].split(",") if kind.startswith("unit:") else [kind]):
                yield k, 2
    for _ in range(cfg.mtp_depth):
        yield "attn_mlp", 1


def _sp_bytes(cfg, table: dict, rows: int, seq: int, m: int) -> dict:
    """:func:`_split_bytes` under ``seq_parallel`` (module docstring)."""
    from ..models.blocks import dtype_of

    c = dtype_of(cfg.compute_dtype).itemsize
    tok = rows * seq
    sl = tok // m * cfg.d_model * c            # a rank's tokens of (B, S, D)
    out: Counter = Counter()
    for kind, fwd in _layers(cfg):
        parts = table["layers"][kind]
        ways = fwd + 1                          # forward(s) and the backward
        out["sp_gather"] += ways * sl * (1 if kind == "ssm" else 2)
        mixer = parts.get({"ssm": "heads", "rec": "lru"}.get(kind, "heads"))
        ffn = [parts.get(p) for p in ("mlp", "experts", "shared")]
        out["sp_scatter"] += ways * sl * (bool(mixer) + sum(map(bool, ffn)))
        if kind == "ssm" and mixer:
            out["norm_sum"] += ways * tok * _F32
        if kind == "rec" and mixer:
            out["lru_gather"] += ways * tok * (cfg.lru_width or cfg.d_model) // m * c
    heads = 1 + cfg.mtp_depth
    # a split vocab's: the cross-entropies' hidden gathered both ways, the
    # lookups' reduce-scatter; a whole one's: the hidden gathered forward,
    # the lookups' gradients backward
    out["sp_gather"] += heads * 2 * sl
    if table["vocab"]:
        out["sp_scatter"] += heads * 2 * sl
        out["vocab_ce"] += heads * 3 * tok * _F32
    return out


def _ep_bytes(cfg, table: dict, rows: int, seq: int, m: int, d: int,
              total: int, cap: int | None = None, ways: int = 3) -> dict:
    """``ep_stationary``'s calls over ``data`` (``d`` of the mesh's
    ``total`` ranks) of one micro-batch of ``rows`` x ``seq`` tokens, to
    be multiplied by ``d - 1`` (module docstring): each in a layer's
    ``ways`` passes (forward, recompute and backward).  ``cap``: the
    capacity of a group (default that of ``seq`` tokens)."""
    from ..models.blocks import dtype_of
    from ..models.moe import capacity

    out: Counter = Counter()
    if d == 1 or not table["layers"].get("attn_moe", {}).get("experts"):
        return out
    c = dtype_of(cfg.compute_dtype).itemsize
    e = cfg.n_experts
    cap = capacity(seq, cfg.top_k, e, cfg.moe_capacity_factor) if cap is None else cap
    buf = rows * (e // m) * cap * cfg.d_model * c      # (G, E/m, C, D)
    spread = e % total == 0                   # the param rule's (data, model) branch
    moe = sum(n for kind, n in cfg.layer_groups() if kind == "attn_moe")
    names = ("ep_dispatch", "ep_return") if spread else ("ep_gather", "ep_scatter")
    for name in names:
        out[name] += moe * ways * (buf // d if spread else buf)
    return out


def _factored_bytes(pl, stacked: bool) -> int:
    """Adafactor's partial-mean bytes of one leaf (module docstring)."""
    if len(pl.shape) < 2:
        return 0
    rows, upl = 1, pl
    if stacked and len(pl.shape) > 2:
        rows, upl = pl.shape[0], pl.row()
    loc = upl.local_shape
    got = 0
    if _split(upl, -1) > 1:                       # vr: the mean over dim -1
        got += (_split(upl, -1) - 1) * math.prod(loc[:-1])
    if _split(upl, -2) > 1:                       # vc, then mean(vr, -1)
        got += (_split(upl, -2) - 1) * (math.prod(loc[:-2] + loc[-1:])
                                        + math.prod(loc[:-2]))
    return rows * got * _F32


def serve_step_bytes(cfg, params, mesh, kind: str, batch: int, seq: int, *,
                     max_len: int, specs=None, pick: bool = False,
                     seq_parallel: bool = False, ep_stationary: bool = False) -> dict:
    """``{call: bytes}`` one rank receives in one ``kind`` step
    (``"prefill"`` of ``seq`` tokens, or ``"decode"``) of the placed
    serving run (module docstring) of ``batch`` sequences whose caches
    hold ``max_len`` tokens, ``params`` (a ``Model``; shapes and dtypes
    are read, so it may live on ``meta``) placed by ``specs`` (default
    ``param_specs(params, cfg.fsdp, mesh, ep_stationary=)``) on ``mesh``,
    plus ``"total_bytes"``."""
    from ..launch.mesh import batch_axes
    from ..launch.sharding import (Placement, _itemsize, leaf_shape,
                                   param_specs, tree_leaves)
    from ..models.blocks import dtype_of
    from ..models.shard import seq_splits
    from ..train.step import _gather_over, _split_table

    specs = (param_specs(params, cfg.fsdp, mesh, ep_stationary)
             if specs is None else specs)
    baxes = batch_axes(mesh)
    m = int(dict(mesh.shape).get("model", 1))
    table = _split_table(cfg, mesh)
    out: Counter = Counter()
    for path, leaf in tree_leaves(params).items():
        if path[0] == "mtp":
            continue
        shape = leaf_shape(leaf)
        pl = Placement(mesh, specs[path], shape)
        stacked = path[0] == "groups"
        rows = shape[0] if stacked else 1
        row_bytes = math.prod(pl.local_shape[1:] if stacked else pl.local_shape) \
            * _itemsize(leaf)
        lkind = cfg.layer_groups()[path[1]][0] if stacked else None
        name = ".".join(map(str, path[2:] if stacked else path))
        over, _ = _gather_over(table, lkind, name, pl, baxes,
                               ep_stationary=ep_stationary)
        p = math.prod(int(mesh.shape[a]) for a in (pl.axes if over is None else over))
        out["param_gather"] += rows * (p - 1) * row_bytes
    if m > 1:
        rows = Placement(mesh, (baxes, None), (batch, 1)).local_shape[0]
        tok = rows * (1 if kind == "decode" else seq)
        sp = kind == "prefill" and seq_parallel and seq_splits(seq, m)
        c = dtype_of(cfg.compute_dtype).itemsize
        for call, n in _serve_split_bytes(cfg, table, rows, tok, m, c, sp).items():
            out[call] += (m - 1) * n
        for call, n in _serve_cache_bytes(cfg, table, kind, rows, m, c,
                                          max_len).items():
            out[call] += (m - 1) * n
        if ep_stationary:
            d = int(dict(mesh.shape).get("data", 1))
            group = (1, rows) if kind == "decode" else (rows, None)
            for call, n in _ep_bytes(cfg, table, group[0], seq, m, d,
                                     _mesh_size(mesh), cap=group[1],
                                     ways=1).items():
                out[call] += (d - 1) * n
        if pick and kind == "decode" and table["vocab"]:
            out["vocab_argmax"] += (m - 1) * rows * 2 * 8
    got = {k: v for k, v in out.items() if v}
    got["total_bytes"] = sum(got.values())
    return got


def _serve_layers(cfg):
    """The layer kinds a serving step runs, one a layer (a ``unit:``
    layer's sub-blocks), the MTP heads left out."""
    for kind, n in cfg.layer_groups():
        for _ in range(n):
            yield from (kind[5:].split(",") if kind.startswith("unit:") else [kind])


def _serve_split_bytes(cfg, table: dict, rows: int, tok: int, m: int, c: int,
                       sp: bool) -> dict:
    """The split's sums over ``model`` in one serving forward of ``tok``
    tokens (``rows`` of them a sequence's last), to be multiplied by
    ``m - 1`` (module docstring)."""
    act = tok * cfg.d_model * c
    sl = act // m                               # a rank's tokens under sp
    lru = (cfg.lru_width or cfg.d_model) // m
    out: Counter = Counter()
    for kind in _serve_layers(cfg):
        parts = table["layers"][kind]
        mixer = parts.get({"ssm": "heads", "rec": "lru"}.get(kind, "heads"))
        ffn = [parts.get(p) for p in ("mlp", "experts", "shared")]
        if kind == "ssm" and mixer:
            out["norm_sum"] += tok * _F32
        if kind == "rec" and mixer:
            out["lru_gather"] += tok * lru * c
        if sp:
            out["sp_gather"] += sl * (1 if kind == "ssm" else 2)
            out["sp_scatter"] += sl * (bool(mixer) + sum(map(bool, ffn)))
            continue
        out["tp_fwd"] += act * (bool(mixer) + bool(parts.get("mlp"))
                                + bool(parts.get("shared")))
        out["moe_combine"] += act * bool(parts.get("experts"))
    if sp:
        out["sp_gather"] += rows * cfg.d_model * c
        out["sp_scatter"] += sl * table["vocab"]
    else:
        out["vocab_embed"] += act * table["vocab"]
    return out


def _serve_cache_bytes(cfg, table: dict, kind: str, rows: int, m: int, c: int,
                       max_len: int) -> dict:
    """The caches' calls of one serving step (module docstring), to be
    multiplied by ``m - 1``."""
    out: Counter = Counter()
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    for lk in _serve_layers(cfg):
        parts = table["layers"][lk]
        if lk == "ssm":
            din = cfg.ssm_expand * cfg.d_model
            conv = din + 2 * cfg.ssm_d_state
            n = ((cfg.ssm_d_conv - 1) * conv // m if conv % m == 0 else 0) + \
                (din // m if parts["heads"] else 0)
            if kind == "decode" and n:
                out["conv_gather"] += rows * n * _F32
            continue
        if lk == "rec":
            continue
        heads = parts["heads"]
        if cfg.use_mla:
            w, dv, q = max_len, cfg.kv_lora_rank, cfg.kv_lora_rank + cfg.qk_rope_dim
            qb = _F32
        else:
            w = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
            dv, q, qb = hd, hd, c
        slots = cfg.seq_shard_decode and w % m == 0
        if not cfg.use_mla and parts["kv"]:
            if kind == "decode":
                out["kv_write"] += rows * (kvh // m) * 2 * hd * c
            else:
                per = ([(2 * hd, 1), (2, _F32)] if cfg.kv_cache_dtype == "int8"
                       else [(2 * hd, c)])
                ring = sum(rows * (kvh // m) * last * size for last, size in per)
                if slots:
                    out["kv_exchange"] += ring * w // m
                else:
                    out["kv_write"] += ring * w
        if kind == "decode" and slots:
            if heads:
                out["q_gather"] += rows * (h // m) * q * qb
            out["decode_combine"] += rows * (h // m if heads else h) * (dv + 2) * _F32
    return out
