"""Activation-sharding hints of the model zoo (port of
``repro.models.shard``), and the seams of a model trained on a
``launch.mesh.ProcessMesh``.

The JAX package pins the sharding of hot activations with
``constrain(x, kind)`` inside ``use_mesh_axes(mesh, ...)``.
``jax.lax.with_sharding_constraint`` is the identity on values, and so is
the port's ``constrain``: under ``use_mesh_axes`` with a ``ProcessMesh``
it validates the kind's spec against the activation's global shape (the
batch dim times the batch shards), as the JAX one does, and checks the
rank's local shape (a dim the spec puts on ``model`` holds 1/m of its
``whole`` size where m divides it), then returns ``x``; on one card it is
the identity and checks nothing.

The process grid splits the batch over the batch axes, and the compute of
every layer kind over ``model`` where :func:`split_kinds` says its units
divide (Megatron's pattern, as the JAX package's placement implies): a
rank runs its own heads, ``d_ff`` columns, experts, vocab rows, SSD heads
(mamba2) and RG-LRU width, read from the local shapes of the params the
train step hands it.  Two crossings join the ranks along ``model``:
:func:`to_model` (the identity forward; its backward adds the gradient
over ``model``) in front of a column-parallel product, and
:func:`from_model` (adds over ``model`` forward; the identity backward)
after a row-parallel one.  :func:`model_max` is the vocab-parallel loss's
max; :func:`model_allsum` (adds over ``model`` forward and backward) the
gated RMSNorm's sum of squares over a split width; :func:`model_concat`
(gathers a split activation's last dim forward; the backward hands each
rank its slice of the gradient added over ``model``) the RG-LRU gates'
input.  Every sum gathers the partials (``mesh.gather``, or one
``mesh.all_to_all`` for :func:`model_concat`'s backward) and adds them in
coordinate order, so every rank along ``model`` gets the same bits; each
is counted in ``mesh.stats`` under its call site's name.  All of them are
the identity outside a ``ProcessMesh``.

A rank of a ``ProcessMesh`` holds its batch shard, so where the loss
reduces over the batch it needs the other shards' numbers too:
:func:`batch_sum` adds a value over the batch shards (the ranks of this
rank's group along the batch axes, in coordinate order) and
:func:`batch_shards` counts them; both are the identity (1) outside such
a context.  :func:`layer_call` is the runner the train step installs
with :func:`running_layers`, so that ``models.model.forward`` runs each
layer from its params' shards.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch

__all__ = ["use_mesh_axes", "active", "constrain", "batch_sum",
           "batch_shards", "running_layers", "layer_call", "model_shards",
           "model_index", "to_model", "from_model", "model_sum", "model_max",
           "model_allsum", "model_concat", "ssd_heads", "split_kinds"]

_CTX: dict = {"on": False}


@contextmanager
def use_mesh_axes(mesh, batch=("data",), model="model",
                  seq_parallel=False, ep_stationary=False):
    """Install the activation-sharding axes for the duration of a call
    (the JAX signature)."""
    prev = dict(_CTX)
    _CTX.update(on=True, mesh=mesh,
                batch=(batch,) if isinstance(batch, str) else tuple(batch),
                model=model, seq_parallel=bool(seq_parallel),
                ep_stationary=bool(ep_stationary))
    try:
        yield
    finally:
        _CTX.clear()
        _CTX.update(prev)


def active() -> bool:
    return bool(_CTX.get("on"))


def _process_mesh():
    """The installed mesh where it is a ``ProcessMesh``, else None."""
    mesh = _CTX.get("mesh") if _CTX.get("on") else None
    return mesh if getattr(mesh, "per_process", False) else None


def _spec_for(kind: str, ndim: int, shape: tuple = ()) -> tuple:
    b, m = _CTX["batch"], _CTX["model"]
    sp = m if _CTX.get("seq_parallel") else None
    table = {
        # (leading batch dim, then fixed tail); padded with None to ndim
        "act_bsd": (b, sp, None),              # (B, S, D) residual stream
        "act_bsf": (b, None, m),               # (B, S, F) ffn hidden
        "logits": (b, None, m),                # (B, S, V)
        "heads": (b, None, m, None),           # (B, S, H, D)
        "kv": (b, None, None, None),           # (B, S, KV, D) kv<model: repl
        "batch_only": (b,),                    # anything (B, ...)
        "moe_buf": (b, m, None, None),         # (G, E, C, D)
        "ssd_heads": (b, None, m, None),       # (B, L, H, P)
        "state_bh": (b, m),                    # (B, H, ...) decode states
    }
    if kind == "moe_buf" and _CTX.get("ep_stationary") and len(shape) >= 2:
        total = math.prod(int(v) for v in dict(_CTX["mesh"].shape).values())
        if shape[1] % total == 0:
            return ((None, tuple(b) + (m,), None, None) + (None,) * ndim)[:ndim]
        return ((None, m, None, None) + (None,) * ndim)[:ndim]
    if kind not in table:
        raise KeyError(kind)
    spec = table[kind]
    return (spec + (None,) * (ndim - len(spec)))[:ndim]


def _model_dims(kind: str, ndim: int) -> list:
    """The dims the kind's spec puts on ``model``."""
    m = _CTX["model"]
    return [d for d, e in enumerate(_spec_for(kind, ndim))
            if e == m or (isinstance(e, tuple) and m in e)]


def constrain(x, kind: str, whole: int | None = None):
    """``x``; under ``use_mesh_axes`` with a ``ProcessMesh``, first the
    kind's spec validated against ``x``'s global shape, and with ``whole``
    (the global size of the dim the spec puts on ``model``) the rank's
    local size of that dim checked: ``whole / m`` where m divides
    ``whole``, else ``whole`` (module docstring).  Raises ``ValueError``
    on a local shape the split does not give."""
    mesh = _process_mesh()
    if mesh is None:
        return x
    from ..ft.remesh import validate_spec

    shape = tuple(x.shape)
    if shape:
        shape = (shape[0] * batch_shards(),) + shape[1:]
    if whole is not None:
        m = model_shards()
        want = whole // m if whole % m == 0 else whole
        for d in _model_dims(kind, x.ndim):
            if x.shape[d] != want:
                raise ValueError(
                    f"constrain {kind!r}: dim {d} holds {x.shape[d]} on this "
                    f"rank; split over {m} ranks along {_CTX['model']!r} the "
                    f"whole {whole} leaves {want}")
            shape = shape[:d] + (whole,) + shape[d + 1:]
    validate_spec(shape, _spec_for(kind, x.ndim, shape), mesh)
    return x


def batch_shards() -> int:
    """How many shards the batch is split into: the product of the batch
    axes' sizes on the installed ``ProcessMesh``, else 1."""
    mesh = _process_mesh()
    if mesh is None:
        return 1
    return math.prod(int(mesh.shape[a]) for a in _CTX["batch"])


def batch_sum(x):
    """``x`` added over the batch shards: this rank's value and those of
    its group along the batch axes, gathered (``mesh.gather``) and added
    in coordinate order, so every rank gets the same bits.  The identity
    outside a ``ProcessMesh``.  Values only: no gradient flows through
    the other ranks' terms (callers pass counts and routing fractions)."""
    mesh = _process_mesh()
    if mesh is None or batch_shards() == 1:
        return x
    got = mesh.gather(x.detach().reshape(1, -1), _CTX["batch"], "batch_sum")[0]
    acc = got[0]
    for c in range(1, got.shape[0]):
        acc = acc + got[c]
    return acc.view(x.shape)


@contextmanager
def running_layers(call):
    """Run every layer of ``models.model.forward`` through ``call(layer,
    x, cfg) -> (x, aux)`` for the duration of the context."""
    prev = _CTX.get("layer_call")
    _CTX["layer_call"] = call
    try:
        yield
    finally:
        _CTX["layer_call"] = prev


def layer_call():
    """The installed layer runner, or None."""
    return _CTX.get("layer_call")


# -- the model axis ----------------------------------------------------------


def model_shards() -> int:
    """Ranks along ``model`` on the installed ``ProcessMesh``, else 1."""
    mesh = _process_mesh()
    return 1 if mesh is None else int(mesh.shape[_CTX["model"]])


def model_index() -> int:
    """This rank's coordinate along ``model`` on the installed
    ``ProcessMesh``, else 0."""
    mesh = _process_mesh()
    if mesh is None:
        return 0
    return int(mesh.coords[mesh.axis_names.index(_CTX["model"])])


def _model_gather(x, what: str):
    """(m, numel) of this rank's ``x`` and its group's along ``model``, in
    coordinate order."""
    return _process_mesh().gather(x.detach().reshape(1, -1), (_CTX["model"],),
                                  what)[0]


def model_sum(x, what: str):
    """``x`` added over the ranks along ``model`` in coordinate order, in
    f32 and cast back to ``x``'s dtype; values only.  The identity
    outside a ``ProcessMesh`` or with one rank along ``model``."""
    if model_shards() == 1:
        return x
    got = _model_gather(x, what)
    acc = got[0].float()
    for c in range(1, got.shape[0]):
        acc = acc + got[c].float()
    return acc.to(x.dtype).view(x.shape)


def model_max(x, what: str):
    """The elementwise max of ``x`` over the ranks along ``model`` (exact
    in any order); values only."""
    if model_shards() == 1:
        return x
    return _model_gather(x, what).amax(dim=0).view(x.shape)


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return model_sum(g, "tp_bwd")


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, what):
        return model_sum(x, what)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, what):
        ctx.what = what
        return model_sum(x, what)

    @staticmethod
    def backward(ctx, g):
        return model_sum(g, ctx.what), None


class _Concat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, what):
        ctx.what, ctx.shape = what, x.shape
        got = _model_gather(x, what)                   # (m, numel)
        m = got.shape[0]
        return got.view(m, -1, x.shape[-1]).movedim(0, 1).reshape(
            *x.shape[:-1], m * x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        m, k = model_shards(), ctx.shape[-1]
        send = g.reshape(-1, m, k).movedim(1, 0).reshape(1, m, -1)
        got = _process_mesh().all_to_all(send, (_CTX["model"],), ctx.what)[0]
        acc = got[0].float()
        for c in range(1, m):
            acc = acc + got[c].float()
        return acc.to(g.dtype).view(ctx.shape), None


def to_model(x):
    """Where a value every rank along ``model`` holds whole enters the
    rank's own part of a split computation: the identity forward; the
    backward adds the ranks' partial gradients over ``model``
    (``tp_bwd``)."""
    return x if model_shards() == 1 else _ToModel.apply(x)


def from_model(x, what: str):
    """The ranks' partials of a split computation added over ``model``
    (``what``); the backward hands each rank the whole gradient."""
    return x if model_shards() == 1 else _FromModel.apply(x, what)


def model_allsum(x, what: str):
    """The ranks' partials added over ``model`` where every rank's result
    depends on every partial: the sum forward, and the sum of the ranks'
    gradients backward (``to_model(from_model(x))`` in one call a way),
    both counted as ``what``."""
    return x if model_shards() == 1 else _AllSum.apply(x, what)


def model_concat(x, what: str):
    """The ranks' slices of a split activation's last dim, concatenated
    in coordinate order (one ``mesh.gather``, ``what``); the backward
    hands each rank its slice of the gradient added over ``model`` (one
    ``mesh.all_to_all``, ``what``)."""
    return x if model_shards() == 1 else _Concat.apply(x, what)


# -- what splits -------------------------------------------------------------


def ssd_heads(cfg) -> int:
    """A mamba2 layer's SSD heads, ``ssm_expand d_model / ssm_headdim``
    (not ``n_heads``)."""
    return cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim


def _base_kinds(cfg) -> list:
    kinds = []
    for kind, _ in cfg.layer_groups():
        for k in (kind[5:].split(",") if kind.startswith("unit:") else [kind]):
            if k not in kinds:
                kinds.append(k)
    if cfg.mtp_depth and "attn_mlp" not in kinds:
        kinds.append("attn_mlp")           # the MTP heads' blocks
    return kinds


def split_kinds(cfg, m: int) -> dict:
    """The one table of what the train step on a ``ProcessMesh`` with
    ``m`` ranks along ``model`` splits: ``{"layers": {kind: {part:
    bool}}, "vocab": bool}`` for each layer kind of ``cfg`` (a ``unit:``
    group's sub-blocks, the MTP heads' block).  A part splits where its
    units divide by ``m``: ``heads`` (wq/wo, MLA's wq_b/wkv_b/wo; an
    ``ssm`` layer's SSD heads, :func:`ssd_heads`), ``kv`` (wk/wv: kv
    heads, and only with the heads), ``mlp`` (d_ff, also a ``rec``
    layer's MLP), ``experts`` (E), ``shared`` (the shared experts' d_ff),
    ``lru`` (a ``rec`` layer's RG-LRU width); ``vocab`` the tables' rows.
    A part that does not split runs whole (its params gathered whole, as
    in the step without the split)."""
    div = lambda n: bool(n) and m > 1 and n % m == 0
    layers = {}
    for kind in _base_kinds(cfg):
        if kind == "ssm":
            layers[kind] = {"heads": div(ssd_heads(cfg))}
            continue
        if kind == "rec":
            layers[kind] = {"lru": div(cfg.lru_width or cfg.d_model),
                            "mlp": div(cfg.d_ff)}
            continue
        heads = div(cfg.n_heads)
        parts = {"heads": heads}
        if not cfg.use_mla:
            parts["kv"] = heads and div(cfg.n_kv_heads)
        if kind == "attn_moe":
            parts["experts"] = div(cfg.n_experts)
            if cfg.n_shared_experts:
                parts["shared"] = div(cfg.n_shared_experts
                                      * (cfg.d_ff_expert or cfg.d_ff))
        else:
            parts["mlp"] = div(cfg.d_ff)
        layers[kind] = parts
    return {"layers": layers, "vocab": div(cfg.vocab_size)}
