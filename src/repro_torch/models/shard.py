"""Activation-sharding hints of the model zoo (port of
``repro.models.shard``), and the seams of a model trained on a
``launch.mesh.ProcessMesh``.

The JAX package pins the sharding of hot activations with
``constrain(x, kind)`` inside ``use_mesh_axes(mesh, ...)``.
``jax.lax.with_sharding_constraint`` is the identity on values, and so is
the port's ``constrain``: under ``use_mesh_axes`` with a ``ProcessMesh``
it validates the kind's spec against the activation's global shape (each
dim's local size times the tiles of its spec entry), as the JAX one does,
and checks the rank's local shape (a dim the spec puts on ``model``,
alone or with other axes, holds its ``whole`` size over those tiles where
they divide it), then returns ``x``; on one card it is the identity and
checks nothing.

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
``mesh.all_to_all`` for a reduce-scatter) and adds them in
coordinate order, so every rank along ``model`` gets the same bits; each
is counted in ``mesh.stats`` under its call site's name.  All of them are
the identity outside a ``ProcessMesh``.

With ``seq_parallel`` (Megatron-SP, the JAX package's ``sp``) the
residual stream between layers is split over ``model`` along the
sequence as well: a rank holds (B/d, S/m, D), its own S/m tokens
(:func:`seq_parallel`; the train step installs it only where m divides
S, as ``validate_spec`` drops an axis that does not divide).  A layer
gathers its normed input's sequence (:func:`seq_gather`: an all-gather
forward, a reduce-scatter of the gradient backward, both ``sp_gather``),
runs everything that mixes positions on the whole sequence, and a split
part's row-parallel sum becomes a reduce-scatter back to the rank's
tokens (:func:`from_model`: ``sp_scatter`` both ways); :func:`to_model`
is then the identity both ways (the layer's gather adds the ranks'
partial gradients), and a part that runs whole keeps its own tokens of
its output (:func:`seq_local`).  A whole vocab's lookup and
cross-entropy run whole and alike on every rank, so their table's
gradient is whole on each (:func:`seq_split`, :func:`seq_whole`: one
all-gather a way, no sum).  With ``ep_stationary`` the expert banks
stay on their ranks and the tokens move (:func:`expert_dispatch`,
:func:`expert_return`, :func:`batch_gather`, :func:`batch_scatter`; see
``models.moe``).

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
           "model_index", "to_model", "from_model", "model_add", "model_sum",
           "model_max", "model_allsum", "model_concat", "ssd_heads",
           "split_kinds", "seq_parallel", "ep_stationary", "seq_splits",
           "seq_gather", "seq_whole", "seq_split", "seq_local",
           "own_tokens_grad", "expert_dispatch",
           "expert_return", "batch_gather", "batch_scatter", "EP_AXIS",
           "serving", "serve_runner", "cache_placements", "cache_slots",
           "sequence_split", "model_gather", "softmax_combine",
           "model_argmax", "seq_last", "kv_exchange"]

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


def _entry_axes(e) -> tuple:
    return () if e is None else (e,) if isinstance(e, str) else tuple(
        a for x in e for a in ((x,) if isinstance(x, str) else x))


def constrain(x, kind: str, whole: int | None = None):
    """``x``; under ``use_mesh_axes`` with a ``ProcessMesh``, first the
    kind's spec validated against ``x``'s global shape (each dim's local
    size times the tiles of its spec entry), and with ``whole`` (the
    global size of the dim the spec puts on ``model``, alone or in a
    tuple of axes) the rank's local size of that dim checked: ``whole``
    over the entry's tiles where they divide it, else ``whole`` (module
    docstring).  Raises ``ValueError`` on a local shape the split does
    not give."""
    mesh = _process_mesh()
    if mesh is None:
        return x
    from ..ft.remesh import validate_spec

    m_ax = _CTX["model"]
    shape = list(x.shape)
    on_m = [d for d, e in enumerate(_spec_for(kind, x.ndim))
            if m_ax in _entry_axes(e)]
    hint = tuple(whole if whole is not None and d in on_m else n
                 for d, n in enumerate(shape))
    spec = _spec_for(kind, x.ndim, hint)
    for d, e in enumerate(spec):
        axes = _entry_axes(e)
        n = math.prod(int(mesh.shape[a]) for a in axes)
        if whole is not None and m_ax in axes:
            want = whole // n if whole % n == 0 else whole
            if x.shape[d] != want:
                over = axes[0] if len(axes) == 1 else axes
                raise ValueError(
                    f"constrain {kind!r}: dim {d} holds {x.shape[d]} on this "
                    f"rank; split over {n} ranks along {over!r} the "
                    f"whole {whole} leaves {want}")
            shape[d] = whole
        else:
            shape[d] *= n
    validate_spec(tuple(shape), spec, mesh)
    return x


def batch_shards() -> int:
    """How many shards the batch is split into: the product of the batch
    axes' sizes on the installed ``ProcessMesh``, else 1."""
    mesh = _process_mesh()
    if mesh is None:
        return 1
    return math.prod(int(mesh.shape[a]) for a in _CTX["batch"])


def batch_index() -> int:
    """This rank's index among the batch shards on the installed
    ``ProcessMesh`` (its coordinates along the batch axes, row-major, as
    ``launch.sharding.Placement`` numbers a dim's tiles), else 0."""
    mesh = _process_mesh()
    if mesh is None:
        return 0
    names = mesh.axis_names
    idx = 0
    for a in _CTX["batch"]:
        idx = idx * int(mesh.shape[a]) + int(mesh.coords[names.index(a)])
    return idx


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


def to_model(x):
    """Where a value every rank along ``model`` holds whole enters the
    rank's own part of a split computation: the identity forward; the
    backward adds the ranks' partial gradients over ``model``
    (``tp_bwd``).  Under :func:`seq_parallel` the identity both ways: the
    layer gathered ``x``'s sequence (:func:`seq_gather`), whose backward
    adds those partials."""
    return x if model_shards() == 1 or seq_parallel() else _ToModel.apply(x)


def from_model(x, what: str):
    """The ranks' partials of a split computation added over ``model``
    (``what``); the backward hands each rank the whole gradient.  Under
    :func:`seq_parallel` ``x`` is a partial of the whole sequence, and the
    sum is a reduce-scatter to this rank's tokens (``sp_scatter``; its
    backward all-gathers the gradient's sequence)."""
    if model_shards() == 1:
        return x
    if seq_parallel():
        return _Scatter.apply(x, (_CTX["model"],), 1, "sp_scatter")
    return _FromModel.apply(x, what)


def model_add(x, what: str):
    """:func:`from_model` without the sequence: the partials added over
    ``model`` forward (``what``), the identity backward, whatever the
    residual stream's split (the vocab-parallel loss's sums)."""
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
    if model_shards() == 1:
        return x
    return _Gather.apply(x, (_CTX["model"],), x.ndim - 1, what)


# -- the sequence over model (seq_parallel) and the experts (ep_stationary) ----

# the param rules' FSDP axis, which ``ep_stationary`` puts the expert banks
# (or their ffn columns) on beside ``model``
EP_AXIS = "data"


def seq_parallel() -> bool:
    """The residual stream is split over ``model`` along the sequence:
    ``seq_parallel`` installed with a ``ProcessMesh`` of more than one
    rank along ``model`` (module docstring)."""
    return bool(_CTX.get("seq_parallel")) and model_shards() > 1


def seq_splits(seq: int, m: int) -> bool:
    """Whether ``seq_parallel`` splits a sequence of ``seq`` tokens over
    ``m`` ranks along ``model``: m > 1 divides it (else the axis is
    dropped, as ``validate_spec`` drops it, and the stream stays whole)."""
    return m > 1 and seq % m == 0


def ep_stationary() -> bool:
    """``ep_stationary`` installed with a ``ProcessMesh``: a split MoE's
    expert banks stay where the placement put them (``models.moe``)."""
    return bool(_CTX.get("ep_stationary")) and _process_mesh() is not None


def _chunks(x, p: int, dim: int):
    """``x`` cut into ``p`` equal chunks along ``dim``, as the (1, p, n)
    stack ``mesh.all_to_all`` sends."""
    n = x.shape[dim] // p
    return x.reshape(*x.shape[:dim], p, n, *x.shape[dim + 1:]).movedim(
        dim, 0).reshape(1, p, -1)


def _joined(got, shape: tuple, dim: int):
    """(p, n) chunks of ``shape`` each, in coordinate order, joined
    along ``dim``."""
    p = got.shape[0]
    t = got.reshape(p, *shape).movedim(0, dim)
    return t.reshape(*shape[:dim], p * shape[dim], *shape[dim + 1:])


def _all_gather(x, axes: tuple, dim: int, what: str):
    """This rank's ``x`` and its group's along ``axes``, joined along
    ``dim`` in coordinate order (one ``mesh.gather``)."""
    got = _process_mesh().gather(x.detach().reshape(1, -1), axes, what)[0]
    return _joined(got, tuple(x.shape), dim)


def _reduce_scatter(x, axes: tuple, dim: int, what: str):
    """This rank's chunk along ``dim`` of ``x`` added over its group along
    ``axes``: one ``mesh.all_to_all`` sends each member its chunk, and the
    received chunks are added in coordinate order, in f32, cast back."""
    mesh = _process_mesh()
    p = int(mesh.group(axes)[1].shape[1])
    got = mesh.all_to_all(_chunks(x.detach(), p, dim), axes, what)[0]
    acc = got[0].float()
    for c in range(1, p):
        acc = acc + got[c].float()
    shape = list(x.shape)
    shape[dim] //= p
    return acc.to(x.dtype).view(shape)


def _exchange(x, axes: tuple, split: int, join: int, what: str):
    """Chunk c of ``x`` along ``split`` to the member at coordinate c of
    this rank's group along ``axes``, the chunks received joined along
    ``join`` in coordinate order (one ``mesh.all_to_all``)."""
    mesh = _process_mesh()
    p = int(mesh.group(axes)[1].shape[1])
    got = mesh.all_to_all(_chunks(x.detach(), p, split), axes, what)[0]
    shape = list(x.shape)
    shape[split] //= p
    return _joined(got, tuple(shape), join)


class _Gather(torch.autograd.Function):
    """An all-gather along ``dim`` over ``axes`` forward; its backward
    reduce-scatters the gradient (both counted as ``what``)."""

    @staticmethod
    def forward(ctx, x, axes, dim, what):
        ctx.args = axes, dim, what
        return _all_gather(x, axes, dim, what)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, *ctx.args), None, None, None


class _Scatter(torch.autograd.Function):
    """A reduce-scatter along ``dim`` over ``axes`` forward; its backward
    all-gathers the gradient (both counted as ``what``)."""

    @staticmethod
    def forward(ctx, x, axes, dim, what):
        ctx.args = axes, dim, what
        return _reduce_scatter(x, axes, dim, what)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None, None


class _GatherWhole(torch.autograd.Function):
    """An all-gather along ``dim`` over ``axes`` forward; the backward keeps
    this rank's chunk of a gradient every rank computed whole."""

    @staticmethod
    def forward(ctx, x, axes, dim, what):
        ctx.n, ctx.dim = x.shape[dim], dim
        ctx.r = int(_process_mesh().group(axes)[0][_process_mesh().rank])
        return _all_gather(x, axes, dim, what)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.r * ctx.n, ctx.n), None, None, None


class _SplitGather(torch.autograd.Function):
    """This rank's chunk along ``dim`` of a value every rank holds whole
    forward; the backward all-gathers the gradient over ``axes``."""

    @staticmethod
    def forward(ctx, x, axes, dim, what):
        ctx.args = axes, dim, what
        p = int(_process_mesh().group(axes)[1].shape[1])
        r = int(_process_mesh().group(axes)[0][_process_mesh().rank])
        n = x.shape[dim] // p
        return x.narrow(dim, r * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None, None


class _Exchange(torch.autograd.Function):
    """An all-to-all (chunks along ``split`` out, joined along ``join``);
    its backward is the reverse one (both counted as ``what``)."""

    @staticmethod
    def forward(ctx, x, axes, split, join, what):
        ctx.args = axes, split, join, what
        return _exchange(x, axes, split, join, what)

    @staticmethod
    def backward(ctx, g):
        axes, split, join, what = ctx.args
        return _exchange(g, axes, join, split, what), None, None, None, None


def seq_gather(x):
    """Under :func:`seq_parallel`: the rank's tokens of ``x`` (B, S/m,
    ...) -> the whole sequence (B, S, ...), gathered over ``model`` in
    coordinate order; the backward adds the ranks' gradients and keeps
    this rank's tokens (both ``sp_gather``).  ``x`` itself otherwise."""
    if not seq_parallel():
        return x
    return _Gather.apply(x, (_CTX["model"],), 1, "sp_gather")


def seq_whole(x):
    """Under :func:`seq_parallel`: the whole sequence of ``x`` for a part
    every rank runs whole and alike (a whole vocab's cross-entropy); the
    backward keeps this rank's tokens of the gradient, which every rank
    computed whole (the forward ``sp_gather``; no sum).  ``x`` itself
    otherwise."""
    if not seq_parallel():
        return x
    return _GatherWhole.apply(x, (_CTX["model"],), 1, "sp_gather")


def seq_split(t):
    """Under :func:`seq_parallel`: this rank's tokens of a ``t`` every rank
    computed whole and alike (a whole vocab's lookup); the backward
    gathers the ranks' gradients, so every rank's is the whole one
    (``sp_gather``).  ``t`` itself otherwise."""
    if not seq_parallel():
        return t
    return _SplitGather.apply(t, (_CTX["model"],), 1, "sp_gather")


def seq_local(t):
    """Under :func:`seq_parallel`: this rank's S/m tokens (dim 1) of a
    ``t`` every rank holds whole; the backward pads zeros (a whole part's
    output, the tokens and labels of the rank's slice).  ``t`` itself
    otherwise."""
    if not seq_parallel():
        return t
    n = t.shape[1] // model_shards()
    r = model_index()
    return t[:, r * n:(r + 1) * n]


def own_tokens_grad(t):
    """``t`` (B, S, ...), the same on every rank along ``model``; under
    :func:`seq_parallel` its gradient flows back through this rank's
    tokens only, so that the ranks' gradients add up to the whole one (a
    term of the loss each rank computes whole: the MoE aux's mean of the
    router's probabilities).  ``t`` itself otherwise."""
    if not seq_parallel():
        return t
    n = t.shape[1] // model_shards()
    r = model_index()
    mine = torch.zeros(t.shape[1], dtype=torch.bool, device=t.device)
    mine[r * n:(r + 1) * n] = True
    return torch.where(mine.view(1, -1, *[1] * (t.ndim - 2)), t, t.detach())


def expert_dispatch(buf):
    """``ep_stationary`` with the experts spread over ``EP_AXIS`` and
    ``model``: this rank's dispatch buffer (G, E/m, C, D), the experts of
    its ``model`` index in ``EP_AXIS`` coordinate order, E/(d m) a rank
    -> (d G, E/(d m), C, D), every batch shard's groups for the experts
    this rank holds, by one all-to-all over ``EP_AXIS`` (``ep_dispatch``;
    the backward the reverse one)."""
    return _Exchange.apply(buf, (EP_AXIS,), 1, 0, "ep_dispatch")


def expert_return(yb):
    """The inverse of :func:`expert_dispatch` (``ep_return``)."""
    return _Exchange.apply(yb, (EP_AXIS,), 0, 1, "ep_return")


def batch_gather(buf):
    """``ep_stationary`` with the experts on ``model`` and their ffn
    columns on ``EP_AXIS``: every batch shard's (G, ...) buffers joined
    over ``EP_AXIS`` (``ep_gather``; the backward reduce-scatters)."""
    return _Gather.apply(buf, (EP_AXIS,), 0, "ep_gather")


def batch_scatter(yb):
    """The partial outputs of this rank's ffn columns (d G, ...) added
    over ``EP_AXIS``, this rank's G groups kept (``ep_scatter``; the
    backward all-gathers)."""
    return _Scatter.apply(yb, (EP_AXIS,), 0, "ep_scatter")


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


# -- serving on a ProcessMesh ----------------------------------------------------


@contextmanager
def serving(runner, cache_pls: dict, cache_len: int):
    """Install a placed serving run for the duration of a call:
    ``runner`` (``serve.engine``'s: ``runner.top(params, fn, *args)`` and
    ``runner.layer(layer, method, *args)`` run a call of ``models.model``
    over the params gathered as the placement needs), the caches'
    placements (``launch.sharding.named`` of ``cache_specs``, keyed by
    ``cache_leaves``' paths) and their whole length ``cache_len`` (the
    ``max_len`` they were made for)."""
    prev = {k: _CTX.get(k) for k in ("serve", "cache_pls", "cache_len")}
    _CTX.update(serve=runner, cache_pls=cache_pls, cache_len=int(cache_len))
    try:
        yield
    finally:
        _CTX.update(prev)


def serve_runner():
    """The installed serving runner (:func:`serving`), or None."""
    return _CTX.get("serve") if _process_mesh() is not None else None


def cache_placements():
    """The installed caches' placements (:func:`serving`), or None."""
    return _CTX.get("cache_pls") if serve_runner() is not None else None


def cache_slots(n_local: int, window: int | None = None) -> tuple:
    """(whole slots, this rank's first slot) of a cache whose sequence
    dim holds ``n_local`` slots on this rank: the installed
    ``cache_len`` (capped at ``window``, a sliding window's ring), split
    over ``model`` where the rank holds fewer; ``(n_local, 0)`` outside
    a placed serving run."""
    whole = _CTX.get("cache_len") if serve_runner() is not None else None
    if whole is None:
        return n_local, 0
    whole = min(whole, window) if window else whole
    if n_local == whole:
        return whole, 0
    if n_local * model_shards() != whole:
        raise ValueError(f"a cache of {n_local} slots on this rank is no split "
                         f"of {whole} over {model_shards()} ranks")
    return whole, model_index() * n_local


@contextmanager
def sequence_split(on: bool):
    """``seq_parallel`` as ``on`` says for the duration of a call (a decode
    step's one token keeps the stream whole, :func:`seq_splits`)."""
    prev = _CTX.get("seq_parallel")
    _CTX["seq_parallel"] = bool(prev) and bool(on)
    try:
        yield
    finally:
        _CTX["seq_parallel"] = prev


def model_gather(x, dim: int, what: str):
    """The ranks' slices of ``x`` along ``dim`` joined over ``model`` in
    coordinate order (one ``mesh.gather``); values only.  ``x`` itself
    with one rank along ``model``."""
    if model_shards() == 1:
        return x
    return _all_gather(x, (_CTX["model"],), dim, what)


def kv_exchange(x, split: int, join: int, what: str = "kv_exchange"):
    """Chunk c of ``x`` along ``split`` to the rank at ``model``
    coordinate c, the chunks received joined along ``join`` (one
    ``mesh.all_to_all``): a prefill's ring of the rank's kv heads turned
    into every head's slots of the rank's share of the ring."""
    if model_shards() == 1:
        return x
    return _exchange(x, (_CTX["model"],), split, join, what)


def softmax_combine(acc, mx, sm, to_heads: bool, what: str = "decode_combine"):
    """One softmax over slots split over ``model`` (flash-decoding across
    ranks): each rank's partials over its slots -- ``acc`` (B, H, dv),
    the f32 sums of its weights times the values, ``mx`` (B, H) its
    running max (-inf where it holds no valid slot) and ``sm`` (B, H) the
    sum of its weights ``exp(s - mx)`` -- merged in coordinate order:
    ``sum_r acc_r e^(mx_r - M) / sum_r sm_r e^(mx_r - M)``, M the max
    over the ranks.  ``to_heads``: one ``mesh.all_to_all`` hands each
    rank its H/m heads' partials of every rank, and it returns (B, H/m,
    dv); otherwise one ``mesh.gather`` and (B, H, dv).  Outside a split
    (one rank along ``model``) ``acc / sm``."""
    m = model_shards()
    if m == 1:
        return acc / torch.clamp(sm, min=1e-30)[..., None]
    b, h, dv = acc.shape
    packed = torch.cat([acc, mx[..., None], sm[..., None]], -1)
    if to_heads:
        got = _process_mesh().all_to_all(_chunks(packed, m, 1),
                                         (_CTX["model"],), what)[0]
        h //= m
    else:
        got = _model_gather(packed, what)
    parts = got.reshape(m, b, h, dv + 2)
    mxs = parts[..., dv]
    top = mxs.amax(dim=0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    num = den = None
    for c in range(m):
        a = torch.where(torch.isfinite(mxs[c]), torch.exp(mxs[c] - top),
                        torch.zeros_like(top))
        t_num, t_den = parts[c, ..., :dv] * a[..., None], parts[c, ..., dv + 1] * a
        num = t_num if num is None else num + t_num
        den = t_den if den is None else den + t_den
    return num / torch.clamp(den, min=1e-30)[..., None]


def model_argmax(x, what: str = "vocab_argmax"):
    """The argmax over the last dim of ``x`` (B, V/m), this rank's vocab
    columns, over the whole vocab: each rank's first max and its id,
    gathered over ``model`` and taken in coordinate order with a strict
    comparison, so a tie goes to the lowest id (``torch.argmax``'s
    rule).  Returns (B,) int64 ids, the same on every rank along
    ``model``."""
    v = x.shape[-1]
    val, idx = torch.max(x.float(), dim=-1)
    if model_shards() == 1:
        return idx
    ids = (idx + model_index() * v).double()
    got = _model_gather(torch.stack([val.double(), ids], -1), what)
    got = got.reshape(got.shape[0], *val.shape, 2)
    best, best_id = got[0, ..., 0], got[0, ..., 1]
    for c in range(1, got.shape[0]):
        more = got[c, ..., 0] > best
        best = torch.where(more, got[c, ..., 0], best)
        best_id = torch.where(more, got[c, ..., 1], best_id)
    return best_id.long()


def seq_last(x):
    """Under :func:`seq_parallel`: the last token of the whole sequence of
    ``x`` (B, S/m, D), which the last rank along ``model`` holds: every
    rank's last token gathered (``sp_gather``) and the last rank's kept.
    ``x[:, -1:]`` otherwise."""
    if not seq_parallel():
        return x[:, -1:]
    return _all_gather(x[:, -1:], (_CTX["model"],), 1, "sp_gather")[:, -1:]
