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

On a ``launch.mesh.ProcessMesh`` (``grad_shardings``: the params'
``launch.sharding.Placement`` s) the step runs on every rank, on the
rank's slices of the state (``sharding.place``):

* the batch splits over the batch axes (everything but ``model``); ranks
  along ``model`` compute on the same batch shard, and split the compute
  of the parts ``models.shard.split_kinds`` names (``train_step.
  split_kinds``): each runs its own heads, ``d_ff`` columns, experts,
  vocab rows, SSD heads and RG-LRU width (Megatron's column- and
  row-parallel products, joined by ``shard.to_model``/``from_model``, the
  gated norm's ``model_allsum`` and the RG-LRU gates' ``model_concat``,
  every sum added in coordinate order);
* each layer's params are gathered just before the layer's forward, and
  again in its backward (every layer runs under
  ``torch.utils.checkpoint``, its recompute never stopped early, so its
  gathered params live only inside it); the other params are gathered
  once a micro-batch.  A param of a split part is gathered over the
  batch axes only, to the rank's ``model`` slice, except those a rank
  cuts its share from (``_CUT``: mamba2's ``in_proj``, conv and head
  vectors, RG-LRU's ``conv_b`` and ``lam``), gathered whole; every other
  one to whole;
* each micro-batch's gradient of a param -- the rank's ``model`` slice of
  a split one, the whole (and the same on every rank along ``model``)
  otherwise -- is reduce-scattered to its placement (one ``all_to_all``
  over the batch axes, the slices added in rank order: the JAX package's
  ``grad_shardings``), never all-reduced; a ``_CUT`` param's, which
  covers the rank's share only, over the batch axes and ``model``;
* the loss divides by the whole batch's mask count and the MoE aux takes
  the whole batch's routing fractions (``models.shard.batch_sum``); the
  global norm, Adafactor's means over split dims and per-leaf RMS and the
  int8 compressor's ``amax`` add the other slices' partials
  (``Placement.sum_over``), all in rank order, so every rank reports the
  same bits;
* the optimizer updates each rank's slices (in place with ``donate``).

Two options of ``build_train_step`` change the split (the JAX package's
``use_mesh_axes(..., seq_parallel=, ep_stationary=)``, which its dry run
reaches through ``--variant sp,ep``); both give the numbers of the step
without them, within the order of f32 sums:

* ``seq_parallel`` (Megatron-SP): where m > 1 ranks along ``model``
  divide the sequence, a rank's residual stream between layers is its
  S/m tokens (``models.shard.seq_gather``/``seq_local``; the
  row-parallel sums become reduce-scatters, the column-parallel inputs
  all-gathers, and each layer's checkpoint keeps 1/m of its input).  A
  param no split part owns then sees the rank's tokens alone, so its
  gradient is added over ``model`` as well as the batch axes -- but a
  whole vocab's tables: their lookup and cross-entropy run whole on
  every rank (``shard.seq_split``/``seq_whole``), their gradient whole;
* ``ep_stationary``: the expert banks are placed by
  ``state_specs(..., ep_stationary=True)`` (E over ``data`` and
  ``model``, or E over ``model`` and their ffn columns over ``data``)
  and are never gathered: the tokens move to them (``models.moe``), and
  a bank's gradient is complete on its rank (added over the batch axes
  its placement does not split alone: ``pod`` on ``multi``).
"""

from __future__ import annotations

import math
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


def _compress_grads(grads: dict, ef, inplace: bool, placements=None):
    """int8 quantize->dequantize with error feedback; returns (g~, new_ef).
    Each JAX leaf has one scale, ``max|g + e| / 127`` over all its layers
    (and all its slices, with ``placements``);
    ``torch.round`` rounds half to even, as ``jnp.round``.  The grads are
    overwritten (they are the step's own); ``ef`` only with ``inplace``."""
    ef = _fresh(ef, inplace)
    for path, leaf in grads.items():
        es = _state_rows(tree_get(ef, path), leaf)
        amax = None
        for g, e in zip(rows(leaf), es):
            a = torch.max(torch.abs(g.float() + e))
            amax = a if amax is None else torch.maximum(amax, a)
        if placements is not None:
            pl = placements[path]
            amax = pl.sum_over(amax, tuple(range(len(pl.shape))), "compress",
                               op="max")
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


def _loss(cfg, params, batch):
    return M.loss_fn(params, cfg, batch["tokens"], batch["labels"],
                     mask=batch.get("mask"), prefix_embeds=batch.get("prefix_embeds"))


def value_and_grad(cfg, params: M.Model, batch: dict, leaves=None, loss_of=_loss):
    """(loss, grads) of ``loss_fn`` on ``batch`` (tensors on the params'
    device) by autograd: grads keyed as ``param_leaves(params)`` (or
    ``leaves``), a stack's as a ``LayerStack``, zeros for a param the loss
    does not reach.  The params require grad for the backward pass only.
    ``loss_of(cfg, params, batch) -> (loss, extras)`` stands in for
    ``loss_fn`` (the step on a ``ProcessMesh`` gathers params first)."""
    leaves = M.param_leaves(params) if leaves is None else leaves
    flat = [t for leaf in leaves.values() for t in rows(leaf)]
    try:
        for t in flat:
            t.requires_grad_(True)
        with torch.enable_grad():
            loss, _ = loss_of(cfg, params, batch)
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
    seq_parallel: bool = False,
    ep_stationary: bool = False,
):
    """Returns train_step(state, batch) -> (state, metrics).

    batch: {"tokens": (B, S) ints, "labels": (B, S) ints, "mask": optional
    (B, S) f32, "prefix_embeds": optional}, numpy arrays or tensors (moved
    to the params' device).  With ``grad_accum > 1`` the batch's leading
    dim is split into microbatches, run in order on the same params; their
    f32 gradients are summed in that order, then divided.

    ``grad_shardings``: the params' placements (path -> ``Placement``, as
    ``launch.sharding.named(mesh, param_specs(params), params)`` gives
    them).  On a ``ProcessMesh`` the step is the sharded one of the module
    docstring and takes the state as ``sharding.place`` leaves it on each
    rank, and the whole batch (each rank keeps its rows); where one
    process holds every tile (a ``TileMesh``, a ``MeshShape``, the 1 x 1
    ``card`` mesh) there is nothing to constrain and the step is the one
    without ``grad_shardings``.
    ``donate``: update the given state's tensors in place (module
    docstring).  ``seq_parallel``, ``ep_stationary``: the options of the
    step on a ``ProcessMesh`` (module docstring; ``ep_stationary`` needs
    the placements of ``state_specs(..., ep_stationary=True)``); the step
    without a ``ProcessMesh`` is the same with or without them.

    On a ``ProcessMesh`` the returned function carries ``split_kinds``
    (``models.shard.split_kinds``: what the step splits over ``model``,
    with ``"seq_parallel": True`` / ``"ep_stationary": True`` where the
    option is on) and, on a card, ``fwd_bwd_events``: the CUDA events
    around the last step's forward and backward passes.
    """
    mesh, pls = None, None
    if grad_shardings is not None:
        meshes = {id(pl.mesh): pl.mesh for pl in grad_shardings.values()}
        if len(meshes) != 1:
            raise ValueError("grad_shardings: every placement must be on one "
                             f"mesh, got {len(meshes)}")
        if getattr(next(iter(meshes.values())), "per_process", False):
            pls = dict(grad_shardings)
            mesh = next(iter(meshes.values()))
    on_mesh = {} if pls is None else {"placements": pls}
    opts = {"seq_parallel": bool(seq_parallel), "ep_stationary": bool(ep_stationary)}

    def train_step(state: TrainState, batch):
        params = state.params
        leaves = M.param_leaves(params)
        if mesh is None:
            batch = as_batch(batch, params.device)
            mbs = [{k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                                 *v.shape[1:])[i] for k, v in batch.items()}
                   for i in range(grad_accum)] if grad_accum > 1 else [batch]
            grad_of = lambda mb: value_and_grad(cfg, params, mb, leaves)
        else:
            mbs = _local_micros(batch, mesh, grad_accum)
            grad_of = _mesh_grad_of(cfg, params, leaves, pls, mesh, opts)
        events = None
        if mesh is not None and mesh.device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        gsum, losses = None, []
        for mb in mbs:
            loss, g = grad_of(mb)
            losses.append(loss)
            if grad_accum == 1:
                gsum = g
            elif gsum is None:
                gsum = {k: LayerStack(x.float() for x in v)
                        if isinstance(v, LayerStack) else v.float()
                        for k, v in g.items()}
            else:
                for k, v in g.items():
                    for a, b in zip(rows(gsum[k]), rows(v)):
                        a.add_(b.float())
            del g
        if events is not None:
            events[1].record()
            train_step.fwd_bwd_events = events
        if mesh is not None:
            # each rank's loss is its share of the whole batch's
            losses = list(_batch_sum(mesh, torch.stack(losses)).unbind(0))
        if grad_accum > 1:
            for v in gsum.values():
                for a in rows(v):
                    a.div_(grad_accum)
            lsum = torch.zeros((), dtype=torch.float32, device=params.device)
            for x in losses:
                lsum = lsum + x
            loss = lsum / grad_accum
        else:
            loss = losses[0]
        grads = gsum

        ef = state.ef
        with torch.no_grad():
            if compress_grads and ef is not None:
                grads, ef = _compress_grads(grads, ef, inplace=donate, **on_mesh)
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm,
                                               inplace=True, **on_mesh)
            new_leaves, new_opt = optimizer.update(
                grads, state.opt_state, leaves, state.step, inplace=donate,
                **on_mesh)
        del grads, gsum
        new_params = params if donate else M.replace_params(params, new_leaves)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": state.step}
        return TrainState(new_params, new_opt, state.step + 1, ef), metrics

    train_step.donate = donate
    train_step.split_kinds = None if mesh is None else (
        _split_table(cfg, mesh) | {k: True for k, v in opts.items() if v})
    return train_step



# -- the step on a ProcessMesh ---------------------------------------------------


class _Gather(torch.autograd.Function):
    """A param's slice -> the param gathered over ``over`` (all its axes
    with None: the whole param; ``Placement.gather``); its backward
    reduce-scatters that gradient to the slice over ``sum_axes`` (the
    batch axes, with ``model`` too where a rank computed only its share of
    it; ``Placement.reduce_scatter``)."""

    @staticmethod
    def forward(ctx, part, pl, sum_axes, over):
        ctx.pl, ctx.sum_axes, ctx.over = pl, sum_axes, over
        full = pl.gather(part, "param_gather", over)
        return part.view_as(part) if full is part else full

    @staticmethod
    def backward(ctx, g):
        return (ctx.pl.reduce_scatter(g, ctx.sum_axes, "grad_reduce_scatter",
                                      ctx.over), None, None, None)


class _LossOf(torch.nn.Module):
    """``loss_fn`` of a model as a module's forward, so that
    ``torch.func.functional_call`` can run it over gathered params."""

    def __init__(self, model, cfg):
        super().__init__()
        self.model = model
        self.cfg = cfg

    def forward(self, mb):
        return _loss(self.cfg, self.model, mb)


def _local_micros(batch: dict, mesh, grad_accum: int) -> list:
    """The rank's rows of each micro-batch of the whole ``batch``: micro m
    is rows [m B/ga, (m+1) B/ga), split over the batch axes
    (``batch_specs``' rule), on the mesh's device."""
    from ..launch.mesh import batch_axes
    from ..launch.sharding import Placement

    baxes = batch_axes(mesh)
    nb = math.prod(int(mesh.shape[a]) for a in baxes)
    out = [{} for _ in range(grad_accum)]
    for k, v in batch.items():
        if v is None:
            continue
        t = torch.as_tensor(v)
        if t.shape[0] % (grad_accum * nb):
            raise ValueError(f"batch {k!r}: {t.shape[0]} rows do not split into "
                             f"{grad_accum} micro-batches over {nb} batch shards")
        parts = t.reshape(grad_accum, t.shape[0] // grad_accum, *t.shape[1:])
        for m in range(grad_accum):
            part = parts[m]
            pl = Placement(mesh, (baxes,) + (None,) * (part.ndim - 1),
                           tuple(part.shape))
            x = pl.shard(part)
            out[m][k] = x.long() if k in ("tokens", "labels") else x
    return out


def _batch_sum(mesh, x):
    """``x`` added over the batch shards (``models.shard.batch_sum``)."""
    from ..launch.mesh import batch_axes
    from ..models import shard

    with shard.use_mesh_axes(mesh, batch_axes(mesh), "model"):
        return shard.batch_sum(x)


def _split_table(cfg, mesh) -> dict:
    """``shard.split_kinds`` for the mesh's ranks along ``model``."""
    from ..models import shard

    return shard.split_kinds(cfg, int(dict(mesh.shape).get("model", 1)))


# the params of a split part that a rank takes whole and cuts its share
# from: JAX's placement of them does not line up with the rank's heads or
# lru slice (``in_proj``'s columns [z | x | B | C | dt], the conv's [x | B
# | C]) or keeps them whole (the head and channel vectors, the gated
# norm's scale).  Gathered whole; each rank's gradient covers its share
# only (and a partial of B and C), so it is added over ``model`` as well
# as the batch axes
_CUT = {"ssm": ("in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "D", "norm"),
        "rec": ("conv_b", "lam")}


def _part_of(kind: str, name: str) -> tuple:
    """(layer kind, part of ``shard.split_kinds`` or None, the param is
    one of a split part's :data:`_CUT`) of the param ``name`` of a layer of
    ``kind`` (a ``unit:`` layer's sub-block by its own kind)."""
    if kind.startswith("unit:"):
        sub, name = name.split(".", 1)
        kind = kind[5:].split(",")[int(sub[1:])]
    q = name.split(".")
    cut = q[0] == "mix" and q[1] in _CUT.get(kind, ())
    if kind == "ssm":
        return kind, ("heads" if q[0] == "mix" else None), cut
    if kind == "rec" and q[0] == "mix":
        return kind, "lru", cut
    if q[0] == "mix" and q[1] in ("wk", "wv"):
        return kind, "kv", False
    if q[0] == "mix" and q[1] in ("wq", "wo", "wq_b", "wkv_b"):
        return kind, "heads", False
    if q[0] == "ffn" and q[1] == "shared":
        return kind, "shared", False
    if q[0] == "ffn" and q[1] in ("wi", "wg", "wo"):
        return kind, ("experts" if len(q) == 2 else "mlp"), False
    return kind, None, False


def _gather_over(table: dict, kind: str, name: str, pl, baxes: tuple,
                 seq_parallel: bool = False, ep_stationary: bool = False) -> tuple:
    """(the axes to gather the param ``name`` of a layer of ``kind`` over,
    the axes to add its gradient over).  A part the table splits: gathered
    over the batch axes alone (the rank keeps its ``model`` slice), its
    gradient added over ``baxes``; one of its :data:`_CUT` params
    gathered whole (None), its gradient added over ``baxes`` and
    ``model``; with ``ep_stationary`` an expert bank not gathered at all
    (``()``), its gradient added over the batch axes its placement leaves
    whole.  Anything else: whole, over ``baxes`` (and ``model`` with
    ``seq_parallel``, but for a whole vocab's tables, which every rank
    runs whole: module docstring).  ``kind`` None is a top-level param: a
    table (vocab) or an MTP head's."""
    with_model = tuple(a for a in pl.mesh.axis_names if a in baxes or a == "model")
    cut, part, tables = False, None, False
    if kind is None:
        q = name.split(".")
        if q[0] in ("embed", "head"):
            split, tables = table["vocab"], True
        elif q[0] == "mtp" and q[2] == "block":
            kind, part, cut = _part_of("attn_mlp", ".".join(q[3:]))
            split = table["layers"][kind].get(part, False)
        else:
            split = False
    else:
        kind, part, cut = _part_of(kind, name)
        split = table["layers"][kind].get(part, False)
    if split and cut:
        return None, with_model
    if split and part == "experts" and ep_stationary:
        return (), tuple(a for a in baxes if a not in pl.axes)
    if split:
        return tuple(a for a in pl.axes if a != "model"), baxes
    return None, with_model if seq_parallel and not tables else baxes


def _mesh_grad_of(cfg, params, leaves, pls: dict, mesh, opts: dict):
    """``mb -> (loss, grads)`` of a rank on ``mesh`` (module docstring): the
    top-level params gathered once, each layer's gathered inside its own
    ``torch.utils.checkpoint`` (again in the recompute, which runs the
    whole layer), the gradients reduce-scattered to the rank's slices by
    ``_Gather``'s backward; a split part's params gathered over the batch
    axes alone (:func:`_gather_over`).  ``opts``: ``seq_parallel`` (on
    where the micro-batch's sequence splits, ``shard.seq_splits``) and
    ``ep_stationary``."""
    from torch.func import functional_call
    from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

    from ..launch.mesh import batch_axes
    from ..models import shard

    baxes = batch_axes(mesh)
    table = _split_table(cfg, mesh)
    m = int(dict(mesh.shape).get("model", 1))
    row_of = {}
    for path, leaf in leaves.items():
        r = pls[path].row() if isinstance(leaf, LayerStack) else pls[path]
        for t in rows(leaf):
            row_of[id(t)] = r
    top = [(n, t, row_of[id(t)]) for n, t in params.named_parameters()
           if not n.startswith("groups.")]
    live = {}                     # this micro-batch's options

    def run_layer(layer, x, cfg_):
        names, parts = zip(*layer.named_parameters())
        lpls = [row_of[id(t)] for t in parts]
        overs = [_gather_over(table, layer.kind, n, p, baxes, **live)
                 for n, p in zip(names, lpls)]

        def run(x, *sh):
            full = {n: _Gather.apply(t, p, s, o)
                    for n, t, p, (o, s) in zip(names, sh, lpls, overs)}
            return functional_call(layer, full, (x, cfg_))
        # the whole layer again in the recompute: its sums over ``model``
        # run there as in the forward, whatever the backward still needs
        with set_checkpoint_early_stop(False):
            return checkpoint(run, x, *parts, use_reentrant=False)

    def gathered_loss(cfg_, params_, mb):
        full = {"model." + n: _Gather.apply(t, p, *reversed(
            _gather_over(table, None, n, p, baxes, **live))) for n, t, p in top}
        return functional_call(_LossOf(params_, cfg_), full, (mb,))

    def grad_of(mb):
        live.update(opts, seq_parallel=opts["seq_parallel"]
                   and shard.seq_splits(mb["tokens"].shape[1], m))
        with shard.use_mesh_axes(mesh, baxes, "model", **live), \
                shard.running_layers(run_layer):
            return value_and_grad(cfg, params, mb, leaves, loss_of=gathered_loss)
    return grad_of
