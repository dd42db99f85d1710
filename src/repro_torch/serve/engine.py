"""LM generation (port of ``repro.serve.engine``): prefill + a decode loop,
and a slot-based continuous-batching manager (requests enter and leave
fixed batch slots between decode steps).

``generate`` prefills the prompt and decodes greedily, or samples at a
``temperature`` from an explicit ``torch.Generator``.  Under
:func:`on_mesh` it runs on a rank of a ``launch.mesh.ProcessMesh``, on
the params and caches placed by ``param_specs`` and ``cache_specs``
(the JAX package's sharded serving cells): the rank's rows of the batch,
its share of the compute over ``model`` (``models.shard``), each layer's
params gathered over the batch axes for that layer's call alone where
the placement splits them there (``fsdp``; with ``fsdp=False`` the
weights stay where they are), the caches' sequence over ``model``
(decode attention merges each rank's slots' softmax, ``shard.
softmax_combine``), and the pick over the rank's vocab columns an
argmax over ``model`` (``shard.model_argmax``; sampling gathers the
logits whole and draws the rank's rows of the whole batch's uniforms
from a generator seeded alike on every rank).
``SlotServer`` keeps
the JAX package's behaviour, quirks included: each request is prefilled
alone (batch 1) and its cache spliced into a free slot of the batch cache,
and every step decodes all slots at one shared position, the largest
among the active slots (caches mask by absolute position).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models import model as M
from ..models import shard

__all__ = ["generate", "SlotServer", "on_mesh"]


def _draw(probs, generator):
    """One id a row (B, 1) from ``probs`` (B, V): the inverse CDF at one
    uniform a row.  The uniforms are drawn for the whole batch (every
    batch shard's rows, ``shard.batch_shards``) and a rank takes its
    rows', so a placed run draws what the one-process run draws from a
    generator seeded alike, and no two batch shards share a uniform."""
    b = probs.shape[0]
    u = torch.rand(b * shard.batch_shards(), generator=generator,
                   device=probs.device)[shard.batch_index() * b:][:b]
    cdf = probs.cumsum(-1)
    idx = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None], right=True)
    return idx.clamp_(max=probs.shape[-1] - 1)


def _pick(lg, temperature: float, generator, vocab: int):
    """The next ids (B, 1) from the last position's logits: the argmax,
    or a draw at ``temperature`` (:func:`_draw`).  Given a rank's vocab
    columns (fewer than ``vocab``) the argmax runs over ``model`` and a
    draw takes the logits gathered whole."""
    last = lg[:, -1]
    split = last.shape[-1] < vocab
    if temperature > 0:
        if split:
            last = shard.model_gather(last, 1, "vocab_gather")
        probs = torch.softmax(last.float() / temperature, dim=-1)
        return _draw(probs, generator)
    if split:
        return shard.model_argmax(last)[:, None]
    return torch.argmax(last, dim=-1)[:, None]


@torch.inference_mode()
def generate(params, cfg, tokens, steps: int, max_len: int | None = None,
             temperature: float = 0.0, generator: torch.Generator | None = None,
             feed=None, on_step=None):
    """Greedy/temperature generation: prefill the prompt, then decode.
    tokens: (B, S) integer ids on the params' device -> (B, steps) ids.
    The first id comes from the prefill, each later one from a decode
    step (``steps - 1`` of them).  Sampling draws from ``generator``, a
    ``torch.Generator`` on that device.  ``feed`` ((B, steps - 1) ids)
    decodes those in place of the picked ones (teacher forcing; the picks
    are returned all the same); ``on_step(i, logits, caches)`` is called
    after the prefill (``i`` 0) and after decode step ``i``."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    max_len = max_len or min(cfg.max_seq_len, tokens.shape[1] + steps)
    logits, caches, pos = M.prefill(params, cfg, tokens=tokens, max_len=max_len)
    if on_step is not None:
        on_step(0, logits, caches)
    tok = _pick(logits, temperature, generator, cfg.vocab_size)
    out = [tok]
    for i in range(steps - 1):
        fed = tok if feed is None else feed[:, i:i + 1]
        logits, caches = M.decode_step(params, cfg, caches, fed, pos + i)
        if on_step is not None:
            on_step(i + 1, logits, caches)
        tok = _pick(logits, temperature, generator, cfg.vocab_size)
        out.append(tok)
    return torch.cat(out, dim=1)


class _Call(torch.nn.Module):
    """A method of a module as a module's forward, so that
    ``torch.func.functional_call`` can run it over other tensors."""

    def __init__(self, module, fn):
        super().__init__()
        self.module = module
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.module, *args)


# the top-level params a serving call reads (the MTP heads are unused)
_TOP = ("embed", "head", "final_norm")


class _MeshRunner:
    """``models.model``'s calls on a rank (``shard.serving``): each layer's
    params, and the top-level ones a call reads, gathered for that call
    alone as the train step's forward gathers them (``train.step.
    _gather_over``: a split part's over the batch axes, keeping the
    rank's ``model`` slice; one a rank cuts its share from, and anything
    that does not split, whole; with ``ep_stationary`` an expert bank
    not at all), each gather counted as ``param_gather``."""

    def __init__(self, params, cfg, placements: dict, mesh,
                 ep_stationary: bool = False):
        from ..launch.mesh import batch_axes
        from ..train.optim import rows
        from ..train.step import _split_table

        self.baxes = batch_axes(mesh)
        self.table = _split_table(cfg, mesh)
        self.ep = bool(ep_stationary)
        self.row_of = {}
        for path, leaf in M.param_leaves(params).items():
            pl = placements[path].row() if isinstance(leaf, M.LayerStack) \
                else placements[path]
            for t in rows(leaf):
                self.row_of[id(t)] = pl

    def _gathered(self, kind, named) -> dict:
        from ..train.step import _gather_over

        out = {}
        for name, t in named:
            pl = self.row_of[id(t)]
            over, _ = _gather_over(self.table, kind, name, pl, self.baxes,
                                   ep_stationary=self.ep)
            out[name] = pl.gather(t, "param_gather", over)
        return out

    def layer(self, layer, method: str, *args):
        from torch.func import functional_call

        full = self._gathered(layer.kind, layer.named_parameters())
        return functional_call(
            _Call(layer, lambda mod, *a: getattr(mod, method)(*a)),
            {"module." + n: v for n, v in full.items()}, args)

    def top(self, params, fn, *args):
        from torch.func import functional_call

        named = [(n, t) for n, t in params.named_parameters()
                 if n.split(".")[0] in _TOP]
        full = self._gathered(None, named)
        return functional_call(_Call(params, fn),
                               {"module." + n: v for n, v in full.items()}, args)


@contextmanager
def on_mesh(params, cfg, placements: dict, cache_placements: dict, max_len: int,
            *, seq_parallel: bool = False, ep_stationary: bool = False):
    """Serve on a rank of a ``ProcessMesh`` for the duration of the
    context (module docstring): ``params`` the rank's slices placed by
    ``placements`` (``sharding.named`` of ``param_specs(..., fsdp=,
    ep_stationary=)``), ``cache_placements`` the caches' (``named`` of
    ``cache_specs``, for the batch and ``max_len`` of the calls).
    ``seq_parallel`` splits a prefill's stream over ``model`` where it
    divides the prompt; ``ep_stationary`` keeps the expert banks where
    they are.  ``generate``, ``models.model.prefill`` and ``decode_step``
    inside it take the rank's rows of the tokens."""
    from ..launch.mesh import batch_axes

    mesh = next(iter(placements.values())).mesh
    runner = _MeshRunner(params, cfg, placements, mesh, ep_stationary)
    with shard.use_mesh_axes(mesh, batch_axes(mesh), "model",
                             seq_parallel=seq_parallel,
                             ep_stationary=ep_stationary), \
            shard.serving(runner, cache_placements, max_len):
        yield


@dataclass
class _Slot:
    req_id: int | None = None
    remaining: int = 0
    out: list = field(default_factory=list)


def _splice(big, small, slot: int):
    """Write the batch-1 cache ``small`` into row ``slot`` of ``big``."""
    if isinstance(big, dict):
        for key in big:
            _splice(big[key], small[key], slot)
    elif isinstance(big, list):
        for b, s in zip(big, small):
            _splice(b, s, slot)
    else:
        big[slot:slot + 1] = small.to(big.dtype)


class SlotServer:
    """Continuous batching over a fixed (batch, max_len) decode grid.

    Fixed shapes; new requests are prefilled one at a time (batch 1) and
    their caches spliced into the batch cache at the free slot; each step
    decodes every slot at the largest position among the active ones.
    """

    def __init__(self, params, cfg, batch_slots: int, max_len: int):
        self.params, self.cfg = params, cfg
        self.b, self.max_len = batch_slots, max_len
        dev = params.device
        self.caches = M.init_caches(cfg, batch_slots, max_len, device=dev)
        self.tokens = torch.zeros((batch_slots, 1), dtype=torch.long, device=dev)
        self.pos = np.zeros(batch_slots, np.int64)
        self.slots = [_Slot() for _ in range(batch_slots)]
        self._next_id = 0

    @torch.inference_mode()
    def submit(self, prompt: np.ndarray, gen_len: int) -> int:
        """Prefill a request into a free slot; returns its id."""
        free = next(i for i, s in enumerate(self.slots) if s.req_id is None)
        rid = self._next_id
        self._next_id += 1
        toks = torch.as_tensor(np.asarray(prompt), device=self.params.device)
        logits, pcaches, ppos = M.prefill(self.params, self.cfg,
                                          tokens=toks[None], max_len=self.max_len)
        _splice(self.caches, pcaches, free)
        first = int(torch.argmax(logits[0, -1]))
        self.tokens[free, 0] = first
        self.pos[free] = int(ppos)
        self.slots[free] = _Slot(rid, gen_len, [first])
        return rid

    @torch.inference_mode()
    def step(self) -> dict[int, list[int]]:
        """One decode step for every active slot; returns finished requests."""
        active = [i for i, s in enumerate(self.slots) if s.req_id is not None]
        if not active:
            return {}
        pos = int(max(self.pos[i] for i in active))
        logits, self.caches = M.decode_step(self.params, self.cfg, self.caches,
                                            self.tokens, pos)
        nxt = torch.argmax(logits[:, -1], dim=-1)
        self.tokens = nxt[:, None]
        nxt = nxt.tolist()
        done = {}
        for i in active:
            s = self.slots[i]
            s.out.append(nxt[i])
            s.remaining -= 1
            self.pos[i] += 1
            if s.remaining <= 0:
                done[s.req_id] = s.out
                self.slots[i] = _Slot()
        return done
