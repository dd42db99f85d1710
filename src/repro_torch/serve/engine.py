"""LM generation (port of ``repro.serve.engine``): prefill + a decode loop,
and a slot-based continuous-batching manager (requests enter and leave
fixed batch slots between decode steps).

``generate`` prefills the prompt and decodes greedily, or samples at a
``temperature`` from an explicit ``torch.Generator``.  ``SlotServer`` keeps
the JAX package's behaviour, quirks included: each request is prefilled
alone (batch 1) and its cache spliced into a free slot of the batch cache,
and every step decodes all slots at one shared position, the largest
among the active slots (caches mask by absolute position).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..models import model as M

__all__ = ["generate", "SlotServer"]


def _pick(lg, temperature: float, generator):
    if temperature > 0:
        probs = torch.softmax(lg[:, -1].float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
    return torch.argmax(lg[:, -1], dim=-1)[:, None]


@torch.inference_mode()
def generate(params, cfg, tokens, steps: int, max_len: int | None = None,
             temperature: float = 0.0, generator: torch.Generator | None = None):
    """Greedy/temperature generation: prefill the prompt, then decode.
    tokens: (B, S) integer ids on the params' device -> (B, steps) ids.
    The first id comes from the prefill, each later one from a decode
    step (``steps - 1`` of them).  Sampling draws from ``generator``, a
    ``torch.Generator`` on that device."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    max_len = max_len or min(cfg.max_seq_len, tokens.shape[1] + steps)
    logits, caches, pos = M.prefill(params, cfg, tokens=tokens, max_len=max_len)
    tok = _pick(logits, temperature, generator)
    out = [tok]
    for i in range(steps - 1):
        logits, caches = M.decode_step(params, cfg, caches, tok, pos + i)
        tok = _pick(logits, temperature, generator)
        out.append(tok)
    return torch.cat(out, dim=1)


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
