"""Synthetic data pipeline: deterministic, shardable token streams (the
port's own copy of ``repro.data.pipeline``: numpy, no device state).

Real deployments stream tokenized documents; here the pipeline produces a
deterministic PRNG token stream with document structure (EOS-delimited
segments, Zipfian token marginals) so loss curves are meaningful and runs
are exactly reproducible across restarts -- the property fault-tolerance
tests rely on: ``batch_at(step)`` is a pure function of (seed, step), so a
restarted run consumes identical data with no iterator state to snapshot.
"""

from __future__ import annotations

import numpy as np

__all__ = ["TokenPipeline"]


class TokenPipeline:
    def __init__(self, vocab_size: int, batch: int, seq_len: int, seed: int = 0,
                 mean_doc_len: int = 512):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.mean_doc = mean_doc_len
        # Zipf-ish marginal over the vocab (heavy head, like text)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.p = p / p.sum()

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for a global step: {'tokens','labels','mask'}."""
        rng = np.random.default_rng((self.seed, step))
        toks = rng.choice(self.vocab, size=(self.batch, self.seq + 1), p=self.p)
        # EOS-delimited documents: sprinkle token 0 with 1/mean_doc rate
        eos = rng.random((self.batch, self.seq + 1)) < 1.0 / self.mean_doc
        toks = np.where(eos, 0, toks).astype(np.int32)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
            "mask": np.ones((self.batch, self.seq), np.float32),
        }

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
