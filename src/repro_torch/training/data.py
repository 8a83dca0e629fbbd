"""Synthetic LM data pipeline: deterministic, learnable, infinite.

A copy of the reference's ``training/data.py`` (pure numpy; the port
imports nothing of the reference), so both frameworks train on the same
batches bit for bit.  Sequences follow a fixed random bigram chain over the
vocab with noise — enough structure that a small model's loss visibly
drops within a few steps — fully reproducible from the seed; each batch is
generated whole on the host."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class BigramDataPipeline:
    def __init__(self, vocab_size: int, seq_len: int, batch_size: int, *,
                 seed: int = 0, noise: float = 0.1, branching: int = 4):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.noise = noise
        rng = np.random.default_rng(seed)
        # each token has `branching` plausible successors
        self._succ = rng.integers(0, vocab_size,
                                  (vocab_size, branching)).astype(np.int32)
        self._seed = seed

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self._seed, step))
        b, s, v = self.batch_size, self.seq_len, self.vocab_size
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = rng.integers(0, v, b)
        branch = rng.integers(0, self._succ.shape[1], (b, s))
        noise_mask = rng.random((b, s)) < self.noise
        noise_tok = rng.integers(0, v, (b, s))
        for t in range(1, s):
            nxt = self._succ[toks[:, t - 1], branch[:, t]]
            toks[:, t] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        return {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
                "mask": np.concatenate([np.ones((b, s - 1), np.float32),
                                        np.zeros((b, 1), np.float32)], 1)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
