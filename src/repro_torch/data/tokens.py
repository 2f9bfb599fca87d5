"""Synthetic LM token pipeline (a numpy copy of ``repro.data.tokens``):
deterministic, shardable, restart-safe.

A Zipf-distributed Markov-like stream with enough structure that a trained
LM measurably lowers its loss. Batches are keyed by (step, shard), so a run
resumed from a checkpoint replays exactly the batches it would have
consumed; the same (seed, step, shard) gives the reference's batch bit for
bit.
"""
from __future__ import annotations

import numpy as np


class SyntheticTokenStream:
    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 seed: int = 0, shard: int = 0, num_shards: int = 1):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.seed = seed
        self.shard = shard
        self.num_shards = num_shards
        # fixed bigram structure: token t prefers successors near (a*t+c) % V
        rng = np.random.default_rng(seed)
        self._a = int(rng.integers(1, vocab_size - 1)) | 1
        self._c = int(rng.integers(0, vocab_size))
        zipf = 1.0 / (np.arange(1, vocab_size + 1) ** 1.1)
        self._p = zipf / zipf.sum()

    def batch(self, step: int) -> dict:
        """{'tokens', 'labels'}: (batch_size, seq_len) int32 numpy arrays,
        labels the tokens shifted by one."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.shard
        )
        b, s, v = self.batch_size, self.seq_len, self.vocab_size
        toks = np.empty((b, s + 1), np.int64)
        toks[:, 0] = rng.choice(v, size=b, p=self._p)
        noise = rng.random((b, s))
        jumps = rng.choice(v, size=(b, s), p=self._p)
        for t in range(s):
            succ = (self._a * toks[:, t] + self._c) % v
            toks[:, t + 1] = np.where(noise[:, t] < 0.75, succ, jumps[:, t])
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
