"""Deterministic synthetic token stream (port of ``repro/data/pipeline.py``'s
``SyntheticLM``; numpy only, so the two packages draw identical batches).

A fixed-seed Zipf-weighted Markov stream with bigram structure: the
offline stand-in for the paper's WikiText-2/C4 calibration and evaluation
sets.  Batches are a pure function of (seed, step, host).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    batch: int                      # per-host batch
    seed: int = 0                   # structure seed (the "language")
    branching: int = 12             # bigram fan-out; lower = more learnable
    stream_seed: int | None = None  # sampling seed: the same language with
                                    # another stream is a second corpus

    def __post_init__(self):
        if self.stream_seed is None:
            self.stream_seed = self.seed
        rng = np.random.default_rng(self.seed)
        # each token can be followed by `branching` candidates, Zipf weights
        self._next = rng.integers(0, self.vocab,
                                  size=(self.vocab, self.branching))
        w = 1.0 / np.arange(1, self.branching + 1)
        self._w = w / w.sum()

    def batch_at(self, step: int, host: int = 0) -> dict:
        """{"tokens", "labels"} int32 [batch, seq_len], labels shifted by
        one."""
        rng = np.random.default_rng(
            (self.stream_seed * 1_000_003 + step) * 131 + host)
        toks = np.empty((self.batch, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=self.batch)
        for t in range(self.seq_len):
            choice = rng.choice(self.branching, size=self.batch, p=self._w)
            toks[:, t + 1] = self._next[toks[:, t], choice]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def calibration(self, n_batches: int,
                    start_step: int = 10_000) -> list[dict]:
        """A held-out slice used as the pruning calibration set."""
        return [self.batch_at(start_step + i) for i in range(n_batches)]
