"""Synthetic LM data pipeline (deterministic, shardable, CPU-friendly).

A copy of ``repro.data.pipeline`` (numpy only; the port never imports
the JAX package): the same seeds give the same batches, bitwise.

Generates a Zipf-distributed token stream with short-range structure (a
first-order Markov chain over a small state space) so models actually have
something learnable — loss decreases measurably within a few hundred steps
on reduced configs.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    n_states: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse-ish Markov transition over hidden states
        self._trans = rng.dirichlet(np.full(self.n_states, 0.25),
                                    size=self.n_states)
        # each state emits from a Zipf-tilted slice of the vocab
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        zipf = 1.0 / ranks
        self._emit = np.stack([
            np.roll(zipf, rng.integers(0, self.vocab)) for _ in
            range(self.n_states)])
        self._emit /= self._emit.sum(axis=1, keepdims=True)

    def batches(self, *, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            rng = np.random.default_rng((self.seed, step))
            toks = np.empty((self.batch, self.seq_len + 1), np.int32)
            state = rng.integers(0, self.n_states, size=self.batch)
            for t in range(self.seq_len + 1):
                for b in range(self.batch):
                    toks[b, t] = rng.choice(self.vocab,
                                            p=self._emit[state[b]])
                    state[b] = rng.choice(self.n_states,
                                          p=self._trans[state[b]])
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            step += 1


@dataclasses.dataclass
class FastSyntheticLM:
    """Vectorized variant (no per-token Python loop) for bigger batches.

    Keeps the Zipf marginal but models structure as ``next ≈ f(prev)`` with
    noise — cheap to sample yet non-trivial to predict.
    """

    vocab: int
    seq_len: int
    batch: int
    seed: int = 0

    def batches(self, *, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        p = (1.0 / ranks) / np.sum(1.0 / ranks)
        while True:
            rng = np.random.default_rng((self.seed, 7, step))
            base = rng.choice(self.vocab, size=(self.batch, self.seq_len + 1),
                              p=p)
            # structure: 60 % of positions deterministically derive from the
            # previous token; the rest stay random
            mix = rng.random((self.batch, self.seq_len)) < 0.6
            derived = (base[:, :-1] * 31 + 7) % self.vocab
            base[:, 1:][mix] = derived[mix]
            yield {"tokens": base[:, :-1].astype(np.int32),
                   "labels": base[:, 1:].astype(np.int32)}
            step += 1
