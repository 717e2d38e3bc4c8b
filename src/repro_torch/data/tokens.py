"""Synthetic LM token stream for the transformer-family architectures
(NumPy; the port's copy of the JAX package's ``data/tokens.py``).

Generates a deterministic, seeded Zipf-distributed token stream with local
n-gram structure (so losses actually decrease during the smoke training
runs) and yields (tokens, labels) batches. Replace with a real corpus
loader in deployment; the trainer only sees the iterator protocol.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["TokenStream"]


@dataclass
class TokenStream:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        # Markov-ish structure: each token biases the next within a band.
        while True:
            base = rng.zipf(1.3, size=(self.batch_size, self.seq_len + 1))
            tok = np.minimum(base - 1, self.vocab_size - 1).astype(np.int32)
            drift = rng.integers(0, 17, size=tok.shape).astype(np.int32)
            tok = (tok + np.cumsum(drift, axis=1) // 16) % self.vocab_size
            yield tok[:, :-1], tok[:, 1:]

    def batch(self, step: int = 0):
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        base = rng.zipf(1.3, size=(self.batch_size, self.seq_len + 1))
        tok = np.minimum(base - 1, self.vocab_size - 1).astype(np.int32)
        return tok[:, :-1], tok[:, 1:]
