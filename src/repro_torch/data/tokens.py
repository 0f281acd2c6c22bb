"""Synthetic LM token pipeline (deterministic, seeded)."""
from __future__ import annotations

import numpy as np


def token_batches(vocab_size: int, batch: int, seq: int, *, seed: int = 0,
                  n_batches: int | None = None):
    """Yields {'tokens': (B, S), 'labels': (B, S)} int32. Zipf-ish marginal so
    the loss actually decreases when training."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    i = 0
    while n_batches is None or i < n_batches:
        toks = rng.choice(vocab_size, size=(batch, seq + 1), p=probs)
        toks = toks.astype(np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        i += 1
