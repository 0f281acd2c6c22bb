"""Synthetic recsys click batches (Criteo-shaped, zipf-distributed ids)."""
from __future__ import annotations

import numpy as np


def click_batches(vocab_sizes, n_dense: int, batch: int, *, seed: int = 0,
                  n_batches: int | None = None):
    rng = np.random.default_rng(seed)
    vocab = np.asarray(vocab_sizes)
    i = 0
    while n_batches is None or i < n_batches:
        # zipf-ish ids: squared uniform concentrates mass on low ids
        u = rng.uniform(size=(batch, len(vocab))) ** 3
        sparse = (u * vocab[None, :]).astype(np.int32)
        dense = rng.normal(size=(batch, n_dense)).astype(np.float32)
        # a weak planted signal so training converges
        logit = dense[:, 0] * 0.5 + (sparse[:, 0] % 7 == 0) * 1.0 - 0.5
        label = (rng.uniform(size=batch) < 1 / (1 + np.exp(-logit)))
        yield {"sparse": sparse, "dense": dense,
               "label": label.astype(np.float32)}
        i += 1
