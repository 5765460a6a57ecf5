"""Synthetic data pipelines (the torch counterpart of
``repro.data.synthetic``; numpy only, so both packages draw the same
batches from the same seed).

Only the recsys click-log generator is ported; the LM token stream and
the graphs wait for ROADMAP queue 1 item 12.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def recsys_batches(
    vocab_sizes: Tuple[int, ...],
    batch: int,
    hot: int = 1,
    seed: int = 0,
    planted_dim: int = 8,
    signal_scale: float = 3.0,
) -> Iterator[dict]:
    """ids (B, F, H) int32 (-1 pad), labels (B,) in {0,1} from a planted
    low-rank logistic model over hashed field embeddings."""
    rng = np.random.default_rng(seed)
    F = len(vocab_sizes)
    # planted per-field hash projections -> a fixed logistic teacher
    planted = [rng.normal(size=(min(v, 64), planted_dim)) * 0.5
               for v in vocab_sizes]
    w = rng.normal(size=(planted_dim,)) * signal_scale
    while True:
        ids = np.stack(
            [rng.integers(0, v, size=(batch, hot)) for v in vocab_sizes],
            axis=1,
        ).astype(np.int32)
        if hot > 1:  # random multi-hot padding to exercise bags
            drop = rng.uniform(size=ids.shape) < 0.3
            drop[:, :, 0] = False
            ids = np.where(drop, -1, ids)
        z = np.zeros((batch,))
        for f in range(F):
            emb = planted[f][ids[:, f, 0] % planted[f].shape[0]]
            z += emb @ w / np.sqrt(F)
        labels = (rng.uniform(size=batch) < 1 / (1 + np.exp(-z))).astype(
            np.float32)
        yield {"ids": ids, "labels": labels}
