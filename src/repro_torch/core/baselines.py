"""Reference diversifiers (the torch port's own copy of the numpy part of
``repro.core.baselines``): pure relevance Top-N and the random baseline.
MMR and greedy-avg are JAX loops in ``repro`` and are not ported yet
(ROADMAP queue 1 item 2).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def top_n_select(r: np.ndarray, k: int, mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Pure relevance Top-N."""
    r = np.asarray(r)
    if mask is not None:
        r = np.where(mask, r, -np.inf)
    return np.argsort(-r, kind="stable")[:k]


def random_top_select(
    r: np.ndarray,
    k: int,
    b: int,
    rng: np.random.Generator,
    mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Random baseline (paper §5): N uniform picks from the N+b most relevant."""
    pool = top_n_select(r, k + b, mask)
    if b == 0:
        return pool
    return rng.choice(pool, size=min(k, pool.size), replace=False)
