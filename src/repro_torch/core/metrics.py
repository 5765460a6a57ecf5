"""Accuracy and diversity metrics (paper §5.2.2), the torch port's own
copy of ``repro.core.metrics`` (numpy only).

* recall              - fraction of users whose held-out test item appears
                        in the recommended slate;
* average / minimum / median pairwise dissimilarity ``1 - S_ij`` within
  the slate (the min and median are the paper's two *new* metrics).

All slate metrics accept -1-padded index vectors (the eps-stop of
Algorithm 1) and ignore padded slots.  ``mean_slate_diversity_rows``
computes the same numbers as ``mean_slate_diversity`` from the item
feature rows, without the (M, M) similarity matrix.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def recall_at_n(selections: np.ndarray, test_items: np.ndarray) -> float:
    """selections (U, N) int, test_items (U,) int -> recall in [0, 1]."""
    selections = np.asarray(selections)
    test_items = np.asarray(test_items)
    hits = (selections == test_items[:, None]).any(axis=1)
    return float(hits.mean())


def _pairwise_dissim(sel: np.ndarray, S: np.ndarray) -> np.ndarray:
    """Upper-triangle pairwise dissimilarities of the valid slate items."""
    sel = sel[sel >= 0]
    if sel.size < 2:
        return np.zeros((0,))
    sub = S[np.ix_(sel, sel)]
    iu = np.triu_indices(sel.size, k=1)
    return 1.0 - sub[iu]


def slate_diversity(sel: np.ndarray, S: np.ndarray) -> Dict[str, float]:
    """average / minimum / median dissimilarity of one slate (paper §5.2.2)."""
    d = _pairwise_dissim(np.asarray(sel), np.asarray(S))
    if d.size == 0:
        return {"avg": 0.0, "min": 0.0, "median": 0.0}
    return {
        "avg": float(d.mean()),
        "min": float(d.min()),
        "median": float(np.median(d)),
    }


def mean_slate_diversity(selections: np.ndarray, S: np.ndarray) -> Dict[str, float]:
    """Per-user diversity averaged over users (the paper's Figure-3 y-axes)."""
    accs = {"avg": [], "min": [], "median": []}
    for sel in np.asarray(selections):
        m = slate_diversity(sel, S)
        for key in accs:
            accs[key].append(m[key])
    return {key: float(np.mean(v)) for key, v in accs.items()}


def mean_slate_diversity_rows(selections: np.ndarray,
                              feats: np.ndarray) -> Dict[str, float]:
    """``mean_slate_diversity(selections, feats @ feats.T)`` from each
    slate's own rows: O(k^2 D) per slate instead of an (M, M) matrix."""
    accs = {"avg": [], "min": [], "median": []}
    feats = np.asarray(feats)
    for sel in np.asarray(selections):
        rows = feats[sel[sel >= 0]]
        m = slate_diversity(np.arange(rows.shape[0]), rows @ rows.T)
        for key in accs:
            accs[key].append(m[key])
    return {key: float(np.mean(v)) for key, v in accs.items()}


def log_det_objective(L: np.ndarray, sel: np.ndarray) -> float:
    """log det(L_Y) of a slate - the MAP objective being greedily maximized.

    Used by tests/benchmarks to compare solution quality across methods.
    """
    sel = np.asarray(sel)
    sel = sel[sel >= 0]
    if sel.size == 0:
        return 0.0
    sign, logdet = np.linalg.slogdet(np.asarray(L, np.float64)[np.ix_(sel, sel)])
    return float(logdet) if sign > 0 else -np.inf
