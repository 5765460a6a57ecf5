"""Naive greedy MAP approximation — the paper's *baseline* (eq. (8)),
the torch port's counterpart of ``repro.core.greedy_naive``.

At step k it evaluates ``det(L_{Y u {i}})`` for every remaining candidate
``i`` with an explicit determinant — O(k^3) per candidate, O(N^3 M) per
slate.  This is the algorithm Figure 1 of the paper compares against and
the exactness oracle for Algorithm 1 (both must select identical items).

``greedy_map_naive`` is float64 numpy, a copy of ``repro``'s oracle.
``greedy_map_naive_vmapped`` keeps ``repro``'s name for the "vectorized
as well as possible" Figure-1 baseline: per step one batched
``torch.linalg.slogdet`` over the M gathered ``(t+1) x (t+1)``
submatrices, on ``L``'s device and in ``L``'s dtype, so the measured
speedup is not an artifact of poor baseline engineering.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def greedy_map_naive(
    L: np.ndarray,
    k: int,
    eps: float = 1e-6,
    mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Paper eq. (8): j = argmax_i det(L_{Y u {i}}), numpy float64.

    Returns (indices, gains) where ``gains[t]`` is the determinant ratio
    ``det(L_{Y_t}) / det(L_{Y_{t-1}})`` (= d_t^2 of Algorithm 1) so tests
    can check the determinant identity det(L_Y) = prod d^2.

    Stops early when the best marginal gain ``sqrt(ratio) <= eps``
    (mirrors Algorithm 1's eq.-(20) stop so both methods stay comparable).
    """
    L = np.asarray(L, np.float64)
    M = L.shape[0]
    selectable = np.ones(M, bool) if mask is None else np.asarray(mask, bool).copy()
    sel: list[int] = []
    gains: list[float] = []
    det_prev = 1.0
    for _ in range(k):
        cand = np.flatnonzero(selectable)
        if cand.size == 0:
            break
        best_j, best_det = -1, -np.inf
        for i in cand:
            idx = sel + [int(i)]
            det_i = np.linalg.det(L[np.ix_(idx, idx)])
            if det_i > best_det:
                best_det, best_j = det_i, int(i)
        ratio = best_det / det_prev
        if ratio <= eps * eps:
            break
        sel.append(best_j)
        gains.append(ratio)
        selectable[best_j] = False
        det_prev = best_det
    out = np.full(k, -1, np.int64)
    out[: len(sel)] = sel
    g = np.zeros(k, np.float64)
    g[: len(gains)] = gains
    return out, g


def greedy_map_naive_vmapped(
    L: torch.Tensor, k: int, eps: float = 1e-6
) -> np.ndarray:
    """Vectorized naive greedy: per step, one batched ``slogdet`` over all
    M candidates' ``(t+1) x (t+1)`` submatrices ``L[Y + [i], Y + [i]]``,
    on ``L.device`` in ``L.dtype``.  The strongest-possible "original
    greedy" baseline of Figure 1.

    As ``repro``'s version, it takes ``eps`` but never stops early: all
    ``k`` slots are filled.  A submatrix whose determinant has sign <= 0
    scores -inf; ties go to the first maximal index.  The selection stays
    on the device (no host read per step); returns (k,) int64 numpy.
    """
    M = L.shape[0]
    dev = L.device
    diag = torch.diagonal(L)
    sel = torch.empty((k,), dtype=torch.long, device=dev)
    selectable = torch.ones((M,), dtype=torch.bool, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=L.dtype, device=dev)
    for t in range(k):
        base = sel[:t]
        # sub[i] = [[L_YY, L_Yi], [L_iY, L_ii]], gathered by index_select
        # from L's t rows Y: (t, M) and never an (M, M, t) index
        rows = L.index_select(0, base)  # (t, M): L[Y, :]
        cols = L.index_select(1, base)  # (M, t): L[:, Y]
        sub = torch.empty((M, t + 1, t + 1), dtype=L.dtype, device=dev)
        sub[:, :t, :t] = rows.index_select(1, base)
        sub[:, :t, t] = rows.T
        sub[:, t, :t] = cols
        sub[:, t, t] = diag
        sign, logdet = torch.linalg.slogdet(sub)
        lds = torch.where((sign > 0) & selectable, logdet, neg_inf)
        j = torch.argmax(lds)
        sel[t] = j
        selectable[j] = False
    return sel.cpu().numpy()
