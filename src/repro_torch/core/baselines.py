"""Reference diversification algorithms the paper compares against (§5),
the torch port's counterpart of ``repro.core.baselines``.

* MMR   (Carbonell & Goldstein '98, paper eq. (25)):
      j = argmax  theta*r_i + (1-theta) * min_{k in R} (1 - S_ki)
* Greedy (Bradley & Smyth '01, paper eq. (26)):
      j = argmax  theta*r_i + (1-theta) * mean_{k in R} (1 - S_ki)
  (The paper's displayed eq. (26) shows ``max`` but the surrounding text
  — "(26) uses the average dissimilarity" — and the cited [3] both say
  *average*; we implement average and note the typo.)
* Random/Top (paper §5): sample N uniformly from the N+b most relevant
  (b=0 degenerates to pure Top-N); numpy.

MMR and greedy-avg take (M,) relevance and (M, M) similarity tensors and
an optional (M,) selectable mask, and return (N,) int32 indices on the
inputs' device (no early stop — these methods always fill N slots, as in
the paper).  Each is a k-step loop of eager torch ops in ``repro``'s
operation order, so on the CPU its float32 scores are ``repro``'s bit
for bit; the loop never reads a value back to the host.  Argmax ties go
to the first index; a row left all -inf (a mask with fewer than k
selectable items) selects index 0, as ``jnp.argmax`` does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = float("-inf")


def _select_loop(r, S, k, theta, mask, use_min: bool):
    M = r.shape[0]
    dtype, dev = r.dtype, r.device
    theta = torch.as_tensor(theta, dtype=dtype, device=dev)
    if mask is None:
        mask = torch.ones((M,), dtype=torch.bool, device=dev)
    avail = torch.where(mask.to(dev), 0.0, NEG_INF).to(dtype)

    # State trackers for the dissimilarity aggregate over selected items.
    min_dis = torch.ones((M,), dtype=dtype, device=dev)  # min over empty
    sum_dis = torch.zeros((M,), dtype=dtype, device=dev)  # set := 1 -> first
    sel = torch.full((k,), -1, dtype=torch.int32, device=dev)  # pick: argmax r
    for t in range(k):
        if use_min:
            agg = min_dis
        else:
            agg = (torch.ones_like(sum_dis) if t == 0
                   else sum_dis / max(t, 1))
        score = theta * r + (1.0 - theta) * agg + avail
        j = torch.argmax(score)
        dis_j = 1.0 - S[j]  # dissimilarity of every item to the new pick
        min_dis = torch.minimum(min_dis, dis_j)
        sum_dis = sum_dis + dis_j
        avail[j] = NEG_INF
        sel[t] = j
    return sel


def mmr_select(
    r: torch.Tensor,
    S: torch.Tensor,
    k: int,
    theta: float = 0.5,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MMR (paper eq. (25)) — min-dissimilarity aggregate."""
    return _select_loop(r, S, k, theta, mask, use_min=True)


def greedy_avg_select(
    r: torch.Tensor,
    S: torch.Tensor,
    k: int,
    theta: float = 0.5,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Greedy [3] (paper eq. (26)) — average-dissimilarity aggregate."""
    return _select_loop(r, S, k, theta, mask, use_min=False)


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
