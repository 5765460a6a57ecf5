"""Plain-torch oracle for the dpp_greedy kernels.

An independent implementation path: ``repro_torch.core.greedy_chol``
keeps the Cholesky state as (M, N) columns (the paper's layout), while
the kernels use the transposed (N, M) row layout.  The windowed mode is
``repro_torch.core.windowed``'s incremental path.
"""
from __future__ import annotations

import torch

from repro_torch.core.greedy_chol import dpp_greedy_lowrank_batch
from repro_torch.core.windowed import dpp_greedy_windowed_lowrank_batch


def dpp_greedy_ref(
    V: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    eps: float = 1e-3,
    window: int | None = None,
):
    """V (B, D, M), mask (B, M) -> (sel (B, k) int32, d_hist (B, k) f32)."""
    V, mask = V.to(torch.float32), mask.to(torch.bool)
    if window is not None and window < k:
        res = dpp_greedy_windowed_lowrank_batch(V, k, window, eps, mask)
    else:
        res = dpp_greedy_lowrank_batch(V, k, eps, mask)
    return res.indices, res.d_hist
