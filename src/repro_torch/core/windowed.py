"""Windowed Div-DPP: diversity against the last ``w`` picks only.

The torch counterpart of ``repro.core.windowed``'s incremental path,
O(w M) per step with O(w M) state, so slate length is unbounded.  State
is the window Cholesky factor's action on every candidate,
``C (B, w, M)`` with ``C[b, :, i] = V_W^{-1} L_{W, i}`` kept in window
order (row 0 = oldest pick).  Appending a pick is the paper's eq. 16-18
row append; evicting the oldest pick is a first-row Cholesky downdate:
``w - 1`` Givens rotations applied to the rows of ``C``, computed from
``C`` itself (``C[:, win]`` *is* the window factor), with ``d_i^2``
repaired from the rotation residue (``d2 += u^2``).  See the JAX module
for the derivation.

``d_hist`` stores the marginal at selection time, before the eviction
(``dj``, not the post-eviction ``djp`` the append divides by).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.greedy_chol import (
    NEG_INF,
    GreedyResult,
    _dense_rows,
    _full_mask,
    _lowrank_rows,
    _unbatch,
    lane_steps,
)


def greedy_step_windowed(row_fn, t, C, d2, win, stopped, *, w, eps2, tiny):
    """One sliding-window greedy step on the ring state ``C (B, w, M)``.

    ``d2 (B, M)``, ``win (B, w)`` int64 ring ids (-1 = empty slot),
    ``stopped (B,)``; ``eps2``/``tiny`` 0-d tensors of the state dtype.
    ``t`` is the absolute step index (it decides eviction, ``t >= w``,
    and the ring row ``pos``): an int, or a ``(B,)`` tensor of per-lane
    counters (the streaming slot layout).

    Returns ``(C, d2, win, stopped, j, dj)``.
    """
    B, M = d2.shape
    ar = torch.arange(B, device=d2.device)
    C0, d20, win0 = C, d2, win

    # ---- select against the current window of min(t, w) picks
    j = torch.argmax(d2, dim=1)
    dj2 = d2[ar, j]
    stopped = stopped | (dj2 <= eps2)
    dj = torch.sqrt(torch.maximum(dj2, eps2))

    # ---- evict the oldest window item to make room (window full only)
    full = (lane_steps(t, B, d2.device) >= w) & ~stopped  # (B,)
    fullc = full[:, None]
    C = C.clone()
    u = torch.where(fullc, C[:, 0], 0.0)
    win_shift = torch.roll(win, -1, dims=1)  # win_shift[:, r] = old win[:, r+1]
    for r in range(w - 1):
        # when not evicting, read row r and rotate by identity (no-op)
        row = torch.where(fullc, C[:, r + 1], C[:, r])
        idx = win_shift[:, r].clamp_min(0)
        a = row[ar, idx]  # current window-factor diagonal V22[r, r]
        b = u[ar, idx]  # current downdate vector entry v[r]
        rho = torch.maximum(torch.sqrt(a * a + b * b), tiny)
        cos = torch.where(full, a / rho, 1.0)[:, None]
        sin = torch.where(full, b / rho, 0.0)[:, None]
        new_row = cos * row + sin * u
        u = cos * u - sin * row
        C[:, r] = new_row
    # the evicted slot: stale last row is cleared, d2 regains the norm
    # carried away by the rotation residue row
    C[:, w - 1] = torch.where(fullc, 0.0, C[:, w - 1])
    d2 = torch.where(fullc, d2 + u * u, d2)
    shifted = win_shift.clone()
    shifted[:, w - 1] = -1
    win = torch.where(fullc, shifted, win)

    # ---- append j against the *post-eviction* window (eqs. 16-18);
    # its marginal there is d2[j] repaired by the eviction (>= dj2)
    djp = torch.sqrt(torch.maximum(d2[ar, j], eps2))
    cj = C[ar, :, j]  # (B, w)
    e = (row_fn(j) - torch.bmm(cj[:, None, :], C)[:, 0]) / djp[:, None]
    pos = lane_steps(t, B, d2.device).clamp_max(w - 1)
    C_next = C.clone()
    C_next[ar, pos] = e
    d2_next = d2 - e * e
    d2_next[ar, j] = NEG_INF
    win_next = win.clone()
    win_next[ar, pos] = j

    stc = stopped[:, None]
    C = torch.where(stc[:, :, None], C0, C_next)
    d2 = torch.where(stc, d20, d2_next)
    win = torch.where(stc, win0, win_next)
    return C, d2, win, stopped, j, dj


def _windowed_loop(diag, row_fn, k: int, window: int, eps: float, mask):
    """Incremental sliding-window greedy, O(w M) per step.

    diag:   (B, M) float — L_ii for every candidate.
    row_fn: j (B,) -> (B, M) float — row L_j of each user's kernel.
    """
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    B, M = diag.shape
    w = min(window, k)
    dtype, dev = diag.dtype, diag.device
    eps2 = torch.tensor(eps, dtype=dtype, device=dev) ** 2
    tiny = torch.tensor(1e-30, dtype=dtype, device=dev)

    d2 = torch.where(mask, diag, NEG_INF)
    C = torch.zeros((B, w, M), dtype=dtype, device=dev)
    win = torch.full((B, w), -1, dtype=torch.int64, device=dev)
    sel = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    d_hist = torch.zeros((B, k), dtype=dtype, device=dev)
    stopped = torch.zeros((B,), dtype=torch.bool, device=dev)
    for t in range(k):
        C, d2, win, stopped, j, dj = greedy_step_windowed(
            row_fn, t, C, d2, win, stopped, w=w, eps2=eps2, tiny=tiny
        )
        sel[:, t] = torch.where(stopped, -1, j).to(torch.int32)
        d_hist[:, t] = torch.where(stopped, 0.0, dj)
    return GreedyResult(sel, (sel >= 0).sum(-1).to(torch.int32), d_hist)


def dpp_greedy_windowed_batch(
    L: torch.Tensor, k: int, window: int = 10, eps: float = 1e-6,
    mask: Optional[torch.Tensor] = None,
) -> GreedyResult:
    """Sliding-window greedy per user on dense L (B, M, M), mask (B, M)."""
    mask = _full_mask(mask, L.shape[:2], L.device)
    return _windowed_loop(
        torch.diagonal(L, dim1=-2, dim2=-1), _dense_rows(L), k, window,
        eps, mask,
    )


def dpp_greedy_windowed_lowrank_batch(
    V: torch.Tensor, k: int, window: int = 10, eps: float = 1e-6,
    mask: Optional[torch.Tensor] = None,
) -> GreedyResult:
    """Sliding-window greedy per user on ``L = V^T V``, V (B, D, M)."""
    mask = _full_mask(mask, (V.shape[0], V.shape[2]), V.device)
    return _windowed_loop(
        (V * V).sum(1), _lowrank_rows(V), k, window, eps, mask
    )


def dpp_greedy_windowed(
    L: torch.Tensor, k: int, window: int = 10, eps: float = 1e-6,
    mask: Optional[torch.Tensor] = None,
) -> GreedyResult:
    """Greedy MAP with a sliding diversity window of the last ``w`` picks
    on a dense (M, M) kernel.  ``window >= k`` equals exact Algorithm 1."""
    m = None if mask is None else mask[None]
    return _unbatch(dpp_greedy_windowed_batch(L[None], k, window, eps, m))


def dpp_greedy_windowed_lowrank(
    V: torch.Tensor, k: int, window: int = 10, eps: float = 1e-6,
    mask: Optional[torch.Tensor] = None,
) -> GreedyResult:
    """Sliding-window greedy on the implicit kernel ``L = V^T V``,
    V (D, M)."""
    m = None if mask is None else mask[None]
    return _unbatch(
        dpp_greedy_windowed_lowrank_batch(V[None], k, window, eps, m)
    )
