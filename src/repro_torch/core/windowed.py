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

Also the conditioning side: :func:`window_solve` solves candidate
columns against a window factor, the one block solve behind a session's
delta updates (``core.streaming.greedy_state_extend`` / ``_rescore`` and
``serving.session``) and :func:`windowed_state_rebuild`, which
recomputes a ring state from the pool, the last ``w`` shown ids and the
dead set (the session layer's eviction repair);
:func:`dpp_greedy_windowed_rebuild` is the rebuild-every-step oracle on
a dense kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import constant

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
    eps2 = constant(eps, dtype=dtype, device=dev) ** 2
    tiny = constant(1e-30, dtype=dtype, device=dev)

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


def window_solve(F: torch.Tensor, Vwin: torch.Tensor, X: torch.Tensor,
                 c: Optional[torch.Tensor] = None):
    """Condition pool columns ``X (D, n)`` on a window: returns their
    ring rows ``c = F^{-1} Vwin^T X`` ``(f, n)`` and gains ``d2 = |X|^2 -
    |c|^2`` ``(n,)``.

    ``Vwin (D, f)`` holds the window's pool columns, oldest first, and
    ``F (f, f)`` the lower-triangular Cholesky factor of their Gram
    (only its lower triangle is read: a ring state's ``C[:, win]^T`` is
    one).  An empty ring slot is a zero column of ``Vwin`` with an
    identity row and column of ``F``, and gives a zero row of ``c``.
    ``c``, when given, receives the ring rows in place.  O(f D n + f^2
    n): the cost of a session's delta is that of its columns alone."""
    d2 = (X * X).sum(0)
    if F.shape[0] == 0:  # an empty window conditions nothing
        return X.new_zeros((0, X.shape[1])), d2
    b = (Vwin.T @ X).to(F.dtype)
    c = torch.linalg.solve_triangular(F, b, upper=False, out=c)
    return c, d2 - (c * c).sum(0)


def windowed_state_rebuild(V: torch.Tensor, shown: torch.Tensor,
                           dead: torch.Tensor):
    """Rebuild the incremental ring state ``(C (w, M), d2 (M,))`` from
    history alone.

    A windowed state is a pure function of the pool ``V (D, M)``, the
    last ``w`` shown pool columns (``shown (w,)`` integer ids, oldest
    first, -1-padded at the tail) and the dead set (``dead (M,)`` bool:
    every ever-shown or masked-out column, padding included).  The
    window's Gram is positive definite without jitter (every pick
    cleared the eps gate, so the incremental factor's diagonal is at
    least eps) and its Cholesky factor is unique, so this lands on the
    ``C`` rows the incremental path reached, up to rounding (~1 ulp).

    ``torch.linalg.cholesky_ex`` skips the ``info`` check (and the host
    sync it costs on a card) that ``cholesky`` makes: the Gram is
    positive definite by construction.  Every column is then solved
    against the factor by :func:`window_solve`.  This is the session
    layer's eviction repair (``repro_torch.serving.session``).
    """
    w = shown.shape[0]
    ids = shown.clamp_min(0).to(torch.int64)
    valid = shown >= 0
    Vwin = torch.where(valid[None, :], V[:, ids], 0.0)  # (D, w)
    eye = torch.eye(w, dtype=V.dtype, device=V.device)
    vm = valid[:, None] & valid[None, :]
    F, _ = torch.linalg.cholesky_ex(torch.where(vm, Vwin.T @ Vwin, eye))
    C, d2 = window_solve(F, Vwin, V)
    return C, torch.where(dead, NEG_INF, d2)


def dpp_greedy_windowed_rebuild(
    L: torch.Tensor, k: int, window: int = 10, eps: float = 1e-6,
    mask: Optional[torch.Tensor] = None,
) -> GreedyResult:
    """Reference sliding-window greedy on a dense (M, M) kernel: rebuild
    and re-solve the window every step.

    O(w^2 M) per step (against the incremental path's O(w M));
    independently derived, kept as the oracle the fast paths are tested
    against.  Empty ring slots get an identity row and column so the
    factor stays defined; the factor is of ``L_W + 1e-6 I``, as
    ``repro``'s.
    """
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    M = L.shape[0]
    w = min(window, k)
    dtype, dev = L.dtype, L.device
    eps2 = constant(eps, dtype=dtype, device=dev) ** 2
    if mask is None:
        mask = torch.ones((M,), dtype=torch.bool, device=dev)
    diag = torch.diagonal(L)
    eye = torch.eye(w, dtype=dtype, device=dev)
    sel = torch.full((k,), -1, dtype=torch.int32, device=dev)
    d_hist = torch.zeros((k,), dtype=dtype, device=dev)
    win = torch.full((w,), -1, dtype=torch.int64, device=dev)
    avail = torch.where(mask.to(device=dev, dtype=torch.bool), 0.0,
                        NEG_INF).to(dtype)
    stopped = torch.zeros((), dtype=torch.bool, device=dev)
    for t in range(k):
        ids = win.clamp_min(0)
        valid = win >= 0
        vm = valid[:, None] & valid[None, :]
        Lw = torch.where(vm, L[ids][:, ids], eye)
        F, _ = torch.linalg.cholesky_ex(Lw + 1e-6 * eye)
        Lwi = torch.where(valid[:, None], L[ids], 0.0)  # (w, M)
        C = torch.linalg.solve_triangular(F, Lwi, upper=False)
        d2 = diag - (C * C).sum(0) + avail  # -inf for taken / masked
        j = torch.argmax(d2)
        dj2 = d2[j]
        stopped = stopped | (dj2 <= eps2)
        dj = torch.sqrt(torch.maximum(dj2, eps2))
        sel[t] = torch.where(stopped, -1, j).to(torch.int32)
        d_hist[t] = torch.where(stopped, 0.0, dj)
        win_next, avail_next = win.clone(), avail.clone()
        win_next[t % w] = j
        avail_next[j] = NEG_INF
        win = torch.where(stopped, win, win_next)
        avail = torch.where(stopped, avail, avail_next)
    return GreedyResult(sel, (sel >= 0).sum().to(torch.int32), d_hist)
