"""Fast greedy DPP MAP inference — the paper's Algorithm 1 ("Div-DPP").

Incremental-Cholesky greedy MAP approximation (paper §4.2), the torch
counterpart of ``repro.core.greedy_chol``:

* each remaining candidate ``i`` carries a row vector ``c_i`` and a scalar
  ``d_i^2 = L_ii - ||c_i||^2`` with ``det(L_{Y u {i}}) = det(L_Y) d_i^2``;
* selection (eq. 13):  ``j = argmax_i d_i``                    — O(M);
* update (eqs. 16-18): ``e_i = (L_ji - <c_j, c_i>) / d_j``,
  ``c_i <- [c_i e_i]``, ``d_i^2 <- d_i^2 - e_i^2``             — O(Mk);
* stop when ``#Y = N`` or ``d_j <= eps`` (eq. 20, justified by Thm 4.1).

``c`` is pre-allocated ``(B, M, N)`` zeros and column ``t`` is written at
step ``t`` in place.  The batch dimension is written out (JAX vmaps a
single-problem loop); single-problem entry points run a batch of one.
The k-step loop is a Python loop over device tensors: it never reads a
value back to the host.

Argmax ties go to the lowest index (``torch.argmax`` returns the first
maximum, as ``jnp.argmax`` does); an all ``-inf`` row selects index 0.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.device import constant

NEG_INF = float("-inf")


class GreedyResult(NamedTuple):
    """Result of greedy MAP inference.

    indices:     (N,) int32 — selected item ids in selection order; slots
                 after an eps-stop hold -1.
    n_selected:  ()  int32 — number of valid entries in ``indices``.
    d_hist:      (N,) float — the marginal-gain sequence d^k (paper
                 Thm 4.1: positive, non-increasing while selection runs).
                 Slots after the stop hold 0.

    Batched entry points add a leading (B,) dimension to every field.
    """

    indices: torch.Tensor
    n_selected: torch.Tensor
    d_hist: torch.Tensor


def lane_steps(t, B: int, device) -> torch.Tensor:
    """A step index — an int or per-lane counters — as ``(B,)`` int64."""
    return constant(t, device=device).to(torch.int64).expand(B)


def greedy_step_exact(row_fn, t, c, d2, stopped, eps2):
    """One step of Algorithm 1 on the column-layout state ``c (B, M, k)``.

    ``d2 (B, M)``, ``stopped (B,)`` bool, ``eps2`` a 0-d tensor of the
    state dtype; ``row_fn(j)`` returns the rows ``L[b, j[b]]`` as
    ``(B, M)``.  ``t`` is the absolute step index (the column of ``c``
    the new Cholesky row lands in): an int, or a ``(B,)`` tensor of
    per-lane counters (the streaming slot layout); ``c`` is updated in
    place, and a stopped lane's column is left as it is.

    Returns ``(c, d2, stopped, j, dj)``.
    """
    ar = torch.arange(d2.shape[0], device=d2.device)
    col = lane_steps(t, d2.shape[0], d2.device).clamp_max(c.shape[2] - 1)
    j = torch.argmax(d2, dim=1)
    dj2 = d2[ar, j]
    # Stop rule (eq. 20): d_j <= eps  <=>  d_j^2 <= eps^2 (d_j >= 0).
    stopped = stopped | (dj2 <= eps2)
    dj = torch.sqrt(torch.maximum(dj2, eps2))  # guarded; unused when stopped
    # Update (eqs. 16-18): e = (L_j - c c_j) / d_j.
    cj = c[ar, j]  # (B, k)
    e = (row_fn(j) - torch.bmm(c, cj[:, :, None])[..., 0]) / dj[:, None]
    e = torch.where(stopped[:, None], 0.0, e)
    c[ar, :, col] = torch.where(stopped[:, None], c[ar, :, col], e)
    d2_next = d2 - e * e
    d2_next[ar, j] = constant(NEG_INF, d2.dtype, d2.device)  # remove j
    d2 = torch.where(stopped[:, None], d2, d2_next)
    return c, d2, stopped, j, dj


def _greedy_loop(
    diag: torch.Tensor,
    row_fn: Callable[[torch.Tensor], torch.Tensor],
    k: int,
    eps: float,
    mask: torch.Tensor,
) -> GreedyResult:
    """Shared batched greedy loop.

    diag:   (B, M) float — L_ii for every candidate.
    row_fn: j (B,) -> (B, M) float — row L_j of each user's kernel.
    mask:   (B, M) bool — True where the candidate is selectable.
    """
    B, M = diag.shape
    dtype, dev = diag.dtype, diag.device
    eps2 = constant(eps, dtype=dtype, device=dev) ** 2

    d2 = torch.where(mask, diag, NEG_INF)
    c = torch.zeros((B, M, k), dtype=dtype, device=dev)
    sel = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    d_hist = torch.zeros((B, k), dtype=dtype, device=dev)
    stopped = torch.zeros((B,), dtype=torch.bool, device=dev)
    for t in range(k):
        c, d2, stopped, j, dj = greedy_step_exact(
            row_fn, t, c, d2, stopped, eps2
        )
        sel[:, t] = torch.where(stopped, -1, j).to(torch.int32)
        d_hist[:, t] = torch.where(stopped, 0.0, dj)
    n_selected = (sel >= 0).sum(-1).to(torch.int32)
    return GreedyResult(sel, n_selected, d_hist)


def _full_mask(mask, shape, device):
    if mask is None:
        return torch.ones(shape, dtype=torch.bool, device=device)
    return mask.to(device=device, dtype=torch.bool).expand(shape)


def _dense_rows(L):
    ar = torch.arange(L.shape[0], device=L.device)
    return lambda j: L[ar, j]


def _lowrank_rows(V):
    ar = torch.arange(V.shape[0], device=V.device)
    return lambda j: torch.bmm(V[ar, :, j][:, None, :], V)[:, 0]


def _unbatch(res: GreedyResult) -> GreedyResult:
    return GreedyResult(res.indices[0], res.n_selected[0], res.d_hist[0])


def dpp_greedy_dense_batch(
    L: torch.Tensor, k: int, eps: float = 1e-6,
    mask: Optional[torch.Tensor] = None,
) -> GreedyResult:
    """Algorithm 1 per user on explicit kernels L (B, M, M), mask (B, M)."""
    mask = _full_mask(mask, L.shape[:2], L.device)
    return _greedy_loop(
        torch.diagonal(L, dim1=-2, dim2=-1), _dense_rows(L), k, eps, mask
    )


def dpp_greedy_lowrank_batch(
    V: torch.Tensor, k: int, eps: float = 1e-6,
    mask: Optional[torch.Tensor] = None,
) -> GreedyResult:
    """Algorithm 1 per user on ``L = V^T V``, V (B, D, M), mask (B, M).

    Row ``L_j = V[:, j] @ V`` is recomputed per step — O(DM) extra FLOPs
    per step traded for O(M^2) memory never allocated.
    """
    mask = _full_mask(mask, (V.shape[0], V.shape[2]), V.device)
    return _greedy_loop((V * V).sum(1), _lowrank_rows(V), k, eps, mask)


def dpp_greedy_dense(
    L: torch.Tensor, k: int, eps: float = 1e-6,
    mask: Optional[torch.Tensor] = None,
) -> GreedyResult:
    """Algorithm 1 on an explicit (M, M) kernel ``L``."""
    m = None if mask is None else mask[None]
    return _unbatch(dpp_greedy_dense_batch(L[None], k, eps, m))


def dpp_greedy_lowrank(
    V: torch.Tensor, k: int, eps: float = 1e-6,
    mask: Optional[torch.Tensor] = None,
) -> GreedyResult:
    """Algorithm 1 on the implicit kernel ``L = V^T V``, ``V (D, M)``."""
    m = None if mask is None else mask[None]
    return _unbatch(dpp_greedy_lowrank_batch(V[None], k, eps, m))


def dpp_greedy(
    relevance: torch.Tensor,
    k: int,
    *,
    similarity: Optional[torch.Tensor] = None,
    feats: Optional[torch.Tensor] = None,
    alpha=1.0,
    eps: float = 1e-6,
    mask: Optional[torch.Tensor] = None,
) -> GreedyResult:
    """Convenience front-end: builds the (implicit) kernel and runs Div-DPP.

    Exactly one of ``similarity`` (dense (M, M)) or ``feats`` (column-
    normalized (D, M)) must be given.
    """
    from repro_torch.core import kernel_matrix as km

    if (similarity is None) == (feats is None):
        raise ValueError("pass exactly one of similarity= or feats=")
    if similarity is not None:
        L = km.build_kernel_dense(relevance, similarity, alpha)
        return dpp_greedy_dense(L, k, eps, mask)
    V = km.scaled_features(feats, relevance, alpha)
    return dpp_greedy_lowrank(V, k, eps, mask)
