"""DPP kernel-matrix construction (paper eqs. (5), (21), (22)).

The paper builds the DPP kernel from a relevance vector ``r`` and an item
similarity matrix ``S``::

    L = Diag(m(r)) . S . Diag(m(r)),     m(r_i) = alpha ** r_i   (alpha >= 1)

Two representations, as in ``repro.core.kernel_matrix``:

* **dense** — the explicit ``(M, M)`` kernel ``L``;
* **implicit low-rank** — ``S = F^T F`` for column-normalized features
  ``F in (D, M)``, represented by ``V = F * m(r)`` so that
  ``L = V^T V``; any row ``L_j = V[:, j]^T V`` is recomputed on the fly.

Every function broadcasts over leading batch dimensions.
"""
from __future__ import annotations

import torch

from repro_torch.device import constant


def map_relevance(r: torch.Tensor, alpha) -> torch.Tensor:
    """Paper eq. (21): m(r_i) = alpha ** r_i, computed in log space."""
    alpha = constant(alpha, dtype=r.dtype, device=r.device)
    return torch.exp(r * torch.log(alpha))


def normalize_columns(F: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-l2-normalize the columns of a (D, M) feature matrix."""
    nrm = torch.linalg.vector_norm(F, dim=-2, keepdim=True)
    return F / torch.clamp_min(nrm, eps)


def similarity_from_features(F: torch.Tensor) -> torch.Tensor:
    """S = F^T F for column-normalized F (paper §5.1 synthetic setup)."""
    return F.transpose(-1, -2) @ F


def build_kernel_dense(
    relevance: torch.Tensor, similarity: torch.Tensor, alpha=1.0
) -> torch.Tensor:
    """Paper eq. (22): L = Diag(alpha^r) S Diag(alpha^r)."""
    m = map_relevance(relevance, alpha)
    return (m[..., :, None] * similarity) * m[..., None, :]


def build_kernel_dense_raw(
    relevance: torch.Tensor, similarity: torch.Tensor
) -> torch.Tensor:
    """Paper eq. (5): L = Diag(r) S Diag(r) (no exponential mapping)."""
    return (relevance[..., :, None] * similarity) * relevance[..., None, :]


def scaled_features(
    feats: torch.Tensor, relevance: torch.Tensor, alpha=1.0
) -> torch.Tensor:
    """Implicit kernel: V = F * alpha^r so that L = V^T V.

    ``feats`` is (D, M) column-normalized; ``relevance`` is (M,).
    """
    return feats * map_relevance(relevance, alpha)[..., None, :]


def scaled_features_raw(
    feats: torch.Tensor, relevance: torch.Tensor
) -> torch.Tensor:
    """Implicit eq.-(5) kernel: V = F * r."""
    return feats * relevance[..., None, :]
