"""DPP slate re-ranking as a serving stage: the model-side config and the
shortlist and kernel construction (the torch counterpart of
``repro.serving.reranker``).

Any scorer that yields ``(relevance scores, item feature vectors)`` can
be diversified: shortlist the top-C candidates, build the implicit DPP
kernel ``L = Diag(a^r) F^T F Diag(a^r)`` over the shortlist, and run the
paper's fast greedy MAP through ``repro_torch.core.greedy_map``.

* ``use_kernel=True`` routes through the hand-written CUDA kernels
  (resident while one user's gains fit a block's shared memory, tiled
  past that; ``tile_m=`` pins the tiled kernels, ``tile_m="auto"`` takes
  the tile past the resident gate from the measured autotune cache);
  the default runs the plain PyTorch core.
* ``mesh=`` (a ``repro_torch.distributed.CandidateMesh``, with
  ``axis_name=``) shards the candidate axis over the ranks of a process
  group and delegates to ``repro_torch.serving.sharded_rerank``: a
  sharded top-C shortlist mask, then the candidate-sharded greedy MAP
  (``repro_torch.core.sharded``), whose local update is the shard-local
  update entry of K3/K4 on a CUDA mesh; ``tile_m=`` sets its tile;
  ``chunk_size=`` streams on the mesh (``Reranker.stream``).
* ``window=w`` enforces diversity only against the last ``w`` picks.
* ``mask=`` (on the request) excludes candidates before the shortlist
  and inside greedy selection.

``DPPRerankConfig`` validates itself at construction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.dispatch import GreedySpec
from repro_torch.core.kernel_matrix import map_relevance
from repro_torch.obs import ObsConfig


@dataclasses.dataclass(frozen=True)
class DPPRerankConfig:
    """Model-side serving configuration.

    ``slate_size`` / ``shortlist`` are session defaults that a
    ``RerankRequest`` may override.  ``chunk_size`` is the default chunk
    of ``Reranker.stream`` (and, with ``use_kernel``, runs the whole
    slate as fused chunk kernels; with ``mesh=``, chunks of the ranks'
    resumable state).  ``mesh=`` and ``use_kernel`` are mutually
    exclusive backends.  ``tile_m="auto"`` needs ``use_kernel=True``:
    the resident kernels while they fit, past that the measured autotune
    cache's tile (``kernels/dpp_greedy/autotune.py``), the model's on a
    miss; a mesh refuses it, as ``repro``'s does.
    """

    slate_size: int = 50  # N (session default; RerankRequest overrides)
    shortlist: int = 1000  # C (session default; RerankRequest overrides)
    alpha: float = 4.0  # trade-off (paper eq. 21); 1.0 = pure diversity
    eps: float = 1e-3
    use_kernel: bool = False  # CUDA kernels (their plain versions on CPU)
    window: Optional[int] = None  # sliding diversity window (None = exact)
    mesh: Optional[object] = None  # CandidateMesh: shard the candidate axis
    axis_name: str = "data"  # the mesh axis carrying the candidate shards
    # kernel candidate-axis tile (an int forces tiled; "auto": measured)
    tile_m: Optional[object] = None
    chunk_size: Optional[int] = None
    obs: Optional[ObsConfig] = None  # observability (installed by Reranker)

    def __post_init__(self):
        if self.slate_size <= 0:
            raise ValueError(f"slate_size must be >= 1, got {self.slate_size}")
        if self.shortlist <= 0:
            raise ValueError(f"shortlist must be >= 1, got {self.shortlist}")
        if self.window is not None and self.window <= 0:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.eps < 0:
            raise ValueError(f"eps must be >= 0, got {self.eps}")
        if self.chunk_size is not None and self.chunk_size <= 0:
            raise ValueError(
                f"chunk_size must be >= 1, got {self.chunk_size}"
            )
        if self.mesh is not None and self.use_kernel:
            raise ValueError(
                "use_kernel (the single-device CUDA kernels) and mesh (the "
                "candidate-sharded backend) are mutually exclusive rerank "
                "backends"
            )
        if self.tile_m is not None:
            from repro_torch.kernels.dpp_greedy.tiling import validate_tile_m

            validate_tile_m(self.tile_m, allow_auto=True)
            if self.tile_m == "auto" and not self.use_kernel:
                raise ValueError(
                    'tile_m="auto" consults the measured autotune cache, '
                    "which only the CUDA kernels do — set use_kernel=True "
                    "(the torch and sharded backends do not consult the "
                    "cache)"
                )
            if not self.use_kernel and self.mesh is None:
                raise ValueError(
                    "tile_m= tiles the CUDA kernels — it needs "
                    "use_kernel=True or mesh= (the torch backend would "
                    "silently ignore it)"
                )

    def greedy_spec(self) -> GreedySpec:
        if self.mesh is not None:
            backend = "sharded"
        elif self.use_kernel:
            backend = "kernel"
        else:
            backend = "torch"
        return GreedySpec(
            k=self.slate_size,
            window=self.window,
            backend=backend,
            eps=self.eps,
            mesh=self.mesh,
            axis_name=self.axis_name,
            tile_m=self.tile_m,
            # the torch spec cannot carry a chunk size (its whole-slate
            # path would silently ignore it — GreedySpec rejects that);
            # Reranker.stream passes it to the chunk executor directly
            chunk_size=(self.chunk_size
                        if self.use_kernel or self.mesh is not None
                        else None),
        )


def _shortlist_kernel(scores, feats, cfg, mask):
    """The top-C shortlist and its implicit DPP kernel, per user.

    scores (B, M); feats (M, D) shared or (B, M, D) per user; mask (B, M)
    bool or None.  Returns ``(V (B, D, C) float32, shortlist mask (B, C)
    or None, top_i (B, C) global ids)``.

    The top-C is a stable descending sort, so equal scores keep the
    lowest index first, as ``jax.lax.top_k`` orders them (``torch.topk``
    promises no order among ties, and a different shortlist permutation
    changes the emitted ids).  Masked candidates rank last through the
    dtype's ``finfo.min`` sentinel and have their relevance zeroed.
    """
    B, M = scores.shape
    C = min(cfg.shortlist, M)
    s = scores if mask is None else torch.where(
        mask, scores, torch.finfo(scores.dtype).min
    )
    top_s, order = torch.sort(s, dim=-1, descending=True, stable=True)
    top_s, top_i = top_s[:, :C], order[:, :C]
    if feats.ndim == 2:
        f = feats[top_i]  # (B, C, D)
    else:
        f = feats[torch.arange(B, device=feats.device)[:, None], top_i]
    rel = map_relevance(top_s.to(torch.float32), cfg.alpha)
    m_top = None if mask is None else mask.gather(1, top_i)
    if m_top is not None:
        # the sentinel score only exists to rank masked items last; keep
        # it out of the kernel (alpha < 1 maps it to inf)
        rel = torch.where(m_top, rel, 0.0)
    V = (f.to(torch.float32) * rel[..., None]).transpose(1, 2).contiguous()
    return V, m_top, top_i
