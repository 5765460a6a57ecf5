"""One front door for greedy DPP MAP inference.

The torch counterpart of ``repro.core.dispatch``: every greedy variant
ported so far — exact Algorithm 1 (dense or low-rank, single or batched),
the sliding-window incremental variant, and the CUDA whole-slate kernels
— is reachable through ``greedy_map`` with a ``GreedySpec``.

Dispatch rules:

* kernel representation — pass exactly one of ``L`` (dense, (M, M) or
  (B, M, M)) or ``V`` (low-rank ``L = V^T V``, (D, M) or (B, D, M));
* ``spec.window`` — ``None`` (or ``>= k``) runs the exact Algorithm 1;
  smaller windows run the O(w M)-per-step sliding-window greedy;
* ``spec.backend`` — "torch" runs the plain PyTorch core; "kernel"
  routes low-rank inputs through ``repro_torch.kernels.dpp_greedy``
  (CUDA kernels on CUDA tensors, their plain versions on CPU tensors;
  dense inputs are rejected — the kernels never materialize L);
  "sharded" shards the candidate axis over ``spec.mesh``
  (``repro_torch.core.sharded``: every rank of the mesh's process group
  calls ``greedy_map`` with the same arguments; low-rank only); "auto"
  is "sharded" when a mesh is set, else "torch";
* ``spec.tile_m`` — candidate-axis tile for the kernels; it forces the
  tiled per-step kernels (by default ``TilePolicy`` keeps the resident
  kernels while they fit shared memory and tiles past that), and sets
  the tile of the fused chunk kernels; on the sharded backend, the tile
  of the shard-local update entries.  ``"auto"`` (kernel backend only:
  the sharded update entries need an explicit tile, as in ``repro``)
  keeps the resident rule and takes the tile past it from the measured
  autotune cache (``kernels/dpp_greedy/autotune.py``), the model's tile
  on a miss;
* ``spec.chunk_size`` — greedy steps per resumable chunk.  On the kernel
  backend ``greedy_map`` then runs the slate as fused chunk kernels (one
  K5/K6 launch per chunk), on the sharded backend as chunks of the
  rank's resumable state, and returns the identical slate.  The torch
  whole-slate path has no chunked execution, so ``chunk_size`` with
  ``backend='torch'`` (or ``'auto'`` without a mesh) is rejected at
  construction — torch streaming passes ``chunk_size=`` to
  ``greedy_map_chunks``.

``greedy_map_chunks`` is the streaming front door: a generator yielding
per-chunk ``GreedyResult``s whose concatenation is the whole-slate
``greedy_map`` result (see ``repro_torch.core.streaming``).

``GreedySpec`` validates itself at construction — a bad config raises
``GreedySpecError`` (a ``ValueError``) at spec-build time.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.greedy_chol import (
    GreedyResult,
    dpp_greedy_dense_batch,
    dpp_greedy_lowrank_batch,
)
from repro_torch.core.windowed import (
    dpp_greedy_windowed_batch,
    dpp_greedy_windowed_lowrank_batch,
)
from repro_torch.obs.dispatch import record_greedy_map

_BACKENDS = ("auto", "torch", "kernel", "sharded")


class GreedySpecError(ValueError):
    """Invalid ``GreedySpec`` — raised at spec construction time."""


@dataclasses.dataclass(frozen=True)
class GreedySpec:
    """How to run greedy MAP: slate size, window, backend, mesh,
    tolerance."""

    k: int
    window: Optional[int] = None  # None = exact Algorithm 1
    backend: str = "auto"  # "auto" | "torch" | "kernel" | "sharded"
    eps: float = 1e-6
    mesh: Optional[object] = None  # CandidateMesh of the sharded backend
    axis_name: str = "data"  # the mesh axis carrying the candidate shards
    # kernel candidate-axis tile (an int forces tiled; "auto": measured)
    tile_m: Optional[object] = None
    chunk_size: Optional[int] = None  # greedy steps per resumable chunk

    def __post_init__(self):
        if self.k <= 0:
            raise GreedySpecError(f"k must be >= 1, got {self.k}")
        if self.window is not None and self.window < 1:
            raise GreedySpecError(f"window must be >= 1, got {self.window}")
        if self.backend not in _BACKENDS:
            raise GreedySpecError(
                f"unknown backend {self.backend!r}; expected one of {_BACKENDS}"
            )
        if self.backend == "sharded" and self.mesh is None:
            raise GreedySpecError(
                "backend='sharded' needs mesh= (and axis_name=)"
            )
        if self.mesh is not None and self.backend not in ("auto", "sharded"):
            raise GreedySpecError(
                f"mesh= only applies to the sharded backend (backend="
                f"'sharded' or 'auto'), not {self.backend!r} — a mesh with "
                f"a single-device backend would be silently ignored"
            )
        if self.chunk_size is not None:
            if self.chunk_size < 1:
                raise GreedySpecError(
                    f"chunk_size must be >= 1, got {self.chunk_size}"
                )
            if self.backend != "kernel" and not self.sharded():
                raise GreedySpecError(
                    "chunk_size= selects chunked execution, which only the "
                    "kernel (fused chunk kernels) and sharded (resumable "
                    "rank state) backends implement — on the torch "
                    "whole-slate path it would be silently ignored; stream "
                    "through greedy_map_chunks(..., chunk_size=) instead"
                )
        if self.tile_m is not None:
            from repro_torch.kernels.dpp_greedy.tiling import validate_tile_m

            try:
                validate_tile_m(self.tile_m, allow_auto=True)
            except ValueError as e:
                raise GreedySpecError(str(e)) from None
            if self.tile_m == "auto" and self.backend != "kernel":
                raise GreedySpecError(
                    'tile_m="auto" consults the measured autotune cache, '
                    "which only the single-device kernel dispatch does "
                    "(backend='kernel') — the torch backend ignores tile_m "
                    "and the sharded update entries need an explicit warp "
                    "multiple"
                )
            if self.backend != "kernel" and not self.sharded():
                raise GreedySpecError(
                    "tile_m= only applies to the CUDA kernels "
                    "(backend='kernel', or 'sharded'/'auto' with a mesh) — "
                    "on the torch backend it would be silently ignored"
                )

    def windowed(self) -> bool:
        return self.window is not None and self.window < self.k

    def sharded(self) -> bool:
        return self.backend == "sharded" or (
            self.backend == "auto" and self.mesh is not None
        )


def greedy_map(
    spec: GreedySpec,
    *,
    L: Optional[torch.Tensor] = None,
    V: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> GreedyResult:
    """Run greedy DPP MAP per ``spec`` on a dense (L) or low-rank (V) kernel.

    Accepts single problems (L (M, M) / V (D, M)) and user batches
    (L (B, M, M) / V (B, D, M)); returns a ``GreedyResult`` whose fields
    gain a leading batch dimension in the batched case.  ``mask`` may be
    per-problem ((M,) / (B, M)) or a shared (M,) filter alongside a
    batched L/V, broadcast to (B, M) here once.
    """
    if (L is None) == (V is None):
        raise ValueError("pass exactly one of L= (dense) or V= (low-rank)")
    if spec.backend == "kernel" and L is not None:
        raise ValueError(
            "backend='kernel' needs the low-rank V — the kernels never "
            "materialize the dense L"
        )
    if spec.sharded() and L is not None:
        raise ValueError(
            "backend='sharded' needs the low-rank V — a dense L cannot be "
            "candidate-sharded"
        )
    kern = L if L is not None else V
    batched = kern.ndim == 3
    if not batched:
        kern = kern[None]
        mask = None if mask is None else mask[None]
    if mask is not None:
        mask = mask.to(device=kern.device, dtype=torch.bool).expand(
            kern.shape[0], kern.shape[-1]
        )

    backend = ("sharded" if spec.sharded()
               else "kernel" if spec.backend == "kernel" else "torch")
    chunked = spec.chunk_size is not None
    record_greedy_map(backend, B=kern.shape[0], k=spec.k, M=kern.shape[-1],
                      chunked=chunked)

    if chunked:
        # fused chunk kernels or the sharded state, chunk by chunk: the
        # identical slate
        chunks = list(greedy_map_chunks(spec, V=kern, mask=mask))
        sel = torch.cat([c.indices for c in chunks], dim=-1)
        dh = torch.cat([c.d_hist for c in chunks], dim=-1)
        res = GreedyResult(sel, (sel >= 0).sum(-1).to(torch.int32), dh)
    elif backend == "sharded":
        from repro_torch.core.sharded import dpp_greedy_sharded

        res = dpp_greedy_sharded(
            kern, spec.k, mesh=spec.mesh, axis_name=spec.axis_name,
            window=spec.window, eps=spec.eps, mask=mask, tile_m=spec.tile_m,
        )
    elif backend == "kernel":
        from repro_torch.kernels.dpp_greedy import dpp_greedy as dpp_kernel

        sel, dh = dpp_kernel(kern, spec.k, mask=mask, eps=spec.eps,
                             window=spec.window, tile_m=spec.tile_m)
        res = GreedyResult(sel, (sel >= 0).sum(-1).to(torch.int32), dh)
    elif L is not None:
        if spec.windowed():
            res = dpp_greedy_windowed_batch(kern, spec.k, spec.window,
                                            spec.eps, mask)
        else:
            res = dpp_greedy_dense_batch(kern, spec.k, spec.eps, mask)
    elif spec.windowed():
        res = dpp_greedy_windowed_lowrank_batch(kern, spec.k, spec.window,
                                                spec.eps, mask)
    else:
        res = dpp_greedy_lowrank_batch(kern, spec.k, spec.eps, mask)
    if batched:
        return res
    return GreedyResult(res.indices[0], res.n_selected[0], res.d_hist[0])


def greedy_map_chunks(
    spec: GreedySpec,
    *,
    L: Optional[torch.Tensor] = None,
    V: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    chunk_size: Optional[int] = None,
):
    """Generator running greedy MAP per ``spec`` in resumable chunks.

    Yields ``ceil(k / chunk)`` :class:`GreedyResult`s whose ``indices`` /
    ``d_hist`` cover ``chunk`` selections each (the last chunk is short
    when ``chunk`` does not divide ``k``); their concatenation is the
    whole-slate ``greedy_map`` result, indices index for index.  After an
    eps-stop the remaining slots hold -1 / 0, as the whole-slate tail
    does.

    ``chunk_size`` overrides ``spec.chunk_size`` — that is how the torch
    backend (whose spec cannot carry a chunk size) streams.  Backends:
    torch takes single problems (dense L or low-rank V); kernel takes
    single or batched low-rank V, one K5/K6 launch per chunk; sharded
    takes single or batched low-rank V on ``spec.mesh``, one update
    launch a step on each rank's shard.  On a mesh every rank of the
    group runs the generator to its end (or every rank stops at the same
    chunk): a rank that stops early leaves its peers blocked in the next
    step's collective.
    """
    from repro_torch.core.streaming import (
        greedy_chunk,
        greedy_init,
        resolve_chunk,
        slot_pad_v,
    )

    chunk = resolve_chunk(spec, chunk_size)
    kern = L if L is not None else V
    if mask is not None and kern is not None and kern.ndim == 3 \
            and mask.ndim == 1:
        mask = mask.expand(kern.shape[0], mask.shape[0])
    state = greedy_init(spec, L=L, V=V, mask=mask)
    if V is not None:
        V = slot_pad_v(spec, V, state)  # once, so no chunk copies V
    done = 0
    while done < spec.k:
        c = min(chunk, spec.k - done)
        state, sel, dh = greedy_chunk(spec, state, L=L, V=V, chunk_size=c)
        yield GreedyResult(sel, (sel >= 0).sum(-1).to(torch.int32), dh)
        done += c
