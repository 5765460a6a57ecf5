"""Public wrapper for the dpp_greedy CUDA kernels.

Kernel-first dispatch (``TilePolicy``): while one user's gains and the
winner's staged columns fit a thread block's shared memory, the resident
whole-slate kernels in ``dpp_greedy.py`` run (the entire greedy loop in
one launch); past the budget, or with an explicit ``tile_m``, the tiled
per-step kernels in ``tiled.py`` run (one launch per greedy step).  The
plain reference is reachable only through ``force_ref=True``.

On CPU tensors every mode runs its kernels' plain PyTorch versions; on
CUDA tensors it launches the kernels or raises.  Inputs are upcast to
float32; there is no padding of ``D`` or ``M``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.dpp_greedy.dpp_greedy import dpp_greedy_kernel
from repro_torch.kernels.dpp_greedy.ref import dpp_greedy_ref
from repro_torch.kernels.dpp_greedy.tiled import dpp_greedy_tiled
from repro_torch.kernels.dpp_greedy.tiling import (
    TilePolicy,
    resident_smem_bytes,
    tiled_smem_bytes,
)
from repro_torch.obs.dispatch import (
    record_kernel_dispatch,
    record_tile_resolution,
)


def dpp_greedy(
    V: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    eps: float = 1e-3,
    force_ref: bool = False,
    window: Optional[int] = None,
    tile_m: Optional[int] = None,
):
    """Batched greedy DPP MAP inference.

    V (B, D, M) scaled features, mask (B, M). Returns (sel, d_hist) with
    shape (B, k); sel slots after an eps-stop hold -1.  ``window=w``
    enforces diversity only against the last w picks (O(w M) state,
    unbounded k); ``window >= k`` or None is the exact Algorithm 1.
    ``tile_m`` forces the tiled kernels with that candidate-axis tile.
    """
    B, D, M = V.shape
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    policy = TilePolicy(tile_m=tile_m)
    V = V.to(torch.float32).contiguous()
    if mask is None:
        mask = torch.ones((B, M), dtype=torch.bool, device=V.device)
    mask = mask.to(device=V.device, dtype=torch.bool).expand(B, M).contiguous()
    windowed = window is not None and window < k
    state_rows = min(window, k) if windowed else k
    if force_ref:
        record_kernel_dispatch(
            "ref", D=D, M=M, state_rows=state_rows, windowed=windowed
        )
        return dpp_greedy_ref(V, mask, k, eps, window=window)

    record_tile_resolution("explicit" if tile_m is not None else "model")
    mode, tm = policy.decide(D, M, state_rows, windowed)
    record_kernel_dispatch(
        mode, D=D, M=M, state_rows=state_rows, windowed=windowed, tile_m=tm,
        smem_bytes=(
            resident_smem_bytes(D, M, state_rows, windowed)
            if mode == "resident" else tiled_smem_bytes(D, state_rows,
                                                        windowed)
        ),
    )
    if mode == "resident":
        return dpp_greedy_kernel(V, mask, k, window=window, eps=eps)
    return dpp_greedy_tiled(V, mask, k, window=window, eps=eps, tile_m=tm)
