"""Resident whole-slate greedy DPP MAP kernels (K1 exact, K2 windowed).

CUDA counterparts of ``repro/kernels/dpp_greedy/dpp_greedy.py``'s
``_kernel`` and ``_kernel_windowed`` (``csrc/dpp_greedy.cu``): one thread
block per user runs the whole k-step greedy loop in one launch for the
whole batch, with the user's gains ``d2`` in shared memory and ``V`` and
the Cholesky rows ``C`` (row ``t`` written at step ``t``) in device
memory.  ``TilePolicy`` (``tiling.py``) decides when they fit.

Each kernel has its plain PyTorch version here, written step by step like
the Pallas body.  A wrapper runs the plain version for CPU tensors (the
tests) and launches its kernel for CUDA tensors, or raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.greedy_chol import NEG_INF, _lowrank_rows
from repro_torch.core.windowed import greedy_step_windowed
from repro_torch.kernels import cuda
from repro_torch.kernels.dpp_greedy.tiling import resident_smem_bytes

_SRC = Path(__file__).resolve().parent / "csrc" / "dpp_greedy.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "dpp_resident_set_smem": [_I, _I],
    "dpp_resident_exact": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "dpp_resident_windowed": [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P,
    ],
}


def eps_squared(eps: float) -> float:
    """``eps ** 2`` rounded as float32 arithmetic rounds it, as the JAX
    and plain paths compute the stop threshold."""
    return float(np.float32(eps) * np.float32(eps))


def init_gains(V: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Initial marginal gains ``d2 = diag(V^T V)``, ``-inf`` where masked:
    (B, M) float32, shared by every kernel path so resident and tiled runs
    start from identical bits."""
    return torch.where(mask, (V * V).sum(1), NEG_INF).contiguous()


def _check_inputs(V, d2):
    B, D, M = V.shape
    cuda.require(V, "V", torch.float32, (B, D, M))
    cuda.require(d2, "d2", torch.float32, (B, M))


def _cpu_or_cuda(t: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises otherwise."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.is_cuda


# ---------------------------------------------------------------------------
# K1: exact
# ---------------------------------------------------------------------------


def dpp_greedy_resident_plain(V, d2, k: int, eps: float):
    """Plain version of K1: V (B, D, M), d2 (B, M) initial gains ->
    (sel (B, k) int32, d_hist (B, k) float32).  Row layout ``C (B, k, M)``
    as the Pallas body keeps it."""
    B, D, M = V.shape
    ar = torch.arange(B, device=V.device)
    eps2 = torch.tensor(eps, dtype=torch.float32, device=V.device) ** 2
    C = torch.zeros((B, k, M), dtype=torch.float32, device=V.device)
    sel = torch.full((B, k), -1, dtype=torch.int32, device=V.device)
    dh = torch.zeros((B, k), dtype=torch.float32, device=V.device)
    stopped = torch.zeros((B,), dtype=torch.bool, device=V.device)
    for t in range(k):
        j = torch.argmax(d2, dim=1)
        dj2 = d2[ar, j]
        stopped = stopped | (dj2 <= eps2)
        dj = torch.sqrt(torch.maximum(dj2, eps2))
        # kernel row L_j = V[:, j]^T V and <c_j, c_i> for all i
        lj = torch.bmm(V[ar, :, j][:, None, :], V)[:, 0]
        dots = torch.bmm(C[ar, :, j][:, None, :], C)[:, 0]
        e = (lj - dots) / dj[:, None]
        C[:, t] = torch.where(stopped[:, None], 0.0, e)
        d2_next = d2 - e * e
        d2_next[ar, j] = NEG_INF
        d2 = torch.where(stopped[:, None], d2, d2_next)
        sel[:, t] = torch.where(stopped, -1, j).to(torch.int32)
        dh[:, t] = torch.where(stopped, 0.0, dj)
    return sel, dh


def dpp_greedy_resident(V, d2, k: int, eps: float):
    """K1: one launch for the whole batch.  V (B, D, M) f32, d2 (B, M)
    f32 initial gains -> (sel (B, k) int32, d_hist (B, k) f32)."""
    if not _cpu_or_cuda(V):
        return dpp_greedy_resident_plain(V, d2, k, eps)
    _check_inputs(V, d2)
    B, D, M = V.shape
    smem = resident_smem_bytes(D, M, k, windowed=False)
    C = torch.empty((B, k, M), dtype=torch.float32, device=V.device)
    sel = torch.empty((B, k), dtype=torch.int32, device=V.device)
    dh = torch.empty((B, k), dtype=torch.float32, device=V.device)
    lib = cuda.library(_SRC, _SIGNATURES)
    cuda.raise_smem(lib, "dpp_resident_set_smem", 0, smem, V.device)
    err = lib.dpp_resident_exact(
        V.data_ptr(), d2.data_ptr(), C.data_ptr(), sel.data_ptr(),
        dh.data_ptr(), B, D, M, k, eps_squared(eps), smem,
        cuda.stream_ptr(V),
    )
    cuda.count_launch("dpp_greedy_resident")
    cuda.check(err, "dpp_greedy_resident")
    return sel, dh


# ---------------------------------------------------------------------------
# K2: sliding window
# ---------------------------------------------------------------------------


def dpp_greedy_resident_windowed_plain(V, d2, k: int, w: int, eps: float):
    """Plain version of K2: the Pallas windowed body's select / evict
    (w - 1 Givens rotations swept over the ring rows, residue repairs d2)
    / append, which is ``repro_torch.core.windowed.greedy_step_windowed``
    on the same (B, w, M) ring."""
    B, D, M = V.shape
    dev = V.device
    eps2 = torch.tensor(eps, dtype=torch.float32, device=dev) ** 2
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=dev)
    row_fn = _lowrank_rows(V)
    C = torch.zeros((B, w, M), dtype=torch.float32, device=dev)
    win = torch.full((B, w), -1, dtype=torch.int64, device=dev)
    sel = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    dh = torch.zeros((B, k), dtype=torch.float32, device=dev)
    stopped = torch.zeros((B,), dtype=torch.bool, device=dev)
    for t in range(k):
        C, d2, win, stopped, j, dj = greedy_step_windowed(
            row_fn, t, C, d2, win, stopped, w=w, eps2=eps2, tiny=tiny
        )
        sel[:, t] = torch.where(stopped, -1, j).to(torch.int32)
        dh[:, t] = torch.where(stopped, 0.0, dj)
    return sel, dh


def dpp_greedy_resident_windowed(V, d2, k: int, w: int, eps: float):
    """K2: one launch for the whole batch, window ``w < k``."""
    if not _cpu_or_cuda(V):
        return dpp_greedy_resident_windowed_plain(V, d2, k, w, eps)
    _check_inputs(V, d2)
    B, D, M = V.shape
    smem = resident_smem_bytes(D, M, w, windowed=True)
    C = torch.empty((B, w, M), dtype=torch.float32, device=V.device)
    sel = torch.empty((B, k), dtype=torch.int32, device=V.device)
    dh = torch.empty((B, k), dtype=torch.float32, device=V.device)
    lib = cuda.library(_SRC, _SIGNATURES)
    cuda.raise_smem(lib, "dpp_resident_set_smem", 1, smem, V.device)
    err = lib.dpp_resident_windowed(
        V.data_ptr(), d2.data_ptr(), C.data_ptr(), sel.data_ptr(),
        dh.data_ptr(), B, D, M, k, w, eps_squared(eps), smem,
        cuda.stream_ptr(V),
    )
    cuda.count_launch("dpp_greedy_resident_windowed")
    cuda.check(err, "dpp_greedy_resident_windowed")
    return sel, dh


def dpp_greedy_kernel(V, mask, k: int, window=None, eps: float = 1e-3):
    """Batched resident greedy DPP MAP.

    V (B, D, M) float32, mask (B, M) bool.  ``window < k`` runs K2, else
    K1.  Returns (sel (B, k) int32, d_hist (B, k) float32).
    """
    d2 = init_gains(V, mask)
    if window is not None and window < k:
        return dpp_greedy_resident_windowed(V, d2, k, window, eps)
    return dpp_greedy_resident(V, d2, k, eps)
