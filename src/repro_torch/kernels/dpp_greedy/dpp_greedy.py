"""Resident whole-slate greedy DPP MAP kernels (K1 exact, K2 windowed).

CUDA counterparts of ``repro/kernels/dpp_greedy/dpp_greedy.py``'s
``_kernel`` and ``_kernel_windowed`` (``csrc/dpp_greedy.cu``): one launch
runs the whole k-step greedy loop for the whole batch, each user on one
thread-block cluster of ``s`` CTAs that hold its gains ``d2`` and, where
it fits, its ``V`` (and, windowed, its ring) in shared memory, slice by
slice, and exchange the step's argmax through DSMEM.  ``TilePolicy``
(``tiling.py``) decides when the resident kernels run,
``tiling.resident_cluster`` how they lay a user out (:func:`cluster_plan`
asks it once per shape and card).

Each kernel has its plain PyTorch version here, written step by step like
the Pallas body.  A wrapper runs the plain version for CPU tensors (the
tests) and launches its kernel for CUDA tensors, or raises.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.core.greedy_chol import NEG_INF, _lowrank_rows
from repro_torch.core.windowed import greedy_step_windowed
from repro_torch.kernels import cuda
from repro_torch.kernels.dpp_greedy.tiling import (
    ClusterPlan,
    cluster_smem_bytes,
    cluster_tile,
    resident_cluster,
)

_SRC = Path(__file__).resolve().parent / "csrc" / "dpp_greedy.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "dpp_resident_set_smem": [_I, _I],
    "dpp_resident_capacity": [_I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    "dpp_resident_exact": [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P,
    ],
    "dpp_resident_windowed": [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P,
    ],
}
# Cluster sizes a card test may force (16 needs the non-portable cluster
# attribute, which the kernels do not set, so a card refuses it).
_FORCEABLE = (1, 2, 4, 8, 16)


def _which(windowed: bool, v_resident: bool, state_resident: bool) -> int:
    """The kernel instantiation: ``2 * windowed + v_resident``, plus 4
    for K1 with its Cholesky rows in shared memory."""
    return (2 * int(windowed) + int(v_resident)
            + (4 if state_resident and not windowed else 0))


@functools.lru_cache(maxsize=None)
def _capacity(which: int, s: int, smem: int, index: int) -> int:
    lib = cuda.library(_SRC, _SIGNATURES)
    cuda.raise_smem(lib, "dpp_resident_set_smem", which, smem,
                    torch.device("cuda", index))
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = lib.dpp_resident_capacity(which, s, smem, ctypes.byref(n))
    # an error of the query (a cluster size the card refuses) places none
    return n.value if err == 0 else 0


def cluster_capacity(windowed: bool, s: int, smem: int, v_resident: bool,
                     state_resident: bool, device) -> int:
    """Clusters of ``s`` CTAs of K2 (``windowed``) or K1, in the
    instantiation for ``v_resident`` / ``state_resident``, at ``smem``
    bytes of shared memory a CTA that ``device`` holds at once
    (``cudaOccupancyMaxActiveClusters``; 0: it cannot place one), queried
    once per card, kernel and size."""
    device = torch.device(device)
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    return _capacity(_which(windowed, v_resident, state_resident), int(s),
                     int(smem), index)


@functools.lru_cache(maxsize=256)
def cluster_plan(D: int, M: int, state_rows: int, windowed: bool,
                 lanes: int, device: torch.device,
                 cluster: Optional[int] = None) -> ClusterPlan:
    """``tiling.resident_cluster``'s layout of ``lanes`` users on
    ``device``'s card (bounded by :func:`cluster_capacity`; on the CPU,
    where the plain versions run, by the shared memory alone), memoized
    per shape and card.  ``cluster`` forces the CTAs a user (card tests
    only)."""
    if cluster is not None and cluster not in _FORCEABLE:
        raise ValueError(f"cluster must be one of {_FORCEABLE}, got "
                         f"{cluster!r}")
    capacity = (functools.partial(cluster_capacity, windowed,
                                  device=device)
                if device.type == "cuda" else None)
    return resident_cluster(D, M, state_rows, windowed, lanes, capacity,
                            s=cluster)


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


def _launch(windowed, V, d2, k, w, eps, plan, cluster):
    """One K1 (K2 ``windowed``) cluster launch for the whole batch; the
    layout is ``plan`` (``ops.py`` passes the policy's), else the
    policy's for this shape (:func:`cluster_plan`, ``cluster`` forcing
    the CTAs a user)."""
    _check_inputs(V, d2)
    B, D, M = V.shape
    R = w if windowed else k
    if plan is None:
        plan = cluster_plan(D, M, R, windowed, B, V.device, cluster)
    s, vres, sres = plan
    smem = cluster_smem_bytes(D, M, R, windowed, s, vres, sres)
    which = _which(windowed, vres, sres)
    name = ("dpp_greedy_resident_windowed" if windowed
            else "dpp_greedy_resident")
    lib = cuda.library(_SRC, _SIGNATURES)
    cuda.raise_smem(lib, "dpp_resident_set_smem", which, smem, V.device)
    dev = V.device
    sel = torch.empty((B, k), dtype=torch.int32, device=dev)
    dh = torch.empty((B, k), dtype=torch.float32, device=dev)
    # the state (K2's ring, K1's Cholesky rows) in device memory unless
    # the CTAs keep it
    C = None if sres else torch.empty((B, R, M), dtype=torch.float32,
                                      device=dev)
    args = (V.data_ptr(), d2.data_ptr(), None if C is None else C.data_ptr(),
            sel.data_ptr(), dh.data_ptr(), B, D, M, k)
    tile = cluster_tile(M, s)
    if windowed:
        err = lib.dpp_resident_windowed(
            *args, w, s, tile, int(vres), int(sres), eps_squared(eps), smem,
            cuda.stream_ptr(V))
    else:
        err = lib.dpp_resident_exact(
            *args, s, tile, int(vres), int(sres), eps_squared(eps), smem,
            cuda.stream_ptr(V))
    cuda.count_launch(name)
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaError_t {err} (B={B}, "
            f"D={D}, M={M}, k={k}, w={w}: clusters of {s} CTAs, {smem} B of "
            f"shared memory a CTA, V resident {vres})"
        )
    return sel, dh


def dpp_greedy_resident(V, d2, k: int, eps: float,
                        plan: Optional[ClusterPlan] = None,
                        cluster: Optional[int] = None):
    """K1: one launch for the whole batch.  V (B, D, M) f32, d2 (B, M)
    f32 initial gains -> (sel (B, k) int32, d_hist (B, k) f32).  ``plan``
    is the policy's cluster layout (``ops.py`` passes it); ``cluster``
    forces the CTAs a user (card tests)."""
    if not _cpu_or_cuda(V):
        return dpp_greedy_resident_plain(V, d2, k, eps)
    return _launch(False, V, d2, k, None, eps, plan, cluster)


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


def dpp_greedy_resident_windowed(V, d2, k: int, w: int, eps: float,
                                 plan: Optional[ClusterPlan] = None,
                                 cluster: Optional[int] = None):
    """K2: one launch for the whole batch, window ``w < k``; ``plan`` and
    ``cluster`` as for :func:`dpp_greedy_resident`."""
    if not _cpu_or_cuda(V):
        return dpp_greedy_resident_windowed_plain(V, d2, k, w, eps)
    return _launch(True, V, d2, k, w, eps, plan, cluster)


def dpp_greedy_kernel(V, mask, k: int, window=None, eps: float = 1e-3,
                      plan: Optional[ClusterPlan] = None):
    """Batched resident greedy DPP MAP.

    V (B, D, M) float32, mask (B, M) bool.  ``window < k`` runs K2, else
    K1, laid out by ``plan`` (the policy's when None).  Returns (sel (B,
    k) int32, d_hist (B, k) float32).
    """
    d2 = init_gains(V, mask)
    if window is not None and window < k:
        return dpp_greedy_resident_windowed(V, d2, k, window, eps, plan)
    return dpp_greedy_resident(V, d2, k, eps, plan)
