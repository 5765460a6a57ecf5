"""Tiled per-step greedy DPP MAP kernels (K3 exact, K4 windowed).

CUDA counterparts of ``repro/kernels/dpp_greedy/tiled.py``'s
``_pass_full`` and ``_pass_windowed`` (``csrc/tiled.cu``), for candidate
sets past the resident budget: each greedy step is one launch over
``(ceil(M / tile_m), B)`` blocks.  Every block applies the update of the
step's winner to its tile and folds the tile's (max, lowest-index argmax)
into the next step's winner with one 64-bit ``atomicMax`` on an orderable
key (:func:`pack_key`), so the k-step loop keeps all state on the device.

No step needs anything between launches: the kernel decodes its winner
from the key and latches the eps-stop itself.  Windowed, the small
per-user state that ``repro``'s whole-slate loop resolves between
sweeps in JAX (the winner's pre-eviction column, the window factor
``C[:, win]``, the ring ids) crosses from one launch to the next
through step-parity buffers on the card, and every block derives the
eviction's Givens coefficients from them, as the fused chunk kernel K6
does; the plain version derives them with :func:`eviction_coeffs`.
So the k-step loop of :func:`dpp_greedy_tiled` issues no PyTorch op
between its launches.

The fused chunk kernels K5/K6 (``csrc/chunk.cu``, counterparts of
``_chunk_pass_full`` / ``_chunk_pass_windowed`` with their winner fold
``_reduce_argmax_and_cols``) advance a resumable streaming state
(``repro_torch.core.streaming``) by ``chunk`` steps in one cooperative
launch: :func:`fused_chunk_exact`, :func:`fused_chunk_windowed` (each a
:func:`chunk_launcher` built and called once).

The shard-local update entries of K3/K4 (:func:`tiled_update_exact`,
:func:`tiled_update_windowed`, counterparts of ``repro``'s functions of
the same names) run one step's local update on a column shard of the
candidate-sharded path (``repro_torch.core.sharded``): the winner and
its columns come from outside, after the cross-shard argmax and the
owner's broadcast, and each block folds its tile's argmax into the
shard's key; :func:`update_launcher` prepares them once a call.

Each kernel has its plain PyTorch version here; a wrapper runs it for
CPU tensors and launches the kernel for CUDA tensors, or raises.  State
(``C``, ``d2``, keys; for the chunk kernels also ``stopped`` and the
ring ids) is updated in place on both paths.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.core.greedy_chol import NEG_INF, _lowrank_rows
from repro_torch.core.windowed import greedy_step_windowed
from repro_torch.kernels import cuda
from repro_torch.kernels.dpp_greedy.dpp_greedy import (
    _cpu_or_cuda,
    eps_squared,
    init_gains,
)
from repro_torch.kernels.dpp_greedy.tiling import (
    chunk_smem_bytes,
    tiled_smem_bytes,
    update_smem_bytes,
)

_SRC = Path(__file__).resolve().parent / "csrc" / "tiled.cu"
_CHUNK_SRC = Path(__file__).resolve().parent / "csrc" / "chunk.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "tiled_set_smem": [_I, _I],
    "tiled_step_exact": [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P,
    ],
    "tiled_step_windowed": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
        _F, _I, _P,
    ],
    "tiled_update_exact": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
        _P,
    ],
    "tiled_update_windowed": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
        _I, _I, _I, _P,
    ],
}
# tiled_set_smem's kernel index of each entry (csrc/tiled.cu)
_SMEM_WHICH = {"tiled_step_exact": 0, "tiled_step_windowed": 1,
               "tiled_update_exact": 2, "tiled_update_windowed": 3}
_CHUNK_SIGNATURES = {
    "fused_chunk_capacity": [_I, _I, ctypes.POINTER(ctypes.c_int)],
    "fused_chunk_exact": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
        _I, _P,
    ],
    "fused_chunk_windowed": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _I, _I, _F, _I, _P,
    ],
}
_U32 = 2**32


# ---------------------------------------------------------------------------
# Orderable argmax keys (the int64 bits of csrc/common.cuh's u64 keys)
# ---------------------------------------------------------------------------


def pack_key(val: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(value f32, index) -> int64 holding the bits of the kernels' u64
    key ``ordered(value) << 32 | (2^32 - 1 - index)``, whose unsigned
    order is (value, then lowest index)."""
    s = val.contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(s < 0, -s - 1, s + 2**31)  # [0, 2^32)
    hi = torch.where(ordered >= 2**31, ordered - _U32, ordered)
    return hi * _U32 + (_U32 - 1 - idx.to(torch.int64))


def unpack_key(key: torch.Tensor):
    """Inverse of :func:`pack_key`: -> (value f32, index int64)."""
    hi, lo = key >> 32, key & (_U32 - 1)
    ordered = torch.where(hi < 0, hi + _U32, hi)
    s = torch.where(ordered >= 2**31, ordered - 2**31, -ordered - 1)
    return s.to(torch.int32).view(torch.float32), _U32 - 1 - lo


def _tile_maxes(d2: torch.Tensor, tile_m: int):
    """Each tile's (max, lowest-index argmax as a global index), (B, nt)
    each; the ragged last tile padded with -inf."""
    B, M = d2.shape
    nt = -(-M // tile_m)
    padded = torch.full((B, nt * tile_m), NEG_INF, dtype=d2.dtype,
                        device=d2.device)
    padded[:, :M] = d2
    tmax, targ = padded.view(B, nt, tile_m).max(dim=2)
    return tmax, targ + torch.arange(nt, device=d2.device) * tile_m


def _tile_argmax(d2: torch.Tensor, tile_m: int):
    """Per-tile (max, lowest-index argmax) folded across tiles — the
    running reduction of the Pallas sweep.  Returns (max, global index)."""
    tmax, targ = _tile_maxes(d2, tile_m)
    best = torch.argmax(tmax, dim=1)  # first maximum: the lowest tile
    ar = torch.arange(d2.shape[0], device=d2.device)
    return tmax[ar, best], targ[ar, best]


# ---------------------------------------------------------------------------
# Windowed eviction coefficients
# ---------------------------------------------------------------------------


def eviction_coeffs(Cw, cj, dj2, full, w: int):
    """Precompute the first-row Cholesky-downdate rotations from the
    small replicated state, so a tiled step can apply them per column.

    Cw:   (B, w, w) — the window factor C[:, win] (column s = window
          member s's Cholesky column); empty slots zeroed by the caller.
    cj:   (B, w) — the winner's PRE-eviction Cholesky column.
    dj2:  (B,)   — the winner's selection-time marginal gain d_j^2.
    full: (B,) bool — eviction actually happens this step.

    Returns ``(cos (B, w-1), sin (B, w-1), cj_post (B, w), d2j (B,))`` —
    identity rotations, ``cj_post = cj`` and ``d2j = dj2`` where ``full``
    is False.  Applying (cos, sin) to any column reproduces what the
    in-place rotation sweep of ``core.windowed`` computes, because the
    sweep only ever reads not-yet-rotated rows (row r+1 at iteration r).
    """
    tiny = 1e-30
    fullb = full[:, None]
    u_w = torch.where(fullb, Cw[:, 0, :], 0.0)
    u_c = torch.where(full, cj[:, 0], 0.0)
    coss, sins, cpost = [], [], []
    for r in range(w - 1):
        row_w = torch.where(fullb, Cw[:, r + 1, :], Cw[:, r, :])
        row_c = torch.where(full, cj[:, r + 1], cj[:, r])
        a = row_w[:, r + 1]
        b = u_w[:, r + 1]
        rho = torch.clamp_min(torch.sqrt(a * a + b * b), tiny)
        cos = torch.where(full, a / rho, 1.0)
        sin = torch.where(full, b / rho, 0.0)
        coss.append(cos)
        sins.append(sin)
        cpost.append(cos * row_c + sin * u_c)
        u_c = cos * u_c - sin * row_c
        u_w = cos[:, None] * u_w - sin[:, None] * row_w
    cpost.append(torch.where(full, 0.0, cj[:, w - 1]))
    empty = torch.zeros(full.shape + (0,), dtype=cj.dtype, device=cj.device)
    cos_arr = torch.stack(coss, -1) if coss else empty
    sin_arr = torch.stack(sins, -1) if sins else empty
    d2j = torch.where(full, dj2 + u_c * u_c, dj2)
    return cos_arr, sin_arr, torch.stack(cpost, -1), d2j


# ---------------------------------------------------------------------------
# K3: one exact step
# ---------------------------------------------------------------------------


def tiled_step_exact_plain(V, C, d2, keys, flags, sel, dh, t: int,
                           eps: float, tile_m: int) -> None:
    """Plain version of K3, same operands, updated in place: decode the
    winner of step ``t`` from ``keys[t]``, latch the eps-stop into
    ``flags[t + 1]``, write ``sel``/``dh[:, t]``, append Cholesky row
    ``t`` and update ``d2``, and pack the next winner into ``keys[t+1]``."""
    B = V.shape[0]
    ar = torch.arange(B, device=V.device)
    eps2 = torch.tensor(eps, dtype=torch.float32, device=V.device) ** 2
    dj2, j = unpack_key(keys[t])
    stop = (flags[t] != 0) | (dj2 <= eps2)
    dj = torch.sqrt(torch.maximum(dj2, eps2))
    sel[:, t] = torch.where(stop, -1, j).to(torch.int32)
    dh[:, t] = torch.where(stop, 0.0, dj)
    flags[t + 1] = stop.to(torch.int32)
    lj = torch.bmm(V[ar, :, j][:, None, :], V)[:, 0]
    dots = torch.bmm(C[ar, :, j][:, None, :], C)[:, 0]
    e = (lj - dots) / dj[:, None]
    live = ~stop[:, None]
    C[:, t] = torch.where(live, e, C[:, t])
    d2_next = d2 - e * e
    d2_next[ar, j] = NEG_INF
    d2.copy_(torch.where(live, d2_next, d2))
    mx, am = _tile_argmax(d2, tile_m)
    keys[t + 1] = pack_key(mx, am)


def tiled_step_exact(V, C, d2, keys, flags, sel, dh, t: int, eps: float,
                     tile_m: int) -> None:
    """K3: one launch = one exact greedy step over (ceil(M/tile_m), B)
    blocks.  V (B, D, M), C (B, k, M), d2 (B, M) f32; keys (k+1, B) int64
    (row t+1 zero), flags (k+1, B) int32; sel (B, k) int32, dh (B, k)."""
    if not _cpu_or_cuda(V):
        return tiled_step_exact_plain(V, C, d2, keys, flags, sel, dh, t, eps,
                                      tile_m)
    _check_step(t, sel)
    step_launcher("tiled_step_exact", (V, C, d2, keys, flags, sel, dh), eps,
                  tile_m)(t)


# ---------------------------------------------------------------------------
# K4: one windowed step
# ---------------------------------------------------------------------------


def tiled_step_windowed_plain(V, C, d2, keys, flags, sel, dh, win, cand,
                              wcol, t: int, eps: float, tile_m: int) -> None:
    """Plain version of K4, same operands, updated in place.  Decode the
    winner of step ``t`` from ``keys[t]`` and latch the eps-stop as K3
    does; take its pre-eviction column from its tile's ``cand[p]`` and
    the window factor from ``wcol[p]`` (``p = t % 2``), derive the
    rotations with :func:`eviction_coeffs`; then the Pallas
    ``_tile_update_windowed`` over the whole candidate axis: evict with
    the rotations (the residue repairs d2), append against the
    post-eviction ring; pack the next winner into ``keys[t + 1]`` and
    publish parity ``1 - p``: the ring ids, each tile's argmax column and
    the window factor after the step."""
    B, w, _ = C.shape
    ar = torch.arange(B, device=V.device)
    eps2 = torch.tensor(eps, dtype=torch.float32, device=V.device) ** 2
    p = t % 2
    dj2, j = unpack_key(keys[t])
    stop = (flags[t] != 0) | (dj2 <= eps2)
    sel[:, t] = torch.where(stop, -1, j).to(torch.int32)
    dh[:, t] = torch.where(stop, 0.0, torch.sqrt(torch.maximum(dj2, eps2)))
    flags[t + 1] = stop.to(torch.int32)
    ring = win[p].to(torch.int64)
    full = (t >= w) & ~stop
    pos = min(t, w - 1)
    cj_pre = cand[p, ar, j // tile_m]
    Cw = torch.where((ring >= 0)[:, None, :], wcol[p], 0.0)
    cos, sin, cjp, d2j = eviction_coeffs(Cw, cj_pre, dj2, full, w)
    djp = torch.sqrt(torch.maximum(d2j, eps2))

    fc = full[:, None]
    u = torch.where(fc, C[:, 0], 0.0)
    rows = []
    for r in range(w - 1):
        row = torch.where(fc, C[:, r + 1], C[:, r])
        rows.append(cos[:, r:r + 1] * row + sin[:, r:r + 1] * u)
        u = cos[:, r:r + 1] * u - sin[:, r:r + 1] * row
    rows.append(torch.where(fc, 0.0, C[:, w - 1]))
    Cpost = torch.stack(rows, 1)
    d2e = torch.where(fc, d2 + u * u, d2)
    lj = torch.bmm(V[ar, :, j][:, None, :], V)[:, 0]
    dots = torch.bmm(cjp[:, None, :], Cpost)[:, 0]
    e = (lj - dots) / djp[:, None]
    Cpost[:, pos] = e
    live = ~stop
    C.copy_(torch.where(live[:, None, None], Cpost, C))
    d2_next = d2e - e * e
    d2_next[ar, j] = NEG_INF
    d2.copy_(torch.where(live[:, None], d2_next, d2))
    tmax, tile_am = _tile_maxes(d2, tile_m)
    best = torch.argmax(tmax, dim=1)
    keys[t + 1] = pack_key(tmax[ar, best], tile_am[ar, best])

    shifted = torch.roll(ring, -1, dims=1)
    shifted[:, w - 1] = -1
    ring_next = torch.where(fc, shifted, ring)
    ring_next[:, pos] = j
    ring_next = torch.where(live[:, None], ring_next, ring)
    win[1 - p] = ring_next.to(torch.int32)
    nt = tile_am.shape[1]
    cols = C.gather(2, tile_am[:, None, :].expand(B, w, nt)).transpose(1, 2)
    cand[1 - p] = torch.where(live[:, None, None], cols, cand[1 - p])
    member = C.gather(2, ring_next.clamp_min(0)[:, None, :].expand(B, w, w))
    keep = live[:, None, None] & (ring_next >= 0)[:, None, :]
    wcol[1 - p] = torch.where(keep, member, wcol[1 - p])


def tiled_step_windowed(V, C, d2, keys, flags, sel, dh, win, cand, wcol,
                        t: int, eps: float, tile_m: int) -> None:
    """K4: one launch = one windowed greedy step over
    (ceil(M/tile_m), B) blocks, with its per-user state on the card.
    V (B, D, M), C (B, w, M) ring, d2 (B, M) f32; keys (k+1, B) int64
    (row t+1 zero), flags (k+1, B) int32; sel (B, k) int32, dh (B, k);
    the step-parity buffers win (2, B, w) int32, cand (2, B, nt, w) and
    wcol (2, B, w, w) f32 (parity 0: ids -1, zeros before step 0)."""
    if not _cpu_or_cuda(V):
        return tiled_step_windowed_plain(V, C, d2, keys, flags, sel, dh, win,
                                         cand, wcol, t, eps, tile_m)
    _check_step(t, sel)
    step_launcher("tiled_step_windowed",
                  (V, C, d2, keys, flags, sel, dh, win, cand, wcol), eps,
                  tile_m)(t)


# ---------------------------------------------------------------------------
# The per-step launcher of the whole-slate loop (K3 / K4)
# ---------------------------------------------------------------------------


def _check_step(t: int, sel) -> None:
    k = sel.shape[1]
    if not 0 <= t < k:
        raise ValueError(f"step t={t} outside [0, {k})")


def _require_step(windowed: bool, V, C, d2, keys, flags, sel, dh,
                  *ring, tile_m: int) -> None:
    B, D, M = V.shape
    k = sel.shape[1]
    rows = C.shape[1] if windowed else k
    cuda.require(V, "V", torch.float32, (B, D, M))
    cuda.require(C, "C", torch.float32, (B, rows, M))
    cuda.require(d2, "d2", torch.float32, (B, M))
    cuda.require(keys, "keys", torch.int64, (k + 1, B))
    cuda.require(flags, "flags", torch.int32, (k + 1, B))
    cuda.require(sel, "sel", torch.int32, (B, k))
    cuda.require(dh, "dh", torch.float32, (B, k))
    if not windowed:
        return
    win, cand, wcol = ring
    nt = -(-M // tile_m)
    cuda.require(win, "win", torch.int32, (2, B, rows))
    cuda.require(cand, "cand", torch.float32, (2, B, nt, rows))
    cuda.require(wcol, "wcol", torch.float32, (2, B, rows, rows))


def step_launcher(kernel: str, operands: tuple, eps: float, tile_m: int):
    """``step(t)``: one step of :func:`dpp_greedy_tiled`'s loop, K3
    (``kernel="tiled_step_exact"``) or K4 (``"tiled_step_windowed"``) on
    ``operands``, the kernel wrapper's tensor arguments before ``t``.

    For CUDA tensors the operands are checked, the pointers, ``eps**2``,
    shared-memory size and stream worked out, and the kernel's
    shared-memory limit raised here, once, so a step is one ctypes call
    and its launch count; for CPU tensors each step calls the kernel's
    wrapper, which runs the plain version."""
    V = operands[0]
    if not _cpu_or_cuda(V):
        wrapper = globals()[kernel]
        return lambda t: wrapper(*operands, t, eps, tile_m)
    windowed = kernel == "tiled_step_windowed"
    _require_step(windowed, *operands, tile_m=tile_m)
    B, D, M = V.shape
    rows, k = operands[1].shape[1], operands[5].shape[1]
    smem = tiled_smem_bytes(D, rows, windowed)
    lib = cuda.library(_SRC, _SIGNATURES)
    cuda.raise_smem(lib, "tiled_set_smem", _SMEM_WHICH[kernel], smem,
                    V.device)
    fn = getattr(lib, kernel)
    head = tuple(x.data_ptr() for x in operands) + (
        (B, D, M, rows, k) if windowed else (B, D, M, k))
    tail = (tile_m, eps_squared(eps), smem, cuda.stream_ptr(V))
    count = cuda.count_launch

    def step(t: int) -> None:
        err = fn(*head, t, *tail)
        count(kernel)
        if err:
            cuda.check(err, kernel)

    return step


# ---------------------------------------------------------------------------
# The shard-local update entries of K3 / K4 (repro_torch.core.sharded)
# ---------------------------------------------------------------------------


def _umax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The larger of two keys in the kernels' unsigned order (the int64
    tensors hold u64 bits): the plain version of ``atomicMax``."""
    flip = -2**63
    return torch.where((a ^ flip) >= (b ^ flip), a, b)


def _pack_shard_argmax(d2, base: int, tile_m: int, keys, t) -> None:
    """Fold each lane's shard argmax into its key row ``(t + 1) & 1`` (an
    unsigned max, as the entries' ``atomicMax``) and zero the row
    ``t & 1`` that its step read, as the entries do."""
    mx, am = _tile_argmax(d2, tile_m)
    ar = torch.arange(d2.shape[0], device=d2.device)
    row = (t & 1).to(torch.int64)
    keys[row, ar] = 0
    keys[1 - row, ar] = _umax(keys[1 - row, ar], pack_key(mx, am + base))


def _lane_groups(x: torch.Tensor):
    """``(value, lanes)`` for each distinct value of the per-lane ``x``:
    ``lanes`` a slice of every lane when they all share it (the whole
    slate and the stream), else their indices."""
    vals = torch.unique(x).tolist()
    if len(vals) == 1:
        return [(vals[0], slice(None))]
    return [(v, torch.nonzero(x == v)[:, 0]) for v in vals]


def _prefix_dots(c, C, n):
    """``c[b, :n_b] @ C[b, :n_b]`` for every lane, ``n (B,)`` per lane:
    one ``bmm`` over the lanes that share a prefix length."""
    out = torch.empty((C.shape[0], C.shape[2]), dtype=C.dtype,
                      device=C.device)
    for v, lanes in _lane_groups(n):
        out[lanes] = torch.bmm(c[lanes, None, :v], C[lanes, :v])[:, 0]
    return out


def tiled_update_exact_plain(Vl, C, d2, vj, cj, dj, stopped, j, t,
                             base: int, keys, tile_m: int) -> None:
    """Plain version of the exact update entry, same operands, updated in
    place: on the column shard ``Vl`` whose first column is global id
    ``base``, append Cholesky row ``t[b]`` of each lane for its winner
    ``j`` (global ids) from the broadcast columns ``vj`` / ``cj`` (rows
    below ``t[b]``) and sqrt gain ``dj``, update ``d2`` (the owner masks
    ``j`` to -inf), leave stopped lanes and lanes at ``t[b] >= k`` as
    they are, and fold the shard's (max, lowest global index) into the
    lane's key row ``(t + 1) & 1``, zeroing row ``t & 1``."""
    B, k, M = C.shape
    ar = torch.arange(B, device=Vl.device)
    t = t.to(torch.int64)
    lj = torch.bmm(vj[:, None, :], Vl)[:, 0]
    dots = _prefix_dots(cj, C, t.clamp_max(k))
    e = (lj - dots) / dj[:, None]
    live = ~stopped & (t < k)
    row = t.clamp_max(k - 1)
    C[ar, row] = torch.where(live[:, None], e, C[ar, row])
    gid = torch.arange(M, device=Vl.device) + base
    d2_next = torch.where(gid == j.to(torch.int64)[:, None], NEG_INF,
                          d2 - e * e)
    d2.copy_(torch.where(live[:, None], d2_next, d2))
    _pack_shard_argmax(d2, base, tile_m, keys, t)


def tiled_update_exact(Vl, C, d2, vj, cj, dj, stopped, j, t, base: int,
                       keys, tile_m: int) -> None:
    """The exact update entry: one launch = the local update of one greedy
    step on a column shard, over ``(ceil(Mloc / tile_m), B)`` blocks.  The
    counterpart of ``repro``'s ``tiled_update_exact``, with a leading
    lane axis and a step counter a lane: Vl (B, D, Mloc), C (B, k, Mloc),
    d2 (B, Mloc) f32; the winner's columns vj (B, D), cj (B, k) (rows
    below ``t[b]`` read), dj (B,) f32; stopped (B,) bool; j (B,) int32
    global winner ids; t (B,) int32 step counters (lane b appends row
    ``t[b]``; a lane at ``t[b] >= k`` is stopped); ``base`` the shard's
    first global id; keys (2, B) int64, the two key rows of each lane
    used in turn (row ``(t + 1) & 1`` zero).  C, d2 and keys are updated
    in place."""
    if not _cpu_or_cuda(Vl):
        return tiled_update_exact_plain(Vl, C, d2, vj, cj, dj, stopped, j, t,
                                        base, keys, tile_m)
    update_launcher((Vl, C, d2, vj, cj, dj, stopped, j, t), base, keys,
                    tile_m)()


def tiled_update_windowed_plain(Vl, C, d2, vj, cjp, djp, stopped, full, cos,
                                sin, j, t, base: int, keys,
                                tile_m: int) -> None:
    """Plain version of the windowed update entry, same operands, updated
    in place: where ``full``, evict the ring's oldest row with the Givens
    pairs ``(cos, sin)`` (from :func:`eviction_coeffs`; the residue
    repairs d2), then append the winner ``j``'s row against the
    post-eviction ring at row ``pos = min(t[b], w - 1)`` from its
    broadcast ``vj``, its post-eviction column ``cjp`` and repaired sqrt
    gain ``djp``; stopped lanes stay as they are; fold the shard's
    argmax into the keys as the exact entry does."""
    B, w, M = C.shape
    ar = torch.arange(B, device=Vl.device)
    pos = t.to(torch.int64).clamp_max(w - 1)
    fc = full[:, None]
    u = torch.where(fc, C[:, 0], 0.0)
    rows = []
    for r in range(w - 1):
        row = torch.where(fc, C[:, r + 1], C[:, r])
        rows.append(cos[:, r:r + 1] * row + sin[:, r:r + 1] * u)
        u = cos[:, r:r + 1] * u - sin[:, r:r + 1] * row
    rows.append(torch.where(fc, 0.0, C[:, w - 1]))
    Cpost = torch.stack(rows, 1)
    d2e = torch.where(fc, d2 + u * u, d2)
    lj = torch.bmm(vj[:, None, :], Vl)[:, 0]
    dots = _prefix_dots(cjp, Cpost, pos)
    e = (lj - dots) / djp[:, None]
    Cpost[ar, pos] = e
    live = ~stopped
    C.copy_(torch.where(live[:, None, None], Cpost, C))
    gid = torch.arange(M, device=Vl.device) + base
    d2_next = torch.where(gid == j.to(torch.int64)[:, None], NEG_INF,
                          d2e - e * e)
    d2.copy_(torch.where(live[:, None], d2_next, d2))
    _pack_shard_argmax(d2, base, tile_m, keys, t)


def tiled_update_windowed(Vl, C, d2, vj, cjp, djp, stopped, full, cos, sin,
                          j, t, base: int, keys, tile_m: int) -> None:
    """The windowed update entry: one launch = the local evict + append of
    one greedy step on a column shard.  The counterpart of ``repro``'s
    ``tiled_update_windowed``, with a leading lane axis: C (B, w, Mloc)
    ring; cjp (B, w) the winner's post-eviction column, djp (B,) its
    repaired sqrt gain; full (B,) bool (evict this step); cos, sin
    (B, w - 1) the Givens pairs; lane b appends at ring row
    ``min(t[b], w - 1)``; the rest as :func:`tiled_update_exact`."""
    if not _cpu_or_cuda(Vl):
        return tiled_update_windowed_plain(Vl, C, d2, vj, cjp, djp, stopped,
                                           full, cos, sin, j, t, base, keys,
                                           tile_m)
    update_launcher((Vl, C, d2, vj, cjp, djp, stopped, full, cos, sin, j, t),
                    base, keys, tile_m)()


def _require_update(operands, keys) -> None:
    windowed = len(operands) == 12
    Vl, C, d2, vj, cj, dj, stopped = operands[:7]
    B, D, M = Vl.shape
    rows = C.shape[1]
    cuda.require(Vl, "Vl", torch.float32, (B, D, M))
    cuda.require(C, "C", torch.float32, (B, rows, M))
    cuda.require(d2, "d2", torch.float32, (B, M))
    cuda.require(vj, "vj", torch.float32, (B, D))
    cuda.require(cj, "cjp" if windowed else "cj", torch.float32, (B, rows))
    cuda.require(dj, "djp" if windowed else "dj", torch.float32, (B,))
    cuda.require(stopped, "stopped", torch.bool, (B,))
    cuda.require(operands[-2], "j", torch.int32, (B,))
    cuda.require(operands[-1], "t", torch.int32, (B,))
    cuda.require(keys, "keys", torch.int64, (2, B))
    if windowed:
        full, cos, sin = operands[7:10]
        cuda.require(full, "full", torch.bool, (B,))
        cuda.require(cos, "cos", torch.float32, (B, rows - 1))
        cuda.require(sin, "sin", torch.float32, (B, rows - 1))


def update_launcher(operands: tuple, base: int, keys, tile_m: int):
    """``step()``: the update entry of one greedy step on a column shard,
    exact (``operands = (Vl, C, d2, vj, cj, dj, stopped, j, t)``) or
    windowed (``(Vl, C, d2, vj, cjp, djp, stopped, full, cos, sin, j,
    t)``), folding into ``keys (2, B)``.

    The caller refills the winner's buffers and advances the step
    counters ``t`` in place between steps, so for CUDA tensors the
    operands are checked, the pointers, the shared-memory size and
    stream worked out and the kernel's shared-memory limit raised here,
    once (as :func:`step_launcher` does for K3 / K4): a step is one
    ctypes call and its launch count.  For CPU tensors each step runs
    the entry's plain version."""
    windowed = len(operands) == 12
    kernel = "tiled_update_windowed" if windowed else "tiled_update_exact"
    Vl = operands[0]
    if not _cpu_or_cuda(Vl):
        plain = (tiled_update_windowed_plain if windowed
                 else tiled_update_exact_plain)
        return lambda: plain(*operands, base, keys, tile_m)
    _require_update(operands, keys)
    B, D, M = Vl.shape
    rows = operands[1].shape[1]
    smem = update_smem_bytes(D, rows, windowed)
    lib = cuda.library(_SRC, _SIGNATURES)
    cuda.raise_smem(lib, "tiled_set_smem", _SMEM_WHICH[kernel], smem,
                    Vl.device)
    fn = getattr(lib, kernel)
    args = tuple(x.data_ptr() for x in operands + (keys,)) + (
        B, D, M, rows, base, tile_m, smem)
    count = cuda.count_launch

    def step(_operands=operands) -> None:  # the pointers' tensors live on
        err = fn(*args, cuda.stream_ptr(Vl))
        count(kernel)
        if err:
            cuda.check(err, kernel)

    return step


# ---------------------------------------------------------------------------
# K5 / K6: fused multi-step chunks of a resumable state
# ---------------------------------------------------------------------------


def fused_chunk_exact_plain(V, C, d2, t, stopped, chunk: int, eps: float):
    """Plain version of K5, same operands: ``chunk`` exact steps from
    the per-lane step counters ``t``, updating ``C``, ``d2`` and
    ``stopped`` in place.  A lane whose counter reaches the state's
    capacity ``R`` latches stopped.  Returns (sel, dh) (B, chunk)."""
    B, D, M = V.shape
    R = C.shape[1]
    ar = torch.arange(B, device=V.device)
    eps2 = torch.tensor(eps, dtype=torch.float32, device=V.device) ** 2
    t = t.to(torch.int64)
    sel = torch.empty((B, chunk), dtype=torch.int32, device=V.device)
    dh = torch.empty((B, chunk), dtype=torch.float32, device=V.device)
    for s in range(chunk):
        ts = t + s
        j = torch.argmax(d2, dim=1)
        dj2 = d2[ar, j]
        stopped |= (dj2 <= eps2) | (ts >= R)
        dj = torch.sqrt(torch.maximum(dj2, eps2))
        sel[:, s] = torch.where(stopped, -1, j).to(torch.int32)
        dh[:, s] = torch.where(stopped, 0.0, dj)
        lj = torch.bmm(V[ar, :, j][:, None, :], V)[:, 0]
        dots = torch.bmm(C[ar, :, j][:, None, :], C)[:, 0]
        e = (lj - dots) / dj[:, None]
        live = ~stopped[:, None]
        row = ts.clamp_max(R - 1)
        C[ar, row] = torch.where(live, e, C[ar, row])
        d2_next = d2 - e * e
        d2_next[ar, j] = NEG_INF
        d2.copy_(torch.where(live, d2_next, d2))
    return sel, dh


def fused_chunk_windowed_plain(V, C, d2, t, stopped, win, chunk: int,
                               eps: float):
    """Plain version of K6, same operands: ``chunk`` sliding-window steps
    (``repro_torch.core.windowed.greedy_step_windowed`` on the (B, w, M)
    ring, per-lane ``t``), updating ``C``, ``d2``, ``stopped`` and the
    ring ids ``win`` in place.  Returns (sel, dh) (B, chunk)."""
    B, D, M = V.shape
    w = C.shape[1]
    dev = V.device
    eps2 = torch.tensor(eps, dtype=torch.float32, device=dev) ** 2
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=dev)
    row_fn = _lowrank_rows(V)
    t = t.to(torch.int64)
    Cs, d2s, wins, st = C, d2, win.to(torch.int64), stopped
    sel = torch.empty((B, chunk), dtype=torch.int32, device=dev)
    dh = torch.empty((B, chunk), dtype=torch.float32, device=dev)
    for s in range(chunk):
        Cs, d2s, wins, st, j, dj = greedy_step_windowed(
            row_fn, t + s, Cs, d2s, wins, st, w=w, eps2=eps2, tiny=tiny
        )
        sel[:, s] = torch.where(st, -1, j).to(torch.int32)
        dh[:, s] = torch.where(st, 0.0, dj)
    C.copy_(Cs)
    d2.copy_(d2s)
    win.copy_(wins)
    stopped.copy_(st)
    return sel, dh


@functools.lru_cache(maxsize=None)
def _capacity(windowed: bool, smem: int, index: int) -> int:
    with torch.cuda.device(index):
        lib = cuda.library(_CHUNK_SRC, _CHUNK_SIGNATURES)
        n = ctypes.c_int(0)
        cuda.check(lib.fused_chunk_capacity(int(windowed), smem,
                                            ctypes.byref(n)),
                   "fused_chunk_capacity")
    return n.value


def chunk_capacity(windowed: bool, smem: int, device) -> int:
    """Blocks of K5 (or K6) that ``device`` keeps co-resident at ``smem``
    bytes of shared memory per block — the most one cooperative launch
    may hold (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` x SMs,
    queried once per card and size)."""
    device = torch.device(device)
    index = device.index
    return _capacity(bool(windowed), int(smem),
                     torch.cuda.current_device() if index is None else index)


# cudaErrorCooperativeLaunchTooLarge: the grid cannot all be co-resident
_COOPERATIVE_TOO_LARGE = 720


def _check_cooperative(err: int, name: str, B: int, M: int,
                       tile_m: int) -> None:
    if err == _COOPERATIVE_TOO_LARGE:
        raise ValueError(
            f"{name}: the grid of {B * -(-M // tile_m)} blocks ({B} lanes x "
            f"tiles of {tile_m} columns) cannot be co-resident for one "
            f"cooperative launch; size the tile with TilePolicy.decide(..., "
            f"chunked=True, capacity=chunk_capacity)"
        )
    cuda.check(err, name)


def _chunk_operands(V, C, d2, t, stopped, R):
    B, D, M = V.shape
    cuda.require(V, "V", torch.float32, (B, D, M))
    cuda.require(C, "C", torch.float32, (B, R, M))
    cuda.require(d2, "d2", torch.float32, (B, M))
    cuda.require(t, "t", torch.int32, (B,))
    cuda.require(stopped, "stopped", torch.bool, (B,))


def chunk_launcher(V, C, d2, t, stopped, win, chunk: int, eps: float,
                   tile_m: int, v_resident: bool = False):
    """``launch()``: one K5 (``win`` None) or K6 launch of ``chunk`` steps
    on these operands, returning ``(sel, dh)`` (B, chunk) — the same two
    tensors every call, overwritten, so read them before the next.  The
    operands are checked, the scratch allocated and the launch arguments
    packed here, once (:func:`step_launcher` prepares K3/K4 so), and a
    launch is one zeroing of the argmax keys and lane barriers and one
    ctypes call, on the stream current at the launch.  Each launch
    updates C, d2, stopped (and win) in place; ``t`` is read, never
    advanced.  For CPU tensors each launch runs the kernel's plain
    version."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    windowed = win is not None
    if not _cpu_or_cuda(V):
        if windowed:
            return lambda: fused_chunk_windowed_plain(V, C, d2, t, stopped,
                                                      win, chunk, eps)
        return lambda: fused_chunk_exact_plain(V, C, d2, t, stopped, chunk,
                                               eps)
    B, D, M = V.shape
    R = C.shape[1]
    _chunk_operands(V, C, d2, t, stopped, R)
    dev = V.device
    # the per-step argmax keys (chunk+1, B) and, behind them, one barrier
    # counter per lane (64 bits each, the kernels count in the low 32)
    scratch = torch.empty(((chunk + 1) * B + B,), dtype=torch.int64,
                          device=dev)
    sel = torch.empty((B, chunk), dtype=torch.int32, device=dev)
    dh = torch.empty((B, chunk), dtype=torch.float32, device=dev)
    ptrs = [V, C, d2, t, stopped]
    if windowed:
        cuda.require(win, "win", torch.int32, (B, R))
        nt = -(-M // tile_m)
        ptrs += [win, scratch, scratch[(chunk + 1) * B:],
                 torch.empty((2, B, nt, R), dtype=torch.float32, device=dev),
                 torch.empty((2, B, R, R), dtype=torch.float32, device=dev)]
        name = "fused_chunk_windowed"
    else:
        ptrs += [scratch, scratch[(chunk + 1) * B:]]
        name = "fused_chunk_exact"
    ptrs += [sel, dh]
    smem = chunk_smem_bytes(D, tile_m, R, windowed, v_resident)
    fn = getattr(cuda.library(_CHUNK_SRC, _CHUNK_SIGNATURES), name)
    args = tuple(x.data_ptr() for x in ptrs) + (
        B, D, M, R, chunk, tile_m, int(v_resident), eps_squared(eps), smem)
    count, stream = cuda.count_launch, cuda.stream_ptr

    def launch(_operands=ptrs):  # the pointers' tensors live with it
        scratch.zero_()
        # the stream current at this launch, as the zeroing's and the
        # caller's copies: a launcher outlives a stream switch
        err = fn(*args, stream(V))
        count(name)
        _check_cooperative(err, name, B, M, tile_m)
        return sel, dh

    return launch


def fused_chunk_exact(V, C, d2, t, stopped, chunk: int, eps: float,
                      tile_m: int, v_resident: bool = False):
    """K5: one cooperative launch = ``chunk`` exact greedy steps over
    ``(ceil(M / tile_m), B)`` blocks.  V (B, D, M), C (B, R, M), d2 (B, M)
    f32; t (B,) int32 step counters; stopped (B,) bool.  C, d2 and
    stopped are updated in place; returns (sel (B, chunk) int32,
    dh (B, chunk) f32).  Each block keeps its tile's gains in shared
    memory for the chunk, and its slice of V too when ``v_resident``
    (the tile policy's answer, ``TilePolicy.decide(..., chunked=True)``)."""
    return chunk_launcher(V, C, d2, t, stopped, None, chunk, eps, tile_m,
                          v_resident)()


def fused_chunk_windowed(V, C, d2, t, stopped, win, chunk: int, eps: float,
                         tile_m: int, v_resident: bool = False):
    """K6: one cooperative launch = ``chunk`` sliding-window steps.
    C (B, w, M) ring, win (B, w) int32 ring ids (oldest first, -1 empty);
    the rest as :func:`fused_chunk_exact`.  C, d2, stopped and win are
    updated in place; returns (sel, dh) (B, chunk).  Each block keeps
    its slice of the ring in shared memory for the chunk, and its slice
    of V too when ``v_resident`` (the tile policy's answer,
    ``TilePolicy.decide(..., chunked=True)``)."""
    return chunk_launcher(V, C, d2, t, stopped, win, chunk, eps, tile_m,
                          v_resident)()


# ---------------------------------------------------------------------------
# Whole-slate loop
# ---------------------------------------------------------------------------


def dpp_greedy_tiled(V, mask, k: int, window=None, eps: float = 1e-3,
                     tile_m: int = 1024):
    """Batched greedy DPP MAP with the candidate axis swept in tiles.

    V (B, D, M) float32 (any M: the kernels mask the ragged last tile),
    mask (B, M) bool.  Returns (sel (B, k) int32, d_hist (B, k) f32).
    One K3/K4 launch per step, with every buffer allocated and every
    operand checked up front (:func:`step_launcher`): no PyTorch op runs
    between the launches and nothing is read back to the host.
    """
    B, D, M = V.shape
    dev = V.device
    w = window if (window is not None and window < k) else None
    ar = torch.arange(B, device=dev)
    d2 = init_gains(V, mask)
    C = torch.zeros((B, k if w is None else w, M), dtype=torch.float32,
                    device=dev)
    keys = torch.zeros((k + 1, B), dtype=torch.int64, device=dev)
    j0 = torch.argmax(d2, dim=1)
    keys[0] = pack_key(d2[ar, j0], j0)
    flags = torch.zeros((k + 1, B), dtype=torch.int32, device=dev)
    sel = torch.empty((B, k), dtype=torch.int32, device=dev)
    dh = torch.empty((B, k), dtype=torch.float32, device=dev)
    if w is None:
        step = step_launcher("tiled_step_exact",
                             (V, C, d2, keys, flags, sel, dh), eps, tile_m)
    else:
        nt = -(-M // tile_m)
        win = torch.full((2, B, w), -1, dtype=torch.int32, device=dev)
        cand = torch.zeros((2, B, nt, w), dtype=torch.float32, device=dev)
        wcol = torch.zeros((2, B, w, w), dtype=torch.float32, device=dev)
        step = step_launcher(
            "tiled_step_windowed",
            (V, C, d2, keys, flags, sel, dh, win, cand, wcol), eps, tile_m)
    for t in range(k):
        step(t)
    return sel, dh
