"""Public wrapper for the dpp_greedy CUDA kernels.

Kernel-first dispatch (``TilePolicy``): while one user's gains and the
winner's staged columns fit a thread block's shared memory, the resident
whole-slate kernels in ``dpp_greedy.py`` run (the entire greedy loop in
one launch, each user on a thread-block cluster laid out by
``tiling.resident_cluster``); past the budget, or with an explicit
``tile_m``, the tiled per-step kernels in ``tiled.py`` run (one launch
per greedy step).  The
plain reference is reachable only through ``force_ref=True``.

The tile comes from one precedence ladder (:func:`_resolve_tile_policy`):
the ``DPP_TILE_M`` process override (a warp multiple or ``auto``) >
an explicit ``tile_m=`` > ``tile_m="auto"`` (the measured autotune
cache, ``autotune.lookup_tile``, with the model as its fallback) > the
on-chip budget model; a ``tile_policy=`` object bypasses the ladder and
the override (the autotune sweep passes one, so the environment it tunes
cannot steer what it measures).

The ``dpp_greedy_stream_*`` functions run resumable streaming states
(``repro_torch.core.streaming``) through the fused chunk kernels K5/K6
in ``tiled.py``: one cooperative launch per chunk, its tile sized by
``TilePolicy.decide(..., chunked=True)``; ``dpp_greedy_stream_launcher``
prepares such a launch once for a caller that repeats it on one state.

On CPU tensors every mode runs its kernels' plain PyTorch versions; on
CUDA tensors it launches the kernels or raises.  Inputs are upcast to
float32; there is no padding of ``D`` or ``M``.
"""
from __future__ import annotations

import functools
import os
from typing import Optional

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels.dpp_greedy.dpp_greedy import (
    cluster_plan,
    dpp_greedy_kernel,
    init_gains,
)
from repro_torch.kernels.dpp_greedy.ref import dpp_greedy_ref
from repro_torch.kernels.dpp_greedy.tiled import (
    capacity_fn,
    chunk_launcher,
    dpp_greedy_tiled,
    fused_chunk_exact,
    fused_chunk_windowed,
)
from repro_torch.kernels.dpp_greedy.tiling import (
    TileM,
    TilePolicy,
    chunk_smem_bytes,
    cluster_smem_bytes,
    tiled_smem_bytes,
    validate_tile_m,
)
from repro_torch.obs.dispatch import (
    record_kernel_dispatch,
    record_tile_override,
    record_tile_resolution,
)


def _env_tile_m() -> TileM:
    """Parse the ``DPP_TILE_M`` process override: unset or empty -> None,
    ``auto`` -> the autotune ladder, anything else an explicit warp
    multiple.  Invalid values raise: a mistyped fleet-wide override must
    fail loudly, not fall back to the model."""
    raw = os.environ.get("DPP_TILE_M", "").strip()
    if not raw:
        return None
    if raw.lower() == "auto":
        return "auto"
    try:
        tm = int(raw)
    except ValueError:
        raise ValueError(
            f'DPP_TILE_M must be an integer warp multiple or "auto", got '
            f"{raw!r}"
        ) from None
    validate_tile_m(tm)
    return tm


def _resolve_tile_policy(tile_m: TileM,
                         tile_policy: Optional[TilePolicy]) -> TilePolicy:
    """The tile_m precedence ladder, applied once per dispatch:

        DPP_TILE_M env > explicit ``tile_m=`` > ``"auto"`` cache > model

    (the cache-vs-model rungs resolve inside ``TilePolicy.decide``).  An
    explicit ``tile_policy=`` object bypasses the env override.  A
    request that loses to the env is recorded
    (``dpp_tile_override_total``), not silently ignored."""
    if tile_m is not None and tile_policy is not None:
        raise ValueError("pass at most one of tile_m= or tile_policy=")
    if tile_policy is not None:
        record_tile_resolution("policy")
        return tile_policy
    env = _env_tile_m()
    if env is not None:
        if tile_m is not None and env != tile_m:
            record_tile_override(
                winner="env",
                lost="auto" if tile_m == "auto" else "explicit",
            )
        record_tile_resolution("env")
        return TilePolicy(tile_m=env)
    if tile_m == "auto":
        record_tile_resolution("auto")
    elif tile_m is not None:
        record_tile_resolution("explicit")
    else:
        record_tile_resolution("model")
    return TilePolicy(tile_m=tile_m)


def dpp_greedy(
    V: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    eps: float = 1e-3,
    force_ref: bool = False,
    window: Optional[int] = None,
    tile_m: TileM = None,
    tile_policy: Optional[TilePolicy] = None,
):
    """Batched greedy DPP MAP inference.

    V (B, D, M) scaled features, mask (B, M). Returns (sel, d_hist) with
    shape (B, k); sel slots after an eps-stop hold -1.  ``window=w``
    enforces diversity only against the last w picks (O(w M) state,
    unbounded k); ``window >= k`` or None is the exact Algorithm 1.
    ``tile_m`` (or a whole ``tile_policy``) forces the tiled kernels with
    that candidate-axis tile; ``tile_m="auto"`` keeps the resident
    kernels while they fit and takes the tile past that from the
    measured autotune cache (the model's tile on a miss); ``DPP_TILE_M``
    overrides ``tile_m`` process-wide (see the module docstring).
    """
    B, D, M = V.shape
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    validate_tile_m(tile_m, allow_auto=True)
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

    policy = _resolve_tile_policy(tile_m, tile_policy)
    mode, tm = policy.decide(D, M, state_rows, windowed, lanes=B,
                             device=V.device)
    if mode == "resident":
        # the cluster layout: decided once per shape and card, passed on
        plan = cluster_plan(D, M, state_rows, windowed, B, V.device)
        record_kernel_dispatch(
            mode, D=D, M=M, state_rows=state_rows, windowed=windowed,
            smem_bytes=cluster_smem_bytes(D, M, state_rows, windowed, *plan),
            v_resident=plan.v_resident,
        )
        return dpp_greedy_kernel(V, mask, k, window=window, eps=eps,
                                 plan=plan)
    record_kernel_dispatch(
        mode, D=D, M=M, state_rows=state_rows, windowed=windowed, tile_m=tm,
        smem_bytes=tiled_smem_bytes(D, state_rows, windowed),
    )
    return dpp_greedy_tiled(V, mask, k, window=window, eps=eps, tile_m=tm)


# ---------------------------------------------------------------------------
# Resumable streaming execution (chunk-emitting; repro_torch.core.streaming)
# ---------------------------------------------------------------------------


# the tile "auto" resolved for each kernel streaming state, keyed on its
# C tensor (every chunk of the state carries the same one, and the entry
# goes with it)
_STATE_TILES = WeakIdKeyDictionary()


def resolve_chunk_tile(D: int, M: int, state_rows: int, windowed: bool,
                       lanes: int, capacity, device: torch.device,
                       tile_m: TileM = None, *,
                       tile_policy: Optional[TilePolicy] = None,
                       state=None) -> Optional[int]:
    """The ``tile_m`` a fused chunk launch (K5 / K6) of ``lanes`` lanes
    at this shape runs under: the precedence ladder
    (:func:`_resolve_tile_policy`) applied and ``"auto"`` looked up at
    ``lanes`` and ``capacity`` (``smem bytes -> blocks``, None: no
    limit) on ``device``; an explicit tile, or None for the model.  The
    chunk launches and the router's co-residency check
    (``serving.router.check_slots``) both resolve the knob here.  Given
    a kernel streaming ``state``, an ``"auto"`` answer is kept for it at
    its first resolution (its init's), and its chunks and launchers
    reuse it: no lookup and no file read after that."""
    policy = _resolve_tile_policy(tile_m, tile_policy)
    if policy.tile_m != "auto":
        return policy.tile_m
    if state is not None and state.C in _STATE_TILES:
        return _STATE_TILES[state.C]
    tm = policy.resolve(D, M, state_rows, windowed, chunked=True,
                        lanes=lanes, capacity=capacity, device=device)
    if state is not None:
        _STATE_TILES[state.C] = tm
    return tm


def _stream_tile(D: int, M: int, state_rows: int, windowed: bool,
                 tile_m: TileM, lanes: int, device: torch.device,
                 tile_policy: Optional[TilePolicy] = None,
                 state=None) -> tuple[int, bool]:
    """The candidate-axis tile of a fused chunk launch and whether K5 /
    K6 keeps V in shared memory: the fewest V-resident tiles per lane
    whose grid co-resides, else one whole-M tile per lane while one
    block's shared memory holds it, else the tile that keeps the
    cooperative grid co-resident (``TilePolicy``, bounded on a card by
    the occupancy it reports, ``chunk_capacity``; the plain versions on
    the CPU launch no grid); under ``"auto"`` the measured tile past the
    whole-M tile where the cache has one, kept on ``state``
    (:func:`resolve_chunk_tile`).  Memoized on the resolved tile."""
    capacity = capacity_fn(windowed, device)
    tm = resolve_chunk_tile(D, M, state_rows, windowed, lanes, capacity,
                            device, tile_m, tile_policy=tile_policy,
                            state=state)
    return _stream_tile_memo(D, M, state_rows, windowed, tm, lanes, device)


@functools.lru_cache(maxsize=256)
def _stream_tile_memo(D, M, state_rows, windowed, tile_m, lanes,
                      device) -> tuple[int, bool]:
    mode, tm, v_resident = TilePolicy(tile_m=tile_m).decide(
        D, M, state_rows, windowed, chunked=True, lanes=lanes,
        capacity=capacity_fn(windowed, device))
    return (M if mode == "resident" else min(tm, M)), v_resident


def dpp_greedy_stream_init(
    V: torch.Tensor,
    k: int,
    mask: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    tile_m: TileM = None,
    tile_policy: Optional[TilePolicy] = None,
):
    """Initial resumable state for the kernel streaming path.

    V (D, M) single or (B, D, M) batched.  Returns a
    ``repro_torch.core.streaming.GreedyState`` in the kernels' layout:
    row-layout Cholesky state ``C (B, R, M)``, ``d2 (B, M)`` with the
    mask folded in (``init_gains``, as the whole-slate kernels start),
    ``win (B, w)`` int32 ring ids (``(B, 0)`` exact), per-lane
    ``stopped (B,)`` and a shared step counter ``t``.
    """
    from repro_torch.core.streaming import GreedyState

    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    Vb = (V[None] if V.ndim == 2 else V).to(torch.float32).contiguous()
    B, D, M = Vb.shape
    windowed = window is not None and window < k
    R = min(window, k) if windowed else k
    if mask is None:
        mask = torch.ones((B, M), dtype=torch.bool, device=Vb.device)
    mask = mask.to(device=Vb.device, dtype=torch.bool).expand(B, M)
    dev = Vb.device
    C = torch.zeros((B, R, M), dtype=torch.float32, device=dev)
    win = torch.full((B, R if windowed else 0), -1, dtype=torch.int32,
                     device=dev)
    state = GreedyState(
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.zeros((B,), dtype=torch.bool, device=dev), C,
        init_gains(Vb, mask), win,
    )
    tile, vres = _stream_tile(D, M, R, windowed, tile_m, B, dev,
                              tile_policy, state)
    record_kernel_dispatch(
        "fused_chunk", D=D, M=M, state_rows=R, windowed=windowed,
        tile_m=tile, smem_bytes=chunk_smem_bytes(D, tile, R, windowed, vres),
        v_resident=vres,
    )
    return state


def dpp_greedy_stream_pad(V: torch.Tensor, state) -> torch.Tensor:
    """``V`` in the streaming state's geometry: contiguous float32, same
    shape (the port pads nothing; kept for ``repro``'s name).  Done once
    up front, it makes every chunk call copy-free."""
    return V.to(torch.float32).contiguous()


def _stream_operands(V, state):
    """``V`` as (B, D, M) contiguous float32, checked against ``state``;
    returns (V, windowed, the state rows R)."""
    Vb = (V[None] if V.ndim == 2 else V).to(torch.float32).contiguous()
    M = Vb.shape[-1]
    if state.d2.shape[-1] != M:
        raise ValueError(
            f"state was built for {state.d2.shape[-1]} candidates, but V "
            f"carries M={M} — pass the V the state was initialized with"
        )
    return Vb, state.win.shape[-1] > 0, state.C.shape[1]


def dpp_greedy_stream_launcher(V: torch.Tensor, state, chunk: int, *,
                               eps: float = 1e-3, tile_m: TileM = None,
                               tile_policy: Optional[TilePolicy] = None):
    """``launch()``: :func:`dpp_greedy_stream_chunk`'s K5/K6 launch on
    this state and ``V``, prepared once (``tiled.chunk_launcher``) for a
    caller that repeats it, as a session does its scrolls.  Each call
    launches ``chunk`` steps and returns ``(sel, dh)`` ``(B, chunk)``,
    the launcher's own tensors, overwritten by the next call.  The
    state's tensors are updated in place and must stay where they are;
    ``state.t`` is read where it lies, so the caller advances it in
    place, and it must already be ``(B,)`` int32 or a 0-d int32 with
    ``B == 1``."""
    Vb, windowed, R = _stream_operands(V, state)
    B, D, M = Vb.shape
    t = state.t.to(torch.int32).expand(B).contiguous()
    if t.data_ptr() != state.t.data_ptr():
        raise ValueError(
            "a stream launcher reads the state's step counter in place: "
            "it must be int32, per lane or shared by a single lane"
        )
    tile, vres = _stream_tile(D, M, R, windowed, tile_m, B, Vb.device,
                              tile_policy, state)
    return chunk_launcher(Vb, state.C, state.d2, t, state.stopped,
                          state.win if windowed else None, chunk,
                          float(eps), tile, vres)


def dpp_greedy_stream_chunk(
    V: torch.Tensor,
    state,
    chunk: int,
    *,
    eps: float = 1e-3,
    tile_m: TileM = None,
    tile_policy: Optional[TilePolicy] = None,
):
    """Advance ``chunk`` greedy steps on a kernel streaming state: one
    K5 (exact) or K6 (windowed) launch.  The state is authoritative for
    the mode (its ``win`` leaf decides windowed vs exact) and, under
    ``"auto"``, for the tile its init resolved; it is updated in place.  Returns ``(state, sel, dh)`` with ``sel``/``dh`` shaped
    ``(chunk,)`` for a single-problem ``V (D, M)`` and ``(B, chunk)``
    batched.

    ``state.t`` may be the shared scalar of the uniform batch paths or a
    per-lane ``(B,)`` counter (the slot layout, where slots join at
    heterogeneous progress); the kernels take it per lane either way.
    """
    single = V.ndim == 2
    Vb, windowed, R = _stream_operands(V, state)
    B, D, M = Vb.shape
    tile, vres = _stream_tile(D, M, R, windowed, tile_m, B, Vb.device,
                              tile_policy, state)
    t = state.t.to(torch.int32).expand(B).contiguous()
    if windowed:
        sel, dh = fused_chunk_windowed(
            Vb, state.C, state.d2, t, state.stopped, state.win, chunk,
            float(eps), tile, vres,
        )
    else:
        sel, dh = fused_chunk_exact(
            Vb, state.C, state.d2, t, state.stopped, chunk, float(eps), tile,
            vres,
        )
    new_state = type(state)(state.t + chunk, state.stopped, state.C,
                            state.d2, state.win)
    if single:
        return new_state, sel[0], dh[0]
    return new_state, sel, dh
