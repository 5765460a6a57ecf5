"""Step-resumable greedy MAP — the state/init/step/chunk layer under
streaming slate emission (the torch counterpart of
``repro.core.streaming``).

The greedy loop is a recurrence on a small state (the incremental
Cholesky rows, the marginal gains ``d2`` and, windowed, the ring order).
This module reifies it as :class:`GreedyState` and exposes it in
resumable pieces:

* ``greedy_init(spec, L=|V=, mask=)``  -> initial state;
* ``greedy_step(spec, state, ...)``    -> one selection;
* ``greedy_chunk(spec, state, ...)``   -> ``chunk_size`` selections.

Chunks concatenate exactly to the whole-slate result, because each
backend's chunk executor runs the per-step op sequence of its
whole-slate loop:

* torch  — ``greedy_step_exact`` / ``greedy_step_windowed``, the very
           functions the whole-slate loops call;
* kernel — the fused chunk kernels K5/K6
           (``repro_torch.kernels.dpp_greedy.ops.dpp_greedy_stream_*``):
           one cooperative CUDA launch per chunk, sharing the per-column
           device functions of the resident kernels K1/K2 (their plain
           versions on CPU tensors);
* sharded — ``repro_torch.core.sharded.ShardedState``: each rank's
           shard of the state, advanced by the step of the whole-slate
           sharded loop (one update-entry launch a step, with that
           step's collectives); every rank runs the same chunks.  Its
           step counter is a lane's own, so the router's lanes sit at
           their own depths on a mesh too.

``GreedyState`` is backend-specific: the torch exact state keeps the
paper's column layout ``C (M, k)``, the torch windowed state the ring
``C (w, M)`` (single problems), the kernel state the row layout
``C (B, R, M)`` with per-lane ``stopped (B,)``; the sharded state is a
``ShardedState`` of the rank's own slices, not a ``GreedyState``.
Thread a state back into the same ``spec`` that created it.  Unlike
``repro``'s immutable arrays, the port updates a state's tensors in
place where that saves an O(R M) copy per chunk (exact ``C``; every
kernel-state leaf; slot splices): keep the returned state and drop the
one passed in.

The exact state holds ``k`` Cholesky rows; a lane whose step counter
reaches ``k`` latches stopped (``repro`` drops the row write there
instead; neither slate nor stream ever runs past ``k``).

The serving front door is ``repro_torch.serving.Reranker.stream``; the
dispatch-level generator is ``repro_torch.core.dispatch.
greedy_map_chunks``; :func:`greedy_chunk_slots` advances a batch of
slots at heterogeneous progress (the continuous-batching substrate).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.greedy_chol import (
    NEG_INF,
    _dense_rows,
    _lowrank_rows,
    greedy_step_exact,
    lane_steps,
)
from repro_torch.core.sharded import (
    ShardedState,
    dpp_greedy_sharded_stream_chunk,
    dpp_greedy_sharded_stream_init,
)
from repro_torch.core.windowed import greedy_step_windowed, window_solve
from repro_torch.device import constant, resolve_device, same_device
from repro_torch.distributed.context import shard_bounds
from repro_torch.obs.dispatch import (
    record_chunk,
    record_slot_state_alloc,
    record_state_alloc,
)


class GreedyState(NamedTuple):
    """Resumable greedy MAP state (backend-specific layouts, see module
    docstring).

    t:       () int32 — the next absolute step index ((S,) per slot).
    stopped: () bool  — eps-stop latch ((B,) for kernel states).
    C:       Cholesky state — torch exact ``(M, k)`` columns, windowed
             ``(w, M)`` ring rows; kernel ``(B, R, M)`` rows.
    d2:      marginal gains with the selectability mask folded in
             (masked candidates sit at -inf) — ``(M,)`` / ``(B, M)``.
    win:     window ring ids, oldest first (``(0,)``-shaped when exact).
    """

    t: torch.Tensor
    stopped: torch.Tensor
    C: torch.Tensor
    d2: torch.Tensor
    win: torch.Tensor


def _refuse_sharded_splice(what: str, sharded: bool) -> None:
    if sharded:
        raise NotImplementedError(
            f"{what} takes no candidate-sharded state: a sharded lane is "
            f"built at the slot batch's bucket width, so that a column has "
            f"the same owner in every lane, and admitted in place "
            f"(state_admit, ShardedState.admit)"
        )


def _check_kernel_args(spec, L, V):
    if (L is None) == (V is None):
        raise ValueError("pass exactly one of L= (dense) or V= (low-rank)")
    if L is not None and (spec.backend == "kernel" or spec.sharded()):
        raise ValueError(
            f"backend {spec.backend!r} streams the low-rank V only — the "
            f"kernels never materialize a dense L, and it cannot be "
            f"candidate-sharded"
        )


def resolve_chunk(spec, chunk_size: Optional[int]) -> int:
    """The effective chunk size: the explicit argument wins, else
    ``spec.chunk_size``; one of them must be set and positive."""
    c = chunk_size if chunk_size is not None else spec.chunk_size
    if c is None:
        raise ValueError(
            "no chunk size: pass chunk_size= or set GreedySpec.chunk_size"
        )
    if c < 1:
        raise ValueError(f"chunk_size must be >= 1, got {c}")
    return c


# ---------------------------------------------------------------------------
# torch executors (single problem; dense L or low-rank V)
# ---------------------------------------------------------------------------


def _init_torch(k: int, window: Optional[int], L, V, mask) -> GreedyState:
    kern = L if L is not None else V
    if kern.ndim != 2:
        raise ValueError(
            f"torch streaming takes a single problem (L (M, M) / V (D, M)), "
            f"got ndim={kern.ndim}"
        )
    M = kern.shape[-1]
    dtype, dev = kern.dtype, kern.device
    if mask is None:
        mask = torch.ones((M,), dtype=torch.bool, device=dev)
    diag = torch.diagonal(L) if L is not None else (V * V).sum(0)
    d2 = torch.where(mask.to(device=dev, dtype=torch.bool), diag, NEG_INF)
    if window is not None and window < k:
        C = torch.zeros((window, M), dtype=dtype, device=dev)
        win = torch.full((window,), -1, dtype=torch.int64, device=dev)
    else:
        C = torch.zeros((M, k), dtype=dtype, device=dev)
        win = torch.zeros((0,), dtype=torch.int64, device=dev)
    return GreedyState(
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.bool, device=dev), C, d2, win,
    )


def _chunk_body(row_fn, state: GreedyState, chunk: int, eps: float):
    """``chunk`` steps of the shared per-step bodies on a *batched* state
    (leading lane axis on every leaf, ``t`` a scalar or per lane), at
    absolute step ``t + s`` — the whole-slate loops' op sequence."""
    C, d2, win, stopped = state.C, state.d2, state.win, state.stopped
    B = d2.shape[0]
    dtype, dev = d2.dtype, d2.device
    eps2 = constant(eps, dtype=dtype, device=dev) ** 2
    tiny = constant(1e-30, dtype=dtype, device=dev)
    t = lane_steps(state.t, B, dev)
    windowed = win.shape[-1] > 0
    sel = torch.full((B, chunk), -1, dtype=torch.int32, device=dev)
    dh = torch.zeros((B, chunk), dtype=dtype, device=dev)
    for s in range(chunk):
        if windowed:
            C, d2, win, stopped, j, dj = greedy_step_windowed(
                row_fn, t + s, C, d2, win, stopped, w=C.shape[1],
                eps2=eps2, tiny=tiny,
            )
        else:
            stopped = stopped | (t + s >= C.shape[2])
            C, d2, stopped, j, dj = greedy_step_exact(
                row_fn, t + s, C, d2, stopped, eps2
            )
        sel[:, s] = torch.where(stopped, -1, j).to(torch.int32)
        dh[:, s] = torch.where(stopped, 0.0, dj)
    return GreedyState(state.t + chunk, stopped, C, d2, win), sel, dh


def _batch1(state: GreedyState) -> GreedyState:
    return GreedyState(*(x[None] for x in state))


def _chunk_single(kern, dense: bool, state: GreedyState, chunk: int,
                  eps: float):
    row_fn = _dense_rows(kern[None]) if dense else _lowrank_rows(kern[None])
    st, sel, dh = _chunk_body(row_fn, _batch1(state), chunk, eps)
    return GreedyState(*(x[0] for x in st)), sel[0], dh[0]


# ---------------------------------------------------------------------------
# Dispatch-aware front doors
# ---------------------------------------------------------------------------


def greedy_init(spec, *, L=None, V=None, mask=None) -> GreedyState:
    """Initial resumable state for ``spec`` on a dense (L) or low-rank
    (V) kernel.  ``mask`` marks selectable candidates; it is folded into
    the state (masked entries can never be selected in any later chunk).
    """
    _check_kernel_args(spec, L, V)
    record_state_alloc(k=spec.k)
    if spec.sharded():
        return dpp_greedy_sharded_stream_init(
            V, spec.k, mesh=spec.mesh, axis_name=spec.axis_name,
            window=spec.window, mask=mask, tile_m=spec.tile_m,
        )
    if spec.backend == "kernel":
        from repro_torch.kernels.dpp_greedy import dpp_greedy_stream_init

        return dpp_greedy_stream_init(
            V, spec.k, mask=mask, window=spec.window, tile_m=spec.tile_m
        )
    return _init_torch(spec.k, spec.window, L, V, mask)


def greedy_chunk(
    spec, state: GreedyState, *, L=None, V=None,
    chunk_size: Optional[int] = None,
):
    """Advance ``chunk_size`` greedy steps (default ``spec.chunk_size``).

    Returns ``(next_state, sel (chunk,), d_hist (chunk,))`` — with a
    leading batch axis on ``sel``/``d_hist`` for batched kernel and
    sharded states.  On a mesh every rank calls it with the same
    chunk (the step's collectives pair the ranks).
    Slots after an eps-stop hold -1 / 0, as the whole-slate result's
    tail does.  ``state.t`` advances by the chunk even across an
    eps-stop.  The caller sizes chunks so the total never exceeds
    ``spec.k`` on the exact path (the windowed ring is unbounded);
    ``repro_torch.core.dispatch.greedy_map_chunks`` does this.
    """
    _check_kernel_args(spec, L, V)
    chunk = resolve_chunk(spec, chunk_size)
    if spec.sharded():
        # the request's B and M, as on the other backends
        record_chunk("sharded", B=state.d2.shape[0], chunk=chunk, M=state.M)
        return dpp_greedy_sharded_stream_chunk(V, state, chunk,
                                               eps=spec.eps)
    kern = L if L is not None else V
    record_chunk(
        "kernel" if spec.backend == "kernel" else "torch",
        B=kern.shape[0] if kern.ndim == 3 else 1,
        chunk=chunk,
        M=kern.shape[-1],
    )
    if spec.backend == "kernel":
        from repro_torch.kernels.dpp_greedy import dpp_greedy_stream_chunk

        return dpp_greedy_stream_chunk(
            V, state, chunk, eps=spec.eps, tile_m=spec.tile_m
        )
    return _chunk_single(kern, L is not None, state, chunk, float(spec.eps))


def greedy_chunk_launcher(spec, state: GreedyState, *, V,
                          chunk_size: Optional[int] = None):
    """``launch()`` -> ``(sel, d_hist)``: :func:`greedy_chunk` on the
    low-rank ``V`` for a caller that owns ``state`` and runs many chunks
    of one size on it, as a session does: each call advances ``state``
    in place, its step counter too, so the caller keeps the state object
    and its tensors.  On the kernel backend a call is one K5/K6 launch
    with the operands checked and the scratch allocated once
    (``dpp_greedy_stream_launcher``), and ``sel`` / ``d_hist`` are the
    launcher's own ``(B, chunk)`` tensors, overwritten by the next call;
    on the torch backend a call runs :func:`greedy_chunk` and copies the
    new state into the old one's tensors.  ``V (S, D, M)`` with a
    slot-batched state (:func:`greedy_slots_init`) advances every slot,
    as :func:`greedy_chunk_slots` does; the continuous-batching router
    runs its cycles so.  On a mesh a call is :meth:`ShardedState.chunk`
    through the update launcher the state keeps (``chunk`` update
    launches, with their collectives: every rank calls it together),
    and ``V`` is the state's own shard (:func:`slot_pad_v`)."""
    _check_kernel_args(spec, None, V)
    chunk = resolve_chunk(spec, chunk_size)
    if spec.sharded():
        def launch_sharded():
            record_chunk("sharded", B=state.d2.shape[0], chunk=chunk,
                         M=state.M)
            return dpp_greedy_sharded_stream_chunk(V, state, chunk,
                                                   eps=spec.eps)[1:]

        return launch_sharded
    backend = "kernel" if spec.backend == "kernel" else "torch"
    B, M = (V.shape[0] if V.ndim == 3 else 1), V.shape[-1]
    if backend == "kernel":
        from repro_torch.kernels.dpp_greedy import dpp_greedy_stream_launcher

        run = dpp_greedy_stream_launcher(V, state, chunk, eps=spec.eps,
                                         tile_m=spec.tile_m)

        def launch():
            record_chunk(backend, B=B, chunk=chunk, M=M)
            out = run()
            state.t.add_(chunk)
            return out

        return launch

    def launch():
        record_chunk(backend, B=B, chunk=chunk, M=M)
        if V.ndim == 3:
            new, sel, dh = _chunk_body(_lowrank_rows(V), state, chunk,
                                       float(spec.eps))
        else:
            new, sel, dh = _chunk_single(V, False, state, chunk,
                                         float(spec.eps))
        for old, x in zip(state, new):
            old.copy_(x)
        return sel, dh

    return launch


def greedy_step(spec, state: GreedyState, *, L=None, V=None):
    """One greedy step: ``(next_state, idx, d)`` with scalar ``idx``/``d``
    (-1 / 0 once eps-stopped).  Sugar for a chunk of one."""
    state, sel, dh = greedy_chunk(spec, state, L=L, V=V, chunk_size=1)
    return state, sel[..., 0], dh[..., 0]


# ---------------------------------------------------------------------------
# Session delta updates — recondition a windowed state on a pool delta
# ---------------------------------------------------------------------------
#
# A windowed state is fully determined by the pool ``V``, the last-w
# shown ids and the dead set (shown + masked): ``d2_i = L_ii -
# ||C[:, i]||^2`` for live i, and ``C[:, i] = V_W^{-1} L_{W, i}`` depends
# only on the window columns of V.  So when a block of candidate columns
# is appended or overwritten, only that block's C columns and d2 entries
# change; the block is re-solved against the window factor ``C[:, win]``
# (lower-triangular) with one triangular solve — O(w^2 + w dM D), never
# O(k M) like a from-scratch rerun.


def _delta_cols(V, C, d2, win, start: int, V_blk, mask_blk,
                keep_dead: bool):
    """Recompute C/d2 for pool columns ``[start, start + dM)`` after
    writing ``V_blk`` there.  Unbatched leaves: V (D, M), C (w, M),
    d2 (M,), win (w,).  ``keep_dead`` preserves dead columns (d2 at
    -inf: shown, masked) bit for bit — the rescore contract.  Returns
    new tensors; the inputs are not modified."""
    w = C.shape[0]
    dtype = C.dtype
    dm = V_blk.shape[1]
    ids = win.clamp_min(0)
    valid = win >= 0

    # the window's lower-triangular Cholesky factor, read off C itself;
    # empty ring slots become identity rows (and zero window columns) so
    # the solve is a no-op there
    eye = torch.eye(w, dtype=dtype, device=C.device)
    F = torch.where(valid[:, None], C[:, ids].T, eye)
    Vwin = torch.where(valid[None, :], V[:, ids], 0.0)
    c, d2_blk = window_solve(F, Vwin, V_blk)
    d2_blk = torch.where(mask_blk, d2_blk, NEG_INF)

    sl = slice(start, start + dm)
    if keep_dead:
        dead = torch.isneginf(d2[sl])
        V_blk = torch.where(dead[None, :], V[:, sl], V_blk)
        c = torch.where(dead[None, :], C[:, sl], c)
        d2_blk = torch.where(dead, d2[sl], d2_blk)

    V, C, d2 = V.clone(), C.clone(), d2.clone()
    V[:, sl] = V_blk.to(V.dtype)
    C[:, sl] = c.to(dtype)
    d2[sl] = d2_blk.to(d2.dtype)
    return V, C, d2


def _state_delta(spec, state, V, start, V_new, mask_new, keep_dead, op):
    if spec.sharded():
        # repro refuses sharded states here too (its streaming.py,
        # _state_delta): the ring is sharded and a column delta crosses
        # shard boundaries
        raise NotImplementedError(
            f"{op} is not implemented for sharded states, as in repro: the "
            f"window ring is sharded and a column delta crosses shard "
            f"boundaries; re-rank a sharded pool from scratch"
        )
    if state.win.shape[-1] == 0:
        raise ValueError(
            f"{op} needs a windowed state (window < slate size): the "
            f"exact C (M, k) layout does not expose the conditioning "
            f"window, so a column delta cannot be re-solved in O(w*dM)"
        )
    if V_new.ndim != 2:
        raise ValueError(f"{op}: V_new must be (D, dM), got ndim={V_new.ndim}")
    dm = V_new.shape[1]
    M = V.shape[-1]
    if V_new.shape[0] != V.shape[-2]:
        raise ValueError(
            f"{op}: V_new has D={V_new.shape[0]} rows but the pool operand "
            f"carries D={V.shape[-2]}"
        )
    start = int(start)
    if start < 0 or start + dm > M:
        raise ValueError(
            f"{op}: block [{start}, {start + dm}) exceeds the pool's "
            f"{M} columns — size the session capacity up front"
        )
    if mask_new is None:
        mask_new = torch.ones((dm,), dtype=torch.bool, device=V.device)
    mask_new = mask_new.to(device=V.device, dtype=torch.bool)
    V_blk = V_new.to(device=V.device, dtype=V.dtype)
    if spec.backend == "kernel":
        if state.C.ndim != 3 or state.C.shape[0] != 1:
            raise ValueError(
                f"{op} takes a single-request kernel stream state "
                f"(leading batch axis 1): a session runs one state, and no "
                f"ROADMAP queue 1 item adds delta updates to the router's "
                f"slot-batched states"
            )
        V2, C2, d22 = _delta_cols(
            V[0] if V.ndim == 3 else V, state.C[0], state.d2[0],
            state.win[0], start, V_blk, mask_new, keep_dead,
        )
        C2, d22 = C2[None], d22[None]
        if V.ndim == 3:
            V2 = V2[None]
    else:
        V2, C2, d22 = _delta_cols(
            V, state.C, state.d2, state.win, start, V_blk, mask_new,
            keep_dead,
        )
    # a delta can revive a stopped state: new or raised columns may now
    # clear the eps gate, so the latch re-arms.  The revived resume must
    # condition on the live ring: a stopped chunk advances t past the
    # last real pick, and a stale t >= w would evict a window item that
    # was never followed by a pick.  Ring occupancy is the true pick count
    # below w, and any t >= w behaves the same once the ring is full — so
    # t is re-derived from the ring.
    t2 = (state.win >= 0).sum(-1).to(torch.int32)
    if t2.ndim:  # single-request kernel state: one lane, scalar counter
        t2 = t2[0]
    new_state = GreedyState(
        t2, torch.zeros_like(state.stopped), C2, d22, state.win.clone()
    )
    return new_state, V2


def greedy_state_extend(spec, state: GreedyState, V, start, V_new,
                        mask_new=None):
    """Append ``dM`` candidate columns at ``start`` of the pool operand.

    Writes ``V_new (D, dM)`` into columns ``[start, start + dM)`` of
    ``V``, re-solves exactly those columns' Cholesky state against the
    state's current window and returns ``(state', V')`` — O(w * dM),
    independent of how many steps the state has already taken.  The
    target region is overwritten blind (the caller's padding or retired
    region); ``mask_new`` marks which new columns are selectable.
    Windowed states only.  The dtype of ``V`` and the state threads
    through: nothing is cast to float32 on the way.
    """
    return _state_delta(
        spec, state, V, start, V_new, mask_new, False, "greedy_state_extend"
    )


def greedy_state_rescore(spec, state: GreedyState, V, start, V_new,
                         mask_new=None):
    """Overwrite ``dM`` existing columns with refreshed vectors.

    Same geometry and cost as :func:`greedy_state_extend`, with one
    contract change: dead columns (d2 at -inf — already shown, masked
    out) keep their exact old V/C/d2 bits, so the shown history and the
    window factor are never rewritten by a score refresh.  ``mask_new``
    False additionally retires a live column.
    """
    return _state_delta(
        spec, state, V, start, V_new, mask_new, True, "greedy_state_rescore"
    )


# ---------------------------------------------------------------------------
# Slot-batched execution — the continuous-batching substrate
# ---------------------------------------------------------------------------
#
# A router coalesces heterogeneous live requests into one batch of S
# slots and advances all of them with one chunk call per cycle.  Slots
# join and leave mid-flight, so the slot state carries a per-slot step
# counter ``t (S,)``; the per-step bodies consume ``t`` per lane (it only
# feeds the Cholesky row index and the ring position), so a slot's
# selections are those of a single-request state at the same ``t``.
#
# Layout: every leaf gains a leading slot axis — torch exact
# ``C (S, M, k)``, windowed ``C (S, w, M)``, kernel ``(S, R, M)`` — and
# parked (empty) slots hold ``stopped=True`` with ``d2`` at -inf, so
# they select -1 while occupied neighbours compute.


def greedy_slot_state(spec, V, mask=None, dtype=None) -> GreedyState:
    """Single-request state in ``spec``'s slot layout.

    ``spec.k`` is the slot capacity, not the request's own slate length:
    every slot shares one Cholesky geometry so states splice into any
    slot.  ``V (D, M)`` must already span the slot batch's width (mask
    False over padding).  ``dtype`` casts ``V`` first so the state's
    leaves match the slot batch it will be spliced into; the kernels
    compute in float32 regardless.  On a mesh this is the rank's
    single-request :class:`~repro_torch.core.sharded.ShardedState` of
    ``V`` (called on every rank), the state a slot-batched lane holds
    after :func:`state_admit` of the same request.
    """
    if dtype is not None:
        V = V.to(dtype)
    if spec.sharded():
        return dpp_greedy_sharded_stream_init(
            V, spec.k, mesh=spec.mesh, axis_name=spec.axis_name,
            window=spec.window, mask=mask, tile_m=spec.tile_m,
        )
    if spec.backend == "kernel":
        from repro_torch.kernels.dpp_greedy import dpp_greedy_stream_init

        st = dpp_greedy_stream_init(
            V, spec.k, mask=mask, window=spec.window, tile_m=spec.tile_m
        )
        return GreedyState(st.t, st.stopped[0], st.C[0], st.d2[0], st.win[0])
    return _init_torch(spec.k, spec.window, None, V, mask)


def slot_state_widen(spec, state: GreedyState, M: int) -> GreedyState:
    """A fresh single-request slot state (``greedy_slot_state`` on the
    request's own ``V (D, m)``) widened to ``M >= m`` candidate columns:
    the new columns parked (gains at -inf, Cholesky columns zero), the
    request's own columns untouched.  Its gains are then bit for bit
    those a whole-slate call on the unpadded ``V`` starts from (the
    gains reduction on the card may round differently at another
    width)."""
    _refuse_sharded_splice("slot_state_widen", spec.sharded())
    pad = M - state.d2.shape[-1]
    if pad < 0:
        raise ValueError(
            f"cannot widen a state of {state.d2.shape[-1]} columns to {M}"
        )
    if pad == 0:
        return state
    # the torch exact state keeps columns C (M, k), every other C (R, M)
    torch_exact = spec.backend != "kernel" and state.win.shape[-1] == 0
    C = torch.nn.functional.pad(
        state.C, (0, 0, 0, pad) if torch_exact else (0, pad)
    )
    d2 = torch.cat([state.d2, state.d2.new_full((pad,), NEG_INF)])
    return state._replace(C=C, d2=d2)


def slot_pad_v(spec, V, state):
    """``V`` in the chunk executor's geometry.  The port pads nothing (the
    kernels mask their own ragged edge), so this is the identity, kept
    for ``repro``'s name; the kernel backend casts to contiguous
    float32 once so no chunk call copies V, and a sharded state gives
    the rank's own shard (``state.Vl``), so no chunk moves O(D M)
    data."""
    if spec.sharded():
        return state.Vl
    if spec.backend == "kernel":
        from repro_torch.kernels.dpp_greedy import dpp_greedy_stream_pad

        return dpp_greedy_stream_pad(V, state)
    return V


def greedy_slots_init(spec, slots: int, D: int, M: int,
                      dtype=torch.float32, device=None):
    """Parked S-slot batch state + its zeroed V operand.

    Returns ``(state, V_slots)``: every slot is parked (``stopped``,
    ``d2`` -inf, ``t`` 0) and ``V_slots`` is zeros ``(S, D, M)``.  Admit
    requests with :func:`state_splice`, free slots with
    :func:`state_evict`.  ``dtype`` is the resident element type; it
    must match the lanes that will be spliced in.  ``device`` defaults
    to the card (``repro_torch.device.resolve_device``); pass ``"cpu"``
    for the plain path.  On a mesh the state is the rank's slot
    :class:`~repro_torch.core.sharded.ShardedState` over its shard of
    the ``M``-column bucket on ``spec.mesh.device`` (``device``, when
    given, must be that device; ``dtype`` float32, as the sharded path
    computes), and ``V_slots`` is the state's own shard ``state.Vl``.
    """
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    if spec.sharded():
        return _sharded_slots_init(spec, slots, D, M, dtype, device)
    device = resolve_device(device)
    record_slot_state_alloc(slots=slots, M=M)
    Vz = torch.zeros((D, M), dtype=dtype, device=device)
    single = greedy_slot_state(
        spec, Vz, mask=torch.zeros((M,), dtype=torch.bool, device=device)
    )
    single = single._replace(stopped=torch.ones_like(single.stopped))
    state = GreedyState(*(
        x.expand((slots,) + tuple(x.shape)).clone() for x in single
    ))
    Vp = slot_pad_v(spec, Vz, state)
    V_slots = torch.zeros((slots,) + tuple(Vp.shape), dtype=Vp.dtype,
                          device=device)
    return state, V_slots


def _sharded_slots_init(spec, slots: int, D: int, M: int, dtype, device):
    mesh = spec.mesh
    if dtype != torch.float32:
        raise ValueError(f"a sharded slot state computes in float32, got "
                         f"dtype {dtype}")
    if device is not None and not same_device(resolve_device(device),
                                              mesh.device):
        raise ValueError(f"spec.mesh keeps its shards on {mesh.device}, "
                         f"not on {device}")
    record_slot_state_alloc(slots=slots, M=M)
    base, Mloc = shard_bounds(M, mesh)
    dev = mesh.device
    state = ShardedState(
        torch.zeros((slots, D, Mloc), dtype=torch.float32, device=dev),
        torch.zeros((slots, Mloc), dtype=torch.bool, device=dev), spec.k,
        mesh=mesh, base=base, M=M, window=spec.window, tile_m=spec.tile_m,
        slots=True)
    state.stopped.fill_(True)
    return state, state.Vl


def state_splice(state: GreedyState, single: GreedyState,
                 slot: int) -> GreedyState:
    """Write a single-request state (``greedy_slot_state``, same spec and
    geometry) into ``slot`` of a slot-batched state, in place; each leaf
    is cast to the batch leaf's dtype.  Returns ``state``."""
    _refuse_sharded_splice("state_splice", isinstance(state, ShardedState)
                           or isinstance(single, ShardedState))
    for b, s in zip(state, single):
        b[slot] = s.to(b.dtype)
    return state


def state_admit(spec, state: GreedyState, slot: int, V,
                mask=None) -> GreedyState:
    """Admit one request into the parked ``slot`` of a slot-batched
    state, in place: its step counter rewound, its stop flag cleared and
    the gains of its own ``V (D, m)`` (mask ``(m,)`` or None) written
    over the slot's first ``m`` columns.  Nothing else is written: a
    parked slot (:func:`greedy_slots_init`, :func:`state_evict`) already
    holds zero Cholesky rows, ring ids -1 and gains -inf, and no chunk
    changes a stopped lane's rows.  The slot then holds the bits
    ``state_splice(state, slot_state_widen(spec, greedy_slot_state(spec,
    V, mask), M), slot)`` would write, the gains computed at the
    request's own width as a whole-slate call computes them, at three
    writes instead of a state's worth of ops.  Returns ``state``.

    On a mesh ``V`` is the rank's shard ``(D, Mloc)`` of the request
    padded to the slot state's bucket and ``mask`` its selectable columns
    ``(Mloc,)`` (``serving.sharded_rerank._sharded_kernel`` with the
    bucket as ``width``), written by :meth:`ShardedState.admit`: the lane
    then holds the bits of ``greedy_slot_state(spec, V_padded, mask)``
    on every rank."""
    if spec.sharded():
        if mask is None:
            mask = torch.ones(V.shape[-1:], dtype=torch.bool,
                              device=V.device)
        state.admit(slot, V, mask)
        return state
    m = V.shape[-1]
    if spec.backend == "kernel":
        # init_gains' reduction on (1, D, m) float32: K1's first gains
        V = V.to(torch.float32).contiguous()[None]
        d2 = (V * V).sum(1)[0]
    else:
        V = V.to(state.d2.dtype)
        d2 = (V * V).sum(0)
    if mask is not None:
        d2 = torch.where(mask.to(torch.bool), d2, NEG_INF)
    state.t.select(0, slot).zero_()
    state.stopped.select(0, slot).zero_()
    state.d2.select(0, slot)[:m].copy_(d2)
    return state


def state_evict(state: GreedyState, slot: int) -> GreedyState:
    """Park ``slot`` in place: eps-stopped with every candidate at -inf,
    step counter rewound, Cholesky rows zeroed (so a later splice starts
    from the bits of a fresh single-request state); a sharded state's
    lane also has its keys zeroed (:meth:`ShardedState.evict`).  Returns
    ``state``."""
    if isinstance(state, ShardedState):
        state.evict(slot)
        return state
    state.t[slot] = 0
    state.stopped[slot] = True
    state.C[slot] = 0.0
    state.d2[slot] = NEG_INF
    if state.win.shape[-1]:
        state.win[slot] = -1
    return state


def greedy_chunk_slots(spec, state: GreedyState, V_slots, chunk: int):
    """Advance every slot ``chunk`` greedy steps in one batched call.

    ``V_slots (S, D, M)`` is the stacked per-slot kernel operand.
    Returns ``(state, sel (S, chunk), d_hist (S, chunk))`` — parked and
    stopped slots yield -1 / 0.  On the kernel backend this is one K5/K6
    launch for all slots; per-request k, mask and progress live in data.
    On a mesh it is ``chunk`` steps of the rank's slot
    :class:`~repro_torch.core.sharded.ShardedState` (one update launch
    and its collectives a step, every rank together; ``V_slots`` the
    state's shard), global ids.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if spec.sharded():
        record_chunk("sharded", B=V_slots.shape[0], chunk=chunk, M=state.M)
        return dpp_greedy_sharded_stream_chunk(V_slots, state, chunk,
                                               eps=spec.eps)
    record_chunk(
        "kernel" if spec.backend == "kernel" else "torch",
        B=V_slots.shape[0],
        chunk=chunk,
        M=V_slots.shape[-1],
    )
    if spec.backend == "kernel":
        from repro_torch.kernels.dpp_greedy import dpp_greedy_stream_chunk

        return dpp_greedy_stream_chunk(
            V_slots, state, chunk, eps=spec.eps, tile_m=spec.tile_m
        )
    return _chunk_body(_lowrank_rows(V_slots), state, chunk, float(spec.eps))
