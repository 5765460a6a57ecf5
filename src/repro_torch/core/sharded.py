"""Sharded candidate-axis greedy MAP: one slate over millions of
candidates (the torch counterpart of ``repro/core/sharded.py``).

The paper's Algorithm 1 costs O(D M) a step on the low-rank kernel
``L = V^T V``, and each candidate needs only its own column of ``V``.
So rank ``p`` of a P-rank :class:`~repro_torch.distributed.CandidateMesh`
keeps just the ``(D, M/P)`` column shard of ``V`` and its slice of the
Cholesky state (``C``, ``d2``); the dense ``(M, M)`` kernel never exists.
``repro`` runs the ranks as one ``shard_map``; here they are the
processes of a ``torch.distributed`` group, each given the same full
request and returning the same slate.  ``M`` is zero-padded (mask
False) to ``P * Mloc``.

A request batch of B users shares the group: each rank holds
``V (B, D, Mloc)`` and the per-step collectives move B values at once.

Per greedy step, on every rank:

1. **global argmax**: each shard's best (gain, global id), unpacked from
   the key its last update folded, meets the others' in one all-gather;
   the fold takes the largest gain, then the lowest rank, which is the
   lowest global id (``repro_torch.distributed.global_argmax``);
2. **winner broadcast**: one SUM all-reduce of owner-masked rows
   replicates the winner's ``V[:, j]`` and its Cholesky column ``c_j``
   (windowed: with the ``(w, w)`` window factor ``C[:, win]``, gathered
   from the members' owners in the same all-reduce, from which every
   rank derives the same eviction coefficients with
   ``kernels.dpp_greedy.tiled.eviction_coeffs``);
3. **local update**: the shard-local update entry of K3 / K4
   (``tiled_update_exact`` / ``tiled_update_windowed``, one launch on a
   CUDA shard, the plain version on a CPU one) appends row ``t`` (or
   evicts and appends on the ring), updates ``d2`` (the owner masks the
   winner) and folds the shard's next (max, lowest global index) key.

Every rank holds the replicated step state (the slate, the stop flags,
windowed the ring ids), so the slate is the same on every rank and
equals the single-device rerank's up to exact float ties between
distinct items, which the single-device path breaks by shortlist
position and this one by lowest global id.  The initial gains are a
sum over ``D`` in a fixed order (:func:`init_gains`), so a column's
gain has the same bits for every shard count.

The loop state is resumable (:class:`ShardedState`, one update
launcher prepared per state), and the whole slate is that state advanced
by one chunk of ``k``: a stream's chunks concatenate to it bit for bit
by construction.  Each lane keeps its own step counter (``repro``'s
``t_batched``), so the continuous-batching router's slot state is a
:class:`ShardedState` too, its lanes admitted and evicted in place at
their own depths.

Front doors: ``greedy_map(GreedySpec(backend="sharded", mesh=...))``
and ``Reranker(DPPRerankConfig(mesh=...)).rerank``
(``repro_torch.serving.sharded_rerank``); the stream through
``core.streaming.greedy_init`` / ``greedy_chunk``,
``core.dispatch.greedy_map_chunks`` and ``Reranker.stream`` (every rank
consumes the same chunks); the router through
``Reranker(DPPRerankConfig(mesh=...)).submit`` on the slot executors of
``core.streaming`` (every rank submits and pumps alike);
``repro_torch.launch.serve_sharded`` runs P ranks end to end, whole,
``--stream`` or ``--router``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.greedy_chol import NEG_INF, GreedyResult
from repro_torch.distributed.context import (
    all_reduce_sum,
    bcast_from_owner,
    gather_pairs,
    global_argmax,
    shard_bounds,
)


def _mesh_axis_size(mesh, axis_name: str) -> int:
    if axis_name != mesh.axis_name:
        raise ValueError(
            f"mesh has no axis {axis_name!r}; mesh axes: "
            f"({mesh.axis_name!r},)"
        )
    return mesh.size


def local_columns(x: torch.Tensor, base: int, Mloc: int, fill) -> torch.Tensor:
    """Columns ``[base, base + Mloc)`` of ``x (..., M)``, padded with
    ``fill`` past ``M``: this rank's shard of a full request array."""
    M = x.shape[-1]
    lo, hi = min(base, M), min(base + Mloc, M)
    part = x[..., lo:hi]
    if hi - lo < Mloc:
        pad = torch.full(x.shape[:-1] + (Mloc - (hi - lo),), fill,
                         dtype=x.dtype, device=x.device)
        part = torch.cat([part, pad], -1)
    return part.contiguous()


def init_gains(Vl: torch.Tensor, maskl: torch.Tensor) -> torch.Tensor:
    """``d2 = diag(V^T V)`` of a shard, ``-inf`` where masked: (B, Mloc),
    summed over ``d`` in ascending order one column at a time, so a
    column's gain does not depend on the shard width."""
    acc = Vl[:, 0] * Vl[:, 0]
    for d in range(1, Vl.shape[1]):
        acc = acc + Vl[:, d] * Vl[:, d]
    return torch.where(maskl, acc, NEG_INF).contiguous()


class ShardedState:
    """The resumable sharded greedy state of one rank (``repro``'s
    sharded ``GreedyState``, whose leaves are the global view of the
    per-device slices; here each rank holds its own).  Each chunk
    advances it in place: keep the object.

    * ``Vl (B, D, Mloc)``, ``C (B, R, Mloc)`` rows (R = k exact, the ring
      of w windowed), ``d2 (B, Mloc)``: the rank's shard of ``V``, of the
      Cholesky rows and of the gains;
    * ``t (B,)`` int32: each lane's next step (``repro``'s per-slot
      ``t_batched``); a lane whose counter reaches ``k`` latches stopped;
    * ``keys (2, B)`` int64: each lane's packed (max gain, lowest global
      id) of its shard, two rows used in turn: step ``t`` reads row
      ``t & 1`` and its update entry folds the next into row
      ``(t + 1) & 1`` (zeroing the one it read), so a lane's keys never
      run out and a lane admitted again needs only its two keys reset;
    * ``stopped (B,)``, windowed ``win (B, w)`` (ring ids, oldest first,
      -1 empty): replicated on every rank;
    * ``steps`` the chunks' steps so far, ``base`` the shard's first
      global id, ``M`` the request's candidate count, ``single`` a
      ``(D, M)`` request.

    The whole slate and the stream start every lane together (one ``t``
    for all).  A slot state (``slots=True``, the continuous-batching
    router's; ``core.streaming.greedy_slots_init``) starts parked and
    takes requests lane by lane (:meth:`admit`, :meth:`evict`), each at
    its own depth; its chunks run past ``k`` on lanes that finished, whose
    counters stay at ``k`` (parked lanes' too), stopped.

    One update launcher is prepared here over the state's buffers and
    the winner's (refilled in place every step), so a chunk's steps are
    one launch each with nothing prepared again."""

    def __init__(self, Vl: torch.Tensor, maskl: torch.Tensor, k: int, *,
                 mesh, base: int, M: Optional[int] = None,
                 window: Optional[int] = None,
                 tile_m: Optional[int] = None, single: bool = False,
                 slots: bool = False):
        from repro_torch.kernels.dpp_greedy.tiled import update_launcher
        from repro_torch.kernels.dpp_greedy.tiling import DEFAULT_TILE_M

        B, D, Mloc = Vl.shape
        dev = Vl.device
        f32 = dict(dtype=torch.float32, device=dev)
        self.mesh, self.base, self.k, self.single = mesh, base, k, single
        self.slots = slots
        self.M = mesh.size * Mloc if M is None else M
        self.w = min(window, k) if window is not None and window < k \
            else None
        rows = k if self.w is None else self.w
        self.steps = 0
        self.t = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.Vl = Vl
        self.d2 = torch.empty((B, Mloc), **f32)
        self.C = torch.zeros((B, rows, Mloc), **f32)
        self.keys = torch.zeros((2, B), dtype=torch.int64, device=dev)
        self._ar = torch.arange(B, device=dev)
        self.stopped = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._first(slice(None), Vl, maskl)
        # the winner's buffers, refilled in place every step
        self._vj = torch.zeros((B, D), **f32)
        self._cj = torch.zeros((B, rows), **f32)
        self._dj = torch.zeros((B,), **f32)
        self._j = torch.zeros((B,), dtype=torch.int32, device=dev)
        tile = tile_m or DEFAULT_TILE_M
        head = (Vl, self.C, self.d2, self._vj, self._cj, self._dj,
                self.stopped)
        if self.w is None:
            self.win = None
            self._launch = update_launcher(head + (self._j, self.t), base,
                                           self.keys, tile)
        else:
            w = self.w
            self.win = torch.full((B, w), -1, dtype=torch.int64, device=dev)
            self._full = torch.zeros((B,), dtype=torch.bool, device=dev)
            self._cos = torch.zeros((B, w - 1), **f32)
            self._sin = torch.zeros((B, w - 1), **f32)
            self._launch = update_launcher(
                head + (self._full, self._cos, self._sin, self._j, self.t),
                base, self.keys, tile)

    def _first(self, lanes, Vl, maskl) -> None:
        """The gains of ``lanes`` from their shard ``Vl`` and mask, in
        :func:`init_gains`' order, and their first key (row 0)."""
        from repro_torch.kernels.dpp_greedy.tiled import pack_key

        d2 = init_gains(Vl, maskl)
        j0 = torch.argmax(d2, dim=1)
        ar = torch.arange(d2.shape[0], device=d2.device)
        self.d2[lanes] = d2
        self.keys[:, lanes] = 0
        self.keys[0, lanes] = pack_key(d2[ar, j0], j0 + self.base)

    def admit(self, lane: int, Vl: torch.Tensor, maskl: torch.Tensor):
        """Start a request in the parked ``lane`` (:meth:`evict`, or a
        fresh slot state), in place: its shard ``Vl (D, Mloc)`` of the
        request padded to the state's ``M`` and its mask ``(Mloc,)``
        written, its gains and first key computed as a fresh state of
        that request computes them, its ring ids reset and its counter at
        0, its stop flag cleared.  The lane then holds the bits of a
        fresh single-request :class:`ShardedState` of the request at the
        same ``M`` (its Cholesky rows are zero from the park)."""
        self.Vl[lane].copy_(Vl)
        self._first(slice(lane, lane + 1), self.Vl[lane:lane + 1],
                    maskl[None])
        if self.win is not None:
            self.win[lane] = -1
        self.t[lane] = 0
        self.stopped[lane] = False

    def evict(self, lane: int) -> None:
        """Park ``lane`` in place: stopped, every gain at -inf, its
        Cholesky rows and keys zero, its counter rewound.  A parked lane
        selects -1 while its neighbours run."""
        self.stopped[lane] = True
        self.d2[lane] = NEG_INF
        self.C[lane] = 0.0
        self.keys[:, lane] = 0
        self.t[lane] = 0
        if self.win is not None:
            self.win[lane] = -1

    def _step(self, eps2: float):
        """One greedy step of every lane, each at its own ``t``, on every
        rank: the global argmax, the winner's columns from its owner, one
        update launch.  Returns the step's ``(ids (B,) int32, -1 once
        stopped; d (B,))``."""
        from repro_torch.kernels.dpp_greedy.tiled import (
            eviction_coeffs,
            unpack_key,
        )

        mesh, base, t, ar = self.mesh, self.base, self.t, self._ar
        Vl, C, stopped = self.Vl, self.C, self.stopped
        B, D, Mloc = Vl.shape
        val, gid = unpack_key(self.keys[t & 1, ar])
        dj2, jg, owner = global_argmax(mesh, val, gid)
        stopped |= (dj2 <= eps2) | (t >= self.k)
        d_sel = torch.sqrt(torch.clamp_min(dj2, eps2))
        jl = (jg - base).clamp(0, Mloc - 1)
        mine = torch.cat([Vl[ar, :, jl], C[ar, :, jl]], 1)
        sel = torch.where(stopped, -1, jg).to(torch.int32)
        dh = torch.where(stopped, 0.0, d_sel)
        self._j.copy_(jg)
        self.steps += 1
        w = self.w
        if w is None:
            z = bcast_from_owner(mesh, mine, owner)
            self._vj.copy_(z[:, :D])
            self._cj.copy_(z[:, D:])
            self._dj.copy_(d_sel)
            self._launch()
            t.add_(t < self.k)  # a counter stops at k
            return sel, dh
        # the (w, w) window factor C[:, win] from each member's owner and
        # the winner's pre-eviction column from its owner: one all-reduce
        win = self.win
        li = win - base
        owned = (win >= 0) & (li >= 0) & (li < Mloc)
        cols = C.gather(2, li.clamp(0, Mloc - 1)[:, None, :].expand(B, w, w))
        cols = torch.where(owned[:, None, :], cols, 0.0)
        z = all_reduce_sum(mesh, torch.cat(
            [cols.reshape(B, w * w), torch.where(owner[:, None], mine, 0.0)],
            1))
        Cw = z[:, :w * w].reshape(B, w, w)
        self._vj.copy_(z[:, w * w:w * w + D])
        is_full = (t >= w) & ~stopped
        cs, sn, cjp, d2j = eviction_coeffs(Cw, z[:, w * w + D:], dj2,
                                           is_full, w)
        self._full.copy_(is_full)
        self._cos.copy_(cs)
        self._sin.copy_(sn)
        self._cj.copy_(cjp)
        self._dj.copy_(torch.sqrt(torch.clamp_min(d2j, eps2)))
        self._launch()
        shifted = torch.roll(win, -1, dims=1)
        shifted[:, w - 1] = -1
        nxt = torch.where(is_full[:, None], shifted, win)
        nxt.scatter_(1, t.clamp_max(w - 1).to(torch.int64)[:, None],
                     jg[:, None])
        self.win = torch.where(stopped[:, None], win, nxt)
        t.add_(t < self.k)
        return sel, dh

    def chunk(self, n: int, eps: float):
        """Advance ``n`` greedy steps: ``(sel (B, n) int32 global ids, -1
        after an eps-stop; d_hist (B, n))``, the same on every rank.  A
        state that started its lanes together holds ``k`` steps, and a
        chunk past them raises; a slot state's lanes latch stopped at
        ``k`` instead."""
        from repro_torch.kernels.dpp_greedy.dpp_greedy import eps_squared

        if n < 1:
            raise ValueError(f"chunk must be >= 1, got {n}")
        if not self.slots and self.steps + n > self.k:
            raise ValueError(
                f"a chunk of {n} from step {self.steps} passes the state's "
                f"k={self.k} steps")
        eps2 = eps_squared(eps)
        B = self.d2.shape[0]
        sel = torch.empty((B, n), dtype=torch.int32, device=self.d2.device)
        dh = torch.empty((B, n), dtype=torch.float32, device=self.d2.device)
        for s in range(n):
            sel[:, s], dh[:, s] = self._step(eps2)
        return sel, dh


def greedy_local(Vl: torch.Tensor, maskl: torch.Tensor, k: int, *, mesh,
                 base: int, window: Optional[int] = None, eps: float = 1e-6,
                 tile_m: Optional[int] = None):
    """The sharded greedy loop on this rank's shard (``repro``'s
    ``_exact_body`` / ``_windowed_body``): a :class:`ShardedState` and
    one chunk of ``k``, so a stream's chunks concatenate to it by
    construction.

    Vl (B, D, Mloc) float32 and maskl (B, Mloc) bool on ``mesh.device``,
    ``base`` the shard's first global id.  Returns ``(sel (B, k) int32
    global ids, -1 after an eps-stop; d_hist (B, k) float32)``, the same
    on every rank.  ``tile_m`` is the update entries' candidate tile
    (default ``tiling.DEFAULT_TILE_M``)."""
    state = ShardedState(Vl, maskl, k, mesh=mesh, base=base, window=window,
                         tile_m=tile_m)
    return state.chunk(k, eps)


def _check_request(V, k, window, tile_m, mesh, axis_name, name):
    from repro_torch.kernels.dpp_greedy.tiling import validate_tile_m

    if V.ndim not in (2, 3):
        raise ValueError(
            f"{name} takes V (D, M) or a user batch (B, D, M), "
            f"got ndim={V.ndim}"
        )
    if k <= 0:
        raise ValueError(f"k must be >= 1, got {k}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    validate_tile_m(tile_m)
    _mesh_axis_size(mesh, axis_name)


def _local_request(V, mask, mesh):
    """This rank's shard of a full request: ``(Vl (B, D, Mloc) float32,
    maskl (B, Mloc), base)`` on ``mesh.device``.  ``mask`` is ``(M,)``,
    ``(B, M)``, or, batched, a shared ``(M,)`` filter."""
    Vb = V if V.ndim == 3 else V[None]
    B, _, M = Vb.shape
    if mask is None:
        mask = torch.ones((B, M), dtype=torch.bool, device=V.device)
    mask = mask.to(dtype=torch.bool).expand(B, M)
    base, Mloc = shard_bounds(M, mesh)
    Vl = local_columns(Vb, base, Mloc, 0.0).to(mesh.device, torch.float32)
    ml = local_columns(mask, base, Mloc, False).to(mesh.device)
    return Vl, ml, base


def dpp_greedy_sharded(
    V: torch.Tensor,
    k: int,
    *,
    mesh,
    axis_name: str = "data",
    window: Optional[int] = None,
    eps: float = 1e-6,
    mask: Optional[torch.Tensor] = None,
    tile_m: Optional[int] = None,
) -> GreedyResult:
    """Greedy DPP MAP with the candidate axis of ``V`` sharded over
    ``mesh`` (call it on every rank with the same arguments).

    ``V`` is a single problem ``(D, M)`` or a user batch ``(B, D, M)``;
    ``mask`` is ``(M,)``, ``(B, M)``, or, batched, a shared ``(M,)``
    filter.  Each rank moves only its column shard to ``mesh.device``.
    Selects the slate of ``dpp_greedy_lowrank`` (``window`` None or
    ``>= k``) or ``dpp_greedy_windowed_lowrank`` on the whole ``V``
    (their ``_batch`` variants batched), identical ids and ``d_hist``
    within float32 rounding, with global ids.  ``tile_m`` is the update
    entries' candidate tile."""
    _check_request(V, k, window, tile_m, mesh, axis_name,
                   "dpp_greedy_sharded")
    Vl, ml, base = _local_request(V, mask, mesh)
    sel, dh = greedy_local(Vl, ml, k, mesh=mesh, base=base, window=window,
                           eps=eps, tile_m=tile_m)
    n = (sel >= 0).sum(-1).to(torch.int32)
    if V.ndim == 3:
        return GreedyResult(sel, n, dh)
    return GreedyResult(sel[0], n[0], dh[0])


def dpp_greedy_sharded_stream_init(
    V: torch.Tensor,
    k: int,
    *,
    mesh,
    axis_name: str = "data",
    window: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
    tile_m: Optional[int] = None,
) -> ShardedState:
    """The resumable state of the sharded stream (``repro``'s
    ``dpp_greedy_sharded_stream_init``): the same request contract as
    :func:`dpp_greedy_sharded`, called on every rank; the rank keeps its
    column shard and its slice of the state on ``mesh.device``."""
    _check_request(V, k, window, tile_m, mesh, axis_name,
                   "sharded streaming")
    Vl, ml, base = _local_request(V, mask, mesh)
    return ShardedState(Vl, ml, k, mesh=mesh, base=base, M=V.shape[-1],
                        window=window, tile_m=tile_m, single=V.ndim == 2)


def dpp_greedy_sharded_stream_chunk(V: torch.Tensor, state: ShardedState,
                                    chunk: int, *, eps: float = 1e-6):
    """Advance ``chunk`` sharded greedy steps on every rank (``repro``'s
    ``dpp_greedy_sharded_stream_chunk``).  ``V`` is the state's own
    shard ``state.Vl`` (``core.streaming.slot_pad_v``: nothing moves) or
    the request's ``V``, whose shard is copied into the state's.
    Returns ``(state, sel, d_hist)``: ``(chunk,)`` for a single request,
    ``(B, chunk)`` batched, global ids.  Chunks concatenate bit for bit
    to :func:`dpp_greedy_sharded`'s slate.  Every rank must run the same
    chunks: a rank that stops early leaves its peers blocked in the next
    step's collective."""
    if V is not state.Vl:
        if V.shape[-1] != state.M or V.shape[-2] != state.Vl.shape[1]:
            raise ValueError(
                f"V {tuple(V.shape)} is neither the state's shard nor its "
                f"request's (D={state.Vl.shape[1]}, M={state.M})")
        Vb = V if V.ndim == 3 else V[None]
        state.Vl.copy_(local_columns(Vb, state.base, state.Vl.shape[2], 0.0))
    sel, dh = state.chunk(chunk, eps)
    if state.single:
        return state, sel[0], dh[0]
    return state, sel, dh


def sharded_topk(scores: torch.Tensor, c: int, *, mesh,
                 axis_name: str = "data"):
    """Global top-c of a candidate-sharded score vector ``scores (M,)``
    or batch ``(B, M)`` (the full request on every rank).

    Each rank takes the top ``min(c, Mloc)`` of its shard (a stable
    descending sort: equal scores keep the lowest index first), then one
    all-gather of the survivors' (value, id) pairs in rank order and a
    stable sort merge them: exact, since every global top-c element
    survives its own shard's top-c, and equal scores end up by lowest
    global id, as ``jax.lax.top_k`` orders the gathered vector.  (``repro`` merges in
    log2(P) pairwise rounds for power-of-two P; the result is the
    same.)  Returns ``(values (c,), global ids (c,) int64)``, a leading
    B axis when batched, on ``scores``' device."""
    if scores.ndim not in (1, 2):
        raise ValueError(
            f"sharded_topk takes scores (M,) or a batch (B, M), "
            f"got ndim={scores.ndim}"
        )
    _mesh_axis_size(mesh, axis_name)
    batched = scores.ndim == 2
    s = scores if batched else scores[None]
    B, M = s.shape
    c = min(c, M)
    if c <= 0:
        raise ValueError(f"c must be >= 1, got {c}")
    base, Mloc = shard_bounds(M, mesh)
    sl = local_columns(s, base, Mloc, NEG_INF)
    cl = min(c, Mloc)
    v, i = torch.sort(sl, dim=-1, descending=True, stable=True)
    v, i = v[:, :cl], i[:, :cl] + base
    if cl < c:  # pad every rank's list to a common length c
        v = torch.cat([v, torch.full((B, c - cl), NEG_INF, dtype=v.dtype,
                                     device=v.device)], 1)
        i = torch.cat([i, torch.full((B, c - cl), torch.iinfo(torch.int64)
                                     .max, dtype=i.dtype, device=i.device)],
                      1)
    av, ai = gather_pairs(mesh, v, i)
    av, ai = (x.transpose(0, 1).reshape(B, -1) for x in (av, ai))
    vv, pp = torch.sort(av, dim=-1, descending=True, stable=True)
    vv, ii = vv[:, :c], ai.gather(1, pp[:, :c])
    return (vv, ii) if batched else (vv[0], ii[0])
