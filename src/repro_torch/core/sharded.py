"""Sharded candidate-axis greedy MAP: one slate over millions of
candidates (the torch counterpart of ``repro/core/sharded.py``, its
whole-slate part).

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

Front doors: ``greedy_map(GreedySpec(backend="sharded", mesh=...))``
and ``Reranker(DPPRerankConfig(mesh=...)).rerank``
(``repro_torch.serving.sharded_rerank``); ``repro_torch.launch.
serve_sharded`` runs P ranks end to end.  The sharded stream
(``repro``'s ``dpp_greedy_sharded_stream_*``) is ROADMAP item 9b.
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


def greedy_local(Vl: torch.Tensor, maskl: torch.Tensor, k: int, *, mesh,
                 base: int, window: Optional[int] = None, eps: float = 1e-6,
                 tile_m: Optional[int] = None):
    """The sharded greedy loop on this rank's shard (``repro``'s
    ``_exact_body`` / ``_windowed_body`` with their step functions).

    Vl (B, D, Mloc) float32 and maskl (B, Mloc) bool on ``mesh.device``,
    ``base`` the shard's first global id.  Returns ``(sel (B, k) int32
    global ids, -1 after an eps-stop; d_hist (B, k) float32)``, the same
    on every rank.  ``tile_m`` is the update entries' candidate tile
    (default ``tiling.DEFAULT_TILE_M``)."""
    from repro_torch.kernels.dpp_greedy.dpp_greedy import eps_squared
    from repro_torch.kernels.dpp_greedy.tiled import (
        eviction_coeffs,
        pack_key,
        unpack_key,
        update_launcher,
    )
    from repro_torch.kernels.dpp_greedy.tiling import DEFAULT_TILE_M

    B, D, Mloc = Vl.shape
    dev = Vl.device
    tile = tile_m or DEFAULT_TILE_M
    w = min(window, k) if window is not None and window < k else None
    rows = k if w is None else w
    eps2 = eps_squared(eps)
    f32 = dict(dtype=torch.float32, device=dev)
    ar = torch.arange(B, device=dev)

    d2 = init_gains(Vl, maskl)
    C = torch.zeros((B, rows, Mloc), **f32)
    keys = torch.zeros((k + 1, B), dtype=torch.int64, device=dev)
    j0 = torch.argmax(d2, dim=1)
    keys[0] = pack_key(d2[ar, j0], j0 + base)
    # the winner's buffers, refilled in place every step, so the update
    # entry's launcher is prepared once
    vj = torch.zeros((B, D), **f32)
    cj = torch.zeros((B, rows), **f32)
    dj = torch.zeros((B,), **f32)
    stopped = torch.zeros((B,), dtype=torch.bool, device=dev)
    j = torch.zeros((B,), dtype=torch.int32, device=dev)
    sel = torch.empty((B, k), dtype=torch.int32, device=dev)
    dh = torch.empty((B, k), **f32)
    if w is None:
        step = update_launcher((Vl, C, d2, vj, cj, dj, stopped, j), base,
                               keys, tile)
    else:
        full = torch.zeros((B,), dtype=torch.bool, device=dev)
        cos = torch.zeros((B, w - 1), **f32)
        sin = torch.zeros((B, w - 1), **f32)
        win = torch.full((B, w), -1, dtype=torch.int64, device=dev)
        step = update_launcher(
            (Vl, C, d2, vj, cj, dj, stopped, full, cos, sin, j), base, keys,
            tile)

    for t in range(k):
        val, gid = unpack_key(keys[t])
        dj2, jg, owner = global_argmax(mesh, val, gid)
        stopped |= dj2 <= eps2
        d_sel = torch.sqrt(torch.clamp_min(dj2, eps2))
        jl = (jg - base).clamp(0, Mloc - 1)
        mine = torch.cat([Vl[ar, :, jl], C[ar, :, jl]], 1)
        sel[:, t] = torch.where(stopped, -1, jg).to(torch.int32)
        dh[:, t] = torch.where(stopped, 0.0, d_sel)
        j.copy_(jg)
        if w is None:
            z = bcast_from_owner(mesh, mine, owner)
            vj.copy_(z[:, :D])
            cj.copy_(z[:, D:])
            dj.copy_(d_sel)
            step(t)
            continue
        # the (w, w) window factor C[:, win] from each member's owner and
        # the winner's pre-eviction column from its owner: one all-reduce
        li = win - base
        owned = (win >= 0) & (li >= 0) & (li < Mloc)
        cols = C.gather(2, li.clamp(0, Mloc - 1)[:, None, :].expand(B, w, w))
        cols = torch.where(owned[:, None, :], cols, 0.0)
        z = all_reduce_sum(mesh, torch.cat(
            [cols.reshape(B, w * w), torch.where(owner[:, None], mine, 0.0)],
            1))
        Cw = z[:, :w * w].reshape(B, w, w)
        vj.copy_(z[:, w * w:w * w + D])
        is_full = (t >= w) & ~stopped
        cs, sn, cjp, d2j = eviction_coeffs(Cw, z[:, w * w + D:], dj2,
                                           is_full, w)
        full.copy_(is_full)
        cos.copy_(cs)
        sin.copy_(sn)
        cj.copy_(cjp)
        dj.copy_(torch.sqrt(torch.clamp_min(d2j, eps2)))
        pos = min(t, w - 1)
        step(t, pos)
        shifted = torch.roll(win, -1, dims=1)
        shifted[:, w - 1] = -1
        nxt = torch.where(is_full[:, None], shifted, win)
        nxt[:, pos] = jg
        win = torch.where(stopped[:, None], win, nxt)
    return sel, dh


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
    from repro_torch.kernels.dpp_greedy.tiling import validate_tile_m

    if V.ndim not in (2, 3):
        raise ValueError(
            f"dpp_greedy_sharded takes V (D, M) or a user batch (B, D, M), "
            f"got ndim={V.ndim}"
        )
    if k <= 0:
        raise ValueError(f"k must be >= 1, got {k}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    validate_tile_m(tile_m)
    _mesh_axis_size(mesh, axis_name)
    batched = V.ndim == 3
    Vb = V if batched else V[None]
    B, _, M = Vb.shape
    if mask is None:
        mask = torch.ones((B, M), dtype=torch.bool, device=V.device)
    mask = mask.to(dtype=torch.bool).expand(B, M)
    base, Mloc = shard_bounds(M, mesh)
    Vl = local_columns(Vb, base, Mloc, 0.0).to(mesh.device, torch.float32)
    ml = local_columns(mask, base, Mloc, False).to(mesh.device)
    sel, dh = greedy_local(Vl, ml, k, mesh=mesh, base=base, window=window,
                           eps=eps, tile_m=tile_m)
    n = (sel >= 0).sum(-1).to(torch.int32)
    if batched:
        return GreedyResult(sel, n, dh)
    return GreedyResult(sel[0], n[0], dh[0])


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
