"""Tile policy for the dpp_greedy CUDA kernels — a Hopper on-chip budget
model.

Same contract as ``repro.kernels.dpp_greedy.tiling.TilePolicy``:
``decide(D, M, state_rows, windowed)`` returns ``("resident", None)`` or
``("tiled", tile_m)``.  What is counted differs.  The TPU model counts
VMEM; here the resident kernels (``dpp_greedy.py``) are chosen exactly
while one user's marginal gains ``d2 (M,)``, the winner's staged columns
and, windowed, the ``(w, w)`` window factor fit one thread block's
227 KB of shared memory (:func:`resident_smem_bytes`).  So the resident
limit bounds ``M``, not ``D * M``.  How the resident kernels then lay a
user out is :func:`resident_cluster`'s answer: a thread-block cluster
of ``s`` CTAs, each holding a slice of ``M / s`` candidates, with ``V``
and the greedy state (K1's Cholesky rows, K2's ring) in the cluster's
shared memory where they fit (:func:`cluster_smem_bytes`).

Past the budget, or whenever an explicit ``tile_m`` is given, the tiled
per-step kernels (``tiled.py``) run: one launch per greedy step over
``(B, ceil(M / tile_m))`` blocks, with only the winner's columns in
shared memory, so ``M`` is unbounded.  The TPU's LANE/SUBLANE padding
does not carry over: the kernels mask their own ragged edge.

``decide(..., chunked=True, lanes=B, capacity=)`` sizes the fused chunk
kernels (``csrc/chunk.cu``, K5/K6) and returns ``(mode, tile_m,
v_resident)``: one cooperative launch per chunk over ``(ceil(M /
tile_m), B)`` blocks that each keep their tile's gains (and, windowed,
their slice of the ring) in shared memory for the whole chunk
(:func:`chunk_smem_bytes`) and meet at a barrier between steps.  A
cooperative grid must be co-resident, so besides the 227 KB per block
the model bounds the block count by ``capacity(smem)``, the blocks the
card keeps co-resident at that much shared memory per block
(``tiled.chunk_capacity``).  Both kernels first try to keep ``V`` in
shared memory too (:func:`chunk_v_resident`): each lane split into the
fewest tiles whose ``V``, gains, staging and, windowed, ring fit one
block, if that grid co-resides.  Otherwise ``V`` streams from device
memory every step: one whole-M tile per lane while that fits, else
tiles of at least ``DEFAULT_TILE_M`` columns, widened until ``B`` lanes
of tiles fit.  Without a ``capacity`` (the plain
versions on the CPU, which launch no grid) only the shared memory bounds
the tile.

``tile_m="auto"`` keeps every answer above where the model stays
resident and takes the tile past that from the measured autotune cache
(``autotune.lookup_tile``, which accepts only tiles this model accepts at
the queried lanes), the model's own answer on a miss.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Union

# Shared memory one H100 thread block may use (227 KB, dynamic only
# past 48 KB; cudaFuncAttributeMaxDynamicSharedMemorySize is raised).
SMEM_BUDGET_BYTES = 232448
WARP = 32
# Reduction scratch in every kernel: one (value, index) pair per warp.
_RED_FLOATS = 2 * WARP
# Candidate-axis tile of the tiled kernels when the model picks it: one
# 256-thread block sweeps 4 columns per thread.
DEFAULT_TILE_M = 1024


# What the tile_m knob accepts across the stack: an explicit warp
# multiple, the measured autotuner's "auto", or None (the model decides).
TileM = Union[int, str, None]


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` >= ``x``."""
    return (x + m - 1) // m * m


def tile_count(M: int, tile_m: int) -> int:
    """Tiles of ``tile_m`` columns a lane of ``M`` candidates spans: the
    x extent of the tiled and fused chunk kernels' grids, ``(M + tile_m
    - 1) / tile_m`` in ``csrc/tiled.cu`` and ``csrc/chunk.cu``."""
    return -(-M // tile_m)


def validate_tile_m(tile_m, allow_auto: bool = False) -> None:
    """Shared tile_m validation (``TilePolicy``, ``GreedySpec``,
    ``DPPRerankConfig`` and the sharded path accept the knob): ``None``
    (budget model decides), a positive multiple of the 32-thread warp,
    or, where ``allow_auto``, the string ``"auto"`` (the measured
    autotune cache, ``autotune.lookup_tile``, with the model as its
    fallback).  Call sites that cannot consult the cache (the sharded
    update entries) keep ``allow_auto=False``, so a stray ``"auto"``
    fails loudly instead of reaching tile arithmetic."""
    if tile_m is None:
        return
    if tile_m == "auto":
        if allow_auto:
            return
        raise ValueError(
            'tile_m="auto" (the measured autotune cache) is only understood '
            "by the single-device kernel dispatch — this call site needs "
            f"None or an explicit positive multiple of the {WARP}-thread "
            "warp"
        )
    if (not isinstance(tile_m, int) or isinstance(tile_m, bool)
            or tile_m < WARP or tile_m % WARP != 0):
        raise ValueError(
            f'tile_m must be None, "auto" (measured autotune cache with '
            f"budget-model fallback), or a positive multiple of the {WARP}-"
            f"thread warp, got {tile_m!r}"
        )


def resident_smem_bytes(D: int, M: int, state_rows: int,
                        windowed: bool) -> int:
    """Dynamic shared memory of one resident block, in the layout the
    kernels carve it (``csrc/dpp_greedy.cu``): ``d2 (M)``, the winner's
    ``V`` column ``(D)``, then exact: its Cholesky column ``(k)``;
    windowed: its pre/post-eviction columns, the ``(w, w)`` window
    factor, the residue row and the rotation coefficients ``(w)`` each,
    and the ring ids ``(w)``; plus the reduction scratch."""
    R = state_rows
    per_state = R * R + 6 * R if windowed else R
    return 4 * (M + D + per_state + _RED_FLOATS)


# Portable thread-block cluster sizes (CTAs a user) of the resident
# kernels, fewest first.
CLUSTER_SIZES = (1, 2, 4, 8)
# Floats of a resident CTA's header: two u64 argmax keys, the warps'
# reduction scratch (2 x 8), the block argmax, the repaired gain, a pad
# (``CLUSTER_HDR`` in csrc/dpp_greedy.cu).
_CLUSTER_HDR = 24


class ClusterPlan(NamedTuple):
    """How the resident kernels lay out one user: ``s`` CTAs a cluster,
    each a slice of :func:`cluster_tile` candidates; whether each CTA
    keeps its ``(D, tile)`` slice of ``V`` in shared memory
    (``v_resident``, else V streams from device memory every step) and
    its slice of the greedy state, K2's ``(w, tile)`` ring or K1's
    ``(k, tile)`` Cholesky rows (``state_resident``, else the state
    lives in device memory)."""

    s: int
    v_resident: bool
    state_resident: bool


def cluster_tile(M: int, s: int) -> int:
    """Candidates of one CTA's slice in a cluster of ``s``: ``ceil(M /
    s)`` rounded up to 4 floats, so every slice starts 16-byte aligned."""
    return round_up(-(-M // s), 4)


def cluster_smem_bytes(D: int, M: int, state_rows: int, windowed: bool,
                       s: int, v_resident: bool,
                       state_resident: bool = False) -> int:
    """Dynamic shared memory of one resident CTA in a cluster of ``s``,
    in the layout ``csrc/dpp_greedy.cu`` carves it: the header, the
    slice's gains ``d2 (tile)``, with ``state_resident`` the state slice
    ``(R, tile)`` (K2's ring, K1's Cholesky rows), with ``v_resident``
    the ``V`` slice ``(D, tile)``, the winner's ``V`` column ``(D)``;
    exact: its Cholesky column ``(k)``; windowed: its pre/post-eviction
    columns, the ``(w, w)`` window factor, the residue row, the rotation
    coefficients and the ring ids ``(w)`` each, and with ``s > 1`` the
    step-parity exchange buffers: the candidate's ring column ``(2, w)``
    and the window-factor entries ``(2, w, w)``."""
    R = state_rows
    tile = cluster_tile(M, s)
    floats = (_CLUSTER_HDR + tile + D + (D * tile if v_resident else 0)
              + (R * tile if state_resident else 0))
    if windowed:
        floats += R * R + 6 * R
        if s > 1:
            floats += 2 * R + 2 * R * R
    else:
        floats += R
    return 4 * floats


def resident_cluster(D: int, M: int, state_rows: int, windowed: bool,
                     lanes: int = 1,
                     capacity: Optional[Callable[[int, int, bool, bool],
                                                 int]] = None,
                     s: Optional[int] = None) -> ClusterPlan:
    """The resident kernels' layout of each of ``lanes`` users (K2
    ``windowed``, else K1), for a shape ``TilePolicy.decide`` calls
    resident.

    ``s`` is the fewest CTAs a user (of :data:`CLUSTER_SIZES`) whose
    ``V`` slice, gains, staging and, windowed, ring slice fit one CTA's
    227 KB.  K1 keeps its Cholesky rows there too where they fit at that
    many CTAs, or at more while all ``lanes`` clusters still run at once
    (``capacity`` known).  If 8 CTAs cannot hold ``V``, it streams over 8
    slices, with the state resident where it fits.  On a card,
    ``capacity(s, smem, v_resident, state_resident)`` is the number of
    such clusters it holds at once (``cudaOccupancyMaxActiveClusters``); a layout it
    cannot place (0) is not taken.  An explicit ``s`` (the card tests)
    forces the cluster size and decides only the residencies.  Raises
    ``ValueError`` when no layout fits and can be placed."""
    sizes = CLUSTER_SIZES if s is None else (s,)

    def room(s_, vres, sres):
        """How many such clusters run at once (None: no capacity known);
        0 when the layout does not fit or cannot be placed."""
        smem = cluster_smem_bytes(D, M, state_rows, windowed, s_, vres, sres)
        if smem > SMEM_BUDGET_BYTES:
            return 0
        return (None if capacity is None
                else capacity(s_, smem, vres, sres))

    def fits(s_, vres, sres):
        return room(s_, vres, sres) != 0

    fewest = next((s_ for s_ in sizes if fits(s_, True, windowed)), None)
    if fewest is not None:
        if not windowed:
            for s_ in sizes:
                if s_ < fewest:
                    continue
                n = room(s_, True, True)
                if n != 0 and (s_ == fewest or (n is not None
                                                and lanes <= n)):
                    return ClusterPlan(s_, True, True)
        return ClusterPlan(fewest, True, windowed)
    for s_ in (sizes if s is not None else sizes[::-1]):
        for sres in (True, False):
            if fits(s_, False, sres):
                return ClusterPlan(s_, False, sres)
    least = cluster_smem_bytes(D, M, state_rows, windowed, sizes[-1], False)
    raise ValueError(
        f"no resident cluster layout fits or can be placed for D={D}, "
        f"M={M}, {state_rows} state rows, windowed={windowed}, cluster "
        f"sizes {list(sizes)} (at {sizes[-1]} CTAs, {least} B of shared "
        f"memory a CTA against {SMEM_BUDGET_BYTES} B)"
    )


def tiled_smem_bytes(D: int, state_rows: int, windowed: bool) -> int:
    """Dynamic shared memory of one tiled block (``csrc/tiled.cu``): the
    winner's ``V`` column ``(D)``; exact: its Cholesky column ``(R)``;
    windowed: the same per-step staging as a resident block (the
    winner's pre/post-eviction columns, the ``(w, w)`` window factor,
    the residue row, the rotation coefficients and the ring ids), plus
    reduction scratch.  Independent of ``tile_m``."""
    return resident_smem_bytes(D, 0, state_rows, windowed)


def update_smem_bytes(D: int, state_rows: int, windowed: bool) -> int:
    """Dynamic shared memory of one block of the shard-local update
    entries (``csrc/tiled.cu``): the winner's ``V`` column ``(D)``;
    exact: its Cholesky column ``(R)``; windowed: its post-eviction
    column and the rotation coefficients ``(w)`` each; plus reduction
    scratch.  Independent of ``tile_m``."""
    R = state_rows
    return 4 * (D + (3 * R if windowed else R) + _RED_FLOATS)


def chunk_smem_bytes(D: int, tile_m: int, state_rows: int,
                     windowed: bool, v_resident: bool = False) -> int:
    """Dynamic shared memory of one fused-chunk block, in the layout
    ``csrc/chunk.cu`` carves it: the tile's gains ``d2 (tile_m)``, kept
    for the whole chunk; windowed, the tile's ring ``(w, tile_m)`` and,
    ``v_resident``, its ``V`` slice ``(D, tile_m)``, both kept for the
    whole chunk too; then the same per-step staging as a resident block
    — the winner's ``V`` column ``(D)``; exact: its Cholesky column
    ``(R)``; windowed: its pre/post-eviction columns, the ``(w, w)``
    window factor, the residue row, the rotation coefficients and the
    ring ids ``(w)`` each — plus the reduction scratch."""
    R = state_rows
    per_col = (R if windowed else 0) + (D if v_resident else 0)
    return resident_smem_bytes(D, tile_m, R, windowed) + 4 * tile_m * per_col


def chunk_v_resident(D: int, M: int, tile_m: int, state_rows: int,
                     windowed: bool, lanes: int = 1,
                     capacity: Optional[Callable[[int], int]] = None) -> bool:
    """Whether the chunk kernel (K6 ``windowed``, else K5) keeps each
    tile's ``V`` slice in shared memory for the whole chunk: exactly when
    that block fits the 227 KB and, on a card (``capacity``), the grid of
    ``lanes * ceil(M / tile_m)`` blocks still co-resides at that size.
    ``TilePolicy.decide(..., chunked=True)`` decides by this and hands
    the answer on with the tile."""
    smem = chunk_smem_bytes(D, tile_m, state_rows, windowed, v_resident=True)
    if smem > SMEM_BUDGET_BYTES:
        return False
    return capacity is None or lanes * tile_count(M, tile_m) <= capacity(smem)


@dataclasses.dataclass(frozen=True)
class TilePolicy:
    """How the dpp_greedy kernels use shared memory.

    tile_m:
        Explicit candidate-axis tile width (a multiple of 32).  Forces
        the tiled kernels even when the resident kernels would fit —
        that is how tiled-vs-resident parity is tested.  ``None``: the
        resident kernels while their shared memory fits
        ``SMEM_BUDGET_BYTES``, else tiles of ``DEFAULT_TILE_M``.
        ``"auto"`` keeps the resident-while-it-fits rule (for the chunk
        kernels: one whole-M tile a lane) but takes the tile past it
        from the measured autotune cache (``autotune.lookup_tile``) when
        the cache has an entry for this card and shape that the model
        accepts, falling back to the model's answer — never an error —
        when it has none.
    """

    tile_m: TileM = None

    def __post_init__(self):
        validate_tile_m(self.tile_m, allow_auto=True)

    def resolve(
        self, D: int, M: int, state_rows: int, windowed: bool,
        chunked: bool = False, lanes: int = 1,
        capacity: Optional[Callable[[int], int]] = None, device=None,
    ) -> Optional[int]:
        """The ``tile_m`` this policy stands for at this shape: itself
        unless ``"auto"``; for ``"auto"`` the cache's tile where the
        model would tile and the cache has one (looked up, and counted,
        once here), else ``None`` (the model).  ``TilePolicy(tile_m=
        resolve(...)).decide(...)`` is this policy's ``decide``, so a
        caller that repeats one shape resolves once and keeps the
        answer."""
        if self.tile_m != "auto":
            return self.tile_m
        if TilePolicy().decide(D, M, state_rows, windowed, chunked, lanes,
                               capacity)[0] == "resident":
            return None
        from repro_torch.kernels.dpp_greedy.autotune import lookup_tile

        return lookup_tile(D=D, M=M, state_rows=state_rows,
                           windowed=windowed, chunked=chunked, lanes=lanes,
                           capacity=capacity, device=device)

    def decide(
        self, D: int, M: int, state_rows: int, windowed: bool,
        chunked: bool = False, lanes: int = 1,
        capacity: Optional[Callable[[int], int]] = None, device=None,
    ) -> tuple:
        """-> ("resident", None) | ("tiled", tile_m).

        ``chunked=True`` sizes the fused chunk kernels for ``lanes``
        users and returns a third item, ``v_resident``: whether K5 / K6
        keeps each tile's ``V`` in shared memory.
        ``("resident", None, v)`` is one whole-M tile per lane,
        ``("tiled", tile_m, v)`` splits M so that the cooperative grid of
        ``lanes * ceil(M / tile_m)`` blocks stays within
        ``capacity(smem)`` (see the module docstring); raises when no
        tile fits.  ``device`` (the tensors' device) names the card the
        ``"auto"`` lookup keys on.
        """
        if self.tile_m == "auto":
            return TilePolicy(tile_m=self.resolve(
                D, M, state_rows, windowed, chunked, lanes, capacity,
                device)).decide(D, M, state_rows, windowed, chunked, lanes,
                                capacity)
        if chunked:
            return self._decide_chunked(D, M, state_rows, windowed, lanes,
                                        capacity)
        tiled = tiled_smem_bytes(D, state_rows, windowed)
        if tiled > SMEM_BUDGET_BYTES:
            raise ValueError(
                f"D={D} with {state_rows} state rows needs {tiled} B of "
                f"shared memory per block even tiled (budget "
                f"{SMEM_BUDGET_BYTES} B)"
            )
        if self.tile_m is not None:
            return "tiled", self.tile_m
        smem = resident_smem_bytes(D, M, state_rows, windowed)
        if smem <= SMEM_BUDGET_BYTES:
            return "resident", None
        return "tiled", min(DEFAULT_TILE_M, round_up(M, WARP))

    def _decide_chunked(self, D, M, R, windowed, lanes, capacity):
        if self.tile_m is None:
            split = _v_resident_split(D, M, R, windowed, lanes, capacity)
            if split is not None:
                return split
        # the most gains (and, windowed, ring) columns one block holds
        # with V streamed from device memory
        per_col = 4 * (1 + R) if windowed else 4
        room = (SMEM_BUDGET_BYTES - chunk_smem_bytes(D, 0, R, windowed)) \
            // per_col
        if self.tile_m is not None:
            tile = self.tile_m
        elif M <= room:
            tile = M  # one whole-M tile per lane
        else:
            tile = DEFAULT_TILE_M
        if min(tile, M) > room:
            raise ValueError(
                f"D={D} with {R} state rows leaves room for a tile of at most "
                f"{max(room, 0)} columns in one block's {SMEM_BUDGET_BYTES} B "
                f"of shared memory, not {min(tile, M)}"
            )
        while True:
            nt = tile_count(M, tile)
            cols = min(tile, M)
            vres = chunk_v_resident(D, M, cols, R, windowed, lanes, capacity)
            if capacity is None:
                break
            cap = capacity(chunk_smem_bytes(D, cols, R, windowed, vres))
            if lanes * nt <= cap:
                break
            per_lane = cap // lanes
            wider = round_up(-(-M // per_lane), WARP) if per_lane else None
            if self.tile_m is not None or wider is None or wider > room:
                raise ValueError(
                    f"fused chunk grid of {lanes * nt} blocks ({lanes} lanes "
                    f"x {nt} tiles of {min(tile, M)} columns) exceeds the "
                    f"{cap} blocks the card keeps co-resident for one "
                    f"cooperative launch: "
                    + ("pass a wider tile_m or fewer lanes"
                       if self.tile_m is not None else "split the batch")
                )
            tile = wider
        if self.tile_m is None and tile >= M:
            return "resident", None, vres
        return "tiled", tile, vres


def _v_resident_split(D, M, R, windowed, lanes, capacity):
    """The chunk tiling with ``V`` in shared memory: each lane split into
    the fewest tiles (a multiple of the warp, or the whole lane) whose
    ``V``, gains, staging and, windowed, ring fit one block, if that grid
    co-resides: ``decide``'s answer with V in shared memory, else None."""
    per_col = 4 * (1 + D + (R if windowed else 0))
    room = (SMEM_BUDGET_BYTES - chunk_smem_bytes(D, 0, R, windowed)) \
        // per_col
    if M <= room:
        tile = M
    elif room < WARP:
        return None
    else:
        nt = -(-M // room)
        tile = round_up(-(-M // nt), WARP)
        while tile > room:
            nt += 1
            tile = round_up(-(-M // nt), WARP)
    if not chunk_v_resident(D, M, tile, R, windowed, lanes, capacity):
        return None
    return ("resident", None, True) if tile >= M else ("tiled", tile, True)
