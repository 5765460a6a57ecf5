"""Fused candidate scoring + exact top-c per segment of rows (K7), the CUDA
counterpart of ``repro/kernels/scored_topk/scored_topk.py``'s ``_kernel``
and of the final top-c in ``repro``'s ``ops.scored_topk``
(``csrc/scored_topk.cu``).

For every segment of ``seg`` consecutive rows of ``emb`` the kernel keeps
the segment's top-c of ``emb @ query``: with ``seg`` = the block rows
(:func:`scored_topk_blocks`) the Pallas kernel's ``(nb, c)`` survivors,
with ``seg = M`` (``ops.scored_topk``) the global top-c, in one launch.
A persistent grid of ``ctas_per_seg`` CTAs a segment streams ``emb``
through a ring of bulk copies in shared memory, keeps each row's unique
64-bit (value, lowest index) key on chip, runs a radix select across
the segment's CTAs until its candidates fit ``gather`` slots, and places
the top c of those: every CTA ranks its share where a segment has many
CTAs, one CTA sorts them where it has few; :func:`launch_plan` sizes all
of it.  Rows past M
are scored -inf by global index inside the kernel, so ``emb`` is never
padded.  The wrapper runs the plain PyTorch version for CPU tensors (the
tests) and launches the kernel for CUDA tensors, or raises.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import cuda

_SRC = Path(__file__).resolve().parent / "csrc" / "scored_topk.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "scored_topk_launch": [_I, _P, _P, _P, _P, _P, _P, _P] + [_I] * 12 + [_P],
    "scored_topk_capacity": [_I, _I, _P],
    "scored_topk_set_smem": [_I, _I],
}
_DTYPES = (torch.float32, torch.bfloat16)
LANE = 128  # block rows are a multiple of this, as in repro
MAX_SMEM_BYTES = 227 * 1024  # a Hopper block's shared memory (232,448 B)
# Mirrors of the kernel's constants (csrc/scored_topk.cu)
STAGES = 3  # TK_STAGES: ring stages
ROWS_PER_CTA_PASS = 64  # TK_WARPS * TK_ROWS: rows the warps score at once
HEADER_BYTES = 128  # TK_HEADER: mbarriers, select state
SCRATCH_WORDS = 4 + 3 * 1024  # TK_SCRATCH: u32 a segment
RANK_CTAS = 8  # TK_RANK_CTAS: from this many CTAs a segment, they rank
# Plan choices
TILE_BYTES = 26624  # a stage holds the rows that fit here (longer: plain loads)
# Keys a CTA keeps on chip (4224; at D = 100 two CTAs an SM still fit
# beside the ring); a CTA that owns more keeps them in device memory
KEYS_SMEM_BYTES = 33792
MIN_ROWS = 512  # fewest rows worth a CTA of their own
# The select stops once its candidates fit GATHER_Q * Q slots: 4 where the
# CTAs rank them, 1 where one CTA sorts them (its sort of 2Q keys took
# longer on an H100 than another select round)
GATHER_Q = {True: 4, False: 1}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pow2_floor(x: int) -> int:
    return 1 << (x.bit_length() - 1)


def block_rows(M: int, c: int, block_m: int) -> int:
    """Rows per block, as ``repro``'s ``scored_topk_kernel`` sizes them:
    ``block_m`` cut to M, in multiples of 128, and at least c."""
    bm = _round_up(min(block_m, _round_up(M, LANE)), LANE)
    return max(bm, _round_up(c, LANE))


class LaunchPlan(NamedTuple):
    """How one launch covers ``segs`` segments (:func:`launch_plan`)."""
    grid: int  # CTAs: segs * ctas_per_seg
    segs: int
    ctas_per_seg: int  # cooperative (co-resident) when above 1
    tile_rows: int  # rows of a tile; a CTA owns an even run of tiles
    stages: int  # ring stages; 0: rows by plain loads, no ring
    key_slots: int  # the most rows (keys) a CTA owns
    keys_on_chip: bool  # else in device memory
    gather: int  # candidate slots a segment: the select stops below them
    bits0: int  # round 0's radix digit (10, or 8 where 4 KB do not fit)
    smem_bytes: int  # dynamic shared memory a CTA
    scratch_bytes: int  # barrier words, candidates, device-memory keys


def _layout(D: int, c: int, dtype: torch.dtype):
    """(tile rows, stages, ring bytes, round 0's digit bits, fixed bytes,
    Q, the keys-on-chip budget in keys), Q the power of two >= c the
    final sort needs at least.  A tile is a multiple of 64 rows where it
    can be (every warp scores a group of 8), else of 8, else (a stage
    holds fewer than 8 rows: D past 832 float32, 1664 bf16) the rows one
    stage holds, most warps idle."""
    row = D * dtype.itemsize
    tile = TILE_BYTES // row
    for m in (ROWS_PER_CTA_PASS, 8):
        if tile >= m:
            tile -= tile % m
            break
    stages = STAGES if tile else 0
    ring = stages * (_round_up(tile * row, 16) + 16)
    Q = 1 << (c - 1).bit_length()
    for bits0 in (10, 8):  # a 1 KB histogram fits wherever the first K7 ran
        fixed = HEADER_BYTES + (4 << bits0) + _round_up(4 * D, 16)
        if fixed + max(ring, 8 * Q) <= MAX_SMEM_BYTES:
            break
    if fixed + 8 * Q > MAX_SMEM_BYTES:
        raise ValueError(
            f"c={c} with D={D}: the final sort of Q={Q} keys needs "
            f"{fixed + 8 * Q} bytes of shared memory, above the "
            f"{MAX_SMEM_BYTES} a block can hold: lower c"
        )
    budget = max(0, min(KEYS_SMEM_BYTES, MAX_SMEM_BYTES - fixed - ring)) // 8
    return tile or ROWS_PER_CTA_PASS, stages, ring, bits0, fixed, Q, budget


def _gather(Q: int, region: int, ranked: bool) -> int:
    """Candidate slots: up to GATHER_Q * Q where that many keys fit the
    region the ring and keys leave, at least Q."""
    return max(Q, min(GATHER_Q[ranked] * Q, _pow2_floor(max(region // 8, 1))))


def capacity_smem(D: int, c: int, dtype: torch.dtype) -> int:
    """The most dynamic shared memory :func:`launch_plan` gives a CTA for
    (D, c, dtype): the size at which to ask the card how many CTAs are
    co-resident (``capacity``), so every plan's grid is."""
    _, _, ring, _, fixed, Q, budget = _layout(D, c, dtype)
    region = ring + 8 * budget
    return fixed + max(region, 8 * _gather(Q, region, True))


def launch_plan(M: int, D: int, c: int, seg: int, dtype: torch.dtype,
                capacity: int) -> LaunchPlan:
    """The launch of K7 over ``ceil(M / seg)`` segments of ``seg`` rows
    (the last one's rows past M scored -inf), ``capacity`` the CTAs the
    card keeps co-resident at :func:`capacity_smem`.  Each segment gets
    an even share of the grid, at most one CTA per ``MIN_ROWS`` rows,
    each CTA an even run of the segment's tiles.  Raises ``ValueError``
    naming the shared-memory limit for a c whose final sort does not fit
    a block."""
    if dtype not in _DTYPES:
        raise TypeError(f"emb must be float32 or bfloat16, got {dtype}")
    if not 1 <= c <= seg:
        raise ValueError(f"need 1 <= c <= seg, got c={c}, seg={seg}")
    tile, stages, ring, bits0, fixed, Q, budget = _layout(D, c, dtype)
    segs = -(-M // seg)
    ntiles = -(-seg // tile)
    cps = max(1, min(capacity // segs, -(-seg // MIN_ROWS), ntiles))
    slots = -(-ntiles // cps) * tile
    on_chip = slots <= budget
    region = ring + (8 * slots if on_chip else 0)
    gather = _gather(Q, region, cps >= RANK_CTAS)
    smem = fixed + max(region, 8 * gather)
    scratch = ((4 * SCRATCH_WORDS + 8 * gather) * segs
               + (0 if on_chip else 8 * slots * segs * cps))
    return LaunchPlan(segs * cps, segs, cps, tile, stages, slots, on_chip,
                      gather, bits0, smem, scratch)


def _check_args(emb, query, c):
    if emb.ndim != 2 or query.shape != (emb.shape[1],):
        raise ValueError(
            f"emb must be (M, D) and query (D,), got {tuple(emb.shape)} and "
            f"{tuple(query.shape)}"
        )
    if c < 1:
        raise ValueError(f"c must be >= 1, got {c}")


def scored_topk_segments_plain(emb: torch.Tensor, query: torch.Tensor,
                               c: int, seg: int):
    """Plain version of K7: each segment's top-c of ``emb @ query`` by a
    stable descending sort, rows past M at -inf: (vals (segs, c) float32,
    idx (segs, c) int32).  With ``seg = M`` it is ``scored_topk_ref``."""
    _check_args(emb, query, c)
    if c > seg:
        raise ValueError(f"need c <= seg, got c={c}, seg={seg}")
    M = emb.shape[0]
    segs = -(-M // seg)
    s = torch.full((segs * seg,), float("-inf"), dtype=torch.float32,
                   device=emb.device)
    s[:M] = emb.to(torch.float32) @ query.to(torch.float32) + 0.0
    vals, pos = torch.sort(s.view(segs, seg), dim=1, descending=True,
                           stable=True)
    base = torch.arange(segs, device=emb.device)[:, None] * seg
    return vals[:, :c], (pos[:, :c] + base).to(torch.int32)


def scored_topk_blocks_plain(emb: torch.Tensor, query: torch.Tensor, c: int,
                             block_m: int = 8192):
    """:func:`scored_topk_segments_plain` over ``repro``'s blocks."""
    if block_m < 1:
        raise ValueError(f"block_m must be >= 1, got {block_m}")
    return scored_topk_segments_plain(
        emb, query, c, block_rows(emb.shape[0], c, block_m))


@functools.lru_cache(maxsize=None)
def _capacity(bf16: bool, smem: int, index: int) -> int:
    with torch.cuda.device(index):
        lib = cuda.library(_SRC, _SIGNATURES)
        cuda.raise_smem(lib, "scored_topk_set_smem", int(bf16), smem,
                        torch.device("cuda", index))
        n = ctypes.c_int(0)
        cuda.check(lib.scored_topk_capacity(int(bf16), smem, ctypes.byref(n)),
                   "scored_topk_capacity")
    return n.value


def plan_for(emb: torch.Tensor, c: int, seg: int) -> LaunchPlan:
    """:func:`launch_plan` for a CUDA ``emb``, its capacity queried once
    per card, dtype and size."""
    M, D = emb.shape
    index = emb.device.index
    if index is None:
        index = torch.cuda.current_device()
    return _plan(M, D, c, seg, emb.dtype, index, KEYS_SMEM_BYTES)


@functools.lru_cache(maxsize=256)
def _plan(M, D, c, seg, dtype, index, keys_smem_bytes):
    """The plan of one shape on card ``index``, with the kernel's
    shared-memory limit raised to it (``keys_smem_bytes`` keys the cache
    to the budget it was made under)."""
    bf16 = dtype == torch.bfloat16
    cap = _capacity(bf16, capacity_smem(D, c, dtype), index)
    plan = launch_plan(M, D, c, seg, dtype, cap)
    cuda.raise_smem(cuda.library(_SRC, _SIGNATURES), "scored_topk_set_smem",
                    int(bf16), plan.smem_bytes, torch.device("cuda", index))
    return plan


# Per (device, stream): the segments' barrier words, zeroed once and left
# zeroed by every launch, and their candidate slots; kept apart, since
# another call's segments put its slots where these words are.
_SCRATCH: dict = {}


def _scratch(device: torch.device, stream: int, plan: LaunchPlan):
    """(barrier words, candidate slots) pointers for one launch."""
    bar, cand = _SCRATCH.get((device, stream), (None, None))
    if bar is None or bar.numel() < SCRATCH_WORDS * plan.segs:
        bar = torch.zeros((SCRATCH_WORDS * plan.segs,), dtype=torch.int32,
                          device=device)
    if cand is None or cand.numel() < plan.gather * plan.segs:
        cand = torch.empty((plan.gather * plan.segs,), dtype=torch.int64,
                           device=device)
    _SCRATCH[(device, stream)] = bar, cand
    return bar.data_ptr(), cand.data_ptr()


@functools.lru_cache(maxsize=None)
def _kernel():
    """The launch function, bound once (looking the library up costs more
    host time than the launch itself)."""
    return cuda.library(_SRC, _SIGNATURES).scored_topk_launch


# cudaErrorCooperativeLaunchTooLarge: the grid cannot all be co-resident
_COOPERATIVE_TOO_LARGE = 720


def _launch(emb, query, c, seg, squeeze):
    """Check, plan and launch K7 on CUDA tensors: (vals, idx) of shape
    (segs, c), or (c,) when ``squeeze`` (one segment), allocated before
    the launch so that no op follows it."""
    _check_args(emb, query, c)
    if emb.dtype not in _DTYPES:
        raise TypeError(f"emb must be float32 or bfloat16, got {emb.dtype}")
    M, D = emb.shape
    cuda.require(emb, "emb", emb.dtype, (M, D))
    cuda.require(query, "query", emb.dtype, (D,))
    if M >= 2**31 - 1:
        raise ValueError(f"M={M} exceeds the kernel's 32-bit row ids")
    plan = plan_for(emb, c, seg)
    dev = emb.device
    shape = (c,) if squeeze else (plan.segs, c)
    vals = torch.empty(shape, dtype=torch.float32, device=dev)
    idx = torch.empty(shape, dtype=torch.int32, device=dev)
    keys = (None if plan.keys_on_chip else torch.empty(
        (plan.grid * plan.key_slots,), dtype=torch.int64, device=dev))
    stream = cuda.stream_ptr(emb)
    bar, cands = _scratch(dev, stream, plan)
    err = _kernel()(
        int(emb.dtype == torch.bfloat16), emb.data_ptr(), query.data_ptr(),
        vals.data_ptr(), idx.data_ptr(),
        None if keys is None else keys.data_ptr(), cands, bar,
        M, D, c, seg, plan.segs, plan.ctas_per_seg, plan.tile_rows,
        plan.stages, plan.gather, plan.key_slots, plan.bits0,
        plan.smem_bytes, stream,
    )
    if err == _COOPERATIVE_TOO_LARGE:
        raise ValueError(
            f"scored_topk: the grid of {plan.grid} CTAs ({plan.segs} "
            f"segments x {plan.ctas_per_seg}) cannot be co-resident for one "
            f"cooperative launch"
        )
    cuda.check(err, "scored_topk")
    cuda.count_launch("scored_topk")
    return vals, idx


def scored_topk_segments(emb: torch.Tensor, query: torch.Tensor, c: int,
                         seg: int):
    """K7: each segment's top-c of ``emb @ query`` in one launch.  emb
    (M, D) and query (D,), both float32 or both bfloat16 -> (vals
    (segs, c) float32, idx (segs, c) int32), each row in (value
    descending, lowest index first) order."""
    if emb.device.type == "cpu":
        return scored_topk_segments_plain(emb, query, c, seg)
    return _launch(emb, query, c, seg, squeeze=False)


def scored_topk_global(emb: torch.Tensor, query: torch.Tensor, c: int):
    """K7 over one segment of all M rows: the global top-c, (vals (c,),
    idx (c,)), straight from the launch."""
    if emb.device.type == "cpu":
        vals, idx = scored_topk_segments_plain(emb, query, c, emb.shape[0])
        return vals[0], idx[0]
    return _launch(emb, query, c, emb.shape[0], squeeze=True)


def scored_topk_blocks(emb: torch.Tensor, query: torch.Tensor, c: int,
                       block_m: int = 8192):
    """K7 in blocks mode: the block survivors of ``emb @ query``, the
    segments ``repro``'s ``scored_topk_kernel`` keeps its top-c of
    (:func:`block_rows`): (vals (nb, c) float32, idx (nb, c) int32)."""
    if block_m < 1:
        raise ValueError(f"block_m must be >= 1, got {block_m}")
    return scored_topk_segments(emb, query, c,
                                block_rows(emb.shape[0], c, block_m))
