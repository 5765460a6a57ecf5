"""CUDA launch-contract checker (rules cuda-coverage, cuda-alignment,
cuda-smem-budget, cuda-smem-model, cuda-cluster, cuda-coresidency,
autotune-cache-invalid): the port's counterpart of ``repro``'s Pallas
contract checker.

It never launches a kernel.  It drives the plan functions each wrapper
calls before a launch over a sweep of geometries — ``TilePolicy.decide``
through the tile ladder (``ops._resolve_tile_policy`` and, for the
chunk kernels, ``ops.resolve_chunk_tile``), ``tiling.resident_cluster``
(K1/K2), K7's ``scored_topk.launch_plan`` and K8's
``fm_interaction.fm_plan`` (its forward and backward) — and evaluates
each plan over its whole grid in plain Python:

* **coverage** — a lane's tiles (K3-K6), a user's cluster CTAs (K1/K2)
  or a segment's CTAs (K7, split as ``csrc/scored_topk.cu`` splits
  them) cover every column (row) exactly once, and no K7 CTA owns more
  rows than its key slots; K8's persistent blocks take every example
  exactly once;
* **alignment** — a tile is a warp multiple (``validate_tile_m``) or
  the whole M, a cluster slice 16-byte aligned, K7's block rows a
  multiple of 128 and its tiles groups of 8 rows (or, where a stage
  holds fewer, that many); every K8 bulk copy (``tile_copy``, for views
  0-3 elements into their storage) has a 16-byte-aligned source,
  destination and size inside its stage;
* **smem budget** — the bytes the launch gets (the wrapper module's own
  binding of the model) fit ``SMEM_BUDGET_BYTES`` (K8: its header, S
  stages and aux arrays, as ``fm_plan`` counts them);
* **cluster** — a policy cluster size lies in ``CLUSTER_SIZES`` (at most
  8, portable), 16 only where the source sets the non-portable
  attribute, and the card can place the cluster;
* **co-residency** — a cooperative launch (K5, K6, K7) has at most as
  many blocks as the card keeps co-resident at its shared memory (the
  hazard that takes the place of ``pallas-revisit-gap``: a CUDA block
  keeps no output block across grid steps, but a cooperative grid that
  does not co-reside is refused, or hangs at its barrier).

The capacities come from :class:`Capacities`: on the card the wrappers'
own occupancy queries (:func:`card_capacities`), on the CPU a model of
the H100 (:func:`model_capacities`) or any callables a caller gives.

**smem model** drives the wrappers themselves on a stand-in card
(:func:`_fake_card`: CPU tensors, the ``cuda`` helpers replaced by
recorders) at a small M, and holds the bytes each hands to
``cuda.raise_smem`` (K5/K6: to the launch, whose C entry raises the
limit) against ``tiling``'s model for that plan.

**autotune-cache-invalid** re-checks every persisted autotune entry
with the port's own re-check, ``autotune.tile_fits``, at the entry's M
bucket, lanes and the capacities given.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import inspect
import itertools
import os
from typing import Callable, Optional

from repro_torch.analysis.findings import Finding

# The geometries: repro's feature dims and state rows, the lanes a router
# or batch launch carries, candidate widths from a router bucket to the
# 10^6 pool, and the tile knob's three kinds (model, measured, explicit)
SWEEP_D = (8, 64, 256, 2048, 2560, 3072, 5376)
SWEEP_R = (8, 48, 128)
SWEEP_LANES = (1, 4, 32, 64)
SWEEP_M = (1000, 20_000, 65_536, 1_000_000)
SWEEP_TILE = (None, "auto", 256)
# K7: slate shortlists c, global (seg = M) and blocks mode, both dtypes
SWEEP_C = (1, 100, 1000)
TOPK_BLOCK_M = 8192
# the small M the wrappers are driven at for the smem-model rule
DRIVE_M = 2000
# K8: DeepFM's (39, 10) at its train batch and serve_p99's scored rows,
# other recsys widths, an odd F * D, one example past half a block; N
# below, at and past the grid, ragged; every block_b the tests use
SWEEP_FM_FD = ((39, 10), (26, 32), (4, 8), (13, 7), (400, 130), (1, 1))
SWEEP_FM_N = (1, 7, 100, 8191, 65_536)
SWEEP_FM_BLOCK_B = (32, 64, 128)
FM_SERVE_N = 1_024_000  # at (39, 10) and block_b 128 only
FM_OFFSETS = (0, 1, 2, 3)  # a view's elements into its storage
_FM_REGS = 40  # K8's most registers a thread (ptxas -v)

# An H100 SXM's occupancy model (the card's own queries replace it on the
# card): SMs, resident threads / blocks / registers an SM, shared memory
# an SM and the 1 KB the runtime reserves a block
H100_SMS = 132
_SM_THREADS, _SM_BLOCKS, _SM_REGS = 2048, 32, 65_536
_SM_SMEM, _BLOCK_RESERVED = 233_472, 1024
_KERNEL_THREADS = 256  # DPP_THREADS (csrc/common.cuh), TK_THREADS
# registers a thread: the most of the port's kernels by ptxas -v (K4-K6
# 128, K1/K2 95-182, K7 95 under __launch_bounds__(256, 2))
_KERNEL_REGS = 128
_PORTABLE_CLUSTER = 8
_NON_PORTABLE_ATTR = "cudaFuncAttributeNonPortableClusterSizeAllowed"

FAMILIES = ("resident_exact", "resident_windowed", "step_exact",
            "step_windowed", "chunk_exact", "chunk_windowed", "scored_topk",
            "fm_interaction")
COOPERATIVE = ("chunk_exact", "chunk_windowed", "scored_topk")


def _mod(name: str):
    """A kernel module by its name under ``repro_torch.kernels`` (the
    packages re-export functions named like their modules)."""
    return importlib.import_module(f"repro_torch.kernels.{name}")


def blocks_per_sm(smem: int, threads: int = _KERNEL_THREADS,
                  regs: int = _KERNEL_REGS) -> int:
    """Blocks of ``threads`` threads of ``regs`` registers at ``smem``
    bytes of dynamic shared memory one H100 SM holds at once."""
    return min(_SM_THREADS // threads, _SM_BLOCKS,
               _SM_REGS // (regs * threads),
               _SM_SMEM // (smem + _BLOCK_RESERVED))


@dataclasses.dataclass(frozen=True)
class Capacities:
    """What the card keeps co-resident, as the wrappers ask it.

    ``chunk(windowed)``: ``smem -> blocks`` of K5 (K6) or None;
    ``cluster(windowed)``: ``(s, smem, v_resident, state_resident) ->
    clusters`` of K1 (K2) or None; ``topk(dtype, smem)``: CTAs of K7
    (None: K7 is not checked for co-residency); ``device``: where the
    ``"auto"`` tile lookups key; ``fm(backward, dtype, smem)``: blocks of
    K8 (its backward), its plan's grid (None: the H100 model)."""

    chunk: Callable[[bool], Optional[Callable[[int], int]]]
    cluster: Callable[[bool], Optional[Callable[..., int]]]
    topk: Optional[Callable[[object, int], int]]
    device: object
    source: str
    # K8: (backward, dtype, smem) -> blocks co-resident (None: the model)
    fm: Optional[Callable[[bool, object, int], int]] = None


def model_capacities(sms: int = H100_SMS) -> Capacities:
    """The H100 occupancy model (``sms`` SMs): a cluster of ``s`` CTAs
    takes ``s`` block slots (GPC placement aside)."""
    import torch

    def chunk(windowed):
        return lambda smem: sms * blocks_per_sm(smem)

    def cluster(windowed):
        return lambda s, smem, vres, sres: sms * blocks_per_sm(smem) // s

    return Capacities(chunk, cluster,
                      lambda dtype, smem: sms * blocks_per_sm(smem),
                      torch.device("cpu"), f"H100 model, {sms} SMs")


def card_capacities(device) -> Capacities:
    """The occupancy queries the wrappers make on ``device``:
    ``tiled.capacity_fn`` (K5/K6), ``dpp_greedy.cluster_capacity``
    (K1/K2), ``scored_topk._capacity`` (K7) and
    ``fm_interaction._capacity`` (K8)."""
    import torch

    dpp_greedy, tiled = _mod("dpp_greedy.dpp_greedy"), _mod("dpp_greedy.tiled")
    scored_topk = _mod("scored_topk.scored_topk")
    fm = _mod("fm_interaction.fm_interaction")

    device = torch.device(device)
    index = (torch.cuda.current_device() if device.index is None
             else device.index)

    def cluster(windowed):
        return functools.partial(dpp_greedy.cluster_capacity, windowed,
                                 device=device)

    def topk(dtype, smem):
        return scored_topk._capacity(dtype == torch.bfloat16, smem, index)

    def fm_blocks(backward, dtype, smem):
        return fm._capacity(fm._WHICH[backward, dtype], fm.THREADS,
                            smem, index)

    return Capacities(lambda w: tiled.capacity_fn(w, device), cluster, topk,
                      device, f"card {torch.cuda.get_device_name(index)}",
                      fm_blocks)


# --------------------------------------------------------------------------
# Anchors
# --------------------------------------------------------------------------


def _anchor(obj) -> tuple[str, int]:
    """``(path relative to the working directory, line)`` of a function
    or class (a plan function or a wrapper: where a finding points)."""
    obj = inspect.unwrap(obj)
    path = os.path.relpath(inspect.getsourcefile(obj))
    return path, inspect.getsourcelines(obj)[1]


class _Report:
    """Findings deduplicated per (rule, anchor): the first geometry's
    message, with the count of the others."""

    def __init__(self):
        self._first: dict[tuple, Finding] = {}
        self._more: dict[tuple, int] = {}

    def add(self, anchor, rule: str, message: str) -> None:
        key = (rule, *anchor)
        if key in self._first:
            self._more[key] = self._more.get(key, 0) + 1
        else:
            self._first[key] = Finding(anchor[0], anchor[1], rule, message)

    def findings(self) -> list[Finding]:
        out = []
        for key, f in self._first.items():
            more = self._more.get(key, 0)
            if more:
                f = dataclasses.replace(
                    f, message=f"{f.message} (and {more} more geometries)")
            out.append(f)
        return out


# --------------------------------------------------------------------------
# Grid evaluation
# --------------------------------------------------------------------------


def span_gaps(spans: list[tuple[int, int]], n: int) -> Optional[str]:
    """None when the half-open ``spans`` cover ``[0, n)`` exactly once,
    else what is wrong (the first column left out, doubled or past n)."""
    pos = 0
    for lo, hi in sorted(s for s in spans if s[1] > s[0]):
        if lo > pos:
            return f"columns [{pos}, {lo}) never covered"
        if lo < pos:
            return f"columns [{lo}, {min(pos, hi)}) covered twice"
        pos = hi
    if pos < n:
        return f"columns [{pos}, {n}) never covered (the last tile missed)"
    if pos > n:
        return f"columns [{n}, {pos}) past M={n} covered"
    return None


def _tile_spans(M: int, tile: int, nt: int) -> list[tuple[int, int]]:
    return [(i * tile, min((i + 1) * tile, M)) for i in range(nt)]


def _topk_cta_rows(ntiles: int, cps: int, tile_rows: int, seg: int):
    """Each CTA's rows of one segment, split as ``csrc/scored_topk.cu``
    splits its tiles (``t_lo = ntiles * part / cps``)."""
    out = []
    for part in range(cps):
        t_lo, t_hi = ntiles * part // cps, ntiles * (part + 1) // cps
        out.append((min(t_lo * tile_rows, seg), min(t_hi * tile_rows, seg)))
    return out


@dataclasses.dataclass
class _Family:
    """One family's sweep tally for the summary."""

    geometries: int = 0
    refused: int = 0
    largest_grid: int = 0
    capacity_at_largest: Optional[int] = None
    seen: set = dataclasses.field(default_factory=set)

    def count(self, key, blocks: int, capacity: Optional[int]) -> bool:
        if key in self.seen:
            return False
        self.seen.add(key)
        self.geometries += 1
        if blocks > self.largest_grid:
            self.largest_grid, self.capacity_at_largest = blocks, capacity
        return True


# --------------------------------------------------------------------------
# The sweep
# --------------------------------------------------------------------------


def _sweep_dpp(caps: Capacities, report: _Report,
               fams: dict[str, _Family]) -> None:
    dpp_greedy, ops = _mod("dpp_greedy.dpp_greedy"), _mod("dpp_greedy.ops")
    tiled, tiling = _mod("dpp_greedy.tiled"), _mod("dpp_greedy.tiling")

    res_anchor = _anchor(tiling.resident_cluster)
    step_anchor = _anchor(tiling.TilePolicy.decide)
    chunk_anchor = _anchor(tiling.TilePolicy._decide_chunked)
    budget = tiling.SMEM_BUDGET_BYTES
    if max(tiling.CLUSTER_SIZES) > _PORTABLE_CLUSTER:
        src = inspect.getsourcefile(dpp_greedy).replace(
            "dpp_greedy.py", os.path.join("csrc", "dpp_greedy.cu"))
        with open(src, encoding="utf-8") as fh:
            if _NON_PORTABLE_ATTR not in fh.read():
                report.add(res_anchor, "cuda-cluster",
                           f"CLUSTER_SIZES {tiling.CLUSTER_SIZES} holds a "
                           f"size past {_PORTABLE_CLUSTER} but "
                           f"csrc/dpp_greedy.cu never sets "
                           f"{_NON_PORTABLE_ATTR}: the card refuses it")

    for windowed, D, R, M, lanes in itertools.product(
            (False, True), SWEEP_D, SWEEP_R, SWEEP_M, SWEEP_LANES):
        geom = (f"D={D}, M={M}, {R} state rows, windowed={windowed}, "
                f"lanes={lanes}")
        kind = "windowed" if windowed else "exact"
        for knob in SWEEP_TILE:
            # K1-K4: the whole-slate dispatch (ops.dpp_greedy)
            try:
                mode, tm = ops._resolve_tile_policy(knob, None).decide(
                    D, M, R, windowed, lanes=lanes, device=caps.device)
            except ValueError:
                fams[f"step_{kind}"].refused += 1
                mode = None
            if mode == "resident":
                _check_resident(dpp_greedy, tiling, caps, report, fams,
                                res_anchor, windowed, D, R, M, lanes, geom,
                                budget)
            elif mode == "tiled":
                _check_step(tiled, tiling, report, fams, step_anchor,
                            windowed, D, R, M, lanes, tm, geom, budget)
            # K5/K6: the streaming, slot and session chunks (ops._stream_tile)
            _check_chunk(ops, tiled, tiling, caps, report, fams,
                         chunk_anchor, windowed, D, R, M, lanes, knob, geom,
                         budget)


def _check_resident(dpp_greedy, tiling, caps, report, fams, anchor,
                    windowed, D, R, M, lanes, geom, budget) -> None:
    fam = fams["resident_windowed" if windowed else "resident_exact"]
    cap = caps.cluster(windowed)
    try:
        s, vres, sres = tiling.resident_cluster(D, M, R, windowed, lanes,
                                                cap)
    except ValueError as e:
        report.add(anchor, "cuda-smem-budget",
                   f"TilePolicy calls {geom} resident, but no cluster "
                   f"layout fits: {e}")
        return
    # the bytes and slice the launch gets (dpp_greedy._launch's bindings)
    smem = dpp_greedy.cluster_smem_bytes(D, M, R, windowed, s, vres, sres)
    tile = dpp_greedy.cluster_tile(M, s)
    placed = None if cap is None else cap(s, smem, vres, sres)
    if not fam.count((D, R, M, lanes, s, vres, sres), lanes * s, None):
        return
    geom = (f"{geom}: clusters of {s} CTAs of {tile} columns, V resident "
            f"{vres}, state resident {sres}")
    if s not in tiling.CLUSTER_SIZES or s > _PORTABLE_CLUSTER:
        report.add(anchor, "cuda-cluster",
                   f"cluster of {s} CTAs outside the portable sizes "
                   f"{tiling.CLUSTER_SIZES} ({geom})")
    if placed is not None and placed < 1:
        report.add(anchor, "cuda-cluster",
                   f"the card cannot place one cluster ({geom}, {smem} B "
                   f"a CTA)")
    gap = span_gaps(_tile_spans(M, tile, s), M)
    if gap:
        report.add(anchor, "cuda-coverage", f"{gap} ({geom})")
    if tile % 4:
        report.add(anchor, "cuda-alignment",
                   f"cluster slice of {tile} columns is not 16-byte "
                   f"aligned ({geom})")
    if smem > budget:
        report.add(anchor, "cuda-smem-budget",
                   f"{smem} B of shared memory a CTA, over the {budget} B "
                   f"budget ({geom})")


def _check_step(tiled, tiling, report, fams, anchor, windowed, D, R, M,
                lanes, tm, geom, budget) -> None:
    fam = fams["step_windowed" if windowed else "step_exact"]
    nt = tiled.tile_count(M, tm)
    if not fam.count((D, R, M, lanes, tm), lanes * nt, None):
        return
    geom = f"{geom}: tile_m={tm}, {nt} tiles a lane"
    try:
        tiling.validate_tile_m(tm)
    except ValueError:
        report.add(anchor, "cuda-alignment",
                   f"tile_m={tm} is not a multiple of the {tiling.WARP}-"
                   f"thread warp ({geom})")
    gap = span_gaps(_tile_spans(M, tm, nt), M)
    if gap:
        report.add(anchor, "cuda-coverage", f"{gap} ({geom})")
    for what, smem in (("a tiled step", tiled.tiled_smem_bytes(D, R,
                                                                windowed)),
                       ("an update entry", tiled.update_smem_bytes(
                           D, R, windowed))):
        if smem > budget:
            report.add(anchor, "cuda-smem-budget",
                       f"{smem} B of shared memory a block of {what}, over "
                       f"the {budget} B budget ({geom})")


def _check_chunk(ops, tiled, tiling, caps, report, fams, anchor, windowed,
                 D, R, M, lanes, knob, geom, budget) -> None:
    fam = fams["chunk_windowed" if windowed else "chunk_exact"]
    cap = caps.chunk(windowed)
    try:
        tm = ops.resolve_chunk_tile(D, M, R, windowed, lanes, cap,
                                    caps.device, knob)
        mode, tm, vres = tiling.TilePolicy(tile_m=tm).decide(
            D, M, R, windowed, chunked=True, lanes=lanes, capacity=cap)
    except ValueError:
        fam.refused += 1  # the router (check_slots) refuses such slots
        return
    tile = M if mode == "resident" else min(tm, M)
    nt = tiled.tile_count(M, tile)
    smem = tiled.chunk_smem_bytes(D, tile, R, windowed, vres)
    blocks = lanes * nt
    co = None if cap is None else cap(smem)
    if not fam.count((D, R, M, lanes, tile, vres), blocks, co):
        return
    geom = (f"{geom}: tile {tile}, {nt} tiles a lane, V resident {vres}, "
            f"{smem} B a block")
    if tile != M:
        try:
            tiling.validate_tile_m(tile)
        except ValueError:
            report.add(anchor, "cuda-alignment",
                       f"chunk tile {tile} is neither the whole M nor a "
                       f"multiple of the {tiling.WARP}-thread warp ({geom})")
    gap = span_gaps(_tile_spans(M, tile, nt), M)
    if gap:
        report.add(anchor, "cuda-coverage", f"{gap} ({geom})")
    if smem > budget:
        report.add(anchor, "cuda-smem-budget",
                   f"{smem} B of shared memory a block, over the {budget} B "
                   f"budget ({geom})")
    if co is not None and blocks > co:
        report.add(anchor, "cuda-coresidency",
                   f"cooperative grid of {blocks} blocks past the {co} the "
                   f"card keeps co-resident ({geom})")


def _sweep_topk(caps: Capacities, report: _Report,
                fams: dict[str, _Family]) -> None:
    import torch

    from repro_torch.kernels.dpp_greedy.tiling import SMEM_BUDGET_BYTES
    tk = _mod("scored_topk.scored_topk")

    anchor = _anchor(tk.launch_plan)
    fam = fams["scored_topk"]
    budget = min(tk.MAX_SMEM_BYTES, SMEM_BUDGET_BYTES)
    for dtype, D, M, c, blocks_mode in itertools.product(
            (torch.float32, torch.bfloat16), SWEEP_D, SWEEP_M, SWEEP_C,
            (False, True)):
        seg = tk.block_rows(M, c, TOPK_BLOCK_M) if blocks_mode else M
        if c > seg:
            continue
        qsmem = tk.capacity_smem(D, c, dtype)
        cap = (H100_SMS * blocks_per_sm(qsmem) if caps.topk is None
               else caps.topk(dtype, qsmem))
        try:
            plan = tk.launch_plan(M, D, c, seg, dtype, cap)
        except ValueError:
            fam.refused += 1
            continue
        co = plan.ctas_per_seg > 1
        if not fam.count((dtype, D, M, c, seg), plan.grid,
                         cap if co else None):
            continue
        geom = (f"M={M}, D={D}, c={c}, seg={seg}, {dtype}: {plan.segs} "
                f"segments x {plan.ctas_per_seg} CTAs of {plan.tile_rows}-"
                f"row tiles, {plan.smem_bytes} B a CTA")
        if blocks_mode and seg % tk.LANE:
            report.add(anchor, "cuda-alignment",
                       f"block rows {seg} not a multiple of {tk.LANE} "
                       f"({geom})")
        # a stage too short for 8 rows (the LM widths) holds as many as
        # fit: the plan's fallback, whose partial group score_rows guards
        short = tk.TILE_BYTES // (D * dtype.itemsize)
        if plan.tile_rows % 8 and not (plan.stages and
                                       plan.tile_rows == short < 8):
            report.add(anchor, "cuda-alignment",
                       f"tile of {plan.tile_rows} rows is not a multiple "
                       f"of a warp's group of 8 ({geom})")
        gap = span_gaps([(s * seg, min((s + 1) * seg, plan.segs * seg))
                         for s in range(plan.segs)], plan.segs * seg)
        if gap is None and not (plan.segs * seg >= M
                                > (plan.segs - 1) * seg):
            gap = f"{plan.segs} segments of {seg} rows for M={M}"
        ntiles = -(-seg // plan.tile_rows)
        rows = _topk_cta_rows(ntiles, plan.ctas_per_seg, plan.tile_rows,
                              seg)
        gap = gap or span_gaps(rows, seg)
        if gap:
            report.add(anchor, "cuda-coverage", f"{gap} ({geom})")
        most = max(hi - lo for lo, hi in rows)
        if most > plan.key_slots:
            report.add(anchor, "cuda-coverage",
                       f"a CTA owns {most} rows but has {plan.key_slots} key "
                       f"slots ({geom})")
        if plan.smem_bytes > budget:
            report.add(anchor, "cuda-smem-budget",
                       f"{plan.smem_bytes} B of shared memory a CTA, over "
                       f"the {budget} B budget ({geom})")
        if co and (plan.grid > cap or plan.smem_bytes > qsmem):
            report.add(anchor, "cuda-coresidency",
                       f"cooperative grid of {plan.grid} CTAs at "
                       f"{plan.smem_bytes} B against {cap} co-resident at "
                       f"the {qsmem} B the card was asked about ({geom})")


def _sweep_fm(caps: Capacities, report: _Report,
              fams: dict[str, _Family]) -> None:
    """K8 and its backward: ``fm_plan`` over the sweep, its blocks' tiles
    against the examples, its bulk copies against their stages, its
    shared memory against the budget."""
    import torch

    from repro_torch.kernels.dpp_greedy.tiling import SMEM_BUDGET_BYTES
    fm = _mod("fm_interaction.fm_interaction")

    anchor = _anchor(fm.fm_plan)
    fam = fams["fm_interaction"]
    geoms = [(N, F, D, b) for (F, D), N, b in itertools.product(
        SWEEP_FM_FD, SWEEP_FM_N, SWEEP_FM_BLOCK_B)]
    geoms.append((FM_SERVE_N, 39, 10, 128))
    for (N, F, D, block_b), dtype, backward in itertools.product(
            geoms, (torch.float32, torch.bfloat16), (False, True)):
        try:
            T0, S, stage, smem = fm.fm_layout(F, D, dtype, block_b)
        except ValueError:
            fam.refused += 1
            continue
        cap = (H100_SMS * blocks_per_sm(smem, fm.THREADS, _FM_REGS)
               if caps.fm is None else caps.fm(backward, dtype, smem))
        if cap < 1:
            report.add(anchor, "cuda-smem-budget",
                       f"no block of {smem} B fits an SM (N={N}, F={F}, "
                       f"D={D}, {dtype}, block_b={block_b})")
            continue
        plan = fm.fm_plan(N, F, D, dtype, block_b, cap)
        if not fam.count((N, F, D, dtype, block_b, backward), plan.grid,
                         None):
            continue
        geom = (f"{'backward, ' if backward else ''}N={N}, F={F}, D={D}, "
                f"{dtype}, block_b={block_b}: T={plan.tile}, S={S} stages "
                f"of {stage} B, {smem} B a block, grid {plan.grid} of "
                f"{plan.tiles} tiles")
        # coverage: the blocks' tiles, and the tiles' examples
        spans = [(t * plan.tile, min((t + 1) * plan.tile, N))
                 for b in range(plan.grid) for t in fm.block_tiles(plan, b)]
        gap = span_gaps(spans, N)
        if gap is None and not 0 < plan.grid <= plan.tiles:
            gap = f"a grid of {plan.grid} blocks for {plan.tiles} tiles"
        if gap is None and plan.tile > T0:
            gap = f"tiles of {plan.tile} past the stage's {T0} examples"
        if gap:
            report.add(anchor, "cuda-coverage",
                       f"{gap.replace('columns', 'examples')} ({geom})")
        # alignment: the tiles' copies (their offsets repeat every 16
        # tiles: the first 16 and the last)
        ex = F * D * dtype.itemsize
        tiles = sorted({*range(min(plan.tiles, 16)), plan.tiles - 1})
        for off, t in itertools.product(FM_OFFSETS, tiles if S else ()):
            c = fm.tile_copy(plan, N, F, D, dtype.itemsize,
                             off * dtype.itemsize, t)
            nt = min(plan.tile, N - t * plan.tile)
            end = (off * dtype.itemsize + t * plan.tile * ex) % 16 + nt * ex
            if (c.size and (c.src % 16 or c.dst % 16) or c.size % 16
                    or c.dst + c.size > stage or end > stage
                    or c.size + c.plain * dtype.itemsize != nt * ex):
                report.add(anchor, "cuda-alignment",
                           f"tile {t} of a view {off} elements into its "
                           f"storage: bulk copy of {c.size} B from byte "
                           f"{c.src} to stage byte {c.dst}, {c.plain} "
                           f"elements by plain loads ({geom})")
        # smem: the layout, counted again, within the budget
        want = fm.HEADER_BYTES * (S > 0) + S * stage + 8 * T0 * D
        if (smem != want or smem > SMEM_BUDGET_BYTES
                or S > fm.MAX_STAGES):
            report.add(anchor, "cuda-smem-budget",
                       f"{smem} B of shared memory a block ({want} B by its "
                       f"parts), budget {SMEM_BUDGET_BYTES} B ({geom})")


# --------------------------------------------------------------------------
# smem model: the wrappers on a stand-in card
# --------------------------------------------------------------------------


class _Recorder:
    """Stands in for a loaded kernel library and ``cuda.raise_smem``:
    every call is logged, every launch entry returns 0 (cudaSuccess), an
    occupancy query raises."""

    def __init__(self):
        self.log: list[tuple] = []

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)

        def entry(*args):
            if name.endswith("_capacity"):
                # an occupancy answer from here would be memoized by the
                # wrappers as the card's: ask the card before, not here
                raise RuntimeError(f"{name} asked of the stand-in card")
            self.log.append((name, args))
            return 0

        return entry

    def raise_smem(self, lib, setter, which, smem, device):
        self.log.append(("raise_smem", (setter, which, smem)))

    def take(self) -> list[tuple]:
        out, self.log = self.log, []
        return out


@contextlib.contextmanager
def _fake_card():
    """The kernel wrappers' CUDA paths on CPU tensors: the operand checks,
    library loads, stream and launch counting replaced, every launch and
    shared-memory raise recorded.  Restored on exit."""
    from repro_torch.kernels import cuda
    dpp_greedy, tiled = _mod("dpp_greedy.dpp_greedy"), _mod("dpp_greedy.tiled")

    rec = _Recorder()
    patches = [
        (cuda, "library", lambda src, sigs: rec),
        (cuda, "raise_smem", rec.raise_smem),
        (cuda, "require", lambda *a, **k: None),
        (cuda, "stream_ptr", lambda t: 0),
        (cuda, "count_launch", lambda name: None),
        (dpp_greedy, "_cpu_or_cuda", lambda t: True),
        (tiled, "_cpu_or_cuda", lambda t: True),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, value in patches:
            setattr(mod, name, value)
        yield rec
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def _raised(log) -> list[int]:
    return [args[2] for name, args in log if name == "raise_smem"]


def _check_smem_model(caps: Capacities, report: _Report) -> int:
    """Drive every wrapper at ``DRIVE_M`` columns; returns the launches
    driven."""
    import torch

    dpp_greedy, tiled = _mod("dpp_greedy.dpp_greedy"), _mod("dpp_greedy.tiled")
    tiling = _mod("dpp_greedy.tiling")
    from repro_torch.kernels.dpp_greedy.tiling import ClusterPlan
    tk = _mod("scored_topk.scored_topk")

    M, budget, driven = DRIVE_M, tiling.SMEM_BUDGET_BYTES, 0
    f32, i32, i64 = torch.float32, torch.int32, torch.int64

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype)

    def hold(anchor, got, want, geom):
        if got != [want]:
            report.add(anchor, "cuda-smem-model",
                       f"the wrapper hands {got} B for its launch, the "
                       f"tiling model counts {want} B ({geom})")

    # every capacity the drive needs, asked before the stand-in card
    # replaces the library the card's occupancy queries go through (and
    # whose answers the wrappers memoize)
    chunk_plans = {}  # None: the policy refuses K5/K6 there
    for windowed, D, R in itertools.product((False, True), SWEEP_D, SWEEP_R):
        try:
            mode, tm, vres = tiling.TilePolicy().decide(
                D, M, R, windowed, chunked=True, lanes=1,
                capacity=caps.chunk(windowed))
        except ValueError:
            chunk_plans[windowed, D, R] = None
            continue
        chunk_plans[windowed, D, R] = (M if mode == "resident"
                                       else min(tm, M)), vres
    topk_caps = {}
    for dtype, D, c in itertools.product((torch.float32, torch.bfloat16),
                                         SWEEP_D, SWEEP_C):
        qsmem = tk.capacity_smem(D, c, dtype)
        topk_caps[dtype, D, c] = (H100_SMS * blocks_per_sm(qsmem)
                                  if caps.topk is None
                                  else caps.topk(dtype, qsmem))

    with _fake_card() as rec:
        for windowed, D, R in itertools.product((False, True), SWEEP_D,
                                                SWEEP_R):
            kind = "windowed" if windowed else "exact"
            k = 2 * R if windowed else R
            V, d2 = z(1, D, M), z(1, M)
            # K1 / K2 at every cluster layout that fits
            anchor = _anchor(dpp_greedy._launch)
            for s, vres, sres in itertools.product(
                    tiling.CLUSTER_SIZES, (True, False), (True, False)):
                want = tiling.cluster_smem_bytes(D, M, R, windowed, s, vres,
                                                 sres)
                if want > budget:
                    continue
                dpp_greedy._launch(windowed, V, d2, k, R if windowed
                                   else None, 1e-3,
                                   ClusterPlan(s, vres, sres), None)
                log = rec.take()
                geom = (f"K{2 if windowed else 1}, D={D}, M={M}, R={R}, "
                        f"clusters of {s}, V resident {vres}, state "
                        f"resident {sres}")
                hold(anchor, _raised(log), want, geom)
                launch = [a for n, a in log if n.startswith("dpp_resident")]
                tile = tiling.cluster_tile(M, s)
                # (..., [w,] s, tile, v_res, s_res, eps2, smem, stream)
                if not launch or launch[0][-2] != want or \
                        launch[0][-6] != tile:
                    report.add(anchor, "cuda-smem-model",
                               f"the launch gets other bytes or another "
                               f"slice than the model's {want} B / {tile} "
                               f"columns ({geom})")
                driven += 1
            # K3 / K4 per-step launcher
            anchor = _anchor(tiled.step_launcher)
            keys, flags = z(k + 1, 1, dtype=i64), z(k + 1, 1, dtype=i32)
            sel, dh = z(1, k, dtype=i32), z(1, k)
            for tm in (256, tiling.DEFAULT_TILE_M):
                C = z(1, R, M)
                ops_ = (V, C, d2, keys, flags, sel, dh)
                if windowed:
                    nt = tiling.tile_count(M, tm)
                    ops_ += (z(2, 1, R, dtype=i32), z(2, 1, nt, R),
                             z(2, 1, R, R))
                tiled.step_launcher(f"tiled_step_{kind}", ops_, 1e-3, tm)
                hold(anchor, _raised(rec.take()),
                     tiling.tiled_smem_bytes(D, R, windowed),
                     f"K{4 if windowed else 3}, D={D}, R={R}, tile {tm}")
                driven += 1
            # the shard-local update entries of K3 / K4
            anchor = _anchor(tiled.update_launcher)
            head = (V, z(1, R, M), d2, z(1, D), z(1, R), z(1),
                    z(1, dtype=torch.bool))
            ops_ = (head + (z(1, dtype=torch.bool), z(1, R - 1),
                            z(1, R - 1), z(1, dtype=i64), z(1, dtype=i32))
                    if windowed else head + (z(1, dtype=i64),
                                             z(1, dtype=i32)))
            tiled.update_launcher(ops_, 0, z(2, 1, dtype=i64),
                                  tiling.DEFAULT_TILE_M)
            hold(anchor, _raised(rec.take()),
                 tiling.update_smem_bytes(D, R, windowed),
                 f"update entry {kind}, D={D}, R={R}")
            driven += 1
            # K5 / K6 at the policy's tile, V resident and streamed
            anchor = _anchor(tiled.chunk_launcher)
            if chunk_plans[windowed, D, R] is None:
                continue
            tile, vres = chunk_plans[windowed, D, R]
            for v in {vres, False}:
                want = tiling.chunk_smem_bytes(D, tile, R, windowed, v)
                if want > budget:
                    continue
                win = z(1, R, dtype=i32) if windowed else None
                tiled.chunk_launcher(V, z(1, R, M), d2, z(1, dtype=i32),
                                     z(1, dtype=torch.bool), win, 4, 1e-3,
                                     tile, v)()
                launch = [a for n, a in rec.take()
                          if n.startswith("fused_chunk")]
                hold(anchor, [a[-2] for a in launch], want,
                     f"K{6 if windowed else 5}, D={D}, R={R}, tile {tile}, "
                     f"V resident {v}")
                driven += 1
        # K7: the plan's raise against launch_plan's bytes
        anchor = _anchor(tk._plan)
        for (dtype, D, c), cap in topk_caps.items():
            saved = tk._capacity
            tk._capacity = lambda bf16, smem, index: cap
            try:
                plan = tk._plan.__wrapped__(M, D, c, M, dtype, 0,
                                            tk.KEYS_SMEM_BYTES)
            except ValueError:
                continue
            finally:
                tk._capacity = saved
            hold(anchor, _raised(rec.take()),
                 tk.launch_plan(M, D, c, M, dtype, cap).smem_bytes,
                 f"K7, M={M}, D={D}, c={c}, {dtype}")
            driven += plan.grid > 0
    return driven


# --------------------------------------------------------------------------
# Autotune cache validation (rule autotune-cache-invalid)
# --------------------------------------------------------------------------

_ENTRY_FIELDS = (
    ("D", int), ("M_bucket", int), ("state_rows", int), ("tile_m", int),
    ("windowed", bool), ("chunked", bool),
)


def _why_unfit(tm, D, M, R, windowed, chunked, lanes, cap) -> str:
    """Which of ``autotune.tile_fits``' conditions ``tm`` fails."""
    from repro_torch.kernels.dpp_greedy.tiling import (
        SMEM_BUDGET_BYTES,
        WARP,
        chunk_smem_bytes,
        tile_count,
        tiled_smem_bytes,
    )

    if tm < WARP or tm % WARP:
        return f"tile_m {tm} is not a positive multiple of the {WARP}-" \
               f"thread warp"
    cols = min(tm, M)
    smem = (chunk_smem_bytes(D, cols, R, windowed) if chunked
            else tiled_smem_bytes(D, R, windowed))
    if smem > SMEM_BUDGET_BYTES:
        return (f"{smem} B of shared memory a block, over the "
                f"{SMEM_BUDGET_BYTES} B budget")
    return (f"a cooperative grid of {lanes * tile_count(M, cols)} blocks "
            f"past the {cap(smem)} the card keeps co-resident")


def check_autotune_cache(
    path: Optional[str] = None, capacities: Optional[Capacities] = None,
) -> tuple[list[Finding], dict]:
    """Re-check every persisted autotune entry.

    The lookup ladder already degrades an out-of-contract entry to a
    miss at serving time; this makes the contract a fact about the file
    itself, so a stale or hand-edited cache is repaired at review time
    instead of silently falling back.  Per entry: typed fields; an M
    bucket the ladder can match (a power of two >= ``BUCKET_FLOOR``); a
    key that reproduces from the entry's own fields; and
    ``autotune.tile_fits`` at its bucket, lanes and ``capacities``."""
    import json

    autotune = _mod("dpp_greedy.autotune")

    caps = capacities or model_capacities()
    path = path or autotune.active_cache_path()
    summary = {"path": path, "present": False, "entries": 0, "checked": 0}
    if not os.path.exists(path):
        return [], summary
    summary["present"] = True

    def finding(msg: str) -> Finding:
        return Finding(path, 1, "autotune-cache-invalid", msg)

    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, UnicodeDecodeError, ValueError) as e:
        return [finding(f"cache file is not parseable JSON ({e})")], summary
    if not isinstance(doc, dict) or not isinstance(doc.get("entries"), dict):
        return [finding("cache document must be an object with an "
                        "'entries' mapping")], summary
    if doc.get("schema") != autotune.SCHEMA_VERSION:
        return [finding(
            f"cache schema {doc.get('schema')!r} != supported "
            f"{autotune.SCHEMA_VERSION}: re-run python -m "
            f"repro_torch.kernels.autotune"
        )], summary

    findings: list[Finding] = []
    entries = doc["entries"]
    summary["entries"] = len(entries)
    for key, e in sorted(entries.items()):
        if not isinstance(e, dict):
            findings.append(finding(f"entry {key!r} is not an object"))
            continue
        bad = False
        for name, typ in _ENTRY_FIELDS:
            v = e.get(name)
            if not isinstance(v, typ) or (typ is int and isinstance(v, bool)):
                findings.append(finding(
                    f"entry {key!r}: field {name!r} must be "
                    f"{typ.__name__}, got {v!r}"))
                bad = True
        lanes = e.get("lanes", 1)
        if not isinstance(lanes, int) or lanes < 1 or lanes & (lanes - 1):
            findings.append(finding(
                f"entry {key!r}: lanes {lanes!r} is not a power-of-two "
                f"lanes bucket"))
            bad = True
        if bad:
            continue
        D, mb, R = e["D"], e["M_bucket"], e["state_rows"]
        tm, windowed, chunked = e["tile_m"], e["windowed"], e["chunked"]
        summary["checked"] += 1
        if mb < autotune.BUCKET_FLOOR or mb & (mb - 1):
            findings.append(finding(
                f"entry {key!r}: M_bucket {mb} is not a power of two >= "
                f"{autotune.BUCKET_FLOOR} (the lookup never matches it)"))
        expect = autotune.cache_key(
            e.get("device_kind"), e.get("platform"), e.get("backend"),
            D, mb, R, windowed, chunked, lanes)
        if key != expect:
            findings.append(finding(
                f"entry key {key!r} does not reproduce from its own fields "
                f"({expect!r}): hand-edited or corrupted; the lookup never "
                f"matches it"))
        cap = caps.chunk(windowed) if chunked else None
        if not autotune.tile_fits(tm, D, mb, R, windowed, chunked, lanes,
                                  cap):
            findings.append(finding(
                f"entry {key!r}: tile_m={tm} at D={D}, M_bucket={mb}, "
                f"R={R}, windowed={windowed}, chunked={chunked}, "
                f"lanes={lanes}: "
                + _why_unfit(tm, D, mb, R, windowed, chunked, lanes, cap)))
    return findings, summary


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------


def check_kernel_contracts(
    capacities: Optional[Capacities] = None,
) -> tuple[list[Finding], dict]:
    """Sweep every plan of K1-K8, check it, and drive the wrappers for
    the smem model.  ``capacities`` default to :func:`model_capacities`.
    Returns (findings, summary): per family the distinct plans checked,
    the requests (a geometry at one tile knob) the policy refuses (such a
    request raises before any launch) and, for the cooperative families,
    the largest grid beside what the card keeps co-resident at its shared
    memory."""
    caps = capacities or model_capacities()
    report = _Report()
    fams = {name: _Family() for name in FAMILIES}
    _sweep_dpp(caps, report, fams)
    _sweep_topk(caps, report, fams)
    _sweep_fm(caps, report, fams)
    driven = _check_smem_model(caps, report)
    summary = {
        "capacities": caps.source,
        "families": sorted(FAMILIES),
        "geometries": sum(f.geometries for f in fams.values()),
        "per_family": {
            name: {"geometries": f.geometries, "refused": f.refused,
                   **({"largest_grid": f.largest_grid,
                       "co_resident": f.capacity_at_largest}
                      if name in COOPERATIVE else {})}
            for name, f in fams.items()
        },
        "wrapper_launches_driven": driven,
    }
    return report.findings(), summary
