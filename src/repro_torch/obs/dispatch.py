"""Dispatch and rebuild telemetry: which greedy path actually ran, and
what the port re-specialised.

Two halves:

* **Rebuild monitoring** — the counterpart of ``repro``'s
  ``CompileMonitor``.  Where JAX re-specialises by compiling a new
  program for a new shape, the port re-specialises in three ways, each
  counted here: an ``nvcc`` build of a kernel source
  (``kernel_builds_total``), a load of a built kernel library
  (``kernel_module_loads_total``, both from
  ``repro_torch.kernels.cuda``) and an allocation of a slot-batched
  greedy state (``slot_state_allocs_total``, from
  ``core.streaming.greedy_slots_init``: the router's device geometry).
  :class:`RebuildMonitor` brackets a warmup with ``mark()`` /
  ``since_mark()``: "the router never rebuilds after warmup" is
  ``since_mark() == 0`` (``launch.serve_router``'s
  ``rebuilds_after_warmup``).
* **Dispatch recording** — small helpers the greedy dispatch layers call
  to count the kernel execution mode ``kernels/dpp_greedy/ops.py``
  picked (resident / tiled, and the ``TilePolicy`` tile and
  shared-memory numbers behind it), the backend ``greedy_map`` routed
  to, the resumable chunk launches of the streaming layer, the
  launched work in greedy steps and per-step marginal evaluations, the
  session layer's delta updates, evictions and device footprint
  (``repro_torch.serving.session``), and the tile_m precedence ladder
  with its measured-autotune lookups (``kernels/dpp_greedy/autotune.py``).

All helpers no-op (one global read) when observability is disabled and
consume only shapes and config.
"""
from __future__ import annotations

from typing import Optional

import repro_torch.obs as _obs

REBUILD_COUNTERS = (
    "kernel_builds_total",
    "kernel_module_loads_total",
    "slot_state_allocs_total",
)


def record_kernel_build(source: str) -> None:
    """One ``nvcc`` build of the kernel source ``source``."""
    reg = _obs.registry()
    if reg is None:
        return
    reg.counter(
        "kernel_builds_total", "kernel sources compiled by nvcc"
    ).inc(source=source)


def record_module_load(source: str) -> None:
    """One load of the built library of ``source`` into the process."""
    reg = _obs.registry()
    if reg is None:
        return
    reg.counter(
        "kernel_module_loads_total", "built kernel libraries loaded"
    ).inc(source=source)


def record_slot_state_alloc(*, slots: int, M: int) -> None:
    """One slot-batched greedy state of ``slots`` lanes over ``M``
    candidate columns allocated (``greedy_slots_init``)."""
    reg = _obs.registry()
    if reg is None:
        return
    reg.counter(
        "slot_state_allocs_total",
        "slot-batched greedy states allocated (the router's device geometry)",
    ).inc(slots=slots, M=M)


def record_state_alloc(*, k: int) -> None:
    """One whole-request resumable greedy state of slate length ``k``
    allocated (``core.streaming.greedy_init``: a stream's, or a chunked
    ``greedy_map``'s).  Each request allocates its own, so this is no
    rebuild and stays out of :data:`REBUILD_COUNTERS`; figure 8 reads it
    as the per-k serial streams' counter-example to the router."""
    reg = _obs.registry()
    if reg is None:
        return
    reg.counter(
        "greedy_state_allocs_total",
        "whole-request greedy states allocated (one a stream)",
    ).inc(k=k)


class RebuildMonitor:
    """Kernel builds, module loads and slot-state allocations in one
    registry, bracketed around a warmup (``repro``'s ``CompileMonitor``
    counts jit cache misses the same way)."""

    def __init__(self, registry):
        self.registry = registry
        self._mark = 0.0

    def rebuilds(self) -> float:
        """Builds + loads + slot-state allocations so far."""
        return sum(self.registry.counter(name).total()
                   for name in REBUILD_COUNTERS)

    def mark(self) -> None:
        """Remember the current count (call when warmup is done)."""
        self._mark = self.rebuilds()

    def since_mark(self) -> float:
        """Rebuilds since :meth:`mark`: 0 proves a serving loop ran on
        the kernels and the device state it had already built."""
        return self.rebuilds() - self._mark


def record_kernel_dispatch(
    mode: str,
    *,
    D: int,
    M: int,
    state_rows: int,
    windowed: bool,
    tile_m: Optional[int] = None,
    smem_bytes: Optional[int] = None,
    v_resident: Optional[bool] = None,
) -> None:
    """One ``ops.py`` execution-mode decision: which kernel path won
    (``ref`` / ``resident`` / ``tiled`` / ``fused_chunk``) and the
    ``TilePolicy`` numbers behind it (``smem_bytes``: a block's, or a
    resident cluster CTA's, shared memory; ``v_resident``: whether a
    resident or fused chunk launch keeps V in shared memory)."""
    reg = _obs.registry()
    if reg is None:
        return
    reg.counter(
        "dpp_kernel_dispatch_total", "kernel execution modes chosen by ops.py"
    ).inc(mode=mode, windowed=str(bool(windowed)))
    reg.gauge(
        "dpp_tile_m", "candidate-axis tile of the last tiled dispatch (0 = "
        "whole-M resident)"
    ).set(0 if tile_m is None else tile_m)
    if smem_bytes is not None:
        reg.gauge(
            "dpp_smem_bytes_est",
            "TilePolicy shared memory a block (a resident cluster's CTA) of "
            "the last dispatch uses",
        ).set(smem_bytes)
    if v_resident is not None:
        reg.gauge(
            "dpp_v_resident",
            "1 if the last resident or fused chunk dispatch keeps V in "
            "shared memory",
        ).set(int(v_resident))


def record_tile_resolution(source: str) -> None:
    """Which source won one tile_m precedence resolution in ``ops.py``
    (``env`` > ``explicit`` int > requested ``auto`` > ``model``;
    ``policy`` = an explicit ``TilePolicy`` object bypassed the ladder)."""
    reg = _obs.registry()
    if reg is None:
        return
    reg.counter(
        "dpp_tile_source_total",
        "tile_m precedence winners by source "
        "(env/explicit/auto/model/policy)",
    ).inc(source=source)


def record_tile_override(winner: str, lost: str) -> None:
    """A tile_m request that *lost* the precedence resolution (a call
    site's ``tile_m=`` shadowed by the ``DPP_TILE_M`` override), recorded
    instead of silently ignored."""
    reg = _obs.registry()
    if reg is None:
        return
    reg.counter(
        "dpp_tile_override_total",
        "tile_m requests shadowed by a higher-precedence source",
    ).inc(winner=winner, lost=lost)


def record_autotune_lookup(
    outcome: str, *, reason: str = "", tile_m: Optional[int] = None
) -> None:
    """One ``tile_m="auto"`` cache consultation: an ``exact`` or
    nearest-``bucket`` hit (with the chosen tile), or a ``miss`` with its
    reason (empty/corrupt/no_entry/error), after which the on-chip budget
    model decides, never an error."""
    reg = _obs.registry()
    if reg is None:
        return
    if outcome in ("exact", "bucket"):
        reg.counter(
            "autotune_cache_hits_total",
            "tile_m='auto' lookups that produced a measured tile",
        ).inc(kind=outcome)
        if tile_m is not None:
            reg.gauge(
                "autotune_tile_m",
                "tile chosen by the last autotune cache hit",
            ).set(tile_m)
    else:
        reg.counter(
            "autotune_cache_misses_total",
            "tile_m='auto' lookups that fell back to the budget model",
        ).inc(reason=reason or "unknown")


def record_greedy_map(backend: str, *, B: int, k: int, M: int,
                      chunked: bool = False) -> None:
    """One whole-slate ``greedy_map`` dispatch.  Launched work (steps,
    marginal evaluations) is counted here for unchunked runs; chunked
    runs count it per chunk in :func:`record_chunk` instead."""
    reg = _obs.registry()
    if reg is None:
        return
    reg.counter(
        "greedy_dispatch_total", "greedy_map dispatches by backend"
    ).inc(backend=backend, chunked=str(bool(chunked)))
    if not chunked:
        _count_steps(reg, backend, B * k, B * k * M)


def record_chunk(backend: str, *, B: int, chunk: int, M: int) -> None:
    """One resumable chunk launch: ``B`` lanes x ``chunk`` greedy steps
    over ``M`` candidate columns."""
    reg = _obs.registry()
    if reg is None:
        return
    reg.counter(
        "greedy_chunks_total", "resumable chunk launches by backend"
    ).inc(backend=backend)
    _count_steps(reg, backend, B * chunk, B * chunk * M)


def _count_steps(reg, backend: str, steps: int, evals: int) -> None:
    reg.counter(
        "greedy_steps_total", "greedy steps launched (padded/parked lanes "
        "included — this is device work, not delivered selections)"
    ).inc(steps, backend=backend)
    reg.counter(
        "marginal_evals_total", "candidate marginals evaluated: every "
        "launched step updates and argmaxes M candidate gains"
    ).inc(evals, backend=backend)


def record_session_delta(op: str, *, w: int, dm: int) -> None:
    """One session delta update (``extend`` / ``rescore`` / ``rebuild``):
    ``dm`` candidate columns re-solved against a ``w``-row window —
    O(w * dm) device work where a from-scratch rerank would pay
    O(k * M)."""
    reg = _obs.registry()
    if reg is None:
        return
    reg.counter(
        "session_deltas_total", "session delta updates by op"
    ).inc(op=op)
    reg.counter(
        "session_delta_cols_total",
        "candidate columns re-solved by session delta updates",
    ).inc(dm, op=op)


def record_session_evict(resident_bytes: int, *, evicted: int = 1) -> None:
    """``evicted`` sessions dropped to the LRU byte budget;
    ``resident_bytes`` is the store's device footprint *after* the
    eviction (also exported on every resume via
    :func:`record_session_resident`)."""
    reg = _obs.registry()
    if reg is None:
        return
    reg.counter(
        "session_evictions_total",
        "session states dropped by the LRU byte budget",
    ).inc(evicted)
    reg.gauge(
        "session_resident_bytes",
        "device bytes held by resident session states",
    ).set(resident_bytes)


def record_session_resident(resident_bytes: int, *, sessions: int) -> None:
    """Current store footprint: ``sessions`` resident states holding
    ``resident_bytes`` on device."""
    reg = _obs.registry()
    if reg is None:
        return
    reg.gauge(
        "session_resident_bytes",
        "device bytes held by resident session states",
    ).set(resident_bytes)
    reg.gauge(
        "session_resident_count", "resident session states"
    ).set(sessions)
