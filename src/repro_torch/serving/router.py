"""Continuous-batching rerank router: heterogeneous live requests on one
slot-batched greedy state (the torch counterpart of
``repro.serving.router``).

A live reranker sees requests with different candidate counts, slate
lengths and masks arriving at different times, and a slate that
eps-stops after 7 picks should hand its device lane to the next request
at once, not idle until its neighbours finish.  This router serves that
shape the way LLM servers batch token generation continuously:

* a fixed micro-batch of ``slots`` lanes advances ``chunk_size`` greedy
  steps per cycle through **one** batched chunk call (a
  ``repro_torch.core.streaming.greedy_chunk_launcher`` over the slot
  batch, built with it: one K5 or K6 launch on the kernel backend, its
  operands checked once); the per-slot step counter ``t (S,)`` lets
  every lane sit at its own depth;
* requests are padded into a common bucket: the candidate axis to
  ``max_candidates`` columns (each lane's gains are computed at its
  request's own width and the padding's stay at -inf, which argmax can
  never pick, so slates are index for index, and on the card bit for
  bit, those of a per-request ``rerank``) and the slot Cholesky capacity
  to ``max_slate`` rows;
  per-request k, mask and progress live in data and host-side loop
  bounds, so admission never changes the device geometry;
* completed, eps-stopped and deadline-expired lanes are evicted
  (``state_evict``) and refilled from a bounded FIFO admission queue
  (``state_admit``, in place) between cycles;
* the pump is **double-buffered on CUDA stream order**: right after a
  chunk is launched, non-blocking copies of its ``sel``, ``d_hist`` and
  ``stopped`` into pinned host buffers (two sets, allocated once per
  router) are queued behind it and an event is recorded.  Each cycle
  waits on the previous chunk's event only, decides evictions and
  admissions from the copied ``stopped`` (the state's own ``stopped`` is
  updated in place by later launches), *launches the next chunk*, and
  only then delivers the previous chunk's selections from host memory
  while the card computes the next one.  Reading chunk N's device
  tensors after chunk N+1 was queued would wait for chunk N+1 too.

The pump is synchronous and caller-driven: ``submit`` enqueues and
returns a :class:`SlateHandle`; ``pump()`` advances the world one cycle;
``handle.result()`` pumps until that request finishes.  Requests past
``max_queue`` are refused with :class:`RouterQueueFull` (backpressure),
admission is strictly FIFO (no starvation), and a request whose
``deadline`` lapses (on ``time.monotonic()``) is evicted with its partial
slate and ``timed_out=True``.

On the kernel backend the slots are one cooperative launch, so they must
all be co-resident on the card: at the first ``submit``, when the
feature dimension is known, the router checks ``slots`` against the
card's co-residency for its bucket (``tiled.chunk_capacity``) and
refuses with a ``ValueError`` naming the largest ``slots`` that fits.
It never splits the slots across launches and has no CPU fallback: the
device is the session's.

**On a candidate-sharded mesh** (``cfg.mesh``, ``repro``'s router on a
mesh) the slot batch is each rank's slot
``repro_torch.core.sharded.ShardedState`` on the mesh's device: a lane's
bucket is the request's full candidate axis (``max_candidates`` bounds
``num_candidates``, not the shortlist), split over the ranks at the
bucket's width so that a column has one owner in every lane; admission
builds the rank's shard of the lane through the sharded shortlist
(``serving.sharded_rerank._sharded_kernel``) and writes it in place, and
the ids it returns are global already.  A cycle is ``chunk_size`` steps
of the shard-local update entries of K3/K4, each lane at its own step
counter, with each step's two collectives.  Every rank runs the same
router: it submits the same requests in the same order and pumps
together, so every rank admits, evicts and launches the same lanes, or
the step's collectives would pair different requests.  FIFO order,
``RouterQueueFull`` and the eps-stops are the same on every rank by
construction (the stop flags come from the replicated global argmax);
deadlines are not, since each rank reads its own clock.  So the
deadline decisions of a pump (the active lanes that expired, the queued
requests that ``_admit`` finishes as timed out) are made on rank 0 and
sent to every rank in one fixed-size all-reduce (``slots + max_queue``
flags) before any rank acts on them; no rank sends it when no live or
queued request has a deadline, which every rank knows alike.  Its span,
``router.pump.decide``, reads its host time and calls.  TTFC, the
submit times and the spans stay each rank's own.

**Observability.**  The router's counters live in a
``repro_torch.obs.MetricsRegistry`` (the process-global one when an
observability session is installed, ``RouterConfig.obs`` /
``DPPRerankConfig.obs`` install it at construction, else a private
per-router registry), labeled ``router="rN"``:
``router_requests_total{event}``, ``router_chunks_launched_total``,
``router_lane_steps_total{lanes}``, ``router_queue_depth``,
``router_slot_occupancy``, ``router_ttfc_seconds`` and
``router_hook_errors_total``.  :class:`RouterStats` is a view built from
them.  A ``metrics_hook`` that raises is logged and counted, never
fatal.  Every ``pump()`` emits a ``router.pump`` span decomposed into
``.sync`` / ``.evict`` / ``.admit`` / ``.launch`` / ``.materialize``.
"""
from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from collections import deque
from functools import partial
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.streaming import (
    greedy_chunk_launcher,
    greedy_slots_init,
    state_admit,
    state_evict,
)
from repro_torch.device import resolve_device, same_device, to_device
from repro_torch.distributed.context import all_reduce_sum
from repro_torch.kernels.dpp_greedy.tiled import chunk_capacity
from repro_torch.kernels.dpp_greedy.tiling import TilePolicy
from repro_torch.obs import MetricsRegistry, ObsConfig
from repro_torch.serving.reranker import DPPRerankConfig, _shortlist_kernel
from repro_torch.serving.sharded_rerank import _sharded_kernel

_log = logging.getLogger(__name__)

# router="rN" label values; one registry can host many routers
_ROUTER_IDS = itertools.count()


class RouterQueueFull(RuntimeError):
    """The admission queue is at ``max_queue``: resubmit after pumping."""


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Router shape: the micro-batch geometry and admission policy.

    ``max_slate`` is the slot capacity (every lane shares one Cholesky
    geometry; a request's own k only bounds how much of it is consumed)
    and ``max_candidates`` the padded candidate bucket each request's
    shortlist lands in; they default to the session config's
    ``slate_size`` / ``shortlist``.
    """

    slots: int = 4
    max_queue: int = 32
    chunk_size: int = 8
    max_slate: Optional[int] = None  # slot capacity; None -> cfg.slate_size
    max_candidates: Optional[int] = None  # bucket width; None -> cfg.shortlist
    metrics_hook: Optional[Callable[["RouterStats"], None]] = None
    obs: Optional[ObsConfig] = None  # installed at router construction

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.chunk_size < 1:
            raise ValueError(
                f"chunk_size must be >= 1, got {self.chunk_size}"
            )
        if self.max_slate is not None and self.max_slate < 1:
            raise ValueError(f"max_slate must be >= 1, got {self.max_slate}")
        if self.max_candidates is not None and self.max_candidates < 1:
            raise ValueError(
                f"max_candidates must be >= 1, got {self.max_candidates}"
            )


@dataclasses.dataclass
class RouterStats:
    """Counters (monotonic) and gauges (last pump) for the router: a
    value object built on demand from the router's labeled metrics
    (``router.stats`` / the ``metrics_hook`` snapshot)."""

    submitted: int = 0
    admitted: int = 0
    completed: int = 0
    eps_stopped: int = 0
    timed_out: int = 0
    rejected: int = 0
    chunks_launched: int = 0
    lane_steps_active: int = 0  # occupied-lane steps launched
    lane_steps_total: int = 0  # all-lane steps launched (active + parked)
    queue_depth: int = 0  # gauge
    slot_occupancy: int = 0  # gauge
    ttfc_sum: float = 0.0
    ttfc_count: int = 0

    @property
    def fill_ratio(self) -> float:
        """Occupied fraction of launched lane-steps, the continuous-
        batching payoff metric (1.0 = no lane ever idles)."""
        if self.lane_steps_total == 0:
            return 0.0
        return self.lane_steps_active / self.lane_steps_total

    @property
    def mean_ttfc(self) -> float:
        """Mean seconds from submit to the first delivered chunk."""
        if self.ttfc_count == 0:
            return 0.0
        return self.ttfc_sum / self.ttfc_count

    def snapshot(self) -> "RouterStats":
        return dataclasses.replace(self)


class SlateHandle:
    """One submitted request's future slate.

    ``result()`` pumps the owning router until this request finishes and
    returns ``(indices, d_hist)`` as numpy arrays: global ids into the
    request's own candidate axis, length k with -1/0 fill past an
    eps-stop, or the shorter partial slate with ``timed_out=True`` after
    a deadline eviction; ``d_hist`` in the router's resident dtype.
    ``ttfc`` is the seconds from submit to the first chunk.
    """

    def __init__(self, router: "RerankRouter", rid, k: int,
                 dtype=np.float32):
        self.rid = rid
        self.timed_out = False
        self.ttfc: Optional[float] = None
        self._router = router
        self._k = k
        self._dt = np.dtype(dtype)
        self._done = False
        self._idx: List[np.ndarray] = []
        self._dh: List[np.ndarray] = []

    @property
    def done(self) -> bool:
        return self._done

    @property
    def delivered(self) -> int:
        return sum(len(c) for c in self._idx)

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        while not self._done:
            self._router.pump()
        return self.slate()

    def slate(self) -> Tuple[np.ndarray, np.ndarray]:
        """The chunks delivered so far (the full slate once ``done``)."""
        idx = (
            np.concatenate(self._idx) if self._idx
            else np.zeros((0,), np.int32)
        )
        dh = (
            np.concatenate(self._dh) if self._dh
            else np.zeros((0,), self._dt)
        )
        return idx.astype(np.int32), dh.astype(self._dt)

    # router-side delivery ---------------------------------------------------

    def _deliver(self, idx: np.ndarray, dh: np.ndarray, now: float,
                 submit_t: float):
        if self.ttfc is None:
            self.ttfc = now - submit_t
        self._idx.append(idx)
        self._dh.append(dh)

    def _finish(self, timed_out: bool):
        if not timed_out:
            # the whole-slate contract: length k, -1/0 fill after a stop
            short = self._k - self.delivered
            if short > 0:
                self._idx.append(np.full((short,), -1, np.int32))
                self._dh.append(np.zeros((short,), self._dt))
        self.timed_out = timed_out
        self._done = True


class _Live:
    """Router-internal per-request record (queued or in a slot)."""

    __slots__ = (
        "req", "handle", "k", "top_i", "submit_t", "deadline_at", "count",
    )

    def __init__(self, req, handle, k, submit_t, deadline_at):
        self.req = req
        self.handle = handle
        self.k = k
        self.top_i: Optional[np.ndarray] = None  # set at admission
        self.submit_t = submit_t
        self.deadline_at = deadline_at
        self.count = 0  # selections delivered so far


class _Inflight:
    """A launched chunk's host copies: ``sel``, ``d_hist`` and the
    ``stopped`` flags as they were right after the launch, valid once
    ``done`` (the event recorded behind the copies; None on the CPU,
    where the copies are made at once) has been reached."""

    __slots__ = ("sel", "dh", "stopped", "done")

    def __init__(self, sel, dh, stopped, done):
        self.sel, self.dh, self.stopped, self.done = sel, dh, stopped, done


def _dtype_of(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    dt = getattr(x, "dtype", None)
    if dt is None:
        return torch.float32
    return torch.from_numpy(np.zeros((0,), np.dtype(dt))).dtype


def _card_capacity(windowed: bool, device: torch.device):
    """The card's co-residency for the fused chunk kernels,
    ``smem bytes -> blocks`` (None off the card, where the plain
    versions launch no grid)."""
    if device.type != "cuda":
        return None
    return partial(chunk_capacity, windowed, device=device)


def check_slots(slots: int, D: int, M: int, state_rows: int,
                windowed: bool, tile_m: Optional[int], capacity) -> None:
    """Refuse ``slots`` lanes of one fused chunk launch (``M`` candidate
    columns, ``state_rows`` Cholesky or ring rows) that the card cannot
    keep co-resident: a ``ValueError`` naming the largest ``slots`` that
    fits.  ``capacity`` (``smem bytes -> blocks``, None: no limit) is
    ``tiled.chunk_capacity`` on the card."""
    if capacity is None:
        return
    policy = TilePolicy(tile_m=tile_m)

    def fits(lanes: int) -> bool:
        try:
            policy.decide(D, M, state_rows, windowed, chunked=True,
                          lanes=lanes, capacity=capacity)
        except ValueError:
            return False
        return True

    if fits(slots):
        return
    lo, hi = 0, slots  # fits(lo) (vacuously at 0), not fits(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    if lo == 0:
        policy.decide(D, M, state_rows, windowed, chunked=True, lanes=1,
                      capacity=capacity)  # raises the policy's own error
    raise ValueError(
        f"RouterConfig.slots={slots}: one fused chunk launch of {slots} "
        f"lanes x {M} candidates (D={D}, {state_rows} state rows) cannot "
        f"be co-resident on this card; the largest slots that fits is "
        f"{lo}"
    )


class RerankRouter:
    """Continuous-batching executor over one ``DPPRerankConfig`` session
    on ``device`` (the card unless the caller asks for the CPU).

    See the module docstring for the serving model.  Construction is
    cheap; the slot-batched device state is allocated lazily at the
    first admission (when the feature dimension is known).
    """

    def __init__(self, cfg: DPPRerankConfig,
                 router_config: Optional[RouterConfig] = None,
                 device="cuda"):
        self.cfg = cfg
        self.rcfg = router_config or RouterConfig()
        self.device = resolve_device(device)
        if cfg.mesh is not None and not same_device(cfg.mesh.device,
                                                    self.device):
            raise ValueError(
                f"cfg.mesh keeps its shards on {cfg.mesh.device}, but the "
                f"router serves on {self.device}"
            )
        self.capacity = (
            self.rcfg.max_slate if self.rcfg.max_slate is not None
            else cfg.slate_size
        )
        self.bucket = (
            self.rcfg.max_candidates if self.rcfg.max_candidates is not None
            else cfg.shortlist
        )
        self.chunk = self.rcfg.chunk_size
        # one spec for every lane: k is the slot capacity
        self.spec = dataclasses.replace(
            cfg, slate_size=self.capacity
        ).greedy_spec()
        # observability: publish into the global registry when a session
        # is installed, else into a private one, labeled with a
        # per-router id so concurrent routers never mix counters
        ocfg = self.rcfg.obs if self.rcfg.obs is not None else cfg.obs
        if ocfg is not None:
            obs.enable(ocfg)
        self._reg: MetricsRegistry = obs.registry() or MetricsRegistry()
        self._rid_label = f"r{next(_ROUTER_IDS)}"
        self._queue: Deque[_Live] = deque()
        self._active: Dict[int, _Live] = {}
        self._free: List[int] = list(range(self.rcfg.slots))
        self._state = None  # slot-batched GreedyState (lazy)
        self._V = None  # (S, D, M) stacked kernel operand (lazy)
        self._run = None  # the cycle's chunk launcher, built with them
        self._D: Optional[int] = None  # session feature dim (first submit)
        self._dtype: Optional[torch.dtype] = None  # resident slot dtype
        self._host = None  # two sets of pinned (sel, dh, stopped) buffers
        self._launches = 0  # picks the pinned set of the next launch
        self._inflight: Optional[_Inflight] = None

    # -- metrics -------------------------------------------------------------

    def _count(self, event: str, n: int = 1) -> None:
        self._reg.counter(
            "router_requests_total",
            "request lifecycle events through the router",
        ).inc(n, router=self._rid_label, event=event)

    def _gauge(self, name: str, value: float, help: str = "") -> None:
        self._reg.gauge(name, help).set(value, router=self._rid_label)

    @property
    def stats(self) -> RouterStats:
        """The serving counters and gauges as a :class:`RouterStats`
        value object: a fresh snapshot on every read, built from this
        router's labeled metrics."""
        reg, rid = self._reg, self._rid_label
        ev = reg.counter("router_requests_total")
        lanes = reg.counter("router_lane_steps_total")
        ttfc = reg.histogram("router_ttfc_seconds")
        return RouterStats(
            submitted=int(ev.value(router=rid, event="submitted")),
            admitted=int(ev.value(router=rid, event="admitted")),
            completed=int(ev.value(router=rid, event="completed")),
            eps_stopped=int(ev.value(router=rid, event="eps_stopped")),
            timed_out=int(ev.value(router=rid, event="timed_out")),
            rejected=int(ev.value(router=rid, event="rejected")),
            chunks_launched=int(
                reg.counter("router_chunks_launched_total").value(router=rid)
            ),
            lane_steps_active=int(lanes.value(router=rid, lanes="active")),
            lane_steps_total=int(lanes.value(router=rid, lanes="all")),
            queue_depth=int(reg.gauge("router_queue_depth").value(router=rid)),
            slot_occupancy=int(
                reg.gauge("router_slot_occupancy").value(router=rid)
            ),
            ttfc_sum=ttfc.sum(router=rid),
            ttfc_count=ttfc.count(router=rid),
        )

    @property
    def chunk_running(self) -> bool:
        """Whether the last launched chunk is still running on the card
        (its copies' event not yet reached); False on the CPU and when
        no chunk is in flight.  Read right after ``pump()`` it says
        whether the card was still busy with chunk N+1 when chunk N's
        selections were delivered: the double buffer overlapping."""
        f = self._inflight
        return f is not None and f.done is not None and not f.done.query()

    # -- admission -----------------------------------------------------------

    def submit(self, req) -> SlateHandle:
        """Enqueue one single-user :class:`RerankRequest`; returns its
        handle immediately.  Raises :class:`RouterQueueFull` past
        ``max_queue`` (backpressure) and ``ValueError`` for requests the
        router's bucket can never hold, both before enqueueing, so a
        refused request costs nothing.  Touches no device memory."""
        if req.batched:
            raise ValueError(
                "the router serves single requests (scores (M,)); submit "
                "each user separately — they share the micro-batch"
            )
        k = req.slate_size if req.slate_size is not None else self.cfg.slate_size
        if k > self.capacity:
            raise ValueError(
                f"slate_size {k} exceeds the router's slot capacity "
                f"{self.capacity} (RouterConfig.max_slate)"
            )
        shortlist = (
            req.shortlist if req.shortlist is not None else self.cfg.shortlist
        )
        # on a mesh a lane holds the request's full candidate axis
        width = (req.num_candidates if self.cfg.mesh is not None
                 else min(shortlist, req.num_candidates))
        if width > self.bucket:
            raise ValueError(
                f"request needs {width} candidate columns, over the "
                f"router's bucket {self.bucket} (RouterConfig.max_candidates)"
            )
        D = np.shape(req.feats)[-1]
        if self._D is None:
            self._check_slots(D)
            self._D = D
        elif D != self._D:
            raise ValueError(
                f"feature dim {D} != the session's {self._D} — one router "
                f"serves one model"
            )
        # the resident slot batch's dtype: the feats' promoted with the
        # float32 relevance weights (bf16/f16 -> f32, f64 stays f64), so
        # no lane is silently rounded through another precision
        dt = (torch.float32 if self.cfg.mesh is not None  # the sharded path's
              else torch.promote_types(_dtype_of(req.feats), torch.float32))
        if self._dtype is None:
            self._dtype = dt
        elif dt != self._dtype:
            raise ValueError(
                f"feats dtype maps to resident dtype {dt}, but the "
                f"session serves {self._dtype} — one router serves one "
                f"model (and one precision)"
            )
        if len(self._queue) >= self.rcfg.max_queue:
            self._count("rejected")
            raise RouterQueueFull(
                f"admission queue full ({self.rcfg.max_queue}); pump() "
                f"or consume handles before resubmitting"
            )
        now = time.monotonic()
        handle = SlateHandle(
            self, req.rid, k,
            dtype=torch.empty((0,), dtype=self._dtype).numpy().dtype,
        )
        live = _Live(
            req, handle, k, now,
            None if req.deadline is None else now + req.deadline,
        )
        self._queue.append(live)
        self._count("submitted")
        self._gauge("router_queue_depth", len(self._queue))
        return handle

    def _check_slots(self, D: int) -> None:
        if self.spec.backend != "kernel":
            return
        windowed = self.spec.window is not None and self.spec.window < \
            self.capacity
        rows = self.spec.window if windowed else self.capacity
        check_slots(self.rcfg.slots, D, self.bucket, rows, windowed,
                    self.spec.tile_m, _card_capacity(windowed, self.device))

    # -- request preparation -------------------------------------------------

    def _cfg_for(self, req) -> DPPRerankConfig:
        c = req.shortlist if req.shortlist is not None else self.cfg.shortlist
        if c == self.cfg.shortlist:
            return self.cfg
        return dataclasses.replace(self.cfg, shortlist=c)

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return to_device(x, self.device, dtype)

    def _prep(self, live: _Live):
        """Admission prep: the shortlist.  Returns ``(V (D, m), mask (m,)
        or None)`` at the request's own width; on a mesh the rank's shard
        ``(D, Mloc)`` of the request padded to the bucket and its
        selectable columns (every rank runs the shortlist's all-gather
        here, in the same order)."""
        req, cfg = live.req, self._cfg_for(live.req)
        mask = (None if req.mask is None
                else self._tensor(req.mask, torch.bool)[None])
        if self.cfg.mesh is not None:
            Vl, ml, _ = _sharded_kernel(
                self._tensor(req.scores)[None], self._tensor(req.feats), cfg,
                mask, width=self.bucket)
            live.top_i = None  # sharded ids are global already
            return Vl[0], ml[0]
        V, m, top_i = _shortlist_kernel(
            self._tensor(req.scores)[None], self._tensor(req.feats), cfg, mask
        )
        # the host keeps the id map: delivery never touches the card
        live.top_i = top_i[0].cpu().numpy()
        return V[0], None if m is None else m[0]

    def _admit(self, late: List[bool]):
        """FIFO admission into free slots; expired queued requests
        (``late``, by queue position: :meth:`_decide`) are finished (empty
        partial, timed_out) without ever occupying one."""
        for expired in late:
            if not (self._queue and self._free):
                break
            live = self._queue.popleft()
            if expired:
                live.handle._finish(timed_out=True)
                self._count("timed_out")
                continue
            if self._state is None:
                self._state, self._V = greedy_slots_init(
                    self.spec, self.rcfg.slots, self._D, self.bucket,
                    dtype=self._dtype, device=self.device,
                )
                self._run = greedy_chunk_launcher(
                    self.spec, self._state, V=self._V, chunk_size=self.chunk
                )
            slot = self._free.pop()
            V, mask = self._prep(live)
            # a parked slot is zero past the request's width (V) and
            # parked there (never selectable): the lane's gains are the
            # bits a per-request rerank starts from.  On a mesh V is the
            # lane's whole shard, written by state_admit itself
            state_admit(self.spec, self._state, slot, V, mask)
            if self.cfg.mesh is None:
                self._V[slot, :, : V.shape[-1]] = V
            self._active[slot] = live
            self._count("admitted")

    # -- the pump ------------------------------------------------------------

    def _copy_out(self, sel, dh) -> _Inflight:
        """Queue the launched chunk's host copies behind it: into one of
        two pinned sets on the card (the other set may still hold the
        chunk being delivered), plain clones on the CPU."""
        stopped = self._state.stopped
        if self.device.type != "cuda":
            return _Inflight(sel, dh, stopped.clone(), None)
        if self._host is None:
            self._host = [
                tuple(torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                      for x in (sel, dh, stopped))
                for _ in range(2)
            ]
        bufs = self._host[self._launches % 2]
        for buf, x in zip(bufs, (sel, dh, stopped)):
            buf.copy_(x, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return _Inflight(*bufs, done)

    def _launch(self) -> Optional[_Inflight]:
        if not self._active:
            return None
        rid = self._rid_label
        self._reg.counter(
            "router_chunks_launched_total", "batched chunk calls dispatched"
        ).inc(router=rid)
        self._reg.counter(
            "router_lane_steps_total",
            "greedy lane-steps launched (lanes=active: occupied lanes "
            "only; lanes=all: including parked lanes — the ratio is the "
            "batch fill)",
        ).inc(len(self._active) * self.chunk, router=rid, lanes="active")
        self._reg.counter("router_lane_steps_total").inc(
            self.rcfg.slots * self.chunk, router=rid, lanes="all"
        )
        sel, dh = self._run()  # the state advances in place
        inflight = self._copy_out(sel, dh)
        self._launches += 1
        return inflight

    def _evict(self, slot: int):
        state_evict(self._state, slot)
        if self.cfg.mesh is None:  # a sharded admit writes the whole shard
            self._V[slot] = 0.0
        del self._active[slot]
        self._free.append(slot)

    def _decide(self, now: float):
        """The pump's deadline decisions: ``(expired active slots, [queued
        request expired, by queue position])``.  On a mesh of several
        ranks rank 0 decides on its clock and one all-reduce of
        ``slots + max_queue`` flags hands every rank the same answer;
        without a deadline among the live and queued requests (the same
        on every rank) nothing is sent."""
        slots = sorted(self._active)
        due = [self._active[s].deadline_at for s in slots] + [
            live.deadline_at for live in self._queue]
        if all(d is None for d in due):
            return set(), [False] * len(self._queue)
        late = [d is not None and now > d for d in due]
        mesh = self.cfg.mesh
        if mesh is not None and mesh.size > 1:
            with obs.span("router.pump.decide", flags=len(due)):
                n = self.rcfg.slots
                at = slots + [n + i for i in range(len(self._queue))]
                flags = torch.zeros((n + self.rcfg.max_queue,),
                                    dtype=torch.int32, device=mesh.device)
                if mesh.rank == 0:
                    flags[at] = torch.tensor(late, dtype=torch.int32,
                                             device=mesh.device)
                flags = all_reduce_sum(mesh, flags).tolist()
                late = [flags[i] > 0 for i in at]
        return ({s for s, x in zip(slots, late) if x},
                late[len(slots):])

    def pump(self):
        """One router cycle.

        Decide the deadlines (:meth:`_decide`) -> wait for the previous
        chunk's host copies -> evict finished / eps-stopped / expired
        lanes -> admit from the queue -> launch the next chunk (async) ->
        deliver the previous chunk's selections from host memory while
        the card computes the next.

        Each phase runs inside its own span (``router.pump.sync`` /
        ``.evict`` / ``.admit`` / ``.launch`` / ``.materialize``) under
        one ``router.pump`` parent; all spans are no-ops while
        observability is off.
        """
        with obs.span("router.pump"):
            expired_slots, late = self._decide(time.monotonic())
            prev = self._inflight
            deliveries: list = []
            evictions: List[int] = []
            if prev is not None:
                with obs.span("router.pump.sync"):
                    # the one wait of the cycle: the previous chunk's
                    # copies (never the chunk launched after it)
                    if prev.done is not None:
                        prev.done.synchronize()
                    stopped = prev.stopped.numpy()
                for slot, live in sorted(self._active.items()):
                    consume = min(self.chunk, live.k - live.count)
                    lane_stopped = bool(stopped[slot])
                    expired = slot in expired_slots
                    complete = live.count + consume >= live.k
                    deliveries.append(
                        (slot, live, consume, lane_stopped, expired, complete)
                    )
                    if lane_stopped or expired or complete:
                        evictions.append(slot)
            with obs.span("router.pump.evict", lanes=len(evictions)):
                for slot in evictions:
                    self._evict(slot)
            with obs.span("router.pump.admit", queued=len(self._queue)):
                self._admit(late)
            with obs.span("router.pump.launch", lanes=len(self._active)):
                nxt = self._launch()  # async: the card starts chunk N+1
            # ... while the host unpacks chunk N
            with obs.span("router.pump.materialize",
                          deliveries=len(deliveries)):
                if deliveries:
                    sel_np, dh_np = prev.sel.numpy(), prev.dh.numpy()
                for slot, live, consume, lane_stopped, expired, complete in (
                        deliveries):
                    idx = sel_np[slot, :consume].astype(np.int32)
                    if live.top_i is not None:
                        idx = np.where(
                            idx >= 0, live.top_i[np.clip(idx, 0, None)], -1
                        ).astype(np.int32)
                    first = live.handle.ttfc is None
                    live.handle._deliver(
                        idx, dh_np[slot, :consume].astype(live.handle._dt),
                        time.monotonic(), live.submit_t,
                    )
                    if first and live.handle.ttfc is not None:
                        self._reg.histogram(
                            "router_ttfc_seconds",
                            "seconds from submit to the first delivered chunk",
                        ).observe(live.handle.ttfc, router=self._rid_label)
                    live.count += consume
                    if lane_stopped or complete:
                        live.handle._finish(timed_out=False)
                        self._count("completed")
                        if lane_stopped and not complete:
                            self._count("eps_stopped")
                    elif expired:
                        live.handle._finish(timed_out=True)
                        self._count("timed_out")
            self._inflight = nxt
            self._gauge(
                "router_queue_depth", len(self._queue),
                "requests waiting for admission",
            )
            self._gauge(
                "router_slot_occupancy", len(self._active),
                "slots holding a live request",
            )
            if self.rcfg.metrics_hook is not None:
                snap = self.stats
                try:
                    self.rcfg.metrics_hook(snap)
                except Exception:
                    # a broken hook must never take the serving loop down
                    _log.exception(
                        "RouterConfig.metrics_hook raised; continuing"
                    )
                    self._reg.counter(
                        "router_hook_errors_total",
                        "metrics_hook exceptions swallowed by pump()",
                    ).inc(router=self._rid_label)

    def drain(self, max_pumps: int = 100_000):
        """Pump until every queued and active request has finished."""
        pumps = 0
        while self._queue or self._active or self._inflight is not None:
            self.pump()
            pumps += 1
            if pumps > max_pumps:
                raise RuntimeError("router failed to drain (livelock?)")
