"""Session-aware incremental rerank: condition on shown items instead
of recomputing (the torch counterpart of ``repro.serving.session``).

A feed session is a sequence of reranks over a drifting candidate pool.
The paper's §2.4 sliding-window semantics (repulsion only among the
last ``w`` shown items) means the windowed ``GreedyState`` — the
``(w, M)`` Cholesky ring plus the marginal gains ``d2`` — already *is*
the session's conditioning state: everything the next pick needs to
know about the items already shown.  So instead of replaying a full
greedy run from step 0 on every scroll event, this layer

* **resumes** — each session keeps its windowed state on the
  ``Reranker``'s device between scroll events; ``next_chunk(n)`` emits
  the next ``n`` items conditioned on the shown history, never
  replaying selected steps (with ``use_kernel`` on the card: one K6
  launch, ``fused_chunk_windowed``, its operands checked and its
  scratch allocated once a resident state: ``greedy_chunk_launcher``);
* **delta-updates** — when new candidates arrive (``extend``) or
  scores refresh (``rescore``), only the affected columns of the
  session's shortlisted ``V`` are written and only *their* ``C``
  columns / ``d2`` entries re-solved against the current window —
  O(w * dM), never O(k * M).  The block goes to the device in one
  pinned copy, is solved there against the window factor read off the
  ring (``repro_torch.core.windowed.window_solve``, the solve behind
  ``core.streaming.greedy_state_extend`` / ``_rescore`` too) and is
  written into the session's own state in place: ``V``, ``C`` and
  ``d2`` are rows of one buffer, so one write places all three.  On the
  card, once the ring is full, that device half is a CUDA graph
  captured on a block width's first delta and replayed after: its
  dozen small calls cost the host more than the card's work;
* **evicts** — :class:`SessionStore` keeps every session under one LRU
  device-byte budget.  An evicted session is *not* lost: the windowed
  state is a pure function of the pool and the shown history (both
  mirrored on the host), so the next touch rebuilds it through
  ``repro_torch.core.windowed.windowed_state_rebuild`` — one Cholesky
  and one triangular solve, transparent to the caller.

State ownership: the device tensors (``_state`` and ``_V``, views of
one buffer) are owned by the session, updated in place and may vanish
at any moment (eviction); the host mirrors
(numpy: pool vectors, raw features, global ids, shown history, dead
set) are authoritative and never evicted.

A fresh state is built at the live pool's width and widened to the
session's capacity with the headroom parked
(``core.streaming.slot_state_widen``), so its gains are the bits a
per-request ``rerank`` starts from: on the card a gains reduction over
a wider, zero-padded ``V`` may round one ulp away.

Observability: spans ``serving.session.{resume,extend,rescore,
rebuild,evict}`` (each verb's span covers its host copies too, so it
is the verb's whole host wall; an extend's and a rescore's carry
``solve``: how the delta's device half ran); metrics
``session_deltas_total{op}``,
``session_delta_cols_total``, ``session_evictions_total``,
``session_resident_bytes`` and ``session_resident_count``.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.streaming import (
    GreedyState,
    greedy_chunk_launcher,
    greedy_slot_state,
    slot_pad_v,
    slot_state_widen,
)
from repro_torch.core.windowed import window_solve, windowed_state_rebuild
from repro_torch.device import to_device
from repro_torch.obs.dispatch import (
    record_session_delta,
    record_session_evict,
    record_session_resident,
)
from repro_torch.serving.reranker import DPPRerankConfig, _shortlist_kernel


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """Store-side knobs.

    ``budget_bytes`` caps the *device* bytes held by resident session
    states across the store (LRU eviction; host mirrors are exempt —
    they are what makes eviction reversible).  ``capacity`` is each
    session's candidate-pool width in columns; extends append into the
    headroom above the initial shortlist.  Default: twice the
    shortlist, so a session can double its pool before exhausting.
    """

    budget_bytes: int = 64 << 20
    capacity: Optional[int] = None

    def __post_init__(self):
        if self.budget_bytes <= 0:
            raise ValueError(
                f"budget_bytes must be >= 1, got {self.budget_bytes}"
            )
        if self.capacity is not None and self.capacity <= 0:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")


def _check_session_cfg(cfg: DPPRerankConfig) -> None:
    if cfg.mesh is not None:
        # as repro's _check_session_cfg (src/repro/serving/session.py)
        raise NotImplementedError(
            "sessions over a candidate-sharded mesh (cfg.mesh) are not "
            "implemented, as in repro, which refuses them too: the window "
            "ring is sharded and a column delta crosses shard boundaries"
        )
    if cfg.window is None or cfg.window >= cfg.slate_size:
        raise ValueError(
            f"sessions need a windowed config (window < slate_size): the "
            f"exact C (M, k) layout retains the whole selection history "
            f"instead of a w-item conditioning window, so shown items "
            f"cannot be conditioned on in O(w*M) — got window="
            f"{cfg.window}, slate_size={cfg.slate_size}"
        )


def _host(x) -> np.ndarray:
    """``x`` (numpy or a tensor on any device) as a numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class SessionStore:
    """LRU store of :class:`RerankSession`\\ s under one device-byte
    budget, on one device.  Created lazily by ``Reranker.sessions``;
    sessions are opened with ``Reranker.session(req, sid=...)``."""

    def __init__(self, cfg: DPPRerankConfig, scfg: SessionConfig,
                 device):
        _check_session_cfg(cfg)
        self.cfg = cfg
        self.scfg = scfg
        self.device = torch.device(device)
        self._sessions: "OrderedDict[object, RerankSession]" = OrderedDict()
        self._ids = itertools.count()
        self._side = self._pool = None

    def __contains__(self, sid) -> bool:
        return sid in self._sessions

    def __len__(self) -> int:
        return len(self._sessions)

    def get(self, sid) -> "RerankSession":
        """The named session, touched to most-recently-used."""
        sess = self._sessions[sid]
        self._touch(sess)
        return sess

    def create(self, req, sid=None, cfg=None) -> "RerankSession":
        """Open a session over one request's shortlist."""
        cfg = cfg if cfg is not None else self.cfg
        _check_session_cfg(cfg)
        if sid is None:
            sid = next(self._ids)
        if sid in self._sessions:
            raise ValueError(
                f"session {sid!r} already exists — resume it with "
                f"Reranker.session(req, sid={sid!r}) / store.get, or "
                f"close it first"
            )
        sess = RerankSession(self, sid, cfg, req)
        self._sessions[sid] = sess
        self._balance(keep=sess)
        return sess

    def close(self, sid) -> None:
        """Drop a session entirely (device state and host mirrors)."""
        sess = self._sessions.pop(sid)
        sess._drop()
        record_session_resident(
            self.resident_bytes(), sessions=self._resident_count()
        )

    def resident_bytes(self) -> int:
        return sum(
            s._resident_bytes for s in self._sessions.values()
            if s._state is not None
        )

    def _resident_count(self) -> int:
        return sum(
            1 for s in self._sessions.values() if s._state is not None
        )

    def _side_stream(self) -> torch.cuda.Stream:
        """The stream the sessions' delta graphs are captured on."""
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def _graph_pool(self):
        """One memory pool for every session's delta graphs: a graph's
        scratch lives only while it replays, and replays do not overlap
        on a stream."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def _touch(self, sess: "RerankSession") -> None:
        self._sessions.move_to_end(sess.sid)

    def _balance(self, keep: "RerankSession") -> None:
        """Evict least-recently-used resident sessions until the store
        fits ``budget_bytes``.  The session being served is never
        evicted, even when it alone exceeds the budget."""
        total = self.resident_bytes()
        for sess in list(self._sessions.values()):  # LRU order first
            if total <= self.scfg.budget_bytes:
                break
            if sess is keep or sess._state is None:
                continue
            freed = sess._resident_bytes
            with obs.span("serving.session.evict", sid=str(sess.sid),
                          bytes=freed):
                sess._drop()
            total -= freed
            record_session_evict(total)
        record_session_resident(total, sessions=self._resident_count())


def _width(dm: int) -> int:
    """A delta's staged width: ``dm`` rounded up to a power of two, so a
    session stages (and captures) a few widths however its deltas vary;
    the padding repeats the block's last column."""
    return 1 << (dm - 1).bit_length()


class _DeltaStage:
    """One staged block width ``n`` of a resident state's deltas: the
    block's buffer rows and its pool columns in one host buffer (pinned
    on the card) and its device twin, so a delta sends one copy; on the
    card, the CUDA graph of the device half once the ring is full.  Kept
    with the resident state and dropped with it, outside the store's
    byte budget (the state and ``V``)."""

    def __init__(self, D: int, w: int, n: int, dev: torch.device):
        rows = (D + w + 1) * n
        off = 4 * (rows + rows % 2)  # the int64 column ids 8-byte aligned
        self.host = torch.empty((off + 8 * n,), dtype=torch.uint8,
                                pin_memory=dev.type == "cuda")
        self.dev = (self.host if dev.type == "cpu"
                    else torch.empty_like(self.host, device=dev))
        self.blk_h, self.cols_h = (
            x.numpy() for x in self._views(self.host, D, w, n, off))
        self.blk, self.cols = self._views(self.dev, D, w, n, off)
        # recorded after each delta's device half: the host buffer is
        # free again once it has passed
        self.ready = torch.cuda.Event() if dev.type == "cuda" else None
        self.graph = None

    @staticmethod
    def _views(raw, D, w, n, off):
        blk = raw[:4 * (D + w + 1) * n].view(torch.float32)
        return blk.view(D + w + 1, n), raw[off:].view(torch.int64)


class RerankSession:
    """One user's stateful diversified feed.

    Holds the windowed greedy state over a shortlisted, capacity-padded
    candidate pool on the store's device.  Selections are reported as
    *global ids*: the request's original candidate indices for the
    initial shortlist, then the ids :meth:`extend` returns for appended
    candidates.
    """

    def __init__(self, store: SessionStore, sid, cfg: DPPRerankConfig, req):
        if req.batched:
            raise ValueError(
                "a session serves one user's feed (scores (M,)); open one "
                "session per user"
            )
        self.store = store
        self.sid = sid
        self.cfg = cfg
        self.spec = cfg.greedy_spec()
        self.w = min(cfg.window, cfg.slate_size)
        dev = store.device

        feats = to_device(req.feats, dev)
        mask = (None if req.mask is None
                else to_device(req.mask, dev, torch.bool)[None])
        V, m_top, top_i = _shortlist_kernel(
            to_device(req.scores, dev)[None], feats, cfg, mask
        )
        V, top_i = V[0], top_i[0]
        D, C0 = V.shape
        cap = store.scfg.capacity or 2 * C0
        self.cap = max(cap, C0)
        self.D = D

        # host mirrors — authoritative, never evicted; what makes
        # device eviction reversible
        V_h = V.cpu().numpy()
        self._Vh = np.zeros((D, self.cap), V_h.dtype)
        self._Vh[:, :C0] = V_h
        F_h = feats[top_i].cpu().numpy()
        self._Fh = np.zeros((D, self.cap), F_h.dtype)
        self._Fh[:, :C0] = F_h.T
        self._gid = np.full((self.cap,), -1, np.int64)
        self._gid[:C0] = top_i.cpu().numpy()
        self._col_of = {int(g): i for i, g in enumerate(self._gid[:C0])}
        self._dead = np.ones((self.cap,), bool)
        self._dead[:C0] = (
            False if m_top is None else ~m_top[0].cpu().numpy()
        )
        self._shown: list[int] = []
        self._m_live = C0
        self._next_gid = int(req.num_candidates)
        self._stopped_h = False

        # device state — owned here, droppable by the store's LRU; the
        # chunk launcher (size, launch) is prepared on it once
        self._state: Optional[GreedyState] = None
        self._V = self._buf = self._win = self._launch = None
        self._stages: dict = {}
        self._resident_bytes = 0
        self._materialize()

    # -- device residency ---------------------------------------------------

    def _materialize(self) -> None:
        """(Re)build the device state from the host mirrors + history.

        Sessions that have shown nothing get the plain windowed init at
        the live pool's width, widened to the capacity; touched-after-
        evict sessions rebuild the ring rows from the last-w shown
        columns (the unique Cholesky factor: the state the incremental
        path reached, up to rounding — ``windowed_state_rebuild``).
        The layouts are each backend's own: torch ``C (w, M)``,
        ``d2 (M,)``, ``win (w,)`` int64 and a 0-d ``stopped``; kernel
        ``C (1, w, M)`` float32, ``d2 (1, M)``, ``win (1, w)`` int32 and
        ``stopped (1,)``; a 0-d int32 ``t`` for both."""
        dev = self.store.device
        kernel = self.spec.backend == "kernel"
        D, w = self.D, self.w
        # V, the ring rows C and the gains d2 are rows of one buffer, so
        # a delta writes its columns of all three in one copy
        buf = torch.empty((D + w + 1, self.cap), dtype=torch.float32,
                          device=dev)
        V, C, d2 = buf[:D], buf[D:D + w], buf[D + w]
        V.copy_(torch.from_numpy(self._Vh))
        if self._shown:
            ring = self._shown[-w:]
            ring = ring + [-1] * (w - len(ring))
            win = torch.as_tensor(
                ring, dtype=torch.int32 if kernel else torch.int64,
                device=dev)
            C_new, d2_new = windowed_state_rebuild(
                V, win, torch.as_tensor(self._dead, device=dev))
            t = torch.tensor(len(self._shown), dtype=torch.int32, device=dev)
            stopped = torch.tensor(self._stopped_h, device=dev)
            record_session_delta("rebuild", w=w, dm=self.cap)
        else:
            live = self._m_live
            st = greedy_slot_state(
                self.spec, V[:, :live],
                mask=torch.as_tensor(~self._dead[:live], device=dev))
            t, stopped, C_new, d2_new, win = slot_state_widen(
                self.spec, st, self.cap)
        C.copy_(C_new)
        d2.copy_(d2_new)
        if kernel:  # the kernels' single-request layout: one lane
            stopped, C, d2, win = (x[None] for x in (stopped, C, d2, win))
        st = GreedyState(t, stopped, C, d2, win)
        self._state, self._buf, self._win = st, buf, st.win.view(-1)
        self._V = slot_pad_v(self.spec, V, st)
        self._launch, self._stages = None, {}
        self._resident_bytes = sum(
            x.numel() * x.element_size() for x in (*st, self._V)
        )

    def _ensure_resident(self) -> None:
        if self._state is None:
            with obs.span("serving.session.rebuild", sid=str(self.sid),
                          shown=len(self._shown)):
                self._materialize()
            self.store._balance(keep=self)

    def _drop(self) -> None:
        self._state = self._V = self._buf = self._win = self._launch = None
        self._stages = {}

    @property
    def resident(self) -> bool:
        return self._state is not None

    def _relevance(self, scores: np.ndarray) -> np.ndarray:
        """Paper eq. (21), ``alpha ** r`` in log space in float32, as
        ``core.kernel_matrix.map_relevance`` computes it, on the host."""
        return np.exp(scores.astype(np.float32)
                      * np.log(np.float32(self.cfg.alpha)))

    @property
    def _filled(self) -> int:
        """Ring rows in use: every pick enters the window, the oldest
        leaves once it holds ``w``."""
        return min(len(self._shown), self.w)

    @property
    def shown(self) -> np.ndarray:
        """Global ids of everything this session has emitted, in order."""
        return self._gid[np.asarray(self._shown, np.int64)]

    def _delta(self, cols: np.ndarray, V_blk: np.ndarray,
               live: np.ndarray) -> str:
        """Write pool columns ``cols (dM,)`` — ``V_blk (D, dM)`` and their
        selectability ``live (dM,)`` — with their ring rows and gains into
        the device state, in place, and revive the state.

        The block is staged as the buffer's rows (``V``, zero ring rows,
        a gains row of 0 or -inf where not ``live``) with its columns,
        padded to a staged width (:func:`_width`), and sent in one copy.
        On the device :meth:`_solve` conditions it on the window and
        writes it into the state; on the card, once the ring is full,
        through the stage's CUDA graph.  A revived resume conditions on
        the live ring: below a full ring ``t`` is set to the ring's
        occupancy (a stopped chunk advanced it past the last real pick);
        a full ring steps alike for any ``t >= w``.  Returns how the
        device half ran: ``"replay"``, ``"capture"``, ``"eager"`` or
        ``"none"`` (no live column)."""
        f = self._filled
        how = self._send(cols, V_blk, live, f) if cols.size else "none"
        st = self._state
        if f < self.w:  # a full ring: any t >= w steps alike, and t is
            st.t.fill_(f)  # at least the picks so far, so w or more
        if self._stopped_h:  # the card's latch is the host's
            st.stopped.zero_()
        return how

    def _send(self, cols, V_blk, live, f: int) -> str:
        """Stage the block at its width, send it, run the device half."""
        D, w, dev = self.D, self.w, self.store.device
        n = _width(cols.size)
        stage = self._stages.get(n)
        if stage is None:
            stage = self._stages[n] = _DeltaStage(D, w, n, dev)
        elif stage.ready is not None:
            stage.ready.synchronize()  # the last delta's copy has left
        pad = np.minimum(np.arange(n), cols.size - 1)
        stage.blk_h[:D] = V_blk[:, pad]
        stage.blk_h[D:D + w] = 0.0
        stage.blk_h[D + w] = np.where(live[pad], 0.0, -np.inf)
        stage.cols_h[:] = cols[pad]
        if stage.dev is not stage.host:
            stage.dev.copy_(stage.host, non_blocking=True)
        if stage.graph is not None:
            stage.graph.replay()
            how = "replay"
        elif f == w and dev.type == "cuda":
            self._capture(stage)
            how = "capture"
        else:
            self._solve(stage, f)
            how = "eager"
        if stage.ready is not None:
            stage.ready.record()
        return how

    def _solve(self, stage: _DeltaStage, f: int) -> None:
        """The device half of a delta: the staged block's ring rows and
        gains against the window — the last ``f`` shown columns of ``V``
        and the factor the state holds for them, ``C[:f, win[:f]]^T``
        (ring row r is the pick in ``win[r]``, oldest first) — then the
        block written into the state's buffer at its columns (a padding
        column repeats the last one, value and target alike)."""
        D, w, blk = self.D, self.w, stage.blk
        W = torch.index_select(self._buf, 1, self._win[:f])
        _, d2 = window_solve(W[D:D + f].T, W[:D], blk[:D], c=blk[D:D + f])
        blk[D + w].add_(d2)
        self._buf.index_copy_(1, stage.cols, blk)

    def _capture(self, stage: _DeltaStage) -> None:
        """This delta's device half on the store's side stream, which
        also warms it, then the same calls captured into the stage's CUDA
        graph (in the store's shared pool) for the deltas after."""
        cur = torch.cuda.current_stream(self.store.device)
        side = self.store._side_stream()
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            self._solve(stage, self.w)
            graph.capture_begin(pool=self.store._graph_pool(),
                                capture_error_mode="thread_local")
            try:
                self._solve(stage, self.w)
            finally:
                graph.capture_end()
        cur.wait_stream(side)
        stage.graph = graph

    # -- the three session verbs -------------------------------------------

    def next_chunk(self, n: Optional[int] = None):
        """Emit the next ``n`` feed items conditioned on the shown
        history: ``(ids (m,) int64 global ids, gains (m,))``, numpy, with
        ``m <= n`` — short exactly when the session eps-stops (no
        remaining candidate clears the gate; a later ``extend`` /
        ``rescore`` can revive it).  Never replays selected steps; a
        stopped session answers from the host without device work."""
        n = n if n is not None else self.cfg.chunk_size
        if n is None or n < 1:
            raise ValueError(
                f"next_chunk needs n >= 1 (or cfg.chunk_size set), got {n}"
            )
        if self._stopped_h:
            return (
                np.empty((0,), np.int64),
                np.empty((0,), self._Vh.dtype),
            )
        with obs.span("serving.session.resume", sid=str(self.sid), n=n,
                      shown=len(self._shown)):
            self.store._touch(self)
            self._ensure_resident()
            if self._launch is None or self._launch[0] != n:
                self._launch = n, greedy_chunk_launcher(
                    self.spec, self._state, V=self._V, chunk_size=n)
            sel, dh = self._launch[1]()  # the state advances in place
            # one copy to the host: the float32 gains ride as int32 bits
            out = torch.stack([sel.reshape(-1),
                               dh.reshape(-1).view(torch.int32)]).cpu()
            sel_h, dh_h = out[0].numpy(), out[1].numpy().view(np.float32)
        live = sel_h >= 0
        cols = sel_h[live].astype(np.int64)
        self._shown.extend(int(c) for c in cols)
        self._dead[cols] = True
        if cols.size < n:
            self._stopped_h = True
        return self._gid[cols].copy(), dh_h[live].copy()

    def extend(self, scores, feats, mask=None) -> np.ndarray:
        """Append ``dM`` new candidates to the session's pool.

        ``scores (dM,)`` and ``feats (dM, D)`` (numpy, or tensors on any
        device) enter the kernel exactly as the initial shortlist did
        (relevance-scaled columns, paper eq. 21); ``mask`` False keeps a
        column unselectable.  Only the new columns' Cholesky state is
        computed — O(w * dM) — and a stopped session is revived.
        Returns the ``(dM,)`` global ids assigned to the new
        candidates."""
        scores, feats = _host(scores), _host(feats)
        if scores.ndim != 1 or feats.ndim != 2:
            raise ValueError(
                f"extend takes scores (dM,) and feats (dM, D), got "
                f"ndim={scores.ndim}/{feats.ndim}"
            )
        dm = scores.shape[0]
        if feats.shape != (dm, self.D):
            raise ValueError(
                f"extend feats must be ({dm}, {self.D}) to match the "
                f"session's pool, got {tuple(feats.shape)}"
            )
        start = self._m_live
        if start + dm > self.cap:
            raise ValueError(
                f"session pool exhausted: {start} columns used + {dm} new "
                f"> capacity {self.cap} — size SessionConfig.capacity for "
                f"the feed's total candidate churn"
            )
        mask = None if mask is None else _host(mask).astype(bool)
        with obs.span("serving.session.extend", sid=str(self.sid), dm=dm,
                      start=start) as sp:
            self.store._touch(self)
            self._ensure_resident()
            # the block's columns are made on the host, as rescore's are,
            # and sent once: the card and the host mirror hold the same
            # V, and nothing is read back
            rel = self._relevance(scores)
            if mask is not None:
                rel = np.where(mask, rel, np.float32(0.0))
            V_blk = (feats.astype(np.float32) * rel[:, None]).T
            sp.set(solve=self._delta(
                np.arange(start, start + dm), V_blk,
                np.ones(dm, bool) if mask is None else mask))
        self._Vh[:, start:start + dm] = V_blk
        gids = np.arange(self._next_gid, self._next_gid + dm, dtype=np.int64)
        self._next_gid += dm
        self._gid[start:start + dm] = gids
        self._col_of.update(zip(gids.tolist(), range(start, start + dm)))
        self._Fh[:, start:start + dm] = feats.T
        self._dead[start:start + dm] = False if mask is None else ~mask
        self._m_live = start + dm
        self._stopped_h = False
        record_session_delta("extend", w=self.w, dm=dm)
        return gids

    def rescore(self, ids, scores) -> None:
        """Refresh the relevance scores of existing candidates.

        ``ids (dM,)`` are global ids, ``scores (dM,)`` their new scores
        (the last one wins for an id given twice).  The live columns
        among them are rewritten from the stored raw features and
        re-solved against the current window; already-shown (and masked)
        columns keep their exact old state bit for bit, so history is
        never rewritten; a stopped session is revived.  Cost is
        O(w * dM) in the live columns touched (``repro`` re-solves the
        smallest contiguous pool range covering them, O(w * span))."""
        ids = _host(ids).astype(np.int64).reshape(-1)
        scores = _host(scores).reshape(-1)
        if ids.shape != scores.shape:
            raise ValueError(
                f"rescore takes matching ids/scores, got {ids.shape} vs "
                f"{scores.shape}"
            )
        if ids.size == 0:
            return
        try:
            last = {self._col_of[int(g)]: i for i, g in enumerate(ids)}
        except KeyError as e:
            raise ValueError(
                f"rescore: unknown global id {e.args[0]} — ids must come "
                f"from the session's shortlist or from extend()"
            ) from None
        cols = np.fromiter(last, np.int64, len(last))
        pick = np.fromiter(last.values(), np.int64, len(last))
        live = ~self._dead[cols]
        cols, pick = cols[live], pick[live]
        with obs.span("serving.session.rescore", sid=str(self.sid),
                      dm=cols.size) as sp:
            self.store._touch(self)
            self._ensure_resident()
            rel = self._relevance(scores[pick])
            V_new = self._Fh[:, cols] * rel[None, :]
            sp.set(solve=self._delta(cols, V_new, np.ones(cols.size, bool)))
        self._Vh[:, cols] = V_new
        self._stopped_h = False
        record_session_delta("rescore", w=self.w, dm=cols.size)
