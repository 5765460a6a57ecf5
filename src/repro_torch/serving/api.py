"""The serving front door: one session object, one request object (the
torch counterpart of ``repro.serving.api``).

``Reranker(cfg, device="cuda")`` holds the model-side configuration and
the device; every call supplies a :class:`RerankRequest` carrying the
data and the request-side knobs (slate length, shortlist width,
candidate mask).  ``rerank`` moves the request's arrays (numpy or
tensors) onto the session's device and dispatches by request shape:

* ``scores (M,)``    -> one slate;
* ``scores (B, M)``  -> the user batch, with the batch dimension written
                        out through the shortlist and the greedy kernels;
* ``cfg.mesh`` set    -> either shape on the candidate-sharded path
                        (``repro_torch.serving.sharded_rerank``), called
                        by every rank of the mesh's group.

``stream`` emits one request's slate in chunks as it is selected (one
K5/K6 launch per chunk with ``use_kernel``; on a mesh, chunks of each
rank's resumable shard state, one update launch a step, called by every
rank).  ``submit`` hands a single request to the session's
continuous-batching router (``repro_torch.serving.router``: one K5/K6
launch per cycle for every live request) and returns a ``SlateHandle``.
``session`` opens a stateful feed over one request
(``repro_torch.serving.session``: one K6 launch per ``next_chunk``,
O(w * dM) ``extend`` / ``rescore`` delta updates, LRU eviction and
rebuild from host mirrors).  On a mesh ``submit`` serves through the
router on the mesh's device (every rank submits the same requests in
the same order and pumps together; decisions that read a clock are made
on rank 0 and sent to the others), and ``session`` raises
``NotImplementedError``, as ``repro`` refuses sessions over sharded
pools.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.dispatch import greedy_map
from repro_torch.core.streaming import (
    greedy_chunk,
    greedy_init,
    resolve_chunk,
    slot_pad_v,
)
from repro_torch.device import resolve_device, same_device, to_device
from repro_torch.serving.reranker import DPPRerankConfig, _shortlist_kernel


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


@dataclasses.dataclass(frozen=True)
class RerankRequest:
    """One rerank request: the data plus the request-side knobs.

    ``scores`` is ``(M,)`` (single) or ``(B, M)`` (user batch);
    ``feats`` is ``(M, D)`` — shared across a batch — or per-user
    ``(B, M, D)``.  ``slate_size`` / ``shortlist`` default to the session
    config's values; ``mask`` (``(M,)`` or ``(B, M)``) marks selectable
    candidates; ``deadline`` is a latency budget in seconds, honoured by
    the router (timeout eviction returns the partial slate with
    ``timed_out=True``); ``rid`` is an opaque caller tag echoed back on
    router handles.

    Validates at construction.
    """

    scores: Any
    feats: Any
    slate_size: Optional[int] = None
    shortlist: Optional[int] = None
    mask: Optional[Any] = None
    deadline: Optional[float] = None
    rid: Optional[Any] = None

    def __post_init__(self):
        if self.slate_size is not None and self.slate_size <= 0:
            raise ValueError(
                f"slate_size must be >= 1, got {self.slate_size}"
            )
        if self.shortlist is not None and self.shortlist <= 0:
            raise ValueError(f"shortlist must be >= 1, got {self.shortlist}")
        if self.deadline is not None and not self.deadline > 0:
            raise ValueError(
                f"deadline must be a positive seconds budget, got "
                f"{self.deadline}"
            )
        s_shape, f_shape = _shape(self.scores), _shape(self.feats)
        s_nd, f_nd = len(s_shape), len(f_shape)
        if s_nd not in (1, 2):
            raise ValueError(
                f"scores must be (M,) or a user batch (B, M), got "
                f"ndim={s_nd}"
            )
        if f_nd != 2 and not (s_nd == 2 and f_nd == 3):
            raise ValueError(
                f"feats must be (M, D) (shared) or, with batched scores, "
                f"per-user (B, M, D); got feats ndim={f_nd} with scores "
                f"ndim={s_nd}"
            )
        M = s_shape[-1]
        if f_shape[-2] != M:
            raise ValueError(
                f"scores and feats disagree on the candidate count: scores "
                f"carry M={M} candidates but feats {f_shape} carry "
                f"{f_shape[-2]} — every operand must share one M axis"
            )
        if s_nd == 2 and f_nd == 3 and f_shape[0] != s_shape[0]:
            raise ValueError(
                f"scores and feats disagree on the user batch: scores "
                f"carry B={s_shape[0]} users but feats {f_shape} carry "
                f"{f_shape[0]}"
            )
        if self.mask is not None:
            m_shape = _shape(self.mask)
            if len(m_shape) != 1 and not (s_nd == 2 and len(m_shape) == 2):
                raise ValueError(
                    f"mask must be (M,) (shared) or, with batched scores, "
                    f"per-user (B, M); got mask ndim={len(m_shape)} with "
                    f"scores ndim={s_nd}"
                )
            if m_shape[-1] != M:
                raise ValueError(
                    f"scores and mask disagree on the candidate count: "
                    f"scores carry M={M} candidates but mask {m_shape} "
                    f"carries {m_shape[-1]} — every operand must share one "
                    f"M axis"
                )
            if len(m_shape) == 2 and m_shape[0] != s_shape[0]:
                raise ValueError(
                    f"scores and mask disagree on the user batch: scores "
                    f"carry B={s_shape[0]} users but mask {m_shape} carries "
                    f"{m_shape[0]}"
                )

    @property
    def batched(self) -> bool:
        return len(_shape(self.scores)) == 2

    @property
    def num_candidates(self) -> int:
        return _shape(self.scores)[-1]


class Reranker:
    """A DPP rerank serving session on one device.

    ``device`` defaults to the card; a CUDA device without one raises
    here, at construction.  Request arrays (numpy or tensors) are moved
    onto it by ``rerank``, ``stream``, the router and the sessions.
    ``router_config`` shapes the router behind ``submit``,
    ``session_config`` the session store behind ``session``.
    """

    def __init__(self, cfg: DPPRerankConfig, router_config=None,
                 session_config=None, device="cuda"):
        if not isinstance(cfg, DPPRerankConfig):
            raise TypeError(
                f"Reranker takes a DPPRerankConfig, got {type(cfg).__name__}"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.mesh is not None and not same_device(cfg.mesh.device,
                                                    self.device):
            raise ValueError(
                f"cfg.mesh keeps its shards on {cfg.mesh.device}, but the "
                f"session serves on {self.device}: pass device="
                f"{str(cfg.mesh.device)!r}"
            )
        self._router_config = router_config
        self._router = None
        self._session_config = session_config
        self._sessions = None
        if cfg.obs is not None:  # enabled=False configs are a no-op
            obs.enable(cfg.obs)

    def _cfg_for(self, req: RerankRequest) -> DPPRerankConfig:
        """The session's model-side knobs with the request's k and
        shortlist folded in."""
        k = req.slate_size if req.slate_size is not None else self.cfg.slate_size
        c = req.shortlist if req.shortlist is not None else self.cfg.shortlist
        if (k, c) == (self.cfg.slate_size, self.cfg.shortlist):
            return self.cfg
        return dataclasses.replace(self.cfg, slate_size=k, shortlist=c)

    @staticmethod
    def _as_request(req, kwargs) -> RerankRequest:
        if isinstance(req, RerankRequest):
            if kwargs:
                raise TypeError(
                    "pass request knobs inside the RerankRequest, not as "
                    f"keyword overrides: {sorted(kwargs)}"
                )
            return req
        raise TypeError(
            f"expected a RerankRequest, got {type(req).__name__}; build one "
            f"with RerankRequest(scores=..., feats=..., ...)"
        )

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return to_device(x, self.device, dtype)

    def rerank(self, req: RerankRequest, **kwargs):
        """Whole-slate rerank: ``(indices int32, d_hist)``, shapes ``(N,)``
        single / ``(B, N)`` batched, global ids into the request's M (-1
        after an eps-stop).  With ``cfg.mesh`` every rank of the mesh's
        group calls it with the same request and gets the same slate."""
        req = self._as_request(req, kwargs)
        cfg = self._cfg_for(req)
        scores = self._tensor(req.scores)
        feats = self._tensor(req.feats)
        mask = None if req.mask is None else self._tensor(req.mask, torch.bool)
        with obs.span(
            "serving.rerank", M=req.num_candidates, k=cfg.slate_size,
            batched=req.batched,
        ):
            if cfg.mesh is not None:
                return _sharded_rerank_impl(scores, feats, cfg, mask)
            if req.batched:
                return _rerank_batch_impl(scores, feats, cfg, mask)
            return _rerank_impl(scores, feats, cfg, mask)

    def stream(self, req: RerankRequest, chunk_size: Optional[int] = None,
               **kwargs) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Stream one request's slate as it is selected.

        Returns a generator of ``(indices (c,) int32 global ids,
        d_hist (c,))`` chunks whose concatenation is a prefix of
        ``rerank(req)`` (same shortlist, same greedy sequence) covering
        every real selection; the last chunk is short when ``chunk``
        does not divide the slate, and once an eps-stop surfaces (a -1
        tail slot) the generator ends instead of launching further
        all -1 chunks.  ``chunk_size`` overrides ``cfg.chunk_size``.

        Preparation — validation, the top-C shortlist, the resumable
        greedy state — happens here, not at the first ``next()``: the
        generator's resume path costs O(chunk), nothing O(M).

        With ``cfg.mesh`` the preparation runs the sharded shortlist's
        all-gather, so every rank of the mesh's group calls ``stream``
        with the same request, and every rank must consume the same
        number of chunks: a rank that stops early leaves its peers
        blocked in the next step's collective.  The eps-stop below reads
        a chunk's last id, which every rank holds, so all ranks end at
        the same chunk.
        """
        req = self._as_request(req, kwargs)
        cfg = self._cfg_for(req)
        if req.batched:
            raise ValueError(
                "stream serves a single request (scores (M,)); batch "
                "serving goes through rerank"
            )
        spec = cfg.greedy_spec()
        chunk = resolve_chunk(
            spec, chunk_size if chunk_size is not None else cfg.chunk_size
        )
        k = cfg.slate_size
        with obs.span(
            "serving.stream.prep", M=req.num_candidates, k=k, chunk=chunk,
        ):
            scores = self._tensor(req.scores)
            feats = self._tensor(req.feats)
            mask = (None if req.mask is None
                    else self._tensor(req.mask, torch.bool)[None])
            if cfg.mesh is not None:
                from repro_torch.serving.sharded_rerank import (
                    sharded_stream_state,
                )

                # the rank's shard of the masked shortlist: ids are global
                state = sharded_stream_state(scores[None], feats, cfg, mask)
                V, top_i = None, None
            else:
                V, m_top, top_i = _shortlist_kernel(scores[None], feats,
                                                    cfg, mask)
                V, top_i = V[0], top_i[0]
                m_top = None if m_top is None else m_top[0]
                state = greedy_init(spec, V=V, mask=m_top)
            V = slot_pad_v(spec, V, state)

        def emit():
            done, st = 0, state
            while done < k:
                c = min(chunk, k - done)
                with obs.span("serving.stream.chunk", chunk=c, done=done):
                    st, sel, dh = greedy_chunk(spec, st, V=V, chunk_size=c)
                    if top_i is not None:
                        sel = sel.to(torch.int64)
                        sel = torch.where(sel >= 0, top_i[sel.clamp_min(0)],
                                          -1)
                yield sel.to(torch.int32), dh
                done += c
                # eps-stop latch: once a chunk's tail slot is -1 the state
                # is stopped and every further chunk would be a dead
                # launch emitting all -1s.  The consumer reads the yielded
                # chunk anyway, so reading its last slot costs no extra
                # device round trip.
                if done < k and int(sel[-1]) < 0:
                    break

        return emit()

    @property
    def sessions(self):
        """The session store on the session's device (created lazily on
        first use; see ``repro_torch.serving.session``): per-user
        windowed greedy states kept resident between scroll events under
        an LRU byte budget."""
        if self._sessions is None:
            from repro_torch.serving.session import (
                SessionConfig,
                SessionStore,
            )

            self._sessions = SessionStore(
                self.cfg, self._session_config or SessionConfig(),
                self.device,
            )
        return self._sessions

    def session(self, req: RerankRequest, sid=None, **kwargs):
        """Open a ``RerankSession`` over one request's shortlist:
        ``next_chunk(n)`` emits the next ``n`` items conditioned on
        everything the session has already shown (never replaying
        selected steps), ``extend`` / ``rescore`` delta-update the
        candidate pool in O(w * dM), and the store evicts cold sessions
        to ``session_config.budget_bytes`` (rebuilt on the next touch).
        ``sid`` names the session (auto-assigned when None); calling
        again with an existing ``sid`` resumes that session and ignores
        ``req``.  Requires a windowed config (``cfg.window <
        slate_size``); single requests only.
        """
        req = self._as_request(req, kwargs)
        if sid is not None and sid in self.sessions:
            return self.sessions.get(sid)
        return self.sessions.create(req, sid=sid, cfg=self._cfg_for(req))

    @property
    def router(self):
        """The session's continuous-batching router on the session's
        device (created lazily on first use; see
        ``repro_torch.serving.router``)."""
        if self._router is None:
            from repro_torch.serving.router import RerankRouter, RouterConfig

            self._router = RerankRouter(
                self.cfg, self._router_config or RouterConfig(),
                device=self.device,
            )
        return self._router

    def submit(self, req: RerankRequest, **kwargs):
        """Submit one request to the session's continuous-batching
        router; returns a ``SlateHandle`` immediately.  The request
        joins the shared micro-batch at the next free slot: call
        ``handle.result()`` (or pump the router) to drive it."""
        req = self._as_request(req, kwargs)
        return self.router.submit(req)


def _sharded_rerank_impl(scores, feats, cfg, mask):
    """``repro``'s ``_sharded_rerank_impl``: one request or a user batch
    on ``cfg.mesh``."""
    from repro_torch.serving.sharded_rerank import sharded_rerank

    single = scores.ndim == 1
    if single:
        scores = scores[None]
        mask = None if mask is None else mask[None]
    if mask is not None:
        mask = mask.expand(scores.shape)
    sel, dh = sharded_rerank(scores, feats, cfg, mask)
    return (sel[0], dh[0]) if single else (sel, dh)


def _rerank_impl(scores, feats, cfg, mask):
    """One request: scores (M,), feats (M, D), mask (M,) or None."""
    if scores.ndim != 1:
        raise ValueError(
            f"rerank takes a single request (scores (M,)), got "
            f"ndim={scores.ndim}; batched scores dispatch through "
            f"Reranker.rerank"
        )
    m = None if mask is None else mask[None]
    sel, dh = _rerank_batch_impl(scores[None], feats, cfg, m)
    return sel[0], dh[0]


def _rerank_batch_impl(scores, feats, cfg, mask):
    """A user batch: scores (B, M), feats (M, D) or (B, M, D), mask (M,)
    or (B, M) or None."""
    if mask is not None:
        mask = mask.expand(scores.shape)
    V, m_top, top_i = _shortlist_kernel(scores, feats, cfg, mask)
    res = greedy_map(cfg.greedy_spec(), V=V, mask=m_top)
    sel = res.indices.to(torch.int64)
    out = torch.where(sel >= 0, top_i.gather(1, sel.clamp_min(0)), -1)
    return out.to(torch.int32), res.d_hist
