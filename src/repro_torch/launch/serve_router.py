"""Continuous-batching serving launcher: live heterogeneous requests
through ``RerankRouter`` behind a CTR scorer (the torch counterpart of
``repro.launch.serve_router``).

  PYTHONPATH=src python -m repro_torch.launch.serve_router --device cpu \
      --requests 24 --candidates 2000 --slots 4 --chunk 4 --qps 50

A synthetic open-loop client offers one request every ``1/qps`` seconds:
each request is one user scored against the shared candidate pool by
the recsys model (``RecsysModel``, with ``launch.serve``'s candidate
ids; DeepFM's FM term is the kernel K8 on the card), with a per-request
slate length drawn from ``[slate/2, slate]``, an already-seen mask for
every third user, and an optional per-request ``--deadline``.  Requests
are submitted to one ``Reranker.submit`` session; the launcher pumps the
router, measuring completion latency percentiles, time-to-first-chunk,
sustained QPS and the batch fill ratio, and cross-checks a sample of
completed slates index for index against per-request ``rerank``.

``repro``'s flags, with four differences: ``--reduced`` can be turned
off (``--no-reduced`` serves the published config), ``--device``
(default ``cuda``) picks the device, the warm set runs through the
measured router itself (its stats are reported as the difference over
the measured loop), because a second router would allocate its slot
state again inside the measured loop, and ``--chunk`` sets the router's
chunk only, so the parity reranks are whole-slate calls (K1 on the
card with ``--use-kernel``), not the chunk kernels under test.  The
warm set's slates are held against ``rerank`` too.

``--trace-out trace.json`` writes every span of the run (the
``router.pump`` decomposition among them) as Chrome ``trace_event``
JSON.  ``--metrics-out`` then also embeds the metrics snapshot next to
the launcher's numbers; its ``rebuilds_after_warmup`` field (``repro``'s
``jit_misses_after_warmup``) counts kernel builds, kernel library loads
and slot-state allocations after the warm set: 0 means the measured loop
ran on the kernels and the device state the warm set had built.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import get_arch
from repro_torch.data import recsys_batches
from repro_torch.device import resolve_device
from repro_torch.launch.serve import candidate_ids
from repro_torch.models.recsys import init_params, item_embeddings, serve_scores
from repro_torch.obs.dispatch import RebuildMonitor
from repro_torch.serving import (
    DPPRerankConfig,
    ObsConfig,
    Reranker,
    RerankRequest,
    RouterConfig,
    RouterQueueFull,
    RouterStats,
)

_GAUGES = ("queue_depth", "slot_occupancy")


def stats_since(after: RouterStats, before: RouterStats) -> RouterStats:
    """The counters of ``after`` less those of ``before`` (the gauges as
    ``after`` read them)."""
    return RouterStats(**{
        f.name: getattr(after, f.name) - (
            0 if f.name in _GAUGES else getattr(before, f.name))
        for f in dataclasses.fields(RouterStats)
    })


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepfm")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--candidates", type=int, default=2000)
    ap.add_argument("--slate", type=int, default=16)
    ap.add_argument("--shortlist", type=int, default=200)
    ap.add_argument("--alpha", type=float, default=3.0)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--qps", type=float, default=50.0)
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="per-request latency budget in seconds (0 = none)")
    ap.add_argument("--use-kernel", action="store_true")
    ap.add_argument("--parity-sample", type=int, default=4)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--trace-out", default="",
                    help="write the run's spans as Chrome trace_event JSON "
                         "(Perfetto-loadable)")
    ap.add_argument("--device", default="cuda")
    return ap


def make_requests(model, cfg, args, device):
    """Score every user against the shared candidate pool (one batched
    forward) and build the heterogeneous requests."""
    Mc = min(args.candidates, cfg.vocab_sizes[cfg.item_field])
    cand = torch.arange(Mc, dtype=torch.int32, device=device)
    user = torch.as_tensor(
        next(recsys_batches(cfg.vocab_sizes, args.requests, seed=1))["ids"],
        device=device)
    with torch.inference_mode():
        scores = serve_scores(model, candidate_ids(user, cand, cfg),
                              cfg).reshape(args.requests, Mc)
        feats = item_embeddings(model, cand, cfg)  # (Mc, D)
    rng = np.random.default_rng(0)
    reqs = []
    for b in range(args.requests):
        mask = None
        if b % 3 == 2:
            m = np.ones(Mc, bool)
            m[rng.choice(Mc, size=Mc // 5, replace=False)] = False
            mask = torch.as_tensor(m, device=device)
        reqs.append(RerankRequest(
            scores=scores[b], feats=feats,
            slate_size=int(rng.integers(max(args.slate // 2, 1),
                                        args.slate + 1)),
            mask=mask,
            deadline=args.deadline or None,
            rid=b,
        ))
    return reqs


def serve(model, cfg, args, device):
    """The open-loop run on ``model`` (a ``RecsysModel`` of config
    ``cfg``): returns ``(out, rr, pairs)`` with ``out`` the launcher's
    record, ``rr`` the ``Reranker`` and ``pairs`` the checked requests
    as ``(request, handle, rerank ids, rerank d_hist)`` (numpy)."""
    # observability is threaded through the serving configs, not turned
    # on globally here: the run exercises the same wiring users get
    ocfg = (
        ObsConfig(enabled=True)
        if (args.metrics_out or args.trace_out) else None
    )
    reqs = make_requests(model, cfg, args, device)
    Mc = reqs[0].num_candidates
    shortlist = min(args.shortlist, Mc)
    # no chunk_size on the session config: the router's chunk is its
    # own, and the parity reranks stay whole-slate calls (K1 on the
    # card), not the chunk kernels the router runs
    rr = Reranker(DPPRerankConfig(
        slate_size=args.slate, shortlist=shortlist, alpha=args.alpha,
        use_kernel=args.use_kernel,
    ), router_config=RouterConfig(
        slots=args.slots, chunk_size=args.chunk, max_queue=args.requests,
        max_candidates=shortlist, obs=ocfg,
    ), device=device)

    # warm the kernels' loads and the slot state out of the measurement;
    # the warm set covers a masked request too
    warm_reqs = list(reqs[: args.slots])
    if warm_reqs and not any(r.mask is not None for r in warm_reqs):
        masked = next((r for r in reqs if r.mask is not None), None)
        if masked is not None:
            warm_reqs[-1] = masked
    warm = [rr.submit(r) for r in warm_reqs]
    rr.router.drain()
    reg = obs.registry()
    mon = RebuildMonitor(reg) if reg is not None else None
    if mon is not None:
        mon.mark()  # every rebuild past here happens in the measured loop
    st0 = rr.router.stats

    gap = 1.0 / args.qps
    t0 = time.perf_counter()
    handles, arrived, done_at = [], {}, {}
    pending = list(reqs)
    offered = 0
    while pending or any(not h.done for h in handles):
        now = time.perf_counter() - t0
        while pending and offered * gap <= now:
            try:
                h = rr.submit(pending[0])
            except RouterQueueFull:
                break
            arrived[id(h)] = now
            handles.append(h)
            pending.pop(0)
            offered += 1
        rr.router.pump()
        now = time.perf_counter() - t0
        for h in handles:
            if h.done and id(h) not in done_at:
                done_at[id(h)] = now
    makespan = max(done_at.values())

    lat = np.array([done_at[id(h)] - arrived[id(h)] for h in handles])
    ttfc = np.array([h.ttfc for h in handles if h.ttfc is not None])
    # read the rebuild count BEFORE the parity sample, whose per-request
    # rerank loads the whole-slate kernels
    rebuilds = int(mon.since_mark()) if mon is not None else None
    checked = (list(zip(warm_reqs, warm))
               + list(zip(reqs, handles))[: args.parity_sample])
    pairs, parity_ok = [], True
    for req, h in checked:
        if h.timed_out:
            continue
        ei, ed = rr.rerank(req)
        ei, ed = ei.cpu().numpy(), ed.cpu().numpy()
        pairs.append((req, h, ei, ed))
        parity_ok &= bool(np.array_equal(h.slate()[0], ei))
    st = stats_since(rr.router.stats, st0)
    out = {
        "arch": args.arch,
        "device": str(device),
        "requests": len(handles),
        "candidates": Mc,
        "slots": args.slots,
        "chunk": args.chunk,
        "offered_qps": args.qps,
        "sustained_qps": round(len(handles) / makespan, 1),
        "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 2),
        "p95_ms": round(float(np.percentile(lat, 95)) * 1e3, 2),
        "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 2),
        "mean_ttfc_ms": round(float(ttfc.mean()) * 1e3, 2),
        "fill_ratio": round(st.fill_ratio, 3),
        "completed": st.completed,
        "timed_out": st.timed_out,
        "eps_stopped": st.eps_stopped,
        "parity_sample_ok": parity_ok,
    }
    if rebuilds is not None:
        out["rebuilds_after_warmup"] = rebuilds
    return out, rr, pairs


def main(argv=None):
    args = parser().parse_args(argv)
    spec = get_arch(args.arch)
    if spec.family != "recsys":
        raise ValueError("the serving launcher targets the recsys family")
    cfg = spec.reduced() if args.reduced else spec.config
    device = resolve_device(args.device)
    model = init_params(torch.Generator(device).manual_seed(0), cfg)
    out, _, _ = serve(model, cfg, args, device)
    print(json.dumps(out, indent=1))
    if obs.registry() is not None:
        out["obs"] = obs.registry().snapshot()
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(out, f)
    if args.trace_out and obs.tracer() is not None:
        obs.tracer().write_chrome(args.trace_out)
        print(f"trace: {args.trace_out} ({obs.tracer().total} spans)")
    if not out["parity_sample_ok"]:
        raise SystemExit("router slates diverged from per-request rerank")
    return out


if __name__ == "__main__":
    main()
