"""End-to-end serving example: CTR scoring + Div-DPP slate diversification
over batched requests (the paper's production scenario), followed by a
streaming-emission demo — a long windowed feed served chunk by chunk
through ``Reranker.stream`` instead of blocking on the whole slate —
a continuous-batching demo where heterogeneous live requests share
one micro-batch through ``Reranker.submit``, and a session demo where
one user's feed resumes the warm windowed state across scroll events
(``Reranker.session``) and delta-updates when new candidates arrive;
the counterpart of ``repro``'s ``examples/serve_recsys.py``.

  python -m repro_torch.examples.serve_recsys [--device cuda|cpu]

Every part runs the kernels (``use_kernel=True``): on the card DeepFM's
FM term is K8, the slates K1, the stream and the router K5/K6 chunks
and every session scroll one K6 launch; with ``--device cpu`` their
plain PyTorch versions.  The weights are random, drawn from a seed.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.serve import main as serve_main
from repro_torch.serving import (
    DPPRerankConfig,
    Reranker,
    RerankRequest,
    RouterConfig,
    SessionConfig,
)


def _unit_rows(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def stream_demo(device=None):
    """Serve a long diversified feed incrementally: the sliding window
    only enforces repulsion among nearby items, so the first chunk ships
    after ``chunk_size`` greedy steps — the client can start rendering
    while the rest of the feed is still being selected.  The
    concatenated chunks are exactly the whole-slate ``rerank`` result.
    Returns ``(reranker, request, chunk ids)``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    M, D = 2000, 32
    feats = _unit_rows(rng.normal(size=(M, D)).astype(np.float32))
    scores = rng.uniform(size=M).astype(np.float32)
    rr = Reranker(DPPRerankConfig(
        slate_size=40,      # a feed, not a panel — longer than the window
        shortlist=500,
        alpha=3.0,
        window=8,           # diversity against the last 8 items only
        chunk_size=10,      # emit the feed 10 items at a time
        eps=1e-6,
        use_kernel=True,
    ), device=dev)
    req = RerankRequest(scores=torch.as_tensor(scores, device=dev),
                        feats=torch.as_tensor(feats, device=dev))
    print("# streaming feed (window=8, 10 items per chunk):")
    chunks = []
    for n, (ids, d_hist) in enumerate(rr.stream(req)):
        chunks.append(ids.cpu().numpy())
        shown = " ".join(f"{int(i):4d}" for i in chunks[-1])
        print(f"chunk {n}: [{shown}]  min marginal {float(d_hist.min()):.4f}")
    return rr, req, chunks


def router_demo(device=None):
    """Continuous batching: four users with different slate lengths and
    already-seen masks arrive together; ``submit`` coalesces them into
    one shared micro-batch (one launch a cycle) instead of serving them
    one slate at a time.  Returns ``(reranker, requests, handles)``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(1)
    M, D = 1000, 32
    feats = torch.as_tensor(
        _unit_rows(rng.normal(size=(M, D)).astype(np.float32)), device=dev)
    rr = Reranker(
        DPPRerankConfig(slate_size=16, shortlist=200, alpha=3.0,
                        chunk_size=4, eps=1e-6, use_kernel=True),
        router_config=RouterConfig(slots=4, chunk_size=4), device=dev,
    )
    reqs = []
    for u in range(4):
        mask = None
        if u % 2:  # some users have already seen part of the pool
            m = np.ones(M, bool)
            m[rng.choice(M, size=M // 5, replace=False)] = False
            mask = torch.as_tensor(m, device=dev)
        reqs.append(RerankRequest(
            scores=torch.as_tensor(rng.uniform(size=M).astype(np.float32),
                                   device=dev),
            feats=feats, slate_size=8 + 2 * u, mask=mask, rid=f"user{u}",
        ))
    handles = [rr.submit(r) for r in reqs]
    rr.router.drain()
    print("# continuous-batching router (4 heterogeneous users, 4 slots):")
    for h in handles:
        ids, _ = h.slate()
        print(f"{h.rid}: k={len(ids)} slate={ids.tolist()}")
    st = rr.router.stats
    print(f"batch fill ratio {st.fill_ratio:.2f}, "
          f"mean TTFC {st.mean_ttfc * 1e3:.1f} ms")
    return rr, reqs, handles


def session_demo(device=None):
    """Session-aware incremental rerank: one user scrolls a feed across
    several requests while the candidate pool drifts.  ``rr.session``
    keeps the windowed greedy state warm between scroll events — each
    ``next_chunk`` resumes where the last stopped, and ``extend`` /
    ``rescore`` delta-update only the affected columns instead of
    re-running greedy over everything already shown.  Returns the ids
    of each scroll (numpy)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(2)
    M, D = 1500, 32
    feats = _unit_rows(rng.normal(size=(M, D)).astype(np.float32))
    rr = Reranker(
        DPPRerankConfig(slate_size=18, shortlist=300, alpha=3.0,
                        window=8, chunk_size=6, eps=1e-6, use_kernel=True),
        session_config=SessionConfig(budget_bytes=64 << 20), device=dev,
    )
    sess = rr.session(RerankRequest(
        scores=torch.as_tensor(rng.uniform(size=M).astype(np.float32),
                               device=dev),
        feats=torch.as_tensor(feats, device=dev),
    ))
    print("# session feed (window=8, 6 items per scroll):")
    scrolls = []
    for event in range(2):
        ids, gains = sess.next_chunk(6)
        scrolls.append(ids)
        shown = " ".join(f"{int(i):4d}" for i in ids)
        print(f"scroll {event}: [{shown}]  min marginal "
              f"{float(np.min(gains)):.4f}")

    # fresh candidates land mid-session; the next scroll conditions on
    # everything already shown AND sees the new arrivals
    dm = 200
    sess.extend(
        torch.as_tensor(rng.uniform(size=dm).astype(np.float32) + 0.5,
                        device=dev),
        torch.as_tensor(_unit_rows(rng.normal(size=(dm, D)).astype(
            np.float32)), device=dev),
    )
    ids, gains = sess.next_chunk(6)
    scrolls.append(ids)
    fresh = sum(1 for i in ids if int(i) >= M)
    shown = " ".join(f"{int(i):4d}" for i in ids)
    print(f"scroll 2 after extend(+{dm}): [{shown}]  "
          f"({fresh} fresh candidates picked)")
    print(f"shown so far: {len(sess.shown)} items")
    return scrolls


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = ap.parse_args(argv).device
    serve_main([
        "--arch", "deepfm", "--requests", "16", "--candidates", "2000",
        "--slate", "10", "--shortlist", "200", "--alpha", "3.0",
        "--use-kernel", "--device", device,
    ])
    stream_demo(device)
    router_demo(device)
    session_demo(device)


if __name__ == "__main__":
    main()
