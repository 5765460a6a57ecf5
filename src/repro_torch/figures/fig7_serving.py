"""Continuous-batching serving: sustained QPS vs latency percentiles
(beyond-paper; the serving shape the slot-batched router exists for:
heterogeneous live requests share one micro-batch instead of queueing
behind each other's whole slates); the counterpart of ``repro``'s
``benchmarks/fig7_serving.py``.

Two measurements over the same synthetic client (heterogeneous
requests: mixed candidate counts, slate lengths and masks):

* **burst TTFC**: R requests arrive at once; serial request-at-a-time
  streaming serves them one ``Reranker.stream`` after another (request
  i's first chunk waits for slates 0..i-1), the router serves them as
  one continuously batched micro-batch.  The router's mean
  time-to-first-chunk must not exceed the serial path's: that is the
  continuous-batching claim, asserted on the card.
* **open-loop sweep**: requests offered at a fixed rate; reported per
  rate: completed QPS, p50/p95/p99 completion latency, mean TTFC, batch
  fill ratio and peak slot concurrency.

Every completed router slate is checked index for index against the
per-request ``Reranker.rerank`` on the same inputs (each serial stream
too, as a prefix of it); parity failures, a
batch fill ratio below 0.5, or peak concurrency below 4 sustained
heterogeneous requests fail the run red.

The port runs the kernel backend (``use_kernel=True``): on the card the
router's cycles and the serial streams are K5 launches, the reference
reranks K1.  ``repro``'s figure runs its jnp core, where serial
streaming also compiles one program per slate length.  On the CPU the
kernels' plain versions run, the times are host times of the plain
path, and the TTFC ordering is reported, not asserted.

  python -m repro_torch.figures.fig7_serving [--smoke | --full] [--device cuda|cpu]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.figures.common import device_line, parse, sync
from repro_torch.serving import (
    DPPRerankConfig,
    Reranker,
    RerankRequest,
    RouterConfig,
    RouterQueueFull,
)


def make_requests(n, M_lo, M_hi, D, k_lo, k_hi, seed=0, device=None):
    """Heterogeneous request mix on the device: per-request M, k and an
    occasional already-seen mask (``repro``'s draws)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        M = int(rng.integers(M_lo, M_hi + 1))
        feats = rng.normal(size=(M, D)).astype(np.float32)
        feats /= np.maximum(np.linalg.norm(feats, axis=1, keepdims=True),
                            1e-12)
        scores = rng.uniform(0.05, 1.0, size=M).astype(np.float32)
        mask = None
        if i % 3 == 2:  # every third user has seen a slice of the pool
            m = np.ones(M, bool)
            m[rng.choice(M, size=M // 4, replace=False)] = False
            mask = torch.as_tensor(m, device=dev)
        reqs.append(RerankRequest(
            scores=torch.as_tensor(scores, device=dev),
            feats=torch.as_tensor(feats, device=dev),
            slate_size=int(rng.integers(k_lo, k_hi + 1)), mask=mask, rid=i,
        ))
    return reqs


def expected_slates(rr, reqs):
    """Per-request ``rerank`` slates ``(ids, d_hist)``, numpy."""
    return [tuple(x.cpu().numpy() for x in rr.rerank(r)) for r in reqs]


def check_parity(handles, expect):
    bad = []
    for h, (ei, _) in zip(handles, expect):
        gi, _ = h.slate()
        if not np.array_equal(gi, ei):
            bad.append((h.rid, gi.tolist(), ei.tolist()))
    return bad


def burst_serial_ttfc(rr, reqs, chunk):
    """Request-at-a-time: stream each request fully before the next
    starts, ``chunk`` items a chunk; TTFC is measured from the shared
    burst start, each chunk waited for on the device.  Returns the TTFCs
    and the streamed slates (numpy ids, cut where an eps-stop ended the
    stream)."""
    t0 = time.perf_counter()
    ttfc, slates = [], []
    for req in reqs:
        first, chunks = None, []
        for ids, _ in rr.stream(req, chunk_size=chunk):
            sync(rr.device)
            if first is None:
                first = time.perf_counter() - t0
            chunks.append(ids)
        ttfc.append(first)
        slates.append(torch.cat(chunks).cpu().numpy())
    return ttfc, slates


def check_streams(slates, expect):
    """Each streamed slate is a prefix of its rerank slate that covers
    every real selection (``Reranker.stream``'s contract)."""
    return [(i, s.tolist(), ei.tolist())
            for i, (s, (ei, _)) in enumerate(zip(slates, expect))
            if not (np.array_equal(s, ei[: len(s)])
                    and (ei[len(s):] < 0).all())]


def drive_open_loop(rr, reqs, expect, gap_s):
    """Offer one request every ``gap_s`` seconds; pump continuously.
    Returns per-request completion latency, TTFC, the peak slot
    occupancy, parity failures and the makespan."""
    peak = 0
    t0 = time.perf_counter()
    pending = list(reqs)
    handles, done_at, arrived_at = [], {}, {}
    i = 0
    while pending or any(not h.done for h in handles):
        now = time.perf_counter() - t0
        while pending and i * gap_s <= now:
            try:
                h = rr.submit(pending[0])
            except RouterQueueFull:
                break  # backpressure: retry this arrival next cycle
            arrived_at[id(h)] = now
            handles.append(h)
            pending.pop(0)
            i += 1
        rr.router.pump()
        peak = max(peak, rr.router.stats.slot_occupancy)
        now = time.perf_counter() - t0
        for h in handles:
            if h.done and id(h) not in done_at:
                done_at[id(h)] = now
    lat = [done_at[id(h)] - arrived_at[id(h)] for h in handles]
    ttfc = [h.ttfc for h in handles if h.ttfc is not None]
    bad = check_parity(handles, expect[: len(handles)])
    makespan = max(done_at.values()) if done_at else 1e-12
    return lat, ttfc, peak, bad, makespan


def pct(xs, q):
    return float(np.percentile(np.asarray(xs, float), q)) if xs else 0.0


def run(fast_mode, device=None):
    """Returns ``(rows, failures)``: the CSV rows and the red gates."""
    dev = resolve_device(device)
    M_lo, M_hi, D = (256, 512, 16) if fast_mode else (1024, 2048, 32)
    k_lo, k_hi = (8, 16) if fast_mode else (16, 32)
    shortlist = 128 if fast_mode else 512
    slots, chunk = 4, 4
    n_burst = 8
    n_open = 12 if fast_mode else 32
    # the chunk is the router's and the streams' own: the reference
    # reranks stay whole-slate calls (K1 on the card)
    cfg = DPPRerankConfig(slate_size=k_hi, shortlist=shortlist, alpha=3.0,
                          eps=1e-6, use_kernel=True)
    rcfg = RouterConfig(slots=slots, chunk_size=chunk, max_queue=64,
                        max_candidates=shortlist)

    rows, failures = [], []

    # -- burst: router TTFC vs serial request-at-a-time streaming ----------
    reqs = make_requests(n_burst, M_lo, M_hi, D, k_lo, k_hi, seed=1,
                         device=dev)
    rr = Reranker(cfg, router_config=rcfg, device=dev)
    expect = expected_slates(rr, reqs)
    # warm both paths (the kernels' loads, the slot state) out of the
    # measurement, and hold the warm slates too
    _, warm = burst_serial_ttfc(rr, reqs[:1], chunk)
    wh = [rr.submit(r) for r in reqs[:slots]]
    rr.router.drain()
    bad = check_parity(wh, expect) + check_streams(warm, expect)
    serial, streamed = burst_serial_ttfc(rr, reqs, chunk)
    handles = [rr.submit(r) for r in reqs]
    rr.router.drain()
    routed = [h.ttfc for h in handles]
    bad += check_parity(handles, expect) + check_streams(streamed, expect)
    if bad:
        failures.append(f"burst parity: {bad[:2]}")
    st = rr.router.stats
    rows.append(
        ("fig7_burst_ttfc", np.mean(routed) * 1e6,
         f"serial_mean_us={np.mean(serial)*1e6:.1f};"
         f"router_vs_serial={np.mean(routed)/max(np.mean(serial),1e-12):.2f}x;"
         f"R={n_burst};slots={slots};fill={st.fill_ratio:.2f};"
         f"parity={'FAIL' if bad else 'ok'}")
    )
    if dev.type == "cuda" and np.mean(routed) > np.mean(serial):
        failures.append(
            f"router burst TTFC {np.mean(routed)*1e3:.3f}ms exceeds serial "
            f"request-at-a-time {np.mean(serial)*1e3:.3f}ms"
        )
    if st.fill_ratio < 0.5:
        failures.append(f"burst batch fill ratio {st.fill_ratio:.2f} < 0.5")

    # -- open-loop sweep: offered rate vs latency percentiles --------------
    # calibrate the offered rates to this machine: gaps around the idle
    # cycle time keep the router busy without unbounded queueing
    t0 = time.perf_counter()
    rr.router.pump()
    cycle = max(time.perf_counter() - t0, 1e-4)
    for rate_name, gap in [("hot", cycle), ("steady", 4 * cycle)]:
        reqs = make_requests(n_open, M_lo, M_hi, D, k_lo, k_hi, seed=7,
                             device=dev)
        rr = Reranker(cfg, router_config=rcfg, device=dev)
        expect = expected_slates(rr, reqs)
        wh = [rr.submit(r) for r in reqs[:slots]]  # warm the slot geometry
        rr.router.drain()
        bad = check_parity(wh, expect)
        rr2 = Reranker(cfg, router_config=rcfg, device=dev)
        lat, ttfc, peak, bad2, makespan = drive_open_loop(
            rr2, reqs, expect, gap
        )
        bad += bad2
        if bad:
            failures.append(f"open-loop {rate_name} parity: {bad[:2]}")
        st = rr2.router.stats
        qps = len(lat) / makespan
        rows.append(
            (f"fig7_openloop_{rate_name}", pct(lat, 50) * 1e6,
             f"p95_us={pct(lat, 95)*1e6:.1f};p99_us={pct(lat, 99)*1e6:.1f};"
             f"qps={qps:.1f};ttfc_us={np.mean(ttfc)*1e6:.1f};"
             f"gap_us={gap*1e6:.1f};n={len(lat)};peak_concurrency={peak};"
             f"fill={st.fill_ratio:.2f};"
             f"parity={'FAIL' if bad else 'ok'}")
        )
        if rate_name == "hot":
            if peak < 4:
                failures.append(
                    f"hot open-loop peak concurrency {peak} < 4 "
                    f"heterogeneous requests"
                )
            if st.fill_ratio < 0.5:
                failures.append(
                    f"hot open-loop batch fill ratio {st.fill_ratio:.2f} "
                    f"< 0.5"
                )
    return rows, failures


def main(fast_mode=False, device=None):
    dev = resolve_device(device)
    rows, failures = run(fast_mode, device=dev)
    print(device_line(dev))
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    if failures:
        raise RuntimeError(f"fig7 serving gate failures: {failures}")
    return rows


if __name__ == "__main__":
    fast, dev = parse(__doc__)
    main(fast_mode=fast, device=dev)
