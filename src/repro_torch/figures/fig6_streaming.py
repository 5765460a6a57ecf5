"""Streaming slate emission: time-to-first-chunk vs whole-slate latency
(beyond-paper; the serving shape the NeurIPS'18 sliding window exists
for — repulsion only among nearby items means a long feed can start
rendering after the first chunk instead of blocking on the whole
slate); the counterpart of ``repro``'s ``benchmarks/fig6_streaming.py``.

For a windowed long-slate config (N >> w) each backend serves the same
request twice: once through whole-slate ``Reranker.rerank`` and once
through ``Reranker.stream`` with ``chunk_size`` items per chunk.
Reported per row: steady-state time-to-first-chunk (the headline
number), the whole-slate latency it undercuts, the full-stream wall
clock (the price of chunking), and a parity flag — the concatenated
chunks must equal the whole slate index for index, checked every run
and failed red on mismatch.  On the card, time-to-first-chunk must
beat the whole slate, also red on failure; on the CPU that ordering is
reported, not asserted (the plain versions' times share the host).

The ``kernel`` row (``use_kernel=True``, ``tile_m=128``) runs the whole
slate as K4 (one launch a step) and the stream as K6 (one cooperative
launch a chunk).  ``repro`` counts the fused chunk's ``pallas_call``s in
a jaxpr; here the kernels' own launch counters count a stream's K6
launches, and on the card there must be exactly one per chunk
(``fused_calls_per_chunk``).  On the CPU the kernel row runs the
kernels' plain versions, which launch nothing: the count reads ``n/a``.

  python -m repro_torch.figures.fig6_streaming [--smoke | --full] [--device cuda|cpu]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.figures.common import (
    best_time,
    device_line,
    launch_delta,
    parse,
    sync,
)
from repro_torch.kernels import cuda
from repro_torch.serving import DPPRerankConfig, Reranker, RerankRequest

K6 = "fused_chunk_windowed"
ALPHA = 3.0
EPS = 1e-6


def setup(M, D, seed=0, device=None):
    """Uniform scores (M,) and unit-norm Gaussian features (M, D),
    float32 on the device (``repro``'s draws)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(M, D)).astype(np.float32)
    feats /= np.maximum(np.linalg.norm(feats, axis=1, keepdims=True), 1e-12)
    scores = rng.uniform(size=M).astype(np.float32)
    return torch.as_tensor(scores, device=dev), torch.as_tensor(feats,
                                                                device=dev)


def time_whole(rr, req, trials):
    """Least whole-slate wall of ``trials`` after a warm call, and the
    slate."""
    out = {}

    def whole():
        out["slate"] = rr.rerank(req)[0]

    t = best_time(whole, trials, rr.device)
    return t, out["slate"].cpu().numpy()


def stream_once(rr, req):
    """One stream: (time to first chunk, whole stream, the slate)."""
    sync(rr.device)
    chunks, t_first = [], None
    t0 = time.perf_counter()
    for c, _ in rr.stream(req):
        sync(rr.device)
        if t_first is None:
            t_first = time.perf_counter() - t0
        chunks.append(c.cpu().numpy())
    return t_first, time.perf_counter() - t0, np.concatenate(chunks)


def time_stream(rr, req, trials):
    stream_once(rr, req)  # warm
    best_first = best_total = float("inf")
    for _ in range(trials):
        t_first, t_total, streamed = stream_once(rr, req)
        best_first = min(best_first, t_first)
        best_total = min(best_total, t_total)
    return best_first, best_total, streamed


def run(M, D, N, w, chunk, trials, device=None):
    """One dict a backend (``torch``, ``kernel``): the times, the K6
    launches a chunk, the parity flag and the whole and streamed slates
    ((N,) global ids, numpy)."""
    dev = resolve_device(device)
    scores, feats = setup(M, D, device=dev)
    req = RerankRequest(scores=scores, feats=feats)
    base = dict(slate_size=N, shortlist=M, alpha=ALPHA, eps=EPS, window=w)
    rows = []
    for name, extra in [
        ("torch", {}),
        ("kernel", dict(use_kernel=True, tile_m=128)),
    ]:
        # whole-slate latency: the UNCHUNKED path (chunk_size also
        # switches the kernel backend to chunked execution, which is the
        # streaming path's cost, not the blocking baseline's)
        whole_rr = Reranker(DPPRerankConfig(**base, **extra), device=dev)
        stream_rr = Reranker(DPPRerankConfig(**base, **extra,
                                             chunk_size=chunk), device=dev)
        t_whole, slate = time_whole(whole_rr, req, trials)
        t_first, t_total, streamed = time_stream(stream_rr, req, trials)
        fused = None
        if extra and dev.type == "cuda":
            before = cuda.launch_counts()
            stream_once(stream_rr, req)
            fused = (launch_delta(before, cuda.launch_counts()).get(K6, 0)
                     / -(-N // chunk))
        rows.append(dict(
            name=name, M=M, D=D, N=N, w=w, chunk=chunk, t_first=t_first,
            t_whole=t_whole, t_total=t_total, fused_calls_per_chunk=fused,
            parity="ok" if np.array_equal(slate, streamed) else "FAIL",
            slate=slate, streamed=streamed,
        ))
    return rows


def main(fast_mode=False, device=None):
    dev = resolve_device(device)
    # N >> chunk and M large enough that per-step compute (not per-call
    # dispatch overhead) dominates: time-to-first-chunk then has a
    # structural margin over the whole slate (c of N steps)
    M, D, N, w, chunk = (
        (2048, 32, 64, 8, 8) if fast_mode else (2048, 32, 96, 8, 8)
    )
    trials = 2 if fast_mode else 5
    rows = run(M, D, N, w, chunk, trials, device=dev)
    print(device_line(dev))
    print("name,us_per_call,derived")
    for r in rows:
        fused = ("n/a" if r["fused_calls_per_chunk"] is None
                 else f"{r['fused_calls_per_chunk']:.1f}")
        print(
            f"fig6_stream_{r['name']}_M{r['M']}_N{r['N']},"
            f"{r['t_first']*1e6:.1f},"
            f"whole_us={r['t_whole']*1e6:.1f};"
            f"stream_total_us={r['t_total']*1e6:.1f};"
            f"first_chunk_vs_whole={r['t_first']/max(r['t_whole'], 1e-12):.2f}x;"
            f"chunk={r['chunk']};w={r['w']};fused_calls_per_chunk={fused};"
            f"parity={r['parity']}"
        )
    bad = [r["name"] for r in rows if r["parity"] != "ok"]
    if bad:
        raise RuntimeError(f"fig6 streamed-vs-whole parity failure: {bad}")
    # a wall-clock ordering is the card's claim: on the CPU the plain
    # versions' times share the host with whatever else runs there
    slow = [r["name"] for r in rows if not r["t_first"] < r["t_whole"]]
    if dev.type == "cuda" and slow:
        raise RuntimeError(
            f"fig6: time-to-first-chunk did not beat whole-slate latency: "
            f"{slow}"
        )
    fused_bad = [r["name"] for r in rows
                 if r["fused_calls_per_chunk"] not in (None, 1.0)]
    if fused_bad:
        raise RuntimeError(
            f"fig6: the stream did not make exactly one {K6} launch per "
            f"chunk: {fused_bad}"
        )
    return rows


if __name__ == "__main__":
    fast, dev = parse(__doc__)
    main(fast_mode=fast, device=dev)
