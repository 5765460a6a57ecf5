"""Observability end to end: the router pump's host time split by phase
from real spans, and the rebuild ledger (beyond-paper; exercises
``repro_torch.obs`` across the router, streaming and dispatch layers the
way an operator would); the counterpart of ``repro``'s
``benchmarks/fig8_observability.py``.

One obs session spans two workloads over one candidate pool:

* **router** — heterogeneous k / mask requests at one candidate width
  through the continuous-batching router (``use_kernel=True``: K5 on the
  card, its plain version on the CPU).  The slot geometry is warmed, the
  ``RebuildMonitor`` ``mark()``-ed, and the measured drive must show
  **zero** rebuilds (kernel builds, library loads, slot-state
  allocations) after warmup: "the router never rebuilds" as an observed
  counter, not an argument from code structure.  Every ``router.pump``
  span must decompose into its ``.evict`` / ``.admit`` / ``.launch`` /
  ``.materialize`` children (``.sync`` once a chunk is in flight), and
  the rows are the mean microseconds each phase took — admit (host prep
  and splice) vs launch (async dispatch) vs materialize (delivery from
  the pinned copies) vs sync (the wait for the previous chunk).
* **per-k serial streaming** — the counter-example: each distinct slate
  length streams through ``Reranker.stream`` on a whole-request state of
  its own (``greedy_state_allocs_total{k}``), so the ledger must show at
  least one state allocation per distinct k.

Gates (each a failure of the run): zero rebuilds after warmup, at least
one state allocation per distinct serial k, complete pump decomposition,
a schema-valid Chrome trace export, nonzero dispatch telemetry (chunks
and marginal evaluations), and, new in the port, parity: every router
slate equals its per-request ``rerank`` (K1 on the card) index for index
with ``d_hist`` bit for bit on the card (within rtol 3e-4 / atol 1e-5 on
the CPU, where the plain versions round apart), and every serial stream
is a prefix of it.  No gate compares wall-clock times.

  python -m repro_torch.figures.fig8_observability [--smoke | --full] [--device cuda|cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.figures.common import device_line, parse, sync
from repro_torch.obs import ObsConfig, validate_chrome_trace
from repro_torch.obs.dispatch import RebuildMonitor
from repro_torch.serving import (
    DPPRerankConfig,
    Reranker,
    RerankRequest,
    RouterConfig,
)

PUMP_PHASES = ("evict", "admit", "launch", "materialize")
RTOL, ATOL = 3e-4, 1e-5  # d_hist on the CPU: the plain versions' rounding


def make_requests(n, M, D, k_lo, k_hi, seed=0, device=None):
    """Heterogeneous k and masks at ONE candidate width (``repro``'s
    draws), on the device: the shape mix the router serves from one
    launch geometry."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(M, D)).astype(np.float32)
    feats /= np.maximum(np.linalg.norm(feats, axis=1, keepdims=True), 1e-12)
    feats = torch.as_tensor(feats, device=dev)
    reqs = []
    for i in range(n):
        scores = rng.uniform(0.05, 1.0, size=M).astype(np.float32)
        mask = None
        if i % 3 == 2:
            m = np.ones(M, bool)
            m[rng.choice(M, size=M // 4, replace=False)] = False
            mask = torch.as_tensor(m, device=dev)
        reqs.append(RerankRequest(
            scores=torch.as_tensor(scores, device=dev), feats=feats,
            slate_size=int(rng.integers(k_lo, k_hi + 1)), mask=mask, rid=i,
        ))
    return reqs


def pump_breakdown(spans):
    """Span counts, mean and total microseconds by span name."""
    counts, totals = {}, {}
    for s in spans:
        counts[s["name"]] = counts.get(s["name"], 0) + 1
        totals[s["name"]] = totals.get(s["name"], 0.0) + s["dur_us"]
    means = {n: totals[n] / counts[n] for n in counts}
    return counts, means, totals


def slate_parity(got, want, exact):
    """None when the router slate ``got`` equals the rerank slate
    ``want`` ((ids, d_hist) numpy): ids index for index, d_hist bit for
    bit (``exact``) or within rtol / atol; else what differs."""
    (gi, gd), (ei, ed) = got, want
    if not np.array_equal(gi, ei):
        return f"ids {gi.tolist()} != {ei.tolist()}"
    if exact and not np.array_equal(gd, ed):
        return f"d_hist differs by {np.abs(gd - ed).max()}"
    if not exact and not np.allclose(gd, ed, rtol=RTOL, atol=ATOL):
        return f"d_hist beyond rtol {RTOL} / atol {ATOL}"
    return None


def run(fast_mode, device=None):
    """Returns ``(rows, failures, slates)``: the CSV rows, the red gates
    and the router's slates ((ids, d_hist) numpy, by request)."""
    dev = resolve_device(device)
    M, D = (192, 16) if fast_mode else (1024, 32)
    shortlist = min(96 if fast_mode else 256, M)
    k_lo, k_hi = (6, 12) if fast_mode else (16, 32)
    slots, chunk = 4, 4
    n_req = 12 if fast_mode else 32

    rows, failures = [], []
    obs.disable()  # a fresh session owns the whole run
    session = obs.enable(ObsConfig(enabled=True))
    tracer, reg = session.tracer, session.registry
    monitor = RebuildMonitor(reg)

    # the chunk is the router's and the streams' own: the reference
    # reranks stay whole-slate calls (K1 on the card)
    cfg = DPPRerankConfig(slate_size=k_hi, shortlist=shortlist, alpha=3.0,
                          eps=1e-6, use_kernel=True)
    rr = Reranker(cfg, router_config=RouterConfig(
        slots=slots, chunk_size=chunk, max_queue=2 * n_req,
        max_candidates=shortlist,
    ), device=dev)
    reqs = make_requests(n_req, M, D, k_lo, k_hi, seed=3, device=dev)

    # -- router: warm, mark, drive, expect zero rebuilds ----------------------
    warm = [rr.submit(r) for r in reqs[:slots]]
    rr.router.drain()
    if not all(h.done for h in warm):
        failures.append("router warmup left unfinished handles")
    sync(dev)
    monitor.mark()
    n_spans_before = len(tracer)
    handles = [rr.submit(r) for r in reqs[slots:]]
    rr.router.drain()
    sync(dev)
    if not all(h.done for h in handles):
        failures.append("router drive left unfinished handles")
    rebuilds = int(monitor.since_mark())
    if rebuilds != 0:
        failures.append(
            f"router rebuilt: {rebuilds} kernel builds, library loads or "
            f"slot-state allocations after warmup (expected 0: per-request "
            f"k and mask stay in data)")

    spans = tracer.finished()[n_spans_before:]
    counts, means, totals = pump_breakdown(
        [s for s in spans if s["name"].startswith("router.pump")])
    pumps = counts.get("router.pump", 0)
    if pumps == 0:
        failures.append("no router.pump spans recorded")
    for phase in PUMP_PHASES:
        got = counts.get(f"router.pump.{phase}", 0)
        if got != pumps:
            failures.append(
                f"pump decomposition incomplete: {got} router.pump.{phase} "
                f"spans for {pumps} pumps")
    # sync exists for every pump that had a chunk in flight
    if counts.get("router.pump.sync", 0) < max(pumps - 1, 0):
        failures.append(
            f"expected >= {pumps - 1} router.pump.sync spans, got "
            f"{counts.get('router.pump.sync', 0)}")
    pump_total = max(totals.get("router.pump", 0.0), 1e-9)
    for phase in PUMP_PHASES + ("sync",):
        name = f"router.pump.{phase}"
        rows.append((
            f"fig8_pump_{phase}", means.get(name, 0.0),
            f"pumps={pumps};share={totals.get(name, 0.0) / pump_total:.2f};"
            f"pump_mean_us={means.get('router.pump', 0.0):.1f};"
            f"rebuilds_after_warmup={rebuilds}",
        ))

    # -- per-k serial streaming: the allocation counter-example ---------------
    allocs = reg.counter("greedy_state_allocs_total")
    distinct_k = sorted({r.slate_size for r in reqs})
    before = allocs.total()
    streamed = {}
    for k in distinct_k:
        i = [q.slate_size for q in reqs].index(k)
        streamed[i] = torch.cat(
            [ids for ids, _ in rr.stream(reqs[i], chunk_size=chunk)]
        ).cpu().numpy()
    serial = int(allocs.total() - before)
    rows.append((
        "fig8_serial_per_k_misses", float(serial),
        f"distinct_k={len(distinct_k)};"
        f"router_rebuilds_after_warmup={rebuilds}",
    ))
    if serial < len(distinct_k):
        failures.append(
            f"per-k serial streaming allocated {serial} states for "
            f"{len(distinct_k)} distinct k (expected >= 1 each: a stream "
            f"owns a whole-request state whose rows k shapes)")

    # -- exports: schema-valid trace, live dispatch telemetry -----------------
    doc = tracer.export_chrome()
    err = validate_chrome_trace(doc)
    if err is not None:
        failures.append(f"chrome trace schema: {err}")
    snap = reg.snapshot()
    chunks = sum(snap["counters"].get("greedy_chunks_total", {}).values())
    evals = sum(snap["counters"].get("marginal_evals_total", {}).values())
    if chunks <= 0 or evals <= 0:
        failures.append(
            f"dispatch telemetry empty: chunks={chunks} evals={evals}")
    rows.append((
        "fig8_trace_export", float(len(doc["traceEvents"])),
        f"schema={'ok' if err is None else 'FAIL'};"
        f"spans_total={tracer.total};dropped={tracer.dropped};"
        f"chunks={int(chunks)};marginal_evals={int(evals)}",
    ))

    # -- parity: every router slate and stream against its rerank -------------
    slates = [h.slate() for h in warm + handles]
    want = [tuple(x.cpu().numpy() for x in rr.rerank(r)) for r in reqs]
    exact = dev.type == "cuda"
    bad = [(r.rid, why) for r, got, ref in zip(reqs, slates, want)
           if (why := slate_parity(got, ref, exact)) is not None]
    bad += [(reqs[i].rid, "stream is not a prefix of the rerank slate")
            for i, ids in streamed.items()
            if not (np.array_equal(ids, want[i][0][: len(ids)])
                    and (want[i][0][len(ids):] < 0).all())]
    if bad:
        failures.append(f"parity against the per-request rerank: {bad[:2]}")
    # the session stays installed: figures.run snapshots it into
    # BENCH_fig8.json and owns the teardown
    return rows, failures, slates


def main(fast_mode=False, device=None):
    dev = resolve_device(device)
    rows, failures, _ = run(fast_mode, device=dev)
    print(device_line(dev))
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    if failures:
        raise RuntimeError(f"fig8 observability gate failures: {failures}")
    return rows


if __name__ == "__main__":
    fast, dev = parse(__doc__)
    main(fast_mode=fast, device=dev)
