"""The port's continuous-batching router against ``repro``'s, on the CPU.

The same seeded numpy requests go through ``repro.serving``'s router (on
its jnp core: its Pallas chunk kernels do not run on this tree's jax) and
through ``repro_torch.serving``'s, on both port backends: ``torch`` (the
plain core) and ``kernel`` (the plain versions of the fused chunk kernels
K5/K6, which the wrappers run for CPU tensors).  Both routers are driven
through the same sequence of ``submit``s and ``pump``s, and must agree:

* slates index for index, ``d_hist`` within ``tests/conftest.py``'s
  incremental ``GreedyOracle`` tolerance;
* ``RouterStats`` field for field, but ``ttfc_sum`` (a wall-clock sum).

``repro``'s own cases are ported as parametrised tests: heterogeneous
concurrent requests, seeded and Hypothesis interleaved arrivals, eps-stop
freeing a slot, deadlines lapsed before admission and in flight,
backpressure, FIFO without starvation, ``submit`` validation and the
metrics hook.  No test here asserts a wall-clock ordering or a rate:
``repro``'s ``test_router_ttfc_beats_serial_burst`` is Figure 7's gate,
checked on the card.  Also covered: the ``slots`` refusal against a small
co-residency (the CPU has no occupancy query), the rebuild telemetry,
``launch.serve_router`` at ``--reduced`` sizes and Figure 7's structure
at a tiny size.
"""
import dataclasses
import json
import time

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import _ORACLES
import repro.serving as js
from repro.serving.router import RouterQueueFull as JQueueFull
import repro_torch.serving as ts
from repro_torch import obs
from repro_torch.figures import fig7_serving
from repro_torch.launch import serve_router
from repro_torch.obs.dispatch import RebuildMonitor
from repro_torch.serving import router as router_mod

ORACLE = _ORACLES["incremental"]()
BACKENDS = ["torch", "kernel"]
COUNTERS = [f.name for f in dataclasses.fields(ts.RouterStats)
            if f.name != "ttfc_sum"]


def _data(seed, M, D=8, masked=False, rank1=False):
    rng = np.random.default_rng(seed)
    if rank1:  # all-identical features: the DPP eps-stops after one pick
        f = np.tile(rng.normal(size=(1, D)), (M, 1)).astype(np.float32)
        s = rng.uniform(0.5, 1.0, size=M).astype(np.float32)
    else:
        f = rng.normal(size=(M, D)).astype(np.float32)
        s = rng.uniform(0.1, 1.0, size=M).astype(np.float32)
    f /= np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-12)
    mask = None
    if masked:
        mask = np.ones(M, bool)
        mask[rng.choice(M, size=M // 4, replace=False)] = False
    return s, f, mask


def _pair(seed, M, k=None, masked=False, D=8, rank1=False, **kw):
    """The same request for ``repro`` (jnp arrays) and the port (numpy)."""
    s, f, mask = _data(seed, M, D, masked, rank1)
    j = js.RerankRequest(scores=jnp.asarray(s), feats=jnp.asarray(f),
                         slate_size=k,
                         mask=None if mask is None else jnp.asarray(mask),
                         **kw)
    t = ts.RerankRequest(scores=s, feats=f, slate_size=k, mask=mask, **kw)
    return j, t


def _sessions(backend, slots=2, chunk=3, bucket=32, k=8, window=None,
              max_queue=32, metrics_hook=None, **cfg_kw):
    base = dict(slate_size=k, shortlist=bucket, alpha=3.0, window=window,
                chunk_size=chunk, **cfg_kw)
    rkw = dict(slots=slots, chunk_size=chunk, max_candidates=bucket,
               max_queue=max_queue, metrics_hook=metrics_hook)
    jr = js.Reranker(js.DPPRerankConfig(**base),
                     router_config=js.RouterConfig(**rkw))
    tr = ts.Reranker(ts.DPPRerankConfig(use_kernel=backend == "kernel",
                                        **base),
                     router_config=ts.RouterConfig(**rkw), device="cpu")
    return jr, tr


def _stats(rr):
    st = rr.router.stats
    return {name: getattr(st, name) for name in COUNTERS}


def _assert_slates(jh, th):
    ji, jd = (np.asarray(x) for x in jh.result())
    ti, td = th.result()
    assert ti.dtype == np.int32 and td.dtype == np.float32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=ORACLE.dh_rtol,
                               atol=ORACLE.dh_atol)
    assert th.timed_out == jh.timed_out


def _drive_both(jr, tr, pairs, schedule=None):
    """Submit interleaved with pumps per ``schedule`` (pumps after each
    submit), drain, and compare slates and stats; returns the port's
    handles."""
    jhs, ths = [], []
    for i, (jq, tq) in enumerate(pairs):
        jhs.append(jr.submit(jq))
        ths.append(tr.submit(tq))
        for _ in range(schedule[i] if schedule else 0):
            jr.router.pump()
            tr.router.pump()
    jr.router.drain()
    tr.router.drain()
    for jh, th in zip(jhs, ths):
        _assert_slates(jh, th)
    assert _stats(tr) == _stats(jr)
    return ths


def _assert_rerank_parity(tr, pairs, handles):
    """Each port slate is the port's own per-request rerank."""
    for (_, tq), th in zip(pairs, handles):
        ei, ed = tr.rerank(tq)
        gi, gd = th.result()
        np.testing.assert_array_equal(gi, ei.numpy())
        np.testing.assert_allclose(gd, ed.numpy(), rtol=ORACLE.dh_rtol,
                                   atol=ORACLE.dh_atol)


# ---------------------------------------------------------------------------
# Differential parity, heterogeneous and interleaved
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("backend", BACKENDS)
def test_concurrent_heterogeneous_matches_repro(backend, window):
    jr, tr = _sessions(backend, slots=3, chunk=3, bucket=32, k=8,
                       window=window)
    pairs = [
        _pair(1, 40, k=8),
        _pair(2, 24, k=5),
        _pair(3, 48, k=7, masked=True),
        _pair(4, 16, k=3),
        _pair(5, 32, k=8, masked=True),
    ]
    handles = _drive_both(jr, tr, pairs)
    _assert_rerank_parity(tr, pairs, handles)
    st = tr.router.stats
    assert st.completed == 5 and st.slot_occupancy == 0
    assert st.fill_ratio > 0


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("backend", BACKENDS)
def test_interleaved_arrivals_seeded(backend, seed):
    """Random pump interleaving between submits changes no slate."""
    rng = np.random.default_rng(seed)
    jr, tr = _sessions(backend, slots=2, chunk=2, bucket=24, k=6)
    pairs = [
        _pair(100 + seed * 10 + i, int(rng.choice([16, 20, 24])),
              k=int(rng.integers(2, 7)), masked=bool(rng.integers(2)))
        for i in range(5)
    ]
    schedule = [int(rng.integers(0, 4)) for _ in pairs]
    _drive_both(jr, tr, pairs, schedule)


@pytest.mark.parametrize("backend", BACKENDS)
def test_interleaved_arrivals_property(backend):
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=4, deadline=None)
    @given(
        seed=st.integers(0, 2**16),
        ms=st.lists(st.sampled_from([16, 24, 32]), min_size=2, max_size=5),
        pumps=st.lists(st.integers(0, 4), min_size=5, max_size=5),
    )
    def check(seed, ms, pumps):
        rng = np.random.default_rng(seed)
        jr, tr = _sessions(backend, slots=2, chunk=2, bucket=32, k=6)
        pairs = [
            _pair(seed + i, m, k=int(rng.integers(2, 7)),
                  masked=bool(rng.integers(2)))
            for i, m in enumerate(ms)
        ]
        _drive_both(jr, tr, pairs, pumps[: len(pairs)])

    check()


@pytest.mark.parametrize("backend", BACKENDS)
def test_windowed_router_matches_repro(backend):
    jr, tr = _sessions(backend, slots=2, chunk=2, bucket=24, k=6, window=3)
    pairs = [_pair(30 + i, 24, k=6) for i in range(3)]
    _drive_both(jr, tr, pairs)


# ---------------------------------------------------------------------------
# Slot lifecycle: eps-stop reuse, deadlines, backpressure, starvation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_eps_stop_frees_slot_for_queued_request(backend):
    # rank-1 features: every gain after the first pick is float32 noise
    # around 0 (about 1e-6 here), so the stop is decided at eps = 0.05,
    # far above it (at repro's eps = 1e-3 both ports' noise sits at
    # eps^2 and either may take a second pick; ROADMAP section 3)
    jr, tr = _sessions(backend, slots=1, chunk=2, bucket=24, k=8, eps=0.05)
    stopper = _pair(0, 24, k=8, rank1=True)
    follower = _pair(1, 24, k=8)
    handles = _drive_both(jr, tr, [stopper, follower])
    gi1, _ = handles[0].result()
    # the stopper kept the whole-slate contract: length k, -1 fill
    assert len(gi1) == 8 and (gi1 == -1).sum() >= 6
    st = tr.router.stats
    assert st.eps_stopped >= 1 and st.completed == 2
    _assert_rerank_parity(tr, [stopper, follower], handles)


@pytest.mark.parametrize("backend", BACKENDS)
def test_deadline_lapsed_in_flight_returns_partial_slate(backend):
    jr, tr = _sessions(backend, slots=1, chunk=2, bucket=32, k=10)
    jq, tq = _pair(2, 32, k=10, deadline=1e-9)
    th = tr.submit(tq)
    # admitted before the deadline can lapse: the slot holds it in flight
    tr.router._queue[0].deadline_at = time.monotonic() + 3600
    tr.router.pump()  # admits + launches the first chunk
    tr.router._active[0].deadline_at = time.monotonic() - 1.0
    tr.router.drain()
    gi, gd = th.result()
    assert th.timed_out
    assert len(gi) == 2 == len(gd)  # the one chunk delivered, not k
    want = tr.rerank(tq)[0].numpy()
    np.testing.assert_array_equal(gi, want[:2])
    assert tr.router.stats.timed_out == 1
    assert tr.router.stats.completed == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_deadline_expires_in_queue(backend):
    jr, tr = _sessions(backend, slots=1, chunk=2, bucket=24, k=6)
    pairs = [_pair(3, 24, k=6), _pair(4, 24, k=6, deadline=1e-9)]
    jhs = [jr.submit(j) for j, _ in pairs]
    ths = [tr.submit(t) for _, t in pairs]
    time.sleep(0.005)
    jr.router.drain()
    tr.router.drain()
    for jh, th in zip(jhs, ths):
        _assert_slates(jh, th)
    assert not ths[0].timed_out and len(ths[0].result()[0]) == 6
    assert ths[1].timed_out and len(ths[1].result()[0]) == 0
    assert _stats(tr) == _stats(jr)
    assert tr.router.stats.admitted == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_backpressure_and_counters(backend):
    jr, tr = _sessions(backend, slots=1, chunk=2, bucket=16, k=4,
                       max_queue=2)
    pairs = [_pair(10 + i, 16, k=4) for i in range(3)]
    jhs = [jr.submit(j) for j, _ in pairs[:2]]
    ths = [tr.submit(t) for _, t in pairs[:2]]
    with pytest.raises(JQueueFull):
        jr.submit(pairs[2][0])
    with pytest.raises(ts.RouterQueueFull):
        tr.submit(pairs[2][1])
    assert tr.router.stats.rejected == 1
    assert tr.router.stats.queue_depth == 2
    assert _stats(tr) == _stats(jr)
    jr.router.drain()
    tr.router.drain()
    assert all(h.done for h in ths)
    # after draining there is room again
    jhs.append(jr.submit(pairs[2][0]))
    ths.append(tr.submit(pairs[2][1]))
    jr.router.drain()
    tr.router.drain()
    for jh, th in zip(jhs, ths):
        _assert_slates(jh, th)
    assert ths[2].done and not ths[2].timed_out
    assert _stats(tr) == _stats(jr)


@pytest.mark.parametrize("backend", BACKENDS)
def test_no_starvation_fifo_under_full_queue(backend):
    """Every request queued behind one slot completes, first come first
    served."""
    _, tr = _sessions(backend, slots=1, chunk=2, bucket=16, k=4,
                      max_queue=8)
    handles = [tr.submit(_pair(40 + i, 16, k=4, rid=i)[1])
               for i in range(8)]
    finish_order = []
    while not all(h.done for h in handles):
        tr.router.pump()
        for h in handles:
            if h.done and h.rid not in finish_order:
                finish_order.append(h.rid)
    assert finish_order == sorted(finish_order)  # FIFO through one slot
    assert tr.router.stats.completed == 8


@pytest.mark.parametrize("case", ["batched", "capacity", "bucket", "dim",
                                  "dtype"])
def test_submit_validation(case):
    _, tr = _sessions("torch", slots=1, chunk=2, bucket=16, k=4)
    good = _pair(0, 16, k=4)[1]
    s, f = np.ones((2, 16), np.float32), np.ones((16, 8), np.float32)
    bad, match = {
        "batched": (ts.RerankRequest(scores=s, feats=f), "single requests"),
        "capacity": (_pair(0, 16, k=9)[1], "slot capacity"),
        "bucket": (_pair(0, 64, k=4, shortlist=64)[1], "bucket"),
        "dim": (_pair(0, 16, k=4, D=12)[1], "feature dim"),
        "dtype": (dataclasses.replace(good, feats=good.feats.astype(
            np.float64)), "resident dtype"),
    }[case]
    if case in ("dim", "dtype"):
        tr.submit(good)  # the session's model: D = 8, float32
    with pytest.raises(ValueError, match=match):
        tr.submit(bad)
    tr.router.drain()
    assert tr.router.stats.submitted == (1 if case in ("dim", "dtype")
                                         else 0)


def test_float64_session_threads_its_dtype():
    _, tr = _sessions("torch", slots=2, chunk=2, bucket=16, k=4)
    _, tq = _pair(0, 16, k=4)
    tq = dataclasses.replace(tq, feats=tq.feats.astype(np.float64))
    ids, dh = tr.submit(tq).result()
    assert dh.dtype == np.float64 and ids.dtype == np.int32
    assert tr.router._state.C.dtype == torch.float64
    np.testing.assert_array_equal(ids, tr.rerank(tq)[0].numpy())


@pytest.mark.parametrize("backend", BACKENDS)
def test_metrics_hook_sees_gauges(backend):
    seen = []

    def hook(snap):
        seen.append((snap.slot_occupancy, snap.queue_depth,
                     snap.fill_ratio))

    jr, tr = _sessions(backend, slots=2, chunk=2, bucket=16, k=4,
                       metrics_hook=hook)
    handles = _drive_both(jr, tr, [_pair(50 + i, 16) for i in range(3)])
    assert any(occ == 2 for occ, _, _ in seen)  # both slots were busy
    assert seen[-1][0] == 0  # and the hook saw the drain
    assert all(h.ttfc is not None and h.ttfc >= 0 for h in handles)
    st = tr.router.stats
    assert st.ttfc_count == len(handles)
    assert st.mean_ttfc == pytest.approx(
        np.mean([h.ttfc for h in handles]), rel=1e-6
    )


def test_raising_metrics_hook_is_counted_not_fatal():
    def hook(snap):
        raise RuntimeError("broken hook")

    _, tr = _sessions("torch", slots=2, chunk=2, bucket=16, k=4,
                      metrics_hook=hook)
    _, tq = _pair(60, 16, k=4)
    ids, _ = tr.submit(tq).result()
    np.testing.assert_array_equal(ids, tr.rerank(tq)[0].numpy())
    r = tr.router
    pumps = r._reg.counter("router_hook_errors_total").value(
        router=r._rid_label)
    assert pumps == r.stats.chunks_launched + 1  # every pump, the last too


def test_router_metrics_and_spans_under_an_obs_session():
    with obs.session(obs.ObsConfig(enabled=True)):
        _, tr = _sessions("kernel", slots=2, chunk=2, bucket=16, k=4)
        hs = [tr.submit(_pair(70 + i, 16, k=4)[1]) for i in range(3)]
        tr.router.drain()
        reg = obs.registry()
        rid = tr.router._rid_label
        assert reg.counter("router_requests_total").value(
            router=rid, event="completed") == 3
        assert reg.counter("router_chunks_launched_total").value(
            router=rid) == tr.router.stats.chunks_launched > 0
        names = {s["name"] for s in obs.tracer().finished()}
        assert {"router.pump", "router.pump.sync", "router.pump.evict",
                "router.pump.admit", "router.pump.launch",
                "router.pump.materialize"} <= names
        # one slot-state allocation for the router's lifetime
        assert reg.counter("slot_state_allocs_total").total() == 1
    assert all(h.done for h in hs)


def test_stopped_flags_are_copied_before_the_next_launch():
    """The flags a pump decides on are the launched chunk's, not the
    state's after later launches or evictions (which update it in
    place)."""
    _, tr = _sessions("kernel", slots=2, chunk=2, bucket=24, k=8, eps=0.05)
    r = tr.router
    tr.submit(_pair(0, 24, k=8, rank1=True)[1])  # stops in its first chunk
    tr.submit(_pair(1, 24, k=8)[1])
    r.pump()
    first = r._inflight
    flags = first.stopped.clone()
    assert first.stopped.data_ptr() != r._state.stopped.data_ptr()
    r.pump()  # evicts the stopper (in place), launches chunk 2
    assert torch.equal(first.stopped, flags)
    assert r.chunk_running is False  # the CPU copies at once


# ---------------------------------------------------------------------------
# The slots refusal
# ---------------------------------------------------------------------------


def _small_card(blocks):
    return lambda windowed, device: (lambda smem: blocks)


@pytest.mark.parametrize("window", [None, 3])
def test_slots_refused_past_co_residency(window, monkeypatch):
    """32 blocks co-resident, one whole-M tile a lane at this size: 40
    slots are refused with the largest that fits, 32, named, before
    anything is queued; 32 slots are served."""
    monkeypatch.setattr(router_mod, "_card_capacity", _small_card(32))
    _, tr = _sessions("kernel", slots=40, chunk=2, bucket=32, k=8,
                      window=window)
    _, tq = _pair(0, 32, k=8)
    with pytest.raises(ValueError, match="largest slots that fits is 32"):
        tr.submit(tq)
    assert tr.router.stats.submitted == 0 and not tr.router._queue
    with pytest.raises(ValueError, match="largest slots"):
        tr.submit(tq)  # still refused: nothing was fixed by the first try
    _, ok = _sessions("kernel", slots=32, chunk=2, bucket=32, k=8,
                      window=window)
    ids, _ = ok.submit(tq).result()
    np.testing.assert_array_equal(ids, ok.rerank(tq)[0].numpy())


def test_check_slots_names_the_policy_error_when_one_lane_cannot_fit():
    with pytest.raises(ValueError, match="exceeds the 0 blocks"):
        router_mod.check_slots(4, 8, 32, 8, False, None, lambda smem: 0)
    router_mod.check_slots(4, 8, 32, 8, False, None, None)  # no limit


def test_torch_backend_has_no_co_residency_limit(monkeypatch):
    monkeypatch.setattr(router_mod, "_card_capacity", _small_card(1))
    _, tr = _sessions("torch", slots=4, chunk=2, bucket=16, k=4)
    assert tr.submit(_pair(0, 16, k=4)[1]).result()[0].shape == (4,)


def test_router_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda' requested"):
        ts.RerankRouter(ts.DPPRerankConfig())


# ---------------------------------------------------------------------------
# Rebuild telemetry, the launcher and Figure 7
# ---------------------------------------------------------------------------


def test_rebuild_monitor_counts_builds_loads_and_slot_states():
    from repro_torch.obs import dispatch as d

    with obs.session(obs.ObsConfig(enabled=True)):
        mon = RebuildMonitor(obs.registry())
        d.record_kernel_build("chunk.cu")
        d.record_module_load("chunk.cu")
        mon.mark()
        assert mon.since_mark() == 0 and mon.rebuilds() == 2
        d.record_slot_state_alloc(slots=4, M=16)
        assert mon.since_mark() == 1


def test_serve_router_cpu_reduced(tmp_path):
    # slate 8 = the reduced embeddings' width: past the features' rank the
    # gains are float32 noise near eps (ROADMAP section 3)
    try:  # --metrics-out installs a process-wide observability session
        out = serve_router.main([
            "--device", "cpu", "--requests", "9", "--slots", "3", "--slate",
            "8", "--parity-sample", "9", "--qps", "1000",
            "--metrics-out", str(tmp_path / "m.json"),
            "--trace-out", str(tmp_path / "t.json"),
        ])
    finally:
        obs.disable()
    assert out["parity_sample_ok"] and out["requests"] == 9
    assert out["completed"] == 9 and out["timed_out"] == 0
    assert out["rebuilds_after_warmup"] == 0
    doc = json.loads((tmp_path / "m.json").read_text())
    assert doc["obs"]["counters"]["router_chunks_launched_total"]
    trace = json.loads((tmp_path / "t.json").read_text())
    assert any(e.get("name") == "router.pump.launch"
               for e in trace["traceEvents"])


def test_serve_router_reduced_flag_turns_off():
    args = serve_router.parser().parse_args(["--no-reduced"])
    assert args.reduced is False and args.device == "cuda"
    assert serve_router.parser().parse_args([]).reduced is True


def test_serve_router_stats_since():
    a = ts.RouterStats(completed=5, lane_steps_active=8, lane_steps_total=16,
                       slot_occupancy=2, queue_depth=1, ttfc_sum=1.0)
    b = ts.RouterStats(completed=2, lane_steps_active=2, lane_steps_total=8,
                       slot_occupancy=4, queue_depth=3, ttfc_sum=0.25)
    d = serve_router.stats_since(a, b)
    assert (d.completed, d.slot_occupancy, d.queue_depth) == (3, 2, 1)
    assert d.fill_ratio == 0.75 and d.ttfc_sum == 0.75


def test_fig7_structure_tiny_cpu():
    """The burst and the open loop at a tiny size: every router slate
    equals its per-request rerank, the burst fills its lanes and the hot
    loop reaches every slot; no time is asserted."""
    cpu = torch.device("cpu")
    reqs = fig7_serving.make_requests(6, 40, 60, 8, 3, 6, seed=3, device=cpu)
    cfg = ts.DPPRerankConfig(slate_size=6, shortlist=32, alpha=3.0, eps=1e-6,
                             use_kernel=True)
    rcfg = ts.RouterConfig(slots=3, chunk_size=2, max_queue=8,
                           max_candidates=32)
    rr = ts.Reranker(cfg, router_config=rcfg, device=cpu)
    expect = fig7_serving.expected_slates(rr, reqs)
    serial, streamed = fig7_serving.burst_serial_ttfc(rr, reqs, 2)
    handles = [rr.submit(r) for r in reqs]
    rr.router.drain()
    assert len(serial) == 6 and all(t > 0 for t in serial)
    assert fig7_serving.check_parity(handles, expect) == []
    assert fig7_serving.check_streams(streamed, expect) == []
    # a stream cut short, or parting from its rerank, is reported
    assert [b[0] for b in fig7_serving.check_streams(
        [streamed[0][:1], streamed[1][::-1]], expect[:2])] == [0, 1]
    assert rr.router.stats.fill_ratio >= 0.5
    rr2 = ts.Reranker(cfg, router_config=rcfg, device=cpu)
    lat, ttfc, peak, bad, _ = fig7_serving.drive_open_loop(rr2, reqs, expect,
                                                           0.0)
    assert bad == [] and len(lat) == len(ttfc) == 6 and peak == 3
    assert rr2.router.stats.completed == 6


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("backend", BACKENDS)
def test_widened_slot_state_selects_as_at_its_own_width(backend, window):
    """A lane's state built at its request's width and widened to the
    bucket keeps its own columns' bits and parks the padding: a slot
    batch of it selects the request's own slate."""
    from repro_torch import core as tc

    rng = np.random.default_rng(5)
    V = torch.from_numpy(rng.standard_normal((8, 20)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=20) > 0.2)
    spec = tc.GreedySpec(k=6, window=window, backend=backend, eps=1e-6)
    own = tc.greedy_slot_state(spec, V, mask=mask)
    wide = tc.slot_state_widen(spec, own, 32)
    assert torch.equal(wide.d2[:20], own.d2)
    assert torch.isneginf(wide.d2[20:]).all()
    state, Vs = tc.greedy_slots_init(spec, 2, 8, 32, device="cpu")
    state = tc.state_splice(state, wide, 1)
    Vs[1, :, :20] = V
    state, sel, dh = tc.greedy_chunk_slots(spec, state, Vs, 6)
    whole = tc.greedy_map(tc.GreedySpec(k=6, window=window, eps=1e-6),
                          V=V, mask=mask)
    assert torch.equal(sel[1], whole.indices)
    assert (sel[0] == -1).all()
    with pytest.raises(ValueError, match="cannot widen"):
        tc.slot_state_widen(spec, own, 10)
