"""Parity of the port's streaming slice with ``repro``'s jnp streaming core.

The same seeded numpy inputs go through ``repro`` (jnp backend: its
Pallas chunk kernels do not run on this tree's jax) and through
``repro_torch`` on the CPU, on both port backends: ``torch`` (the plain
core) and ``kernel`` (the plain versions of the fused chunk kernels
K5/K6, which the wrappers run for CPU tensors).  Covered:

* ``greedy_map_chunks``: chunks concatenate to the whole slate over
  window x chunk size, eps-stops latch across chunks, ``greedy_step``
  and mixed chunk sizes, batched kernel chunks against per-lane jnp;
* the slot substrate: ``greedy_chunk_slots`` with slots spliced and
  evicted at different progress;
* session deltas: ``greedy_state_extend`` / ``greedy_state_rescore`` on
  C, d2 and t and on the next chunk, including a state revived after an
  eps-stop;
* ``Reranker.stream`` against ``repro.serving.Reranker.stream``;
* ``chunk_size`` validation and the ``greedy_chunks_total`` telemetry.

Slates index for index; ``d_hist`` within the incremental oracle's
tolerance (rtol 3e-4, atol 1e-5).  eps-stops are provoked with eps = 0.05,
far above the float32 noise the gains decay to past the features' rank.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import make_greedy_inputs
import repro.core as jc
import repro.core.streaming as jst
import repro.serving as js
from repro import obs as jobs
import repro_torch.core as tc
import repro_torch.serving as ts
from repro_torch import obs
from repro_torch.kernels.dpp_greedy import (
    TilePolicy,
    chunk_smem_bytes,
    chunk_v_resident,
    fused_chunk_exact,
    fused_chunk_windowed,
)
from repro_torch.kernels.dpp_greedy.tiling import round_up

RTOL, ATOL = 3e-4, 1e-5
BACKENDS = ["torch", "kernel"]


def _inputs(seed, D=16, M=96, masked=True, B=None):
    V = np.array(make_greedy_inputs(seed, B, D, M))
    rng = np.random.default_rng(seed + 11)
    shape = (M,) if B is None else (B, M)
    mask = rng.uniform(size=shape) > 0.2 if masked else np.ones(shape, bool)
    return V, mask


def _jspec(k, window=None, eps=1e-6):
    return jc.GreedySpec(k=k, window=window, backend="jnp", eps=eps)


def _tspec(backend, k, window=None, eps=1e-6, **kw):
    return tc.GreedySpec(k=k, window=window, backend=backend, eps=eps, **kw)


def _jchunks(V, mask, k, window, chunk, eps=1e-6):
    return list(jc.greedy_map_chunks(
        _jspec(k, window, eps), V=jnp.asarray(V),
        mask=None if mask is None else jnp.asarray(mask), chunk_size=chunk))


def _tchunks(backend, V, mask, k, window, chunk, eps=1e-6):
    return list(tc.greedy_map_chunks(
        _tspec(backend, k, window, eps), V=torch.from_numpy(V),
        mask=None if mask is None else torch.from_numpy(mask),
        chunk_size=chunk))


def _assert_close(sel, dh, want_sel, want_dh):
    np.testing.assert_array_equal(np.asarray(sel), np.asarray(want_sel))
    np.testing.assert_allclose(np.asarray(dh), np.asarray(want_dh),
                               rtol=RTOL, atol=ATOL)


def _assert_chunks(got, want):
    assert [tuple(c.indices.shape) for c in got] == \
        [tuple(c.indices.shape) for c in want]
    for g, w in zip(got, want):
        assert g.indices.dtype == torch.int32
        _assert_close(g.indices.numpy(), g.d_hist.numpy(), w.indices,
                      w.d_hist)
        assert int(g.n_selected) == int(w.n_selected)


# ---------------------------------------------------------------------------
# greedy_map_chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 4, 16])
@pytest.mark.parametrize("window", [None, 3, 1])
@pytest.mark.parametrize("backend", BACKENDS)
def test_chunks_concatenate_to_whole_slate(backend, window, chunk):
    V, mask = _inputs(0)
    k = 12 if window is None else 20
    got = _tchunks(backend, V, mask, k, window, chunk)
    _assert_chunks(got, _jchunks(V, mask, k, window, chunk))
    whole = tc.greedy_map(_tspec("torch", k, window), V=torch.from_numpy(V),
                          mask=torch.from_numpy(mask))
    _assert_close(torch.cat([c.indices for c in got]).numpy(),
                  torch.cat([c.d_hist for c in got]).numpy(),
                  whole.indices.numpy(), whole.d_hist.numpy())


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("backend", BACKENDS)
def test_eps_stop_latches_across_chunks(backend, window):
    # D = 6 < k and 9 live candidates: the rank (exact) or the pool
    # (windowed) runs out, and every chunk after the stop is -1 / 0
    V, mask = _inputs(1, D=6, M=64)
    mask[9:] = False
    k, chunk, eps = 14, 4, 0.05
    got = _tchunks(backend, V, mask, k, window, chunk, eps)
    _assert_chunks(got, _jchunks(V, mask, k, window, chunk, eps))
    sel = torch.cat([c.indices for c in got])
    stop = int((sel >= 0).sum())
    assert 0 < stop < k
    assert (sel[stop:] == -1).all()
    assert (torch.cat([c.d_hist for c in got])[stop:] == 0).all()
    assert (got[-1].indices == -1).all()


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("backend", BACKENDS)
def test_greedy_step_and_mixed_chunk_sizes(backend, window):
    V, mask = _inputs(2)
    k = 13
    plan = [1, 3, None, 5, 2, None]  # None: greedy_step
    jspec, tspec = _jspec(k, window), _tspec(backend, k, window)
    jstate = jc.greedy_init(jspec, V=jnp.asarray(V), mask=jnp.asarray(mask))
    tV = torch.from_numpy(V)
    tstate = tc.greedy_init(tspec, V=tV, mask=torch.from_numpy(mask))
    for c in plan:
        if c is None:
            jstate, js_, jd = jc.greedy_step(jspec, jstate, V=jnp.asarray(V))
            tstate, ts_, td = tc.greedy_step(tspec, tstate, V=tV)
            assert ts_.ndim == 0 and td.ndim == 0
        else:
            jstate, js_, jd = jc.greedy_chunk(jspec, jstate, V=jnp.asarray(V),
                                              chunk_size=c)
            tstate, ts_, td = tc.greedy_chunk(tspec, tstate, V=tV,
                                              chunk_size=c)
        _assert_close(ts_.numpy(), td.numpy(), js_, jd)
        assert int(tstate.t) == int(jstate.t)
    np.testing.assert_array_equal(np.asarray(tstate.stopped).reshape(-1),
                                  np.asarray(jstate.stopped).reshape(-1))


@pytest.mark.parametrize("window", [None, 3])
def test_batched_kernel_chunks_match_per_lane_jnp(window):
    V, mask = _inputs(3, B=3)
    k, chunk = 12, 5
    got = list(tc.greedy_map_chunks(
        _tspec("kernel", k, window), V=torch.from_numpy(V),
        mask=torch.from_numpy(mask), chunk_size=chunk))
    sel = torch.cat([c.indices for c in got], -1)
    dh = torch.cat([c.d_hist for c in got], -1)
    assert sel.shape == (3, k)
    for b in range(3):
        want = _jchunks(V[b], mask[b], k, window, chunk)
        _assert_close(sel[b].numpy(), dh[b].numpy(),
                      np.concatenate([np.asarray(c.indices) for c in want]),
                      np.concatenate([np.asarray(c.d_hist) for c in want]))


def test_kernel_chunked_greedy_map_is_the_whole_slate():
    V, mask = _inputs(4, B=2)
    tV, tm = torch.from_numpy(V), torch.from_numpy(mask)
    for window in (None, 3):
        spec = _tspec("kernel", 11, window, chunk_size=4)
        with obs.session(obs.ObsConfig(enabled=True)):
            got = tc.greedy_map(spec, V=tV, mask=tm)
            reg = obs.registry()
            assert reg.counter("greedy_dispatch_total").value(
                backend="kernel", chunked="True") == 1
            assert reg.counter("greedy_chunks_total").value(
                backend="kernel") == 3
        whole = tc.greedy_map(_tspec("kernel", 11, window), V=tV, mask=tm)
        assert torch.equal(got.indices, whole.indices)
        assert torch.equal(got.d_hist, whole.d_hist)


def test_exact_state_latches_at_capacity():
    # the exact state holds k rows: a counter past k selects -1 (repro
    # drops the row write there instead; no slate or stream goes past k)
    V, mask = _inputs(5)
    for backend in BACKENDS:
        spec = _tspec(backend, 6)
        st = tc.greedy_init(spec, V=torch.from_numpy(V))
        st, sel, _ = tc.greedy_chunk(spec, st, V=torch.from_numpy(V),
                                     chunk_size=8)
        assert (sel[:6] >= 0).all() and (sel[6:] == -1).all()
        assert bool(st.stopped.all())


# ---------------------------------------------------------------------------
# Slot substrate
# ---------------------------------------------------------------------------


def _slot_run(lib, spec, V, mask, chunk, schedule, cycles, to):
    """Drive a slot batch: ``schedule[c]`` lists (op, slot, lane) events
    applied before cycle c's chunk.  Returns the per-cycle (sel, dh)."""
    S, D, M = 3, V.shape[1], V.shape[2]
    # the port's entry points default to the card: ask for the CPU
    on = {"device": "cpu"} if lib is tc else {}
    state, Vs = lib.greedy_slots_init(spec, S, D, M, **on)
    out = []
    for c in range(cycles):
        for op, slot, lane in schedule.get(c, ()):
            if op == "evict":
                state = lib.state_evict(state, slot)
                continue
            single = lib.greedy_slot_state(spec, to(V[lane]),
                                           mask=to(mask[lane]))
            state = lib.state_splice(state, single, slot)
            if isinstance(Vs, torch.Tensor):
                Vs[slot] = to(V[lane])
            else:
                Vs = Vs.at[slot].set(to(V[lane]))
        state, sel, dh = lib.greedy_chunk_slots(spec, state, Vs, chunk)
        # copies: the port updates slot states in place
        out.append((np.array(sel), np.array(dh), np.array(state.t)))
    return out


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("backend", BACKENDS)
def test_chunk_slots_heterogeneous_progress(backend, window):
    V, mask = _inputs(6, B=5)
    k, chunk = 12, 4
    # each request runs k / chunk = 3 cycles, then its slot is evicted and
    # respliced: slots sit at different step counters in every launch
    schedule = {
        0: [("splice", 0, 0)],
        1: [("splice", 1, 1)],
        2: [("splice", 2, 2)],
        3: [("evict", 0, None), ("splice", 0, 3)],
        4: [("evict", 1, None)],
        5: [("evict", 2, None), ("splice", 2, 4)],
        6: [("evict", 0, None)],
    }
    want = _slot_run(jst, _jspec(k, window), V, mask, chunk, schedule, 7,
                     jnp.asarray)
    got = _slot_run(tc, _tspec(backend, k, window), V, mask, chunk, schedule,
                    7, torch.from_numpy)
    for (gs, gd, gt), (ws, wd, wt) in zip(got, want):
        _assert_close(gs, gd, ws, wd)
        np.testing.assert_array_equal(gt, wt)
    # a slot equals its request's single-request stream
    lane0 = np.concatenate([got[c][0][0] for c in range(3)])
    single = np.concatenate([np.asarray(c.indices) for c in
                             _jchunks(V[0], mask[0], k, window, chunk)])
    np.testing.assert_array_equal(lane0, single)


def test_slot_dtype_threads_through():
    spec = _tspec("torch", 6, 3)
    state, Vs = tc.greedy_slots_init(spec, 2, 4, 16, dtype=torch.float64,
                                     device="cpu")
    assert state.C.dtype == torch.float64 and Vs.dtype == torch.float64
    V = torch.from_numpy(_inputs(7, D=4, M=16)[0]).double()
    single = tc.greedy_slot_state(spec, V, dtype=torch.float64)
    state = tc.state_splice(state, single, 1)
    assert torch.equal(state.d2[1], single.d2)
    assert bool(state.stopped[0]) and not bool(state.stopped[1])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("backend", BACKENDS)
def test_state_admit_equals_the_spliced_widened_state(backend, window,
                                                      masked):
    """In-place admission (the router's) into a parked slot, fresh, or
    evicted after chunks ran, or never used while its neighbours' chunks
    advanced every step counter, leaves the slot batch bit for bit as a
    fresh state at the request's own width, widened and spliced, does;
    and a slot-batched ``greedy_chunk_launcher`` runs the cycles as
    ``greedy_chunk_slots`` does."""
    D, M, widths, k, chunk = 8, 40, (29, 40, 33), 6, 2
    spec = _tspec(backend, k, window)
    V, mask = _inputs(8, D=D, M=M, B=3, masked=masked)
    reqs = [(torch.from_numpy(V[i, :, :m]).contiguous(),
             torch.from_numpy(mask[i, :m]) if masked else None)
            for i, m in enumerate(widths)]
    a, Va = tc.greedy_slots_init(spec, 3, D, M, device="cpu")
    b, Vb = tc.greedy_slots_init(spec, 3, D, M, device="cpu")
    run = tc.greedy_chunk_launcher(spec, a, V=Va, chunk_size=chunk)

    def admit(slot, i):
        Vi, mi = reqs[i]
        tc.state_admit(spec, a, slot, Vi, mi)
        Va[slot, :, : Vi.shape[-1]] = Vi
        single = tc.slot_state_widen(spec, tc.greedy_slot_state(
            spec, Vi, mask=mi), M)
        tc.state_splice(b, single, slot)
        Vb[slot] = torch.nn.functional.pad(Vi, (0, M - Vi.shape[-1]))

    def cycle():
        nonlocal b
        sel_a, dh_a = (x.clone() for x in run())
        b, sel_b, dh_b = tc.greedy_chunk_slots(spec, b, Vb, chunk)
        assert torch.equal(sel_a, sel_b) and torch.equal(dh_a, dh_b)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        return sel_a

    admit(0, 0)
    assert (cycle()[0] >= 0).all()
    cycle()
    for st in (a, b):
        tc.state_evict(st, 0)
    Va[0] = Vb[0] = 0.0
    admit(0, 1)
    admit(2, 2)  # parked since init; its counter advanced with the rest
    for _ in range(3):
        cycle()


def test_slots_init_defaults_to_the_card(monkeypatch):
    """Without ``device=`` the slot batch goes to the card: with no card
    visible that is ``resolve_device``'s error, never a silent CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda' requested"):
        tc.greedy_slots_init(_tspec("torch", 6, 3), 2, 4, 16)


# ---------------------------------------------------------------------------
# Session deltas
# ---------------------------------------------------------------------------


def _delta_case(backend, op, V, live, eps, first, start, V_new, m_new):
    """Run ``first`` steps, apply the delta, compare the state with
    repro's and then the next chunk."""
    k, w = 30, 3
    jspec, tspec = _jspec(k, w, eps), _tspec(backend, k, w, eps)
    jV, tV = jnp.asarray(V), torch.from_numpy(V)
    js_ = jc.greedy_init(jspec, V=jV, mask=jnp.asarray(live))
    ts_ = tc.greedy_init(tspec, V=tV, mask=torch.from_numpy(live))
    js_, jsel, _ = jc.greedy_chunk(jspec, js_, V=jV, chunk_size=first)
    ts_, tsel, _ = tc.greedy_chunk(tspec, ts_, V=tV, chunk_size=first)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    jfn = getattr(jst, f"greedy_state_{op}")
    tfn = getattr(tc, f"greedy_state_{op}")
    js_, jV = jfn(jspec, js_, jV, start, jnp.asarray(V_new),
                  jnp.asarray(m_new))
    ts_, tV = tfn(tspec, ts_, tV, start, torch.from_numpy(V_new),
                  torch.from_numpy(m_new))
    squeeze = (lambda x: x[0]) if backend == "kernel" else (lambda x: x)
    np.testing.assert_array_equal(tV.numpy(), np.asarray(jV))
    np.testing.assert_allclose(squeeze(ts_.C).numpy(), np.asarray(js_.C),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(squeeze(ts_.d2).numpy(), np.asarray(js_.d2),
                               rtol=RTOL, atol=ATOL)
    assert int(ts_.t) == int(js_.t)
    assert not bool(ts_.stopped.any())
    js_, jsel, jdh = jc.greedy_chunk(jspec, js_, V=jV, chunk_size=6)
    ts_, tsel, tdh = tc.greedy_chunk(tspec, ts_, V=tV, chunk_size=6)
    _assert_close(tsel.numpy(), tdh.numpy(), jsel, jdh)
    return tsel


@pytest.mark.parametrize("op", ["extend", "rescore"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_state_delta_matches_repro(backend, op):
    V, _ = _inputs(8, M=64, masked=False)
    live = np.zeros(64, bool)
    live[:48] = True  # columns 48.. are the session's spare capacity
    rng = np.random.default_rng(9)
    if op == "extend":
        start, V_new = 48, np.array(make_greedy_inputs(10, None, 16, 8))
    else:  # rescore a block that holds shown (dead) columns
        start, V_new = 0, 1.5 * V[:, :20]
    m_new = rng.uniform(size=V_new.shape[1]) > 0.2
    _delta_case(backend, op, V, live, 1e-6, 7, start, V_new, m_new)


@pytest.mark.parametrize("backend", BACKENDS)
def test_extend_revives_after_eps_stop(backend):
    # five live columns: the chunk stops after picking them, t runs past
    # the ring; extend revives the state with t re-derived from the ring
    V, _ = _inputs(11, M=64, masked=False)
    live = np.zeros(64, bool)
    live[:5] = True
    V_new = np.array(make_greedy_inputs(12, None, 16, 10))
    sel = _delta_case(backend, "extend", V, live, 1e-3, 9, 5, V_new,
                      np.ones(10, bool))
    assert (sel.numpy() >= 5).all()  # picks among the new columns


def test_state_delta_keeps_dtype():
    V = torch.from_numpy(_inputs(13, M=32, masked=False)[0]).double()
    spec = _tspec("torch", 10, 3)
    st = tc.greedy_init(spec, V=V)
    st, _, _ = tc.greedy_chunk(spec, st, V=V, chunk_size=4)
    st, V2 = tc.greedy_state_extend(spec, st, V, 20, V[:, :4] * 0.5)
    assert st.C.dtype == torch.float64 and st.d2.dtype == torch.float64
    assert V2.dtype == torch.float64


def test_state_delta_rejects_exact_state():
    V = torch.from_numpy(_inputs(14, M=32)[0])
    spec = _tspec("torch", 4)
    st = tc.greedy_init(spec, V=V)
    with pytest.raises(ValueError, match="windowed state"):
        tc.greedy_state_extend(spec, st, V, 0, V[:, :2])


# ---------------------------------------------------------------------------
# Reranker.stream
# ---------------------------------------------------------------------------


def _req_data(seed, M=300, D=24, masked=True, rank=None):
    rng = np.random.default_rng(seed)
    scores = rng.uniform(size=M).astype(np.float32)
    feats = rng.normal(size=(M, D)).astype(np.float32)
    if rank is not None:
        feats[:, rank:] = 0.0
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    mask = rng.uniform(size=M) > 0.2 if masked else None
    return scores, feats, mask


def _streams(cfg_kw, scores, feats, mask, chunk):
    jcfg = {k: v for k, v in cfg_kw.items() if k != "use_kernel"}
    j = list(js.Reranker(js.DPPRerankConfig(**jcfg)).stream(
        js.RerankRequest(scores=jnp.asarray(scores), feats=jnp.asarray(feats),
                         mask=None if mask is None else jnp.asarray(mask)),
        chunk_size=chunk))
    t = list(ts.Reranker(ts.DPPRerankConfig(**cfg_kw), device="cpu").stream(
        ts.RerankRequest(scores=scores, feats=feats, mask=mask),
        chunk_size=chunk))
    return j, t


@pytest.mark.parametrize("chunk", [3, 8])
@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_reranker_stream_matches_repro(use_kernel, window, chunk):
    scores, feats, mask = _req_data(20)
    kw = dict(slate_size=17, shortlist=120, alpha=3.0, window=window,
              use_kernel=use_kernel)
    j, t = _streams(kw, scores, feats, mask, chunk)
    assert len(t) == len(j) == -(-17 // chunk)
    for (tsel, tdh), (jsel, jdh) in zip(t, j):
        assert tsel.dtype == torch.int32
        _assert_close(tsel.numpy(), tdh.numpy(), jsel, jdh)
    whole = ts.Reranker(ts.DPPRerankConfig(**kw), device="cpu").rerank(
        ts.RerankRequest(scores=scores, feats=feats, mask=mask))
    assert torch.equal(torch.cat([c[0] for c in t]), whole[0])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_stream_stops_dispatching_after_eps_stop(use_kernel, monkeypatch):
    import repro_torch.serving.api as api

    scores, feats, _ = _req_data(21, M=200, D=12, masked=False, rank=5)
    kw = dict(slate_size=20, shortlist=80, alpha=3.0, eps=0.05,
              use_kernel=use_kernel)
    calls = []
    real = api.greedy_chunk
    monkeypatch.setattr(api, "greedy_chunk",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    j, t = _streams(kw, scores, feats, None, 4)
    assert len(calls) == len(t) == len(j) < 5
    assert int(t[-1][0][-1]) == -1
    for (tsel, tdh), (jsel, jdh) in zip(t, j):
        _assert_close(tsel.numpy(), tdh.numpy(), jsel, jdh)


def test_stream_prepares_eagerly(monkeypatch):
    import repro_torch.serving.api as api

    calls = []
    real = api.greedy_init
    monkeypatch.setattr(api, "greedy_init",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    scores, feats, mask = _req_data(22)
    rr = ts.Reranker(ts.DPPRerankConfig(slate_size=6, shortlist=50,
                                        use_kernel=True), device="cpu")
    gen = rr.stream(ts.RerankRequest(scores=scores, feats=feats, mask=mask),
                    chunk_size=2)
    assert calls == [1]  # the shortlist and the state exist before next()
    assert len(list(gen)) == 3 and calls == [1]


def test_stream_rejects_batched_requests_eagerly():
    rr = ts.Reranker(ts.DPPRerankConfig(slate_size=4), device="cpu")
    with pytest.raises(ValueError, match="single request"):
        rr.stream(ts.RerankRequest(scores=np.zeros((2, 8), np.float32),
                                   feats=np.ones((8, 3), np.float32)),
                  chunk_size=2)
    with pytest.raises(ValueError, match="no chunk size"):
        rr.stream(ts.RerankRequest(scores=np.zeros(8, np.float32),
                                   feats=np.ones((8, 3), np.float32)))


def test_stream_config_chunk_size_is_the_default():
    scores, feats, mask = _req_data(23)
    cfg = ts.DPPRerankConfig(slate_size=9, shortlist=60, chunk_size=4,
                             use_kernel=True)
    chunks = list(ts.Reranker(cfg, device="cpu").stream(
        ts.RerankRequest(scores=scores, feats=feats, mask=mask)))
    assert [len(c[0]) for c in chunks] == [4, 4, 1]


# ---------------------------------------------------------------------------
# Validation and telemetry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,jax_backend", [
    ("torch", "jnp"), ("auto", "auto"), ("kernel", "pallas"),
])
@pytest.mark.parametrize("chunk_size", [0, 4])
def test_greedy_spec_rejects_chunk_size_where_repro_does(backend, jax_backend,
                                                         chunk_size):
    def raises(make):
        try:
            make()
        except ValueError:
            return True
        return False

    want = raises(lambda: jc.GreedySpec(k=8, backend=jax_backend,
                                        chunk_size=chunk_size))
    got = raises(lambda: tc.GreedySpec(k=8, backend=backend,
                                       chunk_size=chunk_size))
    assert got == want
    if got:
        with pytest.raises(tc.GreedySpecError):
            tc.GreedySpec(k=8, backend=backend, chunk_size=chunk_size)


@pytest.mark.parametrize("kw", [dict(chunk_size=0), dict(chunk_size=4),
                                dict(chunk_size=4, use_kernel=True)])
def test_config_chunk_size_validation_matches_repro(kw):
    def raises(cls):
        try:
            cls(**kw)
        except ValueError:
            return True
        return False

    assert raises(ts.DPPRerankConfig) == raises(js.DPPRerankConfig)


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("backend", BACKENDS)
def test_chunk_counters_match_repro_obs(backend, window):
    V, mask = _inputs(15)
    k, chunk = 11, 4
    with jobs.session(jobs.ObsConfig(enabled=True)):
        _jchunks(V, mask, k, window, chunk)
        jreg = jobs.registry()
        want = [jreg.counter(n).value(backend="jnp") for n in (
            "greedy_chunks_total", "greedy_steps_total",
            "marginal_evals_total")]
    with obs.session(obs.ObsConfig(enabled=True)):
        _tchunks(backend, V, mask, k, window, chunk)
        treg = obs.registry()
        got = [treg.counter(n).value(backend=backend) for n in (
            "greedy_chunks_total", "greedy_steps_total",
            "marginal_evals_total")]
    assert got == want == [3, k, k * V.shape[1]]


# ---------------------------------------------------------------------------
# The chunked tile model and the K5/K6 wrappers
# ---------------------------------------------------------------------------


def _card_like(smem):
    """A stand-in for ``chunk_capacity``: 132 SMs, each holding at most
    eight 256-thread blocks and 228 KB of shared memory (1 KB reserved
    per block)."""
    return 132 * min(8, 233472 // (smem + 1024))


@pytest.mark.parametrize("D,M,R,windowed,lanes,mode", [
    (100, 1000, 50, False, 64, "tiled"),     # V-resident: 2 tiles per lane
    (100, 1000, 10, True, 64, "tiled"),      # V-resident: 2 tiles per lane
    (100, 65536, 50, False, 4, "tiled"),     # the large pool
    (100, 65536, 10, True, 4, "tiled"),
])
def test_chunked_tile_model(D, M, R, windowed, lanes, mode):
    for capacity in (None, _card_like):
        got, tm, vres = TilePolicy().decide(D, M, R, windowed, chunked=True,
                                            lanes=lanes, capacity=capacity)
        assert got == mode
        cols = M if mode == "resident" else tm
        assert vres == chunk_v_resident(D, M, cols, R, windowed, lanes,
                                        capacity)
        smem = chunk_smem_bytes(D, cols, R, windowed, vres)
        assert smem <= 232448 and (mode == "resident" or tm % 32 == 0)
        if capacity is not None:
            assert lanes * -(-M // cols) <= capacity(smem)
        assert TilePolicy(tile_m=256).decide(
            D, M, R, windowed, chunked=True, lanes=lanes,
            capacity=capacity)[:2] == ("tiled", 256)
    # without a card nothing bounds the lanes; on one, its capacity does
    assert TilePolicy().decide(D, M, R, windowed, chunked=True,
                               lanes=200)[0] == mode
    with pytest.raises(ValueError, match="co-resident"):
        TilePolicy().decide(D, M, R, windowed, chunked=True, lanes=200,
                            capacity=lambda smem: 132)


@pytest.mark.parametrize("M,lanes,tile,vres", [
    # phase 7's shape: V, ring, gains and staging of 512 columns fill
    # 228,624 of a block's 232,448 B; 128 blocks, one per SM
    (1000, 64, 512, True),
    # the large pool: 128 V-resident tiles per lane cannot co-reside, so
    # V streams through tiles of 1024 with the ring in shared memory
    (65536, 4, 1024, False),
    # 200 lanes of the short list: 400 V-resident blocks do not fit a
    # card of 132 SMs, one whole-M streaming tile per lane does
    (1000, 100, 1000, False),
])
def test_windowed_chunk_tile_model_keeps_v_resident_where_it_fits(
        M, lanes, tile, vres):
    D, R = 100, 10
    mode, tm, got = TilePolicy().decide(D, M, R, True, chunked=True,
                                        lanes=lanes, capacity=_card_like)
    assert (tm or M) == tile
    assert mode == ("resident" if tile == M else "tiled")
    assert got == vres
    assert chunk_v_resident(D, M, tile, R, True, lanes, _card_like) == vres
    smem = chunk_smem_bytes(D, tile, R, True, vres)
    assert smem <= 232448
    assert lanes * -(-M // tile) <= _card_like(smem)
    # the layout chunk.cu carves: gains + ring (+ V) per column, then the
    # staging (V column, w x w window factor, 6 w-vectors) and reduction
    per_col = 1 + R + (D if vres else 0)
    assert smem == 4 * (tile * per_col + D + R * R + 6 * R + 64)
    if vres:
        # the fewest tiles: one fewer V-resident tile does not fit a block
        fewer = -(-M // tile) - 1
        wider = round_up(-(-M // fewer), 32)
        assert chunk_smem_bytes(D, wider, R, True, True) > 232448


def test_chunked_tile_model_widens_to_fit_the_card():
    # 4 lanes of the large pool at the 1024-column floor need 256 blocks;
    # a card that holds 100 gets tiles wide enough for 25 per lane
    D, M, R = 100, 65536, 50
    mode, tm, vres = TilePolicy().decide(D, M, R, False, chunked=True,
                                         lanes=4, capacity=lambda smem: 100)
    assert mode == "tiled" and tm == 2624 and 4 * -(-M // tm) <= 100
    assert not vres
    with pytest.raises(ValueError, match="wider tile_m"):
        TilePolicy(tile_m=1024).decide(D, M, R, False, chunked=True,
                                       lanes=4, capacity=lambda smem: 100)
    with pytest.raises(ValueError, match="shared memory"):
        TilePolicy(tile_m=65536).decide(D, M, R, False, chunked=True)


@pytest.mark.parametrize("window", [None, 3])
def test_kernel_chunks_past_one_block_per_sm(window):
    # more lanes than the H100 has SMs: the CPU path bounds nothing, and
    # every lane still equals its whole slate (and, for two, repro's)
    V, mask = _inputs(8, D=8, M=64, B=140)
    k, chunk = 7, 3
    got = list(tc.greedy_map_chunks(
        _tspec("kernel", k, window), V=torch.from_numpy(V),
        mask=torch.from_numpy(mask), chunk_size=chunk))
    sel = torch.cat([c.indices for c in got], -1)
    dh = torch.cat([c.d_hist for c in got], -1)
    whole = tc.greedy_map(_tspec("kernel", k, window), V=torch.from_numpy(V),
                          mask=torch.from_numpy(mask))
    assert torch.equal(sel, whole.indices)
    torch.testing.assert_close(dh, whole.d_hist, rtol=RTOL, atol=ATOL)
    for b in (0, 139):
        want = _jchunks(V[b], mask[b], k, window, chunk)
        _assert_close(sel[b].numpy(), dh[b].numpy(),
                      np.concatenate([np.asarray(c.indices) for c in want]),
                      np.concatenate([np.asarray(c.d_hist) for c in want]))


def test_chunk_wrappers_reject_other_devices():
    m = dict(device="meta")
    V, C = torch.empty((1, 4, 8), **m), torch.empty((1, 2, 8), **m)
    d2, t = torch.empty((1, 8), **m), torch.empty((1,), dtype=torch.int32,
                                                  **m)
    st = torch.empty((1,), dtype=torch.bool, **m)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_chunk_exact(V, C, d2, t, st, 2, 1e-3, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_chunk_windowed(V, C, d2, t, st, torch.empty((1, 2), **m), 2,
                             1e-3, 8)
