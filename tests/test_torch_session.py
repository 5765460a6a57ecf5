"""The port's session-aware incremental rerank against ``repro``'s, on
the CPU.

The same seeded numpy requests go through ``repro.serving``'s sessions on
its jnp core and through ``repro_torch.serving``'s on both port backends:
``torch`` (the plain core) and ``kernel`` (the plain version of K6,
``fused_chunk_windowed_plain``, which the wrapper runs for CPU tensors).
``repro``'s ``[pallas]`` cases are not the reference: its fused chunk
kernels raise on this tree's jax (ROADMAP, "What the reference is on
this tree").  Every verb is applied to both sessions in lockstep, and
every chunk must:

* equal ``repro``'s chunk id for id, gains within ``tests/conftest.py``'s
  incremental ``GreedyOracle`` tolerance;
* equal ``tests/test_session.py::ref_next_picks`` (a float64
  from-scratch conditional greedy over the port's host mirrors: per
  pick, a fresh Cholesky of the window's Gram and a full candidate
  solve) id for id, gains within rtol 3e-4 / atol 1e-5.

``extend`` must return ``repro``'s global ids, and an evicted session
must keep matching a control that was never evicted (and ``repro``'s).
Every case of ``tests/test_session.py`` that concerns sessions is ported
as a test over the two backends; its seam regressions are ported
elsewhere (slot dtypes: ``test_torch_streaming.py::
test_slot_dtype_threads_through``; float64 and mixed-precision router:
``test_torch_router.py``; shared-M validation:
``test_torch_serving.py::test_request_validation``; the stream's
post-stop dispatches: ``test_torch_streaming.py::
test_stream_stops_dispatching_after_eps_stop``; exact states refuse a
delta: ``test_torch_streaming.py::test_state_delta_rejects_exact_state``).
Also: ``windowed_state_rebuild`` and ``dpp_greedy_windowed_rebuild``
against ``repro``'s, each backend's state layout after a build and a
rebuild, the LRU order and budget, the session metrics by name and
label, and Figure 10 and ``examples/serve_recsys.py`` at their CPU
sizes (their parity only: no test here asserts a wall-clock ordering).
"""
import contextlib
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import _ORACLES
from test_session import ref_next_picks
import repro.serving as js
from repro import obs as jobs
from repro.core.windowed import (
    dpp_greedy_windowed_rebuild as j_windowed_rebuild,
    windowed_state_rebuild as j_state_rebuild,
)
import repro_torch.serving as ts
from repro_torch import obs
from repro_torch.core import (
    GreedySpec,
    dpp_greedy_windowed_rebuild,
    greedy_chunk,
    greedy_chunk_launcher,
    greedy_init,
    window_solve,
    windowed_state_rebuild,
)
from repro_torch.examples import serve_recsys
from repro_torch.figures import fig10_session

ORACLE = _ORACLES["incremental"]()
RTOL, ATOL = 3e-4, 1e-5  # repro's own tolerance against ref_next_picks
BACKENDS = ["torch", "kernel"]
ROOT = Path(__file__).resolve().parents[1]


def _cfg_kw(k=8, window=3, shortlist=32, chunk=3, eps=1e-3):
    return dict(slate_size=k, shortlist=shortlist, alpha=3.0, window=window,
                chunk_size=chunk, eps=eps)


def _rerankers(backend, scfg=None, **kw):
    """``repro``'s Reranker (jnp) and the port's on ``backend``, with the
    same config and session config."""
    base = _cfg_kw(**kw)
    jr = js.Reranker(js.DPPRerankConfig(**base), session_config=(
        None if scfg is None else js.SessionConfig(**scfg)))
    tr = ts.Reranker(ts.DPPRerankConfig(use_kernel=backend == "kernel",
                                        **base),
                     session_config=(None if scfg is None
                                     else ts.SessionConfig(**scfg)),
                     device="cpu")
    return jr, tr


def _data(seed, M, D=8, masked=False):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(M, D)).astype(np.float32)
    f /= np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-12)
    s = rng.uniform(0.1, 1.0, size=M).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones(M, bool)
        mask[rng.choice(M, size=M // 4, replace=False)] = False
    return s, f, mask


def _pair(s, f, mask=None):
    j = js.RerankRequest(scores=jnp.asarray(s), feats=jnp.asarray(f),
                         mask=None if mask is None else jnp.asarray(mask))
    return j, ts.RerankRequest(scores=s, feats=f, mask=mask)


def _request(seed, M, D=8, masked=False):
    return _pair(*_data(seed, M, D, masked))


def _delta(seed, dm, D=8):
    """Extend payload: normalized feats (dm, D) + uniform scores."""
    s, f, _ = _data(seed, dm, D)
    return s, f


class Lockstep:
    """One feed through ``repro``'s session and the port's, verb by verb."""

    def __init__(self, jsess, tsess):
        self.j, self.t = jsess, tsess

    def chunk(self, n):
        t = self.t
        cols, ref_g = ref_next_picks(t._Vh.copy(), list(t._shown),
                                     t._dead.copy(), n, t.w, t.cfg.eps)
        ji, jg = (np.asarray(x) for x in self.j.next_chunk(n))
        ti, tg = t.next_chunk(n)
        assert ti.dtype == np.int64 and tg.dtype == np.float32
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tg, jg, rtol=ORACLE.dh_rtol,
                                   atol=ORACLE.dh_atol)
        np.testing.assert_array_equal(ti, t._gid[cols])
        np.testing.assert_allclose(tg, ref_g, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(t.shown, np.asarray(self.j.shown))
        return ti

    def extend(self, s, f, mask=None):
        jg = self.j.extend(jnp.asarray(s), jnp.asarray(f), mask=(
            None if mask is None else jnp.asarray(mask)))
        tg = self.t.extend(s, f, mask=mask)
        np.testing.assert_array_equal(tg, np.asarray(jg))
        return tg

    def rescore(self, ids, scores):
        self.j.rescore(ids, scores)
        self.t.rescore(ids, scores)


def _lockstep(backend, seed, M, masked=False, scfg=None, **kw):
    jr, tr = _rerankers(backend, scfg, **kw)
    jq, tq = _request(seed, M, masked=masked)
    return Lockstep(jr.session(jq), tr.session(tq))


@pytest.fixture
def fresh_obs():
    obs.disable()
    s = obs.enable(obs.ObsConfig(enabled=True))
    yield s
    obs.disable()


# ---------------------------------------------------------------------------
# Resume: session chunks == Reranker.stream, never replaying
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("window", [3, 5])
def test_session_chunks_match_stream(backend, window):
    jr, tr = _rerankers(backend, k=8, window=window)
    jq, tq = _request(7, 40)
    ref = [c.numpy() for c, _ in tr.stream(tq)]
    both = Lockstep(jr.session(jq), tr.session(tq))
    got = np.concatenate([both.chunk(n) for n in (3, 3, 2)])
    np.testing.assert_array_equal(got, np.concatenate(ref))


@pytest.mark.parametrize("backend", BACKENDS)
def test_session_resume_matches_reference(backend):
    both = _lockstep(backend, 11, 36, masked=True)
    for n in (2, 3, 3):
        both.chunk(n)


# ---------------------------------------------------------------------------
# Delta-updates: extend / rescore condition the next chunk correctly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_extend_conditions_next_chunk(backend):
    both = _lockstep(backend, 3, 24)
    both.chunk(3)
    gids = both.extend(*_delta(101, 6))
    # fresh global ids, dense above the request's candidate count
    np.testing.assert_array_equal(gids, np.arange(24, 30))
    both.chunk(3)
    both.chunk(2)


@pytest.mark.parametrize("backend", BACKENDS)
def test_extend_with_mask(backend):
    both = _lockstep(backend, 5, 24)
    both.chunk(3)
    s, f = _delta(55, 5)
    mask = np.array([True, False, True, True, False])
    gids = both.extend(s, f, mask=mask)
    ids = both.chunk(4)
    assert not ({int(gids[1]), int(gids[4])} & set(int(i) for i in ids))


@pytest.mark.parametrize("backend", BACKENDS)
def test_rescore_conditions_next_chunk(backend):
    both = _lockstep(backend, 9, 28)
    shown_before = list(both.chunk(3))
    # refresh a mix of shown and unshown ids: shown columns must keep
    # their exact old state (history is never rewritten), unshown ones
    # re-enter the running with their new relevance
    ids = np.asarray([shown_before[0], *both.t._gid[10:14]], np.int64)
    rng = np.random.default_rng(77)
    both.rescore(ids, rng.uniform(0.5, 1.0, size=ids.size).astype(
        np.float32))
    assert list(both.t.shown) == shown_before
    both.chunk(3)
    both.chunk(2)


@pytest.mark.parametrize("backend", BACKENDS)
def test_rescore_repeated_id_takes_its_last_score(backend):
    both = _lockstep(backend, 19, 28)
    both.chunk(3)
    g = both.t._gid[12]
    both.rescore(np.asarray([g, both.t._gid[5], g], np.int64),
                 np.asarray([0.1, 0.9, 1.0], np.float32))
    both.chunk(3)


def _rank2_request(seed=13):
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.normal(size=(8, 2)))[0]
    coef = rng.normal(size=(16, 2)).astype(np.float32)
    f = (coef @ basis.T).astype(np.float32)
    f /= np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-12)
    s = rng.uniform(0.1, 1.0, size=16).astype(np.float32)
    return _pair(s, f)


@pytest.mark.parametrize("backend", BACKENDS)
def test_extend_revives_eps_stopped_session(backend, fresh_obs):
    # rank-2 pool: every candidate lives in a 2D feature subspace, so
    # the third conditioned gain collapses below eps and the session
    # latches stopped mid-chunk...
    jr, tr = _rerankers(backend)
    jq, tq = _rank2_request()
    both = Lockstep(jr.session(jq), tr.session(tq))
    ids = both.chunk(3)
    assert len(ids) == 2

    def chunks():
        return fresh_obs.registry.counter("greedy_chunks_total").total()

    # ...stopped sessions answer from the host, empty, no device work
    assert chunks() == 1
    assert both.chunk(3).size == 0 and chunks() == 1
    # an extend with full-rank candidates revives it, conditioned on
    # the two shown items
    both.extend(*_delta(99, 4))
    assert both.chunk(3).size == 3 and chunks() == 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_hypothesis_interleavings(backend):
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    op = st.one_of(
        st.tuples(st.just("chunk"), st.integers(1, 3)),
        st.tuples(st.just("extend"), st.integers(1, 4)),
        st.tuples(st.just("rescore"), st.integers(1, 5)),
    )

    # derandomized with a fixed example count: the same examples in every
    # run, in every worker of an xdist run
    @hyp.settings(max_examples=12, deadline=None, derandomize=True,
                  database=None)
    @hyp.given(ops=st.lists(op, min_size=3, max_size=8),
               seed=st.integers(0, 2**20))
    def run(ops, seed):
        both = _lockstep(backend, seed % 997, 24, scfg=dict(capacity=80))
        rng = np.random.default_rng(seed)
        for i, (kind, arg) in enumerate(ops):
            if kind == "chunk":
                both.chunk(arg)
            elif kind == "extend":
                both.extend(*_delta(seed + i, arg))
            else:
                live = both.t._gid[both.t._gid >= 0]
                ids = rng.choice(live, size=min(arg, live.size),
                                 replace=False)
                both.rescore(ids, rng.uniform(
                    0.1, 1.0, size=ids.size).astype(np.float32))
        both.chunk(2)

    run()


# ---------------------------------------------------------------------------
# LRU store: eviction is transparent, budget is respected
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_eviction_rebuild_matches_never_evicted_control(backend):
    (jqA, tqA), (_, tqB) = _request(21, 32), _request(22, 32)
    # budget of 1 byte: whichever session is being served evicts every
    # other resident one
    jr, rr = _rerankers(backend, dict(budget_bytes=1))
    _, ctl_rr = _rerankers(backend)
    ctl = ctl_rr.session(tqA)
    ja = jr.session(jqA, sid="a")

    sa = rr.session(tqA, sid="a")
    ia1, _ = sa.next_chunk(3)
    sb = rr.session(tqB, sid="b")  # creating b evicts a
    assert not sa.resident and sb.resident
    sb.next_chunk(3)

    # the evicted session rebuilds transparently and keeps matching a
    # control that was never evicted (and repro's) — across a later
    # extend too
    ic1, _ = ctl.next_chunk(3)
    np.testing.assert_array_equal(ia1, ic1)
    np.testing.assert_array_equal(ia1, np.asarray(ja.next_chunk(3)[0]))
    ia2, da2 = sa.next_chunk(3)
    ic2, dc2 = ctl.next_chunk(3)
    np.testing.assert_array_equal(ia2, ic2)
    np.testing.assert_allclose(da2, dc2, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ia2, np.asarray(ja.next_chunk(3)[0]))
    assert not sb.resident  # serving a evicted b right back

    s, f = _delta(42, 5)
    sa.extend(s, f)
    ctl.extend(s, f)
    ja.extend(jnp.asarray(s), jnp.asarray(f))
    ia3, da3 = sa.next_chunk(2)
    ic3, dc3 = ctl.next_chunk(2)
    np.testing.assert_array_equal(ia3, ic3)
    np.testing.assert_allclose(da3, dc3, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ia3, np.asarray(ja.next_chunk(2)[0]))
    assert rr.sessions.resident_bytes() == sa._resident_bytes


@pytest.mark.parametrize("backend", BACKENDS)
def test_rebuild_after_eps_stop_and_extend(backend):
    """A session evicted while stopped rebuilds stopped, answers empty,
    and an extend revives it on the rebuilt state as on the control."""
    jq, tq = _rank2_request()
    _, rr = _rerankers(backend, dict(budget_bytes=1))
    _, ctl_rr = _rerankers(backend)
    sess, ctl = rr.session(tq, sid="a"), ctl_rr.session(tq)
    assert len(sess.next_chunk(3)[0]) == len(ctl.next_chunk(3)[0]) == 2
    rr.session(_request(22, 32)[1], sid="b").next_chunk(1)
    assert not sess.resident
    assert sess.next_chunk(3)[0].size == 0 and not sess.resident
    s, f = _delta(99, 4)
    sess.extend(s, f)
    ctl.extend(s, f)
    assert sess.resident and not bool(sess._state.stopped.any())
    ia, da = sess.next_chunk(3)
    ic, dc = ctl.next_chunk(3)
    np.testing.assert_array_equal(ia, ic)
    np.testing.assert_allclose(da, dc, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_lru_order_and_budget(backend):
    """Least recently used sessions go first; the session being served
    stays even when it alone is over the budget; the store stays within
    the budget plus that one session."""
    _, probe = _rerankers(backend)
    one = probe.session(_request(0, 32)[1])._resident_bytes
    _, rr = _rerankers(backend, dict(budget_bytes=2 * one))
    s = [rr.session(_request(60 + i, 32)[1], sid=i) for i in range(4)]
    assert [x.resident for x in s] == [False, False, True, True]
    s[2].next_chunk(1)  # 2 is now most recently used, 3 least
    s[0].next_chunk(1)  # rebuilds 0: evicts 3, keeps 2
    assert [x.resident for x in s] == [True, False, True, False]
    assert rr.sessions.resident_bytes() <= 2 * one
    _, tiny = _rerankers(backend, dict(budget_bytes=1))
    sess = tiny.session(_request(1, 32)[1])
    assert sess.resident and tiny.sessions.resident_bytes() == one


@pytest.mark.parametrize("backend", BACKENDS)
def test_state_layouts_after_build_and_rebuild(backend):
    """Each backend's own layout, fresh and rebuilt: torch ``C (w, cap)``,
    ``win (w,)`` int64, 0-d ``stopped``; kernel ``C (1, w, cap)``
    float32, ``win (1, w)`` int32, ``stopped (1,)``; 0-d int32 ``t``;
    ``V`` contiguous float32 ``(D, cap)``.  The resident bytes are the
    tensors' bytes."""
    _, rr = _rerankers(backend, dict(budget_bytes=1, capacity=40), window=3)
    sess = rr.session(_request(5, 32, masked=True)[1], sid="a")
    lead = (1,) if backend == "kernel" else ()
    for rebuilt in (False, True):
        st = sess._state
        assert st.t.shape == () and st.t.dtype == torch.int32
        assert st.C.shape == lead + (3, 40) and st.C.dtype == torch.float32
        assert st.d2.shape == lead + (40,)
        assert st.win.shape == lead + (3,)
        assert st.win.dtype == (torch.int32 if backend == "kernel"
                                else torch.int64)
        assert st.stopped.shape == lead and st.stopped.dtype == torch.bool
        assert sess._V.shape == (8, 40) and sess._V.is_contiguous()
        if backend == "kernel":  # K6 takes contiguous operands only
            assert all(x.is_contiguous() for x in st)
        assert sess._resident_bytes == sum(
            x.numel() * x.element_size() for x in (*st, sess._V))
        # the headroom and the masked columns are parked
        assert torch.isneginf(st.d2.reshape(-1)[torch.from_numpy(
            sess._dead)]).all()
        if not rebuilt:
            sess.next_chunk(5)  # t = 5 >= w: a full ring
            rr.session(_request(6, 32)[1], sid="b")  # evicts a
            assert not sess.resident
            sess._ensure_resident()
            assert int(sess._state.t) == 5
            np.testing.assert_array_equal(
                sess._state.win.reshape(-1).numpy(), sess._shown[-3:])


# ---------------------------------------------------------------------------
# The rebuild functions against repro's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("filled", [0, 2, 4])
def test_windowed_state_rebuild_matches_repro(filled):
    rng = np.random.default_rng(filled)
    D, M, w = 8, 30, 4
    V = rng.normal(size=(D, M)).astype(np.float32)
    hist = rng.choice(M, size=filled, replace=False)
    shown = np.full((w,), -1, np.int32)
    shown[:filled] = hist
    dead = rng.uniform(size=M) < 0.1
    dead[hist] = True
    jC, jd = (np.asarray(x) for x in j_state_rebuild(
        jnp.asarray(V), jnp.asarray(shown), jnp.asarray(dead)))
    for ring_dtype in (torch.int32, torch.int64):
        C, d2 = windowed_state_rebuild(
            torch.from_numpy(V), torch.from_numpy(shown).to(ring_dtype),
            torch.from_numpy(dead))
        np.testing.assert_allclose(C.numpy(), jC, rtol=1e-5, atol=1e-5)
        assert np.array_equal(np.isneginf(d2.numpy()), np.isneginf(jd))
        np.testing.assert_allclose(d2.numpy()[~dead], jd[~dead], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("filled", [0, 2, 4])
def test_window_solve_matches_float64(filled):
    """The block solve against a float64 solve of the same window, an
    empty ring slot being an identity row of the factor and a zero
    column of the window; ``c=`` receives the rows in place."""
    rng = np.random.default_rng(10 + filled)
    D, n, w = 8, 6, 4
    Vw = rng.normal(size=(D, filled))
    X = rng.normal(size=(D, n)).astype(np.float32)
    F64 = np.linalg.cholesky(Vw.T @ Vw) if filled else np.zeros((0, 0))
    c64 = np.linalg.solve(F64, Vw.T @ X) if filled else np.zeros((0, n))
    d64 = (X.astype(np.float64) ** 2).sum(0) - (c64 ** 2).sum(0)
    F = np.eye(w)
    F[:filled, :filled] = F64
    Vwin = np.zeros((D, w))
    Vwin[:, :filled] = Vw
    out = torch.full((w, n), np.nan)
    c, d2 = window_solve(torch.tensor(F, dtype=torch.float32),
                         torch.tensor(Vwin, dtype=torch.float32),
                         torch.from_numpy(X), c=out)
    assert c.data_ptr() == out.data_ptr()
    np.testing.assert_allclose(c.numpy()[:filled], c64, rtol=1e-4,
                               atol=1e-5)
    assert not c.numpy()[filled:].any()
    np.testing.assert_allclose(d2.numpy(), d64, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_chunk_launcher_advances_the_state_in_place(backend):
    """``greedy_chunk_launcher`` gives ``greedy_chunk``'s chunks, chunk
    for chunk, on the same state object, its counter included."""
    rng = np.random.default_rng(4)
    V = torch.from_numpy(rng.normal(size=(8, 60)).astype(np.float32))
    spec = GreedySpec(k=12, window=3, backend=backend)
    ref, st = greedy_init(spec, V=V), greedy_init(spec, V=V)
    leaves = [x.data_ptr() for x in st]
    launch = greedy_chunk_launcher(spec, st, V=V, chunk_size=4)
    for _ in range(3):
        ref, want_i, want_d = greedy_chunk(spec, ref, V=V, chunk_size=4)
        got_i, got_d = launch()
        assert torch.equal(got_i.reshape(-1), want_i.reshape(-1))
        assert torch.equal(got_d.reshape(-1), want_d.reshape(-1))
        assert int(st.t) == int(ref.t)
    assert [x.data_ptr() for x in st] == leaves
    assert all(torch.equal(a, b) for a, b in zip(st, ref))


@pytest.mark.parametrize("window", [2, 4])
def test_windowed_state_rebuild_matches_incremental(window):
    """The rebuild lands on the ring state the incremental torch stream
    reached from the same history (same Cholesky rows up to rounding)."""
    rng = np.random.default_rng(3)
    V = torch.from_numpy(rng.normal(size=(8, 40)).astype(np.float32))
    spec = GreedySpec(k=12, window=window, backend="torch")
    st = greedy_init(spec, V=V)
    st, sel, _ = greedy_chunk(spec, st, V=V, chunk_size=7)
    dead = torch.zeros(40, dtype=torch.bool)
    dead[sel.long()] = True
    C, d2 = windowed_state_rebuild(V, st.win, dead)
    torch.testing.assert_close(C, st.C, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(d2, st.d2, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("window,k", [(3, 10), (5, 8), (10, 6)])
def test_windowed_rebuild_oracle_matches_repro(window, k, masked):
    rng = np.random.default_rng(window)
    V = rng.normal(size=(10, 40)).astype(np.float32)
    L = V.T @ V
    mask = rng.uniform(size=40) > 0.3 if masked else None
    want = j_windowed_rebuild(jnp.asarray(L), k, window=window, eps=1e-4,
                              mask=None if mask is None
                              else jnp.asarray(mask))
    got = dpp_greedy_windowed_rebuild(
        torch.from_numpy(L), k, window=window, eps=1e-4,
        mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    assert int(got.n_selected) == int(want.n_selected)
    np.testing.assert_allclose(got.d_hist.numpy(), np.asarray(want.d_hist),
                               rtol=ORACLE.dh_rtol, atol=ORACLE.dh_atol)


# ---------------------------------------------------------------------------
# Metrics and spans
# ---------------------------------------------------------------------------


def _evict_sequence(rr, a, b):
    sa = rr.session(a, sid="a")
    sa.next_chunk(2)
    rr.session(b, sid="b").next_chunk(2)
    sa.next_chunk(2)  # touch the evicted session: rebuild delta
    sa.extend(*_delta(7, 3))
    # one shown (dead) id and one live: the port re-solves the live one
    ids = np.array([sa.shown[0], sa._gid[sa._gid >= 0][-1]])
    sa.rescore(ids, np.array([0.5, 0.7], np.float32))


@pytest.mark.parametrize("backend", BACKENDS)
def test_eviction_emits_metrics(backend, fresh_obs):
    """The port's counters equal ``repro``'s for the same sequence, name
    and label for label, but the columns a rescore re-solves: the port
    re-solves the live ids given, ``repro`` the pool range that covers
    them all; the gauges read the port's own bytes."""
    jobs.disable()
    jsess = jobs.enable(jobs.ObsConfig(enabled=True))
    try:
        jr, tr = _rerankers(backend, dict(budget_bytes=1))
        (ja, ta), (jb, tb) = _request(31, 24), _request(32, 24)
        _evict_sequence(jr, ja, jb)
        _evict_sequence(tr, ta, tb)
        want = jsess.registry.snapshot()["counters"]
    finally:
        jobs.disable()
    snap = fresh_obs.registry.snapshot()
    got = snap["counters"]
    for name in ("session_evictions_total", "session_deltas_total"):
        assert got[name] == want[name], name
    cols = dict(want["session_delta_cols_total"], **{"op=rescore": 1.0})
    assert got["session_delta_cols_total"] == cols
    assert set(got["session_deltas_total"]) == {
        "op=rebuild", "op=extend", "op=rescore"}
    sa = tr.sessions.get("a")
    assert snap["gauges"]["session_resident_bytes"] == {
        "": float(sa._resident_bytes)}
    assert snap["gauges"]["session_resident_count"] == {"": 1.0}
    spans = {s["name"] for s in fresh_obs.tracer.finished()}
    assert {f"serving.session.{v}" for v in (
        "resume", "extend", "rescore", "rebuild", "evict")} <= spans


@pytest.mark.parametrize("backend", BACKENDS)
def test_delta_spans_and_staged_widths(backend, fresh_obs):
    """A delta's block is staged at a power-of-two width, its padding a
    repeat of the last column (the chunks after it match ``repro``'s);
    an extend's and a rescore's span say how the delta's device half
    ran: eagerly on the CPU, and not at all when no live column is
    given."""
    both = _lockstep(backend, 12, 24, window=3)
    both.chunk(3)
    gids = both.extend(*_delta(5, 5))
    both.chunk(3)
    both.rescore(gids[:3], np.array([0.9, 0.2, 0.5], np.float32))
    both.rescore(both.t.shown[:2], np.array([0.7, 0.7], np.float32))
    both.chunk(3)
    assert sorted(both.t._stages) == [4, 8]
    solve = [(s["name"].rsplit(".", 1)[1], s["attrs"]["solve"])
             for s in fresh_obs.tracer.finished()
             if s["name"] in ("serving.session.extend",
                              "serving.session.rescore")]
    assert solve == [("extend", "eager"), ("rescore", "eager"),
                     ("rescore", "none")]


# ---------------------------------------------------------------------------
# Bookkeeping and pointed errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_store_close_and_sid_bookkeeping(backend):
    _, rr = _rerankers(backend)
    req = _request(41, 24)[1]
    sess = rr.session(req, sid="u1")
    # resuming by sid returns the same live session, ignoring req
    assert rr.session(_request(42, 24)[1], sid="u1") is sess
    with pytest.raises(ValueError, match="already exists"):
        rr.sessions.create(req, sid="u1")
    a, b = rr.session(_request(43, 24)[1]), rr.session(_request(44, 24)[1])
    assert a.sid != b.sid and len(rr.sessions) == 3
    rr.sessions.close("u1")
    assert "u1" not in rr.sessions and len(rr.sessions) == 2
    assert rr.sessions.device == torch.device("cpu")


@pytest.mark.parametrize("kw", [dict(window=None), dict(k=8, window=8)])
def test_session_requires_windowed_config(kw):
    for backend in BACKENDS:
        _, rr = _rerankers(backend, **kw)
        with pytest.raises(ValueError, match="windowed config"):
            rr.session(_request(1, 24)[1])


def test_session_rejects_sharded_pools():
    # the config takes a mesh (the sharded rerank and stream); the
    # session store refuses it itself, as repro's does
    cfg = ts.DPPRerankConfig(mesh=object(), **dict(_cfg_kw(),
                                                   chunk_size=None))
    with pytest.raises(NotImplementedError, match="sharded"):
        ts.SessionStore(cfg, ts.SessionConfig(), torch.device("cpu"))


def test_session_rejects_user_batches():
    rng = np.random.default_rng(0)
    s = rng.uniform(size=(2, 24)).astype(np.float32)
    f = rng.normal(size=(24, 8)).astype(np.float32)
    _, rr = _rerankers("torch")
    with pytest.raises(ValueError, match="one session per user"):
        rr.session(ts.RerankRequest(scores=s, feats=f))


@pytest.mark.parametrize("backend", BACKENDS)
def test_extend_capacity_exhausted(backend):
    _, rr = _rerankers(backend, dict(capacity=1))
    sess = rr.session(_request(2, 24)[1])  # cap clamps up to the shortlist
    with pytest.raises(ValueError, match="pool exhausted"):
        sess.extend(*_delta(1, 2))


@pytest.mark.parametrize("bad,match", [
    ((np.zeros((2, 3), np.float32), np.zeros((2, 8), np.float32)), "ndim"),
    ((np.zeros(2, np.float32), np.zeros((2, 5), np.float32)), "must be"),
])
def test_extend_rejects_bad_payloads(bad, match):
    _, rr = _rerankers("torch")
    with pytest.raises(ValueError, match=match):
        rr.session(_request(2, 24)[1]).extend(*bad)


def test_rescore_unknown_id():
    _, rr = _rerankers("kernel")
    sess = rr.session(_request(3, 24)[1])
    with pytest.raises(ValueError, match="unknown global id"):
        sess.rescore(np.asarray([10**6]), np.asarray([0.5], np.float32))


def test_session_config_validation():
    with pytest.raises(ValueError, match="budget_bytes"):
        ts.SessionConfig(budget_bytes=0)
    with pytest.raises(ValueError, match="capacity"):
        ts.SessionConfig(capacity=0)


def test_session_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.Reranker(ts.DPPRerankConfig(**_cfg_kw()))


# ---------------------------------------------------------------------------
# Figure 10 and the serve_recsys example at their CPU sizes
# ---------------------------------------------------------------------------


def test_fig10_parity_cpu():
    """Every chunk of both backends, and every slate of their full
    re-reranks, equals the float64 conditional greedy over the pool as
    it stood (the figure's parity gate); its latency gate is the
    card's."""
    rows = fig10_session.main(fast_mode=True, device="cpu")
    assert [r[0] for r in rows] == ["torch", "kernel"]
    assert all(r[8] == "ok" and r[5] == 48 for r in rows)


def _repro_example():
    spec = importlib.util.spec_from_file_location(
        "repro_serve_recsys", ROOT / "examples" / "serve_recsys.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scroll_lines(fn):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return [line.split("]")[0] for line in out.getvalue().splitlines()
            if line.startswith("scroll")]


def test_serve_recsys_session_demo_matches_repro():
    """The port's session demo (K6's plain version) prints ``repro``'s
    scrolls, id for id."""
    got = _scroll_lines(lambda: serve_recsys.session_demo("cpu"))
    assert len(got) == 3
    assert got == _scroll_lines(_repro_example().session_demo)


def test_serve_recsys_cpu(capsys):
    """The whole example on the CPU: the DeepFM part serves, the stream
    equals its rerank, every routed slate its per-request rerank."""
    serve_recsys.main(["--device", "cpu"])
    assert '"arch": "deepfm"' in capsys.readouterr().out
    rr, req, chunks = serve_recsys.stream_demo("cpu")
    np.testing.assert_array_equal(np.concatenate(chunks),
                                  rr.rerank(req)[0].numpy())
    rr, reqs, handles = serve_recsys.router_demo("cpu")
    for req, h in zip(reqs, handles):
        np.testing.assert_array_equal(h.slate()[0], rr.rerank(req)[0].numpy())
