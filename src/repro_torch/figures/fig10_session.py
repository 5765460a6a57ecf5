"""Session-aware incremental rerank: delta-resume latency against a full
re-rerank (beyond-paper; the serving consequence of the sliding window:
the windowed state *is* the session's conditioning state, so a scroll
event after a candidate-pool delta costs O(w * dM) for the delta plus
O(c) resumed steps, never an O(k * M) replay); the counterpart of
``repro``'s ``benchmarks/fig10_session.py``.

The scenario per backend: a session scrolls through a few chunks, then
``dM`` fresh candidates arrive and the user scrolls again.  The delta
path serves that event as ``extend(dM)`` + ``next_chunk(c)`` on the
warm session; the stateless baseline re-reranks a ``shown + c`` slate
from scratch over the grown pool (what a server without sessions must
do).  Reported per row: best-of-trials delta-event latency (headline),
the full re-rerank latency it undercuts, and a parity flag.

The backends are the port's torch core and its kernels
(``use_kernel=True``): on the card every ``next_chunk`` is one K6
launch (``fused_chunk_windowed``) and the stateless re-rerank one K2
launch; on the CPU the kernels' plain versions run.

Two gates, red on failure:

* **parity** — every chunk the session emits (including every
  post-delta chunk) must equal, id for id, an independent float64
  from-scratch conditional greedy over the pool *as it stood at that
  scroll event* (:func:`ref_next_picks`: per pick, a fresh Cholesky of
  the window's Gram plus a full candidate solve).  The final pool is
  not a valid reference — a stateless rerun over it could place
  late-arriving candidates in early positions the session never saw
  them for.  Every slate of the full re-rerank (warm and timed) must
  equal the same greedy from an empty history over the pool it ran on.
  Checked on every device.
* **latency** — the delta event must be strictly faster than the full
  re-rerank.  A wall-clock ordering, so it is asserted on the card
  only; on the CPU the times are host times of the plain path and are
  reported, not asserted.

  python -m repro_torch.figures.fig10_session [--smoke | --full] [--device cuda|cpu]
"""
from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from repro_torch.core import map_relevance
from repro_torch.device import resolve_device
from repro_torch.figures.common import device_line, parse
from repro_torch.serving import (
    DPPRerankConfig,
    Reranker,
    RerankRequest,
    SessionConfig,
)

ALPHA, EPS = 3.0, 1e-6
BACKENDS = (("torch", {}), ("kernel", dict(use_kernel=True)))


def ref_next_picks(Vf, shown, n, w, eps):
    """From-scratch conditional greedy over pool ``Vf (D, M)`` given the
    ``shown`` history — the independently derived float64 reference the
    session's delta-updated resume is gated against.  Returns the next
    (at most ``n``) picks, stopping where no gain clears ``eps^2``."""
    Vf = np.asarray(Vf, np.float64)
    L = Vf.T @ Vf
    shown = list(shown)
    dead = np.zeros(L.shape[0], bool)
    dead[shown] = True
    picks = []
    for _ in range(n):
        win = shown[-w:]
        if win:
            F = np.linalg.cholesky(L[np.ix_(win, win)])
            Ci = np.linalg.solve(F, L[np.asarray(win), :])
            d2 = np.diag(L) - np.sum(Ci * Ci, axis=0)
        else:
            d2 = np.diag(L).copy()
        d2[dead] = -np.inf
        j = int(np.argmax(d2))
        if not d2[j] > eps * eps:
            break
        picks.append(j)
        shown.append(j)
        dead[j] = True
    return picks


def setup(M, D, seed=0):
    """Uniform scores (M,) and unit-norm Gaussian features (M, D),
    float32 numpy (``repro``'s draws)."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(M, D)).astype(np.float32)
    feats /= np.maximum(np.linalg.norm(feats, axis=1, keepdims=True), 1e-12)
    scores = rng.uniform(size=M).astype(np.float32)
    return scores, feats


@contextlib.contextmanager
def no_gc():
    """The garbage collector off around a timed loop, as ``timeit``
    does, after one collection: a pause lands on whichever event it
    falls in, the delta path's or the baseline's."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def run_backend(name, extra, M, D, w, chunk, dm, warm_chunks, trials, dev):
    """One backend's timings, ``(name, M, dM, w, chunk, shown, best
    delta event s, best full re-rerank s)``, and what its parity check
    needs: ``(scores, feats, deltas, emitted chunks)``."""
    scores, feats = setup(M, D)
    # slate_size bounds one scroll burst, not the feed: the session
    # keeps emitting chunks for as long as the user scrolls
    cfg = DPPRerankConfig(slate_size=w + chunk, shortlist=M, alpha=ALPHA,
                          eps=EPS, window=w, chunk_size=chunk, **extra)
    cap = M + (trials + 1) * dm
    rr = Reranker(cfg, session_config=SessionConfig(
        budget_bytes=1 << 32, capacity=cap,
    ), device=dev)
    sess = rr.session(RerankRequest(
        scores=torch.as_tensor(scores, device=dev),
        feats=torch.as_tensor(feats, device=dev)))

    # delta event 0 warms the delta path's first calls (the host's
    # LAPACK, the pinned staging, the kernels' module) out of the timing
    deltas = [setup(dm, D, seed=100 + t)[:2] for t in range(trials + 1)]

    # every chunk with the number of deltas in the pool when it was
    # emitted and the history before it, for the parity check
    emitted, history = [], []

    def emit(ids, n_deltas):
        emitted.append((n_deltas, list(history), [int(i) for i in ids]))
        history.extend(int(i) for i in ids)

    for _ in range(warm_chunks):
        emit(sess.next_chunk(chunk)[0], 0)
    shown0 = len(history)
    k_full = shown0 + chunk  # what a stateless server recomputes

    def delta_event(ds, df):
        # the new candidates arrive on the host, as a server receives them
        t0 = time.perf_counter()
        sess.extend(ds, df)
        ids, _ = sess.next_chunk(chunk)  # numpy: the device work is done
        return time.perf_counter() - t0, ids

    best_delta = float("inf")
    with no_gc():
        for t, (ds, df) in enumerate(deltas):
            dt, ids = delta_event(ds, df)
            emit(ids, t + 1)
            if t > 0:
                best_delta = min(best_delta, dt)

    # stateless baseline: re-rerank shown0 + chunk from scratch over the
    # pool as it stood after the first delta (the same scroll event)
    full_scores = np.concatenate([scores, deltas[0][0]])
    full_feats = np.concatenate([feats, deltas[0][1]])
    full_cfg = DPPRerankConfig(slate_size=k_full, shortlist=M + dm,
                               alpha=ALPHA, eps=EPS, window=w, **extra)
    full_rr = Reranker(full_cfg, device=dev)
    full_req = RerankRequest(scores=torch.as_tensor(full_scores, device=dev),
                             feats=torch.as_tensor(full_feats, device=dev))
    slates = [full_rr.rerank(full_req)[0].cpu()]  # warm
    best_full = float("inf")
    with no_gc():
        for _ in range(max(trials, 2)):
            t0 = time.perf_counter()
            slates.append(full_rr.rerank(full_req)[0].cpu())
            best_full = min(best_full, time.perf_counter() - t0)

    return (name, M, dm, w, chunk, shown0, best_delta, best_full), (
        scores, feats, deltas, emitted, [s.tolist() for s in slates])


def parity(scores, feats, deltas, emitted, slates, w):
    """Every emitted chunk against :func:`ref_next_picks` over the pool
    as it stood when the chunk was emitted, and every slate of the full
    re-rerank against the same reference from an empty history over
    the pool after the first delta.  ``shortlist`` keeps every
    candidate, so a session global id and a slate index are both indices
    into the concatenated (scores, feats) arrays: the reference works
    directly in id space."""
    def pool(n_deltas):
        s_all = np.concatenate([scores] + [d[0] for d in deltas[:n_deltas]])
        f_all = np.concatenate([feats] + [d[1] for d in deltas[:n_deltas]])
        rel = map_relevance(torch.from_numpy(s_all), ALPHA).numpy()
        return (f_all * rel[:, None]).T

    for n_deltas, before, ids in emitted:
        if ref_next_picks(pool(n_deltas), before, len(ids), w, EPS) != ids:
            return "FAIL"
    want = ref_next_picks(pool(1), [], len(slates[0]), w, EPS)
    return "ok" if all(s == want for s in slates) else "FAIL"


def run(fast_mode, device=None):
    """Returns ``(rows, failures)``: the rows of both backends and the
    red gates (latency only on the card)."""
    dev = resolve_device(device)
    # warm_chunks sets the shown history the stateless baseline must
    # replay (its slate grows with the feed) while the delta event's
    # cost stays flat — the structural margin the latency gate rides on
    M, D, w, chunk, dm, warm_chunks = (
        (1024, 32, 8, 8, 64, 6) if fast_mode else (4096, 32, 8, 8, 128, 6)
    )
    trials = 2 if fast_mode else 5
    runs = [run_backend(name, extra, M, D, w, chunk, dm, warm_chunks,
                        trials, dev) for name, extra in BACKENDS]
    # the float64 references run after every timing: their BLAS threads
    # would share the host with a timed event
    rows = [row + (parity(*data, w),) for row, data in runs]
    failures = []
    bad = [r for r in rows if r[8] != "ok"]
    if bad:
        failures.append(
            f"session-resume vs from-scratch parity failure: {bad}")
    slow = [r for r in rows if not r[6] < r[7]]
    if dev.type == "cuda" and slow:
        failures.append(
            f"delta-resume did not beat the full re-rerank: {slow}")
    return rows, failures


def main(fast_mode=False, device=None):
    dev = resolve_device(device)
    rows, failures = run(fast_mode, device=dev)
    print(device_line(dev))
    print("name,us_per_call,derived")
    for (name, M_, dm_, w_, c_, shown, t_delta, t_full, parity) in rows:
        print(
            f"fig10_session_{name}_M{M_}_dM{dm_},{t_delta*1e6:.1f},"
            f"full_rerank_us={t_full*1e6:.1f};"
            f"delta_vs_full={t_delta/max(t_full, 1e-12):.2f}x;"
            f"dm={dm_};chunk={c_};w={w_};shown={shown};parity={parity}"
        )
    if failures:
        raise RuntimeError(f"fig10 session gate failures: {failures}")
    return rows


if __name__ == "__main__":
    fast, dev = parse(__doc__)
    main(fast_mode=fast, device=dev)
