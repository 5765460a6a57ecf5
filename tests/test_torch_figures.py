"""The port's paper figures (``repro_torch.figures``) on the CPU.

Figure 3 is held against ``repro``'s own ``benchmarks/fig3_tradeoff.py``
run in the same process at its fast-mode sweep, on each of the three
datasets: every row (recall, average / minimum / median dissimilarity)
must be equal, except where a Div-DPP user's slate parts from
``repro``'s at a float64-certified near-tie (relative gap within
``TIE_REL``, or a stop decided within ``TIE_REL`` of eps^2).  MMR and
greedy-avg are bit-equal float32 loops and get no such allowance.

Figures 1, 2, 4 and 6 run at their ``--smoke`` sizes with
``device="cpu"``, where the kernel rows run the kernels' plain versions;
their gates must be green (Figure 1: every fast slate equals the float64
naive slate; Figure 4: gate-sweep parity and a past-the-gate cell on the
tiled kernels; Figure 6: streamed = whole slate and one K6 wrapper
call a chunk, its time-to-first-chunk ordering gated on the card only).
Figure 4's N-sweep slates are held against ``repro``'s greedy, Figure
6's kernel row and the quickstart's slates against the torch core.  Figure 5 runs its
smoke sweep (P = 1 and 2 gloo ranks on the CPU): its rows carry
``repro``'s row names and CSV keys.  ``run.py`` must write its artifacts
where it is told and refuse ``benchmarks/results``.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.core as jc
from repro_torch.core import GreedySpec, greedy_map, scaled_features
from repro_torch.kernels.dpp_greedy.tiling import DEFAULT_TILE_M
from repro_torch.figures import (
    common,
    fig1_speedup,
    fig2_reference,
    fig3_tradeoff,
    fig4_windowed,
    fig5_sharded,
    fig6_streaming,
    run,
)

ROOT = Path(__file__).resolve().parents[1]
TIE_REL = 1e-5  # float64 near-tie tolerance, as chip_smoke.py's
CPU = torch.device("cpu")


def _repro_fig3():
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import fig3_tradeoff
    finally:
        sys.path.remove(str(ROOT))
    return fig3_tradeoff


def _repro_fig5():
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import fig5_sharded
    finally:
        sys.path.remove(str(ROOT))
    return fig5_sharded


def _gains64(L, prefix):
    """Float64 marginal gains d^2 of every item given ``prefix``; picked
    items at -inf."""
    g = np.diag(L).copy()
    if len(prefix):
        P = list(prefix)
        LPi = L[P]
        g = g - (LPi * np.linalg.solve(L[np.ix_(P, P)], LPi)).sum(0)
        g[P] = -np.inf
    return g


def _near_tie(L, a, b, eps):
    """Whether local slates a and b first part at a float64 near-tie."""
    p = int(np.nonzero(a != b)[0][0])
    g = _gains64(L, a[:p])
    if a[p] < 0 or b[p] < 0:  # one stopped: the best gain sits at eps^2
        return abs(g.max() - eps * eps) <= TIE_REL * eps * eps
    x, y = g[a[p]], g[b[p]]
    return abs(x - y) <= TIE_REL * max(abs(x), abs(y))


def _dpp_users_certified(name, alpha, detail, N):
    """Every user whose port Div-DPP slate differs from ``repro``'s
    (recomputed with ``repro``'s calls) parts from it at a float64
    near-tie; returns how many differ."""
    ds_cands, S = detail["cands"], detail["S"]
    got = detail["slates"][f"divdpp_a{alpha}"]
    differ = 0
    for row, u in enumerate(detail["users"]):
        cand, rel = ds_cands[u]
        r = fig3_tradeoff.normalize(rel)
        Ssub = S[np.ix_(cand, cand)]
        L = jc.build_kernel_dense(jnp.asarray(r), jnp.asarray(Ssub), alpha=alpha)
        want = np.asarray(jc.dpp_greedy_dense(L, N, eps=fig3_tradeoff.DPP_EPS)
                          .indices)
        ids = got[row]
        mine = np.where(ids >= 0, np.searchsorted(cand, ids), -1)
        if not np.array_equal(mine, want):
            differ += 1
            assert _near_tie(np.asarray(L, np.float64), mine, want,
                             fig3_tradeoff.DPP_EPS), (name, alpha, u)
    return differ


@pytest.mark.parametrize("name", ["jester-like", "lastfm-like",
                                  "movielens-like"])
def test_fig3_fast_rows_match_repro(name):
    jf = _repro_fig3()
    cfg = fig3_tradeoff.DATASETS[name]
    args = (name, cfg["N"], cfg["K"], (1.0, 4.0, 64.0), (0.3, 0.7), (0, 1))
    want = jf.run_dataset(*args)
    got, detail = fig3_tradeoff.run_dataset(*args, device=CPU)
    assert [r[0] for r in got] == [r[0] for r in want]
    for (algo, rec, div), (_, rec_j, div_j) in zip(got, want):
        if rec == rec_j and div == div_j:
            continue
        assert algo.startswith("divdpp_a"), (algo, rec, rec_j, div, div_j)
        assert _dpp_users_certified(name, float(algo[len("divdpp_a"):]),
                                    detail, cfg["N"]) > 0


def test_fig3_main_is_jester_in_fast_mode():
    out = fig3_tradeoff.main(fast_mode=True, device=CPU)
    assert list(out) == ["jester-like"]
    rows, detail = out["jester-like"]
    assert [r[0] for r in rows] == [
        "random_b0", "random_b1", "mmr_t0.3", "greedy_t0.3", "mmr_t0.7",
        "greedy_t0.7", "divdpp_a1.0", "divdpp_a4.0", "divdpp_a64.0"]
    for slates in detail["slates"].values():
        assert slates.shape == (detail["users"].size, 10)


def test_fig1_smoke_cpu_slates_equal_the_float64_naive():
    rows = fig1_speedup.main(fast_mode=True, device=CPU)
    assert [r["N"] for r in rows] == [5, 10, 20]
    for r in rows:
        assert r["t_naive"] is not None
        assert r["exact_match"] == {"naive_slogdet": True, "divdpp": True,
                                    "divdpp_kernel": True}, r["N"]


def test_fig1_float64_slogdet_is_the_reference_past_numpy():
    rows = fig1_speedup.run(trials=1, Ns=(5, 25), numpy_Ns=(5,), M=300,
                            D=40, device=CPU)
    assert rows[0]["exact_match"]["naive_slogdet"] is True
    assert rows[1]["t_naive"] is None and "naive" not in rows[1]["slates"]
    assert rows[1]["exact_match"]["naive_slogdet"] is None
    assert rows[1]["exact_match"]["divdpp"] is True


def test_fig2_smoke_cpu_matches_repro_selectors():
    rows = fig2_reference.main(fast_mode=True, device=CPU)
    r, S, _, _ = common.paper_setup(device=CPU)
    for row in rows:
        N = row["N"]
        for name, fn in (("mmr", jc.mmr_select),
                         ("greedy", jc.greedy_avg_select)):
            want = np.asarray(fn(jnp.asarray(r.numpy()),
                                 jnp.asarray(S.numpy()), N, 0.5))
            np.testing.assert_array_equal(row["slates"][name], want)
        np.testing.assert_array_equal(row["slates"]["divdpp"],
                                      row["slates"]["divdpp_kernel"])
        assert set(row["times"]) == {"mmr", "greedy", "divdpp",
                                     "divdpp_kernel"}


def test_fig4_smoke_cpu_gate_sweep():
    rows, grows = fig4_windowed.main(fast_mode=True, device=CPU)
    assert [r[0] for r in rows] == [8, 16, 32, 64]
    assert [(g["M"], g["D"], g["w"]) for g in grows] == list(
        fig4_windowed.FAST_CELLS)
    for g in grows:
        assert g["parity"] == "ok"
        assert g["past_gate"] == int(g["mode"] == "tiled")
        assert g["launches"] == {}  # the plain versions launch nothing
    past = [g for g in grows if g["past_gate"]]
    assert past and all(g["tile_m"] == 1024 for g in past)


def test_fig4_gate_slates_match_repro_windowed_core():
    """The in-gate cell's kernel slate (K2's plain version) against
    ``repro``'s windowed greedy on the same V."""
    g, = fig4_windowed.run_gate([(4096, 32, 8)], 16, 1, device=CPU)
    V = fig4_windowed.setup(4096, 32, device=CPU).numpy()
    want = jc.greedy_map(jc.GreedySpec(k=16, window=8, eps=1e-6),
                         V=jnp.asarray(V)).indices
    np.testing.assert_array_equal(g["slates"]["kernel"][0], np.asarray(want))


def test_fig4_sweep_slates_match_repro_core():
    """The N-sweep's kernel slates (K2's and K1's plain versions) against
    ``repro``'s greedy on the same V: windowed at every N, exact while N
    stays within V's rank (D = 48), past which the float32 gains are
    rounding noise and no reference orders them."""
    M, D, w = fig4_windowed.FAST_SWEEP
    rows = fig4_windowed.run(M=M, D=D, w=w, trials=1, device=CPU)
    V = jnp.asarray(fig4_windowed.setup(M, D, device=CPU).numpy())
    assert [r[0] for r in rows] == [8, 16, 32, 64]
    for N, _, _, _, slates in rows:
        for path, window in (("windowed", w), ("exact", None)):
            if window is None and N > D:
                continue
            want = jc.greedy_map(jc.GreedySpec(k=N, window=window, eps=1e-6),
                                 V=V).indices
            np.testing.assert_array_equal(slates[path], np.asarray(want),
                                          err_msg=f"N={N} {path}")


def test_fig6_smoke_cpu_gates_and_one_k6_call_a_chunk(monkeypatch):
    from repro_torch.kernels.dpp_greedy import ops

    calls = []
    real = ops.fused_chunk_windowed

    def counted(*args):
        calls.append(args[6])  # the chunk
        return real(*args)

    monkeypatch.setattr(ops, "fused_chunk_windowed", counted)
    rows = fig6_streaming.main(fast_mode=True, device=CPU)
    assert [r["name"] for r in rows] == ["torch", "kernel"]
    for r in rows:
        # the time-to-first-chunk ordering is the card's gate (phase 13
        # of chip_smoke.py), not asserted on the CPU
        assert r["parity"] == "ok"
        assert r["fused_calls_per_chunk"] is None  # no launches on the CPU
    # the kernel row's whole and streamed slates are the torch row's
    np.testing.assert_array_equal(rows[1]["slate"], rows[0]["slate"])
    np.testing.assert_array_equal(rows[1]["streamed"], rows[0]["slate"])
    # the kernel row's streams (warm + 2 trials), 8 chunks of 8 each
    assert calls == [8] * 8 * 3


# the keys of repro's fig5 rows (benchmarks/fig5_sharded.py, _inner)
FIG5_KEYS = {"us_per_user_step", "B", "Mloc", "D", "N", "tile_m",
             "past_gate"}


def test_fig5_smoke_rows_match_repro_schema(capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # rank_env keeps it
    out = fig5_sharded.main(fast_mode=True, device=CPU, at_once=True)
    cfg = _repro_fig5()._PRESETS[True]
    want = [f"fig5_sharded_{label}{tl}_B{B}_P{P}_M{cfg['mloc'] * P}"
            for P in cfg["devices"]
            for label in ("exact", f"w{cfg['window']}")
            for tl in ("", f"_tm{cfg['tile_m']}")
            for B in sorted({1, cfg["batch"]})]
    rows = run._parse_rows(capsys.readouterr().out)
    assert [r["name"] for r in rows] == want
    assert [r["name"] for r in out["rows"]] == want
    for r in rows:
        derived = dict(kv.split("=") for kv in r["derived"].split(";"))
        assert set(derived) == FIG5_KEYS | {"backend"}, r
        assert derived["backend"] == "gloo" and r["us_per_call"] > 0
        assert derived["past_gate"] == "0"  # Mloc 2048: resident-size
        assert int(derived["tile_m"]) in (cfg["tile_m"], DEFAULT_TILE_M)
    assert out["launches"] == {1: {}, 2: {}}  # plain versions: none


def test_run_writes_artifacts_where_told(tmp_path):
    run.main(["--device", "cpu", "--smoke", "--out-dir", str(tmp_path)])
    for fig, _, _ in run.FIGURES:
        doc = json.loads((tmp_path / f"BENCH_{fig}.json").read_text())
        assert doc["status"] == "ok" and doc["fast_mode"] is True
        assert doc["rows"] and doc["meta"]["device"] == "cpu"
        assert doc["meta"]["torch"] == torch.__version__
        # every figure but fig3 (the dense core, called directly) and
        # fig5 (its ranks are subprocesses, with registries of their own)
        # goes through greedy_map, which the registry counts; fig8's
        # greedy_map calls are its parity reranks, in the session it
        # installs itself, beside its router's chunks and its streams'
        # whole-request states
        counters = doc["obs"]["counters"]
        counted = "greedy_dispatch_total" in counters
        assert counted == (fig not in ("fig3", "fig5")), fig
        if fig == "fig8":
            assert counters["greedy_dispatch_total"] == {
                "backend=kernel,chunked=False": 12}
            assert sum(counters["greedy_state_allocs_total"].values()) >= 1
            assert sum(counters["greedy_chunks_total"].values()) >= 1


def test_fig6_timing_gate_is_the_cards(monkeypatch):
    """Figure 6's time-to-first-chunk ordering is checked on the card
    only (as figures 9 and 10 check theirs); its parity gate holds on
    every device."""
    row = dict(name="kernel", M=2048, D=32, N=64, w=8, chunk=8,
               t_first=2.0, t_whole=1.0, t_total=3.0,
               fused_calls_per_chunk=None, parity="ok")
    monkeypatch.setattr(fig6_streaming, "run", lambda *a, **k: [dict(row)])
    fig6_streaming.main(fast_mode=True, device=CPU)  # slower: no gate
    card = torch.device("cuda")
    monkeypatch.setattr(fig6_streaming, "resolve_device", lambda d: d)
    monkeypatch.setattr(fig6_streaming, "device_line", lambda d: "# card")
    with pytest.raises(RuntimeError, match="did not beat whole-slate"):
        fig6_streaming.main(fast_mode=True, device=card)
    row["parity"] = "FAIL"
    with pytest.raises(RuntimeError, match="parity failure"):
        fig6_streaming.main(fast_mode=True, device=CPU)


@pytest.mark.parametrize("where", ["cwd", "checkout", "inside"])
def test_run_refuses_repro_results(tmp_path, monkeypatch, where):
    monkeypatch.chdir(tmp_path)
    out = {"cwd": "benchmarks/results",
           "checkout": str(ROOT / "benchmarks" / "results"),
           "inside": "benchmarks/results/port"}[where]
    with pytest.raises(ValueError, match="benchmarks/results"):
        run.main(["--device", "cpu", "--out-dir", out])
    assert not (tmp_path / "benchmarks").exists()


def test_cli_defaults_to_the_card_and_fast_mode():
    doc = fig1_speedup.__doc__
    fast, dev = common.parse(doc, ["--device", "cpu"])
    assert fast and dev == CPU
    assert common.parse(doc, ["--full", "--device", "cpu"])[0] is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            common.parse(doc, [])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fig1_speedup.main(fast_mode=True)


def test_quickstart_cpu():
    from repro_torch.examples import quickstart

    slates = quickstart.main("cpu")
    assert list(slates) == list(quickstart.ALPHAS)
    relevance, feats = quickstart.setup("cpu")
    for alpha, sel in slates.items():
        assert sel.shape == (quickstart.N,)
        assert np.unique(sel).size == quickstart.N and (sel >= 0).all()
        # K1's plain version against the torch core on the same V
        V = scaled_features(feats, relevance, alpha)
        want = greedy_map(GreedySpec(k=quickstart.N, backend="torch"), V=V)
        np.testing.assert_array_equal(sel, want.indices.numpy())


def test_device_name_raises_when_the_card_is_not_read(monkeypatch):
    """On a card no time goes out without the power limit: a failed
    ``nvidia-smi`` query raises instead of printing the name alone."""
    def fail(*args, **kwargs):
        raise subprocess.CalledProcessError(9, args[0])

    monkeypatch.setattr(common.subprocess, "run", fail)
    with pytest.raises(subprocess.CalledProcessError):
        common.device_name(torch.device("cuda", 0))
    assert common.device_name(CPU) == "cpu"
