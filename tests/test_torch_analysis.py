"""Tests for ``repro_torch.analysis``, case for case with
``tests/test_analysis.py``: the checker is checked from both sides.

* **negative oracle** — the seeded corpus in tests/fixtures/torch_analysis/
  makes every AST rule fire at exactly its planted lines; suppressions
  silence exactly their line; a typo'd rule id is a finding;
* **positive oracle** — the port (``src/repro_torch`` and
  ``chip_smoke.py``) comes back with zero findings, the kernel contract
  sweep covers every family, and the router and session geometry proofs
  equal, field for field, what ``repro``'s proofs report of ``repro``'s
  router and session;
* **kernel rules** — each fires on a monkeypatched corruption: a cluster
  slice or a tile count that misses the last columns, a tile that is not
  a warp multiple, a model that undercounts shared memory, a cooperative
  grid past a small capacity, a cluster size past the portable 8;
* **autotune cache** — the seeded cache fires every facet of
  ``autotune-cache-invalid``; a missing or valid cache is clean;
* **Figure 8** — ``--smoke`` on the CPU passes its gates, its router
  slates equal ``repro``'s router's on the same seeded requests (its jnp
  core), and its rows carry ``repro``'s row names.
"""
import ast
import importlib
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from conftest import _ORACLES
from repro.analysis import RULES as REPRO_RULES
from repro.analysis import jitgeo as repro_jitgeo
from repro_torch import obs
from repro_torch.analysis import COUNTERPARTS, RULES, run_analysis
from repro_torch.analysis import jitgeo
from repro_torch.analysis import kernels as ak
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.findings import (
    Finding,
    apply_suppressions,
    scan_suppressions,
)
from repro_torch.figures import fig8_observability as fig8
from repro_torch.kernels.dpp_greedy import tiling

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "torch_analysis"
PORT = [str(ROOT / "src" / "repro_torch"), str(ROOT / "chip_smoke.py")]
ORACLE = _ORACLES["incremental"]()

AST_RULES = {
    "capture-sync", "capture-pyif", "host-sync-hot", "obs-nonstatic",
    "dead-shim", "plan-key-tensor", "plan-key-unhashable",
    "router-geometry", "session-geometry", "bad-suppression",
}
KERNEL_RULES = {
    "cuda-coverage", "cuda-alignment", "cuda-smem-budget",
    "cuda-smem-model", "cuda-cluster", "cuda-coresidency",
    "autotune-cache-invalid",
}

# the corpus' planted violations: (fixture file, line, rule)
GOLDEN = {
    ("fx_capture.py", 8, "capture-sync"),
    ("fx_capture.py", 9, "capture-pyif"),
    ("fx_capture.py", 18, "capture-sync"),
    ("fx_capture.py", 19, "capture-pyif"),
    ("fx_capture.py", 29, "capture-sync"),
    ("fx_dead_shim.py", 2, "dead-shim"),
    ("fx_dead_shim.py", 3, "dead-shim"),
    ("fx_dead_shim.py", 12, "dead-shim"),
    ("fx_host_sync.py", 9, "host-sync-hot"),
    ("fx_host_sync.py", 10, "host-sync-hot"),
    ("fx_host_sync.py", 12, "host-sync-hot"),
    ("fx_obs_nonstatic.py", 6, "obs-nonstatic"),
    ("fx_obs_nonstatic.py", 8, "obs-nonstatic"),
    ("fx_plan_keys.py", 8, "plan-key-tensor"),
    ("fx_plan_keys.py", 19, "plan-key-tensor"),
    ("fx_plan_keys.py", 21, "plan-key-tensor"),
    ("fx_plan_keys.py", 22, "plan-key-unhashable"),
    ("fx_router_geometry.py", 14, "router-geometry"),
    ("fx_router_geometry.py", 19, "router-geometry"),
    ("fx_router_geometry.py", 24, "router-geometry"),
    ("fx_router_geometry.py", 28, "router-geometry"),
    ("fx_session_geometry.py", 17, "session-geometry"),
    ("fx_session_geometry.py", 19, "session-geometry"),
    ("fx_suppressed.py", 12, "bad-suppression"),
    ("fx_suppressed.py", 12, "obs-nonstatic"),
}


@pytest.fixture(scope="module")
def corpus():
    return run_analysis([str(FIXTURES)], kernel_checks=False)


@pytest.fixture
def hermetic_cache(tmp_path, monkeypatch):
    """No developer's tuned cache, no process tile override."""
    monkeypatch.setenv("DPP_AUTOTUNE_CACHE", str(tmp_path / "absent.json"))
    monkeypatch.delenv("DPP_TILE_M", raising=False)


# --------------------------------------------------------------------------
# Negative oracle: the seeded corpus
# --------------------------------------------------------------------------


def test_rule_catalog_is_complete():
    assert set(RULES) == AST_RULES | KERNEL_RULES
    assert set(COUNTERPARTS) == set(RULES)
    # every rule stands for a repro rule, or says it has none
    assert {c for c in COUNTERPARTS.values() if c} <= set(REPRO_RULES)
    assert [r for r, c in COUNTERPARTS.items() if c is None] == [
        "cuda-cluster"]


def test_corpus_matches_golden_findings(corpus):
    findings, _ = corpus
    got = {(Path(f.path).name, f.line, f.rule) for f in findings}
    assert got == GOLDEN


def test_every_ast_rule_fires_on_the_corpus(corpus):
    findings, _ = corpus
    assert {f.rule for f in findings} == AST_RULES


def test_cli_exits_nonzero_on_corpus(capsys):
    rc = cli_main([str(FIXTURES), "--no-kernel-checks",
                   "--error-on-findings"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "finding(s)" in out


def test_clean_file_exits_zero(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("import torch\n\n\ndef f(x):\n    return x.sum()\n")
    assert cli_main([str(clean)]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


def test_list_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule, stands in COUNTERPARTS.items():
        assert rule in out
        assert f"[repro: {stands or 'no repro counterpart'}]" in out


def test_suppression_silences_only_its_line(corpus):
    findings, _ = corpus
    suppressed = [f for f in findings
                  if Path(f.path).name == "fx_suppressed.py"]
    # line 7 is validly suppressed: nothing anchors there
    assert all(f.line != 7 for f in suppressed)
    # the typo'd suppression on line 12 silences nothing and is itself a
    # finding
    assert {(f.line, f.rule) for f in suppressed} == {
        (12, "bad-suppression"), (12, "obs-nonstatic"),
    }


def test_unknown_rule_id_is_rejected():
    supp, bad = scan_suppressions(
        "x.py", "a = 1  # repro_torch: ignore[no-such-rule]\n")
    assert supp == {}
    assert [f.rule for f in bad] == ["bad-suppression"]
    assert "no-such-rule" in bad[0].message


def test_suppression_in_docstring_is_not_a_suppression():
    supp, bad = scan_suppressions(
        "x.py", '"""docs mention # repro_torch: ignore[capture-sync]"""\n')
    assert supp == {} and bad == []


def test_repro_marker_is_not_the_ports():
    """``# repro: ignore[...]`` is repro's marker: the port neither
    honours it nor reports it (repro's checker owns it)."""
    supp, bad = scan_suppressions(
        "x.py", "a = 1  # repro: ignore[trace-cast]\n")
    assert supp == {} and bad == []


def test_bad_suppression_cannot_be_suppressed():
    f = Finding("x.py", 3, "bad-suppression", "typo")
    kept = apply_suppressions([f], {"x.py": {3: {"bad-suppression"}}})
    assert kept == [f]


# --------------------------------------------------------------------------
# Positive oracle: the port is clean
# --------------------------------------------------------------------------


def test_whole_port_has_zero_findings(hermetic_cache):
    findings, summary = run_analysis(PORT)
    assert findings == [], "\n".join(f.format() for f in findings)
    kc = summary["kernel_contracts"]
    assert kc is not None and kc["families"] == sorted(ak.FAMILIES)
    assert "fm_interaction" in kc["families"]
    per = kc["per_family"]
    assert kc["geometries"] == sum(f["geometries"] for f in per.values())
    # every family is exercised; the cooperative ones stay co-resident
    assert all(f["geometries"] > 0 for f in per.values())
    for fam in ak.COOPERATIVE:
        assert 0 < per[fam]["largest_grid"] <= per[fam]["co_resident"]
    assert kc["wrapper_launches_driven"] > 0
    assert [g["class"] for g in summary["router_geometry"]] == [
        "RerankRouter"]
    assert [g["class"] for g in summary["session_geometry"]] == [
        "RerankSession"]


def test_cli_default_paths_are_the_port(hermetic_cache, monkeypatch,
                                        capsys):
    monkeypatch.chdir(ROOT)
    assert cli_main(["--error-on-findings", "--no-kernel-checks"]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s)" in out and "RerankRouter" in out


def _proof(path, summarize, cls):
    tree = ast.parse(path.read_text(), filename=str(path))
    got = [s for s in (summarize(n) for n in ast.walk(tree)
                       if isinstance(n, ast.ClassDef)) if s is not None]
    assert [s["class"] for s in got] == [cls]
    return got[0]


PROOF_FIELDS = ("violations", "launch_sites", "reachable_geometries")


@pytest.mark.parametrize("kind", ["router", "session"])
def test_geometry_proofs_match_repros(kind):
    """The port's proof of its router (session) reports what repro's
    proof reports of repro's: no violation, one launch site a family,
    one reachable geometry."""
    summarize = {"router": "router_geometry_summary",
                 "session": "session_geometry_summary"}[kind]
    cls = {"router": "RerankRouter", "session": "RerankSession"}[kind]
    mine = _proof(ROOT / "src" / "repro_torch" / "serving" / f"{kind}.py",
                  getattr(jitgeo, summarize), cls)
    theirs = _proof(ROOT / "src" / "repro" / "serving" / f"{kind}.py",
                    getattr(repro_jitgeo, summarize), cls)
    assert {f: mine[f] for f in PROOF_FIELDS} == \
        {f: theirs[f] for f in PROOF_FIELDS}
    assert mine["violations"] == [] and mine["reachable_geometries"] == 1


def test_corpus_router_summaries(corpus):
    _, summary = corpus
    by_class = {s["class"]: s for s in summary["router_geometry"]}
    assert by_class["WobblyRouter"]["reachable_geometries"] is None
    assert by_class["WobblyRouter"]["launch_sites"] == 2
    assert by_class["SteadyRouter"]["reachable_geometries"] == 1
    assert by_class["SteadyRouter"]["launcher_attrs"] == ["_run"]


def test_corpus_session_summaries(corpus):
    _, summary = corpus
    by_class = {s["class"]: s for s in summary["session_geometry"]}
    assert by_class["WobblySession"]["reachable_geometries"] is None
    assert by_class["WobblySession"]["launch_sites"][
        "greedy_state_extend"] == 2
    assert by_class["SteadySession"]["reachable_geometries"] == 1
    assert by_class["SteadySession"]["geometry_attrs"] == ["spec", "w"]


# --------------------------------------------------------------------------
# Kernel contract rules, each on a monkeypatched corruption
# --------------------------------------------------------------------------


def _kernel_rules(caps=None):
    findings, _ = ak.check_kernel_contracts(caps)
    return {f.rule for f in findings}, findings


def test_intact_plans_are_clean(hermetic_cache):
    assert ak.check_kernel_contracts()[0] == []
    # the plain versions' view (no capacity known) too
    no_caps = ak.Capacities(lambda w: None, lambda w: None, None,
                            ak.model_capacities().device, "none")
    assert ak.check_kernel_contracts(no_caps)[0] == []


def test_cluster_slice_missing_columns_is_a_coverage_gap(hermetic_cache,
                                                         monkeypatch):
    """K1/K2's CTAs of a cluster take slices that stop short of M."""
    mod = importlib.import_module(
        "repro_torch.kernels.dpp_greedy.dpp_greedy")
    monkeypatch.setattr(mod, "cluster_tile",
                        lambda M, s: max(4, (M - 1) // s // 4 * 4))
    rules, findings = _kernel_rules()
    assert "cuda-coverage" in rules
    assert any("never covered" in f.message and "clusters of" in f.message
               for f in findings)


def test_grid_missing_the_last_tile_is_a_coverage_gap(hermetic_cache,
                                                      monkeypatch):
    """The tiled and chunk grids count their tiles rounding down."""
    mod = importlib.import_module("repro_torch.kernels.dpp_greedy.tiled")
    monkeypatch.setattr(mod, "tile_count", lambda M, tm: max(1, M // tm))
    rules, findings = _kernel_rules()
    assert "cuda-coverage" in rules
    assert any("the last tile missed" in f.message for f in findings)


def test_tile_off_the_warp_is_an_alignment_finding(hermetic_cache,
                                                   monkeypatch):
    monkeypatch.setattr(tiling, "DEFAULT_TILE_M", 1000)
    rules, findings = _kernel_rules()
    assert "cuda-alignment" in rules
    assert any("tile_m=1000" in f.message for f in findings)


def test_undercounting_model_breaks_model_and_budget(hermetic_cache,
                                                     monkeypatch):
    """A chunk model that leaves out the tile's gains and state columns:
    the wrapper hands the launch more than the model says (smem model),
    and the policy, planning with the undercount, picks tiles whose real
    bytes overflow the block (smem budget)."""
    real = tiling.chunk_smem_bytes
    monkeypatch.setattr(
        tiling, "chunk_smem_bytes",
        lambda D, tile_m, R, windowed, v_resident=False:
        real(D, 0, R, windowed, v_resident))
    rules, findings = _kernel_rules()
    assert {"cuda-smem-model", "cuda-smem-budget"} <= rules
    assert any("the tiling model counts" in f.message for f in findings)


def test_cooperative_grid_past_a_small_capacity(hermetic_cache,
                                                monkeypatch):
    """A chunk planner that ignores the card's co-residency, checked
    against a card that keeps 16 blocks co-resident."""
    real = tiling.TilePolicy._decide_chunked
    monkeypatch.setattr(
        tiling.TilePolicy, "_decide_chunked",
        lambda self, D, M, R, windowed, lanes, capacity:
        real(self, D, M, R, windowed, lanes, None))
    small = ak.model_capacities()
    small = ak.Capacities(lambda w: (lambda smem: 16), small.cluster,
                          small.topk, small.device, "16 blocks")
    rules, findings = _kernel_rules(small)
    assert "cuda-coresidency" in rules
    assert any("past the 16 the card keeps co-resident" in f.message
               for f in findings)


def _fm_broken(fm, fault):
    """K8's plan module with one fault: a block's last tile dropped, a
    bulk copy 8 bytes short of a 16-byte size, or shared memory past the
    budget."""
    if fault == "cuda-coverage":
        real = fm.block_tiles
        return "block_tiles", lambda plan, b: real(plan, b)[:-1] or range(0)
    if fault == "cuda-alignment":
        real = fm.tile_copy
        return "tile_copy", lambda *a: real(*a)._replace(
            size=max(0, real(*a).size - 8))
    real = fm.fm_layout
    return "fm_layout", lambda *a, **k: (*real(*a, **k)[:3],
                                          tiling.SMEM_BUDGET_BYTES + 16)


@pytest.mark.parametrize("fault", ["cuda-coverage", "cuda-alignment",
                                   "cuda-smem-budget"])
def test_fm_plan_faults_fire(hermetic_cache, monkeypatch, fault):
    """The fm_interaction family: each of its three rules fires on a plan
    broken its way, anchored at ``fm_plan``."""
    fm = importlib.import_module(
        "repro_torch.kernels.fm_interaction.fm_interaction")
    monkeypatch.setattr(fm, *_fm_broken(fm, fault))
    r = ak._Report()
    fams = {name: ak._Family() for name in ak.FAMILIES}
    ak._sweep_fm(ak.model_capacities(), r, fams)
    got = r.findings()
    assert fault in {f.rule for f in got}
    assert all(f.path.endswith("fm_interaction.py") for f in got)
    # a block past the budget fits no SM: no plan is made at all
    assert (fams["fm_interaction"].geometries > 0) == (
        fault != "cuda-smem-budget")


def test_non_portable_cluster_size_fires(hermetic_cache, monkeypatch):
    monkeypatch.setattr(tiling, "CLUSTER_SIZES", (1, 2, 4, 8, 16))
    rules, findings = _kernel_rules()
    assert "cuda-cluster" in rules
    assert any(ak._NON_PORTABLE_ATTR in f.message for f in findings)


def test_span_gaps():
    assert ak.span_gaps([(0, 4), (4, 10)], 10) is None
    assert "never covered" in ak.span_gaps([(0, 4), (6, 10)], 10)
    assert "twice" in ak.span_gaps([(0, 6), (4, 10)], 10)
    assert "past M" in ak.span_gaps([(0, 12)], 10)
    # an empty slice (a CTA past M) covers nothing and is fine
    assert ak.span_gaps([(0, 10), (10, 10)], 10) is None


def test_model_capacities_count_blocks_a_card_holds():
    # 256 threads of 128 registers: 2 blocks an SM (264 on 132 SMs, what
    # the card answers for K5 and K7) while shared memory does not bind
    assert ak.blocks_per_sm(0) == 2
    assert ak.model_capacities().chunk(False)(0) == 264
    # fewer registers: the threads bind (8 blocks of 256)
    assert ak.blocks_per_sm(0, regs=32) == 8
    # a block of the whole budget: one an SM
    assert ak.blocks_per_sm(tiling.SMEM_BUDGET_BYTES) == 1
    caps = ak.model_capacities(sms=2)
    assert caps.chunk(False)(tiling.SMEM_BUDGET_BYTES) == 2
    assert caps.cluster(True)(2, 0, True, True) == 2


# --------------------------------------------------------------------------
# Autotune cache validation (rule autotune-cache-invalid)
# --------------------------------------------------------------------------


def test_autotune_cache_fixture_fires_every_violation():
    fx = FIXTURES / "fx_autotune_cache.json"
    findings, summary = ak.check_autotune_cache(str(fx))
    assert summary == {
        "path": str(fx), "present": True, "entries": 4, "checked": 4,
    }
    assert len(findings) == 4
    assert {f.rule for f in findings} == {"autotune-cache-invalid"}
    msgs = "\n".join(f.message for f in findings)
    assert "over the 232448 B budget" in msgs              # over budget
    assert "not a positive multiple of the 32" in msgs     # off the warp
    assert "does not reproduce from its own fields" in msgs  # hand-edit
    assert "past the 264 the card keeps co-resident" in msgs  # grid
    assert all(f.path == str(fx) for f in findings)


def test_autotune_cache_missing_and_valid_are_clean(tmp_path):
    from repro_torch.kernels.dpp_greedy.autotune import AutotuneCache

    findings, summary = ak.check_autotune_cache(str(tmp_path / "no.json"))
    assert findings == [] and summary["present"] is False

    cache = AutotuneCache(str(tmp_path / "good.json"), {})
    cache.put(D=64, M_bucket=65536, state_rows=8, windowed=True,
              chunked=False, tile_m=512, best_us=10.0,
              candidates={512: 10.0}, plain=False,
              device=("dev", "cuda", "sm_90a-cuda"))
    cache.put(D=64, M_bucket=65536, state_rows=8, windowed=False,
              chunked=True, tile_m=1024, best_us=10.0,
              candidates={1024: 10.0}, plain=False, lanes=4,
              device=("dev", "cuda", "sm_90a-cuda"))
    cache.save()
    findings, summary = ak.check_autotune_cache(cache.path)
    assert findings == [], "\n".join(f.format() for f in findings)
    assert summary["checked"] == 2


def test_autotune_cache_corrupt_file_fires(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    findings, _ = ak.check_autotune_cache(str(bad))
    assert [f.rule for f in findings] == ["autotune-cache-invalid"]
    assert "not parseable" in findings[0].message

    foreign = tmp_path / "foreign.json"
    foreign.write_text('{"schema": 99, "entries": {}}')
    findings, _ = ak.check_autotune_cache(str(foreign))
    assert [f.rule for f in findings] == ["autotune-cache-invalid"]
    assert "schema" in findings[0].message


def test_run_analysis_validates_the_active_cache(tmp_path, monkeypatch):
    """With $DPP_AUTOTUNE_CACHE pointing at a bad cache, a run over the
    port surfaces it; an AST-only run never touches the cache."""
    monkeypatch.delenv("DPP_TILE_M", raising=False)
    bad = tmp_path / "cache.json"
    shutil.copy(FIXTURES / "fx_autotune_cache.json", bad)
    monkeypatch.setenv("DPP_AUTOTUNE_CACHE", str(bad))
    findings, summary = run_analysis(PORT)
    assert {f.rule for f in findings} == {"autotune-cache-invalid"}
    assert summary["autotune_cache"]["present"] is True
    findings, summary = run_analysis(PORT, kernel_checks=False)
    assert findings == [] and summary["autotune_cache"] is None


# --------------------------------------------------------------------------
# Figure 8 on the CPU, against repro's
# --------------------------------------------------------------------------


def _repro_fig8():
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import fig8_observability
    finally:
        sys.path.remove(str(ROOT))
    return fig8_observability


@pytest.fixture(scope="module")
def fig8_smoke():
    try:
        rows, failures, slates = fig8.run(True, device="cpu")
    finally:
        obs.disable()
    return rows, failures, slates


def test_fig8_smoke_gates_hold(fig8_smoke):
    rows, failures, slates = fig8_smoke
    assert failures == []
    by_name = {name: (us, derived) for name, us, derived in rows}
    assert "rebuilds_after_warmup=0" in by_name["fig8_pump_admit"][1]
    assert by_name["fig8_serial_per_k_misses"][0] >= 1
    assert "schema=ok" in by_name["fig8_trace_export"][1]
    assert len(slates) == 12


def test_fig8_rows_and_slates_match_repros(fig8_smoke):
    """The same seeded requests through repro's router (its jnp core),
    submitted and drained as figure 8 does: slates index for index,
    d_hist within the incremental oracle's tolerance; and repro's
    figure names the same rows."""
    rows, _, slates = fig8_smoke
    theirs = _repro_fig8()
    import repro.obs as jobs
    from repro.serving import (
        DPPRerankConfig,
        Reranker,
        RouterConfig,
    )

    try:
        jrows, jfail = theirs.run(True)
    finally:
        jobs.disable()
    assert jfail == []
    assert [r[0] for r in rows] == [r[0] for r in jrows]

    M, D, shortlist, k_lo, k_hi, slots, chunk, n = 192, 16, 96, 6, 12, 4, \
        4, 12
    rr = Reranker(DPPRerankConfig(slate_size=k_hi, shortlist=shortlist,
                                  alpha=3.0, eps=1e-6, chunk_size=chunk),
                  router_config=RouterConfig(
                      slots=slots, chunk_size=chunk, max_queue=2 * n,
                      max_candidates=shortlist))
    reqs = theirs.make_requests(n, M, D, k_lo, k_hi, seed=3)
    handles = [rr.submit(r) for r in reqs[:slots]]
    rr.router.drain()
    handles += [rr.submit(r) for r in reqs[slots:]]
    rr.router.drain()
    for h, (ti, td) in zip(handles, slates):
        ji, jd = (np.asarray(x) for x in h.result())
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(td, jd, rtol=ORACLE.dh_rtol,
                                   atol=ORACLE.dh_atol)
    # and the port's requests are repro's draws
    port_reqs = fig8.make_requests(n, M, D, k_lo, k_hi, seed=3,
                                   device="cpu")
    for p, j in zip(port_reqs, reqs):
        assert p.slate_size == j.slate_size
        np.testing.assert_array_equal(p.scores.numpy(),
                                      np.asarray(j.scores))
        assert (p.mask is None) == (j.mask is None)
    assert np.array_equal(port_reqs[0].feats.numpy(),
                          np.asarray(reqs[0].feats))


def test_fig8_main_prints_rows_and_leaves_its_session(capsys):
    try:
        fig8.main(fast_mode=True, device="cpu")
        reg = obs.registry()
        assert reg is not None  # figures.run snapshots it
        assert reg.counter("greedy_state_allocs_total").total() >= 1
    finally:
        obs.disable()
    out = capsys.readouterr().out
    assert out.splitlines()[1] == "name,us_per_call,derived"
    assert "fig8_trace_export" in out


def test_fig8_state_allocs_are_no_rebuild():
    """The per-stream state counter stays out of the rebuild ledger, or
    every stream would count as a rebuild in figure 9 and serve_router."""
    from repro_torch.obs.dispatch import REBUILD_COUNTERS

    assert "greedy_state_allocs_total" not in REBUILD_COUNTERS


def test_fig8_parity_gate_reports_a_differing_slate():
    a = (np.array([3, 1, -1], np.int32), np.array([2.0, 1.0, 0.0],
                                                  np.float32))
    assert fig8.slate_parity(a, a, exact=True) is None
    b = (a[0], a[1] + np.float32(1e-7))
    assert "d_hist" in fig8.slate_parity(a, b, exact=True)
    assert fig8.slate_parity(a, b, exact=False) is None
    c = (np.array([3, 2, -1], np.int32), a[1])
    assert "ids" in fig8.slate_parity(a, c, exact=False)
