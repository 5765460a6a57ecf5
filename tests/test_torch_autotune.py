"""The port's measured tile choice (``repro_torch.kernels.dpp_greedy.
autotune``, ``tile_m="auto"``, ``DPP_TILE_M``) against ``repro``'s
autotuner, on the CPU.

Both packages read the same cache documents with ``device_fingerprint``
pinned to one triple, so their ladders can be compared entry for entry:

* ``bucket_m`` bands every ``M`` as ``repro``'s does; ``cache_key`` is
  ``repro``'s for ASCII fields and stays stable under case changes where
  ``repro``'s is not (``'µ'``); past one lane it carries the lanes'
  bucket, and a tile timed at other lanes is never served;
* the lookup ladder gives ``repro``'s tile or miss reason on the same
  document (exact hit, nearest bucket, empty, missing, corrupt, foreign
  schema, no entry for this card, a stale entry), for entries both budget
  models accept; entries the port's shared-memory or co-residency check
  refuses are misses in the port only;
* the precedence ladder (``DPP_TILE_M`` > explicit > ``"auto"`` > model,
  a ``TilePolicy`` object bypassing it) and its counters match
  ``repro``'s (``tests/test_autotune.py``'s cases);
* ``run_sweep`` on the plain versions with an injected timer writes a
  cache that validates, replaces a corrupt one and keeps the fastest
  tile;
* ``tile_m="auto"`` through ``GreedySpec``, ``Reranker.rerank``,
  ``Reranker.stream`` and the router, past the resident gate, gives the
  explicit tile's slates bit for bit and ``repro``'s jnp core's index for
  index (``d_hist`` within the incremental oracle's tolerance); a
  session's chunks equal the explicit tile's; a state's chunks and a
  launcher's launches read no cache file and run the tile its init
  resolved.
"""
import json
import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import make_greedy_inputs
import repro.core as jc
import repro.obs as jobs
import repro.serving as js
from repro.kernels.dpp_greedy import autotune as jat
from repro.kernels.dpp_greedy.ops import (
    _resolve_tile_policy as j_resolve,
)
import repro_torch.core as tc
import repro_torch.serving as ts
from repro_torch import obs
from repro_torch.kernels.dpp_greedy import autotune as tat
from repro_torch.kernels.dpp_greedy import ops as tops
from repro_torch.kernels.dpp_greedy.tiling import (
    DEFAULT_TILE_M,
    SMEM_BUDGET_BYTES,
    TilePolicy,
    chunk_smem_bytes,
    validate_tile_m,
)
from repro_torch.serving import router as router_mod

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

RTOL, ATOL = 3e-4, 1e-5
TRIPLE = ("Test Card 80GB", "cuda", "sm_90a-cuda")


@pytest.fixture
def pinned(monkeypatch):
    """Both packages' ``device_fingerprint`` pinned to :data:`TRIPLE`."""
    monkeypatch.setattr(jat, "device_fingerprint", lambda *a: TRIPLE)
    monkeypatch.setattr(tat, "device_fingerprint", lambda *a: TRIPLE)
    monkeypatch.delenv("DPP_TILE_M", raising=False)


def _doc(path, entries, device=TRIPLE):
    """A cache document written by ``repro``'s ``AutotuneCache``."""
    cache = jat.AutotuneCache(str(path), {})
    for e in entries:
        cache.put(interpret=True, best_us=1.0,
                  candidates={e["tile_m"]: 1.0}, device=device, **e)
    cache.save()
    return cache


def _both_lookup(path, **q):
    """(repro's tile, its miss reasons), (the port's tile, its reasons)
    for one query on the same document."""
    with jobs.session(jobs.ObsConfig(enabled=True)):
        jt = jat.lookup_tile(path=str(path), **q)
        jm = jobs.registry().counter(
            "autotune_cache_misses_total")._snapshot()
    with obs.session(obs.ObsConfig(enabled=True)):
        tt = tat.lookup_tile(path=str(path), **q)
        tm = obs.registry().counter(
            "autotune_cache_misses_total")._snapshot()
    return (jt, jm), (tt, tm)


# ---------------------------------------------------------------------------
# Bucketing and keys
# ---------------------------------------------------------------------------


def test_bucket_m_equals_repros():
    rng = random.Random(0)
    sample = [1, 2, 31, 32, 33, 127, 128, 129, 255, 256, 4095, 4096,
              65536, 65537]
    sample += [rng.randrange(1, 1 << 24) for _ in range(2000)]
    for M in sample:
        assert tat.bucket_m(M) == jat.bucket_m(M), M
    for M in (0, -1):
        with pytest.raises(ValueError, match="M must be"):
            tat.bucket_m(M)


def test_cache_key_equals_repros_on_ascii():
    rng = random.Random(1)
    fields = ["NVIDIA H100 80GB HBM3", " nvidia  h100 ", "TPU v4", "cpu",
              "a|b", "Sm_90A-CUDA", "x  Y\tz"]
    for _ in range(300):
        dk, plat, be = (rng.choice(fields) for _ in range(3))
        geom = (rng.choice((8, 64, 100)), rng.choice((128, 65536)),
                rng.choice((8, 16, 50)), rng.random() < 0.5,
                rng.random() < 0.5)
        assert tat.cache_key(dk, plat, be, *geom) == \
            jat.cache_key(dk, plat, be, *geom)


def _check_case_stable(dk):
    base = tat.cache_key(dk, "cuda", "sm_90a-cuda", 64, 1024, 8, False,
                         False)
    for other in (f"  {dk.upper()}  ", dk.lower(), dk.casefold()):
        assert tat.cache_key(other, "cuda", "sm_90a-cuda", 64, 1024, 8,
                             False, False) == base
    assert base.count("|") == 7


def test_cache_key_carries_the_lanes_bucket_past_one_lane():
    """A one-lane key is repro's; past one lane the key ends in the
    lanes' power-of-two bucket, so 3 and 4 lanes share a key and 1, 4
    and 8 do not."""
    geom = ("NVIDIA H100", "cuda", "sm_90a-cuda", 100, 65536, 50, False,
            False)
    assert [tat.lanes_bucket(n) for n in (1, 2, 3, 4, 5, 32, 33)] == \
        [1, 2, 4, 4, 8, 32, 64]
    with pytest.raises(ValueError, match="lanes must be"):
        tat.lanes_bucket(0)
    assert tat.cache_key(*geom, lanes=1) == tat.cache_key(*geom) == \
        jat.cache_key(*geom)
    assert tat.cache_key(*geom, lanes=3) == tat.cache_key(*geom, lanes=4) \
        == tat.cache_key(*geom) + "|l4"
    assert len({tat.cache_key(*geom, lanes=n) for n in (1, 4, 8)}) == 3


def test_cache_key_is_case_stable_where_repros_is_not():
    # repro's .lower() keeps the micro sign and the upper-case mu apart
    assert jat.cache_key("µ", "c", "c", 8, 128, 8, 0, 0) != \
        jat.cache_key("µ".upper(), "c", "c", 8, 128, 8, 0, 0)
    for dk in ("µ", "ß", "ı", "ΐ", "ﬁ", "Ǆ", "İ", "NVIDIA µArch"):
        _check_case_stable(dk)


if HAVE_HYPOTHESIS:

    @settings(max_examples=300, deadline=None)
    @given(st.text(min_size=1, max_size=20))
    def test_cache_key_case_stable_hypothesis(dk):
        _check_case_stable(dk)


def test_cache_paths_are_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.setenv("DPP_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    assert tat.active_cache_path() == str(tmp_path / "c.json")
    monkeypatch.delenv("DPP_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert tat.active_cache_path() == tat.default_cache_path() == str(
        tmp_path / "xdg" / "repro_torch" / "dpp_autotune.json")
    assert tat.default_cache_path() != jat.default_cache_path()


def test_device_fingerprint_on_the_cpu():
    assert tat.device_fingerprint("cpu") == tat.CPU_FINGERPRINT


# ---------------------------------------------------------------------------
# The lookup ladder against repro's on the same documents
# ---------------------------------------------------------------------------

STEP = dict(D=16, state_rows=8, windowed=False, chunked=False)
CHUNK = dict(D=16, state_rows=8, windowed=True, chunked=True)


def _entries():
    return [dict(M_bucket=4096, tile_m=128, **STEP),
            dict(M_bucket=1024, tile_m=256, **CHUNK),
            dict(M_bucket=65536, tile_m=512, **CHUNK)]


@pytest.mark.parametrize("case,query,tile,reason", [
    ("exact", dict(M=4000, **STEP), 128, None),
    ("exact_chunk", dict(M=40000, **CHUNK), 512, None),
    ("nearest", dict(M=3000, **CHUNK), 256, None),  # 1024 is 2 octaves off
    ("nearest_far", dict(M=300000, **CHUNK), 512, None),
    ("no_entry", dict(M=4000, D=32, state_rows=8, windowed=False,
                      chunked=False), None, "no_entry"),
    ("other_card", dict(M=4000, **STEP), None, "no_entry"),
    ("empty", dict(M=4000, **STEP), None, "empty"),
    ("missing", dict(M=4000, **STEP), None, "empty"),
    ("corrupt", dict(M=4000, **STEP), None, "corrupt"),
    ("foreign_schema", dict(M=4000, **STEP), None, "corrupt"),
    ("stale", dict(M=4000, **STEP), None, "no_entry"),
])
def test_lookup_ladder_equals_repros(pinned, tmp_path, case, query, tile,
                                     reason):
    path = tmp_path / "cache.json"
    if case == "other_card":
        _doc(path, _entries(), device=("another card", "cuda", "x"))
    elif case == "empty":
        _doc(path, [])
    elif case == "corrupt":
        path.write_text("{not json", encoding="utf-8")
    elif case == "foreign_schema":
        path.write_text(json.dumps({"schema": 99, "entries": {}}))
    elif case == "stale":  # a hand-edited tile neither model accepts
        cache = _doc(path, _entries()[:1])
        next(iter(cache.entries.values()))["tile_m"] = 100
        cache.save()
    elif case != "missing":
        _doc(path, _entries())
    (jt, jm), (tt, tm) = _both_lookup(path, **query)
    assert jt == tt == tile
    want = {} if reason is None else {f"reason={reason}": 1.0}
    assert jm == tm == want


def test_lookup_refuses_what_the_port_model_refuses(pinned, tmp_path,
                                                   monkeypatch):
    """Entries repro's VMEM model accepts but the port's shared memory or
    co-residency does not: a miss in the port, never a bad launch."""
    monkeypatch.setattr(tat, "STAMP_TTL_S", 0.0)  # repro rewrites the file
    path = tmp_path / "cache.json"
    # a windowed chunk block of 8192 columns holds 8192 gains and 8 ring
    # rows: past one block's 227 KB
    assert chunk_smem_bytes(16, 8192, 8, True) > SMEM_BUDGET_BYTES
    _doc(path, [dict(M_bucket=65536, tile_m=8192, **CHUNK),
                dict(M_bucket=65536, tile_m=96, **STEP)])
    (jt, _), (tt, tm) = _both_lookup(path, M=65536, **CHUNK)
    assert jt == 8192 and tt is None and tm == {"reason=no_entry": 1.0}
    # a warp multiple that is no 128-lane multiple: the port's only
    (jt, jm), (tt, _) = _both_lookup(path, M=65536, **STEP)
    assert jt is None and tt == 96
    # co-residency at the queried lanes, within one lanes bucket: 3
    # lanes x 16 tiles of 4096 fit a card that keeps 56 such blocks, 4
    # lanes do not
    cache = tat.AutotuneCache(str(path), {})
    cache.put(M_bucket=65536, tile_m=4096, best_us=1.0, candidates={},
              plain=False, lanes=4, device=TRIPLE, **CHUNK)
    cache.save()
    q = dict(M=65536, path=str(path), **CHUNK)
    assert tat.lookup_tile(lanes=3, capacity=lambda smem: 56, **q) == 4096
    assert tat.lookup_tile(lanes=4, capacity=lambda smem: 56, **q) is None


def test_lookup_never_returns_what_the_model_refuses(pinned, tmp_path):
    rng = random.Random(2)
    path = tmp_path / "cache.json"
    cache = tat.AutotuneCache(str(path), {})
    for _ in range(40):
        cache.put(D=rng.choice((8, 64, 256)), M_bucket=1 << rng.randrange(7, 18),
                  state_rows=rng.choice((8, 16, 128)),
                  windowed=rng.random() < 0.5, chunked=rng.random() < 0.5,
                  tile_m=rng.choice((100, 96, 128, 4096, 65536, 1 << 17)),
                  best_us=1.0, candidates={}, plain=True, device=TRIPLE)
    cache.save()
    for _ in range(200):
        D, R = rng.choice((8, 64, 256)), rng.choice((8, 16, 128))
        M, w, c = rng.randrange(1, 1 << 18), rng.random() < 0.5, \
            rng.random() < 0.5
        lanes, cap = rng.choice((1, 4)), rng.choice((None, 132, 1056))
        capacity = None if cap is None else (lambda smem, n=cap: n)
        tm = tat.lookup_tile(D=D, M=M, state_rows=R, windowed=w, chunked=c,
                             lanes=lanes, capacity=capacity, path=str(path))
        if tm is not None:
            assert tat.tile_fits(tm, D, M, R, w, c, lanes, capacity)


def test_lookup_serves_a_tile_only_to_its_lanes_bucket(pinned, tmp_path):
    """An entry timed at 4 lanes answers 3 and 4 lanes, exactly or from
    the nearest M-bucket, and is a miss at 1 or 8; a sweep of the same
    shape at another lane count is an entry of its own."""
    path = str(tmp_path / "cache.json")
    cache = tat.AutotuneCache(path, {})
    cache.put(M_bucket=65536, tile_m=512, best_us=1.0, candidates={},
              plain=False, lanes=4, device=TRIPLE, **STEP)
    cache.save()
    q = dict(M=65536, path=path, **STEP)
    with obs.session(obs.ObsConfig(enabled=True)):
        reg = obs.registry()
        assert tat.lookup_tile(lanes=4, **q) == 512
        assert tat.lookup_tile(lanes=3, **q) == 512
        assert tat.lookup_tile(**dict(q, M=200000), lanes=4) == 512
        assert tat.lookup_tile(lanes=1, **q) is None
        assert tat.lookup_tile(lanes=8, **q) is None
        assert reg.counter("autotune_cache_hits_total")._snapshot() == \
            {"kind=exact": 2, "kind=bucket": 1}
        assert reg.counter("autotune_cache_misses_total")._snapshot() == \
            {"reason=no_entry": 2}
    cache.put(M_bucket=65536, tile_m=256, best_us=1.0, candidates={},
              plain=False, lanes=1, device=TRIPLE, **STEP)
    cache.save()
    assert tat.lookup_tile(lanes=1, **q) == 256
    assert tat.lookup_tile(lanes=4, **q) == 512
    doc = json.loads(open(path, encoding="utf-8").read())
    assert sorted(e["lanes"] for e in doc["entries"].values()) == [1, 4]


def test_dpp_greedy_looks_the_tile_up_at_its_batch(pinned, tmp_path,
                                                   monkeypatch):
    """``dpp_greedy`` asks the cache at its own lanes: a tile timed at 2
    lanes serves a batch of 2, and one request takes the model's tile."""
    path = str(tmp_path / "cache.json")
    cache = tat.AutotuneCache(path, {})
    cache.put(D=8, M_bucket=65536, state_rows=4, windowed=False,
              chunked=False, tile_m=4096, best_us=1.0, candidates={},
              plain=True, lanes=2, device=TRIPLE)
    cache.save()
    monkeypatch.setenv("DPP_AUTOTUNE_CACHE", path)
    V = torch.from_numpy(np.array(make_greedy_inputs(4, 2, 8, 60000)))
    for B, tile, hits in ((2, 4096, 1), (1, DEFAULT_TILE_M, 0)):
        with obs.session(obs.ObsConfig(enabled=True)):
            reg = obs.registry()
            got = tops.dpp_greedy(V[:B], 4, eps=1e-6, tile_m="auto")
            assert reg.gauge("dpp_tile_m").value() == tile
            assert reg.counter("autotune_cache_hits_total").total() == hits
        want = tops.dpp_greedy(V[:B], 4, eps=1e-6, tile_m=tile)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# TilePolicy's "auto" rung
# ---------------------------------------------------------------------------


def test_decide_auto_prefers_cache_then_model(pinned, tmp_path, monkeypatch):
    """Past the resident gate a cached tile wins over the model's; with
    the cache gone the model's answer stands; resident while it fits."""
    path = tmp_path / "cache.json"
    _doc(path, [dict(M_bucket=65536, tile_m=256, **STEP),
                dict(M_bucket=65536, tile_m=2048, **CHUNK)])
    monkeypatch.setenv("DPP_AUTOTUNE_CACHE", str(path))
    auto, model = TilePolicy(tile_m="auto"), TilePolicy()
    assert auto.decide(16, 60000, 8, False) == ("tiled", 256)
    assert model.decide(16, 60000, 8, False) == ("tiled", 1024)
    assert auto.decide(16, 60000, 8, True, chunked=True) == \
        TilePolicy(tile_m=2048).decide(16, 60000, 8, True, chunked=True)
    assert auto.decide(16, 4000, 8, False) == ("resident", None)
    assert auto.decide(16, 2000, 8, True, chunked=True) == \
        model.decide(16, 2000, 8, True, chunked=True)  # one whole-M tile
    monkeypatch.setenv("DPP_AUTOTUNE_CACHE", str(tmp_path / "absent.json"))
    for chunked in (False, True):
        assert auto.decide(16, 60000, 8, chunked, chunked=chunked) == \
            model.decide(16, 60000, 8, chunked, chunked=chunked)


def test_decide_auto_records_telemetry(pinned, tmp_path, monkeypatch):
    path = tmp_path / "cache.json"
    _doc(path, [dict(M_bucket=65536, tile_m=256, **STEP)])
    monkeypatch.setenv("DPP_AUTOTUNE_CACHE", str(path))
    policy = TilePolicy(tile_m="auto")
    with obs.session(obs.ObsConfig(enabled=True)):
        reg = obs.registry()
        policy.decide(16, 60000, 8, False)  # exact hit
        policy.decide(16, 200000, 8, False)  # bucket 262144 -> nearest
        monkeypatch.setenv("DPP_AUTOTUNE_CACHE",
                           str(tmp_path / "absent.json"))
        policy.decide(16, 60000, 8, False)  # miss -> model
        hits = reg.counter("autotune_cache_hits_total")
        misses = reg.counter("autotune_cache_misses_total")
        assert hits.value(kind="exact") == 1
        assert hits.value(kind="bucket") == 1
        assert misses.value(reason="empty") == 1
        assert reg.gauge("autotune_tile_m").value() == 256


def test_stream_tile_follows_a_rewritten_cache(pinned, tmp_path,
                                               monkeypatch):
    """A memoised "auto" answer does not outlive a rewrite of the file: a
    save in this process is seen at once, another writer's once the
    stamp's time to live has passed; within it the file is not read."""
    path = tmp_path / "cache.json"
    monkeypatch.setenv("DPP_AUTOTUNE_CACHE", str(path))
    clock = [1000.0]
    monkeypatch.setattr(tat, "_clock", lambda: clock[0])
    cpu = torch.device("cpu")
    args = (16, 60000, 8, True, "auto", 1, cpu)
    model = tops._stream_tile(16, 60000, 8, True, None, 1, cpu)
    assert tops._stream_tile(*args) == model
    cache = tat.AutotuneCache(str(path), {})  # this process's writer
    cache.put(D=16, M_bucket=65536, state_rows=8, windowed=True,
              chunked=True, tile_m=2048, best_us=1.0, candidates={},
              plain=True, device=TRIPLE)
    cache.save()
    assert tops._stream_tile(*args)[0] == 2048
    _doc(path, [dict(M_bucket=65536, tile_m=4096, **CHUNK)])  # another
    assert tops._stream_tile(*args)[0] == 2048
    clock[0] += tat.STAMP_TTL_S
    assert tops._stream_tile(*args)[0] == 4096


# ---------------------------------------------------------------------------
# tile_m precedence (env > explicit > auto > model; policy bypasses)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env,tile_m,want", [
    ("256", 384, 256), ("256", "auto", 256), ("256", None, 256),
    ("auto", None, "auto"), ("auto", 384, "auto"), ("AUTO", 256, "auto"),
    (None, 384, 384), (None, "auto", "auto"), (None, None, None),
])
def test_precedence_equals_repros(monkeypatch, env, tile_m, want):
    if env is None:
        monkeypatch.delenv("DPP_TILE_M", raising=False)
    else:
        monkeypatch.setenv("DPP_TILE_M", env)
    with jobs.session(jobs.ObsConfig(enabled=True)):
        jt = j_resolve(tile_m, None).tile_m
        jsrc = jobs.registry().counter("dpp_tile_source_total")._snapshot()
        jover = jobs.registry().counter(
            "dpp_tile_override_total")._snapshot()
    with obs.session(obs.ObsConfig(enabled=True)):
        tt = tops._resolve_tile_policy(tile_m, None).tile_m
        tsrc = obs.registry().counter("dpp_tile_source_total")._snapshot()
        tover = obs.registry().counter("dpp_tile_override_total")._snapshot()
    assert jt == tt == want
    assert jsrc == tsrc and jover == tover


def test_precedence_policy_object_bypasses_env(monkeypatch):
    monkeypatch.setenv("DPP_TILE_M", "256")
    policy = TilePolicy(tile_m=384)
    assert tops._resolve_tile_policy(None, policy) is policy
    with pytest.raises(ValueError, match="at most one"):
        tops._resolve_tile_policy(128, TilePolicy())


@pytest.mark.parametrize("raw,match", [("fast", "DPP_TILE_M"),
                                       ("100", "tile_m"), ("0", "tile_m")])
def test_env_garbage_fails_loudly(monkeypatch, raw, match):
    monkeypatch.setenv("DPP_TILE_M", raw)
    with pytest.raises(ValueError, match=match):
        tops._resolve_tile_policy(None, None)
    with pytest.raises(ValueError, match=match):
        j_resolve(None, None)


def test_validate_tile_m_auto_gating():
    validate_tile_m("auto", allow_auto=True)
    with pytest.raises(ValueError, match="single-device kernel dispatch"):
        validate_tile_m("auto")
    for bad in ("fast", 100, True, 0, -32):
        with pytest.raises(ValueError, match="tile_m"):
            validate_tile_m(bad, allow_auto=True)
    validate_tile_m(96)  # a warp multiple the TPU's 128 lanes refuse


def test_env_override_on_the_dispatch(monkeypatch):
    """``DPP_TILE_M=256`` forces the tiled kernels as ``tile_m=256`` does
    and records that it shadowed a call-site tile."""
    monkeypatch.delenv("DPP_TILE_M", raising=False)
    V = torch.from_numpy(np.array(make_greedy_inputs(0, 2, 8, 600)))
    want = tops.dpp_greedy(V, 6, tile_m=256)
    monkeypatch.setenv("DPP_TILE_M", "256")
    with obs.session(obs.ObsConfig(enabled=True)):
        reg = obs.registry()
        got = tops.dpp_greedy(V, 6, tile_m=128)
        assert reg.counter("dpp_tile_override_total").value(
            winner="env", lost="explicit") == 1
        assert reg.counter("dpp_kernel_dispatch_total").value(
            mode="tiled", windowed="False") == 1
        assert reg.gauge("dpp_tile_m").value() == 256
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# The sweep, on the plain versions with an injected timer
# ---------------------------------------------------------------------------


def _timer(times):
    it = iter(times)

    def timer(prepare):
        prepare()()
        return next(it)
    return timer


@pytest.mark.parametrize("family", tat.FAMILIES)
def test_run_sweep_keeps_the_fastest_tile(tmp_path, family):
    path = str(tmp_path / "cache.json")
    case = tat.SweepCase(family, D=8, M=300, state_rows=4, chunk=2)
    tiles = tat.candidate_tiles(8, 4, case.windowed, case.chunked,
                                tat.bucket_m(300))
    assert tiles == sorted(set(tiles)) and len(tiles) >= 3
    times = [3.0 + i for i in range(len(tiles))]
    times[1] = 1.0  # the second candidate is the fastest
    results, out = tat.run_sweep([case], trials=1, path=path, device="cpu",
                                 timer=_timer(times))
    r = results[0]
    assert out == path and r["tile_m"] == tiles[1]
    assert r["candidates"] == {t: s * 1e6 for t, s in zip(tiles, times)}
    doc = json.loads(open(path, encoding="utf-8").read())
    (entry,) = doc["entries"].values()
    assert doc["schema"] == tat.SCHEMA_VERSION and entry["plain"] is True
    assert entry["tile_m"] == tiles[1] and len(entry["candidates"]) == \
        len(tiles)
    # the winner round-trips through the ladder, and repro reads the file
    q = dict(D=8, M=300, state_rows=4, windowed=case.windowed,
             chunked=case.chunked, path=path)
    assert tat.lookup_tile(**q) == tiles[1]
    assert jat.AutotuneCache.load(path).entries == doc["entries"]


@pytest.mark.parametrize("gain,keeps_model", [(0.02, True), (0.2, False)])
def test_run_sweep_keeps_the_models_tile_within_the_margin(
        tmp_path, gain, keeps_model):
    """A candidate faster than the model's own tile by less than the
    timing noise (``MODEL_MARGIN``) does not replace it."""
    case = tat.SweepCase("chunk_exact", D=8, M=300, state_rows=4, chunk=2)
    tiles = tat.candidate_tiles(8, 4, False, True, tat.bucket_m(300))
    own = tat.model_tile(8, tat.bucket_m(300), 4, False, True)
    assert own in tiles and own != tiles[0]
    times = [1.0] * len(tiles)  # the model's own tile among them
    times[0] = 1.0 - gain
    results, _ = tat.run_sweep([case], trials=1, device="cpu",
                               path=str(tmp_path / "c.json"),
                               timer=_timer(times))
    assert results[0]["tile_m"] == (own if keeps_model else tiles[0])


def test_run_sweep_replaces_corrupt_cache_and_merges(tmp_path):
    path = tmp_path / "cache.json"
    path.write_text("{not json", encoding="utf-8")
    cases = [tat.SweepCase("step_exact", D=8, M=300, state_rows=4)]
    results, _ = tat.run_sweep(cases, trials=1, limit=1, path=str(path),
                               device="cpu")
    doc = json.loads(path.read_text(encoding="utf-8"))
    assert len(results) == 1 and len(doc["entries"]) == 1
    cases.append(tat.SweepCase("chunk_exact", D=8, M=300, state_rows=4))
    tat.run_sweep(cases, trials=1, limit=1, path=str(path), device="cpu")
    assert len(json.loads(path.read_text())["entries"]) == 2


def test_candidates_include_the_models_own_tile():
    """Past the resident gate the model's tile (per step
    ``DEFAULT_TILE_M``; for the chunk kernels the V-resident split) is
    always measured, and every candidate fits the model."""
    for fam in tat.FAMILIES:
        c = tat.SweepCase(fam, D=64, M=65536, state_rows=8)
        tiles = tat.candidate_tiles(64, 8, c.windowed, c.chunked, 65536,
                                    lanes=4, capacity=lambda smem: 528,
                                    limit=3)
        own = tat.model_tile(64, 65536, 8, c.windowed, c.chunked, 4,
                             lambda smem: 528)
        assert own in tiles and len(tiles) <= 4
        for t in tiles:
            assert tat.tile_fits(t, 64, 65536, 8, c.windowed, c.chunked, 4,
                                 lambda smem: 528)
    with pytest.raises(ValueError, match="unknown family"):
        tat.SweepCase("warp_drive", D=16, M=256, state_rows=8)


# ---------------------------------------------------------------------------
# tile_m="auto" end to end, past the resident gate, against repro
# ---------------------------------------------------------------------------

D_, M_, K_, W_, KW_ = 8, 60000, 5, 3, 8
TILE = 4096


@pytest.fixture
def tuned(pinned, tmp_path, monkeypatch):
    """A cache holding TILE for every family at (D_, 65536-bucket) and
    this test's rows, timed at one lane (written by repro) and at 2 and 4
    lanes (by the port), and an obs session to count its hits."""
    path = tmp_path / "cache.json"
    entries = []
    for R in (K_, W_):
        for w in (False, True):
            for c in (False, True):
                entries.append(dict(D=D_, M_bucket=65536, state_rows=R,
                                    windowed=w, chunked=c, tile_m=TILE))
    _doc(path, entries)
    cache = tat.AutotuneCache.load(str(path))
    for lanes in (2, 4):
        for e in entries:
            cache.put(best_us=1.0, candidates={}, plain=True, lanes=lanes,
                      device=TRIPLE, **e)
    cache.save()
    monkeypatch.setenv("DPP_AUTOTUNE_CACHE", str(path))
    with obs.session(obs.ObsConfig(enabled=True)):
        yield obs.registry()


def _V(seed=0, B=2):
    return np.array(make_greedy_inputs(seed, B, D_, M_))


def _jcore(V, k, window):
    res = jc.greedy_map(jc.GreedySpec(k=k, window=window, backend="jnp",
                                      eps=1e-6), V=jnp.asarray(V))
    return np.asarray(res.indices), np.asarray(res.d_hist)


def _hits(reg):
    return reg.counter("autotune_cache_hits_total").total()


@pytest.mark.parametrize("window,chunk", [(None, None), (W_, None),
                                          (None, 2), (W_, 3)])
def test_greedy_spec_auto_equals_explicit_and_repro(tuned, window, chunk):
    k = K_ if window is None else KW_
    V = _V()
    runs = {}
    for tile in ("auto", TILE):
        h0 = _hits(tuned)
        res = tc.greedy_map(tc.GreedySpec(
            k=k, window=window, backend="kernel", eps=1e-6, tile_m=tile,
            chunk_size=chunk), V=torch.from_numpy(V))
        runs[tile] = (res.indices, res.d_hist, _hits(tuned) - h0)
    (a_sel, a_dh, a_hits), (e_sel, e_dh, _) = runs["auto"], runs[TILE]
    assert a_hits >= 1  # the auto run took the cache's tile
    assert torch.equal(a_sel, e_sel) and torch.equal(a_dh, e_dh)
    j_sel, j_dh = _jcore(V, k, window)
    np.testing.assert_array_equal(a_sel.numpy(), j_sel)
    np.testing.assert_allclose(a_dh.numpy(), j_dh, rtol=RTOL, atol=ATOL)


def _request(seed, B=None):
    rng = np.random.default_rng(seed)
    shape = (M_,) if B is None else (B, M_)
    feats = rng.normal(size=(M_, D_)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    return rng.uniform(size=shape).astype(np.float32), feats


@pytest.mark.parametrize("window", [None, W_])
def test_rerank_and_stream_auto_equal_explicit_and_repro(tuned, window):
    k = K_ if window is None else KW_
    base = dict(slate_size=k, shortlist=M_, alpha=3.0, eps=1e-6,
                window=window)
    scores, feats = _request(1, B=2)
    outs = {}
    for tile in ("auto", TILE):
        rr = ts.Reranker(ts.DPPRerankConfig(use_kernel=True, tile_m=tile,
                                            **base), device="cpu")
        outs[tile] = rr.rerank(ts.RerankRequest(scores=scores, feats=feats))
        chunks = list(rr.stream(ts.RerankRequest(scores=scores[0],
                                                 feats=feats), chunk_size=2))
        outs[tile, "stream"] = (torch.cat([c for c, _ in chunks]),
                                torch.cat([d for _, d in chunks]))
    assert _hits(tuned) >= 2
    for key in (("auto", TILE), (("auto", "stream"), (TILE, "stream"))):
        a, e = outs[key[0]], outs[key[1]]
        assert torch.equal(torch.as_tensor(a[0]), torch.as_tensor(e[0]))
        assert torch.equal(torch.as_tensor(a[1]), torch.as_tensor(e[1]))
    j_sel, j_dh = js.Reranker(js.DPPRerankConfig(**base)).rerank(
        js.RerankRequest(scores=jnp.asarray(scores),
                         feats=jnp.asarray(feats)))
    np.testing.assert_array_equal(np.asarray(outs["auto"][0]),
                                  np.asarray(j_sel))
    np.testing.assert_allclose(np.asarray(outs["auto"][1]),
                               np.asarray(j_dh), rtol=RTOL, atol=ATOL)
    s_sel = np.asarray(outs["auto", "stream"][0])
    np.testing.assert_array_equal(s_sel, np.asarray(j_sel)[0])


def test_router_auto_equals_explicit_and_repro(tuned):
    base = dict(slate_size=K_, shortlist=M_, alpha=3.0, eps=1e-6)
    reqs = [_request(10 + i) for i in range(3)]
    got = {}
    for tile in ("auto", TILE):
        rr = ts.Reranker(ts.DPPRerankConfig(use_kernel=True, tile_m=tile,
                                            **base),
                         router_config=ts.RouterConfig(
                             slots=2, chunk_size=2, max_candidates=M_),
                         device="cpu")
        hs = [rr.submit(ts.RerankRequest(scores=s, feats=f))
              for s, f in reqs]
        rr.router.drain()
        got[tile] = [h.slate() for h in hs]
    for (a_sel, a_dh), (e_sel, e_dh) in zip(got["auto"], got[TILE]):
        np.testing.assert_array_equal(a_sel, e_sel)
        np.testing.assert_array_equal(a_dh, e_dh)
    for (s, f), (a_sel, a_dh) in zip(reqs, got["auto"]):
        j_sel, j_dh = js.Reranker(js.DPPRerankConfig(**base)).rerank(
            js.RerankRequest(scores=jnp.asarray(s), feats=jnp.asarray(f)))
        np.testing.assert_array_equal(a_sel, np.asarray(j_sel))
        np.testing.assert_allclose(a_dh, np.asarray(j_dh), rtol=RTOL,
                                   atol=ATOL)


def test_check_slots_resolves_auto_once(tuned):
    """The router's co-residency check takes the cache's tile for its
    slots in one lookup, and refuses what that tile cannot hold."""
    h0 = _hits(tuned)
    router_mod.check_slots(4, D_, M_, K_, False, "auto",
                           lambda smem: 4 * -(-M_ // TILE))
    assert _hits(tuned) - h0 == 1
    with pytest.raises(ValueError, match="largest slots that fits is 3"):
        router_mod.check_slots(4, D_, M_, K_, False, TILE,
                               lambda smem: 3 * -(-M_ // TILE))


def test_chunks_and_launches_read_no_cache_stamp(tuned, monkeypatch):
    """Under "auto" a state's init looks the tile up; its chunks and its
    launchers reuse that answer, and the cache file is stat'ed at most
    once within its stamp's time to live (a syscall a dispatch is what
    made "auto" slower than the model's own tile on the card)."""
    import os

    V = torch.from_numpy(_V(3, B=2))
    stats = []
    real = os.stat

    def counting(path, *a, **k):  # os.stat is global: count the cache's
        if str(path) == tat.active_cache_path():
            stats.append(path)
        return real(path, *a, **k)

    monkeypatch.setattr(tat.os, "stat", counting)
    monkeypatch.setattr(tat, "_clock", lambda: 1000.0)  # within the TTL
    h0 = _hits(tuned)
    state = tops.dpp_greedy_stream_init(V, K_, tile_m="auto")
    assert len(stats) == 1 and _hits(tuned) - h0 == 1
    for _ in range(2):
        state, _, _ = tops.dpp_greedy_stream_chunk(V, state, 2, eps=1e-6,
                                                   tile_m="auto")
    assert len(stats) == 1
    one = tops.dpp_greedy_stream_init(V[:1], K_, tile_m="auto")
    launch = tops.dpp_greedy_stream_launcher(V[:1], one, 1, eps=1e-6,
                                             tile_m="auto")
    for _ in range(2):
        launch()
        one.t.add_(1)
    assert len(stats) == 1 and _hits(tuned) - h0 == 2


def test_a_chunk_runs_its_own_states_tile(tuned, monkeypatch):
    """Two states of one shape, the cache rewritten between their inits:
    each state's chunks and launcher run the tile its own init resolved,
    not the last answer for the shape."""
    path = tat.active_cache_path()
    cache = tat.AutotuneCache.load(path)
    V = torch.from_numpy(_V(5, B=2))
    first = tops.dpp_greedy_stream_init(V, K_, tile_m="auto")
    for key, e in list(cache.entries.items()):
        if e.get("lanes", 1) == 2:
            cache.entries[key] = dict(e, tile_m=TILE // 2)
    cache.save()
    second = tops.dpp_greedy_stream_init(V, K_, tile_m="auto")
    seen = []
    real = tops.fused_chunk_exact

    def spy(*args):
        seen.append(args[-2])  # the tile
        return real(*args)

    monkeypatch.setattr(tops, "fused_chunk_exact", spy)
    for state in (first, second):
        tops.dpp_greedy_stream_chunk(V, state, 1, eps=1e-6, tile_m="auto")
    assert seen == [TILE, TILE // 2]
    tiles = []
    monkeypatch.setattr(tops, "chunk_launcher",
                        lambda *args: tiles.append(args[-2]))
    for state in (first, second):  # a launcher counts lanes in place
        state = state._replace(t=torch.zeros(2, dtype=torch.int32))
        tops.dpp_greedy_stream_launcher(V, state, 1, eps=1e-6,
                                        tile_m="auto")
    assert tiles == [TILE, TILE // 2]


def test_session_auto_equals_explicit(tuned):
    """A session's chunks under "auto" (its launcher built once on the
    cache's tile) equal the explicit tile's bit for bit."""
    scores, feats = _request(20)
    got = {}
    for tile in ("auto", TILE):
        rr = ts.Reranker(ts.DPPRerankConfig(
            slate_size=KW_, shortlist=M_, alpha=3.0, eps=1e-6, window=W_,
            use_kernel=True, tile_m=tile), device="cpu")
        h0 = _hits(tuned)
        sess = rr.session(ts.RerankRequest(scores=scores, feats=feats))
        got[tile] = [sess.next_chunk(3) for _ in range(3)]
        if tile == "auto":
            assert _hits(tuned) - h0 >= 1
    for (a_ids, a_dh), (e_ids, e_dh) in zip(got["auto"], got[TILE]):
        np.testing.assert_array_equal(a_ids, e_ids)
        np.testing.assert_array_equal(a_dh, e_dh)
