"""The port's candidate-sharded rerank against ``repro``'s sharded path, on
the CPU.

The same seeded numpy inputs (``tests/conftest.py::make_greedy_inputs``
and numpy draws) go through ``repro.core.sharded`` / ``repro``'s
``Reranker`` with ``cfg.mesh`` (a ``shard_map`` over a ``("data",)`` JAX
mesh, its jnp step) and through ``repro_torch.core.sharded`` /
``repro_torch``'s ``Reranker`` with ``cfg.mesh`` (ranks of a gloo
``torch.distributed`` group; on CPU shards the update step is the plain
version of the shard-local update entry of K3/K4).  Slates must be equal
index for index, ``d_hist`` within ``GreedyOracle``'s incremental
tolerance (rtol 3e-4 / atol 1e-5).

* One rank, in this process (a gloo group of one, made by a fixture and
  destroyed after the module): ``repro``'s one-device cases of
  ``tests/test_sharded.py``: spec and config validation, exact and
  windowed against ``repro`` on a 1-device mesh and against its jnp
  core and the shared oracle, batched ``V``, shared and per-user masks,
  ``sharded_topk``, the rerank (masked-score poison, inf relevance
  outside the shortlist, eps-stop); the mesh refusals of ``session`` (as
  ``repro``'s), the session store, slot splicing and widening and the
  column deltas.
* The sharded stream on that rank, against ``repro``'s sharded stream
  (``tests/test_streaming.py``'s sharded cases): ``greedy_map_chunks``
  concatenates to the port's whole sharded slate bit for bit, ``d_hist``
  included (window None, 3, 1 x chunk 1, 4, 16), equals ``repro``'s
  stream id for id and the shared oracle; the eps-stop latches across
  chunks; a batched ``V`` with per-user masks; ``Reranker.stream`` on a
  mesh against ``Reranker.rerank`` on it and ``repro``'s stream; one
  update launcher a stream.
* P = 2, 3 and 4 ranks (P = 3 pads M): each P runs once, as gloo ranks in
  subprocesses, beside one JAX subprocess that runs ``repro``'s sharded
  path on 2-, 3- and 4-device host meshes (``XLA_FLAGS`` set before jax
  is imported, as ``tests/test_sharded.py`` does); parametrised tests
  then hold each case.  Exact ties across a shard boundary go to the
  lowest global id, and the cross-shard argmax is checked on crafted
  gains that are all non-negative and that straddle zero (a signed MAX
  all-reduce of the packed argmax keys would pick a negative gain).  The
  ranks also stream each case (``greedy_map_chunks``, ``Reranker.stream``
  of one request): every rank's chunks equal its whole slate bit for bit
  and ``repro``'s sharded stream at the same P.
  The ranks also run the continuous-batching router on the mesh
  (``repro``'s ``test_router_multidevice_sharded_parity`` mix and a
  windowed twin), against ``repro``'s router on the same meshes.
* The plain update entries against ``repro``'s ``tiled_update_exact`` /
  ``tiled_update_windowed`` in interpret mode, with a non-zero ``base``,
  one lane and four lanes at their own step counters.
* The router on a mesh in process: the slot executors on a mesh, a lane
  admitted in place equal to a fresh state bit for bit, a lane admitted
  again after a request with larger gains (stale keys), the one-rank
  router against ``repro``'s on a 1-device mesh; two gloo ranks whose
  clocks disagree return the same handles (deadlines decided on rank 0).
* ``launch.serve_sharded`` with two gloo ranks on the CPU, whole,
  ``--stream`` and ``--router``.
"""
import concurrent.futures
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from conftest import (
    _ORACLES,
    assert_greedy_parity,
    make_greedy_inputs,
    serve_rerank,
    serve_rerank_stream,
)
import repro.core as jcore
import repro.serving as js
from repro.distributed.context import make_mesh_compat
from repro.kernels.dpp_greedy import tiled as jtiled
import repro_torch.core as tcore
import repro_torch.serving as ts
from repro_torch.distributed import init_group, make_mesh, spawn_ranks
from repro_torch.distributed import rank_env
from repro_torch.kernels.dpp_greedy import tiled as ttiled
from repro_torch.launch import serve_sharded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = _ORACLES["incremental"]()
RTOL, ATOL = ORACLE.dh_rtol, ORACLE.dh_atol


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A gloo group of one rank in this process and its CPU mesh."""
    import torch.distributed as dist

    init_group("gloo", 0, 1, tmp_path_factory.mktemp("rdv") / "file",
               timeout_s=60)
    yield make_mesh(device="cpu")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def jmesh():
    return make_mesh_compat((1,), ("data",))


def _problem(seed, M=120, D=24):
    return make_greedy_inputs(seed, None, D, M, alpha=None)


# ---------------------------------------------------------------------------
# Validation and refusals
# ---------------------------------------------------------------------------


def test_spec_validation(mesh):
    with pytest.raises(tcore.GreedySpecError, match="mesh"):
        tcore.GreedySpec(k=5, backend="sharded")
    with pytest.raises(tcore.GreedySpecError, match="mesh"):
        tcore.GreedySpec(k=5, backend="kernel", mesh=mesh)
    with pytest.raises(tcore.GreedySpecError, match="silently ignored"):
        tcore.GreedySpec(k=5, backend="torch", mesh=mesh)
    assert tcore.GreedySpec(k=5, backend="sharded", mesh=mesh,
                            chunk_size=2).chunk_size == 2
    assert tcore.GreedySpec(k=5, mesh=mesh, chunk_size=2).sharded()
    with pytest.raises(tcore.GreedySpecError, match="silently ignored"):
        tcore.GreedySpec(k=5, chunk_size=2)  # torch: no chunked execution
    assert tcore.GreedySpec(k=5, mesh=mesh).sharded()  # auto + mesh
    assert not tcore.GreedySpec(k=5).sharded()
    tcore.GreedySpec(k=5, backend="sharded", mesh=mesh, tile_m=64)
    with pytest.raises(tcore.GreedySpecError, match="tile_m"):
        tcore.GreedySpec(k=5, tile_m=64)


def test_rerank_config_validation(mesh):
    with pytest.raises(ValueError, match="mutually exclusive"):
        ts.DPPRerankConfig(use_kernel=True, mesh=mesh)
    spec = ts.DPPRerankConfig(mesh=mesh, chunk_size=4).greedy_spec()
    assert spec.sharded() and spec.chunk_size == 4
    spec = ts.DPPRerankConfig(slate_size=4, mesh=mesh, tile_m=64).greedy_spec()
    assert spec.backend == "sharded" and spec.mesh is mesh
    assert spec.tile_m == 64 and spec.axis_name == "data"
    with pytest.raises(ValueError, match="tile_m"):
        ts.DPPRerankConfig(tile_m=64)


def _small_request(seed=5, M=64, D=6):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(M, D)).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    return ts.RerankRequest(scores=rng.uniform(size=M).astype(np.float32),
                            feats=f)


# repro refuses sessions over a sharded pool (src/repro/serving/session.py,
# _check_session_cfg); the router serves a mesh (the router tests below)
REFUSALS = {"session": "as in repro"}


@pytest.mark.parametrize("verb", ["session"])
def test_mesh_refuses_stream_submit_session(mesh, verb):
    cfg = ts.DPPRerankConfig(slate_size=8, shortlist=32, window=4,
                             mesh=mesh)
    rr = ts.Reranker(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=REFUSALS[verb]):
        getattr(rr, verb)(_small_request())


def test_session_store_refuses_a_mesh(mesh):
    cfg = ts.DPPRerankConfig(slate_size=8, shortlist=32, window=4,
                             mesh=mesh)
    with pytest.raises(NotImplementedError, match="as in repro"):
        ts.SessionStore(cfg, ts.SessionConfig(), torch.device("cpu"))


def test_reranker_refuses_a_mesh_on_another_device(mesh):
    cfg = ts.DPPRerankConfig(slate_size=8, shortlist=32, mesh=mesh)
    mesh_meta = make_mesh(device="cpu")
    mesh_meta.device = torch.device("meta")
    with pytest.raises(ValueError, match="shards on"):
        ts.Reranker(ts.DPPRerankConfig(slate_size=8, mesh=mesh_meta),
                    device="cpu")
    ts.Reranker(cfg, device="cpu")


def test_sharded_rejects_dense_and_bad_rank(mesh):
    spec = tcore.GreedySpec(k=4, backend="sharded", mesh=mesh)
    with pytest.raises(ValueError, match="low-rank V"):
        tcore.greedy_map(spec, L=torch.eye(8))
    with pytest.raises(ValueError, match="ndim"):
        tcore.dpp_greedy_sharded(torch.ones(2, 2, 4, 16), 2, mesh=mesh)
    with pytest.raises(ValueError, match="mesh has no axis"):
        tcore.dpp_greedy_sharded(torch.ones(4, 16), 2, mesh=mesh,
                                 axis_name="model")
    with pytest.raises(ValueError, match="k must be"):
        tcore.dpp_greedy_sharded(torch.ones(4, 16), 0, mesh=mesh)


# ---------------------------------------------------------------------------
# One rank, in process, against repro on a 1-device mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_matches_repro_one_device(mesh, jmesh, seed):
    V = _problem(seed)
    want = jcore.dpp_greedy_sharded(V, 10, mesh=jmesh, eps=1e-6)
    core = jcore.dpp_greedy_lowrank(V, 10, eps=1e-6)
    got = tcore.dpp_greedy_sharded(_t(V), 10, mesh=mesh, eps=1e-6)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(core.indices))
    _close(got.d_hist, want.d_hist)
    assert int(got.n_selected) == int(want.n_selected)


@pytest.mark.parametrize("window", [None, 5])
def test_sharded_matches_shared_oracle(mesh, greedy_oracle, window):
    V = _problem(7)
    rng = np.random.default_rng(7)
    mask = rng.uniform(size=V.shape[1]) > 0.25
    got = tcore.dpp_greedy_sharded(_t(V), 10, mesh=mesh, window=window,
                                   eps=1e-6, mask=_t(mask))
    assert_greedy_parity(greedy_oracle, got.indices.numpy(),
                         got.d_hist.numpy(), V, 10, window=window, eps=1e-6,
                         mask=jnp.asarray(mask))


def test_sharded_windowed_matches_repro(mesh, jmesh):
    V = _problem(3)
    want = jcore.dpp_greedy_sharded(V, 24, mesh=jmesh, window=5, eps=1e-6)
    got = tcore.dpp_greedy_sharded(_t(V), 24, mesh=mesh, window=5, eps=1e-6)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    _close(got.d_hist, want.d_hist)


def test_sharded_mask_and_dispatch(mesh):
    V = _problem(4)
    rng = np.random.default_rng(4)
    mask = rng.uniform(size=V.shape[1]) > 0.4
    want = jcore.dpp_greedy_lowrank(V, 8, eps=1e-6, mask=jnp.asarray(mask))
    for backend in ("sharded", "auto"):
        got = tcore.greedy_map(
            tcore.GreedySpec(k=8, backend=backend, mesh=mesh, eps=1e-6),
            V=_t(V), mask=_t(mask))
        np.testing.assert_array_equal(got.indices.numpy(),
                                      np.asarray(want.indices))
        assert all(mask[i] for i in got.indices.tolist() if i >= 0)


@pytest.mark.parametrize("window", [None, 3])
def test_sharded_batched_matches_repro(mesh, jmesh, window):
    rng = np.random.default_rng(21)
    B, D, M, k = 4, 12, 90, 8
    V = (rng.normal(size=(B, D, M)) / np.sqrt(D)).astype(np.float32)
    mask = rng.uniform(size=(B, M)) > 0.3
    want = jcore.dpp_greedy_sharded(jnp.asarray(V), k, mesh=jmesh,
                                    window=window, eps=1e-6,
                                    mask=jnp.asarray(mask))
    got = tcore.greedy_map(
        tcore.GreedySpec(k=k, window=window, backend="sharded", mesh=mesh,
                         eps=1e-6), V=_t(V), mask=_t(mask))
    assert got.indices.shape == (B, k)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.n_selected.numpy(),
                                  np.asarray(want.n_selected))
    _close(got.d_hist, want.d_hist)


def test_shared_mask_batched_V(mesh):
    rng = np.random.default_rng(31)
    B, D, M, k = 3, 10, 72, 6
    V = (rng.normal(size=(B, D, M)) / np.sqrt(D)).astype(np.float32)
    mask = rng.uniform(size=M) > 0.4
    got = tcore.greedy_map(tcore.GreedySpec(k=k, mesh=mesh, eps=1e-6),
                           V=_t(V), mask=_t(mask))
    want = jcore.greedy_map(jcore.GreedySpec(k=k, backend="jnp", eps=1e-6),
                            V=jnp.asarray(V),
                            mask=jnp.broadcast_to(jnp.asarray(mask), (B, M)))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert all(mask[i] for i in got.indices.flatten().tolist() if i >= 0)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("c", [13, 97, 500])
def test_sharded_topk_one_device(mesh, jmesh, batched, c):
    rng = np.random.default_rng(7)
    s = rng.uniform(size=(3, 97) if batched else 97).astype(np.float32)
    s[..., 40] = s[..., 3]  # an exact tie: the lower index first
    v1, i1 = jax.lax.top_k(jnp.asarray(s), min(c, 97))
    v2, i2 = tcore.sharded_topk(_t(s), c, mesh=mesh)
    v3, i3 = jcore.sharded_topk(jnp.asarray(s), c, mesh=jmesh)
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i1))
    np.testing.assert_array_equal(v2.numpy(), np.asarray(v1))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i3))


def _port_rerank(scores, feats, cfg, mask=None):
    return ts.Reranker(cfg, device="cpu").rerank(
        ts.RerankRequest(scores=scores, feats=feats, mask=mask))


def _cfgs(mesh, jmesh, **kw):
    return (js.DPPRerankConfig(mesh=jmesh, **kw),
            ts.DPPRerankConfig(mesh=mesh, **kw))


@pytest.mark.parametrize("window", [None, 4])
def test_sharded_rerank_matches_repro_one_device(mesh, jmesh, window):
    rng = np.random.default_rng(9)
    M, D = 300, 16
    scores = rng.uniform(size=M).astype(np.float32)
    feats = rng.normal(size=(M, D)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    kw = dict(slate_size=10, shortlist=128, alpha=3.0, eps=1e-6,
              window=window)
    jcfg, tcfg = _cfgs(mesh, jmesh, **kw)
    want, wdh = serve_rerank(jnp.asarray(scores), jnp.asarray(feats), jcfg)
    dense, _ = serve_rerank(jnp.asarray(scores), jnp.asarray(feats),
                            js.DPPRerankConfig(**kw))
    got, gdh = _port_rerank(scores, feats, tcfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(dense))
    _close(gdh, wdh)


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("per_user_feats", [False, True])
def test_rerank_batch_sharded_matches_repro(mesh, jmesh, window,
                                            per_user_feats):
    rng = np.random.default_rng(23)
    B, M, D = 4, 121, 8
    scores = rng.uniform(size=(B, M)).astype(np.float32)
    feats = rng.normal(size=(B, M, D) if per_user_feats else (M, D))
    feats = (feats / np.linalg.norm(feats, axis=-1, keepdims=True)).astype(
        np.float32)
    mask = rng.uniform(size=(B, M)) > 0.25
    kw = dict(slate_size=6, shortlist=64, alpha=3.0, eps=1e-6, window=window)
    jcfg, tcfg = _cfgs(mesh, jmesh, **kw)
    want, wdh = serve_rerank(jnp.asarray(scores), jnp.asarray(feats), jcfg,
                             mask=jnp.asarray(mask))
    got, gdh = _port_rerank(scores, feats, tcfg, mask)
    assert got.shape == (B, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(gdh, wdh)


def test_rerank_batch_sharded_eps_stop(mesh, jmesh):
    rng = np.random.default_rng(24)
    B, M, D = 4, 80, 3
    scores = rng.uniform(size=(B, M)).astype(np.float32)
    feats = rng.normal(size=(B, M, D)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    kw = dict(slate_size=10, shortlist=64, alpha=2.0, eps=1e-2)
    jcfg, tcfg = _cfgs(mesh, jmesh, **kw)
    want, _ = serve_rerank(jnp.asarray(scores), jnp.asarray(feats), jcfg)
    got, _ = _port_rerank(scores, feats, tcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == -1).any()  # the stop fired


@pytest.mark.parametrize("poison", [float("nan"), float("-inf")])
def test_sharded_rerank_masked_score_poison(mesh, jmesh, poison):
    rng = np.random.default_rng(32)
    M, D = 150, 8
    scores = rng.uniform(size=M).astype(np.float32)
    feats = rng.normal(size=(M, D)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    mask = np.ones(M, bool)
    mask[7] = False
    clean = scores.copy()
    scores[7] = poison
    kw = dict(slate_size=8, shortlist=64, alpha=3.0, eps=1e-6)
    jcfg, tcfg = _cfgs(mesh, jmesh, **kw)
    got, dh = _port_rerank(scores, feats, tcfg, mask)
    assert (got.numpy() >= 0).sum() == 8 and 7 not in got.tolist()
    assert torch.isfinite(dh).all()
    ref, _ = _port_rerank(clean, feats, tcfg, mask)
    want, _ = serve_rerank(jnp.asarray(scores), jnp.asarray(feats), jcfg,
                           mask=jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sharded_rerank_inf_relevance_outside_shortlist(mesh, jmesh):
    rng = np.random.default_rng(33)
    M, D = 200, 8
    scores = rng.uniform(size=M).astype(np.float32)
    scores[11] = -130.0  # 0.5 ** -130 overflows float32: inf relevance
    feats = rng.normal(size=(M, D)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    kw = dict(slate_size=8, shortlist=64, alpha=0.5, eps=1e-6)
    jcfg, tcfg = _cfgs(mesh, jmesh, **kw)
    want, _ = serve_rerank(jnp.asarray(scores), jnp.asarray(feats), jcfg)
    got, dh = _port_rerank(scores, feats, tcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.isfinite(dh).all() and 11 not in got.tolist()


# ---------------------------------------------------------------------------
# The sharded stream, one rank in process, against repro's on a 1-device
# mesh (tests/test_streaming.py's sharded cases)
# ---------------------------------------------------------------------------


def _stream(spec, V, mask=None, chunk=None):
    """The port's ``greedy_map_chunks``: (ids, d_hist) concatenated along
    the slate, and the chunks' widths."""
    chunks = list(tcore.greedy_map_chunks(spec, V=V, mask=mask,
                                          chunk_size=chunk))
    return (torch.cat([c.indices for c in chunks], -1),
            torch.cat([c.d_hist for c in chunks], -1),
            [c.indices.shape[-1] for c in chunks])


def _jstream(spec, V, mask=None, chunk=None):
    chunks = list(jcore.greedy_map_chunks(spec, V=V, mask=mask,
                                          chunk_size=chunk))
    return (np.concatenate([np.asarray(c.indices) for c in chunks], -1),
            np.concatenate([np.asarray(c.d_hist) for c in chunks], -1))


def _specs(mesh, jmesh, k, window, chunk, eps=1e-6):
    return (tcore.GreedySpec(k=k, window=window, backend="sharded",
                             mesh=mesh, eps=eps, chunk_size=chunk),
            jcore.GreedySpec(k=k, window=window, backend="sharded",
                             mesh=jmesh, eps=eps, chunk_size=chunk))


def _equal_bits(got, want):
    """Two (ids, d_hist) pairs of the port, equal bit for bit."""
    assert torch.equal(got[0], want[0]), (got[0], want[0])
    assert torch.equal(got[1], want[1]), (got[1], want[1])


@pytest.mark.parametrize("window", [None, 3, 1])
@pytest.mark.parametrize("chunk", [1, 4, 16])
def test_stream_chunks_concatenate_to_whole(mesh, jmesh, window, chunk):
    D, M, k = 16, 137, 10
    V = make_greedy_inputs(11 + (window or 0), None, D, M)
    mask = np.random.default_rng(5).uniform(size=M) > 0.3
    spec, jspec = _specs(mesh, jmesh, k, window, chunk)
    whole = tcore.greedy_map(
        tcore.GreedySpec(k=k, window=window, mesh=mesh, eps=1e-6),
        V=_t(V), mask=_t(mask))
    sel, dh, sizes = _stream(spec, _t(V), _t(mask))
    assert sum(sizes) == k and max(sizes) <= chunk  # ragged tail covered
    _equal_bits((sel, dh), (whole.indices, whole.d_hist))
    # chunked whole-slate execution returns the same bits
    chunked = tcore.greedy_map(spec, V=_t(V), mask=_t(mask))
    _equal_bits((chunked.indices, chunked.d_hist), (sel, dh))
    want = _jstream(jspec, V, jnp.asarray(mask))
    np.testing.assert_array_equal(sel.numpy(), want[0])
    _close(dh, want[1])


@pytest.mark.parametrize("window", [None, 3])
def test_streamed_slate_matches_shared_oracle(mesh, greedy_oracle, window):
    D, M, k, chunk = 16, 90, 8, 3
    V = make_greedy_inputs(23, None, D, M)
    mask = np.random.default_rng(6).uniform(size=M) > 0.25
    spec = tcore.GreedySpec(k=k, window=window, mesh=mesh, eps=1e-6,
                            chunk_size=chunk)
    sel, dh, _ = _stream(spec, _t(V), _t(mask))
    assert_greedy_parity(greedy_oracle, sel.numpy(), dh.numpy(), V, k,
                         window=window, mask=jnp.asarray(mask))


def test_stream_eps_stop_latches_across_chunks(mesh, jmesh):
    D, M, k, chunk = 5, 160, 12, 4
    V = make_greedy_inputs(31, None, D, M)
    spec, jspec = _specs(mesh, jmesh, k, None, chunk, eps=1e-3)
    whole = tcore.dpp_greedy_sharded(_t(V), k, mesh=mesh, eps=1e-3)
    sel, dh, _ = _stream(spec, _t(V))
    _equal_bits((sel, dh), (whole.indices, whole.d_hist))
    assert (sel == -1).any(), "eps-stop never fired: the case is vacuous"
    want = _jstream(jspec, V)
    np.testing.assert_array_equal(sel.numpy(), want[0])
    _close(dh, want[1])


@pytest.mark.parametrize("window", [None, 3])
def test_stream_batched_per_user_masks(mesh, jmesh, window):
    B, D, M, k, chunk = 3, 10, 140, 8, 3
    V = make_greedy_inputs(47, B, D, M)
    mask = np.random.default_rng(8).uniform(size=(B, M)) > 0.3
    spec, jspec = _specs(mesh, jmesh, k, window, chunk)
    whole = tcore.dpp_greedy_sharded(_t(V), k, mesh=mesh, window=window,
                                     eps=1e-6, mask=_t(mask))
    sel, dh, _ = _stream(spec, _t(V), _t(mask))
    assert sel.shape == (B, k)
    _equal_bits((sel, dh), (whole.indices, whole.d_hist))
    want = _jstream(jspec, V, jnp.asarray(mask))
    np.testing.assert_array_equal(sel.numpy(), want[0])
    _close(dh, want[1])
    assert all(mask[b, i] for b in range(B) for i in sel[b].tolist()
               if i >= 0)


def test_stream_steps_and_mixed_chunks(mesh):
    """The raw init/step/chunk API on a mesh: single steps between chunks
    resume where the state left off, given the state's shard or the
    request's V."""
    V = _t(make_greedy_inputs(41, None, 12, 100))
    spec = tcore.GreedySpec(k=9, window=4, mesh=mesh, eps=1e-6)
    whole = tcore.greedy_map(spec, V=V)
    state = tcore.greedy_init(spec, V=V)
    assert isinstance(state, tcore.ShardedState)
    state, i0, d0 = tcore.greedy_step(spec, state, V=V)
    state, s1, d1 = tcore.greedy_chunk(spec, state, V=V, chunk_size=5)
    Vl = tcore.slot_pad_v(spec, V, state)
    assert Vl is state.Vl and Vl.shape == (1, 12, 100)
    state, s2, d2 = tcore.greedy_chunk(spec, state, V=Vl, chunk_size=3)
    assert state.t == 9 and i0.ndim == 0 and s1.shape == (5,)
    _equal_bits((torch.cat([i0[None], s1, s2]), torch.cat([d0[None], d1,
                                                           d2])),
                (whole.indices, whole.d_hist))
    with pytest.raises(ValueError, match="passes the state's k=9"):
        tcore.greedy_chunk(spec, state, V=Vl, chunk_size=1)
    with pytest.raises(ValueError, match="neither the state's shard"):
        tcore.greedy_chunk(spec, tcore.greedy_init(spec, V=V), V=V[:, :50],
                           chunk_size=1)


@pytest.mark.parametrize("window", [None, 4])
def test_reranker_stream_on_a_mesh_matches_rerank_and_repro(mesh, jmesh,
                                                            window):
    rng = np.random.default_rng(17)
    M, D, N, chunk = 300, 16, 10, 4
    scores = rng.uniform(size=M).astype(np.float32)
    feats = rng.normal(size=(M, D)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    mask = rng.uniform(size=M) > 0.25
    kw = dict(slate_size=N, shortlist=64, alpha=3.0, eps=1e-6,
              window=window, chunk_size=chunk)
    jcfg, tcfg = _cfgs(mesh, jmesh, **kw)
    rr = ts.Reranker(tcfg, device="cpu")
    req = ts.RerankRequest(scores=scores, feats=feats, mask=mask)
    chunks = list(rr.stream(req))
    assert [c.shape[0] for c, _ in chunks] == [4, 4, 2]
    assert all(c.dtype == torch.int32 for c, _ in chunks)
    sel = torch.cat([c for c, _ in chunks])
    dh = torch.cat([d for _, d in chunks])
    _equal_bits((sel, dh), rr.rerank(req))
    jchunks = list(serve_rerank_stream(jnp.asarray(scores),
                                       jnp.asarray(feats), jcfg,
                                       mask=jnp.asarray(mask)))
    np.testing.assert_array_equal(
        sel.numpy(), np.concatenate([np.asarray(c) for c, _ in jchunks]))
    _close(dh, np.concatenate([np.asarray(d) for _, d in jchunks]))
    assert all(mask[i] for i in sel.tolist())


def test_reranker_stream_on_a_mesh_ends_at_the_eps_stop(mesh, jmesh):
    rng = np.random.default_rng(24)
    M, D = 80, 3
    scores = rng.uniform(size=M).astype(np.float32)
    feats = rng.normal(size=(M, D)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    kw = dict(slate_size=12, shortlist=64, alpha=2.0, eps=1e-2,
              chunk_size=2)
    jcfg, tcfg = _cfgs(mesh, jmesh, **kw)
    req = ts.RerankRequest(scores=scores, feats=feats)
    rr = ts.Reranker(tcfg, device="cpu")
    whole, _ = rr.rerank(req)
    stop = int((whole >= 0).sum())
    assert stop < 12  # the stop fires
    sel = torch.cat([c for c, _ in rr.stream(req)])
    # the stream ends with the chunk whose last slot is -1
    assert sel.numel() == min(12, (stop // 2 + 1) * 2)
    assert torch.equal(sel, whole[:sel.numel()])
    want = np.concatenate([np.asarray(c) for c, _ in serve_rerank_stream(
        jnp.asarray(scores), jnp.asarray(feats), jcfg)])
    np.testing.assert_array_equal(sel.numpy(), want)


def test_reranker_stream_on_a_mesh_refuses_a_batch(mesh):
    rng = np.random.default_rng(3)
    cfg = ts.DPPRerankConfig(slate_size=4, shortlist=16, mesh=mesh,
                             chunk_size=2)
    with pytest.raises(ValueError, match="single request"):
        ts.Reranker(cfg, device="cpu").stream(ts.RerankRequest(
            scores=rng.uniform(size=(2, 40)).astype(np.float32),
            feats=rng.normal(size=(40, 4)).astype(np.float32)))


@pytest.mark.parametrize("window", [None, 3])
def test_stream_prepares_one_launcher_per_state(mesh, monkeypatch, window):
    """A stream of n chunks prepares the update entry's launcher once,
    with its state, and launches it once a step."""
    built, steps = [], []
    real = ttiled.update_launcher

    def counted(*args):
        step = real(*args)
        built.append(args[0][0].shape)
        t = args[0][-1]  # the lanes' step counters, advanced in place

        def counted_step():
            steps.append(t.tolist())
            return step()
        return counted_step

    monkeypatch.setattr(ttiled, "update_launcher", counted)
    V = _t(make_greedy_inputs(5, 2, 12, 96))
    spec = tcore.GreedySpec(k=11, window=window, mesh=mesh, eps=1e-6,
                            chunk_size=3)
    chunks = list(tcore.greedy_map_chunks(spec, V=V))
    assert len(chunks) == 4 and built == [(2, 12, 96)]
    assert steps == [[t, t] for t in range(11)]


SLOT_CALLS = {
    "state_splice": lambda spec, st, V: tcore.state_splice(st, st, 0),
    "slot_state_widen": lambda spec, st, V: tcore.slot_state_widen(
        spec, st, 200),
}


@pytest.mark.parametrize("call", sorted(SLOT_CALLS))
def test_slot_executors_refuse_a_mesh(mesh, call):
    """Splicing and widening stay refused on a mesh: a sharded lane is
    built at the bucket width and admitted in place."""
    V = _t(make_greedy_inputs(5, 2, 12, 96))
    spec = tcore.GreedySpec(k=6, window=3, mesh=mesh, eps=1e-6)
    state = tcore.greedy_init(spec, V=V)
    with pytest.raises(NotImplementedError, match="admitted in place"):
        SLOT_CALLS[call](spec, state, V)


@pytest.mark.parametrize("op", ["greedy_state_extend",
                                "greedy_state_rescore"])
def test_column_deltas_refuse_a_sharded_state(mesh, op):
    V = _t(make_greedy_inputs(5, None, 12, 96))
    spec = tcore.GreedySpec(k=6, window=3, mesh=mesh, eps=1e-6)
    state = tcore.greedy_init(spec, V=V)
    with pytest.raises(NotImplementedError, match="as in repro"):
        getattr(tcore, op)(spec, state, V, 0, V[:, :4])


# ---------------------------------------------------------------------------
# The plain update entries against repro's, interpret mode
# ---------------------------------------------------------------------------


def _entry_operands(seed, D=16, M=256, rows=6, t=3):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    V = (rng.normal(size=(D, M)) / np.sqrt(D)).astype(f32)
    C = (0.1 * rng.normal(size=(rows, M))).astype(f32)
    C[t:] = 0.0
    d2 = (1.0 + rng.uniform(size=M)).astype(f32)
    d2[rng.uniform(size=M) < 0.1] = -np.inf
    vj = (rng.normal(size=D) / np.sqrt(D)).astype(f32)
    cj = (0.1 * rng.normal(size=rows)).astype(f32)
    return V, C, d2, vj, cj


@pytest.mark.parametrize("stopped", [False, True])
@pytest.mark.parametrize("owner", [True, False])
def test_plain_update_exact_matches_repro(owner, stopped):
    base, t, tile = 1024, 3, 128
    V, C, d2, vj, cj = _entry_operands(1)
    cj[t:] = 0.0
    dj, j = np.float32(0.7), base + 9 if owner else base - 5
    e, d2j = jtiled.tiled_update_exact(
        jnp.asarray(V), jnp.asarray(C), jnp.asarray(d2), jnp.asarray(vj),
        jnp.asarray(cj), jnp.float32(dj), jnp.asarray(stopped),
        jnp.int32(j), jnp.int32(base), tile_m=tile, interpret=True)
    Ct, d2t = _t(C)[None].clone(), _t(d2)[None].clone()
    keys = torch.zeros((2, 1), dtype=torch.int64)
    keys[t & 1] = 1  # the row step t read: the entry zeroes it
    ttiled.tiled_update_exact(
        _t(V)[None], Ct, d2t, _t(vj)[None], _t(cj)[None],
        torch.tensor([dj]), torch.tensor([stopped]),
        torch.tensor([j], dtype=torch.int32),
        torch.tensor([t], dtype=torch.int32), base, keys, tile)
    # repro returns the appended row (zero when stopped); the port writes
    # it in place and leaves a stopped lane's row as it was
    _close(Ct[0, t], np.zeros_like(e) if stopped else e)
    _close(d2t[0], d2j)
    assert (d2t[0, 9].item() == float("-inf")) == (owner and not stopped)
    assert int(keys[t & 1]) == 0
    val, idx = ttiled.unpack_key(keys[(t + 1) & 1])
    ref = np.asarray(d2j)
    assert int(idx) == base + int(np.argmax(ref))
    _close(val, ref.max())


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("owner", [True, False])
def test_plain_update_windowed_matches_repro(owner, full):
    base, w, tile = 2048, 5, 128
    t = 7 if full else 2
    V, C, d2, vj, cj = _entry_operands(2, rows=w, t=w if full else t)
    Cw = (0.1 * np.random.default_rng(3).normal(size=(w, w))).astype(
        np.float32)
    dj2 = np.float32(0.9)
    cos, sin, cjp, d2j = jtiled.eviction_coeffs(
        jnp.asarray(Cw), jnp.asarray(cj), dj2, jnp.asarray(full), w)
    djp = jnp.sqrt(jnp.maximum(d2j, 1e-12))
    pos = min(t, w - 1)
    j = base + 17 if owner else base + 10_000
    Cj, d2o = jtiled.tiled_update_windowed(
        jnp.asarray(V), jnp.asarray(C), jnp.asarray(d2), jnp.asarray(vj),
        cjp, djp, jnp.asarray(False), jnp.asarray(full), cos, sin,
        jnp.int32(j), jnp.int32(base), jnp.int32(pos), w=w, tile_m=tile,
        interpret=True)
    tcos, tsin, tcjp, td2j = ttiled.eviction_coeffs(
        _t(Cw)[None], _t(cj)[None], torch.tensor([dj2]),
        torch.tensor([full]), w)
    _close(tcos, np.asarray(cos)[None])
    _close(tcjp, np.asarray(cjp)[None])
    Ct, d2t = _t(C)[None].clone(), _t(d2)[None].clone()
    keys = torch.zeros((2, 1), dtype=torch.int64)
    ttiled.tiled_update_windowed(
        _t(V)[None], Ct, d2t, _t(vj)[None], tcjp, torch.sqrt(
            torch.clamp_min(td2j, 1e-12)), torch.tensor([False]),
        torch.tensor([full]), tcos, tsin,
        torch.tensor([j], dtype=torch.int32),
        torch.tensor([t], dtype=torch.int32), base, keys, tile)
    _close(Ct[0], Cj)
    _close(d2t[0], d2o)
    assert (d2t[0, 17].item() == float("-inf")) == owner
    val, idx = ttiled.unpack_key(keys[(t + 1) & 1])
    assert int(idx) == base + int(np.argmax(np.asarray(d2o)))


@pytest.mark.parametrize("windowed", [False, True])
def test_plain_update_entries_per_lane_t_match_repro(windowed):
    """Four lanes at different depths in one call of the plain entry, one
    of them stopped: each live lane equals ``repro``'s entry run on that
    lane alone at its own ``t`` (interpret mode, non-zero ``base``), the
    stopped lane and, exact, the lane whose counter reached ``k`` keep
    their state; each lane's key lands in its row ``(t + 1) & 1`` and its
    row ``t & 1`` is zeroed."""
    base, tile, D, M, rows = 1024, 128, 16, 256, 6
    ts_ = [0, 3, 9, 5] if windowed else [0, 3, 6, 4]
    stopped = [False, False, False, True]
    if not windowed:
        ts_[2] = rows  # reached the state's k rows: latched
    lanes = [_entry_operands(10 + b, rows=rows, t=min(t, rows))
             for b, t in enumerate(ts_)]
    V, C, d2, vj, cj = (np.stack(x) for x in zip(*lanes))
    rng = np.random.default_rng(5)
    j = np.array([base + 9, base - 5, base + 30, base + 11], np.int32)
    dj2 = (0.5 + rng.uniform(size=4)).astype(np.float32)
    keys = torch.ones((2, 4), dtype=torch.int64)
    Ct, d2t = _t(C).clone(), _t(d2).clone()
    tt = torch.tensor(ts_, dtype=torch.int32)
    if windowed:
        Cw = (0.1 * rng.normal(size=(4, rows, rows))).astype(np.float32)
        full = np.array([t >= rows for t in ts_]) & ~np.array(stopped)
        cos, sin, cjp, d2j = ttiled.eviction_coeffs(
            _t(Cw), _t(cj), _t(dj2), torch.from_numpy(full), rows)
        djp = torch.sqrt(torch.clamp_min(d2j, 1e-12))
        ttiled.tiled_update_windowed_plain(
            _t(V), Ct, d2t, _t(vj), cjp, djp, torch.tensor(stopped),
            torch.from_numpy(full), cos, sin, _t(j), tt, base, keys, tile)
    else:
        dj = np.sqrt(dj2)
        ttiled.tiled_update_exact_plain(
            _t(V), Ct, d2t, _t(vj), _t(cj), _t(dj), torch.tensor(stopped),
            _t(j), tt, base, keys, tile)
    for b, t in enumerate(ts_):
        assert int(keys[t & 1, b]) == 0
        live = not stopped[b] and (windowed or t < rows)
        if not live:
            assert torch.equal(Ct[b], _t(C[b])) and torch.equal(d2t[b],
                                                                _t(d2[b]))
            continue
        if windowed:
            want_C, want_d2 = jtiled.tiled_update_windowed(
                jnp.asarray(V[b]), jnp.asarray(C[b]), jnp.asarray(d2[b]),
                jnp.asarray(vj[b]), jnp.asarray(cjp[b].numpy()),
                jnp.float32(djp[b]), jnp.asarray(False),
                jnp.asarray(full[b]), jnp.asarray(cos[b].numpy()),
                jnp.asarray(sin[b].numpy()), jnp.int32(j[b]),
                jnp.int32(base), jnp.int32(min(t, rows - 1)), w=rows,
                tile_m=tile, interpret=True)
        else:
            cjb = cj[b].copy()
            cjb[t:] = 0.0
            e, want_d2 = jtiled.tiled_update_exact(
                jnp.asarray(V[b]), jnp.asarray(C[b]), jnp.asarray(d2[b]),
                jnp.asarray(vj[b]), jnp.asarray(cjb), jnp.float32(dj[b]),
                jnp.asarray(False), jnp.int32(j[b]), jnp.int32(base),
                tile_m=tile, interpret=True)
            want_C = np.asarray(C[b]).copy()
            want_C[t] = np.asarray(e)
        _close(Ct[b], want_C)
        _close(d2t[b], want_d2)
        val, idx = ttiled.unpack_key(keys[(t + 1) & 1, b])
        assert int(idx) == base + int(np.argmax(np.asarray(want_d2)))


# ---------------------------------------------------------------------------
# The router on a mesh: slot states, lanes, and the router against repro's
# ---------------------------------------------------------------------------


def _bucket(V, mask, M):
    """A request ``V (D, m)`` and its mask padded to a bucket of M
    columns (mask False): what a one-rank mesh's lane holds."""
    D, m = V.shape
    Vp = torch.zeros((D, M))
    Vp[:, :m] = V
    mp = torch.zeros((M,), dtype=torch.bool)
    mp[:m] = True if mask is None else mask
    return Vp, mp


def _lane_leaves(state, lane):
    out = [state.Vl[lane], state.d2[lane], state.C[lane], state.keys[:, lane],
           state.t[lane], state.stopped[lane]]
    return out + ([] if state.win is None else [state.win[lane]])


def _slot_spec(mesh, window, k=9):
    return tcore.GreedySpec(k=k, window=window, mesh=mesh, eps=1e-6)


ACCEPT_CALLS = {
    "greedy_slot_state": lambda spec, st, V, m: tcore.greedy_slot_state(
        spec, V, m),
    "greedy_slots_init": lambda spec, st, V, m: tcore.greedy_slots_init(
        spec, 3, 12, 96, device="cpu")[0],
    "state_admit": lambda spec, st, V, m: tcore.state_admit(spec, st, 1, V,
                                                            m),
    "state_evict": lambda spec, st, V, m: tcore.state_evict(st, 1),
    "greedy_chunk_slots": lambda spec, st, V, m: tcore.greedy_chunk_slots(
        spec, st, st.Vl, 2)[1],
    "greedy_chunk_launcher": lambda spec, st, V, m: (
        tcore.greedy_chunk_launcher(spec, st, V=st.Vl, chunk_size=2)()[0]),
}


@pytest.mark.parametrize("call", sorted(ACCEPT_CALLS))
def test_slot_executors_accept_a_mesh(mesh, call):
    """The slot executors run on a mesh: a slot state of parked lanes, a
    lane admitted and evicted in place, chunks of every lane (-1 where
    parked)."""
    spec = _slot_spec(mesh, 3)
    state, Vs = tcore.greedy_slots_init(spec, 3, 12, 96, device="cpu")
    assert isinstance(state, tcore.ShardedState) and Vs is state.Vl
    assert state.stopped.all() and state.slots and Vs.shape == (3, 12, 96)
    V, m = _bucket(_t(make_greedy_inputs(5, None, 12, 80)), None, 96)
    out = ACCEPT_CALLS[call](spec, state, V, m)
    if call == "greedy_slot_state":
        assert isinstance(out, tcore.ShardedState) and out.single
    elif call == "greedy_slots_init":
        assert out.Vl.shape == (3, 12, 96) and out.stopped.all()
    elif call == "state_admit":
        assert out is state and not bool(state.stopped[1])
        assert torch.equal(state.Vl[1], V) and int(state.t[1]) == 0
    elif call == "state_evict":
        assert out is state and bool(state.stopped[1])
        assert torch.equal(state.keys[:, 1], torch.zeros(2, dtype=torch.int64))
    else:
        assert out.shape == (3, 2) and (out == -1).all()  # every lane parked


@pytest.mark.parametrize("window", [None, 3])
def test_sharded_lane_equals_fresh_state(mesh, window):
    """A lane admitted in place holds the bits of a fresh single-request
    sharded state of its request at the same bucket, and steps as it
    does while its neighbour sits at another depth."""
    M, k = 96, 9
    spec = _slot_spec(mesh, window, k)
    V0, m0 = _bucket(_t(make_greedy_inputs(6, None, 12, 96)), None, M)
    mask = torch.from_numpy(np.random.default_rng(2).uniform(size=70) > 0.3)
    V1, m1 = _bucket(_t(make_greedy_inputs(7, None, 12, 70)), mask, M)
    state, Vs = tcore.greedy_slots_init(spec, 2, 12, M, device="cpu")
    tcore.state_admit(spec, state, 0, V0, m0)
    tcore.greedy_chunk_slots(spec, state, Vs, 3)  # lane 0 at t = 3
    tcore.state_admit(spec, state, 1, V1, m1)
    fresh = tcore.greedy_slot_state(spec, V1, m1)
    for got, want in zip(_lane_leaves(state, 1), _lane_leaves(fresh, 0)):
        assert torch.equal(got, want)
    assert state.t.tolist() == [3, 0]
    for n in (4, 2):
        _, sel, dh = tcore.greedy_chunk_slots(spec, state, Vs, n)
        _, fsel, fdh = tcore.greedy_chunk(spec, fresh, V=fresh.Vl,
                                          chunk_size=n)
        assert torch.equal(sel[1], fsel) and torch.equal(dh[1], fdh)
    for got, want in zip(_lane_leaves(state, 1), _lane_leaves(fresh, 0)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("window", [None, 3])
def test_sharded_evict_admit_lower_gains(mesh, jmesh, window):
    """A lane evicted mid-slate and admitted again with a request whose
    gains all lie below its previous occupant's: the new request's slate
    is its own (a key of the old request left in the lane would win
    every fold, as the kernel's atomicMax and the plain version's
    unsigned max both keep the larger key), equal to a fresh state's bit
    for bit and to ``repro``'s sharded slate id for id."""
    M, k = 96, 8
    spec = _slot_spec(mesh, window, k)
    big = 10.0 * _t(make_greedy_inputs(8, None, 12, M))
    small = 0.1 * _t(make_greedy_inputs(9, None, 12, 60))
    assert float((small ** 2).sum(0).max()) < float((big ** 2).sum(0).min())
    state, Vs = tcore.greedy_slots_init(spec, 2, 12, M, device="cpu")
    tcore.state_admit(spec, state, 0, *_bucket(big, None, M))
    tcore.state_admit(spec, state, 1, *_bucket(big, None, M))
    for n in (3, 2):  # lane 0 left at t = 5 with the big request's keys
        tcore.greedy_chunk_slots(spec, state, Vs, n)
    tcore.state_evict(state, 0)
    Vp, mp = _bucket(small, None, M)
    tcore.state_admit(spec, state, 0, Vp, mp)
    sel = [tcore.greedy_chunk_slots(spec, state, Vs, n)[1:] for n in (4, 4)]
    got_i = torch.cat([s[0][0] for s in sel])
    got_d = torch.cat([s[1][0] for s in sel])
    fresh = tcore.greedy_map(spec, V=Vp, mask=mp)
    assert torch.equal(got_i, fresh.indices) and torch.equal(got_d,
                                                             fresh.d_hist)
    assert bool((got_i < 60).all())
    want = jcore.dpp_greedy_sharded(jnp.asarray(small.numpy()), k,
                                    mesh=jmesh, window=window, eps=1e-6)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want.indices))
    _close(got_d, want.d_hist)


@pytest.mark.parametrize("window", [None, 3])
def test_sharded_slot_counters_stop_at_k(mesh, window):
    """A slot state's counters stop at ``k``: a lane run a chunk past
    its capacity and a lane parked all along both sit at ``t = k``,
    stopped, however many more steps run, and a finished lane's rows and
    gains stay as its last step left them."""
    M, k = 96, 6
    spec = _slot_spec(mesh, window, k)
    state, Vs = tcore.greedy_slots_init(spec, 2, 12, M, device="cpu")
    tcore.state_admit(spec, state, 0,
                      *_bucket(_t(make_greedy_inputs(4, None, 12, 80)),
                               None, M))
    _, sel, _ = tcore.greedy_chunk_slots(spec, state, Vs, k + 2)
    assert bool((sel[0, :k] >= 0).all()) and sel[0, k:].tolist() == [-1, -1]
    assert state.t.tolist() == [k, k] and bool(state.stopped.all())
    done = [x.clone() for x in (state.C[0], state.d2[0])]
    _, sel, _ = tcore.greedy_chunk_slots(spec, state, Vs, 3 * k)
    assert bool((sel == -1).all()) and state.t.tolist() == [k, k]
    assert all(torch.equal(a, b) for a, b in zip(done, (state.C[0],
                                                        state.d2[0])))


ROUTER_MIX = [(0, 64, 6, False), (1, 48, 4, True), (2, 64, 5, False),
              (3, 56, 6, True), (4, 40, 6, False), (5, 64, 3, True)]


def _router_arrays(seed, m, rank2=False):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(m, 8)).astype(np.float32)
    if rank2:  # features of rank 2: the slate eps-stops after 2 picks
        f[:, 2:] = 0.0
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    s = rng.uniform(0.1, 1.0, size=m).astype(np.float32)
    mm = np.ones(m, bool)
    mm[::3] = False
    return s, f, mm


def _router_mix(mod, arr, lapsed=()):
    """``ROUTER_MIX`` (``repro``'s ``test_router_multidevice_sharded_parity``
    mix and two more) as requests of ``mod`` (``ts`` or ``js``); request 4
    eps-stops, the requests in ``lapsed`` carry a lapsed deadline."""
    reqs = []
    for i, (seed, m, k, masked) in enumerate(ROUTER_MIX):
        s, f, mm = _router_arrays(seed, m, rank2=i == 4)
        reqs.append(mod.RerankRequest(
            scores=arr(s), feats=arr(f), slate_size=k,
            mask=arr(mm) if masked else None,
            deadline=1e-9 if i in lapsed else None))
    return reqs


def _serve_router(rr, reqs):
    handles = [rr.submit(r) for r in reqs]
    rr.router.drain()
    return handles


@pytest.mark.parametrize("chunk", [2, 4])
@pytest.mark.parametrize("window", [None, 3])
def test_router_on_a_mesh_matches_repro(mesh, jmesh, window, chunk):
    """``Reranker.submit`` on a one-rank mesh against ``repro``'s router on
    a one-device mesh: requests of different M, k and mask over 2 slots,
    one eps-stop, one lapsed deadline, lanes whose chunks run past the
    slot capacity of 6; ids equal and d_hist within the oracle's
    tolerance, each slate also the per-request sharded rerank's."""
    kw = dict(slate_size=6, shortlist=48, alpha=3.0, eps=1e-3,
              window=window)
    jcfg, tcfg = _cfgs(mesh, jmesh, **kw)
    rcfg = dict(slots=2, chunk_size=chunk, max_candidates=64)
    rr = ts.Reranker(tcfg, router_config=ts.RouterConfig(**rcfg),
                     device="cpu")
    got = _serve_router(rr, _router_mix(ts, np.asarray, lapsed=(2,)))
    jrr = js.Reranker(jcfg, router_config=js.RouterConfig(**rcfg))
    want = _serve_router(jrr, _router_mix(js, jnp.asarray, lapsed=(2,)))
    assert rr.router.stats.timed_out == 1 and rr.router.stats.eps_stopped
    assert rr.router.stats.completed == len(ROUTER_MIX) - 1
    for i, (h, jh, req) in enumerate(zip(got, want,
                                         _router_mix(ts, np.asarray))):
        assert h.timed_out == jh.timed_out == (i == 2)
        gi, gd = h.slate()
        wi, wd = jh.slate()
        np.testing.assert_array_equal(gi, np.asarray(wi))
        _close(gd, np.asarray(wd))
        if i != 2:
            ri, rd = rr.rerank(req)
            np.testing.assert_array_equal(gi, ri.numpy())
            _close(gd, rd.numpy())
    assert (got[4].slate()[0] < 0).any()  # the eps-stop


def test_router_on_a_mesh_refuses_what_the_bucket_cannot_hold(mesh):
    cfg = ts.DPPRerankConfig(slate_size=6, shortlist=8, mesh=mesh)
    rr = ts.Reranker(cfg, router_config=ts.RouterConfig(max_candidates=50),
                     device="cpu")
    s, f, _ = _router_arrays(0, 64)
    with pytest.raises(ValueError, match="64 candidate columns"):
        rr.submit(ts.RerankRequest(scores=s, feats=f))  # full M, not C


_SKEWED_RANK = r"""
import json
import sys
import time
import numpy as np
from repro_torch import obs
from repro_torch.distributed import init_group, leave_group, make_mesh
from repro_torch.serving import (
    DPPRerankConfig,
    Reranker,
    RerankRequest,
    RouterConfig,
)
import repro_torch.serving.router as router_mod

rank, rdv, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
init_group("gloo", rank, 2, rdv, timeout_s=60)
mesh = make_mesh(device="cpu")
skew = [0.0]
if rank == 1:  # rank 1's clock jumps 1000 s ahead once the requests are in
    class _Clock:
        perf_counter = staticmethod(time.perf_counter)
        monotonic = staticmethod(lambda: time.monotonic() + skew[0])
    router_mod.time = _Clock
rr = Reranker(DPPRerankConfig(slate_size=6, shortlist=48, alpha=3.0,
                              mesh=mesh),
              router_config=RouterConfig(slots=2, chunk_size=2,
                                         max_candidates=64), device="cpu")
handles = []
for i in range(6):
    rng = np.random.default_rng(i)
    f = rng.normal(size=(64, 8)).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    handles.append(rr.submit(RerankRequest(
        scores=rng.uniform(size=64).astype(np.float32), feats=f,
        deadline=1e-9 if i == 3 else 100.0)))
skew[0] = 1000.0
obs.enable(obs.ObsConfig(enabled=True))
rr.router.drain()
json.dump({"slates": [h.slate()[0].tolist() for h in handles],
           "d_hist": [h.slate()[1].tolist() for h in handles],
           "timed_out": [h.timed_out for h in handles],
           "decisions": sum(1 for sp in obs.tracer().finished()
                            if sp["name"] == "router.pump.decide")},
          open(out, "w"))
leave_group()
"""


def test_router_on_two_ranks_decides_deadlines_on_rank_zero(tmp_path):
    """Two gloo ranks, rank 1's clock 1000 s ahead after submission: had
    each rank read its own clock, rank 1 would time out every 100-s
    request at its first pump while rank 0 served it, and the ranks'
    collectives would pair different lanes.  Rank 0 decides: both ranks
    return the same handles, only the lapsed request timed out."""
    spawn_ranks(lambda r: ["-c", _SKEWED_RANK, str(r), str(tmp_path / "rdv"),
                           str(tmp_path / f"rank{r}.json")], 2, 120,
                env=rank_env(2, {"OMP_NUM_THREADS": "1"}), cwd=REPO)
    r0, r1 = (json.loads((tmp_path / f"rank{r}.json").read_text())
              for r in (0, 1))
    assert r0 == r1
    assert r0["timed_out"] == [i == 3 for i in range(6)]
    assert all(len(s) == 6 for i, s in enumerate(r0["slates"]) if i != 3)
    assert r0["decisions"] > 0


# ---------------------------------------------------------------------------
# P = 2, 3, 4 ranks against repro on P-device meshes
# ---------------------------------------------------------------------------

PS = (2, 3, 4)
K_EXACT, K_WIN, W = 12, 20, 5
RERANK = dict(slate_size=6, shortlist=40, alpha=3.0, eps=1e-6)


def _cases():
    """The multi-rank cases' inputs, as numpy arrays."""
    out = {}
    V = np.asarray(_problem(11, M=97, D=16))  # 97 pads for P = 2, 3, 4
    out["single_V"] = V
    rng = np.random.default_rng(12)
    Vb = (rng.normal(size=(3, 12, 90)) / np.sqrt(12)).astype(np.float32)
    out["batch_V"] = Vb
    out["batch_mask"] = rng.uniform(size=(3, 90)) > 0.3
    out["shared_mask"] = rng.uniform(size=90) > 0.4
    # ties across every shard boundary: column i + 30 copies column i
    # (boosted so the pairs lead); 60 columns split 30/30, 20/20/20 and
    # 15 x 4, so each pair straddles a boundary.  A copy's gain is 0 once
    # its original is picked, so the slate (k = 8 < D) holds originals
    T = (rng.normal(size=(16, 60)) / 4.0).astype(np.float32)
    T[:, :30] *= np.linspace(1.5, 3.0, 30, dtype=np.float32)
    T[:, 30:] = T[:, :30]
    out["ties_V"] = T
    s = rng.uniform(size=(3, 97)).astype(np.float32)
    s[:, 60] = s[:, 10]
    out["topk_scores"] = s
    out["rr_scores"] = rng.uniform(size=(4, 121)).astype(np.float32)
    f = rng.normal(size=(121, 8)).astype(np.float32)
    out["rr_feats"] = f / np.linalg.norm(f, axis=1, keepdims=True)
    out["rr_mask"] = rng.uniform(size=(4, 121)) > 0.2
    for P in PS:
        out[f"argmax_vals_{P}"], out[f"argmax_gids_{P}"] = _argmax_case(P)
    for i, (seed, m, _, _) in enumerate(ROUTER_MIX):
        out[f"router_s{i}"], out[f"router_f{i}"], out[f"router_m{i}"] = \
            _router_arrays(seed, m, rank2=i == 4)
    return out


# the router cases: ROUTER_MIX on 2 slots of capacity 6, chunk 2, a
# bucket of 64 columns (repro's test_router_multidevice_sharded_parity)
ROUTER = dict(cfg=dict(slate_size=6, shortlist=48, alpha=3.0, eps=1e-3,
                       chunk_size=2),
              rcfg=dict(slots=2, chunk_size=2, max_candidates=64))
CONSTS = json.dumps(dict(KE=K_EXACT, KW=K_WIN, W=W, RR=RERANK, PS=PS,
                         RM=ROUTER_MIX, ROUTER=ROUTER))


def _argmax_case(P):
    """Crafted shard-local bests for the cross-shard argmax, (P, 5) values
    and global ids: row r is rank r's best per user."""
    r = np.arange(P, dtype=np.float32)[:, None]
    vals = np.concatenate([
        np.full((P, 1), 2.0),      # all equal and positive: rank 0 wins
        r - 1.5,                   # straddles zero: the highest rank wins
        np.zeros((P, 1)),          # all zero: rank 0
        -1.0 - r,                  # all negative: rank 0
        np.where(r == P - 1, 0.5, -3.0e38),  # one positive, the last rank
    ], 1).astype(np.float32)
    return vals, r.astype(np.int64) * 1000 + np.arange(5)


_TORCH_RANK = r"""
import json
import sys
import numpy as np
import torch
from repro_torch.core import (
    GreedySpec,
    dpp_greedy_sharded,
    greedy_map_chunks,
    sharded_topk,
)
from repro_torch.distributed import global_argmax, init_group, leave_group
from repro_torch.distributed import make_mesh
from repro_torch.serving import (
    DPPRerankConfig,
    Reranker,
    RerankRequest,
    RouterConfig,
)

rank, P, rdv, inp, out = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6]
c = json.loads(sys.argv[6])
KE, KW, W, RR = c["KE"], c["KW"], c["W"], c["RR"]
torch.set_num_threads(1)
init_group("gloo", rank, P, rdv, timeout_s=60)
mesh = make_mesh(device="cpu")
z = dict(np.load(inp))
t = lambda x: torch.from_numpy(x)
res = {}
def put(name, r):
    res[name + "_sel"] = r.indices.numpy()
    res[name + "_dh"] = r.d_hist.numpy()
put("exact", dpp_greedy_sharded(t(z["single_V"]), KE, mesh=mesh, eps=1e-6))
put("windowed", dpp_greedy_sharded(t(z["single_V"]), KW, mesh=mesh,
                                   window=W, eps=1e-6))
put("batch", dpp_greedy_sharded(t(z["batch_V"]), 8, mesh=mesh, eps=1e-6,
                                mask=t(z["batch_mask"])))
put("shared", dpp_greedy_sharded(t(z["batch_V"]), 10, mesh=mesh, window=3,
                                 eps=1e-6, mask=t(z["shared_mask"])))
put("ties", dpp_greedy_sharded(t(z["ties_V"]), 8, mesh=mesh, eps=1e-3))
v, i = sharded_topk(t(z["topk_scores"]), 25, mesh=mesh)
res["topk_v"], res["topk_i"] = v.numpy(), i.numpy()
for w in (None, 3):
    cfg = DPPRerankConfig(mesh=mesh, window=w, **RR)
    sel, dh = Reranker(cfg, device="cpu").rerank(RerankRequest(
        scores=z["rr_scores"], feats=z["rr_feats"], mask=z["rr_mask"]))
    res[f"rerank{w}_sel"], res[f"rerank{w}_dh"] = sel.numpy(), dh.numpy()
def stream(name, V, k, chunk, window=None, mask=None):
    spec = GreedySpec(k=k, window=window, mesh=mesh, eps=1e-6,
                      chunk_size=chunk)
    cs = list(greedy_map_chunks(spec, V=t(V), mask=mask))
    res[f"stream_{name}_sel"] = torch.cat([c.indices for c in cs], -1).numpy()
    res[f"stream_{name}_dh"] = torch.cat([c.d_hist for c in cs], -1).numpy()
stream("exact", z["single_V"], KE, 4)
stream("windowed", z["single_V"], KW, 3, window=W)
stream("batch", z["batch_V"], 8, 3, mask=t(z["batch_mask"]))
stream("shared", z["batch_V"], 10, 4, window=3, mask=t(z["shared_mask"]))
one = RerankRequest(scores=z["rr_scores"][0], feats=z["rr_feats"],
                    mask=z["rr_mask"][0])
for w in (None, 3):
    cfg = DPPRerankConfig(mesh=mesh, window=w, chunk_size=4, **RR)
    rr = Reranker(cfg, device="cpu")
    sel, dh = rr.rerank(one)
    res[f"rerank{w}_one_sel"] = sel.numpy()
    res[f"rerank{w}_one_dh"] = dh.numpy()
    cs = list(rr.stream(one))
    res[f"stream_rerank{w}_sel"] = torch.cat([c for c, _ in cs]).numpy()
    res[f"stream_rerank{w}_dh"] = torch.cat([d for _, d in cs]).numpy()
for w, key in ((None, "router"), (3, "router3")):
    rr = Reranker(DPPRerankConfig(mesh=mesh, window=w, **c["ROUTER"]["cfg"]),
                  router_config=RouterConfig(**c["ROUTER"]["rcfg"]),
                  device="cpu")
    hs = [rr.submit(RerankRequest(
        scores=z[f"router_s{i}"], feats=z[f"router_f{i}"], slate_size=k,
        mask=z[f"router_m{i}"] if masked else None))
        for i, (_, _, k, masked) in enumerate(c["RM"])]
    rr.router.drain()
    sel, dh = np.full((len(hs), 6), -2), np.zeros((len(hs), 6), np.float32)
    for i, h in enumerate(hs):
        gi, gd = h.slate()
        sel[i, :len(gi)], dh[i, :len(gd)] = gi, gd
    res[f"{key}_sel"], res[f"{key}_dh"] = sel, dh
vals, gids = z[f"argmax_vals_{P}"][rank], z[f"argmax_gids_{P}"][rank]
dj2, j, owner = global_argmax(mesh, t(vals), t(gids))
res["argmax_v"], res["argmax_j"] = dj2.numpy(), j.numpy()
res["argmax_owner"] = owner.numpy()
np.savez(out, **res)
leave_group()
"""

_JAX_REF = r"""
import json
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.core import (
    GreedySpec,
    dpp_greedy_sharded,
    greedy_map_chunks,
    sharded_topk,
)
from repro.distributed.context import make_mesh_compat
from repro.serving import (
    DPPRerankConfig,
    Reranker,
    RerankRequest,
    RouterConfig,
)

z = dict(np.load(sys.argv[1]))
c = json.loads(sys.argv[3])
KE, KW, W, RR = c["KE"], c["KW"], c["W"], c["RR"]
res = {}
for P in c["PS"]:
    mesh = make_mesh_compat((P,), ("data",), devices=jax.devices()[:P])
    def put(name, r):
        res[f"{name}_sel_{P}"] = np.asarray(r.indices)
        res[f"{name}_dh_{P}"] = np.asarray(r.d_hist)
    a = jnp.asarray
    put("exact", dpp_greedy_sharded(a(z["single_V"]), KE, mesh=mesh,
                                    eps=1e-6))
    put("windowed", dpp_greedy_sharded(a(z["single_V"]), KW, mesh=mesh,
                                       window=W, eps=1e-6))
    put("batch", dpp_greedy_sharded(a(z["batch_V"]), 8, mesh=mesh, eps=1e-6,
                                    mask=a(z["batch_mask"])))
    put("shared", dpp_greedy_sharded(a(z["batch_V"]), 10, mesh=mesh,
                                     window=3, eps=1e-6,
                                     mask=a(z["shared_mask"])))
    put("ties", dpp_greedy_sharded(a(z["ties_V"]), 8, mesh=mesh, eps=1e-3))
    v, i = sharded_topk(a(z["topk_scores"]), 25, mesh=mesh)
    res[f"topk_v_{P}"], res[f"topk_i_{P}"] = np.asarray(v), np.asarray(i)
    for w in (None, 3):
        cfg = DPPRerankConfig(mesh=mesh, window=w, **RR)
        sel, dh = Reranker(cfg).rerank(RerankRequest(
            scores=a(z["rr_scores"]), feats=a(z["rr_feats"]),
            mask=a(z["rr_mask"])))
        res[f"rerank{w}_sel_{P}"] = np.asarray(sel)
        res[f"rerank{w}_dh_{P}"] = np.asarray(dh)
    def stream(name, V, k, chunk, window=None, mask=None):
        spec = GreedySpec(k=k, window=window, backend="sharded", mesh=mesh,
                          eps=1e-6, chunk_size=chunk)
        cs = list(greedy_map_chunks(spec, V=a(V), mask=mask))
        res[f"stream_{name}_sel_{P}"] = np.concatenate(
            [np.asarray(c.indices) for c in cs], -1)
        res[f"stream_{name}_dh_{P}"] = np.concatenate(
            [np.asarray(c.d_hist) for c in cs], -1)
    stream("exact", z["single_V"], KE, 4)
    stream("windowed", z["single_V"], KW, 3, window=W)
    stream("batch", z["batch_V"], 8, 3, mask=a(z["batch_mask"]))
    stream("shared", z["batch_V"], 10, 4, window=3,
           mask=jnp.broadcast_to(a(z["shared_mask"]), (3, 90)))
    for w in (None, 3):
        cfg = DPPRerankConfig(mesh=mesh, window=w, chunk_size=4, **RR)
        cs = list(Reranker(cfg).stream(RerankRequest(
            scores=a(z["rr_scores"][0]), feats=a(z["rr_feats"]),
            mask=a(z["rr_mask"][0]))))
        res[f"stream_rerank{w}_sel_{P}"] = np.concatenate(
            [np.asarray(c) for c, _ in cs])
        res[f"stream_rerank{w}_dh_{P}"] = np.concatenate(
            [np.asarray(d) for _, d in cs])
    for w, key in ((None, "router"), (3, "router3")):
        rr = Reranker(DPPRerankConfig(mesh=mesh, window=w,
                                      **c["ROUTER"]["cfg"]),
                      router_config=RouterConfig(**c["ROUTER"]["rcfg"]))
        hs = [rr.submit(RerankRequest(
            scores=a(z[f"router_s{i}"]), feats=a(z[f"router_f{i}"]),
            slate_size=k, mask=a(z[f"router_m{i}"]) if masked else None))
            for i, (_, _, k, masked) in enumerate(c["RM"])]
        rr.router.drain()
        sel = np.full((len(hs), 6), -2)
        dh = np.zeros((len(hs), 6), np.float32)
        for i, h in enumerate(hs):
            gi, gd = h.slate()
            sel[i, :len(gi)], dh[i, :len(gd)] = gi, gd
        res[f"{key}_sel_{P}"], res[f"{key}_dh_{P}"] = sel, dh
np.savez(sys.argv[2], **res)
"""


@pytest.fixture(scope="module", autouse=True)
def _multi_started(tmp_path_factory):
    """Start every P's torch ranks and the JAX reference when the module
    starts, so they run while the in-process tests do; :func:`multi`
    collects them."""
    tmp = tmp_path_factory.mktemp("multi")
    inp = tmp / "inputs.npz"
    np.savez(inp, **_cases())
    jax_env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")

    def jax_ref():
        res = subprocess.run(
            [sys.executable, "-c", _JAX_REF, str(inp), str(tmp / "jax.npz"),
             CONSTS], env=jax_env, cwd=REPO, capture_output=True, text=True,
            timeout=300)
        assert res.returncode == 0, res.stderr[-3000:]
        return dict(np.load(tmp / "jax.npz"))

    def ranks(P):
        d = tmp / f"p{P}"
        d.mkdir()
        spawn_ranks(lambda r: ["-c", _TORCH_RANK, str(r), str(P),
                               str(d / "rdv"), str(inp),
                               str(d / f"rank{r}.npz"), CONSTS], P, 240,
                    env=rank_env(P, {"OMP_NUM_THREADS": "1"}), cwd=REPO)
        return [dict(np.load(d / f"rank{r}.npz")) for r in range(P)]

    pool = concurrent.futures.ThreadPoolExecutor(1 + len(PS))
    futures = {"jax": pool.submit(jax_ref)}
    futures.update({P: pool.submit(ranks, P) for P in PS})
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def multi(_multi_started):
    """Every P's torch ranks and the JAX reference, run once:
    ``{"torch": {P: [rank 0's results, ...]}, "jax": results}``."""
    return {"torch": {P: _multi_started[P].result() for P in PS},
            "jax": _multi_started["jax"].result()}


GREEDY_CASES = ["exact", "windowed", "batch", "shared", "ties", "rerankNone",
                "rerank3", "router", "router3"]


@pytest.mark.parametrize("P", PS)
def test_multi_rank_ranks_agree(multi, P):
    """Every rank returns the same slates, bit for bit."""
    ranks = multi["torch"][P]
    for r in ranks[1:]:
        for key, val in ranks[0].items():
            if key.startswith("argmax_owner"):
                continue
            np.testing.assert_array_equal(r[key], val, err_msg=key)


@pytest.mark.parametrize("case", GREEDY_CASES)
@pytest.mark.parametrize("P", PS)
def test_multi_rank_matches_repro(multi, P, case):
    got, want = multi["torch"][P][0], multi["jax"]
    np.testing.assert_array_equal(got[f"{case}_sel"],
                                  want[f"{case}_sel_{P}"])
    _close(got[f"{case}_dh"], want[f"{case}_dh_{P}"])


# each stream case and the whole-slate call it streams (the rerank cases
# stream one request, user 0, whose whole slate the ranks also served)
STREAM_CASES = {"exact": "exact", "windowed": "windowed", "batch": "batch",
                "shared": "shared", "rerankNone": "rerankNone_one",
                "rerank3": "rerank3_one"}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
@pytest.mark.parametrize("P", PS)
def test_multi_rank_stream_equals_whole(multi, P, case):
    """On every rank the stream's chunks concatenate to the rank's own
    whole sharded slate, bit for bit."""
    whole = STREAM_CASES[case]
    for res in multi["torch"][P]:
        for part in ("sel", "dh"):
            np.testing.assert_array_equal(res[f"stream_{case}_{part}"],
                                          res[f"{whole}_{part}"])


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
@pytest.mark.parametrize("P", PS)
def test_multi_rank_stream_matches_repro(multi, P, case):
    got, want = multi["torch"][P][0], multi["jax"]
    np.testing.assert_array_equal(got[f"stream_{case}_sel"],
                                  want[f"stream_{case}_sel_{P}"])
    _close(got[f"stream_{case}_dh"], want[f"stream_{case}_dh_{P}"])


@pytest.mark.parametrize("P", PS)
def test_multi_rank_ties_pick_the_lowest_global_id(multi, P):
    sel = multi["torch"][P][0]["ties_sel"].tolist()
    # every pick ties its copy on the other side of a boundary: the
    # original, with the lower global id, wins each time
    assert all(0 <= s < 30 for s in sel) and len(set(sel)) == 8
    ref = jcore.dpp_greedy_lowrank(jnp.asarray(_cases()["ties_V"]), 8,
                                   eps=1e-3)
    np.testing.assert_array_equal(sel, np.asarray(ref.indices))


@pytest.mark.parametrize("P", PS)
def test_multi_rank_topk_matches_repro(multi, P):
    got, want = multi["torch"][P][0], multi["jax"]
    np.testing.assert_array_equal(got["topk_i"], want[f"topk_i_{P}"])
    np.testing.assert_array_equal(got["topk_v"], want[f"topk_v_{P}"])
    top = jax.lax.top_k(jnp.asarray(_cases()["topk_scores"]), 25)[1]
    np.testing.assert_array_equal(got["topk_i"], np.asarray(top))


@pytest.mark.parametrize("P", PS)
def test_multi_rank_argmax_keeps_value_order(multi, P):
    """The fold takes the largest value, then the lowest rank, on gains
    that are all non-negative and that straddle zero."""
    vals, gids = _argmax_case(P)
    best = np.argmax(vals, axis=0)  # numpy: the first maximum
    cols = np.arange(vals.shape[1])
    for r, res in enumerate(multi["torch"][P]):
        np.testing.assert_array_equal(res["argmax_v"], vals[best, cols])
        np.testing.assert_array_equal(res["argmax_j"], gids[best, cols])
        np.testing.assert_array_equal(res["argmax_owner"], best == r)
    assert best[1] == P - 1 and best[0] == 0 and best[4] == P - 1


# ---------------------------------------------------------------------------
# launch.serve_sharded
# ---------------------------------------------------------------------------


def test_serve_sharded_two_gloo_ranks_on_cpu(tmp_path, capsys):
    out = serve_sharded.main([
        "--device", "cpu", "--devices", "2", "--backend", "gloo",
        "--candidates", "3001", "--dim", "16", "--batch", "3",
        "--shortlist", "500", "--window", "0", "4", "--slate", "10", "12",
        "--check", "--timeout", "240",
        "--metrics-out", str(tmp_path / "m.json")])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == json.loads((tmp_path / "m.json").read_text()) == out
    assert out["devices"] == 2 and out["per_device_candidates"] == 1501
    assert out["check"].startswith("ok")
    for run, k in zip(out["runs"], (10, 12)):
        assert run["ranks_agree"] and run["check"].startswith("ok")
        assert np.asarray(run["indices"]).shape == (3, k)
        assert [r["rank"] for r in run["ranks"]] == [0, 1]
        # 2 collectives a step and the shortlist's one (CPU: no kernel)
        assert all(r["collectives"] == 2 * k + 1 for r in run["ranks"])
        assert all(r["launches"] == {} for r in run["ranks"])



def test_serve_sharded_stream_two_gloo_ranks_on_cpu(tmp_path, capsys):
    out = serve_sharded.main([
        "--device", "cpu", "--devices", "2", "--backend", "gloo",
        "--candidates", "3001", "--dim", "16", "--shortlist", "500",
        "--window", "0", "4", "--slate", "10", "12", "--stream", "4",
        "--check", "--timeout", "240"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == out
    assert set(out["stream"]) == {"chunk_size", "first_chunk_s",
                                  "stream_total_s", "first_chunk_vs_whole",
                                  "check"}
    assert out["stream"]["check"] == "ok (chunks concatenate to the slate)"
    for run, k in zip(out["runs"], (10, 12)):
        st = run["stream"]
        assert st["chunk_size"] == 4 and st["check"].startswith("ok")
        assert run["check"].startswith("ok") and run["n_selected"] == k
        assert 0 < st["first_chunk_s"] <= st["stream_total_s"]
        assert [r["rank"] for r in st["ranks"]] == [0, 1]
        # the stream's steps: 2 collectives each, and the shortlist's one
        assert all(r["collectives"] == 2 * k + 1 for r in st["ranks"])
        assert all(r["launches"] == {} for r in st["ranks"])  # CPU
    with pytest.raises(SystemExit, match="single request"):
        serve_sharded.main(["--device", "cpu", "--batch", "2",
                            "--stream", "4"])


def test_serve_sharded_router_two_gloo_ranks_on_cpu(tmp_path, capsys):
    """``serve_sharded --router``: two gloo ranks serve the requests of an
    ``--inputs`` file (pools cut by ``sizes``, two lapsed ``deadlines``)
    through the router on the mesh, exact and windowed; every rank's
    handles equal rank 0's and each slate the per-request sharded
    rerank's."""
    rng = np.random.default_rng(3)
    f = rng.normal(size=(500, 8)).astype(np.float32)
    np.savez(tmp_path / "req.npz", feats=f / np.linalg.norm(
        f, axis=1, keepdims=True),
        scores=rng.uniform(size=(6, 500)).astype(np.float32),
        mask=rng.uniform(size=(6, 500)) > 0.1,
        sizes=np.array([500, 300, 120, 500, 260, 400]),
        deadlines=np.array([0, 1e-9, 0, 0, 1e-9, 0]))
    out = serve_sharded.main([
        "--device", "cpu", "--devices", "2", "--backend", "gloo",
        "--inputs", str(tmp_path / "req.npz"), "--shortlist", "100",
        "--window", "0", "3", "--slate", "8", "10", "--router", "6",
        "--slots", "3", "--chunk", "4", "--check", "--timeout", "240"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == out
    assert out["router"] == 6 and out["slots"] == 3
    for run, k in zip(out["runs"], (8, 10)):
        assert run["ranks_agree"] and run["check"].startswith("ok")
        assert run["timed_out"] == [i in (1, 4) for i in range(6)]
        assert np.asarray(run["indices"]).shape == (6, k)
        assert all(k // 2 <= n <= k for n in run["slate_sizes"])
        assert [r["rank"] for r in run["ranks"]] == [0, 1]
        for r in run["ranks"]:
            # a collective a pump while a queued or live request has a
            # deadline: the two lapsed ones leave the queue at once
            assert 0 < r["decisions"] < run["pumps"]
            assert r["launches"] == {}
            assert set(r["pump_us"]) == {"pump", "sync", "decide", "evict",
                                         "admit", "launch", "materialize"}
            assert r["chunks_launched"] <= run["pumps"]
            ttfc = [x for x in r["ttfc_s"] if x is not None]
            assert len(ttfc) == 4 and min(ttfc) > 0
