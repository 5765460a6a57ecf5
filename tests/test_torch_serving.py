"""Parity of the port's serving call with ``repro``'s.

``repro_torch.serving.Reranker(cfg, device="cpu").rerank`` against
``repro.serving.Reranker(cfg).rerank`` (the jnp path) on the same numpy
inputs: single requests, batches with shared and per-user feats, masks,
windows and an eps-stop tail, through the plain torch core and through
the kernels' plain versions (``use_kernel=True`` on CPU tensors).  Global
ids must match index for index; ``d_hist`` within rtol 3e-4, atol 1e-5.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.serving as js
import repro_torch.serving as ts

RTOL, ATOL = 3e-4, 1e-5


def _data(seed, B=None, M=300, D=12, per_user=False, masked=False):
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    scores = rng.uniform(size=lead + (M,)).astype(np.float32)
    fshape = ((B,) if per_user else ()) + (M, D)
    feats = rng.normal(size=fshape).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    mask = rng.uniform(size=lead + (M,)) > 0.2 if masked else None
    return scores, feats, mask


def _both(cfg_kw, scores, feats, mask=None, **req_kw):
    jkw = {k: v for k, v in cfg_kw.items() if k != "tile_m"}
    jkw["use_kernel"] = False  # the jnp path is the reference
    j = js.Reranker(js.DPPRerankConfig(**jkw)).rerank(js.RerankRequest(
        scores=jnp.asarray(scores), feats=jnp.asarray(feats),
        mask=None if mask is None else jnp.asarray(mask), **req_kw))
    t = ts.Reranker(ts.DPPRerankConfig(**cfg_kw), device="cpu").rerank(
        ts.RerankRequest(scores=scores, feats=feats, mask=mask, **req_kw))
    return j, t


def _assert_same(j, t):
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=RTOL,
                               atol=ATOL)
    assert t[0].dtype == torch.int32


_CFGS = {
    "exact": dict(shortlist=100, slate_size=12, alpha=3.0),
    "window": dict(shortlist=100, slate_size=30, alpha=3.0, window=4),
    "kernel": dict(shortlist=100, slate_size=12, alpha=3.0, use_kernel=True),
    "kernel_window": dict(shortlist=100, slate_size=30, alpha=3.0,
                          window=4, use_kernel=True),
    "kernel_tiled": dict(shortlist=100, slate_size=12, alpha=3.0,
                         use_kernel=True, tile_m=32),
    "kernel_tiled_window": dict(shortlist=100, slate_size=30, alpha=3.0,
                                window=4, use_kernel=True, tile_m=32),
}


@pytest.mark.parametrize("cfg", sorted(_CFGS))
def test_single_request(cfg):
    scores, feats, _ = _data(0)
    _assert_same(*_both(_CFGS[cfg], scores, feats))


@pytest.mark.parametrize("cfg", sorted(_CFGS))
def test_batch_shared_feats_masked(cfg):
    scores, feats, mask = _data(1, B=3, masked=True)
    _assert_same(*_both(_CFGS[cfg], scores, feats, mask))


@pytest.mark.parametrize("cfg", ["exact", "kernel_window"])
def test_batch_per_user_feats(cfg):
    scores, feats, _ = _data(2, B=2, per_user=True)
    _assert_same(*_both(_CFGS[cfg], scores, feats))


def test_shared_mask_and_request_overrides():
    scores, feats, mask = _data(3, B=2, masked=True)
    _assert_same(*_both(_CFGS["kernel"], scores, feats, mask[0],
                        slate_size=7, shortlist=64))


@pytest.mark.parametrize("cfg", ["exact", "kernel", "kernel_tiled"])
def test_eps_stop_tail(cfg):
    # D < k: the slate runs out of rank; eps is far above the float32
    # noise the gains decay to past the rank
    scores, feats, _ = _data(4, M=200, D=5)
    kw = dict(_CFGS[cfg], eps=0.05)
    j, t = _both(kw, scores, feats)
    _assert_same(j, t)
    assert (t[0][5:] == -1).all() and (t[1][5:] == 0).all()


def test_duplicated_scores_keep_top_k_order():
    # many equal scores straddle the shortlist cut: the stable sort must
    # keep lax.top_k's lowest-index-first order, or the emitted global
    # ids change.  Feature norms vary so the greedy itself has no ties.
    from repro.serving.reranker import _shortlist_kernel as jax_shortlist
    from repro_torch.serving.reranker import _shortlist_kernel

    scores, feats, mask = _data(5, M=200, masked=True)
    scores = np.round(scores * 4) / 4  # five distinct values
    rng = np.random.default_rng(55)
    feats *= rng.uniform(0.5, 1.5, size=(200, 1)).astype(np.float32)
    cfg = dict(_CFGS["exact"], shortlist=50)
    jV, jm, ji = jax_shortlist(jnp.asarray(scores), jnp.asarray(feats),
                               js.DPPRerankConfig(**cfg), jnp.asarray(mask))
    tV, tm, ti = _shortlist_kernel(
        torch.from_numpy(scores)[None], torch.from_numpy(feats),
        ts.DPPRerankConfig(**cfg), torch.from_numpy(mask)[None])
    np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm[0].numpy(), np.asarray(jm))
    np.testing.assert_allclose(tV[0].numpy(), np.asarray(jV), rtol=1e-6)
    _assert_same(*_both(cfg, scores, feats, mask))


def test_duplicated_feature_columns_tie_to_lowest_index():
    scores, feats, _ = _data(6, M=100)
    scores = np.concatenate([scores, scores])
    feats = np.concatenate([feats, feats])
    j, t = _both(dict(_CFGS["kernel"], shortlist=200), scores, feats)
    _assert_same(j, t)


def test_bf16_inputs_upcast():
    scores, feats, _ = _data(7, B=2)
    sb = torch.from_numpy(scores).to(torch.bfloat16)
    fb = torch.from_numpy(feats).to(torch.bfloat16)
    j = js.Reranker(js.DPPRerankConfig(**_CFGS["exact"])).rerank(
        js.RerankRequest(scores=jnp.asarray(sb.float().numpy(),
                                            jnp.bfloat16),
                         feats=jnp.asarray(fb.float().numpy(), jnp.bfloat16)))
    t = ts.Reranker(ts.DPPRerankConfig(**_CFGS["kernel"]), device="cpu") \
        .rerank(ts.RerankRequest(scores=sb, feats=fb))
    _assert_same(j, t)
    assert t[1].dtype == torch.float32


@pytest.mark.parametrize("kw,match", [
    (dict(slate_size=0), "slate_size"),
    (dict(shortlist=0), "shortlist"),
    (dict(deadline=0.0), "deadline"),
    (dict(scores=np.zeros((2, 3, 4))), "scores must be"),
    (dict(feats=np.zeros((5,))), "feats must be"),
    (dict(feats=np.zeros((7, 4))), "candidate count"),
    (dict(scores=np.zeros((2, 5)), feats=np.zeros((3, 5, 4))), "user batch"),
    (dict(mask=np.ones(6, bool)), "candidate count"),
    (dict(scores=np.zeros((2, 5)), mask=np.ones((3, 5), bool)), "user batch"),
    (dict(mask=np.ones((2, 5), bool)), "mask must be"),
])
def test_request_validation(kw, match):
    base = dict(scores=np.zeros(5), feats=np.zeros((5, 4)))
    base.update(kw)
    with pytest.raises(ValueError, match=match):
        ts.RerankRequest(**base)


@pytest.mark.parametrize("kw,err", [
    (dict(slate_size=0), ValueError),
    (dict(shortlist=0), ValueError),
    (dict(window=0), ValueError),
    (dict(eps=-1.0), ValueError),
    (dict(tile_m=64), ValueError),  # needs use_kernel
    (dict(tile_m=100, use_kernel=True), ValueError),
    (dict(tile_m="auto", use_kernel=True), NotImplementedError),
    (dict(mesh=object(), tile_m="auto"), NotImplementedError),
    (dict(chunk_size=0, mesh=object()), ValueError),
    (dict(mesh=object(), use_kernel=True), ValueError),
])
def test_config_validation(kw, err):
    with pytest.raises(err):
        ts.DPPRerankConfig(**kw)


@pytest.mark.parametrize("verb", ["session", "submit"])
def test_unported_verbs_raise(verb):
    """Both verbs are ported now and serve the request's rerank slate:
    ``submit`` (the router) the whole slate, ``session`` (under a
    windowed config) chunks that concatenate to a prefix of it."""
    scores, feats, _ = _data(8, M=20)
    req = ts.RerankRequest(scores=scores, feats=feats)
    if verb == "submit":
        rr = ts.Reranker(ts.DPPRerankConfig(), device="cpu")
        ids, _ = rr.submit(req).result()
        assert np.array_equal(ids, rr.rerank(req)[0].numpy())
        return
    rr = ts.Reranker(ts.DPPRerankConfig(slate_size=10, window=3),
                     device="cpu")
    sess = rr.session(req)
    ids = np.concatenate([sess.next_chunk(n)[0] for n in (4, 3)])
    assert ids.size == 7
    assert np.array_equal(ids, rr.rerank(req)[0].numpy()[:7])


def test_reranker_type_errors():
    with pytest.raises(TypeError, match="DPPRerankConfig"):
        ts.Reranker(object(), device="cpu")
    rr = ts.Reranker(ts.DPPRerankConfig(), device="cpu")
    with pytest.raises(TypeError, match="RerankRequest"):
        rr.rerank(np.zeros(5))


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.Reranker(ts.DPPRerankConfig(use_kernel=True))  # default "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.Reranker(ts.DPPRerankConfig(), device="cuda:0")


def test_obs_span_and_dispatch_telemetry():
    from repro_torch import obs

    scores, feats, _ = _data(9, B=2)
    cfg = ts.DPPRerankConfig(**_CFGS["kernel"],
                             obs=obs.ObsConfig(enabled=True))
    try:
        ts.Reranker(cfg, device="cpu").rerank(
            ts.RerankRequest(scores=scores, feats=feats))
        names = [s["name"] for s in obs.tracer().finished()]
        assert names == ["serving.rerank"]
        reg = obs.registry()
        assert reg.counter("dpp_kernel_dispatch_total").value(
            mode="resident", windowed="False") == 1
        assert reg.counter("greedy_steps_total").value(backend="kernel") \
            == 2 * 12
    finally:
        obs.disable()


def test_obs_copies_match_repro():
    # the port's obs metrics/trace are near-verbatim copies: same
    # operations, same exports
    from repro import obs as jobs
    from repro_torch import obs as tobs

    outs = []
    for mod in (jobs, tobs):
        reg = mod.MetricsRegistry()
        reg.counter("c", "help").inc(2, mode="a")
        reg.gauge("g").set(3.5)
        reg.histogram("h").observe(0.002, k="x")
        outs.append((reg.snapshot(), reg.expose()))
    assert outs[0] == outs[1]
    tracer = tobs.SpanTracer(ring_size=2, torch_annotations=True)
    for name in ("a", "b", "c"):
        with tracer.span(name, n=1):
            pass
    doc = tracer.export_chrome()
    assert tobs.validate_chrome_trace(doc) is None
    assert [e["name"] for e in doc["traceEvents"][1:]] == ["b", "c"]
    assert tracer.dropped == 1
