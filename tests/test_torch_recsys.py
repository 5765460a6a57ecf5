"""Parity of the port's recsys scoring path (``repro_torch.models``,
``configs``, ``data``, ``core.metrics``/``baselines`` and
``launch.serve``) with ``repro``'s, on the CPU.

The parameters cross from JAX through ``params_from_jax`` (numpy
leaves), the inputs through numpy.  Tolerances, with their reasons:

* logits at the reduced configs: rtol 1e-5 / atol 1e-6 (the FM, CIN,
  attention and MLP sums run in another order in float32);
* DeepFM at its published widths (39 fields, embed 10, MLP 400-400-400)
  with small vocabularies: rtol 1e-4 / atol 1e-5 (400-wide float32 dot
  products in another order);
* embeddings, bags and tables: rtol 1e-6 / atol 1e-7 (a gather and a
  masked sum of at most H rows);
* serving: scores rtol 1e-5 / atol 1e-6, slates index for index;
* the diversity from slate rows: rtol 1e-6 (float32 similarities from
  another matrix product).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.configs import shapes as jax_shapes
from repro.configs.base import make_recsys_vocabs as jax_vocabs
from repro.core import baselines as jax_baselines
from repro.core import metrics as jax_metrics
from repro.data import recsys_batches as jax_batches
from repro.launch import serve as jax_serve
from repro.models import recsys as jax_recsys
from repro.models.embedding import (
    EmbeddingSpec as JaxSpec,
    embedding_bag as jax_bag,
    embedding_bag_ref as jax_bag_ref,
)
from repro.serving import (
    DPPRerankConfig as JaxRerankConfig,
    Reranker as JaxReranker,
    RerankRequest as JaxRequest,
)
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.configs.base import make_recsys_vocabs
from repro_torch.core import (
    mean_slate_diversity,
    mean_slate_diversity_rows,
    random_top_select,
    recall_at_n,
    slate_diversity,
    top_n_select,
)
from repro_torch.data import recsys_batches
from repro_torch.kernels import cuda
from repro_torch.launch import serve
from repro_torch.models import params_from_jax, recsys
from repro_torch.models.embedding import (
    EmbeddingSpec,
    embedding_bag,
    embedding_bag_ref,
    init_table,
)
from repro_torch.serving import DPPRerankConfig, Reranker

ARCHS = ["deepfm", "xdeepfm", "wide-deep", "autoint"]
VOCABS = (50, 30, 80, 20)


def port_cfg(jcfg, **kw):
    """The port's RecsysConfig with the same fields as a repro one."""
    fields = {f: getattr(jcfg, f) for f in (
        "name", "vocab_sizes", "embed_dim", "interaction", "mlp_dims",
        "cin_layers", "attn_layers", "attn_heads", "d_attn", "hot_size",
        "item_field", "emb_mode")}
    fields.update(kw)
    return recsys.RecsysConfig(**fields, dtype=torch.float32)


def jax_model(jcfg, seed=0):
    params = jax_recsys.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, params)
    return params, params_from_jax(tree, port_cfg(jcfg), device="cpu")


def _ids(vocabs, batch, hot, seed):
    return next(recsys_batches(vocabs, batch, hot=hot, seed=seed))["ids"]


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hot", [1, 3])
def test_embedding_bag_matches_repro(hot):
    spec, jspec = EmbeddingSpec(VOCABS, 8, 16), JaxSpec(VOCABS, 8, 16)
    assert spec.total_rows == jspec.total_rows
    np.testing.assert_array_equal(spec.offsets, jspec.offsets)
    rng = np.random.default_rng(hot)
    table = rng.normal(size=(spec.total_rows, 8)).astype(np.float32)
    ids = np.stack([rng.integers(0, v, size=(16, hot)) for v in VOCABS], 1)
    ids[:, :, 1:] = np.where(rng.uniform(size=ids[:, :, 1:].shape) < 0.5, -1,
                             ids[:, :, 1:])
    ids = ids.astype(np.int32)
    want = np.asarray(jax_bag(jnp.asarray(table), jnp.asarray(ids), jspec))
    t, i = torch.from_numpy(table), torch.from_numpy(ids)
    for got in (embedding_bag(t, i, spec), embedding_bag_ref(t, i, spec),
                embedding_bag(t, i, spec, mode="alltoall")):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        embedding_bag_ref(t, i, spec).numpy(),
        np.asarray(jax_bag_ref(jnp.asarray(table), jnp.asarray(ids), jspec)),
        rtol=1e-6, atol=1e-7)


def test_init_table_shape_scale_and_seed():
    spec = EmbeddingSpec(VOCABS, 8)
    a = init_table(torch.Generator().manual_seed(3), spec)
    b = init_table(torch.Generator().manual_seed(3), spec)
    assert a.shape == (512, 8) and torch.equal(a, b)
    assert 0.008 < float(a.std()) < 0.012


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hot", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_repro_reduced(arch, hot):
    jcfg = jax_configs.get_arch(arch).reduced()
    params, model = jax_model(jcfg)
    cfg = configs.get_arch(arch).reduced()
    ids = _ids(cfg.vocab_sizes, 64, hot, seed=hot)
    want = np.asarray(jax_recsys.forward_logits(params, jnp.asarray(ids),
                                                jcfg))
    with torch.inference_mode():
        got = recsys.forward_logits(model, torch.from_numpy(ids), cfg)
        scores = recsys.serve_scores(model, torch.from_numpy(ids), cfg)
    assert got.dtype == torch.float32 and got.shape == (64,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        scores.numpy(),
        np.asarray(jax_recsys.serve_scores(params, jnp.asarray(ids), jcfg)),
        rtol=1e-5, atol=1e-6)


def test_deepfm_full_widths_small_vocabs():
    """DeepFM's published widths (39 fields, embed 10, MLP 400-400-400)
    with small vocabularies."""
    full = jax_configs.get_arch("deepfm").config
    vocabs = tuple(int(v) for v in
                   np.random.default_rng(5).integers(20, 300, size=39))
    jcfg = jax_recsys.RecsysConfig(
        name="deepfm-small-vocab", vocab_sizes=vocabs,
        embed_dim=full.embed_dim, interaction="fm", mlp_dims=full.mlp_dims)
    params, model = jax_model(jcfg, seed=1)
    assert [tuple(lin.weight.shape) for lin in model.mlp.layers] == [
        (400, 390), (400, 400), (400, 400), (1, 400)]
    ids = _ids(vocabs, 96, 1, seed=2)
    want = np.asarray(jax_recsys.forward_logits(params, jnp.asarray(ids),
                                                jcfg))
    with torch.inference_mode():
        got = recsys.forward_logits(model, torch.from_numpy(ids), model.cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_forward_runs_fm_through_k8_plain_on_cpu():
    """On the CPU the FM term is K8's plain version: no launch counted,
    the same numbers as the differentiable reference."""
    jcfg = jax_configs.get_arch("deepfm").reduced()
    _, model = jax_model(jcfg)
    ids = torch.from_numpy(_ids(jcfg.vocab_sizes, 8, 1, 0))
    cuda.reset_launch_counts()
    with torch.inference_mode():
        emb, _ = recsys.embed(model, ids, model.cfg)
        got = recsys.fm_second_order(emb)
    assert cuda.launch_counts() == {}
    want = np.asarray(jax_recsys.fm_second_order(jnp.asarray(emb.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def test_forward_with_grad_matches_repro_grad():
    """K8 is differentiable (the refusal it once raised is gone): the
    gradient of reduced DeepFM's logits against a random cotangent,
    through the FM term's plain backward on the CPU, equals ``jax.vjp``'s
    within rtol 1e-5 / atol 1e-6, parameter for parameter."""
    jcfg = jax_configs.get_arch("deepfm").reduced()
    params, model = jax_model(jcfg)
    ids = _ids(jcfg.vocab_sizes, 16, 1, 0)
    ct = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: jax_recsys.forward_logits(p, jnp.asarray(ids),
                                                         jcfg), params)
    (grads,) = vjp(jnp.asarray(ct))
    logits = recsys.forward_logits(model, torch.from_numpy(ids), model.cfg)
    logits.backward(torch.from_numpy(ct))
    want = dict(params_from_jax(jax.tree.map(np.asarray, grads),
                                port_cfg(jcfg), device="cpu")
                .named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_item_embeddings_match_repro(arch):
    jcfg = jax_configs.get_arch(arch).reduced()
    params, model = jax_model(jcfg)
    item = np.arange(jcfg.vocab_sizes[jcfg.item_field], dtype=np.int32)
    want = np.asarray(jax_recsys.item_embeddings(params, jnp.asarray(item),
                                                 jcfg))
    with torch.inference_mode():
        got = recsys.item_embeddings(model, torch.from_numpy(item), model.cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_repro(arch):
    assert (configs.get_arch(arch).config.param_count()
            == jax_configs.get_arch(arch).config.param_count())
    assert (configs.get_arch(arch).reduced().param_count()
            == jax_configs.get_arch(arch).reduced().param_count())


@pytest.mark.parametrize("arch", ARCHS)
def test_random_init_matches_repro_shapes_and_scales(arch):
    """init_params draws repro's distributions (not its numbers): the
    same parameter shapes, deterministic per seed."""
    jcfg = jax_configs.get_arch(arch).reduced()
    cfg = configs.get_arch(arch).reduced()
    jtree = jax.tree.map(np.asarray, jax_recsys.init_params(
        jax.random.PRNGKey(0), jcfg))
    a = recsys.init_params(torch.Generator().manual_seed(0), cfg)
    b = recsys.init_params(torch.Generator().manual_seed(0), cfg)
    conv = params_from_jax(jtree, cfg, device="cpu")
    sa, sc = a.state_dict(), conv.state_dict()
    assert {k: v.shape for k, v in sa.items()} == {
        k: v.shape for k, v in sc.items()}
    for k in sa:
        assert torch.equal(sa[k], b.state_dict()[k])
    assert 0.008 < float(a.table.detach().std()) < 0.012


def test_params_from_jax_transposes_and_checks():
    jcfg = jax_configs.get_arch("deepfm").reduced()
    params, model = jax_model(jcfg)
    w = np.asarray(params["mlp"]["layers"][1]["w"])  # (32, 16)
    assert w.shape == (32, 16)
    np.testing.assert_array_equal(model.mlp.layers[1].weight.detach().numpy(),
                                  w.T)
    tree = jax.tree.map(np.asarray, params)
    bad = dict(tree, extra=np.zeros(1))
    with pytest.raises(KeyError, match="needs"):
        params_from_jax(bad, model.cfg, device="cpu")
    tree["mlp"]["layers"][1]["w"] = w.T  # (16, 32): the untransposed layout
    with pytest.raises(ValueError, match="mlp.layers"):
        params_from_jax(tree, model.cfg, device="cpu")


# ---------------------------------------------------------------------------
# configs, data, metrics, baselines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_repro(arch):
    spec, jspec = configs.get_arch(arch), jax_configs.get_arch(arch)
    assert (spec.id, spec.family, spec.skips) == (jspec.id, jspec.family,
                                                 jspec.skips)
    for cfg, jcfg in ((spec.config, jspec.config),
                      (spec.reduced(), jspec.reduced())):
        assert cfg == port_cfg(jcfg)
        assert cfg.spec.total_rows == jcfg.spec.total_rows
    assert sorted(spec.active_shapes()) == sorted(jspec.active_shapes())


def test_registry_and_shapes():
    assert configs.list_archs() == jax_configs.list_archs()
    assert set(ARCHS) <= set(configs.list_archs())
    for name, family in (("gemma3-27b", "lm"), ("graphcast", "gnn")):
        assert configs.get_arch(name).family == family
    with pytest.raises(KeyError):
        configs.get_arch("nope")
    for name, s in shapes.RECSYS_SHAPES.items():
        j = jax_shapes.RECSYS_SHAPES[name]
        assert (s.name, s.kind, s.batch, s.n_candidates) == (
            j.name, j.kind, j.batch, j.n_candidates)
    assert make_recsys_vocabs(39, seed=104) == jax_vocabs(39, seed=104)
    full = configs.get_arch("deepfm").config
    assert full.spec.total_rows == 22_187_008
    assert full.vocab_sizes[full.item_field] == 1_558_920


@pytest.mark.parametrize("hot", [1, 3])
def test_recsys_batches_match_repro(hot):
    a, b = recsys_batches(VOCABS, 32, hot, seed=4), jax_batches(VOCABS, 32,
                                                                hot, seed=4)
    for _ in range(2):
        x, y = next(a), next(b)
        np.testing.assert_array_equal(x["ids"], y["ids"])
        np.testing.assert_array_equal(x["labels"], y["labels"])


def test_metrics_and_baselines_match_repro():
    rng = np.random.default_rng(0)
    F = rng.normal(size=(60, 5)).astype(np.float32)
    F /= np.linalg.norm(F, axis=1, keepdims=True)
    S = F @ F.T
    sel = np.stack([rng.permutation(60)[:8] for _ in range(6)])
    sel[2, 5:] = -1
    assert mean_slate_diversity(sel, S) == jax_metrics.mean_slate_diversity(
        sel, S)
    assert slate_diversity(sel[1], S) == jax_metrics.slate_diversity(sel[1], S)
    tests = sel[:, 3].copy()
    tests[0] = 61
    assert recall_at_n(sel, tests) == jax_metrics.recall_at_n(sel, tests)
    r = rng.uniform(size=60)
    r[3] = r[7]
    mask = rng.uniform(size=60) > 0.2
    np.testing.assert_array_equal(top_n_select(r, 9, mask),
                                  jax_baselines.top_n_select(r, 9, mask))
    np.testing.assert_array_equal(
        random_top_select(r, 5, 4, np.random.default_rng(1)),
        jax_baselines.random_top_select(r, 5, 4, np.random.default_rng(1)))


@pytest.mark.parametrize("pad", [False, True])
def test_slate_rows_diversity_equals_full_similarity(pad):
    rng = np.random.default_rng(7)
    F = rng.normal(size=(300, 10)).astype(np.float32)
    F /= np.linalg.norm(F, axis=1, keepdims=True)
    sel = np.stack([rng.permutation(300)[:10] for _ in range(16)])
    if pad:
        sel[3, 6:] = -1
        sel[4, 1:] = -1
    want = jax_metrics.mean_slate_diversity(sel, F @ F.T)
    got = mean_slate_diversity_rows(sel, F)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _jax_pipeline(params, jcfg, user, Mc, slate, shortlist, alpha):
    """repro's serve pipeline composed from its public functions
    (``launch/serve.py::serve``'s body, one user at a time)."""
    cand = jnp.arange(Mc, dtype=jnp.int32)
    rows = []
    for u in np.asarray(user):
        ids = np.broadcast_to(u[None], (Mc,) + u.shape).copy()
        ids[:, jcfg.item_field, 0] = np.arange(Mc)
        ids[:, jcfg.item_field, 1:] = -1
        rows.append(jax_recsys.serve_scores(params, jnp.asarray(ids), jcfg))
    scores = jnp.stack(rows)
    feats = jax_recsys.item_embeddings(params, cand, jcfg)
    rr = JaxReranker(JaxRerankConfig(slate_size=slate, shortlist=shortlist,
                                     alpha=alpha))
    slates, _ = rr.rerank(JaxRequest(scores=scores, feats=feats))
    return np.asarray(scores), np.asarray(slates)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("hot", [1, 2])
def test_serve_batch_matches_repro_pipeline(hot, use_kernel):
    jcfg = jax_configs.get_arch("deepfm").reduced()
    params, model = jax_model(jcfg)
    user = _ids(jcfg.vocab_sizes, 6, hot, seed=1)
    Mc, slate, shortlist = 50, 8, 30
    want_s, want_sl = _jax_pipeline(params, jcfg, user, Mc, slate, shortlist,
                                    3.0)
    rr = Reranker(DPPRerankConfig(slate_size=slate, shortlist=shortlist,
                                  alpha=3.0, use_kernel=use_kernel),
                  device="cpu")
    scores, slates = serve.serve_batch(model, torch.from_numpy(user),
                                       torch.arange(Mc, dtype=torch.int32),
                                       model.cfg, rr)
    assert scores.shape == (6, Mc) and slates.shape == (6, slate)
    np.testing.assert_allclose(scores.numpy(), want_s, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(slates.numpy(), want_sl)


def test_candidate_ids_layout():
    cfg = configs.get_arch("deepfm").reduced()
    user = torch.from_numpy(_ids(cfg.vocab_sizes, 2, 3, seed=0))
    ids = serve.candidate_ids(user, torch.tensor([4, 9, 1]), cfg)
    assert ids.shape == (6, 4, 3)
    f = cfg.item_field
    assert ids[:, f, 0].tolist() == [4, 9, 1, 4, 9, 1]
    assert (ids[:, f, 1:] == -1).all()
    keep = [i for i in range(4) if i != f]
    assert torch.equal(ids[:3][:, keep], user[0][keep].expand(3, 3, 3))
    assert torch.equal(ids[3:][:, keep], user[1][keep].expand(3, 3, 3))


def test_serve_report_matches_repro_main(capsys):
    """repro's driver and the port's serve_batch + report on the same
    parameters (repro's PRNGKey(0) tree, converted) and the same users:
    the same record.  The slate is 8, the reduced config's embedding
    width: past the features' rank the greedy gains are float32 noise
    near eps, where any two summation orders may stop at different
    steps."""
    want = jax_serve.main(["--requests", "8", "--slate", "8"])
    jcfg = jax_configs.get_arch("deepfm").reduced()
    _, model = jax_model(jcfg)
    Mc = min(2000, jcfg.vocab_sizes[jcfg.item_field])
    user = torch.from_numpy(_ids(jcfg.vocab_sizes, 8, 1, seed=1))
    cand = torch.arange(Mc, dtype=torch.int32)
    rr = Reranker(DPPRerankConfig(slate_size=8, shortlist=min(200, Mc),
                                  alpha=3.0), device="cpu")
    scores, slates = serve.serve_batch(model, user, cand, model.cfg, rr)
    with torch.inference_mode():
        feats = recsys.item_embeddings(model, cand, model.cfg)
    got = serve.report("deepfm", scores, slates, feats, 1.0, 1.0)
    assert got.keys() == want.keys()
    assert (got["requests"], got["candidates"]) == (8, Mc)
    for key in ("mean_rel_dpp", "mean_rel_top"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    for key in ("diversity_dpp", "diversity_top"):
        for m in ("avg", "min", "median"):
            np.testing.assert_allclose(got[key][m], want[key][m], rtol=1e-5)


def test_serve_main_on_cpu(tmp_path, capsys):
    out = serve.main(["--device", "cpu", "--requests", "4",
                      "--metrics-out", str(tmp_path / "m.json")])
    assert out["requests"] == 4 and out["candidates"] == 50
    assert 0 < out["mean_rel_dpp"] < 1
    assert (tmp_path / "m.json").exists()
    full = serve.main(["--device", "cpu", "--no-reduced", "--arch", "autoint",
                       "--requests", "1", "--candidates", "64",
                       "--shortlist", "32", "--slate", "4", "--use-kernel"])
    assert full["candidates"] == 64
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--requests", "1"])
