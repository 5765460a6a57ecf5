"""Parity of the port's LM family (``repro_torch.models.{layers, moe,
transformer}``, ``convert.transformer_from_jax`` and
``examples.lm_rerank``) with ``repro``'s, on the CPU.

The same numpy inputs go through both; ``repro``'s parameters cross
through the converters.  Tolerances, float32 configs throughout:

* layers, attention, MoE, ``forward_hidden``, prefill logits and caches:
  rtol 1e-4 / atol 1e-5 (float32 matrix products in another order);
* decode logits against ``repro``'s decode and against the full forward:
  rtol / atol 3e-3 with a ring that wraps, 2e-3 otherwise (the tolerances
  of ``repro``'s own decode tests);
* the example: embeddings rtol 1e-4 / atol 1e-5, slates index for index.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import slate_diversity as jax_slate_diversity
from repro.core import top_n_select as jax_top_n_select
from repro.models import layers as JL
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.serving import (
    DPPRerankConfig as JaxRerankConfig,
    Reranker as JaxReranker,
    RerankRequest as JaxRequest,
)
from repro_torch.configs import get_arch
from repro_torch.distributed import ModelMesh, axis_rules, single_pod_rules
from repro_torch.examples import lm_rerank
from repro_torch.models import layers as L
from repro_torch.models import moe, transformer as tfm
from repro_torch.models.convert import _fill, transformer_from_jax

RTOL, ATOL = 1e-4, 1e-5
CPU = "cpu"

TINY_DENSE = tfm.TransformerConfig(
    name="tiny-dense", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, dtype=torch.float32, chunk_q=16,
)
TINY_QKVBIAS = tfm.TransformerConfig(
    name="tiny-qkvbias", n_layers=2, d_model=48, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab=128, qkv_bias=True, dtype=torch.float32, chunk_q=16,
)
TINY_MIXED = tfm.TransformerConfig(
    name="tiny-mixed", n_layers=6, d_model=32, n_heads=4, n_kv_heads=2,
    d_ff=64, vocab=64, window=8, global_every=3, dtype=torch.float32,
    chunk_q=16,
)
TINY_MOE = tfm.TransformerConfig(
    name="tiny-moe", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
    d_ff=48, vocab=64, moe=moe.MoEConfig(n_experts=4, top_k=2, d_ff=48),
    dtype=torch.float32, chunk_q=16,
)
TINY_MOE_RES = tfm.TransformerConfig(
    name="tiny-moe-res", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
    d_ff=48, vocab=64, moe=moe.MoEConfig(n_experts=4, top_k=2, d_ff=24),
    moe_dense_residual=True, dtype=torch.float32, chunk_q=16,
)
ALL = [TINY_DENSE, TINY_QKVBIAS, TINY_MIXED, TINY_MOE, TINY_MOE_RES]
LM_ARCHS = ["arctic-480b", "olmoe-1b-7b", "phi3-mini-3.8b", "gemma3-27b",
            "qwen1.5-4b"]
DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def jax_cfg(cfg):
    """``repro``'s TransformerConfig with the port config's fields."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = DTYPES[cfg.dtype]
    if cfg.moe is not None:
        fields["moe"] = jmoe.MoEConfig(**dataclasses.asdict(cfg.moe))
    return jtfm.TransformerConfig(**fields)


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def models(cfg, seed=0):
    """(repro's params, the port's Transformer holding them)."""
    params = jtfm.init_params(jax.random.PRNGKey(seed), jax_cfg(cfg))
    return params, transformer_from_jax(numpy_tree(params), cfg, CPU)


def tokens_for(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S))


@pytest.fixture(autouse=True)
def _inference():
    """The port's models serve under ``torch.inference_mode()``."""
    with torch.inference_mode():
        yield


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 32)).astype(np.float32) * 3
    scale = rng.uniform(0.5, 1.5, size=32).astype(np.float32)
    norm = L.RMSNorm(32)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
    got = L.rmsnorm(norm, torch.from_numpy(x), 1e-6)
    close(got, JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))


@pytest.mark.parametrize("offset", [0, 13])
def test_apply_rope(offset):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = offset + np.arange(9)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    close(got, JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    close(L.rope_freqs(16, 500.0), JL.rope_freqs(16, 500.0))


def test_mlp_apply():
    p = JL.mlp_init(jax.random.PRNGKey(2), 32, 80, jnp.float32)
    mlp = L.MLP(32, 80)
    with torch.no_grad():
        _fill(mlp, numpy_tree(p), "mlp")
    x = np.random.default_rng(2).standard_normal((4, 5, 32)).astype(
        np.float32)
    close(L.mlp_apply(mlp, torch.from_numpy(x)),
          JL.mlp_apply(p, jnp.asarray(x)))


# (Sq, Skv, H, KV, chunk_q, window, q_offset)
ATTN_CASES = {
    "one-chunk": (8, 8, 4, 2, 16, None, 0),
    "chunks-ragged-tail": (37, 37, 4, 2, 16, None, 0),
    "window": (37, 37, 4, 2, 16, 5, 0),
    "q-offset": (5, 12, 4, 4, 16, None, 7),
    "q-offset-chunks-window": (20, 24, 6, 2, 8, 6, 4),
    "groups-4": (19, 19, 8, 2, 16, None, 0),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_gqa_attention(case):
    Sq, Skv, H, KV, chunk_q, window, q_offset = ATTN_CASES[case]
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, Sq, H, 8)).astype(np.float32)
    k = rng.standard_normal((2, Skv, KV, 8)).astype(np.float32)
    v = rng.standard_normal((2, Skv, KV, 8)).astype(np.float32)
    got = L.gqa_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), window=window,
                          q_offset=q_offset, chunk_q=chunk_q)
    want = JL.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            window=window, q_offset=q_offset,
                            chunk_q=chunk_q)
    assert got.shape == (2, Sq, H, 8)
    close(got, want)


def test_attention_apply():
    p = JL.attention_init(jax.random.PRNGKey(4), 32, 4, 2, 8, jnp.float32,
                          qkv_bias=True)
    attn = L.Attention(32, 4, 2, 8, qkv_bias=True)
    with torch.no_grad():
        _fill(attn, numpy_tree(p), "attn")
    x = np.random.default_rng(4).standard_normal((2, 21, 32)).astype(
        np.float32)
    kw = dict(n_heads=4, n_kv_heads=2, d_head=8, rope_theta=10000.0,
              window=6, chunk_q=8)
    close(L.attention_apply(attn, torch.from_numpy(x), **kw),
          JL.attention_apply(p, jnp.asarray(x), **kw))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def moe_pair(d, cfg, seed):
    jc = jmoe.MoEConfig(**dataclasses.asdict(cfg))
    p = jmoe.moe_init(jax.random.PRNGKey(seed), d, jc, jnp.float32)
    m = moe.MoE(d, cfg)
    with torch.no_grad():
        _fill(m, numpy_tree(p), "moe")
    return jc, p, m


def test_local_moe_drops_slots_as_repro():
    cfg = moe.MoEConfig(n_experts=4, top_k=2, d_ff=24, capacity_factor=0.25)
    jc, p, m = moe_pair(16, cfg, 5)
    T = 40
    x = np.random.default_rng(5).standard_normal((T, 16)).astype(np.float32)
    cap = moe.capacity(cfg, T)
    assert cap == 8  # 80 (token, slot) pairs for 4 x 8 slots: most drop
    _, top_e, _ = moe.route(torch.from_numpy(x), m, cfg)
    assert (moe.dispatch_positions(top_e, 4, cap) == cap).sum() > 0
    got, aux = moe._local_moe(torch.from_numpy(x), m, cfg)
    want, jaux = jmoe._local_moe(jnp.asarray(x), p, jc, 1, None)
    close(got, want)
    close(aux, jaux)


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_local_moe_router_ties_go_to_the_lower_expert(top_k):
    """Experts 1 and 3 (and 0 and 2) have equal router columns, so their
    probabilities tie exactly; ``jax.lax.top_k`` takes the lower index."""
    cfg = moe.MoEConfig(n_experts=4, top_k=top_k, d_ff=24)
    jc, p, m = moe_pair(16, cfg, 6)
    w = np.asarray(p["router"]["w"]).copy()
    w[:, 2], w[:, 3] = w[:, 0], w[:, 1]
    p = dict(p, router={"w": jnp.asarray(w)})
    with torch.no_grad():
        m.router.weight.copy_(torch.from_numpy(w.T))
    x = np.random.default_rng(6).standard_normal((12, 16)).astype(np.float32)
    _, top_e, probs = moe.route(torch.from_numpy(x), m, cfg)
    assert torch.equal(probs[:, 0], probs[:, 2])
    assert torch.equal(probs[:, 1], probs[:, 3])
    _, jtop_e = jax.lax.top_k(
        jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(w), axis=-1), top_k)
    assert np.array_equal(top_e.numpy(), np.asarray(jtop_e))
    got, aux = moe._local_moe(torch.from_numpy(x), m, cfg)
    want, jaux = jmoe._local_moe(jnp.asarray(x), p, jc, 1, None)
    close(got, want)
    close(aux, jaux)


def test_moe_apply_with_a_mesh_raises():
    """The mesh refusal is gone: ``moe_apply`` takes the mesh that
    ``axis_rules`` installs (a (1, 1) mesh gives the local layer bit for
    bit; ``tests/test_torch_mesh_ranks.py`` holds 8 ranks against
    ``repro``), the old ``mesh=`` argument is refused, and the
    expert-parallel body raises when no mesh is installed."""
    cfg = moe.MoEConfig(n_experts=4, top_k=2, d_ff=8)
    m = moe.MoE(8, cfg, generator=torch.Generator().manual_seed(0),
                device="cpu")
    x = torch.randn(1, 3, 8, generator=torch.Generator().manual_seed(1))
    want, want_aux = moe.moe_apply(m, x, cfg)
    mesh = ModelMesh(((0,),), 0, torch.device("cpu"))
    with axis_rules(single_pod_rules(), mesh):
        got, aux = moe.moe_apply(m, x, cfg)
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
    with pytest.raises(TypeError, match="mesh"):
        moe.moe_apply(m, x, cfg, mesh=object())
    with pytest.raises(RuntimeError, match="ModelMesh"):
        moe._local_moe(x[0], m, cfg, 2, "model")


# ---------------------------------------------------------------------------
# transformer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", ALL, ids=lambda c: c.name)
def test_forward_hidden_matches_repro(cfg):
    params, model = models(cfg)
    toks = tokens_for(cfg, 2, 32, 1)
    hidden, aux, (ks, vs) = tfm.forward_hidden(
        model, torch.from_numpy(toks), cfg, collect_kv=True)
    jh, jaux, (jks, jvs) = jtfm.forward_hidden(
        params, jnp.asarray(toks, jnp.int32), jax_cfg(cfg), collect_kv=True)
    assert hidden.shape == (2, 32, cfg.d_model)
    close(hidden, jh)
    close(aux, jaux)
    close(ks, jks)
    close(vs, jvs)
    close(tfm.logits_from_hidden(model, hidden),
          jtfm.logits_from_hidden(params, jh))


@pytest.mark.parametrize("cfg,B,S,extra,max_seq,tol", [
    (TINY_DENSE, 2, 24, 4, 64, 2e-3),
    (TINY_MOE_RES, 2, 12, 3, 32, 2e-3),
    (TINY_MIXED, 1, 20, 3, 40, 3e-3),  # the window-8 rings wrap
], ids=["dense", "moe-res", "mixed-ring-wraps"])
def test_prefill_then_decode_matches_repro(cfg, B, S, extra, max_seq, tol):
    params, model = models(cfg)
    jc = jax_cfg(cfg)
    toks = tokens_for(cfg, B, S + extra, 2)
    jt = jnp.asarray(toks, jnp.int32)
    logits, cache = tfm.prefill(model, torch.from_numpy(toks[:, :S]), cfg,
                                max_seq)
    jlogits, jcache = jtfm.prefill(params, jt[:, :S], jc, max_seq)
    close(logits, jlogits)
    assert cache["pos"] == int(jcache["pos"]) == S
    assert set(cache["groups"]) == set(jcache["groups"])
    for key, g in cache["groups"].items():
        for kv in ("k", "v"):
            close(g[kv], jcache["groups"][key][kv])
    hidden, _, _ = tfm.forward_hidden(model, torch.from_numpy(toks), cfg)
    full = tfm.logits_from_hidden(model, hidden).float()
    close(logits, full[:, S - 1], rtol=tol, atol=tol)
    for t in range(extra):
        step = toks[:, S + t:S + t + 1]
        logits, cache = tfm.decode_step(model, cache, torch.from_numpy(step),
                                        cfg)
        jlogits, jcache = jtfm.decode_step(params, jcache, jnp.asarray(
            step, jnp.int32), jc)
        close(logits, jlogits, rtol=tol, atol=tol)
        close(logits, full[:, S + t], rtol=tol, atol=tol)
        assert cache["pos"] == S + t + 1
    for key, g in cache["groups"].items():
        for kv in ("k", "v"):
            close(g[kv], jcache["groups"][key][kv])


@pytest.mark.parametrize("max_seq", [4, 8, 32, 1 << 15])
@pytest.mark.parametrize("arch", ["tiny-mixed", "tiny-dense", "gemma3-27b",
                                  "qwen1.5-4b"])
def test_layer_cache_plan_and_init_cache_groups(arch, max_seq):
    cfg = {"tiny-mixed": TINY_MIXED, "tiny-dense": TINY_DENSE}.get(arch)
    if cfg is None:
        cfg = get_arch(arch).config
    jc = jax_cfg(cfg)
    assert tfm.layer_cache_plan(cfg, max_seq) == jtfm.layer_cache_plan(
        jc, max_seq)
    if cfg.d_model > 64:
        return  # a published config's plan only: no buffers at this width
    cache = tfm.init_cache(cfg, 2, max_seq, device=CPU)
    jcache = jtfm.init_cache(jc, 2, max_seq)
    assert cache["pos"] == 0
    assert {k: tuple(g["k"].shape) for k, g in cache["groups"].items()} == {
        k: g["k"].shape for k, g in jcache["groups"].items()}
    assert tfm.cache_max_seq(cfg, cache) == jtfm.cache_max_seq(jc, jcache)


def test_init_cache_groups():
    cache = tfm.init_cache(TINY_MIXED, batch=2, max_seq=32, device=CPU)
    # window=8 local layers + full(32) global layers -> two groups
    assert set(cache["groups"]) == {"8", "32"}
    assert cache["groups"]["8"]["k"].shape == (4, 2, 8, 2, 8)
    assert cache["groups"]["32"]["k"].shape == (2, 2, 32, 2, 8)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_counts_match_repro(arch):
    cfg, jc = get_arch(arch).config, jax_get_arch(arch).config
    assert cfg.param_count() == jc.param_count()
    assert cfg.active_param_count() == jc.active_param_count()
    assert cfg.head_dim == jc.head_dim
    assert cfg.layer_windows() == jc.layer_windows()
    assert cfg.uses_mixed_windows == jc.uses_mixed_windows


@pytest.mark.parametrize("cfg", ALL, ids=lambda c: c.name)
def test_module_holds_repros_parameter_count(cfg):
    _, model = models(cfg)
    n = sum(p.numel() for p in model.parameters())
    jn = sum(a.size for a in jax.tree.leaves(jtfm.init_params(
        jax.random.PRNGKey(0), jax_cfg(cfg))))
    assert n == jn


def test_bf16_forward_is_finite_and_near_its_f32_copy():
    cfg = dataclasses.replace(TINY_DENSE, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    model = tfm.init_params(gen, cfg)
    f32 = tfm.Transformer(dataclasses.replace(cfg, dtype=torch.float32),
                          device=CPU)
    f32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    toks = torch.from_numpy(tokens_for(cfg, 2, 20, 3))
    hidden, _, _ = tfm.forward_hidden(model, toks, cfg)
    want, _, _ = tfm.forward_hidden(f32, toks, f32.cfg)
    assert hidden.dtype == torch.bfloat16 and hidden.shape == (2, 20, 64)
    assert torch.isfinite(hidden.float()).all()
    torch.testing.assert_close(hidden.float(), want, rtol=0.1, atol=0.1)


def test_converter_refuses_missing_extra_and_misshapen_leaves():
    params, _ = models(TINY_QKVBIAS)
    tree = numpy_tree(params)
    missing = dict(tree, layers={k: v for k, v in tree["layers"].items()
                                 if k != "ln2"})
    with pytest.raises(KeyError, match="ln2"):
        transformer_from_jax(missing, TINY_QKVBIAS, CPU)
    with pytest.raises(KeyError, match="bogus"):
        transformer_from_jax(dict(tree, bogus=np.zeros(3)), TINY_QKVBIAS, CPU)
    bias = dict(tree["layers"]["attn"]["wq"])
    bias.pop("b")
    nobias = dict(tree, layers=dict(tree["layers"], attn=dict(
        tree["layers"]["attn"], wq=bias)))
    with pytest.raises(KeyError, match="dense keys"):
        transformer_from_jax(nobias, TINY_QKVBIAS, CPU)
    with pytest.raises(ValueError, match="embed"):
        transformer_from_jax(dict(tree, embed=tree["embed"].T), TINY_QKVBIAS,
                             CPU)
    short = jax.tree.map(lambda a: a[:1], tree["layers"])
    with pytest.raises(ValueError, match="2 layers"):
        transformer_from_jax(dict(tree, layers=short), TINY_QKVBIAS, CPU)


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------


def repro_example(params, cfg):
    """``examples/lm_rerank.py``'s computation, in process."""
    M, S = 256, 16
    rng = np.random.default_rng(0)
    items = jnp.asarray(rng.integers(0, cfg.vocab, size=(M, S)), jnp.int32)
    hidden, _, _ = jtfm.forward_hidden(params, items, cfg)
    emb = np.array(hidden.mean(axis=1), np.float32)
    emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
    scores = emb @ emb[0]
    rr = JaxReranker(JaxRerankConfig(slate_size=10, shortlist=64, alpha=4.0))
    slate, _ = rr.rerank(JaxRequest(scores=jnp.asarray(scores),
                                    feats=jnp.asarray(emb)))
    slate = np.asarray(slate)
    top = jax_top_n_select(scores, 10)
    Ssim = emb @ emb.T
    return (emb, slate, top, jax_slate_diversity(slate, Ssim),
            jax_slate_diversity(top, Ssim))


def test_lm_rerank_example_gives_repros_slates(capsys):
    jc = jax_get_arch("qwen1.5-4b").reduced()
    cfg = get_arch("qwen1.5-4b").reduced()
    assert jax_cfg(cfg) == jc
    params = jtfm.init_params(jax.random.PRNGKey(0), jc)
    model = transformer_from_jax(numpy_tree(params), cfg, CPU)
    got = lm_rerank.main(device=CPU, model=model)
    emb, slate, top, div, top_div = repro_example(params, jc)
    close(got["emb"], emb)
    assert got["slate"].tolist() == slate.tolist()
    assert got["top"].tolist() == top.tolist()
    for key in ("avg", "min", "median"):
        np.testing.assert_allclose(got["diversity"][key], div[key],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["top_diversity"][key], top_div[key],
                                   rtol=1e-4, atol=1e-5)
    out = capsys.readouterr().out
    assert f"DPP slate: {slate.tolist()}" in out
    assert f"Top slate: {top.tolist()}" in out


def test_lm_rerank_refuses_a_non_lm_arch():
    with pytest.raises(ValueError, match="gnn"):
        lm_rerank.build_model("graphcast", True, CPU)
