"""The port's remat (``repro_torch.models.layers.remat``): every LM block,
every attention chunk under ``remat_chunks`` and every GNN processor
layer recompute on the backward pass, as ``repro``'s ``jax.checkpoint``
does, on the CPU.

* ``remat_chunks=True`` against ``repro``'s ``value_and_grad(train_loss)``
  with the same flag, at ``test_train_loss_and_grads_match_repro``'s
  tolerances (rtol 1e-4 / atol 1e-5: float32 products in another order);
* the loss and every gradient with ``remat`` patched to a plain call,
  with block remat and with block plus chunk remat: equal bit for bit
  (the recompute runs the same ops on the same inputs);
* remat takes effect: the bytes that ``saved_tensors_hooks`` sees saved
  (the parameters' storage left out) are each block's (layer's) inputs
  and the head's, and without remat they exceed that bound;
* paths that take no gradient never reach ``torch.utils.checkpoint``,
  and ``prefill`` / ``decode_step`` give the same bits either way.
"""
import contextlib
import contextvars
import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtfm
from repro_torch import data
from repro_torch.models import gnn
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import transformer_from_jax
from tests.test_torch_models_lm import ALL as LM_CONFIGS
from tests.test_torch_models_lm import jax_cfg as lm_jax_cfg
from tests.test_torch_train import (
    hold_grads,
    jax_init,
    numpy_tree,
    value_and_grad,
)
from tests.test_torch_train import close as train_close

B, S = 2, 40  # chunk_q 16: chunks of 16, 16 and a ragged 8
GNN_TINY = gnn.GNNConfig(name="tiny-gnn", n_layers=2, d_hidden=16, d_feat=8,
                         n_vars=3, d_edge=4, dtype=torch.float32)
ids = lambda c: c.name


@contextlib.contextmanager
def no_remat():
    """``layers.remat`` patched to a plain call: the un-checkpointed graph
    (the blocks', the chunks' and the GNN layers' alike)."""
    old = L.remat
    L.remat = lambda fn, *args: fn(*args)
    try:
        yield
    finally:
        L.remat = old


def saved_bytes(fn):
    """(bytes of the tensors autograd saves while ``fn()`` runs, leaving
    out parameters, the shapes saved, ``fn()``)."""
    total, shapes = [0], []

    def pack(t):
        if not isinstance(t, torch.nn.Parameter):
            total[0] += t.numel() * t.element_size()
            shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return total[0], shapes, out


def lm_tokens(cfg, seed=1, S_=S):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S_)))


def grads_of(loss, module):
    """(loss, each parameter's gradient) through ``torch.autograd.grad``,
    as ``launch.train.make_step`` takes them."""
    return loss, torch.autograd.grad(loss, list(module.parameters()),
                                     allow_unused=True)


def assert_bitwise(got, want, what):
    (lg, gg), (lw, gw) = got, want
    assert torch.equal(lg, lw), f"{what}: loss {lg} vs {lw}"
    assert len(gg) == len(gw)
    for i, (a, b) in enumerate(zip(gg, gw)):
        assert (a is None) == (b is None), (what, i)
        assert a is None or torch.equal(a, b), f"{what}: gradient {i}"


# ---------------------------------------------------------------------------
# chunk remat against repro
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", LM_CONFIGS, ids=ids)
def test_chunk_remat_loss_and_grads_match_repro(cfg):
    cfg = dataclasses.replace(cfg, remat_chunks=True)
    assert S > cfg.chunk_q and S % cfg.chunk_q  # chunked, a ragged tail
    jc = lm_jax_cfg(cfg)
    assert jc.remat_chunks
    params = jax_init(jtfm, jc)
    model = transformer_from_jax(numpy_tree(params), cfg, "cpu")
    tokens = lm_tokens(cfg).numpy()
    loss, grads = value_and_grad(jtfm.train_loss)(
        params, {"tokens": jnp.asarray(tokens, jnp.int32)}, jc)
    got = tfm.train_loss(model, {"tokens": torch.from_numpy(tokens)}, cfg)
    got.backward()
    train_close(got, loss)
    hold_grads(model, transformer_from_jax(numpy_tree(grads), cfg, "cpu"))


# ---------------------------------------------------------------------------
# bit for bit against the un-checkpointed graph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", LM_CONFIGS, ids=ids)
def test_lm_remat_is_the_plain_graph_bit_for_bit(cfg):
    model = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    batch = {"tokens": lm_tokens(cfg)}
    loss_of = lambda rc: grads_of(tfm.train_loss(
        model, batch, dataclasses.replace(cfg, remat_chunks=rc)), model)
    with no_remat():
        plain = loss_of(False)
    assert_bitwise(loss_of(False), plain, f"{cfg.name} block remat")
    assert_bitwise(loss_of(True), plain, f"{cfg.name} block + chunk remat")


def gnn_batch(edge_mask=True, seed=3):
    g = data.random_graph(60, 240, GNN_TINY.d_feat, GNN_TINY.n_vars,
                          seed=seed)
    b = {"node_feats": torch.from_numpy(g.node_feats),
         "edges": torch.from_numpy(g.edges),
         "targets": torch.from_numpy(g.targets)}
    if edge_mask:
        b["edge_mask"] = torch.from_numpy(
            np.random.default_rng(4).uniform(size=240) < 0.8)
    return b


@pytest.mark.parametrize("aggregator", ["sum", "mean"])
def test_gnn_remat_is_the_plain_graph_bit_for_bit(aggregator):
    cfg = dataclasses.replace(GNN_TINY, aggregator=aggregator)
    model = gnn.init_params(torch.Generator().manual_seed(0), cfg)
    b = gnn_batch()
    with no_remat():
        plain = grads_of(gnn.mse_loss(model, b, cfg), model)
    assert_bitwise(grads_of(gnn.mse_loss(model, b, cfg), model), plain,
                   f"gnn {aggregator} layer remat")


# ---------------------------------------------------------------------------
# remat takes effect: what the backward keeps
# ---------------------------------------------------------------------------


def lm_bound(cfg, n_layers):
    """What a checkpointed LM may keep, in bytes: each block's input
    (B, S, d) and the head's float32 tensors, at most 8 of (B, S, d)
    (``ln_f``, the unembed's input) and 3 of (B, S, vocab) (the logits,
    their ``logsumexp`` and its gradient's input)."""
    item = torch.tensor([], dtype=cfg.dtype).element_size()
    return (n_layers * B * S * cfg.d_model * item
            + 4 * B * S * (8 * cfg.d_model + 3 * cfg.vocab))


@pytest.mark.parametrize("cfg", LM_CONFIGS, ids=ids)
def test_lm_remat_keeps_only_each_blocks_input(cfg):
    model = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    batch = {"tokens": lm_tokens(cfg)}
    deeper_cfg = dataclasses.replace(cfg, n_layers=2 * cfg.n_layers,
                                     remat_chunks=True)
    deeper = tfm.init_params(torch.Generator().manual_seed(0), deeper_cfg)
    loss = lambda m, c: lambda: tfm.train_loss(m, batch, c)
    kept, _, _ = saved_bytes(loss(model, cfg))
    kept_deeper, _, _ = saved_bytes(loss(deeper, deeper_cfg))
    with no_remat():
        plain, _, _ = saved_bytes(loss(model, cfg))
    item = torch.tensor([], dtype=cfg.dtype).element_size()
    # each block added keeps exactly its input x (B, S, d)
    assert kept_deeper - kept == cfg.n_layers * B * S * cfg.d_model * item
    assert kept <= lm_bound(cfg, cfg.n_layers) < plain, (kept, plain)


def test_gnn_remat_keeps_only_each_layers_inputs():
    b = gnn_batch()
    N, E = b["node_feats"].shape[0], b["edges"].shape[0]
    per_layer = 4 * (N * GNN_TINY.d_hidden + E * GNN_TINY.d_edge)  # h, e
    kept = {}
    for n_layers in (2, 4):
        cfg = dataclasses.replace(GNN_TINY, n_layers=n_layers)
        model = gnn.init_params(torch.Generator().manual_seed(0), cfg)
        kept[n_layers], _, _ = saved_bytes(
            lambda: gnn.mse_loss(model, b, cfg))
        with no_remat():
            plain, _, _ = saved_bytes(lambda: gnn.mse_loss(model, b, cfg))
        assert plain - kept[n_layers] > 2 * n_layers * per_layer
    assert kept[4] - kept[2] == 2 * per_layer


@pytest.mark.parametrize("window", [None, 12])
def test_attention_chunk_remat_keeps_no_scores(window):
    rng = np.random.default_rng(0)
    H, KV, dh, chunk = 4, 2, 8, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (B, S, h, dh)).astype(np.float32)).requires_grad_()
        for h in (H, KV, KV))
    run = lambda rc: lambda: L.gqa_attention(
        q, k, v, window=window, chunk_q=chunk, remat_chunks=rc)
    n_chunks = -(-S // chunk)
    scores = lambda shapes: sum(s[-2:] == (chunk, S) for s in shapes)
    plain, plain_shapes, want = saved_bytes(run(False))
    kept, kept_shapes, got = saved_bytes(run(True))
    assert torch.equal(got, want)
    assert scores(plain_shapes) >= n_chunks
    assert scores(kept_shapes) == 0
    # what the chunks keep is their inputs, smaller than one chunk's scores
    assert kept < plain and kept < n_chunks * 4 * B * H * chunk * S
    g_plain = torch.autograd.grad(want.square().sum(), (q, k, v))
    g_kept = torch.autograd.grad(got.square().sum(), (q, k, v))
    assert all(torch.equal(a, b) for a, b in zip(g_kept, g_plain))


# ---------------------------------------------------------------------------
# paths without gradients, and the recompute's context
# ---------------------------------------------------------------------------


def prefill_decode(model, cfg, toks, S0):
    logits, cache = tfm.prefill(model, toks[:, :S0], cfg, 64)
    outs = [logits]
    for t in range(S0, toks.shape[1]):
        logits, cache = tfm.decode_step(model, cache, toks[:, t:t + 1], cfg)
        outs.append(logits)
    return outs + [g[kv] for g in cache["groups"].values()
                   for kv in ("k", "v")]


@pytest.mark.parametrize("cfg", LM_CONFIGS, ids=ids)
def test_no_grad_paths_never_checkpoint_and_keep_their_bits(cfg,
                                                            monkeypatch):
    cfg = dataclasses.replace(cfg, remat_chunks=True)
    model = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    toks = lm_tokens(cfg, seed=2, S_=S + 3)
    with no_remat():
        want = prefill_decode(model, cfg, toks, S)
    with torch.no_grad():
        plain_hidden = tfm.forward_hidden(model, toks, cfg)[0]
    got_grad = prefill_decode(model, cfg, toks, S)  # checkpointed blocks

    def refuse(*a, **kw):
        raise AssertionError("torch.utils.checkpoint called without grad")

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", refuse)
    with torch.no_grad():
        got_no_grad = prefill_decode(model, cfg, toks, S)
        hidden = tfm.forward_hidden(model, toks, cfg)[0]
    with torch.inference_mode():
        got_inf = prefill_decode(model, cfg, toks, S)
    with pytest.raises(AssertionError, match="without grad"):
        tfm.train_loss(model, {"tokens": toks}, cfg)  # grad on: it runs
    assert torch.equal(hidden, plain_hidden)
    for got in (got_grad, got_no_grad, got_inf):
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_recompute_runs_in_the_forwards_context():
    """The autograd engine may run the recompute on another thread (the
    card's); it sees the context variables (axis rules, mesh) that the
    forward saw."""
    var = contextvars.ContextVar("probe", default=None)
    seen = []

    def fn(x):
        seen.append(var.get())
        return (x * x).sum()

    x = torch.ones(3, requires_grad=True)
    token = var.set("installed")
    y = L.remat(fn, x)
    var.reset(token)
    t = threading.Thread(target=y.backward)
    t.start()
    t.join()
    assert seen == ["installed", "installed"]
    assert torch.equal(x.grad, torch.full((3,), 2.0))
