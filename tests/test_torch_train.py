"""Parity of the port's training slice (the three losses, ``launch.train``'s
``make_step`` and its restart) with ``repro``'s, on the CPU.

``repro``'s parameters cross through ``params_from_jax``,
``transformer_from_jax`` and ``gnn_from_jax``; a ``jax.grad`` tree (and
an AdamW moment tree) crosses through the same converter into a second
module, whose parameters are held against the port's ``.grad`` (and
moments) name for name.  The inputs are the same numpy arrays.
Tolerances, with their reasons:

* losses and gradients, float32: rtol 1e-4 / atol 1e-5 (float32 matrix
  products, scatter sums and the FM sums in another order);
* 20 training steps of reduced DeepFM: loss and ``grad_norm`` per step,
  the parameters and both moments at the end, rtol 1e-4 / atol 1e-5;
* with ``int8_ef``, 10 steps at rtol 1e-3 / atol 1e-5: a gradient an ulp
  apart can put ``x / scale`` on the other side of a half, and one
  quantum of difference then enters the moments.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch import train as jax_train
from repro.models import gnn as jgnn
from repro.models import moe as jmoe
from repro.models import recsys as jax_recsys
from repro.models import transformer as jtfm
from repro.optim import (
    AdamWConfig as JaxAdamWConfig,
    adamw_init as jax_adamw_init,
    adamw_update as jax_adamw_update,
    cosine_warmup as jax_cosine_warmup,
    ef_compress_grads as jax_ef_compress,
    ef_init as jax_ef_init,
)
from repro_torch import data
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import get_arch
from repro_torch.launch import train
from repro_torch.models import gnn, moe, params_from_jax, recsys
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import gnn_from_jax, transformer_from_jax
from repro_torch.optim import AdamWConfig, adamw_init, ef_init
from tests.test_torch_models_gnn import jax_cfg as gnn_jax_cfg
from tests.test_torch_models_lm import ALL as LM_CONFIGS
from tests.test_torch_models_lm import jax_cfg as lm_jax_cfg
from tests.test_torch_recsys import ARCHS, port_cfg

RTOL, ATOL = 1e-4, 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
numpy_tree = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float32),
                                       tree)


def value_and_grad(loss_fn):
    """``jax.value_and_grad(loss_fn)`` jitted, the config static (one
    compile instead of an eager op-by-op trace)."""
    return jax.jit(jax.value_and_grad(loss_fn), static_argnums=2)


def jax_init(module, cfg, seed=0):
    """``module.init_params`` jitted (faster than its eager trace)."""
    return jax.jit(module.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg)


def close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                   np.float32),
        np.asarray(want, np.float32), rtol=rtol, atol=atol, err_msg=what)


def hold_grads(model, want_module, rtol=RTOL, atol=ATOL):
    """Each parameter's ``.grad`` against ``want_module``'s same-named
    parameter (a ``jax.grad`` tree carried through the converter)."""
    want = dict(want_module.named_parameters())
    got = dict(model.named_parameters())
    assert list(got) == list(want)
    for name, p in got.items():
        assert p.grad is not None, name
        close(p.grad, want[name].detach(), rtol, atol, name)


# ---------------------------------------------------------------------------
# the three losses and their gradients
# ---------------------------------------------------------------------------


def _recsys_case(jcfg, batch, seed, hot=1):
    params = jax_init(jax_recsys, jcfg, seed)
    cfg = port_cfg(jcfg)
    model = params_from_jax(numpy_tree(params), cfg, device="cpu")
    b = next(data.recsys_batches(jcfg.vocab_sizes, batch, hot=hot,
                                 seed=seed))
    loss, grads = value_and_grad(jax_recsys.bce_loss)(
        params, {k: jnp.asarray(v) for k, v in b.items()}, jcfg)
    got = recsys.bce_loss(model, {k: torch.from_numpy(v)
                                  for k, v in b.items()}, cfg)
    got.backward()
    assert got.dtype == torch.float32 and got.shape == ()
    close(got, loss)
    hold_grads(model, params_from_jax(numpy_tree(grads), cfg, device="cpu"))


@pytest.mark.parametrize("hot", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_bce_loss_and_grads_match_repro_reduced(arch, hot):
    _recsys_case(jax_get_arch(arch).reduced(), 64, seed=hot, hot=hot)


def test_bce_loss_and_grads_match_repro_deepfm_full_widths():
    """DeepFM's published widths (39 fields, embed 10, MLP 400-400-400)
    with small vocabularies, as ``test_deepfm_full_widths_small_vocabs``."""
    full = jax_get_arch("deepfm").config
    vocabs = tuple(int(v) for v in
                   np.random.default_rng(5).integers(20, 300, size=39))
    jcfg = jax_recsys.RecsysConfig(
        name="deepfm-small-vocab", vocab_sizes=vocabs,
        embed_dim=full.embed_dim, interaction="fm", mlp_dims=full.mlp_dims)
    _recsys_case(jcfg, 96, seed=1)


def test_table_gradient_is_dense():
    """Rows no example touched get an explicit zero gradient (a dense
    ``.grad``, as ``jax.grad`` gives through the gather), so AdamW still
    decays them."""
    cfg = get_arch("deepfm").reduced()
    model = recsys.init_params(torch.Generator().manual_seed(0), cfg)
    b = next(data.recsys_batches(cfg.vocab_sizes, 4, seed=0))
    recsys.bce_loss(model, {k: torch.from_numpy(v) for k, v in b.items()},
                    cfg).backward()
    assert model.table.grad.layout == torch.strided
    assert model.table.grad.shape == model.table.shape
    assert int((model.table.grad.abs().sum(1) == 0).sum()) > 0


TINY_MOE_DROPS = dataclasses.replace(
    LM_CONFIGS[3], name="tiny-moe-drops",
    moe=moe.MoEConfig(n_experts=4, top_k=2, d_ff=48, capacity_factor=0.25))


@pytest.mark.parametrize("cfg", LM_CONFIGS + [TINY_MOE_DROPS],
                         ids=lambda c: c.name)
def test_train_loss_and_grads_match_repro(cfg):
    jc = lm_jax_cfg(cfg)
    params = jax_init(jtfm, jc)
    model = transformer_from_jax(numpy_tree(params), cfg, "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 24))
    if cfg.moe is not None and cfg.moe.capacity_factor < 1:
        T = tokens.size
        assert moe.capacity(cfg.moe, T) * cfg.moe.n_experts \
            < T * cfg.moe.top_k  # slots drop
    loss, grads = value_and_grad(jtfm.train_loss)(
        params, {"tokens": jnp.asarray(tokens, jnp.int32)}, jc)
    got = tfm.train_loss(model, {"tokens": torch.from_numpy(tokens)}, cfg)
    got.backward()
    close(got, loss)
    hold_grads(model, transformer_from_jax(numpy_tree(grads), cfg, "cpu"))


def test_train_loss_adds_the_summed_aux_loss():
    cfg = LM_CONFIGS[3]  # tiny-moe
    model = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(2, 16)))
    with torch.no_grad():
        hidden, aux, _ = tfm.forward_hidden(model, toks, cfg)
        ce = torch.nn.functional.cross_entropy(
            tfm.logits_from_hidden(model, hidden[:, :-1]).reshape(
                -1, cfg.vocab), toks[:, 1:].reshape(-1))
        got = tfm.train_loss(model, {"tokens": toks}, cfg)
    assert float(aux) > 0
    close(got, ce + cfg.aux_loss_coef * aux, rtol=1e-5, atol=1e-6)


GNN_TINY = gnn.GNNConfig(name="tiny-gnn", n_layers=2, d_hidden=16, d_feat=8,
                         n_vars=3, d_edge=4, dtype=torch.float32)


@pytest.mark.parametrize("masks", ["none", "node", "edge", "both"])
@pytest.mark.parametrize("aggregator", ["sum", "mean"])
def test_mse_loss_and_grads_match_repro(aggregator, masks):
    cfg = dataclasses.replace(GNN_TINY, aggregator=aggregator)
    jc = gnn_jax_cfg(cfg)
    g = data.random_graph(60, 240, cfg.d_feat, cfg.n_vars, seed=3)
    rng = np.random.default_rng(4)
    b = {"node_feats": g.node_feats, "edges": g.edges, "targets": g.targets}
    if masks in ("node", "both"):
        b["node_mask"] = rng.uniform(size=60) < 0.7
    if masks in ("edge", "both"):
        b["edge_mask"] = rng.uniform(size=240) < 0.8
    params = jax_init(jgnn, jc)
    model = gnn_from_jax(numpy_tree(params), cfg, "cpu")
    loss, grads = value_and_grad(jgnn.mse_loss)(
        params, {k: jnp.asarray(v) for k, v in b.items()}, jc)
    got = gnn.mse_loss(model, {k: torch.from_numpy(v) for k, v in b.items()},
                       cfg)
    got.backward()
    close(got, loss)
    hold_grads(model, gnn_from_jax(numpy_tree(grads), cfg, "cpu"))


# ---------------------------------------------------------------------------
# the slice as a whole: make_step against repro's step
# ---------------------------------------------------------------------------


def jax_step(loss_fn, acfg, warmup, total, use_compression):
    """``repro``'s step, built from its public functions as its
    ``launch/train.py`` builds it."""

    @jax.jit
    def step_fn(params, opt, ef_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        if use_compression:
            grads, ef_state = jax_ef_compress(grads, ef_state)
        lr_scale = jax_cosine_warmup(opt["step"], warmup=warmup, total=total)
        params, opt, metrics = jax_adamw_update(params, grads, opt, acfg,
                                                lr_scale)
        return params, opt, ef_state, {"loss": loss, **metrics}

    return step_fn


@pytest.mark.parametrize("compression,steps,rtol", [
    ("none", 20, RTOL), ("int8_ef", 10, 1e-3)])
def test_make_step_matches_repro_step(compression, steps, rtol):
    jcfg = jax_get_arch("deepfm").reduced()
    cfg = get_arch("deepfm").reduced()
    kw = dict(lr=1e-3)
    warmup, use = 5, compression == "int8_ef"
    params = jax_init(jax_recsys, jcfg)
    model = params_from_jax(numpy_tree(params), cfg, device="cpu")
    jstep = jax_step(lambda p, b: jax_recsys.bce_loss(p, b, jcfg),
                     JaxAdamWConfig(**kw), warmup, steps, use)
    step = train.make_step(lambda m, b: recsys.bce_loss(m, b, cfg),
                           AdamWConfig(**kw), warmup, steps, compression)
    jopt, opt = jax_adamw_init(params), adamw_init(
        dict(model.named_parameters()))
    jef = jax_ef_init(params) if use else None
    ef = ef_init(dict(model.named_parameters())) if use else None
    batches = data.recsys_batches(cfg.vocab_sizes, 64, seed=0)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    for s in range(steps):
        b = next(batches)
        params, jopt, jef, jm = jstep(params, jopt, jef,
                                      {k: jnp.asarray(v) for k, v in b.items()})
        model, opt, ef, m = step(model, opt, ef,
                                 {k: torch.from_numpy(v) for k, v in b.items()})
        close(m["loss"], jm["loss"], rtol, ATOL, f"loss at step {s}")
        close(m["grad_norm"], jm["grad_norm"], rtol, ATOL,
              f"grad_norm at step {s}")
        if s == 0:  # lr 0 at the first update: the parameters stay put
            for n, p in model.named_parameters():
                assert torch.equal(p.detach(), init[n]), n
    assert int(opt["step"]) == int(jopt["step"]) == steps
    want = params_from_jax(numpy_tree(params), cfg, device="cpu")
    for n, p in model.named_parameters():
        close(p, dict(want.named_parameters())[n].detach(), rtol, ATOL, n)
    for key in ("m", "v"):
        wm = dict(params_from_jax(numpy_tree(jopt[key]), cfg,
                                  device="cpu").named_parameters())
        for n, t in opt[key].items():
            close(t, wm[n].detach(), rtol, ATOL, f"{key} {n}")


# ---------------------------------------------------------------------------
# the restart through the entry point
# ---------------------------------------------------------------------------

FLAGS = ["--arch", "deepfm", "--reduced", "--steps", "40", "--batch", "64",
         "--ckpt-every", "10", "--log-every", "100"]


def _layout(d):
    return {s: sorted(os.listdir(os.path.join(d, s)))
            for s in sorted(os.listdir(d))}


def _repro_run(ckpt, extra):
    """``repro``'s trainer in this process, with the same flags."""
    try:
        return jax_train.main(FLAGS + ["--ckpt-dir", ckpt] + extra)
    except RuntimeError as e:
        assert "injected failure at step 25" in str(e)
        return None


def test_restart_after_injected_failure(tmp_path):
    """``python -m repro_torch.launch.train`` fails at step 25, resumes
    from step 20 and finishes, as ``repro``'s
    ``test_train_restart_after_injected_failure`` checks its own; the
    step directories, their files and the summary's keys equal those of
    ``repro``'s run with the same flags."""
    ckpt, jckpt = str(tmp_path / "ck"), str(tmp_path / "jck")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu"] + FLAGS + ["--ckpt-dir", ckpt]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r1 = subprocess.run(base + ["--fail-at-step", "25"], capture_output=True,
                        text=True, env=env, cwd=REPO, timeout=300)
    assert r1.returncode != 0 and "injected failure" in r1.stderr
    assert _repro_run(jckpt, ["--fail-at-step", "25"]) is None
    assert _layout(ckpt) == _layout(jckpt) == {
        "step_00000010": ["arrays.p0.npz", "meta.json"],
        "step_00000020": ["arrays.p0.npz", "meta.json"]}
    r2 = subprocess.run(base + ["--resume", "auto"], capture_output=True,
                        text=True, env=env, cwd=REPO, timeout=300)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed from step 20" in r2.stdout
    summary = json.loads(r2.stdout.strip().splitlines()[-1])
    assert summary["steps_run"] == 20  # 40 total - 20 resumed
    assert np.isfinite(summary["last_loss"])
    jsummary = _repro_run(jckpt, ["--resume", "auto"])
    assert list(summary) == list(jsummary)
    assert _layout(ckpt) == _layout(jckpt)
    assert sorted(_layout(ckpt)) == ["step_00000020", "step_00000030",
                                     "step_00000040"]
    meta = json.load(open(os.path.join(ckpt, "step_00000040", "meta.json")))
    jmeta = json.load(open(os.path.join(jckpt, "step_00000040", "meta.json")))
    assert meta["step"] == jmeta["step"] == 40
    assert set(meta["dtypes"].values()) == set(jmeta["dtypes"].values())
    assert len(meta["names"]) == len(jmeta["names"])


def _final(ckpt, model_tree):
    return restore_checkpoint(ckpt, model_tree)[1]


def test_resume_replays_the_data_stream(tmp_path):
    """``repro``'s defect, reproduced as it is (ROADMAP queue 3): a
    resumed run draws the data stream again from batch 0 and drops the
    error-feedback residual, so it does not equal an uninterrupted run;
    it equals the restored state trained on batches 0, 1, ... instead."""
    base = ["--device", "cpu"] + FLAGS
    whole, cut = str(tmp_path / "whole"), str(tmp_path / "cut")
    train.main(base + ["--ckpt-dir", whole])
    with pytest.raises(RuntimeError, match="injected failure at step 25"):
        train.main(base + ["--ckpt-dir", cut, "--fail-at-step", "25"])
    train.main(base + ["--ckpt-dir", cut, "--resume", "auto"])

    cfg = get_arch("deepfm").reduced()
    model = recsys.init_params(torch.Generator().manual_seed(0), cfg)
    params = dict(model.named_parameters())
    skel = {"params": params, "opt": adamw_init(params)}
    start, state = restore_checkpoint(cut, skel, step=20)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(state["params"][n])
    opt = state["opt"]
    step = train.make_step(lambda m, b: recsys.bce_loss(m, b, cfg),
                           AdamWConfig(lr=3e-4), 20, 40)
    batches = data.recsys_batches(cfg.vocab_sizes, 64, seed=0)
    for _ in range(start, 40):
        b = {k: torch.from_numpy(v) for k, v in next(batches).items()}
        model, opt, _, _ = step(model, opt, None, b)
    got, ref = _final(cut, skel), _final(whole, skel)
    replayed = {n: p.detach() for n, p in params.items()}
    for n in params:
        close(got["params"][n], replayed[n], 1e-6, 1e-7, n)
    assert any(not torch.allclose(got["params"][n], ref["params"][n],
                                  rtol=1e-4, atol=1e-6) for n in params)
