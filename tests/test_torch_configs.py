"""The port's architecture registry (``repro_torch.configs``) against
``repro.configs``: all ten ids, every published and reduced config field
for field (dtypes mapped: ``jnp.bfloat16`` / ``jnp.float32`` to the torch
dtypes), the shape sets and the skips; and every reduced arch runs one
forward through the port on the CPU with finite outputs.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.configs import shapes as jax_shapes
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.data import batched_molecules, recsys_batches
from repro_torch.models import gnn, recsys, transformer as tfm

ALL_ARCHS = jax_configs.list_archs()
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def as_fields(cfg):
    """A config's fields as plain values, dtypes as torch dtypes and a
    nested MoE config as its own fields."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = (type(v).__name__, as_fields(v))
        elif f.name == "dtype":
            v = DTYPES.get(v, v)
        out[f.name] = v
    return out


def test_registry_answers_all_ten_ids():
    assert configs.list_archs() == ALL_ARCHS
    assert len(ALL_ARCHS) == 10
    for arch in ALL_ARCHS:
        spec = configs.get_arch(arch)
        assert spec.id == arch
        assert spec.family == jax_configs.get_arch(arch).family
    with pytest.raises(KeyError):
        configs.get_arch("nope")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_equal_repros_field_for_field(arch):
    spec, jspec = configs.get_arch(arch), jax_configs.get_arch(arch)
    assert type(spec.config).__name__ == type(jspec.config).__name__
    assert as_fields(spec.config) == as_fields(jspec.config)
    assert as_fields(spec.reduced()) == as_fields(jspec.reduced())
    assert spec.skips == jspec.skips
    assert sorted(spec.shapes) == sorted(jspec.shapes)
    assert sorted(spec.active_shapes()) == sorted(jspec.active_shapes())
    if spec.family != "recsys":
        assert spec.config.param_count() == jspec.config.param_count()
        assert spec.reduced().param_count() == jspec.reduced().param_count()


@pytest.mark.parametrize("family", ["LM_SHAPES", "GNN_SHAPES",
                                    "RECSYS_SHAPES"])
def test_shape_sets_equal_repros(family):
    got, want = getattr(shapes, family), getattr(jax_shapes, family)
    assert list(got) == list(want)
    for name in got:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(
            want[name])


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_reduced_arch_runs_one_port_forward(arch):
    spec = configs.get_arch(arch)
    cfg = spec.reduced()
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        if spec.family == "lm":
            model = tfm.init_params(gen, cfg)
            toks = torch.from_numpy(np.random.default_rng(1).integers(
                0, cfg.vocab, size=(2, 24)))
            hidden, aux, _ = tfm.forward_hidden(model, toks, cfg)
            assert hidden.shape == (2, 24, cfg.d_model)
            out = tfm.logits_from_hidden(model, hidden)
            assert torch.isfinite(aux)
        elif spec.family == "recsys":
            model = recsys.init_params(gen, cfg)
            batch = next(recsys_batches(cfg.vocab_sizes, batch=32, seed=0))
            out = recsys.forward_logits(model, torch.from_numpy(
                batch["ids"]), cfg)
            assert out.shape == (32,)
        else:
            model = gnn.init_params(gen, cfg)
            batch = batched_molecules(4, 10, 20, cfg.d_feat, cfg.n_vars,
                                      seed=0)
            out = gnn.apply(model, torch.from_numpy(batch["node_feats"]),
                            torch.from_numpy(batch["edges"]), cfg)
            assert out.shape == (40, cfg.n_vars)
    assert torch.isfinite(out.float()).all()
