"""Carry a ``repro`` recsys parameter tree across to the port.

``params_from_jax(tree, cfg, device)`` takes the tree as numpy arrays
(``jax.tree.map(np.asarray, params)``; this module imports no JAX) and
fills a ``RecsysModel`` with it:

  table, wide, bias          -> the same-named parameters
  mlp.layers[i].{w, b}       -> model.mlp.layers[i] (nn.Linear)
  cin[i], cin_out.{w, b}     -> model.cin[i], model.cin_out
  attn[i].{wq, wk, wv, wr}.w -> model.attn[i][...] (nn.Linear, no bias)
  attn_out.{w, b}            -> model.attn_out

``repro``'s dense weight is ``(d_in, d_out)``, applied as ``x @ w``;
``nn.Linear`` stores ``(d_out, d_in)``, so every dense weight is
transposed.  Every array must match its parameter's shape exactly, and
every leaf of the tree must be used.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models.recsys import RecsysConfig, RecsysModel


def _set(param: torch.Tensor, value, name: str) -> None:
    value = torch.tensor(np.asarray(value))
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(
            f"{name}: array of shape {tuple(value.shape)} for a parameter of "
            f"shape {tuple(param.shape)}"
        )
    param.copy_(value.to(dtype=param.dtype, device=param.device))


def _set_dense(lin: nn.Linear, p: dict, name: str) -> None:
    if set(p) != ({"w", "b"} if lin.bias is not None else {"w"}):
        raise KeyError(f"{name}: unexpected dense keys {sorted(p)}")
    _set(lin.weight, np.asarray(p["w"]).T, f"{name}.w")
    if lin.bias is not None:
        _set(lin.bias, p["b"], f"{name}.b")


def params_from_jax(tree: dict, cfg: RecsysConfig, device=None) -> RecsysModel:
    """``repro``'s recsys parameter tree (numpy leaves) -> the port's
    ``RecsysModel`` on ``device`` (default the card)."""
    model = RecsysModel(cfg, device=device)
    want = {"table", "wide", "bias"}
    if model.mlp is not None:
        want.add("mlp")
    if cfg.interaction == "cin":
        want |= {"cin", "cin_out"}
    if cfg.interaction == "self-attn":
        want |= {"attn", "attn_out"}
    if set(tree) != want:
        raise KeyError(f"parameter tree has keys {sorted(tree)}, the "
                       f"{cfg.interaction} config needs {sorted(want)}")
    with torch.no_grad():
        for name in ("table", "wide", "bias"):
            _set(getattr(model, name), tree[name], name)
        if model.mlp is not None:
            layers = tree["mlp"]["layers"]
            if len(layers) != len(model.mlp.layers):
                raise ValueError(f"mlp: {len(layers)} layers for "
                                 f"{len(model.mlp.layers)}")
            for i, (lin, p) in enumerate(zip(model.mlp.layers, layers)):
                _set_dense(lin, p, f"mlp.layers[{i}]")
        if cfg.interaction == "cin":
            if len(tree["cin"]) != len(model.cin):
                raise ValueError(f"cin: {len(tree['cin'])} layers for "
                                 f"{len(model.cin)}")
            for i, (w, p) in enumerate(zip(model.cin, tree["cin"])):
                _set(w, p, f"cin[{i}]")
            _set_dense(model.cin_out, tree["cin_out"], "cin_out")
        if cfg.interaction == "self-attn":
            if len(tree["attn"]) != len(model.attn):
                raise ValueError(f"attn: {len(tree['attn'])} layers for "
                                 f"{len(model.attn)}")
            for i, (layer, p) in enumerate(zip(model.attn, tree["attn"])):
                if set(p) != set(layer):
                    raise KeyError(f"attn[{i}]: keys {sorted(p)}")
                for key in layer:
                    _set_dense(layer[key], p[key], f"attn[{i}].{key}")
            _set_dense(model.attn_out, tree["attn_out"], "attn_out")
    return model
