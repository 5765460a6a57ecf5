"""Carry a ``repro`` parameter tree across to the port.

Each converter takes the tree as numpy arrays (``jax.tree.map(np.asarray,
params)``; this module imports no JAX) and fills the port's module with
it on ``device`` (default the card).

``params_from_jax(tree, cfg, device)`` fills a ``RecsysModel``:

  table, wide, bias          -> the same-named parameters
  mlp.layers[i].{w, b}       -> model.mlp.layers[i] (nn.Linear)
  cin[i], cin_out.{w, b}     -> model.cin[i], model.cin_out
  attn[i].{wq, wk, wv, wr}.w -> model.attn[i][...] (nn.Linear, no bias)
  attn_out.{w, b}            -> model.attn_out

``transformer_from_jax(tree, cfg, device)`` fills a ``Transformer`` and
``gnn_from_jax(tree, cfg, device)`` a ``GNN``, key for key by the
modules' own names (``embed``, ``layers``, ``ln_f``, ``unembed``;
``encoder``, ``edge_embed``, ``processor``, ``decoder``).  ``repro``
stacks the per-layer leaves of ``layers`` and ``processor`` as ``(L,
...)`` (its ``vmap`` init); they are unstacked into the ``ModuleList``,
every leaf's leading dimension checked against the layer count.

``repro_leaves(model)`` names, for each of the port's parameters, the
leaf of ``repro``'s tree it is filled from: its ``/``-joined path (a
stacked ``layers/...`` leaf once for every layer), whether the
parameter is that leaf transposed (an ``nn.Linear`` weight) and whether
it is one layer of a stacked leaf.  The dry run keys ``repro``'s
sharding rules by it (``repro_torch.launch.shardings``).

On a mesh, a model converted on the CPU goes through
``place_on_mesh(model, mesh, rules, device)``, which keeps this rank's
block of each leaf ``repro`` shards (the tables' rows under the rules'
``"rows"`` entry, the MoE experts' ``wi``, ``wg``, ``wo`` under
``"experts"``) and whole copies of the rest on ``device``, so no rank's
device ever holds a whole table.

``repro``'s dense weight is ``(d_in, d_out)``, applied as ``x @ w``;
``nn.Linear`` stores ``(d_out, d_in)``, so every dense weight is
transposed into its ``nn.Linear``.  The MoE experts' ``wi``, ``wg``,
``wo`` (E, d_in, d_out), the embedding ``(vocab, d)`` and ``unembed``
``(d, vocab)`` keep ``repro``'s layout.  Every array must match its
parameter's shape exactly, and every leaf of the tree must be used.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.distributed.context import ModelMesh, local_block
from repro_torch.models.gnn import GNN, GNNConfig
from repro_torch.models.moe import MoE
from repro_torch.models.recsys import RecsysConfig, RecsysModel
from repro_torch.models.transformer import Transformer, TransformerConfig


def _set(param: torch.Tensor, value, name: str) -> None:
    value = np.asarray(value)
    if value.dtype.name == "bfloat16":  # ml_dtypes: torch cannot wrap it
        value = value.astype(np.float32)
    value = torch.tensor(value)
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


def _fill(mod: nn.Module, tree: dict, name: str) -> None:
    """``mod``'s parameters from ``tree``, key for key by the module's
    own names; a ``ModuleList`` takes a stacked ``(L, ...)`` subtree."""
    if isinstance(mod, nn.Linear):
        _set_dense(mod, tree, name)
        return
    params = dict(mod.named_parameters(recurse=False))
    children = dict(mod.named_children())
    if not isinstance(tree, dict) or set(tree) != set(params) | set(children):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise KeyError(f"{name}: parameter tree has keys {got}, the module "
                       f"needs {sorted(set(params) | set(children))}")
    for key, prm in params.items():
        _set(prm, tree[key], f"{name}.{key}")
    for key, child in children.items():
        if isinstance(child, nn.ModuleList):
            _fill_stacked(child, tree[key], f"{name}.{key}")
        else:
            _fill(child, tree[key], f"{name}.{key}")


def _leaves(tree, name: str):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, f"{name}.{key}")
    else:
        yield name, np.asarray(tree)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {key: _index(sub, i) for key, sub in tree.items()}
    return np.asarray(tree)[i]


def _fill_stacked(layers: nn.ModuleList, tree: dict, name: str) -> None:
    """Unstack ``repro``'s ``(L, ...)`` layer leaves into ``layers``."""
    for leaf, arr in _leaves(tree, name):
        if arr.ndim == 0 or arr.shape[0] != len(layers):
            raise ValueError(f"{leaf}: stacked array of shape {arr.shape} "
                             f"for {len(layers)} layers")
    for i, layer in enumerate(layers):
        _fill(layer, _index(tree, i), f"{name}[{i}]")


def transformer_from_jax(tree: dict, cfg: TransformerConfig,
                         device=None) -> Transformer:
    """``repro``'s transformer parameter tree (numpy leaves) -> the port's
    ``Transformer`` on ``device`` (default the card)."""
    model = Transformer(cfg, device=device)
    with torch.no_grad():
        _fill(model, tree, "params")
    return model


def gnn_from_jax(tree: dict, cfg: GNNConfig, device=None) -> GNN:
    """``repro``'s GNN parameter tree (numpy leaves) -> the port's ``GNN``
    on ``device`` (default the card)."""
    model = GNN(cfg, device=device)
    with torch.no_grad():
        _fill(model, tree, "params")
    return model


def _walk(mod: nn.Module, port: str, path: str, stacked: bool, out: dict):
    """``_fill``'s walk: every parameter under ``mod`` by its port name."""
    def join(a, b):
        return f"{a}.{b}" if a else b

    def jpath(a, b):
        return f"{a}/{b}" if a else b

    if isinstance(mod, nn.Linear):
        out[join(port, "weight")] = (jpath(path, "w"), True, stacked)
        if mod.bias is not None:
            out[join(port, "bias")] = (jpath(path, "b"), False, stacked)
        return
    for key, _ in mod.named_parameters(recurse=False):
        out[join(port, key)] = (jpath(path, key), False, stacked)
    for key, child in mod.named_children():
        if isinstance(child, nn.ModuleList):
            for i, layer in enumerate(child):
                _walk(layer, join(port, f"{key}.{i}"), jpath(path, key), True,
                      out)
        else:
            _walk(child, join(port, key), jpath(path, key), stacked, out)


def repro_leaves(model: nn.Module) -> dict:
    """``{port parameter name: (repro path, transposed, stacked)}`` for a
    ``RecsysModel``, ``Transformer`` or ``GNN``: the leaf of ``repro``'s
    tree each parameter is converted from (``params_from_jax``,
    ``transformer_from_jax``, ``gnn_from_jax``)."""
    out: dict = {}
    if not isinstance(model, RecsysModel):
        _walk(model, "", "", False, out)
        return out
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "cin":  # a ParameterList: (H_next, H_k, F) as is
            out[name] = ("/".join(parts), False, False)
        elif len(parts) > 1 and parts[-1] in ("weight", "bias"):
            leaf = "w" if parts[-1] == "weight" else "b"
            out[name] = ("/".join(parts[:-1] + [leaf]), leaf == "w", False)
        else:
            out[name] = (name, False, False)
    return out


def _sharded_as(mod: nn.Module, name: str):
    """The logical name of the axis ``repro`` shards a parameter's first
    dimension over, or None for a parameter it keeps whole."""
    if isinstance(mod, RecsysModel) and name in ("table", "wide"):
        return "rows"
    if isinstance(mod, MoE) and name in ("wi", "wg", "wo"):
        return "experts"
    return None


def place_on_mesh(model: nn.Module, mesh: ModelMesh, rules,
                  device=None) -> nn.Module:
    """``model`` (whole, on any device) with every parameter on ``device``
    (default the mesh's): this rank's block under ``rules`` of each leaf
    ``repro`` shards, whole copies of the rest.  In place; returns
    ``model``."""
    dev = mesh.device if device is None else resolve_device(device)
    with torch.no_grad():
        for mod in model.modules():
            for name, prm in list(mod.named_parameters(recurse=False)):
                val = prm.detach()
                logical = _sharded_as(mod, name)
                if logical is not None:
                    val = local_block(val, (rules.get(logical), None), mesh)
                new = torch.empty(val.shape, dtype=val.dtype, device=dev)
                setattr(mod, name, nn.Parameter(
                    new.copy_(val), requires_grad=prm.requires_grad))
    return model

