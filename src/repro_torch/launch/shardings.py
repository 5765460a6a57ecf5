"""Parameter / input sharding rule tables per model family (the torch
counterpart of ``repro.launch.shardings``), as DTensor placements.

The rules are ``repro``'s, copied:
  * LM: 2D megatron TP on "model" x ZeRO-3 FSDP on the data axes
    (column-parallel wq/wk/wv/wi/wg, row-parallel wo; embeddings
    vocab-sharded; MoE experts on "model", FSDP inside each expert);
    under the ``fsdp_ep`` profiles no TP: every dense 2-D weight over
    every axis, experts expert-parallel;
  * recsys: embedding tables row-sharded on "model", towers replicated;
  * GNN: params replicated (small), node/edge arrays sharded over the
    whole device grid.

A spec is a tuple, one entry a dimension of ``repro``'s leaf: None, a
mesh axis, or a tuple of axes.  The rules are keyed by ``repro``'s leaf
paths; a port parameter finds its leaf through
``repro_torch.models.convert.repro_leaves`` (an ``nn.Linear`` weight is
its leaf transposed, a layer's parameter one slice of a stacked leaf),
and its spec is the leaf's, fixed to the leaf's shape (``_fix_spec``),
less the stacked dimension, transposed back.  A mesh here is anything
whose ``shape`` maps an axis name to its size (a ``ModelMesh``, a stub)
or a ``DeviceMesh``.
"""
from __future__ import annotations

from typing import Mapping, Sequence, Tuple

from torch import nn

from repro_torch.distributed.context import (
    as_dtensor,
    fix_spec,
    spec_placements,
)
from repro_torch.models.convert import repro_leaves


def mesh_sizes(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh`` or of a mesh whose ``shape``
    is already such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _res(rules: Mapping, name: str):
    v = rules.get(name)
    if v is None:
        return None
    return tuple(v) if isinstance(v, (list, tuple)) else v


def _replicated(ndim: int) -> tuple:
    return (None,) * ndim


def lm_param_spec(name: str, shape: Sequence[int], rules,
                  profile: str = "baseline") -> tuple:
    """``repro``'s ``lm_param_spec`` for the leaf ``name`` of ``shape``."""
    F = _res(rules, "fsdp")
    M = _res(rules, "model")
    stacked = name.startswith("layers/")
    pre = (None,) if stacked else ()

    def spec(*axes):
        return pre + axes

    if profile.startswith("fsdp_ep"):
        Fe = _res(rules, "fsdp_expert")
        dp = _res(rules, "batch")
        if name == "embed":
            return (M, dp)
        if name == "unembed":
            return (dp, M)
        if "moe/router" in name:
            return spec(None, None)
        if name.endswith(("moe/wi", "moe/wg")):
            return spec(M, Fe, None)
        if name.endswith("moe/wo"):
            return spec(M, None, Fe)
        if name.endswith("/w") and len(shape) == len(pre) + 2:
            return spec(F, None)
        return pre + _replicated(len(shape) - len(pre))

    if name == "embed":
        return (M, F)
    if name == "unembed":
        return (F, M)
    if name.endswith(("wq/w", "wk/w", "wv/w")):
        return spec(F, M)
    if name.endswith(("wq/b", "wk/b", "wv/b")):
        return spec(M)
    if "attn/wo/w" in name:
        return spec(M, F)
    if name.endswith(("mlp/wi/w", "mlp/wg/w")):
        return spec(F, M)
    if name.endswith("mlp/wo/w"):
        return spec(M, F)
    if "moe/router" in name:
        return spec(None, None)
    if name.endswith(("moe/wi", "moe/wg")):
        return spec(M, F, None)
    if name.endswith("moe/wo"):
        return spec(M, None, F)
    return pre + _replicated(len(shape) - len(pre))


def recsys_param_spec(name: str, shape: Sequence[int], rules) -> tuple:
    M = _res(rules, "rows")
    if name in ("table", "wide"):
        return (M, None)
    return _replicated(len(shape))


def gnn_param_spec(name: str, shape: Sequence[int], rules) -> tuple:
    return _replicated(len(shape))


def _fix_spec(spec: Sequence, shape: Sequence[int], mesh) -> tuple:
    """Drop trailing mesh axes from any dim whose size they don't divide
    (e.g. d_ff=6912 over a 512-way FSDP axis group -> keep the largest
    divisible prefix)."""
    return fix_spec(spec, shape, mesh_sizes(mesh))


def _leaf_spec(family: str, path: str, shape, rules, profile) -> tuple:
    if family == "lm":
        return lm_param_spec(path, shape, rules, profile)
    if family == "recsys":
        return recsys_param_spec(path, shape, rules)
    return gnn_param_spec(path, shape, rules)


def param_specs(family: str, model: nn.Module, mesh, rules,
                profile: str = "baseline") -> dict:
    """``{port parameter name: spec}`` in the port's layout: each leaf's
    ``repro`` spec fixed to the leaf's shape (stacked over the model's
    layers where ``repro`` stacks it), then unstacked and transposed."""
    leaves = repro_leaves(model)
    n_layers = len(getattr(model, "layers", ())) or 1
    out = {}
    for name, prm in model.named_parameters():
        path, transposed, stacked = leaves[name]
        shape = tuple(prm.shape)
        leaf = tuple(reversed(shape)) if transposed else shape
        if stacked:
            leaf = (n_layers,) + leaf
        spec = _fix_spec(_leaf_spec(family, path, leaf, rules, profile),
                         leaf, mesh)
        spec = tuple(spec) + (None,) * (len(leaf) - len(spec))
        if stacked:
            spec = spec[1:]
        out[name] = tuple(reversed(spec)) if transposed else spec
    return out


def local_shape(shape: Sequence[int], spec: Sequence, mesh) -> Tuple[int, ...]:
    """The block of ``shape`` one rank holds under ``spec`` (even splits:
    ``_fix_spec`` keeps only dividing axes)."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        for a in axes:
            out[d] //= sizes[a]
    return tuple(out)


def param_shardings(family: str, model: nn.Module, mesh, rules,
                    profile: str = "baseline") -> dict:
    """``{port parameter name: DTensor placements}`` on the ``DeviceMesh``
    ``mesh``."""
    return {name: spec_placements(spec, mesh)
            for name, spec in param_specs(family, model, mesh, rules,
                                          profile).items()}


def opt_shardings(param_sh: dict, mesh) -> dict:
    """AdamW state: moments shard like params; step is replicated."""
    return {"m": param_sh, "v": param_sh,
            "step": spec_placements((), mesh)}


def batch_axes_for(rules, n: int, mesh) -> tuple:
    """Data axes if the leading dim divides evenly, else replicate."""
    v = _res(rules, "batch") or ()
    axes = (v,) if isinstance(v, str) else tuple(v)
    sizes = mesh_sizes(mesh)
    size = 1
    for a in axes:
        size *= sizes[a]
    return axes if axes and n % size == 0 and n >= size else ()


def place_params(model: nn.Module, mesh, placements: dict,
                 requires_grad: bool = False) -> nn.Module:
    """Every parameter of ``model`` as a DTensor on ``mesh`` under
    ``placements`` (``param_shardings``), in place: each rank keeps its
    block of the tensor it holds, with no collective (every rank holds
    the same whole parameter; a fake one allocates nothing).  Returns
    ``model``."""
    for prefix, mod in model.named_modules():
        for key, prm in list(mod.named_parameters(recurse=False)):
            name = f"{prefix}.{key}" if prefix else key
            d = as_dtensor(prm.detach(), mesh, placements[name])
            setattr(mod, key, nn.Parameter(d, requires_grad=requires_grad))
    return model
