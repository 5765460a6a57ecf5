"""Elastic re-meshing (the torch counterpart of
``repro.distributed.elastic``): when ranks are lost (or added), rebuild
the ``("data", "model")`` mesh from the survivors and reshard the state.

The policy keeps the model axis fixed when possible (parameter blocks
stay valid) and shrinks the data axis: the data-parallel degree is the
elastic dimension.  ``repro``'s ``reshard`` is ``jax.device_put`` onto
the new mesh; here every rank of the old mesh gathers each leaf whole
from the blocks and each survivor keeps its block under the new mesh
(after a real failure the whole leaves come from the last checkpoint).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.distributed.context import (
    ModelMesh,
    current_mesh,
    gather_block,
    local_block,
    make_model_mesh,
)


def choose_mesh_shape(n_devices: int, model_pref: int) -> Tuple[int, int]:
    """Largest (data, model) grid with model | model_pref, maximizing used
    devices; prefers keeping the full model axis."""
    for model in sorted(
        {m for m in range(1, model_pref + 1) if model_pref % m == 0},
        reverse=True,
    ):
        data = n_devices // model
        if data >= 1:
            return data, model
    return n_devices, 1


def make_elastic_mesh(ranks: Sequence[int], model_pref: int,
                      device=None) -> Optional[ModelMesh]:
    """A mesh over the surviving ``ranks`` (the first ``data * model`` of
    them, ascending): every survivor calls it, the other ranks take no
    part in its groups; a caller outside it gets None."""
    ranks = sorted(ranks)
    data, model = choose_mesh_shape(len(ranks), model_pref)
    return make_model_mesh((data, model), ranks[: data * model], device)


def _map(fn, tree, *specs):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(s[k] for s in specs)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t, *(s[i] for s in specs))
                          for i, t in enumerate(tree))
    return fn(tree, *specs)


def reshard(tree, old_specs, new_mesh: Optional[ModelMesh], new_specs,
            old_mesh: Optional[ModelMesh] = None):
    """Each leaf of ``tree`` (this rank's block under ``old_specs`` on
    ``old_mesh``, default the installed mesh) as this rank's block under
    ``new_specs`` on ``new_mesh``; None on a rank outside ``new_mesh``.
    Collective over the old mesh: every rank of it calls it, the specs
    trees shaped as ``tree``."""
    old_mesh = current_mesh() if old_mesh is None else old_mesh
    if old_mesh is None:
        raise ValueError("reshard needs the old mesh (old_mesh= or "
                         "axis_rules)")

    def move(x: torch.Tensor, old, new):
        whole = gather_block(x, old, old_mesh)
        if new_mesh is None:
            return None
        return local_block(whole, new, new_mesh).clone()

    return _map(move, tree, old_specs, new_specs)
