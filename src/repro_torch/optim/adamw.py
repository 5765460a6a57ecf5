"""AdamW with decoupled weight decay, f32 moments over (possibly bf16)
params: the torch counterpart of ``repro.optim.adamw``, ``repro``'s
arithmetic written out (not ``torch.optim.AdamW``).

Parameters, gradients and moments are dicts of named tensors (a model's
``named_parameters()``).  ``adamw_update`` writes the new parameters and
moments in place under ``torch.no_grad()`` (a handful of passes a leaf,
no full-size temporary beyond the update) and returns the same dicts;
every scalar it needs (bias corrections, learning rate, clip scale) stays
a tensor on the parameters' device, so an update syncs nothing with the
host.  Weight decay applies to every leaf, biases and tables included.

On DTensor parameters (a cell of ``repro_torch.launch.steps`` on a
mesh) the moments are placed like their parameter and ``step``
replicated, as ``repro``'s ``opt_shardings`` places them; the gradients
must sit on their parameters' placements.  The global norm is one
all-reduce over the whole mesh, the clip scale is replicated, and the
update runs in place on each rank's blocks, the arithmetic of the plain
tensors'.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: Optional[float] = 1.0


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _zeros(p: torch.Tensor) -> torch.Tensor:
    if _is_dtensor(p):  # placed like the parameter
        return torch.zeros_like(p, dtype=torch.float32,
                                requires_grad=False)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params: Tree) -> dict:
    """f32 ``m`` and ``v`` for each named parameter and an int32 ``step``
    on the parameters' device (on DTensor parameters: the moments placed
    like each parameter, ``step`` replicated on their mesh)."""
    first = next(iter(params.values()))
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    if _is_dtensor(first):
        from torch.distributed.tensor import DTensor, Replicate

        mesh = first.device_mesh
        step = DTensor.from_local(step, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return {
        "m": {n: _zeros(p) for n, p in params.items()},
        "v": {n: _zeros(p) for n, p in params.items()},
        "step": step,
    }


def _local(x):
    return x.to_local() if _is_dtensor(x) else x


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares.  On
    DTensors (a replicated DTensor): each leaf's local sum of squares,
    divided by the number of ranks that hold the same block (a power of
    two on the production meshes, so exactly), summed over the leaves
    and completed by one all-reduce over the whole mesh."""
    if not any(_is_dtensor(a) for a in tree.values()):
        leaves = [a.to(torch.float32).square().sum() for a in tree.values()]
        return torch.stack(leaves).sum().sqrt()
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = next(a for a in tree.values() if _is_dtensor(a)).device_mesh
    shares = []
    for a in tree.values():
        copies = 1
        for i, p in enumerate(a.placements):
            if not isinstance(p, Shard):
                copies *= mesh.shape[i]
        shares.append(_local(a).to(torch.float32).square().sum() / copies)
    total = torch.stack(shares).sum()
    if mesh.size() > 1:
        flat = mesh if mesh.ndim == 1 else mesh[tuple(
            mesh.mesh_dim_names)]._flatten()
        total = DTensor.from_local(total, flat, [Partial()],
                                   run_check=False).redistribute(
            flat, [Replicate()]).to_local()
    return DTensor.from_local(total.sqrt(), mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree,
                                                                torch.Tensor]:
    """(grads scaled by min(1, max_norm / max(norm, 1e-9)) in f32, cast
    back to each gradient's dtype; the norm before clipping)."""
    norm = global_norm(grads)
    scale = _local(torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9),
                                   1.0))
    return {n: _like(g, (_local(g).to(torch.float32) * scale).to(g.dtype))
            for n, g in grads.items()}, norm


def _like(ref, local):
    """``local`` as ``ref`` holds its block: a DTensor of ``ref``'s
    placements where ``ref`` is one."""
    if not _is_dtensor(ref):
        return local
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: dict, cfg: AdamWConfig,
                 lr_scale: Any = 1.0):
    """Returns (new params, new state, {"grad_norm": norm before
    clipping}); the parameters and moments are updated in place."""
    if cfg.grad_clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip_norm)
    else:
        gnorm = global_norm(grads)
    step = state["step"] + 1
    t = _local(step).to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)
    lr = cfg.lr * _local(lr_scale) if torch.is_tensor(lr_scale) else (
        cfg.lr * lr_scale)
    for name, prm in params.items():
        p = _local(prm)  # this rank's block, updated in place
        gf = _local(grads[name]).to(torch.float32)
        m, v = _local(state["m"][name]), _local(state["v"][name])
        m.mul_(cfg.b1).add_(gf, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(gf, gf, value=1 - cfg.b2)
        update = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        pf = p.to(torch.float32)
        update.add_(pf, alpha=cfg.weight_decay).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(update)
        else:
            p.copy_((pf - update).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm}
