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


def adamw_init(params: Tree) -> dict:
    """f32 ``m`` and ``v`` for each named parameter and an int32 ``step``
    on the parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    device = next(iter(params.values())).device
    return {
        "m": {n: zeros(p) for n, p in params.items()},
        "v": {n: zeros(p) for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    leaves = [a.to(torch.float32).square().sum() for a in tree.values()]
    return torch.stack(leaves).sum().sqrt()


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree,
                                                                torch.Tensor]:
    """(grads scaled by min(1, max_norm / max(norm, 1e-9)) in f32, cast
    back to each gradient's dtype; the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return {n: (g.to(torch.float32) * scale).to(g.dtype)
            for n, g in grads.items()}, norm


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
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)
    lr = cfg.lr * lr_scale
    for name, p in params.items():
        gf = grads[name].to(torch.float32)
        m, v = state["m"][name], state["v"][name]
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
