"""LR schedules as pure step -> scale functions (multiplied onto cfg.lr),
the torch counterpart of ``repro.optim.schedules``.

Both take the optimizer's step as a tensor and return a float32 tensor on
its device, so a training step reads its learning rate without a host
sync.  The step is the one read before the update increments it: the
first update of a run has scale ``cosine_warmup(0) = 0``.
"""
from __future__ import annotations

import math

import torch


def constant_lr(step: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(step, dtype=torch.float32)


def cosine_warmup(step: torch.Tensor, warmup: int = 100, total: int = 10000,
                  floor: float = 0.1) -> torch.Tensor:
    t = step.to(torch.float32)
    warm = torch.clamp_max(t / max(warmup, 1), 1.0)
    prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
