"""Device resolution for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  A
CUDA device on a machine without one is an error, never a silent move
to the CPU: the tests pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``device`` as a ``torch.device`` (None means the card), raising
    when it names CUDA and no CUDA device is visible."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(dev)!r} requested but torch sees no CUDA device "
            f"(torch {torch.__version__}, cuda {torch.version.cuda}); pass "
            f"device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {str(dev)!r}: use cpu or cuda")
    return dev


def to_device(x, device, dtype=None) -> torch.Tensor:
    """A request array (numpy, a sequence or a tensor on any device) as a
    tensor on ``device``, cast to ``dtype`` when given."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)


def constant(x, dtype=None, device=None) -> torch.Tensor:
    """A constant (a number, a numpy array or a tensor) as a tensor on
    ``device``.  A number is made there by a factory (``torch.full``), an
    array on the host and then moved.  Under ``FakeTensorMode`` (the dry
    run) neither allocates on the card: a tensor made from data is a
    constant the mode computes with for real where it holds one element,
    on the device it names (``torch.tensor(x, device="cuda")`` would)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    if isinstance(x, (bool, int, float)):
        return torch.full((), x, dtype=dtype, device=device)
    a = np.asarray(x)
    if a.size == 1:
        dt = dtype or torch.from_numpy(np.empty(0, a.dtype)).dtype
        return torch.full(a.shape, a.item(), dtype=dt, device=device)
    return torch.as_tensor(a, dtype=dtype).to(device)


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether ``a`` and ``b`` name one device (a CUDA device without an
    index is the current card)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (
        cur if b.index is None else b.index)
