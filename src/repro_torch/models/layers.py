"""Shared neural-net layers (the torch counterpart of the part of
``repro.models.layers`` the recsys models use: ``dense`` and the ReLU
``mlp_head``).

``repro``'s dense weight is ``(d_in, d_out)``, applied as ``x @ w``;
``nn.Linear`` stores ``(d_out, d_in)``.  The initialisation draws the
same distribution (normal times ``d_in ** -0.5``, zero bias) from an
explicit ``torch.Generator``; without one the layer is left for a
converter to fill (``repro_torch.models.convert``).

The LM layers (norms, RoPE, attention, gated MLPs) are not ported yet
(ROADMAP queue 1 item 12).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


def dense(d_in: int, d_out: int, *, bias: bool = False,
          generator: Optional[torch.Generator] = None, device=None,
          dtype=torch.float32) -> nn.Linear:
    """``nn.Linear(d_in, d_out)``; with ``generator`` its weight is drawn
    as ``repro``'s ``dense_init`` draws it."""
    lin = nn.Linear(d_in, d_out, bias=bias, device=device, dtype=dtype)
    if generator is not None:
        with torch.no_grad():
            lin.weight.normal_(generator=generator).mul_(d_in ** -0.5)
            if bias:
                lin.bias.zero_()
    return lin


class MLPHead(nn.Module):
    """Plain ReLU MLP tower over ``dims`` then a final projection to
    ``out_dim`` (``repro``'s ``mlp_head_init`` / ``mlp_head_apply``)."""

    def __init__(self, dims: Sequence[int], out_dim: int = 1, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        dims = list(dims)
        kw = dict(bias=True, generator=generator, device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            [dense(a, b, **kw) for a, b in zip(dims[:-1], dims[1:])]
            + [dense(dims[-1], out_dim, **kw)]
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)
