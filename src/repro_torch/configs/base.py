"""ArchSpec: one selectable ``--arch`` entry = model config + its shape
set + per-shape skips (with reasons) + a reduced config for CPU smoke
tests (the torch counterpart of ``repro.configs.base``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np

from repro_torch.configs.shapes import ShapeSpec


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    id: str
    family: str  # lm | gnn | recsys
    config: Any
    shapes: Dict[str, ShapeSpec]
    skips: Dict[str, str]  # shape name -> reason
    reduced: Callable[[], Any]  # small same-family config for smoke tests

    def active_shapes(self):
        return {k: v for k, v in self.shapes.items() if k not in self.skips}


def make_recsys_vocabs(n_fields: int, seed: int, lo: int = 100,
                       hi: int = 10_000_000):
    """Deterministic log-uniform vocab sizes (Criteo-like long tail).

    Real CTR tables mix a few 1e6-1e7-row id fields with many small
    categorical fields; total lands in the tens of millions of rows."""
    rng = np.random.default_rng(seed)
    sizes = np.exp(rng.uniform(np.log(lo), np.log(hi), size=n_fields)).astype(
        np.int64)
    return tuple(int(s) for s in sizes)
