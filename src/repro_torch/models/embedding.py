"""The fused EmbeddingBag (the torch counterpart of
``repro.models.embedding``).

All categorical fields share one fused table (a row offset per field),
padded to a multiple of ``pad_to_multiple`` rows, so a table converted
from ``repro`` keeps its shape.  A (B, F, H) multi-hot id batch (-1 =
padding) looks up (B, F, D) bag sums: one gather and a masked sum.

``mode`` is accepted and, as in ``repro`` without a mesh, changes
nothing: the row-sharded psum and all-to-all bodies are not ported yet
(ROADMAP queue 1 item 12c, the model-parallel mesh).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    vocab_sizes: Tuple[int, ...]  # rows per field
    dim: int
    pad_to_multiple: int = 512  # fused rows padded for even row-sharding

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate(
            [[0], np.cumsum(self.vocab_sizes)[:-1]]).astype(np.int64)

    @property
    def total_rows(self) -> int:
        t = int(sum(self.vocab_sizes))
        m = self.pad_to_multiple
        return (t + m - 1) // m * m


def init_table(generator: torch.Generator, spec: EmbeddingSpec,
               dtype=torch.float32, scale: float = 0.01) -> torch.Tensor:
    """(total_rows, dim) normal * ``scale``, drawn on the generator's
    device."""
    t = torch.randn((spec.total_rows, spec.dim), generator=generator,
                    device=generator.device, dtype=dtype)
    return t.mul_(scale)


def _flat_ids(ids: torch.Tensor, spec: EmbeddingSpec):
    """(B, F, H) field-local ids (-1 pad) -> (B, F, H) fused row ids
    (int64, 0 at padding) and the validity mask."""
    offs = torch.as_tensor(spec.offsets, device=ids.device)[None, :, None]
    valid = ids >= 0
    return torch.where(valid, ids.to(torch.int64) + offs, 0), valid


def _local_bag(table: torch.Tensor, flat: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    emb = table[flat.reshape(-1)].reshape(flat.shape + (table.shape[1],))
    emb = emb * valid[..., None].to(emb.dtype)
    return emb.sum(2)  # (B, F, D)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  spec: EmbeddingSpec, mode: str = "psum") -> torch.Tensor:
    """table (rows, D), ids (B, F, H) -> (B, F, D) bag-summed embeddings.
    ``mode`` selects the sharded exchange in ``repro``; without a mesh it
    changes nothing there or here."""
    flat, valid = _flat_ids(ids, spec)
    return _local_bag(table, flat, valid)


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      spec: EmbeddingSpec) -> torch.Tensor:
    """Dense one-hot oracle (tests): bag sum == onehot(ids) @ table."""
    flat, valid = _flat_ids(ids, spec)
    B, F, H = ids.shape
    out = torch.zeros((B, F, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    for h in range(H):
        oh = torch.nn.functional.one_hot(flat[:, :, h], table.shape[0])
        oh = oh.to(table.dtype) * valid[:, :, h, None].to(table.dtype)
        out = out + torch.einsum("bfr,rd->bfd", oh, table)
    return out
