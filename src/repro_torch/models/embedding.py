"""The fused EmbeddingBag (the torch counterpart of
``repro.models.embedding``).

All categorical fields share one fused table (a row offset per field),
padded to a multiple of ``pad_to_multiple`` rows, so a table converted
from ``repro`` keeps its shape and splits evenly over a mesh.  A (B, F,
H) multi-hot id batch (-1 = padding) looks up (B, F, D) bag sums.

Two paths, as in ``repro``:

* local (no mesh, or a model axis of one rank): one gather and a masked
  sum;
* on a :class:`~repro_torch.distributed.context.ModelMesh` installed by
  ``axis_rules``: ``repro``'s ``shard_map`` bodies, run by every rank.
  The rank holds its rows of the table under the rules' ``"rows"``
  entry; the ids and the output are whole, each body takes its rank's
  batch slice on entry and all-gathers its output on exit.

  - ``psum``: ids over the data axes that exclude ``"model"``; each
    model shard gathers its row range, masks every id outside it, and
    the partial bags are summed over ``"model"``.
  - ``alltoall`` (only when the batch axes hold ``"model"``, as under
    ``recsys_a2a_rules``; otherwise psum, as ``repro`` falls back): each
    request goes to the owner of its row through one ``all_to_all`` of
    ids and comes back through one of rows.  An owner takes ``cap =
    max(8, int(4 n / n_ex))`` requests from a rank; the rest are
    dropped and read 0, and a padding id goes to owner 0 as row 0 and
    takes one of its slots, exactly as ``repro`` does (ROADMAP queue 3:
    under skew ``repro``'s bag sums come back short, and so do these).

On DTensors (a table and ids placed on a ``DeviceMesh``, the dry run)
the same bodies run under ``local_map``, torch's ``shard_map``: the
table is redistributed to the block the body wants, the ids to its
batch block, and the output stays a DTensor sharded over that batch
block instead of being gathered whole.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import constant
from repro_torch.distributed import context as dctx
from repro_torch.models.dispatch import dispatch_positions


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
    offs = constant(spec.offsets, device=ids.device)[None, :, None]
    valid = ids >= 0
    return torch.where(valid, ids.to(torch.int64) + offs, 0), valid


def _local_bag(table: torch.Tensor, flat: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    emb = table[flat.reshape(-1)].reshape(flat.shape + (table.shape[1],))
    emb = emb * valid[..., None].to(emb.dtype)
    return emb.sum(2)  # (B, F, D)


def _rows(table: torch.Tensor, total: int, want, mesh) -> torch.Tensor:
    """This rank's rows of a table under the spec ``want`` from the block
    it holds under the rules' ``"rows"`` entry (``convert.place_on_mesh``);
    any other block raises."""
    held = (dctx.logical_to_spec("rows")[0], None)
    if table.shape[0] * mesh.axis_size(held[0]) != total:
        raise ValueError(f"a table block of {table.shape[0]} rows is not "
                         f"{total} rows over {held[0]}")
    return dctx.reblock(table, held, want, mesh)


def _a2a_body(table_loc, flat_loc, valid_loc, mesh, ex_axes):
    """``repro``'s ``body_a2a``: a bag of this rank's ids from the rows
    their owners send back."""
    n_ex = mesh.axis_size(ex_axes)
    rows_ex, D = table_loc.shape
    Bl, F, H = flat_loc.shape
    n = Bl * F * H
    req = flat_loc.reshape(-1)
    owner = torch.clamp(req // rows_ex, 0, n_ex - 1)
    cap = max(8, int(4 * n / n_ex))  # 4x imbalance margin
    # rank of each request within its owner bucket; ``cap`` where dropped
    pos = dispatch_positions(owner, n_ex, cap)
    send = req.new_zeros((n_ex, cap + 1))
    send[owner, pos] = req
    recv = mesh.all_to_all(send[:, :cap], ex_axes)  # requests for my rows
    local = recv - mesh.axis_index(ex_axes) * rows_ex
    hit = (local >= 0) & (local < rows_ex)
    rows = table_loc[torch.clamp(local, 0, rows_ex - 1)]
    rows = rows * hit[..., None].to(rows.dtype)
    back = mesh.all_to_all(rows, ex_axes)  # my requests' rows
    back = torch.cat([back, back.new_zeros((n_ex, 1, D))], dim=1)
    got = back[owner, pos].reshape(Bl, F, H, D)  # a drop reads 0
    return (got * valid_loc[..., None].to(got.dtype)).sum(2)


def _psum_body(table_loc, flat_loc, valid_loc, mesh, model_axis):
    """``repro``'s psum ``body``: this model shard's partial bags, summed
    over the model axis."""
    rows_loc = table_loc.shape[0]
    local = flat_loc - mesh.axis_index(model_axis) * rows_loc
    hit = valid_loc & (local >= 0) & (local < rows_loc)
    emb = table_loc[torch.clamp(local, 0, rows_loc - 1)]
    part = (emb * hit[..., None].to(emb.dtype)).sum(2)
    return mesh.psum(part, model_axis)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  spec: EmbeddingSpec, mode: str = "psum") -> torch.Tensor:
    """table (rows, D) [this rank's rows on a mesh], ids (B, F, H) -> (B,
    F, D) bag-summed embeddings, whole on every rank.

    ``mode="psum"``: every model shard computes a dense partial and the
    partials are summed.  ``mode="alltoall"``: each rank sends its ids to
    the row owners and receives only the hit rows back; it needs the
    batch sharded over the model axis too and falls back to psum
    otherwise.  Without a mesh ``mode`` changes nothing."""
    flat, valid = _flat_ids(ids, spec)
    mesh = dctx.current_mesh()
    model_axis = dctx.model_axis_name()
    if mesh is None or model_axis is None or mesh.axis_size(model_axis) == 1:
        if mesh is not None:
            table = _rows(table, spec.total_rows, (None, None), mesh)
        return _local_bag(table, flat, valid)

    dp_axes = dctx.data_axis_names()
    B = ids.shape[0]
    dp_size = 1
    for a in dp_axes:
        dp_size *= mesh.shape[a]
    batch_axes = (tuple(dict.fromkeys(dp_axes))
                  if (dp_axes and B % dp_size == 0) else ())

    if mode == "alltoall" and batch_axes and model_axis in batch_axes:
        # DLRM-style: ids and rows over the whole exchange group
        want = ids_axes = batch_axes
    else:
        # psum path: ids must NOT be sharded over the model axis
        want = model_axis
        ids_axes = tuple(a for a in batch_axes if a != model_axis) or None
    if dctx.is_dtensor(table):
        return _bag_local_map(table, flat, valid, mesh, model_axis, want,
                              ids_axes)
    table_loc = _rows(table, spec.total_rows, (want, None), mesh)
    f = dctx.local_block(flat, (ids_axes,), mesh)
    v = dctx.local_block(valid, (ids_axes,), mesh)
    out = (_psum_body(table_loc, f, v, mesh, model_axis) if want == model_axis
           else _a2a_body(table_loc, f, v, mesh, want))
    return dctx.gather_block(out, (ids_axes,), mesh)


def _bag_local_map(table, flat, valid, mesh, model_axis, want, ids_axes):
    """The psum or all-to-all body on each rank's blocks of DTensors: the
    table's ``want`` rows, the ids' ``ids_axes`` batch block."""
    from torch.distributed.tensor.experimental import local_map

    t_pl = dctx.spec_placements((want, None), mesh.device_mesh)
    i_pl = dctx.spec_placements((ids_axes,), mesh.device_mesh)

    def body(t, f, v):
        if want == model_axis:
            return _psum_body(t, f, v, mesh, model_axis)
        return _a2a_body(t, f, v, mesh, want)

    return local_map(body, out_placements=i_pl, in_placements=(t_pl, i_pl,
                                                               i_pl),
                     in_grad_placements=(dctx.grad_placements(t_pl, i_pl),
                                         i_pl, i_pl),
                     device_mesh=mesh.device_mesh,
                     redistribute_inputs=True)(table, flat, valid)


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
