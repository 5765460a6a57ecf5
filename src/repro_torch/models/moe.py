"""Mixture-of-Experts layer (the torch counterpart of
``repro.models.moe``): GShard-style top-k token-choice routing with a
per-expert capacity and ``repro``'s expert-parallel dispatch.

Without a mesh the layer runs on one device with one expert shard and
no collectives.  Under ``axis_rules`` with a
:class:`~repro_torch.distributed.context.ModelMesh` every rank runs
``repro``'s ``shard_map`` body: the rank holds its ``E / n_shards``
experts of ``wi``, ``wg``, ``wo`` (the ``"model"`` axis), takes its
slice of the whole tokens on entry and all-gathers the output on exit.
The tokens are partitioned, by preference, over (data x model) when T
divides by dp x n_shards, over ``"model"`` when it divides by n_shards,
else replicated:

* partitioned: one ``all_to_all`` over ``"model"`` (within the rank's
  data row) sends each expert its slots, a second sends the outputs
  back;
* replicated: each shard runs its own experts on every token, reads 0
  for a slot of another shard's expert, and the outputs are summed over
  ``"model"``.  (``repro``'s body reads ``expert_out.at[loc_e,
  pos].get(mode="fill")``, and JAX wraps a negative ``loc_e`` before
  filling, so a shard there adds the slot of the expert ``E / n_shards``
  above; ROADMAP queue 3.  The port reads 0, as its comment intends.)

On DTensors (the dry run's placements on a ``DeviceMesh``) the same
body runs under ``local_map`` on each rank's block of tokens and its
experts (the experts' FSDP split gathered on entry); the output stays a
DTensor split over the batch as the input was.

The capacity is the body's own: ``cap = max(8, int(capacity_factor *
T_loc * K / E))`` over the tokens the rank routes, and the aux loss is
averaged over the token axes (over ``"model"`` when replicated).

The router weight is float32 in a bf16 model and so are its logits.
Ties between routing probabilities go to the lower expert index, as
``jax.lax.top_k`` breaks them (a stable descending sort; ``torch.topk``
promises no order).  A (token, slot) pair at position ``cap`` or later
in its expert's stable order is dropped and reads back 0.
"""
from __future__ import annotations

import dataclasses
import functools
import types
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.distributed import context as dctx
from repro_torch.models.dispatch import dispatch_positions
from repro_torch.models.layers import _init_device, dense


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01


class MoE(nn.Module):
    """``repro``'s ``moe_init``: the float32 ``router`` (d_model -> E, no
    bias) and the experts' ``wi``, ``wg`` (E, d_model, d_ff) and ``wo``
    (E, d_ff, d_model), kept in ``repro``'s (d_in, d_out) layout."""

    def __init__(self, d_model: int, cfg: MoEConfig, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        E, Fd = cfg.n_experts, cfg.d_ff
        self.router = dense(d_model, E, generator=generator, device=device,
                            dtype=torch.float32)

        def experts(shape, scale):
            w = torch.empty(shape, device=device, dtype=dtype)
            if generator is not None:
                w.normal_(generator=generator).mul_(scale)
            return nn.Parameter(w)

        s_in, s_out = d_model ** -0.5, Fd ** -0.5
        self.wi = experts((E, d_model, Fd), s_in)
        self.wg = experts((E, d_model, Fd), s_in)
        self.wo = experts((E, Fd, d_model), s_out)


def moe_init(generator: Optional[torch.Generator], d_model: int,
             cfg: MoEConfig, dtype, device=None) -> MoE:
    return MoE(d_model, cfg, generator=generator,
               device=_init_device(generator, device), dtype=dtype)


def route(x: torch.Tensor, p: MoE, cfg: MoEConfig):
    """Routing of x (T, d): ``(top_w (T, K) float32 renormalised over the
    top-k, top_e (T, K) int64, probs (T, E) float32)``."""
    logits = p.router(x.float())  # (T, E) float32
    probs = torch.softmax(logits, dim=-1)
    # stable descending sort: a tie goes to the lower expert index
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :cfg.top_k], top_e[:, :cfg.top_k]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return top_w, top_e, probs


def capacity(cfg: MoEConfig, T: int) -> int:
    """Slots an expert for T tokens: ``max(8, int(cf * T * K / E))``."""
    return max(8, int(cfg.capacity_factor * T * cfg.top_k / cfg.n_experts))


def _experts(p: MoE, cfg: MoEConfig, n_shards: int):
    """This shard's ``wi``, ``wg``, ``wo``: the ``E / n_shards`` experts
    the rank holds (``convert.place_on_mesh``); anything else raises."""
    ws = (p.wi, p.wg, p.wo)
    if ws[0].shape[0] * n_shards != cfg.n_experts:
        raise ValueError(f"{ws[0].shape[0]} experts held, not the block of "
                         f"{cfg.n_experts} over {n_shards} shards")
    return ws


def _ffn(buf: torch.Tensor, wi, wg, wo) -> torch.Tensor:
    h = torch.einsum("ecd,edf->ecf", buf, wi)
    g = torch.einsum("ecd,edf->ecf", buf, wg)
    return torch.einsum("ecf,efd->ecd", F.silu(g) * h, wo)


def _read(out_buf: torch.Tensor, e: torch.Tensor,
          pos: torch.Tensor) -> torch.Tensor:
    """Each slot's row of ``out_buf (E, cap, d)``; position ``cap`` (a
    dropped pair) reads 0."""
    E, _, d = out_buf.shape
    return torch.cat([out_buf, out_buf.new_zeros((E, 1, d))], dim=1)[e, pos]


def _local_moe(x: torch.Tensor, p: MoE, cfg: MoEConfig, n_shards: int = 1,
               model_axis: Optional[str] = None, psum_mode: bool = False):
    """The MoE body of one rank: x (T_loc, d) -> (out (T_loc, d), aux
    loss).  With ``model_axis`` and ``n_shards > 1`` it runs on the mesh
    that ``axis_rules`` installed."""
    T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    E_loc = E // n_shards
    cap = capacity(cfg, T)
    mesh = None
    if model_axis is not None and n_shards > 1:
        mesh = dctx.current_mesh()
        if mesh is None:
            raise RuntimeError("the expert-parallel MoE body needs a "
                               "ModelMesh installed by axis_rules")
    wi, wg, wo = _experts(p, cfg, n_shards)

    # --- routing (f32) ---
    top_w, top_e, probs = route(x, p, cfg)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=0)  # (E,)
    one_hot = F.one_hot(top_e, E).float()  # (T, K, E)
    ce = one_hot.sum(1).mean(dim=0) / K  # fraction routed per expert
    aux = E * torch.sum(me * ce)

    # --- dispatch: slot ``cap`` of a (cap + 1)-slot buffer takes the drops
    flat_e = top_e.reshape(-1)
    pos = dispatch_positions(top_e, E, cap)
    tok_idx = torch.arange(T * K, device=x.device) // K
    buf = x.new_zeros((E, cap + 1, d))
    buf[flat_e, pos] = x[tok_idx]
    buf = buf[:, :cap]

    # --- expert-parallel compute ---
    if mesh is not None and not psum_mode:
        # (E, cap, d) -> (n_shards, E_loc, cap, d) -> a2a -> by source
        recv = mesh.all_to_all(buf.reshape(n_shards, E_loc, cap, d),
                               model_axis)
        expert_in = recv.movedim(0, 1).reshape(E_loc, n_shards * cap, d)
        back = _ffn(expert_in, wi, wg, wo).reshape(E_loc, n_shards, cap, d)
        out_buf = mesh.all_to_all(back.movedim(1, 0).contiguous(),
                                  model_axis).reshape(E, cap, d)
        slot_out = _read(out_buf, flat_e, pos)
    elif mesh is not None:
        # replicated tokens: this shard's experts, the others' slots read 0
        lo = mesh.axis_index(model_axis) * E_loc
        expert_out = _ffn(buf[lo:lo + E_loc], wi, wg, wo)
        loc_e = flat_e - lo
        inside = (loc_e >= 0) & (loc_e < E_loc)
        slot_out = _read(expert_out, torch.clamp(loc_e, 0, E_loc - 1),
                         torch.where(inside, pos, cap))
        slot_out = mesh.psum(slot_out, model_axis)
    else:
        slot_out = _read(_ffn(buf, wi, wg, wo), flat_e, pos)

    # --- combine: weight slots, sum over K ---
    slot_out = slot_out.reshape(T, K, d) * top_w[..., None].to(x.dtype)
    return slot_out.sum(dim=1), aux


def _aux_mean(mesh, aux: torch.Tensor, tok_axes, model_axis: str):
    """The aux loss averaged over the token axes (over ``model_axis`` when
    the tokens are replicated).  Replicated tokens give every rank the
    whole aux, so there the mean's cotangent reaches each rank whole
    rather than divided among them (the value is the mean's)."""
    mean = mesh.pmean(aux, tok_axes or (model_axis,))
    if tok_axes:
        return mean
    return aux + (mean - aux).detach()


def _moe_local_map(p: MoE, x, cfg: MoEConfig, mesh, n_shards: int,
                   model_axis: str, psum_mode: bool, tok_axes):
    """``_local_moe`` on each rank's blocks of DTensors, its tokens
    ``repro``'s: the ``B * S`` tokens in contiguous blocks over
    ``tok_axes`` in order.  ``x (B, S, d)`` enters split over the batch
    by the longest prefix of ``tok_axes`` that divides ``B``; the body
    flattens its block and takes its part over the rest of ``tok_axes``
    (an all-gather over them puts the block back together on the way
    out), so no DTensor is flattened across two splits.  The rank's whole
    experts, the router replicated."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    B, S, d = x.shape
    dm = mesh.device_mesh
    split = 0
    while (split < len(tok_axes)
           and B % mesh.axis_size(tok_axes[:split + 1]) == 0):
        split += 1
    rows, rest = tok_axes[:split], tok_axes[split:]
    x_pl = dctx.spec_placements((rows or None, None, None), dm)
    work = dctx.spec_placements((tok_axes or None,), dm)
    e_pl = dctx.spec_placements(
        (model_axis if n_shards > 1 else None, None, None), dm)
    rep = [Replicate()] * dm.ndim

    def body(xl, wr, wi, wg, wo):
        lp = types.SimpleNamespace(router=functools.partial(F.linear,
                                                            weight=wr),
                                   wi=wi, wg=wg, wo=wo)
        xt = xl.reshape(-1, d)
        if rest:
            xt = dctx.local_block(xt, (rest,), mesh)
        out, aux = _local_moe(xt, lp, cfg, n_shards,
                              model_axis if n_shards > 1 else None, psum_mode)
        if rest:
            out = dctx.gather_block(out, (rest,), mesh)
        return (out.reshape(xl.shape),
                _aux_mean(mesh, aux, tok_axes, model_axis))

    g_rep, g_e = (dctx.grad_placements(rep, work),
                  dctx.grad_placements(e_pl, work))
    out, aux = local_map(body, out_placements=(x_pl, rep),
                         in_placements=(x_pl, rep, e_pl, e_pl, e_pl),
                         in_grad_placements=(dctx.grad_placements(x_pl,
                                                                  work),
                                             g_rep, g_e, g_e, g_e),
                         device_mesh=dm, redistribute_inputs=True)(
        x, p.router.weight, p.wi, p.wg, p.wo)
    keep = [pl if pl == Shard(0) else Replicate() for pl in x.placements]
    if list(out.placements) != keep:
        out = out.redistribute(dm, keep)
    return out, aux


def moe_apply(p: MoE, x: torch.Tensor,
              cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss scalar), both whole on
    every rank of an installed mesh."""
    B, S, d = x.shape
    mesh = dctx.current_mesh()
    model_axis = dctx.model_axis_name()
    if mesh is None or model_axis is None:
        out, aux = _local_moe(x.reshape(B * S, d), p, cfg, 1, None)
        return out.reshape(B, S, d), aux

    n_shards = mesh.axis_size(model_axis)
    dp_axes = dctx.data_axis_names()
    T = B * S
    # token partitioning for dispatch, by preference: (dp x model),
    # (model), replicated + psum
    dp_size = 1
    for a in dp_axes:
        dp_size *= mesh.shape[a]
    if T % (dp_size * n_shards) == 0:
        tok_axes = tuple(dict.fromkeys(tuple(dp_axes) + (model_axis,)))
        psum_mode = False
    elif T % n_shards == 0:
        tok_axes, psum_mode = (model_axis,), False
    else:
        tok_axes, psum_mode = (), True
    x_spec = (tok_axes or None, None)
    if dctx.is_dtensor(x):
        return _moe_local_map(p, x, cfg, mesh, n_shards, model_axis,
                              psum_mode, tok_axes)
    xt = x.reshape(B * S, d)
    out, aux = _local_moe(dctx.local_block(xt, x_spec, mesh), p, cfg,
                          n_shards, model_axis if n_shards > 1 else None,
                          psum_mode)
    aux = _aux_mean(mesh, aux, tok_axes, model_axis)
    return dctx.gather_block(out, x_spec, mesh).reshape(B, S, d), aux
