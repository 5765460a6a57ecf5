"""Mixture-of-Experts layer (the torch counterpart of
``repro.models.moe``): GShard-style top-k token-choice routing with a
per-expert capacity.

Only ``repro``'s branch without a mesh is ported (one expert shard, no
collectives).  The expert-parallel dispatch over a mesh (its
``all_to_all`` and ``psum`` branches) waits for the model-parallel mesh,
ROADMAP queue 1 item 12c: ``moe_apply`` with a mesh raises rather than
run unsharded.

The router weight is float32 in a bf16 model and so are its logits.
Ties between routing probabilities go to the lower expert index, as
``jax.lax.top_k`` breaks them (a stable descending sort; ``torch.topk``
promises no order).  ``cap = max(8, int(capacity_factor * T * K / E))``
slots an expert; a (token, slot) pair at position ``cap`` or later in its
expert's stable order is dropped and reads back 0.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models.layers import _init_device, dense

MESH_REFUSAL = (
    "the expert-parallel MoE dispatch over a mesh is not ported (ROADMAP "
    "queue 1 item 12c, the model-parallel mesh); call moe_apply without "
    "a mesh"
)


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


def dispatch_positions(top_e: torch.Tensor, n_experts: int,
                       cap: int) -> torch.Tensor:
    """(T * K,) each (token, slot) pair's position within its expert, in
    the stable order of the flat expert ids; ``cap`` where dropped."""
    flat_e = top_e.reshape(-1)
    n = flat_e.numel()
    sort_idx = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts  # exclusive prefix
    pos_sorted = torch.arange(n, device=flat_e.device) - starts[
        flat_e[sort_idx]]
    pos = torch.empty_like(pos_sorted).scatter_(0, sort_idx, pos_sorted)
    return torch.clamp_max(pos, cap)


def capacity(cfg: MoEConfig, T: int) -> int:
    """Slots an expert for T tokens: ``max(8, int(cf * T * K / E))``."""
    return max(8, int(cfg.capacity_factor * T * cfg.top_k / cfg.n_experts))


def _local_moe(x: torch.Tensor, p: MoE, cfg: MoEConfig, n_shards: int = 1,
               model_axis: Optional[str] = None, psum_mode: bool = False):
    """The MoE body on one device: x (T, d) -> (out (T, d), aux loss)."""
    if n_shards != 1 or model_axis is not None or psum_mode:
        raise NotImplementedError(MESH_REFUSAL)
    T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, T)

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

    # --- the experts ---
    h = torch.einsum("ecd,edf->ecf", buf, p.wi)
    g = torch.einsum("ecd,edf->ecf", buf, p.wg)
    out_buf = torch.einsum("ecf,efd->ecd", F.silu(g) * h, p.wo)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((E, 1, d))], dim=1)
    slot_out = out_buf[flat_e, pos]  # a dropped pair reads the zero slot

    # --- combine: weight slots, sum over K ---
    slot_out = slot_out.reshape(T, K, d) * top_w[..., None].to(x.dtype)
    return slot_out.sum(dim=1), aux


def moe_apply(p: MoE, x: torch.Tensor, cfg: MoEConfig,
              mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss scalar).  With a ``mesh``
    it raises ``NotImplementedError`` (item 12c)."""
    if mesh is not None:
        raise NotImplementedError(MESH_REFUSAL)
    B, S, d = x.shape
    out, aux = _local_moe(x.reshape(B * S, d), p, cfg)
    return out.reshape(B, S, d), aux
