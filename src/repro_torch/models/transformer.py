"""Decoder-only transformer LM family (the torch counterpart of
``repro.models.transformer``): dense, MoE, and the local:global hybrid.

Covers the five LM configs of ``repro_torch.configs``:
  * dense GQA + RoPE + SwiGLU (phi3, qwen1.5 [qkv_bias], gemma3);
  * gemma3's 5:1 local:global attention (a sliding window a layer);
  * MoE FFN (olmoe top-8, arctic top-2 + a parallel dense residual).

The layer stack is an ``nn.ModuleList`` run in a Python loop, each layer
with its own window (an int, or None for global attention).  Where
gradients are recorded, every block runs through ``layers.remat``, as
``repro`` checkpoints its scan body: a backward pass keeps each block's
input and recomputes the rest one block at a time.  ``remat_chunks``
also recomputes each attention chunk inside the block (``repro``'s
``flash_remat``).  Paths without gradients run each block once, plainly.
Entry points:

  * ``forward_hidden`` - the final hidden states (and the roped K/V);
  * ``prefill``        - forward + KV-cache build + last-token logits;
  * ``decode_step``    - one token against the cache: ring buffers of the
    window's width for sliding-window layers, ``max_seq`` buffers for
    global layers, grouped by width (``layer_cache_plan``).
  * ``train_loss``     - next-token cross-entropy plus the MoE aux loss,
    the training objective (``repro_torch.launch.train``).

Under ``axis_rules`` with a ``ModelMesh`` (``repro_torch.distributed``)
every rank runs the same program: the MoE layers dispatch on the mesh
(``moe.moe_apply``: this rank's experts, ``all_to_all`` or ``psum``),
the rest runs whole on every rank, and the loss is whole on every rank.

``init_params(generator, cfg)`` draws the parameters on the generator's
device from ``repro``'s distributions (not its numbers); without a
generator ``Transformer(cfg, device=...)`` is left for
``repro_torch.models.convert.transformer_from_jax`` to fill.  Parameter
names follow ``repro``'s tree: ``embed``, ``layers[i].{ln1, attn, ln2,
mlp, moe}``, ``ln_f``, ``unembed``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.distributed.context import (
    constrain,
    current_mesh,
    grad_placements,
    is_dtensor,
    place,
)
from repro_torch.models import layers as L
from repro_torch.models.moe import MoE, MoEConfig, moe_apply


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    window: Optional[int] = None  # sliding window width for local layers
    global_every: Optional[int] = None  # every Nth layer is global (gemma3)
    moe: Optional[MoEConfig] = None
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    dtype: Any = torch.bfloat16
    norm_eps: float = 1e-6
    chunk_q: int = 512
    aux_loss_coef: float = 0.01
    remat_chunks: bool = False  # recompute attention chunks on backward

    @property
    def head_dim(self) -> int:
        return (self.d_head if self.d_head is not None
                else self.d_model // self.n_heads)

    def layer_windows(self) -> Tuple[Optional[int], ...]:
        """Per-layer attention window; None = full (global) attention."""
        if self.window is None:
            return (None,) * self.n_layers
        ge = self.global_every or 0
        return tuple(
            None if (ge and (i + 1) % ge == 0) else self.window
            for i in range(self.n_layers)
        )

    @property
    def uses_mixed_windows(self) -> bool:
        return len(set(self.layer_windows())) > 1

    def param_count(self) -> int:
        d, dh = self.d_model, self.head_dim
        attn = d * dh * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.moe is not None:
            ffn = (3 * d * self.moe.d_ff * self.moe.n_experts
                   + d * self.moe.n_experts)
            if self.moe_dense_residual:
                ffn += 3 * d * self.d_ff
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        return self.vocab * d * 2 + self.n_layers * per_layer + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        d, dh = self.d_model, self.head_dim
        attn = d * dh * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.moe is not None:
            ffn = (3 * d * self.moe.d_ff * self.moe.top_k
                   + d * self.moe.n_experts)
            if self.moe_dense_residual:
                ffn += 3 * d * self.d_ff
        else:
            ffn = 3 * d * self.d_ff
        return self.vocab * d * 2 + self.n_layers * (attn + ffn + 2 * d) + d


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """One layer's parameters: ``ln1``, ``attn``, ``ln2`` and ``mlp``
    (dense archs, arctic's residual) and/or ``moe``."""

    def __init__(self, cfg: TransformerConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=cfg.dtype)
        self.ln1 = L.RMSNorm(cfg.d_model, device=device, dtype=cfg.dtype)
        self.attn = L.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, qkv_bias=cfg.qkv_bias, **kw)
        self.ln2 = L.RMSNorm(cfg.d_model, device=device, dtype=cfg.dtype)
        self.moe = (MoE(cfg.d_model, cfg.moe, **kw)
                    if cfg.moe is not None else None)
        self.mlp = (L.MLP(cfg.d_model, cfg.d_ff, **kw)
                    if cfg.moe is None or cfg.moe_dense_residual else None)


class Transformer(nn.Module):
    """The parameters of one ``TransformerConfig`` (``repro``'s
    ``init_params`` tree as modules), on ``device`` (default the card) or,
    with ``generator``, drawn on the generator's device."""

    def __init__(self, cfg: TransformerConfig,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(generator.device if generator is not None
                             else device)
        d, V, dt = cfg.d_model, cfg.vocab, cfg.dtype

        def table(shape, scale):
            w = torch.empty(shape, device=dev, dtype=dt)
            if generator is not None:
                w.normal_(generator=generator).mul_(scale)
            return nn.Parameter(w)

        self.embed = table((V, d), 0.02)
        self.layers = nn.ModuleList(
            [Block(cfg, generator=generator, device=dev)
             for _ in range(cfg.n_layers)])
        self.ln_f = L.RMSNorm(d, device=dev, dtype=dt)
        self.unembed = table((d, V), d ** -0.5)


def init_params(generator: torch.Generator,
                cfg: TransformerConfig) -> Transformer:
    """``repro``'s ``init_params(rng, cfg)``: a ``Transformer`` drawn from
    ``generator`` on its device."""
    return Transformer(cfg, generator=generator)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def _ffn(p_l: Block, u: torch.Tensor, cfg: TransformerConfig):
    """The block's feed-forward half: (out, MoE aux loss)."""
    if cfg.moe is None:
        return L.mlp_apply(p_l.mlp, u), u.new_zeros((), dtype=torch.float32)
    out, aux = moe_apply(p_l.moe, u, cfg.moe)
    if cfg.moe_dense_residual:
        out = out + L.mlp_apply(p_l.mlp, u)
    return out, aux


def _block(p_l: Block, x: torch.Tensor, window: Optional[int],
           cfg: TransformerConfig, collect_kv: bool = False):
    """One transformer block; ``window`` an int or None (global).
    Returns (x, aux, (k, v) roped keys/values if collect_kv)."""
    B, S, _ = x.shape
    h = L.rmsnorm(p_l.ln1, x, cfg.norm_eps)
    q = L.split_heads(L.linear(p_l.attn.wq, h), cfg.n_heads, cfg.head_dim)
    k = L.split_heads(L.linear(p_l.attn.wk, h), cfg.n_kv_heads, cfg.head_dim)
    v = L.split_heads(L.linear(p_l.attn.wv, h), cfg.n_kv_heads, cfg.head_dim)
    pos = torch.arange(S, dtype=torch.int64, device=x.device)
    q = L.apply_rope(q, pos, cfg.rope_theta)
    k = L.apply_rope(k, pos, cfg.rope_theta)
    q = constrain(q, "batch", "seq", "heads", None)
    k = constrain(k, "batch", "seq", "heads", None)
    o = L.gqa_attention(q, k, v, window=window, chunk_q=cfg.chunk_q,
                        remat_chunks=cfg.remat_chunks)
    x = x + L.linear(p_l.attn.wo, L.merge_heads(o))
    ffn, aux = _ffn(p_l, L.rmsnorm(p_l.ln2, x, cfg.norm_eps), cfg)
    x = constrain(x + ffn, "batch", "seq", None)
    return x, aux, ((k, v) if collect_kv else None)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  Where the table's gradient is recorded on a
    DTensor (a training step) it runs under ``local_map``: every rank
    gathers the table whole, as FSDP does, and reads its block of the
    tokens; the table's gradient is each rank's share, summed onto the
    table's own split on the way back (DTensor's indexed write of that
    gradient fails on torch 2.11 for a table and tokens split over
    different axes).  A serving step keeps DTensor's own lookup, which
    gathers no table."""
    if not (is_dtensor(table) and table.requires_grad
            and torch.is_grad_enabled()):
        return table[tokens]
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    dm = table.device_mesh
    rep = [Replicate()] * dm.ndim
    t_pl = list(tokens.placements) if is_dtensor(tokens) else rep
    return local_map(lambda w, t: w[t], out_placements=t_pl,
                     in_placements=(rep, t_pl),
                     in_grad_placements=(grad_placements(rep, t_pl), t_pl),
                     device_mesh=dm, redistribute_inputs=True)(table, tokens)


def forward_hidden(params: Transformer, tokens: torch.Tensor,
                   cfg: TransformerConfig, collect_kv: bool = False):
    """tokens (B, S) -> (hidden (B, S, d), aux loss, kv or None).

    ``collect_kv``: also return the roped K/V stacked over layers, each
    (L, B, S, KV, dh), for the prefill cache.  Each block runs through
    ``layers.remat``."""
    x = constrain(embed_tokens(params.embed, tokens), "batch", "seq", None)
    auxs, ks, vs = [], [], []
    for p_l, w in zip(params.layers, cfg.layer_windows()):
        x, aux, kv = L.remat(_block, p_l, x, w, cfg, collect_kv)
        auxs.append(aux)
        if collect_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    x = L.rmsnorm(params.ln_f, x, cfg.norm_eps)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return x, torch.stack(auxs).sum(), kvs


def logits_from_hidden(params: Transformer,
                       hidden: torch.Tensor) -> torch.Tensor:
    return constrain(hidden @ params.unembed, "batch", None, "vocab")


def train_loss(params: Transformer, batch: dict,
               cfg: TransformerConfig) -> torch.Tensor:
    """Next-token cross-entropy (f32 logsumexp) + MoE aux loss (summed
    over the layers) times ``cfg.aux_loss_coef``."""
    tokens = batch["tokens"]
    hidden, aux, _ = forward_hidden(params, tokens, cfg)
    logits = logits_from_hidden(params, hidden[:, :-1]).to(torch.float32)
    targets = tokens[:, 1:].to(torch.int64)
    ce = torch.mean(_token_ce(logits, targets))
    return ce + cfg.aux_loss_coef * aux


def _token_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Each token's ``logsumexp(logits) - logits[target]`` (float32).  On a
    DTensor whose vocabulary is split it runs under ``local_map`` on each
    rank's block of the vocabulary: the running max by an all-gather, the
    normaliser and the target's logit by sums over the vocabulary's
    ranks, so no rank gathers the logits."""
    if not is_dtensor(logits):
        lse = torch.logsumexp(logits, dim=-1)
        return lse - torch.gather(logits, -1, targets[..., None])[..., 0]
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dm = logits.device_mesh
    names = dm.mesh_dim_names
    l_pl = [p if p in (Shard(0), Shard(2)) else Replicate()
            for p in logits.placements]
    t_pl = [Replicate() if p == Shard(2) else p for p in l_pl]
    v_axes = tuple(names[i] for i, p in enumerate(l_pl) if p == Shard(2))
    mesh = current_mesh()

    def body(lg, tg):
        if not v_axes:
            return _token_ce(lg, tg)
        V = lg.shape[-1]
        lo = mesh.axis_index(v_axes) * V
        m = mesh.all_gather(lg.detach().amax(dim=-1), v_axes).amax(0)
        lse = m + torch.log(mesh.psum(torch.exp(lg - m[..., None]).sum(-1),
                                      v_axes))
        t = tg - lo
        hit = (t >= 0) & (t < V)
        got = torch.gather(lg, -1, torch.clamp(t, 0, V - 1)[..., None])
        return lse - mesh.psum(torch.where(hit, got[..., 0], 0.0), v_axes)

    return local_map(body, out_placements=t_pl, in_placements=(l_pl, t_pl),
                     device_mesh=dm, redistribute_inputs=True)(logits,
                                                              targets)


# ---------------------------------------------------------------------------
# KV cache: group assignment (single source of truth), prefill, decode
# ---------------------------------------------------------------------------


def layer_cache_plan(cfg: TransformerConfig,
                     max_seq: int) -> List[Tuple[int, str, int]]:
    """Per-layer (width, group_key, index_in_group); groups keyed by width.

    Local (sliding-window) layers get ring buffers of width ``window``;
    global layers get full ``max_seq`` buffers.  Uniform archs collapse
    to a single group.
    """
    plan: List[Tuple[int, str, int]] = []
    counters: Dict[str, int] = {}
    for w in cfg.layer_windows():
        width = min(w, max_seq) if w is not None else max_seq
        key = str(width)
        idx = counters.get(key, 0)
        counters[key] = idx + 1
        plan.append((width, key, idx))
    return plan


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               device=None) -> dict:
    """``{"pos": 0, "groups": {key: {"k", "v"}}}``, each group's buffers
    (n_layers_in_group, batch, width, KV, dh) zeros in ``cfg.dtype`` on
    ``device`` (default the card), placed as ``repro``'s cache is (batch
    over the data axes, width over ``"kv_seq"``) where the installed mesh
    places DTensors (``constrain``'s ``place``).  ``pos`` is a Python
    int."""
    dev = resolve_device(device)
    KV, dh = cfg.n_kv_heads, cfg.head_dim
    sizes: Dict[str, int] = {}
    widths: Dict[str, int] = {}
    for width, key, idx in layer_cache_plan(cfg, max_seq):
        sizes[key] = idx + 1
        widths[key] = width
    groups = {
        key: {kv: place(torch.zeros((n, batch, widths[key], KV, dh),
                                    dtype=cfg.dtype, device=dev),
                        None, "batch", "kv_seq", None, None)
              for kv in ("k", "v")}
        for key, n in sizes.items()
    }
    return {"pos": 0, "groups": groups}


def cache_max_seq(cfg: TransformerConfig, cache: dict) -> int:
    """Infer the max_seq a cache was built for."""
    widths = [int(k) for k in cache["groups"]]
    non_window = [w for w in widths if w != (cfg.window or -1)]
    return max(non_window) if non_window else widths[0]


def _decode_attn(p_attn: L.Attention, x: torch.Tensor, kc: torch.Tensor,
                 vc: torch.Tensor, pos: int, is_ring: bool,
                 cfg: TransformerConfig):
    """One-token attention against a (B, W, KV, dh) cache, whose slot for
    ``pos`` (``pos % W`` in a ring, else ``pos``) it writes in place.
    Returns (out (B, 1, d_model), kc, vc)."""
    B = x.shape[0]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    W = kc.shape[1]
    q = L.split_heads(L.linear(p_attn.wq, x), H, dh)
    k = L.split_heads(L.linear(p_attn.wk, x), KV, dh)
    v = L.split_heads(L.linear(p_attn.wv, x), KV, dh)
    pos_arr = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q = L.apply_rope(q, pos_arr, cfg.rope_theta)
    k = L.apply_rope(k, pos_arr, cfg.rope_theta)

    slot = pos % W if is_ring else pos
    if is_dtensor(kc):
        # a cache split over its width: each rank writes the slot where it
        # holds it (an indexed write would land in a gathered copy)
        hit = (torch.arange(W, device=x.device) == slot)[None, :, None, None]
        kc.copy_(torch.where(hit, k.to(kc.dtype), kc))
        vc.copy_(torch.where(hit, v.to(vc.dtype), vc))
    else:
        kc[:, slot] = k[:, 0].to(kc.dtype)
        vc[:, slot] = v[:, 0].to(vc.dtype)

    idx = torch.arange(W, dtype=torch.int64, device=x.device)
    kv_pos = pos - torch.remainder(pos - idx, W) if is_ring else idx
    mask = (kv_pos >= 0) & (kv_pos <= pos)
    o = _decode_core(q, kc, vc, mask, KV).reshape(B, 1, H * dh).to(x.dtype)
    return L.linear(p_attn.wo, o), kc, vc


def _decode_core(q, kc, vc, mask, KV: int):
    """q (B, 1, H, dh) against the cache kc, vc (B, W, KV, dh) under
    ``mask (W,)``: (B, KV, G, dh) float32.  On DTensors it runs under
    ``local_map`` on each rank's block of the batch and of the cache's
    width (:func:`_decode_core_split`)."""
    if is_dtensor(q):
        return _decode_core_split(q, kc, vc, mask, KV)
    dh = q.shape[-1]
    qg = L.group_heads(q, KV)[:, 0].float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, kc.float()) * (dh ** -0.5)
    s = s.masked_fill(~mask[None, None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,btkd->bkgd", p, vc.float())


def _decode_core_split(q, kc, vc, mask, KV: int):
    """``_decode_core`` on DTensors: each rank takes its batch block and
    its block of the cache's width (``"kv_seq"``), scores its keys, and
    the softmax is combined over the width's ranks (the running max by an
    all-gather, the normaliser and the output by sums), so no rank
    gathers the cache."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dm = q.device_mesh
    names = dm.mesh_dim_names
    q_pl, c_pl, w_axes = [], [], []
    for i, (pq, pc) in enumerate(zip(q.placements, kc.placements)):
        if pc == Shard(1):
            q_pl.append(Replicate())
            c_pl.append(pc)
            w_axes.append(names[i])
        elif pq == Shard(0):
            q_pl.append(pq)
            c_pl.append(pq)
        else:
            q_pl.append(Replicate())
            c_pl.append(Replicate())
    mesh = current_mesh()
    w_axes = tuple(w_axes)

    def body(ql, kl, vl):
        if not w_axes:
            return _decode_core(ql, kl, vl, mask, KV)
        W = kl.shape[1]
        lo = mesh.axis_index(w_axes) * W
        dh = ql.shape[-1]
        qg = L.group_heads(ql, KV)[:, 0].float()
        s = torch.einsum("bkgd,btkd->bkgt", qg, kl.float()) * (dh ** -0.5)
        s = s.masked_fill(~mask[lo:lo + W][None, None, None], -1e30)
        m = mesh.all_gather(s.amax(dim=-1, keepdim=True), w_axes).amax(0)
        p = torch.exp(s - m)
        den = mesh.psum(p.sum(dim=-1, keepdim=True), w_axes)
        num = mesh.psum(torch.einsum("bkgt,btkd->bkgd", p, vl.float()),
                        w_axes)
        return num / den

    return local_map(body, out_placements=q_pl, in_placements=(q_pl, c_pl,
                                                               c_pl),
                     device_mesh=dm, redistribute_inputs=True)(q, kc, vc)


def _decode_block(p_l: Block, x: torch.Tensor, kc, vc, pos: int,
                  is_ring: bool, cfg: TransformerConfig):
    h = L.rmsnorm(p_l.ln1, x, cfg.norm_eps)
    h, kc, vc = _decode_attn(p_l.attn, h, kc, vc, pos, is_ring, cfg)
    x = x + h
    ffn, _ = _ffn(p_l, L.rmsnorm(p_l.ln2, x, cfg.norm_eps), cfg)
    return x + ffn, kc, vc


def decode_step(params: Transformer, cache: dict, tokens: torch.Tensor,
                cfg: TransformerConfig):
    """One decoding step.  tokens (B, 1) -> (logits (B, vocab) float32,
    cache').  The cache's buffers are written in place (each layer's slot
    for this position) and returned with ``pos + 1``; layers run in
    schedule order, each against its group's buffer."""
    pos = int(cache["pos"])
    x = embed_tokens(params.embed, tokens[:, :1])
    plan = layer_cache_plan(cfg, cache_max_seq(cfg, cache))
    groups = cache["groups"]
    for p_l, (_, key, gidx), w in zip(params.layers, plan,
                                      cfg.layer_windows()):
        g = groups[key]
        x, _, _ = _decode_block(p_l, x, g["k"][gidx], g["v"][gidx], pos,
                                w is not None, cfg)
    x = L.rmsnorm(params.ln_f, x, cfg.norm_eps)
    logits = (x[:, 0] @ params.unembed).float()
    return logits, {"pos": pos + 1, "groups": groups}


def prefill(params: Transformer, tokens: torch.Tensor,
            cfg: TransformerConfig, max_seq: int):
    """Prefill: one forward pass over the prompt (collecting the roped
    K/V), build the decode cache, return the last token's logits
    (float32) and the cache.  A ring layer keeps the last ``width``
    tokens, token t at slot ``t % width``."""
    B, S = tokens.shape
    hidden, _, (ks, vs) = forward_hidden(params, tokens, cfg,
                                         collect_kv=True)
    logits = (hidden[:, -1] @ params.unembed).float()

    cache = init_cache(cfg, B, max_seq, device=tokens.device)
    for i, (width, key, gidx) in enumerate(layer_cache_plan(cfg, max_seq)):
        g = cache["groups"][key]
        if width >= S:
            g["k"][gidx, :, :S] = ks[i].to(g["k"].dtype)
            g["v"][gidx, :, :S] = vs[i].to(g["v"].dtype)
        else:
            # ring layout: token t -> slot t % width; last ``width`` survive
            slots = torch.arange(width, dtype=torch.int64,
                                 device=tokens.device)
            tok = (S - width) + torch.remainder(slots - (S - width), width)
            g["k"][gidx] = ks[i][:, tok].to(g["k"].dtype)
            g["v"][gidx] = vs[i][:, tok].to(g["v"].dtype)
    cache["pos"] = S
    return logits, cache
