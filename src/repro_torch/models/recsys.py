"""CTR / ranking model family: DeepFM, xDeepFM, Wide&Deep, AutoInt (the
torch counterpart of ``repro.models.recsys``).

All four share the fused EmbeddingBag (``embedding.py``); they differ in
the feature-interaction stage:

  deepfm    - FM second-order (the fm_interaction kernel, K8)
              + first-order wide term + deep MLP            [1703.04247]
  xdeepfm   - CIN (compressed interaction network) + MLP    [1803.05170]
  wide-deep - linear wide term + deep MLP                   [1606.07792]
  autoint   - multi-head self-attention over field embeddings
              with residual projections                     [1810.11921]

Serving produces (score, item embedding) pairs so the DPP reranker
(``repro_torch.serving``) can diversify slates; training minimises
``bce_loss`` (``repro_torch.launch.train``).  Under ``axis_rules`` with a
``ModelMesh`` (``repro_torch.distributed``) a rank holds its rows of
``table`` and ``wide`` (``convert.place_on_mesh``), the bags run
``repro``'s psum or all-to-all body by ``emb_mode``, and the rest of the
forward, K8 included, runs whole on every rank.  The FM term is
differentiable: on the card its gradient comes from K8's hand-written
backward.  The tables' gradients are dense, as ``jax.grad`` gives them
through ``repro``'s gather, so AdamW moves every row.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.distributed.context import constrain, is_dtensor
from repro_torch.kernels.fm_interaction import fm_interaction
from repro_torch.models.embedding import (
    EmbeddingSpec,
    embedding_bag,
    init_table,
)
from repro_torch.models.layers import MLPHead, dense


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    vocab_sizes: Tuple[int, ...]  # one entry per sparse field
    embed_dim: int
    interaction: str  # fm | cin | concat | self-attn
    mlp_dims: Tuple[int, ...] = ()
    cin_layers: Tuple[int, ...] = ()
    attn_layers: int = 0
    attn_heads: int = 0
    d_attn: int = 0
    hot_size: int = 1  # ids per field (multi-hot bags supported)
    item_field: int = 0  # which field is the "item" (retrieval / DPP rerank)
    emb_mode: str = "psum"  # psum | alltoall (on a mesh; see embedding)
    dtype: Any = torch.float32

    @property
    def n_fields(self) -> int:
        return len(self.vocab_sizes)

    @property
    def spec(self) -> EmbeddingSpec:
        return EmbeddingSpec(self.vocab_sizes, self.embed_dim)

    def param_count(self) -> int:
        """The count ``repro`` reports: both tables and the MLP's hidden
        layers (not its output projection, the CIN or the attention)."""
        total = self.spec.total_rows * self.embed_dim
        total += self.spec.total_rows  # wide/first-order table
        d_in = self.n_fields * self.embed_dim
        dims = (d_in,) + tuple(self.mlp_dims)
        for a, b in zip(dims[:-1], dims[1:]):
            total += a * b + b
        return total


class RecsysModel(nn.Module):
    """The parameters of one ``RecsysConfig`` (``repro``'s ``init_params``
    tree as modules): ``table``, ``wide``, ``bias``, ``mlp``, ``cin`` /
    ``cin_out`` and ``attn`` / ``attn_out`` where the interaction has them.

    With ``generator`` the parameters are drawn on the generator's device
    from the distributions ``repro`` uses (not its numbers: the two
    frameworks' generators differ); without one they are allocated on
    ``device`` (default the card) for a converter to fill.
    """

    def __init__(self, cfg: RecsysConfig,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(generator.device if generator is not None
                             else device)
        dt, F, D = cfg.dtype, cfg.n_fields, cfg.embed_dim
        kw = dict(generator=generator, device=dev, dtype=dt)

        def table(spec):
            if generator is None:
                return nn.Parameter(torch.empty(
                    (spec.total_rows, spec.dim), device=dev, dtype=dt))
            return nn.Parameter(init_table(generator, spec, dt))

        self.table = table(cfg.spec)
        self.wide = table(EmbeddingSpec(cfg.vocab_sizes, 1))
        self.bias = nn.Parameter(torch.zeros((), device=dev, dtype=dt))
        self.mlp = (MLPHead([F * D] + list(cfg.mlp_dims), **kw)
                    if cfg.mlp_dims else None)
        if cfg.interaction == "cin":
            sizes = (F,) + tuple(cfg.cin_layers)
            ws = []
            for h_in, h_out in zip(sizes[:-1], sizes[1:]):
                w = torch.empty((h_out, h_in, F), device=dev, dtype=dt)
                if generator is not None:
                    w.normal_(generator=generator).mul_((h_in * F) ** -0.5)
                ws.append(nn.Parameter(w))
            self.cin = nn.ParameterList(ws)
            self.cin_out = dense(sum(cfg.cin_layers), 1, bias=True, **kw)
        if cfg.interaction == "self-attn":
            d_l, layers = D, []
            d_out = cfg.attn_heads * cfg.d_attn
            for _ in range(cfg.attn_layers):
                layers.append(nn.ModuleDict(
                    {n: dense(d_l, d_out, **kw) for n in ("wq", "wk", "wv",
                                                          "wr")}))
                d_l = d_out
            self.attn = nn.ModuleList(layers)
            self.attn_out = dense(F * d_l, 1, bias=True, **kw)


def init_params(generator: torch.Generator, cfg: RecsysConfig) -> RecsysModel:
    """``repro``'s ``init_params(rng, cfg)``: a ``RecsysModel`` drawn from
    ``generator`` on its device."""
    return RecsysModel(cfg, generator=generator)


# ---------------------------------------------------------------------------
# interactions
# ---------------------------------------------------------------------------


def fm_second_order(emb: torch.Tensor) -> torch.Tensor:
    """(B, F, D) -> (B,)  0.5 * sum_d[(sum_f v)^2 - sum_f v^2], through the
    fm_interaction kernel (K8) on the card, its plain version on the
    CPU.  On a DTensor K8 runs under ``local_map`` on the rank's block of
    examples (any split of F or D gathered first)."""
    if not is_dtensor(emb):
        return fm_interaction(emb)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    pl = [p if p == Shard(0) else Replicate() for p in emb.placements]
    return local_map(fm_interaction, out_placements=pl, in_placements=(pl,),
                     device_mesh=emb.device_mesh,
                     redistribute_inputs=True)(emb)


def cin(emb: torch.Tensor, weights, out_proj: nn.Linear) -> torch.Tensor:
    """Compressed Interaction Network (xDeepFM §3). emb (B, F, D) -> (B,)."""
    x0 = xk = emb
    pooled = []
    for W in weights:  # W (H_next, H_k, F)
        # z[b, h, m, d] = xk[b, h, d] * x0[b, m, d]; contract with W
        xk = torch.einsum("bhd,bmd,ohm->bod", xk, x0, W)
        pooled.append(xk.sum(2))  # (B, H_next)
    return out_proj(torch.cat(pooled, 1))[:, 0]


def autoint_layers(emb: torch.Tensor, layers, heads: int,
                   d_attn: int) -> torch.Tensor:
    """Stacked multi-head self-attention over fields.
    (B, F, D) -> (B, F, d')."""
    x = emb
    for p in layers:
        B, F, _ = x.shape
        q = p["wq"](x).reshape(B, F, heads, d_attn)
        k = p["wk"](x).reshape(B, F, heads, d_attn)
        v = p["wv"](x).reshape(B, F, heads, d_attn)
        s = torch.einsum("bfhd,bghd->bhfg", q, k) * (d_attn ** -0.5)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhfg,bghd->bfhd", a, v).reshape(B, F, heads * d_attn)
        x = torch.relu(o + p["wr"](x))
    return x


# ---------------------------------------------------------------------------
# forward / serving
# ---------------------------------------------------------------------------


def embed(model: RecsysModel, ids: torch.Tensor, cfg: RecsysConfig):
    """ids (B, F, H) -> (field embeddings (B, F, D), first-order term
    (B,))."""
    emb = embedding_bag(model.table, ids, cfg.spec, mode=cfg.emb_mode)
    emb = constrain(emb, "batch", None, None)
    wide = embedding_bag(model.wide, ids, EmbeddingSpec(cfg.vocab_sizes, 1),
                         mode=cfg.emb_mode)
    return emb, wide[..., 0].sum(1)


def forward_logits(model: RecsysModel, ids: torch.Tensor,
                   cfg: RecsysConfig) -> torch.Tensor:
    """ids (B, F, H) -> logits (B,) float32."""
    emb, first_order = embed(model, ids, cfg)
    logit = model.bias + first_order
    flat = emb.reshape(emb.shape[0], -1)
    if cfg.interaction == "fm":
        logit = logit + fm_second_order(emb)
        logit = logit + model.mlp(flat)[:, 0]
    elif cfg.interaction == "cin":
        logit = logit + cin(emb, model.cin, model.cin_out)
        logit = logit + model.mlp(flat)[:, 0]
    elif cfg.interaction == "concat":
        logit = logit + model.mlp(flat)[:, 0]
    elif cfg.interaction == "self-attn":
        h = autoint_layers(emb, model.attn, cfg.attn_heads, cfg.d_attn)
        logit = logit + model.attn_out(h.reshape(h.shape[0], -1))[:, 0]
    else:
        raise ValueError(cfg.interaction)
    return logit.to(torch.float32)


def bce_loss(model: RecsysModel, batch: dict,
             cfg: RecsysConfig) -> torch.Tensor:
    """batch: ids (B, F, H) int32, labels (B,) float -> the mean binary
    cross-entropy of the float32 logits (a 0-d tensor)."""
    z = forward_logits(model, batch["ids"], cfg)
    y = batch["labels"].to(torch.float32)
    return torch.mean(torch.clamp_min(z, 0) - z * y
                      + torch.log1p(torch.exp(-torch.abs(z))))


def serve_scores(model: RecsysModel, ids: torch.Tensor,
                 cfg: RecsysConfig) -> torch.Tensor:
    return torch.sigmoid(forward_logits(model, ids, cfg))


def item_embeddings(model: RecsysModel, item_ids: torch.Tensor,
                    cfg: RecsysConfig) -> torch.Tensor:
    """Item-side feature vectors (for DPP similarity). item_ids (M,) local
    ids within the item field -> (M, D) l2-normalized (over the batch
    axes on a mesh: a row-sharded table's rows are summed there)."""
    offs = int(cfg.spec.offsets[cfg.item_field])
    ids = (item_ids.to(torch.int64) + offs)[:, None, None]
    # a bag of one fused row id each (one field of the table's rows): on a
    # mesh the bag's own body fetches the rows from their owners
    whole = EmbeddingSpec((model.table.shape[0],), cfg.embed_dim,
                          pad_to_multiple=1)
    rows = embedding_bag(model.table, ids, whole, mode=cfg.emb_mode)[:, 0]
    norm = torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
    return rows / torch.clamp_min(norm, 1e-9)
