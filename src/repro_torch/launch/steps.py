"""Cell builders (the torch counterpart of ``repro.launch.steps``): (an
architecture x an input shape x a mesh) -> a step function and its
arguments, every argument a DTensor placed on the mesh by ``repro``'s
sharding rules.

``repro`` lowers a cell with ``ShapeDtypeStruct`` inputs and a sharding
for each; the port builds its arguments as fake tensors
(``FakeTensorMode``: shapes and dtypes, no storage) placed as DTensors,
so a cell of arctic-480b's 480B parameters allocates nothing, and
``repro_torch.launch.dryrun`` runs the step once on them.  Given real
parameters and a real batch (``params=``, ``batch=``), the same cell
runs them: each rank keeps its block of the whole tensors it was given.

Covered: the serving cells, an LM's prefill and decode (``decode_32k``,
``long_500k``) and a recsys model's serve and retrieval shapes, under
``repro``'s profiles (``fsdp_ep``, its remat variant, ``flash_remat``,
``a2a_emb``).  A training shape raises ``NotImplementedError``: the
training cells, with the gradients of the sharded bag and MoE bodies
and of FSDP, are ROADMAP item 12e(b).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed import context as dctx
from repro_torch.launch.shardings import (
    _res,
    batch_axes_for,
    local_shape,
    param_specs,
    place_params,
)
from repro_torch.models import recsys as recsys_mod
from repro_torch.models.convert import repro_leaves
from repro_torch.models import transformer as tfm
from repro_torch.serving import DPPRerankConfig, Reranker, RerankRequest

TRAINING_TODO = ("the training cells (train_4k, train_batch and graphcast's "
                 "shapes) are ROADMAP item 12e(b): they need the gradients "
                 "of the sharded bag and MoE bodies and of FSDP")


@dataclasses.dataclass
class Cell:
    """One cell: ``step_fn(*args)`` on the mesh.  ``leaves`` names every
    argument leaf (``params/<repro path>[/<layer>]``, ``batch/...``,
    ``cache/...``) with ``(tensor, spec in the port's layout, repro
    path, transposed, stacked)``; ``fake_mode`` is the mode the fake
    arguments belong to (None for a cell of real tensors)."""

    arch_id: str
    shape_name: str
    step_fn: Callable
    args: Tuple[Any, ...]
    leaves: dict
    notes: str = ""
    model_flops_per_step: float = 0.0
    fake_mode: Any = None

    def shard_shapes(self, mesh) -> dict:
        """``{repro leaf path: this rank's block shape}`` in ``repro``'s
        layout (a stacked leaf with its layer count in front)."""
        out = {}
        for t, spec, path, transposed, stacked in self.leaves.values():
            shape = local_shape(tuple(t.shape), spec, mesh)
            if transposed:
                shape = tuple(reversed(shape))
            if stacked:
                n = out.get(path, (0,))[0] + 1
                shape = (n,) + shape
            out[path] = shape
        return out

    def static_bytes(self, mesh) -> Tuple[int, int]:
        """This rank's argument bytes two ways: ``repro``'s rule (each
        leaf's bytes times the fraction of it the placement leaves the
        rank) and the local blocks' own bytes."""
        rule = held = 0
        for t, spec, _, _, _ in self.leaves.values():
            whole = t.numel() * t.element_size()
            frac = 1.0
            for a, b in zip(local_shape(tuple(t.shape), spec, mesh), t.shape):
                frac *= a / max(b, 1)
            rule += int(whole * frac)
            local = t.to_local() if dctx.is_dtensor(t) else t
            held += local.numel() * local.element_size()
        return rule, held


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _place(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    return dctx.as_dtensor(t, mesh, dctx.spec_placements(spec, mesh))


def _to(x, spec, mesh):
    """``x`` redistributed to ``spec`` (an output sharding of ``repro``'s
    cell)."""
    want = dctx.spec_placements(
        dctx.fix_spec(spec, x.shape, dict(zip(mesh.mesh_dim_names,
                                              mesh.shape))), mesh)
    return x if tuple(x.placements) == tuple(want) else x.redistribute(
        mesh, want)


class _Builder:
    """Makes a cell's tensors: fake ones in the cell's ``FakeTensorMode``
    (nothing allocated), or the caller's real ones, placed on ``mesh``."""

    def __init__(self, mesh, real: bool):
        from torch._subclasses.fake_tensor import FakeTensorMode

        self.mesh = mesh
        self.device = torch.device(mesh.device_type)
        self.fake_mode = None if real else FakeTensorMode(
            allow_non_fake_inputs=False)
        self.leaves: dict = {}

    def mode(self):
        return self.fake_mode if self.fake_mode is not None else (
            contextlib.nullcontext())

    def params(self, family, model, rules, profile):
        specs = param_specs(family, model, self.mesh, rules, profile)
        names = repro_leaves(model)
        place_params(model, self.mesh, {
            n: dctx.spec_placements(s, self.mesh)
            for n, s in specs.items()})
        for name, prm in model.named_parameters():
            path, transposed, stacked = names[name]
            self.leaves[f"params/{name}"] = (prm, specs[name],
                                             f"params/{path}", transposed,
                                             stacked)
        return model

    def tensor(self, name, given, shape, dtype, spec):
        t = given if given is not None else torch.zeros(
            shape, dtype=dtype, device=self.device)
        t = _place(t, spec, self.mesh)
        self.leaves[name] = (t, tuple(spec), name, False, False)
        return t


def _lm_cell(arch: ArchSpec, shape: ShapeSpec, mesh, rules, b: _Builder,
             params, batch, profile: str) -> Cell:
    cfg: tfm.TransformerConfig = arch.config
    B, S = shape.global_batch, shape.seq_len
    b_axes = batch_axes_for(rules, B, mesh)
    M = _res(rules, "model")
    kv_seq = _res(rules, "kv_seq")
    with b.mode():
        model = params if params is not None else tfm.Transformer(
            cfg, device=b.device)
        b.params("lm", model, rules, profile)
        batch = batch or {}
        S_in = S if shape.kind == "prefill" else 1
        tokens = b.tensor("batch/tokens", batch.get("tokens"), (B, S_in),
                          torch.int32, (b_axes or None, None))

    def out_logits(logits):
        return _to(logits, (b_axes or None, M), mesh)

    if shape.kind == "prefill":
        def step(params, batch):
            logits, cache = tfm.prefill(params, batch["tokens"], cfg,
                                        max_seq=S)
            return out_logits(logits), cache

        return Cell(arch.id, shape.name, step, (model, {"tokens": tokens}),
                    b.leaves,
                    model_flops_per_step=2.0 * cfg.active_param_count() * B
                    * S, fake_mode=b.fake_mode)

    # decode (decode_32k / long_500k): the cache is an argument (the
    # caller's, ``batch["cache"]``, or zeros at position 0)
    with b.mode():
        cache = batch.get("cache") or tfm.init_cache(cfg, B, S,
                                                     device=b.device)
        cache = {"pos": cache["pos"], "groups": {
            key: dict(g) for key, g in cache["groups"].items()}}
        for key, g in cache["groups"].items():
            for kv in ("k", "v"):
                g[kv] = b.tensor(f"cache/groups/{key}/{kv}", g[kv],
                                 tuple(g[kv].shape), cfg.dtype,
                                 (None, b_axes or None, kv_seq, None, None))

    def step(params, cache, batch):
        logits, cache = tfm.decode_step(params, cache, batch["tokens"], cfg)
        return out_logits(logits), cache

    return Cell(arch.id, shape.name, step, (model, cache, {"tokens": tokens}),
                b.leaves,
                model_flops_per_step=2.0 * cfg.active_param_count() * B,
                fake_mode=b.fake_mode)


def _mlp_flops(cfg: recsys_mod.RecsysConfig) -> int:
    dims = (cfg.n_fields * cfg.embed_dim,) + tuple(cfg.mlp_dims) + (1,)
    return sum(2 * a * c for a, c in zip(dims[:-1], dims[1:]))


def _recsys_cell(arch: ArchSpec, shape: ShapeSpec, mesh, rules, b: _Builder,
                 params, batch, profile: str) -> Cell:
    cfg: recsys_mod.RecsysConfig = arch.config
    F, H = cfg.n_fields, cfg.hot_size
    batch = batch or {}
    with b.mode():
        model = params if params is not None else recsys_mod.RecsysModel(
            cfg, device=b.device)
        b.params("recsys", model, rules, profile)

    if shape.kind == "serve":
        B = shape.batch
        b_axes = batch_axes_for(rules, B, mesh)
        with b.mode():
            ids = b.tensor("batch/ids", batch.get("ids"), (B, F, H),
                           torch.int32, (b_axes or None, None, None))

        def step(params, batch):
            scores = recsys_mod.serve_scores(params, batch["ids"], cfg)
            return _to(scores, (b_axes or None,), mesh)

        return Cell(arch.id, shape.name, step, (model, {"ids": ids}),
                    b.leaves, model_flops_per_step=1.0 * B * _mlp_flops(cfg),
                    fake_mode=b.fake_mode)

    # retrieval_cand: score 1M candidates for one user, then the DPP
    # rerank (repro's default backend, the torch core)
    Mc = shape.n_candidates
    Mc_p = _round_up(Mc, 512)  # pad so the candidate axis shards evenly
    b_axes = batch_axes_for(rules, Mc_p, mesh)
    rr = DPPRerankConfig(slate_size=50, shortlist=1000, alpha=4.0)
    session = Reranker(rr, device=b.device)
    with b.mode():
        user = b.tensor("batch/user_ids", batch.get("user_ids"), (1, F, H),
                        torch.int32, (None, None, None))
        cand = b.tensor("batch/cand_ids", batch.get("cand_ids"), (Mc_p,),
                        torch.int32, (b_axes or None,))

    def step(params, batch):
        return retrieval_step(params, batch["user_ids"], batch["cand_ids"],
                              Mc, cfg, session)

    return Cell(arch.id, shape.name, step, (model, {"user_ids": user,
                                                    "cand_ids": cand}),
                b.leaves,
                notes=(f"DPP rerank: shortlist={rr.shortlist} "
                       f"N={rr.slate_size} alpha={rr.alpha} (paper "
                       f"Algorithm 1, whole on every rank: the scores and "
                       f"features gathered)"),
                model_flops_per_step=1.0 * Mc * _mlp_flops(cfg),
                fake_mode=b.fake_mode)


def retrieval_step(model, user, cand, n_real: int, cfg, session: Reranker):
    """``repro``'s retrieval step: the user's fields broadcast over the
    padded candidates ``cand (Mc_p,)`` (the item field replaced by each
    candidate), scored, padding masked to -inf, then the DPP rerank of
    the scores and the candidates' item embeddings.  Returns ``(slate,
    d_hist)``, whole on every rank."""
    Mc_p = cand.shape[0]
    F, H = cfg.n_fields, cfg.hot_size
    dev = cand.device
    pad_mask = torch.arange(Mc_p, device=dev) < n_real
    ids = dctx.constrain(user.expand(Mc_p, F, H), "batch", None, None)
    c = cand[:, None, None].to(torch.int32)
    if H > 1:
        c = torch.cat([c, torch.full((Mc_p, 1, H - 1), -1, dtype=torch.int32,
                                     device=dev)], dim=2)
    ids = torch.cat([ids[:, :cfg.item_field], c,
                     ids[:, cfg.item_field + 1:]], dim=1)
    ids = dctx.constrain(ids, "batch", None, None)
    scores = recsys_mod.serve_scores(model, ids, cfg)
    scores = torch.where(pad_mask, scores, float("-inf"))
    feats = recsys_mod.item_embeddings(model, cand, cfg)
    if dctx.is_dtensor(scores):
        scores = dctx.gathered(scores)
        feats = dctx.gathered(feats)
    return session.rerank(RerankRequest(scores=scores, feats=feats))


def build_cell(arch: ArchSpec, shape: ShapeSpec, mesh, rules,
               profile: str = "baseline", *, params=None,
               batch: Optional[dict] = None) -> Cell:
    """The cell of ``arch`` at ``shape`` on the ``DeviceMesh`` ``mesh``
    under ``rules`` and ``profile``.  Without ``params`` every argument
    is a fake tensor of the mesh's device type; with ``params`` (the
    whole model, on the mesh's device) and ``batch`` (whole tensors by
    ``repro``'s batch keys, any missing ones zeros; a decode cell's
    ``"cache"`` a whole ``init_cache`` dict) the cell runs them."""
    if arch.family == "lm" and profile in ("flash_remat", "fsdp_ep_remat"):
        arch = dataclasses.replace(arch, config=dataclasses.replace(
            arch.config, remat_chunks=True))
    if profile == "a2a_emb" and arch.family == "recsys":
        arch = dataclasses.replace(arch, config=dataclasses.replace(
            arch.config, emb_mode="alltoall"))
    if shape.kind in ("train", "graph_train") or arch.family == "gnn":
        raise NotImplementedError(
            f"{arch.id} {shape.name}: {TRAINING_TODO}")
    fn = {"lm": _lm_cell, "recsys": _recsys_cell}[arch.family]
    return fn(arch, shape, mesh, rules, _Builder(mesh, params is not None),
              params, batch, profile)
