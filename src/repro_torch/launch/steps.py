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

Every cell of ``repro``: the serving cells (an LM's prefill and decode,
``decode_32k`` and ``long_500k``, a recsys model's serve and retrieval
shapes) and the training cells (an LM's ``train_4k``, a recsys model's
``train_batch``, graphcast's four graph shapes), under ``repro``'s
profiles (``fsdp_ep``, its remat variant, ``flash_remat``,
``a2a_emb``).  A training step is ``repro``'s ``_train_wrapper``: the
loss, its gradients (each redistributed to its parameter's placements:
FSDP's reduce-scatter, the all-reduce of a replicated leaf), then AdamW
at ``AdamWConfig()`` on moments placed like the parameters.
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
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as recsys_mod
from repro_torch.models.convert import repro_leaves
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.serving import DPPRerankConfig, Reranker, RerankRequest


@dataclasses.dataclass
class Cell:
    """One cell: ``step_fn(*args)`` on the mesh.  ``leaves`` names every
    argument leaf (``params/<repro path>[/<layer>]``, ``opt/m/...``,
    ``opt/v/...``, ``opt/step``, ``batch/...``, ``cache/...``) with
    ``(tensor, spec in the port's layout, repro path, transposed,
    stacked)``; ``fake_mode`` is the mode the fake arguments belong to
    (None for a cell of real tensors); ``train``: the step records
    gradients (a training cell)."""

    arch_id: str
    shape_name: str
    step_fn: Callable
    args: Tuple[Any, ...]
    leaves: dict
    notes: str = ""
    model_flops_per_step: float = 0.0
    fake_mode: Any = None
    train: bool = False

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

    def params(self, family, model, rules, profile, train=False):
        specs = param_specs(family, model, self.mesh, rules, profile)
        names = repro_leaves(model)
        place_params(model, self.mesh, {
            n: dctx.spec_placements(s, self.mesh)
            for n, s in specs.items()}, requires_grad=train)
        for name, prm in model.named_parameters():
            path, transposed, stacked = names[name]
            self.leaves[f"params/{name}"] = (prm, specs[name],
                                             f"params/{path}", transposed,
                                             stacked)
        return model

    def opt(self, model):
        """AdamW's state of ``model``'s placed parameters: ``m`` and ``v``
        placed like each parameter (leaves ``opt/m/<repro path>``,
        ``opt/v/...``), ``step`` replicated (``opt/step``)."""
        opt = adamw_init(dict(model.named_parameters()))
        for name in opt["m"]:
            _, spec, path, transposed, stacked = self.leaves[
                f"params/{name}"]
            leaf = path[len("params/"):]
            for k in ("m", "v"):
                self.leaves[f"opt/{k}/{name}"] = (
                    opt[k][name], spec, f"opt/{k}/{leaf}", transposed,
                    stacked)
        self.leaves["opt/step"] = (opt["step"], (), "opt/step", False, False)
        return opt

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
    train = shape.kind == "train"
    with b.mode():
        model = params if params is not None else tfm.Transformer(
            cfg, device=b.device)
        b.params("lm", model, rules, profile, train=train)
        batch = batch or {}
        if train:
            opt = b.opt(model)
            seq = _res(rules, "seq")  # fsdp_ep: the sequence over "model"
            tokens = b.tensor("batch/tokens", batch.get("tokens"), (B, S),
                              torch.int32, (b_axes or None, seq))
    if train:
        return Cell(arch.id, shape.name, train_step(
            lambda p, bt: tfm.train_loss(p, bt, cfg)),
                    (model, opt, {"tokens": tokens}), b.leaves,
                    model_flops_per_step=6.0 * cfg.active_param_count() * B
                    * S, fake_mode=b.fake_mode, train=True)
    with b.mode():
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


def _gnn_dims(shape: ShapeSpec) -> Tuple[int, int, str]:
    """``repro``'s graph size of a GNN shape: ``(nodes, edges, note)``,
    both padded to a multiple of 512."""
    if shape.name == "minibatch_lg":
        b, (f1, f2) = shape.batch_nodes, shape.fanout
        n = b * (1 + f1 + f1 * f2)
        e = b * f1 + b * f1 * f2
        note = f"sampled subgraph: {b} seeds, fanout {shape.fanout}, padded"
    elif shape.name == "molecule":
        n = shape.n_graphs * shape.nodes_per_graph
        e = shape.n_graphs * shape.edges_per_graph
        note = f"{shape.n_graphs} disjoint molecules"
    else:
        n, e = shape.n_nodes, shape.n_edges
        note = "full graph"
    return _round_up(n, 512), _round_up(e, 512), note + " (padded to /512)"


def _gnn_cell(arch: ArchSpec, shape: ShapeSpec, mesh, rules, b: _Builder,
              params, batch, profile: str) -> Cell:
    cfg = dataclasses.replace(arch.config, d_feat=shape.d_feat)
    N, E, note = _gnn_dims(shape)
    nodes, edges = _res(rules, "nodes"), _res(rules, "edges")
    batch = batch or {}
    with b.mode():
        model = params if params is not None else gnn_mod.GNN(
            cfg, device=b.device)
        b.params("gnn", model, rules, profile, train=True)
        opt = b.opt(model)
        args = {k: b.tensor(f"batch/{k}", batch.get(k), shp, dt, spec)
                for k, shp, dt, spec in (
                    ("node_feats", (N, cfg.d_feat), torch.float32,
                     (nodes, None)),
                    ("edges", (E, 2), torch.int32, (edges, None)),
                    ("targets", (N, cfg.n_vars), torch.float32,
                     (nodes, None)),
                    ("node_mask", (N,), torch.bool, (nodes,)),
                    ("edge_mask", (E,), torch.bool, (edges,)))}
    # the processor's MLPs, per edge and per node, x3 for the backward
    fwd = cfg.n_layers * (
        E * 2 * (2 * cfg.d_hidden + cfg.d_edge) * cfg.d_hidden
        + N * 2 * (cfg.d_hidden + cfg.d_edge) * cfg.d_hidden)
    return Cell(arch.id, shape.name, train_step(
        lambda p, bt: gnn_mod.mse_loss(p, bt, cfg)), (model, opt, args),
                b.leaves, notes=note, model_flops_per_step=3.0 * fwd,
                fake_mode=b.fake_mode, train=True)


def _replicated(x):
    """A DTensor whole on every rank (a partial sum completed)."""
    from torch.distributed.tensor import Replicate

    if not dctx.is_dtensor(x):
        return x
    want = [Replicate()] * x.device_mesh.ndim
    return x if list(x.placements) == want else x.redistribute(
        x.device_mesh, want)


def train_step(loss_fn: Callable):
    """``repro``'s ``_train_wrapper``: ``step(model, opt, batch) -> (model,
    opt, {"loss", "grad_norm"})``.  The loss (made whole on every rank),
    its gradients (zeros for a parameter it does not use, as
    ``jax.grad`` gives), each redistributed to its parameter's
    placements, then ``adamw_update`` at ``AdamWConfig()``, in place."""

    def step(model, opt, batch):
        params = dict(model.named_parameters())
        with torch.enable_grad():
            loss = _replicated(loss_fn(model, batch))
            raw = torch.autograd.grad(loss, list(params.values()),
                                      allow_unused=True)
        grads = {}
        for (name, p), g in zip(params.items(), raw):
            if g is None:
                g = torch.zeros_like(p)
            elif dctx.is_dtensor(g) and tuple(g.placements) != tuple(
                    p.placements):
                g = g.redistribute(p.device_mesh, p.placements)
            grads[name] = g
        _, opt, metrics = adamw_update(params, grads, opt,
                                       AdamWConfig())
        return model, opt, {"loss": loss.detach(), **metrics}

    return step


def _mlp_flops(cfg: recsys_mod.RecsysConfig) -> int:
    dims = (cfg.n_fields * cfg.embed_dim,) + tuple(cfg.mlp_dims) + (1,)
    return sum(2 * a * c for a, c in zip(dims[:-1], dims[1:]))


def _recsys_cell(arch: ArchSpec, shape: ShapeSpec, mesh, rules, b: _Builder,
                 params, batch, profile: str) -> Cell:
    cfg: recsys_mod.RecsysConfig = arch.config
    F, H = cfg.n_fields, cfg.hot_size
    batch = batch or {}
    train = shape.kind == "train"
    with b.mode():
        model = params if params is not None else recsys_mod.RecsysModel(
            cfg, device=b.device)
        b.params("recsys", model, rules, profile, train=train)

    if train:
        B = shape.batch
        b_axes = batch_axes_for(rules, B, mesh)
        with b.mode():
            opt = b.opt(model)
            ids = b.tensor("batch/ids", batch.get("ids"), (B, F, H),
                           torch.int32, (b_axes or None, None, None))
            labels = b.tensor("batch/labels", batch.get("labels"), (B,),
                              torch.float32, (b_axes or None,))
        return Cell(arch.id, shape.name, train_step(
            lambda p, bt: recsys_mod.bce_loss(p, bt, cfg)),
                    (model, opt, {"ids": ids, "labels": labels}), b.leaves,
                    model_flops_per_step=3.0 * B * _mlp_flops(cfg),
                    fake_mode=b.fake_mode, train=True)

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
    fn = {"lm": _lm_cell, "gnn": _gnn_cell,
          "recsys": _recsys_cell}[arch.family]
    return fn(arch, shape, mesh, rules, _Builder(mesh, params is not None),
              params, batch, profile)
