"""The port's training dry-run cells (``repro_torch.launch.steps``' train
branches, ``dryrun.trace`` with gradients) against ``repro``'s, on the
CPU.

A module fixture starts, at once, each a subprocess:

* this file as tracers (``python tests/test_torch_dryrun_train.py
  tracer OUT K``), each in one fake world of 512 ranks: tracer 0 builds
  every training cell under every profile on a (2, 4) mesh (each
  argument's shard shape, the optimizer's leaves included, and
  ``model_flops_per_step``), traces the recsys and graphcast cells under
  ``baseline`` at (2, 4), deepfm ``train_batch`` on the pod mesh under
  both recsys profiles (the hand count), the reduced qwen1.5-4b beside
  its remat profiles (the recompute's hand count) and the reduced cases
  below at (2, 2); tracers 1-5 trace one LM's ``train_4k`` each under
  ``baseline`` at (2, 4);
* ``repro``'s ``build_cell`` for the same 32 (cell, profile) pairs on
  an 8-device (2, 4) host mesh (a JAX subprocess);
* ``repro``'s loss, gradients and one ``_train_wrapper`` step for the
  reduced cases, on one device and under the profile's rules on a
  4-device (2, 2) host mesh (a JAX subprocess);
* four gloo ranks (``spawn_ranks``, this file as ``rank R ...``) running
  the reduced cases' training cells on a (2, 2) mesh of real tensors,
  their weights ``repro``'s initialisers' converted: DeepFM
  ``train_batch`` (B = 16) under ``baseline`` and ``a2a_emb``;
  qwen1.5-4b ``train_4k`` (B = 4, S = 32: two attention chunks) under
  ``baseline`` and ``fsdp_ep_remat``; olmoe-1b-7b ``train_4k`` (B = 4,
  S = 32) under ``baseline``; graphcast ``molecule`` cut to 4 graphs.

Bars: shard shapes and model FLOPs exactly; each real rank's collective
counts and bytes by kind, its FLOPs and its argument bytes equal the
fake world's exactly; every gradient on its parameter's placements;
loss, ``grad_norm`` and each gathered gradient, normwise per leaf
(DeepFM 1e-5, the LMs and the GNN 2e-4), against one process of the
same weights and against ``repro``'s ``jax.value_and_grad``, on one
device or, where a capacity depends on the rank's block (the MoE), on
the (2, 2) host mesh; the parameters after the step by
``chip_smoke.py``'s ``step_pair`` rule (an element whose gradient the
two sides give more than 1% apart may part by up to 2 lr, at most 1e-2
of them; every other element within rtol 1e-4 / atol 1e-5).
"""
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

LM_PROFILES = ("baseline", "fsdp_ep", "fsdp_ep_remat", "flash_remat")
PROFILES = {"lm": LM_PROFILES, "recsys": ("baseline", "a2a_emb"),
            "gnn": ("baseline",)}
REDUCED = {  # case: (arch, shape, shape fields, profiles)
    "deepfm": ("deepfm", "train_batch", dict(batch=16),
               ("baseline", "a2a_emb")),
    "qwen": ("qwen1.5-4b", "train_4k", dict(global_batch=4, seq_len=32),
             ("baseline", "fsdp_ep_remat")),
    "olmoe": ("olmoe-1b-7b", "train_4k", dict(global_batch=4, seq_len=32),
              ("baseline",)),
    "gnn": ("graphcast", "molecule", dict(n_graphs=4), ("baseline",)),
}
MESH_ONLY = {"olmoe"}  # the capacity is the rank's block's: repro's mesh
NORM_TOL = {"deepfm": 1e-5, "qwen": 2e-4, "olmoe": 2e-4, "gnn": 2e-4}
REMAT = (("flash_remat", "baseline"), ("fsdp_ep_remat", "fsdp_ep"))
WORLD = 4
LMS = ("phi3-mini-3.8b", "qwen1.5-4b", "gemma3-27b", "olmoe-1b-7b",
       "arctic-480b")


def training_cells():
    """Every training (arch, shape, profile) of the inventory."""
    from repro_torch.configs import get_arch, list_archs

    out = []
    for a in list_archs():
        spec = get_arch(a)
        for s, shape in spec.active_shapes().items():
            if shape.kind in ("train", "graph_train"):
                out += [(a, s, p) for p in PROFILES[spec.family]]
    return out


def reduced_arch(case):
    from repro_torch.configs import get_arch

    arch_id, shape_name, fields, _ = REDUCED[case]
    arch = get_arch(arch_id)
    arch = dataclasses.replace(arch, config=arch.reduced())
    return arch, dataclasses.replace(arch.shapes[shape_name], **fields)


def profiled(cfg, family, profile):
    """``cfg`` as ``build_cell`` runs it under ``profile``."""
    if family == "lm" and profile in ("flash_remat", "fsdp_ep_remat"):
        return dataclasses.replace(cfg, remat_chunks=True)
    if family == "recsys" and profile == "a2a_emb":
        return dataclasses.replace(cfg, emb_mode="alltoall")
    return cfg


def _key(*parts):
    return "|".join(parts)


def _jsonable(rec):
    return json.loads(json.dumps(rec))


# ---------------------------------------------------------------------------
# the tracers: one fake world of 512 ranks each
# ---------------------------------------------------------------------------


def tracer(out_dir, part):
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.hostdev import fake_world
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.launch.steps import build_cell

    fake_world(512)
    mesh = make_host_mesh(2, 4, device="cpu")
    res = {"traced": {}}
    if part:
        arch = get_arch(LMS[part - 1])
        rec, _ = dryrun.dry_run(arch, arch.shapes["train_4k"], mesh, "host")
        res["traced"][_key(arch.id, "train_4k")] = _jsonable(rec)
        Path(out_dir, f"tracer{part}.json").write_text(json.dumps(res))
        return

    res["shapes"] = {}
    for a, s, p in training_cells():
        arch = get_arch(a)
        cell = build_cell(arch, arch.shapes[s], mesh,
                          dryrun.rules_for(p, False), profile=p)
        res["shapes"][_key(a, s, p)] = {
            "shapes": {k: list(v) for k, v in
                       cell.shard_shapes(mesh).items()},
            "flops": cell.model_flops_per_step}
        if p == "baseline" and arch.family != "lm":
            rec, _ = dryrun.dry_run(arch, arch.shapes[s], mesh, "host")
            res["traced"][_key(a, s)] = _jsonable(rec)

    pod = make_production_mesh(device="cpu")
    arch = get_arch("deepfm")
    res["hand"] = {p: _jsonable(dryrun.dry_run(
        arch, arch.shapes["train_batch"], pod, "pod", p)[0])
                   for p in ("baseline", "a2a_emb")}

    four = make_host_mesh(2, 2, device="cpu")
    arch, shape = reduced_arch("qwen")
    res["remat"] = {p: _jsonable(dryrun.dry_run(arch, shape, four, "host",
                                                p)[0])
                    for pair in REMAT for p in pair}
    res["w4"] = {}
    for case, (_, _, _, profs) in REDUCED.items():
        arch, shape = reduced_arch(case)
        for p in profs:
            rec, _ = dryrun.dry_run(arch, shape, four, "host", p)
            res["w4"][_key(case, p)] = _jsonable(rec)
    Path(out_dir, "tracer0.json").write_text(json.dumps(res))


# ---------------------------------------------------------------------------
# the inputs, the models and one process
# ---------------------------------------------------------------------------


class _Npz(dict):
    """A dict of arrays read like an ``np.load`` archive."""

    @property
    def files(self):
        return list(self)


def _unflat(z, prefix):
    tree = {}
    for key in z.files:
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = z[key]

    def lists(t):
        if not isinstance(t, dict):
            return t
        t = {k: lists(v) for k, v in t.items()}
        if t and all(k.startswith("#") for k in t):
            return [t[f"#{i}"] for i in range(len(t))]
        return t

    return lists(tree)


def model_config(case):
    arch, shape = reduced_arch(case)
    if arch.family == "gnn":
        return dataclasses.replace(arch.config, d_feat=shape.d_feat)
    return arch.config


def port_model(case, z):
    from repro_torch.models import convert

    arch, _ = reduced_arch(case)
    tree = _unflat(z, case)
    fn = {"lm": convert.transformer_from_jax, "gnn": convert.gnn_from_jax,
          "recsys": convert.params_from_jax}[arch.family]
    return fn(tree, model_config(case), device="cpu")


BATCH_KEYS = {"deepfm": ("ids", "labels"), "qwen": ("tokens",),
              "olmoe": ("tokens",),
              "gnn": ("node_feats", "edges", "targets", "node_mask",
                      "edge_mask")}


def port_batch(case, z):
    import torch

    return {k: torch.from_numpy(np.asarray(z[f"{case}_{k}"]))
            for k in BATCH_KEYS[case]}


def loss_fn(case, profile):
    from repro_torch.models import gnn, recsys, transformer

    arch, _ = reduced_arch(case)
    cfg = profiled(model_config(case), arch.family, profile)
    fn = {"lm": transformer.train_loss, "gnn": gnn.mse_loss,
          "recsys": recsys.bce_loss}[arch.family]
    return lambda m, b: fn(m, b, cfg)


class _Grads:
    """Patches ``steps.adamw_update`` to keep the gradients it is handed
    (and whether each sits on its parameter's placements)."""

    def __init__(self):
        from repro_torch.launch import steps

        self.steps, self.orig, self.grads, self.placed = steps, (
            steps.adamw_update), {}, {}

    def __enter__(self):
        from repro_torch.distributed import context as dctx

        def keep(params, grads, opt, acfg, lr_scale=1.0):
            for n, g in grads.items():
                self.grads[n] = g.detach()
                p = params[n]
                self.placed[n] = (not dctx.is_dtensor(p)) or tuple(
                    g.placements) == tuple(p.placements)
            return self.orig(params, grads, opt, acfg, lr_scale)

        self.steps.adamw_update = keep
        return self

    def __exit__(self, *exc):
        self.steps.adamw_update = self.orig


def one_process(case, profile, z):
    """The step of the same weights on plain tensors in one process:
    ``(loss, grad_norm, {name: grad}, {name: parameter after})``."""
    from repro_torch.launch import steps
    from repro_torch.optim import adamw_init

    model = port_model(case, z)
    opt = adamw_init(dict(model.named_parameters()))
    with _Grads() as g:
        _, _, met = steps.train_step(loss_fn(case, profile))(
            model, opt, port_batch(case, z))
    return (float(met["loss"]), float(met["grad_norm"]),
            {n: t.numpy() for n, t in g.grads.items()},
            {n: p.detach().numpy() for n, p in model.named_parameters()})


# ---------------------------------------------------------------------------
# a real rank of four
# ---------------------------------------------------------------------------


def rank(r, rdv, inp, out_dir):
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import init_group, leave_group
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    init_group("gloo", r, WORLD, rdv)
    mesh = make_host_mesh(2, 2, device="cpu")
    z = np.load(inp)
    res, outs = {}, {}
    for case, (_, _, _, profs) in REDUCED.items():
        arch, shape = reduced_arch(case)
        for p in profs:
            model = port_model(case, z)
            with _Grads() as g:
                rec, tr = dryrun.dry_run(arch, shape, mesh, "host", p,
                                         params=model,
                                         batch=port_batch(case, z))
            met = tr["out"][2]
            k = _key(case, p)
            res[k] = {"rec": _jsonable(rec), "placed": all(g.placed.values()),
                      "n_grads": len(g.grads),
                      "loss": float(dctx.gathered(met["loss"])),
                      "grad_norm": float(dctx.gathered(met["grad_norm"]))}
            for n, t in g.grads.items():
                outs[_key(k, "grad", n)] = dctx.gathered(t).numpy()
            for n, t in model.named_parameters():
                outs[_key(k, "param", n)] = dctx.gathered(t.detach()).numpy()
    Path(out_dir, f"rank{r}.json").write_text(json.dumps(res))
    np.savez(Path(out_dir, f"rank{r}.npz"), **outs)
    leave_group()


# ---------------------------------------------------------------------------
# repro (JAX subprocesses)
# ---------------------------------------------------------------------------

_JAX_SHAPES = r"""
import json, sys
import jax
from repro.configs import get_arch
from repro.distributed.context import (
    axis_rules, fsdp_ep_rules, recsys_a2a_rules, single_pod_rules)
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import build_cell

cells = json.loads(sys.argv[1])
mesh = make_host_mesh(2, 4)
out = {}
for a, s, p in cells:
    rules = (fsdp_ep_rules(False) if p in ("fsdp_ep", "fsdp_ep_remat") else
             recsys_a2a_rules(False) if p == "a2a_emb" else
             single_pod_rules())
    arch = get_arch(a)
    with axis_rules(rules, mesh):
        cell = build_cell(arch, arch.shapes[s], mesh, rules, profile=p)
    shapes = {}
    for name, arg, sh in zip(("params", "opt", "batch"), cell.args,
                             cell.in_shardings):
        leaves = jax.tree_util.tree_flatten_with_path(arg)[0]
        shs = jax.tree_util.tree_leaves(
            sh, is_leaf=lambda x: hasattr(x, "shard_shape"))
        for (path, leaf), shard in zip(leaves, shs):
            key = "/".join([name] + [str(getattr(k, "key", getattr(
                k, "idx", k))) for k in path])
            shapes[key] = list(shard.shard_shape(leaf.shape))
    out["|".join((a, s, p))] = {"shapes": shapes,
                                "flops": cell.model_flops_per_step}
print(json.dumps(out))
"""

_JAX_GRADS = r"""
import dataclasses, json, sys
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import get_arch
from repro.distributed.context import (
    axis_rules, fsdp_ep_rules, recsys_a2a_rules, single_pod_rules)
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import _train_wrapper
from repro.models import gnn, recsys, transformer
from repro.optim import AdamWConfig, adamw_init

z = np.load(sys.argv[1])
cases = json.loads(sys.argv[3])
mesh = make_host_mesh(2, 2)
res = {}


def unflat(prefix):
    tree = {}
    for key in z.files:
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(z[key])

    def lists(t):
        if not isinstance(t, dict):
            return t
        t = {k: lists(v) for k, v in t.items()}
        if t and all(k.startswith("#") for k in t):
            return [t[f"#{i}"] for i in range(len(t))]
        return t

    return lists(tree)


def flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/" + "/".join(str(getattr(k, "key", getattr(
            k, "idx", k))) for k in path)] = np.asarray(leaf)
    return out


for case, (arch_id, shape_name, fields, family, profs) in cases.items():
    arch = get_arch(arch_id)
    cfg0 = arch.reduced()
    if family == "gnn":
        cfg0 = dataclasses.replace(cfg0, d_feat=arch.shapes[
            shape_name].d_feat)
    params = unflat(case)
    batch = {k[len(case) + 1:]: jnp.asarray(z[k]) for k in z.files
             if k.startswith(case + "_")}
    for p in profs:
        cfg = cfg0
        if family == "lm" and p in ("flash_remat", "fsdp_ep_remat"):
            cfg = dataclasses.replace(cfg, remat_chunks=True)
        if family == "recsys" and p == "a2a_emb":
            cfg = dataclasses.replace(cfg, emb_mode="alltoall")
        rules = (fsdp_ep_rules(False) if p.startswith("fsdp_ep") else
                 recsys_a2a_rules(False) if p == "a2a_emb" else
                 single_pod_rules())
        fn = {"lm": transformer.train_loss, "gnn": gnn.mse_loss,
              "recsys": recsys.bce_loss}[family]
        loss = lambda prm, b: fn(prm, b, cfg)
        step = _train_wrapper(loss, AdamWConfig())
        for where in ("local", "mesh"):
            k = case + "|" + p + "|" + where
            if where == "mesh":
                with axis_rules(rules, mesh):
                    lv, g = jax.jit(jax.value_and_grad(loss))(params, batch)
                    new, _, met = jax.jit(step)(params, adamw_init(params),
                                                batch)
            else:
                lv, g = jax.value_and_grad(loss)(params, batch)
                new, _, met = step(params, adamw_init(params), batch)
            res[k + "|loss"] = np.asarray(lv)
            res[k + "|grad_norm"] = np.asarray(met["grad_norm"])
            res.update(flat(g, k + "|grad"))
            res.update(flat(new, k + "|param"))
np.savez(sys.argv[2], **res)
"""


def _repro_inputs():
    """``repro``'s initialisers' weights (float32 numpy, ``case/<path>``
    keys) and the batches (``case_<key>``)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as jget
    from repro.models import gnn as jgnn
    from repro.models import recsys as jrec
    from repro.models import transformer as jtfm

    z = {}
    rng = np.random.default_rng(0)
    for case, (arch_id, shape_name, fields, _) in REDUCED.items():
        spec = jget(arch_id)
        cfg = spec.reduced()
        if spec.family == "gnn":
            cfg = dataclasses.replace(cfg, d_feat=spec.shapes[
                shape_name].d_feat)
        init = {"lm": jtfm.init_params, "gnn": jgnn.init_params,
                "recsys": jrec.init_params}[spec.family]
        params = init(jax.random.PRNGKey(0), cfg)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            key = "/".join(
                [case] + [(f"#{k.idx}" if hasattr(k, "idx") else str(k.key))
                          for k in path])
            z[key] = np.asarray(leaf.astype(jnp.float32))
        if case == "deepfm":
            B = fields["batch"]
            z["deepfm_ids"] = np.stack([rng.integers(0, v, size=(B, 1))
                                        for v in cfg.vocab_sizes],
                                       1).astype(np.int32)
            z["deepfm_labels"] = rng.integers(0, 2, B).astype(np.float32)
        elif spec.family == "lm":
            z[f"{case}_tokens"] = rng.integers(
                0, cfg.vocab, (fields["global_batch"], fields["seq_len"])
            ).astype(np.int32)
        else:
            from repro_torch.launch.steps import _gnn_dims

            _, shape = reduced_arch(case)
            N, E, _ = _gnn_dims(shape)
            n = shape.n_graphs * shape.nodes_per_graph
            e = shape.n_graphs * shape.edges_per_graph
            z["gnn_node_feats"] = rng.normal(size=(N, cfg.d_feat)).astype(
                np.float32)
            z["gnn_edges"] = rng.integers(0, n, (E, 2)).astype(np.int32)
            z["gnn_targets"] = rng.normal(size=(N, cfg.n_vars)).astype(
                np.float32)
            z["gnn_node_mask"] = np.arange(N) < n
            z["gnn_edge_mask"] = np.arange(E) < e
    return z


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"tracer", "jax_shapes", "jax", "ranks", "inputs"}``: the
    subprocess runs, at once."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import rank_env, spawn_ranks

    tmp = tmp_path_factory.mktemp("dryrun_train")
    z = _repro_inputs()
    inp = tmp / "inputs.npz"
    np.savez(inp, **z)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")

    def run_tracer(part):
        r = subprocess.run([sys.executable, __file__, "tracer", str(tmp),
                            str(part)], env=env, cwd=REPO,
                           capture_output=True, text=True, timeout=400,
                           stdin=subprocess.DEVNULL)
        assert r.returncode == 0, r.stderr[-3000:]
        return json.loads((tmp / f"tracer{part}.json").read_text())

    def run_jax(script, devices, *args):
        jenv = dict(env, XLA_FLAGS=f"--xla_force_host_platform_device_count="
                    f"{devices} --xla_cpu_multi_thread_eigen=false")
        r = subprocess.run([sys.executable, "-c", script, *args], env=jenv,
                           cwd=REPO, capture_output=True, text=True,
                           timeout=400, stdin=subprocess.DEVNULL)
        assert r.returncode == 0, r.stderr[-3000:]
        return r.stdout

    def jax_grads():
        cases = {c: (a, s, f, get_arch(a).family, ps)
                 for c, (a, s, f, ps) in REDUCED.items()}
        run_jax(_JAX_GRADS, 4, str(inp), str(tmp / "jax.npz"),
                json.dumps(cases))
        return dict(np.load(tmp / "jax.npz"))

    def run_ranks():
        spawn_ranks(lambda r: [__file__, "rank", str(r), str(tmp / "rdv"),
                               str(inp), str(tmp)], WORLD, 300,
                    env=rank_env(WORLD, {"OMP_NUM_THREADS": "1"}), cwd=REPO)
        return [(json.loads((tmp / f"rank{r}.json").read_text()),
                 dict(np.load(tmp / f"rank{r}.npz"))) for r in range(WORLD)]

    with concurrent.futures.ThreadPoolExecutor(len(LMS) + 4) as pool:
        fts = [pool.submit(run_tracer, k) for k in range(len(LMS) + 1)]
        fs = pool.submit(lambda: json.loads(run_jax(
            _JAX_SHAPES, 8, json.dumps(training_cells())).strip()
            .splitlines()[-1]))
        fj, fr = pool.submit(jax_grads), pool.submit(run_ranks)
        drv = fts[0].result()
        for f in fts[1:]:
            drv["traced"].update(f.result()["traced"])
        return {"tracer": drv, "jax_shapes": fs.result(),
                "jax": fj.result(), "ranks": fr.result(),
                "inputs": _Npz(z)}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a,s,p", training_cells())
def test_training_cell_shard_shapes_and_flops_match_repro(runs, a, s, p):
    """Every argument's block at (2, 4), the parameters', AdamW's ``m``,
    ``v`` and ``step`` and the batch's, and the model FLOPs, as
    ``repro``'s ``build_cell`` has them."""
    got = runs["tracer"]["shapes"][_key(a, s, p)]
    want = runs["jax_shapes"][_key(a, s, p)]
    assert got["shapes"] == want["shapes"]
    assert got["flops"] == want["flops"]
    assert any(k.startswith("opt/m/") for k in got["shapes"])
    assert got["shapes"]["opt/step"] == []


@pytest.mark.parametrize("a,s", sorted({(a, s) for a, s, _ in
                                        training_cells()}))
def test_training_cells_trace_on_eight_fake_ranks(runs, a, s):
    rec = runs["tracer"]["traced"][_key(a, s)]
    assert rec["status"] == "ok" and rec["chips"] == 8
    assert rec["real_tensors_seen"] == 0
    ms = rec["memory_stats"]
    assert ms["static_args_per_chip_bytes"] == ms["static_args_held_bytes"]
    assert rec["flop_counter_per_rank"] > 0
    assert sum(rec["coll_op_counts"].values()) > 0  # the gradients' sums


@pytest.mark.parametrize("p,ratio", [("baseline", 1 / 16), ("a2a_emb", 1.0)])
def test_deepfm_train_batch_by_hand(runs, p, ratio):
    """On the pod mesh a rank's FLOPs are 3 x the tower's forward over its
    block of the 65,536 examples (the FM term, the bags and AdamW are not
    matmul-class work): the batch over "data" only (4096 a rank, the
    tower replicated over "model") under ``baseline``, over the whole grid
    (256 a rank) under ``a2a_emb``."""
    from repro_torch.configs import get_arch

    rec = runs["tracer"]["hand"][p]
    cfg = get_arch("deepfm").config
    dims = (cfg.n_fields * cfg.embed_dim,) + tuple(cfg.mlp_dims) + (1,)
    tower = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    per_rank = 65536 // (16 if p == "baseline" else 256)
    assert rec["flop_counter_per_rank"] == 3 * tower * per_rank
    assert rec["model_flops"] == 3 * tower * 65536
    assert rec["useful_flops_ratio"] == ratio
    assert rec["chips"] == 256 and rec["real_tensors_seen"] == 0


@pytest.mark.parametrize("remat,plain", REMAT)
def test_remat_profile_adds_the_chunks_recompute(runs, remat, plain):
    """The reduced qwen1.5-4b at B = 4, S = 32 (chunk_q 16: two query
    chunks) on (2, 2): recomputing each attention chunk in the backward
    adds, for every chunk, its scores einsum, 2 B H q S dh over the
    rank's batch and heads (torch's non-reentrant recompute stops at the
    last tensor the backward needs, the probabilities, so the output's
    einsum is not run again); nothing else changes."""
    a, b = runs["tracer"]["remat"][remat], runs["tracer"]["remat"][plain]
    arch, shape = reduced_arch("qwen")
    cfg = arch.config
    B, S = shape.global_batch, shape.seq_len
    B_loc = B // 2  # the batch over "data"
    H_loc = cfg.n_heads // (2 if plain == "baseline" else 1)  # heads
    extra = cfg.n_layers * (S // cfg.chunk_q) * (
        2 * B_loc * H_loc * cfg.chunk_q * S * cfg.head_dim)
    assert a["flop_counter_per_rank"] - b["flop_counter_per_rank"] == extra
    assert a["memory_stats"] == b["memory_stats"]


REAL = [(c, p) for c, (_, _, _, ps) in REDUCED.items() for p in ps]


@pytest.mark.parametrize("case,p", REAL)
@pytest.mark.parametrize("r", range(WORLD))
def test_real_ranks_count_what_the_fake_world_counts(runs, case, p, r):
    fake = runs["tracer"]["w4"][_key(case, p)]
    real = runs["ranks"][r][0][_key(case, p)]["rec"]
    for k in ("coll_op_counts", "coll_by_kind", "flop_counter_per_rank",
              "model_flops", "chips", "status"):
        assert real[k] == fake[k], k
    assert real["memory_stats"] == fake["memory_stats"]
    assert fake["real_tensors_seen"] == 0
    assert sum(fake["coll_op_counts"].values()) > 0


@pytest.mark.parametrize("case,p", REAL)
def test_every_gradient_sits_on_its_parameters_placements(runs, case, p):
    n_params = len(port_model(case, runs["inputs"]).state_dict())
    for r in range(WORLD):
        got = runs["ranks"][r][0][_key(case, p)]
        assert got["placed"] and got["n_grads"] == n_params


def _repro_leaf(z, prefix, name, leaves):
    path, transposed, stacked = leaves[name]
    a = z[f"{prefix}/{path}"]
    if stacked:
        a = a[next(int(x) for x in name.split(".") if x.isdigit())]
    return a.T if transposed else a


def _normwise(got, want, tol, what):
    err = np.linalg.norm(got.astype(np.float64) - want)
    assert err <= tol * max(np.linalg.norm(want.astype(np.float64)),
                            1e-30), (what, err)


@pytest.mark.parametrize("case,p", REAL)
def test_loss_and_gradients_match_one_process_and_repro(runs, case, p):
    from repro_torch.models.convert import repro_leaves

    z, j = runs["inputs"], runs["jax"]
    tol = NORM_TOL[case]
    leaves = repro_leaves(port_model(case, z))
    where = "mesh" if case in MESH_ONLY else "local"
    ref = f"{case}|{p}|{where}"
    refs = [("repro", float(j[ref + "|loss"]), float(j[ref + "|grad_norm"]),
             {n: _repro_leaf(j, ref + "|grad", n, leaves) for n in leaves})]
    if case not in MESH_ONLY:
        loss, gn, grads, _ = one_process(case, p, z)
        refs.append(("one process", loss, gn, grads))
    for r in range(WORLD):
        got = runs["ranks"][r][0][_key(case, p)]
        outs = runs["ranks"][r][1]
        for who, loss, gn, grads in refs:
            assert abs(got["loss"] - loss) <= tol * abs(loss), who
            assert abs(got["grad_norm"] - gn) <= tol * abs(gn), who
            for n, want in grads.items():
                _normwise(outs[_key(case, p, "grad", n)], want, tol,
                          (who, n, r))


def _step_pair(got, want, g_got, g_want, lr, what):
    """``chip_smoke.py``'s ``step_pair`` rule for one leaf: the shaky
    elements (gradients more than 1% apart against ``|g| + eps``) within
    2 lr, the rest within rtol 1e-4 / atol 1e-5.  Returns the count of
    shaky elements."""
    shaky = np.abs(g_got - g_want) > 1e-2 * (np.abs(g_want) + 1e-8)
    diff = np.abs(got - want)
    assert np.all(diff[shaky] <= 2 * lr * (1 + 1e-3)), what
    ok = diff <= 1e-5 + 1e-4 * np.abs(want)
    assert np.all(ok | shaky), (what, float(diff[~shaky].max()))
    return int(shaky.sum())


@pytest.mark.parametrize("case,p", REAL)
def test_one_adamw_step_matches_one_process_and_repro(runs, case, p):
    from repro_torch.models.convert import repro_leaves
    from repro_torch.optim import AdamWConfig

    z, j = runs["inputs"], runs["jax"]
    lr = AdamWConfig().lr
    leaves = repro_leaves(port_model(case, z))
    where = "mesh" if case in MESH_ONLY else "local"
    ref = f"{case}|{p}|{where}"
    refs = [({n: _repro_leaf(j, ref + "|param", n, leaves) for n in leaves},
             {n: _repro_leaf(j, ref + "|grad", n, leaves) for n in leaves})]
    if case not in MESH_ONLY:
        _, _, grads, params = one_process(case, p, z)
        refs.append((params, grads))
    outs = runs["ranks"][0][1]
    total = shaky = 0
    for params, grads in refs:
        for n, want in params.items():
            shaky += _step_pair(outs[_key(case, p, "param", n)], want,
                                outs[_key(case, p, "grad", n)], grads[n], lr,
                                (case, p, n))
            total += want.size
    assert shaky <= 1e-2 * total
    for r in range(1, WORLD):  # every rank holds the same step
        for n in leaves:
            np.testing.assert_array_equal(
                runs["ranks"][r][1][_key(case, p, "param", n)],
                outs[_key(case, p, "param", n)])


def test_run_dryruns_counts_a_training_cells_error_as_a_failure(
        tmp_path, monkeypatch, capsys):
    from repro_torch.launch import run_dryruns
    from repro_torch.launch.dryrun import record_path

    def fake_run(cmd, **kw):
        a, s, m, p = (cmd[cmd.index(f) + 1] for f in
                      ("--arch", "--shape", "--mesh", "--profile"))
        with open(record_path(str(tmp_path), a, s, m, p), "w") as f:
            json.dump({"arch": a, "shape": s, "mesh": m, "profile": p,
                       "status": "error",
                       "error_type": "NotImplementedError"}, f)
        return subprocess.CompletedProcess(cmd, 1, "", "")

    monkeypatch.setattr(run_dryruns.subprocess, "run", fake_run)
    rc = run_dryruns.main(["--only", "graphcast", "--mesh", "pod", "--out",
                           str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 1 and "4 failures" in out, out
    assert not hasattr(run_dryruns, "not_yet_ported")


if __name__ == "__main__":
    if sys.argv[1] == "tracer":
        tracer(sys.argv[2], int(sys.argv[3]))
    else:
        rank(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
