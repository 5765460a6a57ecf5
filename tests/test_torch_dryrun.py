"""The port's dry run (``repro_torch.launch.{hostdev,mesh,steps,dryrun,
run_dryruns}``) against ``repro``'s, on the CPU.

A module fixture starts three things at once, each a subprocess:

* this file as tracers (``python tests/test_torch_dryrun.py tracer OUT
  K``), TRACERS of them at once, each in one fake world of 512 ranks:
  tracers 1.. build every serving cell and profile on a (2, 4) mesh
  between them (each argument's shard shape and
  ``model_flops_per_step``; the recsys ``serve_p99`` cells traced too);
  tracer 0 traces deepfm ``serve_p99`` at (1, 1) for the hand count, the
  reduced cases below at (2, 2), the remat profiles beside their plain
  ones, and records deepfm's cells on the pod mesh by ``dryrun.main``
  (the records the second ``run_dryruns`` finds);
* ``repro``'s ``build_cell`` for every serving cell and profile on an
  8-device (2, 4) host mesh (a JAX subprocess; ``repro.launch.dryrun``
  itself is never imported in a test process, it sets an XLA flag for
  512 devices at import);
* four gloo ranks (``spawn_ranks``, this file as ``rank R ...``) running
  the reduced cases on a (2, 2) mesh of real tensors: DeepFM's reduced
  config at ``serve_p99`` (B = 16) under ``baseline`` and ``a2a_emb``,
  qwen1.5-4b's at ``prefill_32k`` cut to B = 4, S = 32 (two attention
  chunks) under ``baseline`` and ``fsdp_ep``, and its ``decode_32k`` cut
  to B = 4 against a 32-slot cache that a prefill of 16 tokens filled
  (the cache's width split over "model": the softmax combined across
  ranks), their weights ``repro``'s initialisers' converted.

Bars: shard shapes and FLOP counts exactly; each real rank's collective
counts and bytes by kind, its FLOPs and its argument bytes equal the
fake world's exactly; outputs at ``test_torch_mesh_ranks.py``'s bars
(DeepFM's scores rtol 1e-5 / atol 1e-6, the LM's logits rtol 2e-4 /
atol 2e-5, a sum over ranks in another order) against the one-process
forward of the same weights and against ``repro``'s.
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
RECSYS_PROFILES = ("baseline", "a2a_emb")
REDUCED = {  # case: (arch, shape kind, shape fields, profiles)
    "deepfm": ("deepfm", "serve_p99", dict(batch=16),
               ("baseline", "a2a_emb")),
    "qwen": ("qwen1.5-4b", "prefill_32k", dict(global_batch=4, seq_len=32),
             ("baseline", "fsdp_ep")),
    "decode": ("qwen1.5-4b", "decode_32k", dict(global_batch=4, seq_len=32),
               ("baseline",)),
}
PROMPT = 16  # the decode case's cache: a prefill of 16 of its 32 slots
REMAT = (("flash_remat", "baseline"), ("fsdp_ep_remat", "fsdp_ep"))
WORLD = 4
TRACERS = 4


def serving_cells():
    """Every serving (arch, shape, profile) of the inventory, skips out."""
    from repro_torch.configs import get_arch, list_archs

    out = []
    for a in list_archs():
        spec = get_arch(a)
        profs = {"lm": LM_PROFILES, "recsys": RECSYS_PROFILES}.get(
            spec.family, ())
        for s, shape in spec.active_shapes().items():
            if shape.kind in ("train", "graph_train"):
                continue
            out += [(a, s, p) for p in profs]
    return out


def reduced_arch(case):
    from repro_torch.configs import get_arch

    arch_id, shape_name, fields, _ = REDUCED[case]
    arch = get_arch(arch_id)
    arch = dataclasses.replace(arch, config=arch.reduced())
    return arch, dataclasses.replace(arch.shapes[shape_name], **fields)


def _key(*parts):
    return "|".join(parts)


def _jsonable(rec):
    return json.loads(json.dumps(rec))


# ---------------------------------------------------------------------------
# the tracer: one fake world of 512 ranks
# ---------------------------------------------------------------------------


def tracer(out_dir, part):
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.hostdev import fake_world
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell

    out = Path(out_dir)
    fake_world(512)
    res = {"refuses": False}
    try:
        fake_world(8)
    except RuntimeError:
        res["refuses"] = True
    mesh = make_host_mesh(2, 4, device="cpu")
    shapes = {}
    for a, s, p in (serving_cells()[part - 1::TRACERS - 1] if part
                    else ()):
        arch = get_arch(a)
        rules = dryrun.rules_for(p, False)
        cell = build_cell(arch, arch.shapes[s], mesh, rules, profile=p)
        ent = {"shapes": {k: list(v) for k, v in
                          cell.shard_shapes(mesh).items()},
               "flops": cell.model_flops_per_step}
        if s == "serve_p99":
            ent["traced"] = _jsonable(dryrun.record(
                a, s, "host", p, cell, mesh, dryrun.trace(cell, mesh, rules),
                "cpu"))
        shapes[_key(a, s, p)] = ent
    res["shapes"] = shapes
    if part:
        (out / f"tracer{part}.json").write_text(json.dumps(res))
        return

    one = make_host_mesh(1, 1, device="cpu")
    arch = get_arch("deepfm")
    rec, _ = dryrun.dry_run(arch, arch.shapes["serve_p99"], one, "host")
    cell = build_cell(arch, arch.shapes["serve_p99"], one,
                      dryrun.rules_for("baseline", False))
    res["hand"] = {"rec": _jsonable(rec), "param_bytes": sum(
        t.numel() * t.element_size() for k, (t, *_) in cell.leaves.items()
        if k.startswith("params/"))}

    four = make_host_mesh(2, 2, device="cpu")
    res["w4"] = {}
    for case, (_, _, _, profs) in REDUCED.items():
        arch, shape = reduced_arch(case)
        for p in profs:
            rec, _ = dryrun.dry_run(arch, shape, four, "host", p)
            res["w4"][_key(case, p)] = _jsonable(rec)
    arch, shape = reduced_arch("qwen")
    for p in sorted({x for pair in REMAT for x in pair}):
        rec, _ = dryrun.dry_run(arch, shape, four, "host", p)
        res["w4"][_key("remat", p)] = _jsonable(rec)

    rec_dir = out / "records"
    for s in get_arch("deepfm").shapes:
        for p in RECSYS_PROFILES:
            rc = dryrun.main(["--arch", "deepfm", "--shape", s, "--mesh",
                              "pod", "--out", str(rec_dir), "--profile", p,
                              "--device", "cpu"])
            res.setdefault("main_rc", {})[_key(s, p)] = rc
    res["torch"] = torch.__version__
    (out / f"tracer{part}.json").write_text(json.dumps(res))


# ---------------------------------------------------------------------------
# a real rank of four
# ---------------------------------------------------------------------------


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


def port_model(case, z):
    from repro_torch.models import convert

    arch, _ = reduced_arch(case)
    tree = _unflat(z, "qwen" if case == "decode" else case)
    if case in ("qwen", "decode"):
        return convert.transformer_from_jax(tree, arch.config, device="cpu")
    return convert.params_from_jax(tree, arch.config, device="cpu")


def port_batch(case, z):
    import torch

    if case == "decode":
        from repro_torch.models import transformer

        arch, shape = reduced_arch(case)
        with torch.no_grad():
            _, cache = transformer.prefill(
                port_model(case, z), torch.from_numpy(z["qwen_tokens"][
                    :, :PROMPT]), arch.config, max_seq=shape.seq_len)
        return {"tokens": torch.from_numpy(z["decode_tokens"]),
                "cache": cache}
    key = "tokens" if case == "qwen" else "ids"
    return {key: torch.from_numpy(z[f"{case}_{key}"])}


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
            rec, tr = dryrun.dry_run(arch, shape, mesh, "host", p,
                                     params=port_model(case, z),
                                     batch=port_batch(case, z))
            res[_key(case, p)] = _jsonable(rec)
            y = tr["out"] if case == "deepfm" else tr["out"][0]
            outs[_key(case, p)] = dctx.gathered(y).numpy()
            if case != "deepfm":  # the cache the step wrote
                for key, g in tr["out"][1]["groups"].items():
                    for kv, t in g.items():
                        outs[_key(case, p, key, kv)] = dctx.gathered(
                            t).numpy()
    Path(out_dir, f"rank{r}.json").write_text(json.dumps(res))
    np.savez(Path(out_dir, f"rank{r}.npz"), **outs)
    leave_group()


# ---------------------------------------------------------------------------
# repro's cells on an 8-device host mesh (a JAX subprocess)
# ---------------------------------------------------------------------------

_JAX_CELLS = r"""
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
    names = (("params", "cache", "batch") if len(cell.args) == 3
             else ("params", "batch"))
    shapes = {}
    for name, arg, sh in zip(names, cell.args, cell.in_shardings):
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"tracer", "jax", "ranks", "inputs"}``: the three subprocess runs,
    at once."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as jget
    from repro.models import recsys as jrec
    from repro.models import transformer as jtfm
    from repro_torch.distributed import rank_env, spawn_ranks

    tmp = tmp_path_factory.mktemp("dryrun")
    z = {}
    for case in ("deepfm", "qwen"):
        arch_id = REDUCED[case][0]
        cfg = jget(arch_id).reduced()
        init = jtfm.init_params if case == "qwen" else jrec.init_params
        params = init(jax.random.PRNGKey(0), cfg)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            key = "/".join(
                [case] + [(f"#{k.idx}" if hasattr(k, "idx") else str(k.key))
                          for k in path])
            z[key] = np.asarray(leaf.astype(jnp.float32))
    rng = np.random.default_rng(0)
    vocab = jget("qwen1.5-4b").reduced().vocab
    z["qwen_tokens"] = rng.integers(0, vocab, (4, 32)).astype(np.int32)
    z["decode_tokens"] = rng.integers(0, vocab, (4, 1)).astype(np.int32)
    fcfg = jget("deepfm").reduced()
    z["deepfm_ids"] = np.stack([rng.integers(0, v, size=(16, 1))
                                for v in fcfg.vocab_sizes], 1).astype(np.int32)
    inp = tmp / "inputs.npz"
    np.savez(inp, **z)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")

    def run_tracer(part):
        r = subprocess.run([sys.executable, __file__, "tracer", str(tmp),
                            str(part)], env=env, cwd=REPO,
                           capture_output=True, text=True, timeout=300,
                           stdin=subprocess.DEVNULL)
        assert r.returncode == 0, r.stderr[-3000:]
        return json.loads((tmp / f"tracer{part}.json").read_text())

    def run_jax():
        jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8"
                    " --xla_cpu_multi_thread_eigen=false")
        r = subprocess.run([sys.executable, "-c", _JAX_CELLS,
                            json.dumps(serving_cells())], env=jenv, cwd=REPO,
                           capture_output=True, text=True, timeout=300,
                           stdin=subprocess.DEVNULL)
        assert r.returncode == 0, r.stderr[-3000:]
        return json.loads(r.stdout.strip().splitlines()[-1])

    def run_ranks():
        spawn_ranks(lambda r: [__file__, "rank", str(r), str(tmp / "rdv"),
                               str(inp), str(tmp)], WORLD, 240,
                    env=rank_env(WORLD, {"OMP_NUM_THREADS": "1"}), cwd=REPO)
        return [(json.loads((tmp / f"rank{r}.json").read_text()),
                 dict(np.load(tmp / f"rank{r}.npz"))) for r in range(WORLD)]

    with concurrent.futures.ThreadPoolExecutor(TRACERS + 2) as pool:
        fds = [pool.submit(run_tracer, k) for k in range(TRACERS)]
        fj, fr = pool.submit(run_jax), pool.submit(run_ranks)
        drv = fds[0].result()
        for f in fds[1:]:
            drv["shapes"].update(f.result()["shapes"])
        return {"tracer": drv, "jax": fj.result(), "ranks": fr.result(),
                "inputs": dict(np.load(inp)), "tmp": tmp}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def test_list_matches_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-m", m, "--list"], env=env,
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              stdin=subprocess.DEVNULL)
             for m in ("repro_torch.launch.dryrun", "repro.launch.dryrun")]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    assert outs[0][0].splitlines() == outs[1][0].splitlines()
    assert len(outs[0][0].splitlines()) == 40


@pytest.mark.parametrize("a,s,p", serving_cells())
def test_cell_shard_shapes_and_flops_match_repro(runs, a, s, p):
    """Every argument leaf's block at (2, 4), and the model FLOPs, as
    ``repro``'s ``build_cell`` has them.  ``cache/pos`` is a Python int in
    the port (``repro``'s 0-d int32 array is not a tensor here)."""
    got = runs["tracer"]["shapes"][_key(a, s, p)]
    want = runs["jax"][_key(a, s, p)]
    want_shapes = {k: v for k, v in want["shapes"].items()
                   if k != "cache/pos"}
    assert got["shapes"] == want_shapes
    assert got["flops"] == want["flops"]


@pytest.mark.parametrize("a,p", [(a, p) for a, s, p in serving_cells()
                                 if s == "serve_p99"])
def test_serve_cells_trace_on_eight_fake_ranks(runs, a, p):
    rec = runs["tracer"]["shapes"][_key(a, "serve_p99", p)]["traced"]
    assert rec["status"] == "ok" and rec["chips"] == 8
    assert rec["real_tensors_seen"] == 0
    ms = rec["memory_stats"]
    assert ms["static_args_per_chip_bytes"] == ms["static_args_held_bytes"]


def test_deepfm_serve_p99_by_hand(runs):
    """At (1, 1): no collective; the FLOPs are the tower's exactly, 512 x
    sum 2ab over 390-400-400-400-1 (the FM term, the bags and the wide
    term are not matmul-class work); the argument bytes are the
    parameters' plus the ids' (512 x 39 x 1 int32)."""
    d = runs["tracer"]["hand"]
    rec = d["rec"]
    dims = (390, 400, 400, 400, 1)
    want = 512 * sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    assert rec["coll_op_counts"] == {} and rec["coll_by_kind"] == {}
    assert rec["model_flops"] == want
    assert rec["flop_counter_per_rank"] == want
    assert rec["useful_flops_ratio"] == 1.0
    ms = rec["memory_stats"]
    assert ms["static_args_per_chip_bytes"] == d["param_bytes"] + 512 * 39 * 4
    assert ms["static_args_held_bytes"] == ms["static_args_per_chip_bytes"]
    assert rec["real_tensors_seen"] == 0


REAL_CASES = [(c, p) for c, (_, _, _, ps) in REDUCED.items() for p in ps]


@pytest.mark.parametrize("case,p", REAL_CASES)
@pytest.mark.parametrize("r", range(WORLD))
def test_real_ranks_count_what_the_fake_world_counts(runs, case, p, r):
    fake = runs["tracer"]["w4"][_key(case, p)]
    real = runs["ranks"][r][0][_key(case, p)]
    for k in ("coll_op_counts", "coll_by_kind",
              "flop_counter_per_rank", "model_flops", "chips"):
        assert real[k] == fake[k], k
    assert real["memory_stats"] == fake["memory_stats"]
    assert fake["real_tensors_seen"] == 0
    if p in ("a2a_emb", "fsdp_ep") or case != "deepfm":
        assert sum(fake["coll_op_counts"].values()) > 0


def _one_process(case, z):
    import torch

    from repro_torch.models import recsys, transformer

    arch, shape = reduced_arch(case)
    model = port_model(case, z)
    b = port_batch(case, z)
    with torch.no_grad():
        if case == "decode":
            return transformer.decode_step(model, b["cache"], b["tokens"],
                                           arch.config)
        if case == "qwen":
            return transformer.prefill(model, b["tokens"], arch.config,
                                       max_seq=shape.seq_len)
        return recsys.serve_scores(model, b["ids"], arch.config).numpy()


def _repro(case, z):
    import jax.numpy as jnp

    from repro.configs import get_arch as jget
    from repro.models import recsys as jrec
    from repro.models import transformer as jtfm

    arch_id, _, fields, _ = REDUCED[case]
    cfg = jget(arch_id).reduced()
    params = _to_jnp(_unflat(_Npz(z), "deepfm" if case == "deepfm"
                             else "qwen"))
    if case == "decode":
        _, cache = jtfm.prefill(params, jnp.asarray(
            z["qwen_tokens"][:, :PROMPT]), cfg, max_seq=fields["seq_len"])
        return np.asarray(jtfm.decode_step(
            params, cache, jnp.asarray(z["decode_tokens"]), cfg)[0])
    if case == "qwen":
        return np.asarray(jtfm.prefill(params, jnp.asarray(z["qwen_tokens"]),
                                       cfg, max_seq=fields["seq_len"])[0])
    return np.asarray(jrec.serve_scores(params, jnp.asarray(z["deepfm_ids"]),
                                        cfg))


class _Npz(dict):
    """A dict of arrays read like an ``np.load`` archive."""

    @property
    def files(self):
        return list(self)


def _to_jnp(t):
    import jax.numpy as jnp

    if isinstance(t, dict):
        return {k: _to_jnp(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_to_jnp(v) for v in t]
    return jnp.asarray(t)


@pytest.mark.parametrize("case,p", REAL_CASES)
def test_real_ranks_outputs_match_one_process_and_repro(runs, case, p):
    z = runs["inputs"]
    rtol, atol = (1e-5, 1e-6) if case == "deepfm" else (2e-4, 2e-5)
    local = _one_process(case, _Npz(z))
    ref = _repro(case, z)
    cache = None
    if case != "deepfm":
        local, cache = local[0].numpy(), local[1]
    for r in range(WORLD):
        outs = runs["ranks"][r][1]
        got = outs[_key(case, p)]
        np.testing.assert_allclose(got, local, rtol=rtol, atol=atol)
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
        for key, g in (cache or {"groups": {}})["groups"].items():
            for kv, t in g.items():  # the cache each rank's step wrote
                np.testing.assert_allclose(outs[_key(case, p, key, kv)],
                                           t.numpy(), rtol=rtol, atol=atol)
    np.testing.assert_array_equal(runs["ranks"][0][1][_key(case, p)],
                                  runs["ranks"][WORLD - 1][1][_key(case, p)])


@pytest.mark.parametrize("remat,plain", REMAT)
def test_remat_profile_records_what_its_plain_profile_does(runs, remat,
                                                           plain):
    """A serving step runs no backward, so recomputing attention chunks
    changes nothing a rank holds, computes or sends."""
    w4 = runs["tracer"]["w4"]
    a, b = dict(w4[_key("remat", remat)]), dict(w4[_key("remat", plain)])
    for rec in (a, b):
        for k in ("profile", "trace_s"):
            rec.pop(k)
    assert a == b


def test_every_tensor_the_dry_run_meets_is_fake(runs):
    d = runs["tracer"]
    recs = [d["hand"]["rec"]] + list(d["w4"].values()) + [
        e["traced"] for e in d["shapes"].values() if "traced" in e]
    assert recs and all(r["real_tensors_seen"] == 0 for r in recs)
    assert d["refuses"]


def test_a_second_run_dryruns_runs_no_cell(runs, monkeypatch, capsys):
    from repro_torch.launch import run_dryruns

    d = runs["tracer"]
    assert set(d["main_rc"].values()) == {0}  # the training cell's too

    def no_run(*a, **k):
        raise AssertionError("a cached cell ran again")

    monkeypatch.setattr(run_dryruns.subprocess, "run", no_run)
    rc = run_dryruns.main(["--only", "deepfm", "--mesh", "pod", "--out",
                           str(runs["tmp"] / "records"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and out.count(": cached") == 8, out
    rec = json.loads((runs["tmp"] / "records" /
                      "deepfm__serve_p99__pod__a2a_emb.json").read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["mesh_device_type"] == "cpu"
    assert rec["real_tensors_seen"] == 0


def test_k8_takes_its_shape_only_route_only_on_fake_tensors(
        monkeypatch):
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.fm_interaction import (
        fm_interaction,
        fm_interaction_ref,
    )

    k8 = sys.modules["repro_torch.kernels.fm_interaction.fm_interaction"]

    def no_launch(*a, **k):
        raise AssertionError("K8 launched")

    monkeypatch.setattr(k8, "_launch", no_launch)
    x = torch.randn(5, 39, 10)
    assert not k8.shape_only(x)
    torch.testing.assert_close(fm_interaction(x), fm_interaction_ref(x))
    with FakeTensorMode():
        fc = torch.empty(5, 39, 10, device="cuda")
        fcpu = torch.empty(5, 39, 10)
        assert k8.shape_only(fc) and k8.shape_only(fcpu)
        assert fm_interaction(fc).shape == (5,)
        assert fm_interaction(fc).device.type == "cuda"
        assert k8.fm_interaction_bwd_kernel(
            fc, torch.empty(5, device="cuda")).shape == (5, 39, 10)
        assert fm_interaction(fcpu).shape == (5,)  # the plain version
    meta = torch.empty(5, 39, 10, device="meta")
    assert not k8.shape_only(meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fm_interaction(meta)  # no data, but not the dry run's: refused


if __name__ == "__main__":
    if sys.argv[1] == "tracer":
        tracer(sys.argv[2], int(sys.argv[3]))
    else:
        rank(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
