"""The port's (data x model) mesh against ``repro``'s, on the CPU: eight
gloo ranks on a (2, 4) mesh against ``repro``'s ``shard_map`` bodies on
an 8-device host mesh, the same inputs.

A module fixture makes the inputs here (``repro``'s initialisers on one
JAX device, numpy draws), then starts, at once, the eight torch ranks
(one ``spawn_ranks`` call, 120 s at most, one CPU thread each) and one
JAX subprocess with ``--xla_force_host_platform_device_count=8`` that
computes every reference into one ``.npz``, as
``tests/test_distributed.py`` runs ``repro`` on that mesh (its XLA
threads cut to one a device, so the nine processes do not crowd out
the other test workers).  Each test reads the results.  Bars, with their reasons:

* MoE (``MoEConfig(8, 2, 32, capacity_factor=8.0)``, d = 16) in its three
  token partitions: x (4, 8, 16) over data x model, (1, 4, 16) over
  model, (1, 3, 16) replicated: the output at rtol 2e-4 / atol 2e-5, the
  aux at rtol 1e-5 against ``repro``'s mesh aux, and finite within
  0.2-5x of the local aux (``test_distributed.py:38``).  In the
  replicated partition ``repro`` wraps a negative expert index (ROADMAP
  queue 3), so there the output is held against the local layer and
  against ``repro``'s mesh output where ``repro``'s equals the local.
* The bag (``EmbeddingSpec((100, 60, 200), 8, pad_to_multiple=8)``, the
  ids of ``test_distributed.py:66``): psum, alltoall and alltoall under
  ``single_pod_rules`` (its psum fallback), and alltoall under
  ``recsys_a2a_rules`` with 12 rows that do not divide over its 8-rank
  batch (psum, each rank's rows regathered from its (data x model) block
  to its "model" block) at rtol 1e-5 / atol 1e-6 against ``repro`` on
  the same rules and against the local bag; the body each ran, by its
  collectives.  Skewed ids, so that a rank sends
  owner 0 more than ``cap`` requests, padding included: the port drops
  what ``repro`` drops.
* The tiny MoE LM of ``test_distributed.py:88``: the loss within 1e-4
  of ``repro``'s on the mesh and 5e-3 of the local loss.
* DeepFM's reduced config under both rule tables: logits at rtol 1e-5 /
  atol 1e-6 (``tests/test_torch_recsys.py``'s bar for the local
  forward); each rank holds only its rows of both tables.
* Elastic: an (8, 8) array placed ``("data", "model")`` on (2, 4), ranks
  0-3 surviving into (1, 4): each block equal to ``repro``'s
  ``reshard``'s shard bit for bit.
* ``axis_size`` on the mesh against ``repro``'s under the mesh.
Every rank returns the same whole outputs, bit for bit.
"""
import concurrent.futures
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import embedding as jemb
from repro.models import moe as jmoe
from repro.models import recsys as jrecsys
from repro.models import transformer as jtfm
from repro_torch.distributed import (
    ModelMesh,
    axis_rules,
    axis_size,
    fsdp_ep_rules,
    rank_env,
    recsys_a2a_rules,
    single_pod_rules,
    spawn_ranks,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = (2, 4)
WORLD = MESH[0] * MESH[1]
MOE_X = {"dm": (4, 8, 16), "m": (1, 4, 16), "psum": (1, 3, 16)}
BAG = dict(vocab=(100, 60, 200), dim=8, pad=8)
BAG_CASES = {  # case: (rules, mode, ids key)
    "psum": ("single_pod", "psum", "ids"),
    "alltoall": ("a2a", "alltoall", "ids"),
    "fallback": ("single_pod", "alltoall", "ids"),
    "skew": ("a2a", "alltoall", "skew_ids"),
    "indivisible": ("a2a", "alltoall", "odd_ids"),
}
LM = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
          vocab=64, chunk_q=16, aux_loss_coef=0.0)
MOE = dict(n_experts=8, top_k=2, d_ff=32, capacity_factor=8.0)
RULES = ("single_pod", "a2a", "fsdp_ep")
AXIS_NAMES = ("batch", "experts", "rows", "nodes", "vocab", "seq", "heads")
CONSTS = json.dumps(dict(MESH=MESH, MOE_X=MOE_X, BAG=BAG, BAG_CASES=BAG_CASES,
                         LM=LM, MOE=MOE, RULES=RULES, AXIS_NAMES=AXIS_NAMES))

# Both scripts read the inputs' parameter trees back from flat keys.
_UNFLAT = r"""
import json, sys
import numpy as np


def unflat(z, prefix):
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


C = json.loads(sys.argv[-1])
"""

_JAX_REF = _UNFLAT + r"""
import dataclasses
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.distributed.context import (
    axis_rules, axis_size, fsdp_ep_rules, make_mesh_compat, recsys_a2a_rules,
    single_pod_rules)
from repro.distributed.elastic import make_elastic_mesh, reshard
from repro.models import embedding as E, moe, recsys, transformer as T

z = np.load(sys.argv[1])
rules = {"single_pod": single_pod_rules(), "a2a": recsys_a2a_rules(False),
         "fsdp_ep": fsdp_ep_rules(False)}
mesh = make_mesh_compat(tuple(C["MESH"]), ("data", "model"))
res = {}

mcfg = moe.MoEConfig(**C["MOE"])
mp = jax.tree.map(jnp.asarray, unflat(z, "moe"))
for case in C["MOE_X"]:
    x = jnp.asarray(z[f"moe_x_{case}"])
    out, aux = moe.moe_apply(mp, x, mcfg)
    res[f"moe_local_{case}"], res[f"moe_local_aux_{case}"] = out, aux
    with axis_rules(rules["single_pod"], mesh):
        out, aux = jax.jit(lambda p, x: moe.moe_apply(p, x, mcfg))(mp, x)
    res[f"moe_{case}"], res[f"moe_aux_{case}"] = out, aux

spec = E.EmbeddingSpec(tuple(C["BAG"]["vocab"]), C["BAG"]["dim"],
                       pad_to_multiple=C["BAG"]["pad"])
table = jnp.asarray(z["bag_table"])
for case, (r, mode, key) in C["BAG_CASES"].items():
    ids = jnp.asarray(z[key])
    res[f"bag_local_{case}"] = E.embedding_bag(table, ids, spec)
    with axis_rules(rules[r], mesh):
        res[f"bag_{case}"] = jax.jit(
            lambda t, i: E.embedding_bag(t, i, spec, mode=mode))(table, ids)

lcfg = T.TransformerConfig(name="t", dtype=jnp.float32,
                           moe=moe.MoEConfig(**C["MOE"]), **C["LM"])
lp = jax.tree.map(jnp.asarray, unflat(z, "lm"))
batch = {"tokens": jnp.asarray(z["lm_tokens"])}
res["lm_local"] = T.train_loss(lp, batch, lcfg)
with axis_rules(rules["single_pod"], mesh):
    res["lm"] = jax.jit(lambda p, b: T.train_loss(p, b, lcfg))(lp, batch)

base = get_arch("deepfm").reduced()
fp = jax.tree.map(jnp.asarray, unflat(z, "fm"))
fids = jnp.asarray(z["fm_ids"])
res["fm_local"] = recsys.forward_logits(fp, fids, base)
for r, mode in (("single_pod", "psum"), ("a2a", "alltoall")):
    cfg = dataclasses.replace(base, emb_mode=mode)
    with axis_rules(rules[r], mesh):
        res[f"fm_{r}"] = jax.jit(
            lambda p, i: recsys.forward_logits(p, i, cfg))(fp, fids)

devs = jax.devices()
mesh1 = make_elastic_mesh(devs, model_pref=4)
x1 = jax.device_put(jnp.asarray(z["elastic_x"]),
                    NamedSharding(mesh1, P("data", "model")))
mesh2 = make_elastic_mesh(devs[:4], model_pref=4)
x2 = reshard(x1, NamedSharding(mesh2, P("data", "model")))
for s in x1.addressable_shards:
    res[f"elastic_old_{s.device.id}"] = s.data
for s in x2.addressable_shards:
    res[f"elastic_new_{s.device.id}"] = s.data
res["elastic_new_shape"] = np.asarray(mesh2.devices.shape)

for r in C["RULES"]:
    with jax.set_mesh(mesh), axis_rules(rules[r], mesh):
        res[f"axis_size_{r}"] = np.asarray(
            [axis_size(n) for n in C["AXIS_NAMES"]])

np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in res.items()})
"""

_TORCH_RANK = _UNFLAT + r"""
import dataclasses
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_arch
from repro_torch.distributed import (
    axis_rules, fsdp_ep_rules, init_group, leave_group, local_block,
    make_elastic_mesh, make_model_mesh, recsys_a2a_rules, reshard,
    single_pod_rules)
from repro_torch.models import embedding as E, moe, recsys
from repro_torch.models import transformer as T
from repro_torch.models.convert import (
    _fill, params_from_jax, place_on_mesh, transformer_from_jax)

rank, rdv, inp, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3], \
    sys.argv[4]
init_group("gloo", rank, 8, rdv, timeout_s=100)
mesh = make_model_mesh(tuple(C["MESH"]), device="cpu")
rules = {"single_pod": single_pod_rules(), "a2a": recsys_a2a_rules(False)}
z = np.load(inp)
t = lambda a: torch.from_numpy(np.array(a))
res = {"coords": np.asarray(mesh.coords)}

# which collectives each call made: the body that ran
calls = []
for name in ("all_to_all", "psum"):
    def counted(x, axes, _f=getattr(mesh, name), _n=name):
        calls.append(_n)
        return _f(x, axes)
    setattr(mesh, name, counted)

mcfg = moe.MoEConfig(**C["MOE"])
lcfg = T.TransformerConfig(name="t", dtype=torch.float32, moe=mcfg, **C["LM"])
mp = unflat(z, "moe")
layer = moe.MoE(mp["wi"].shape[1], mcfg, device="cpu")
with torch.no_grad():
    _fill(layer, mp, "moe")
# this rank's experts only (the "experts" rule: over "model")
place_on_mesh(layer, mesh, rules["single_pod"], "cpu")
res["moe_experts_held"] = np.asarray(layer.wi.shape[0])
for case in C["MOE_X"]:
    with torch.no_grad(), axis_rules(rules["single_pod"], mesh):
        o, aux = moe.moe_apply(layer, t(z[f"moe_x_{case}"]), mcfg)
    res[f"moe_{case}"], res[f"moe_aux_{case}"] = o.numpy(), aux.numpy()

spec = E.EmbeddingSpec(tuple(C["BAG"]["vocab"]), C["BAG"]["dim"],
                       pad_to_multiple=C["BAG"]["pad"])
for case, (r, mode, key) in C["BAG_CASES"].items():
    rows = rules[r]["rows"]
    table = local_block(t(z["bag_table"]), (rows, None), mesh).clone()
    del calls[:]
    with axis_rules(rules[r], mesh):
        res[f"bag_{case}"] = E.embedding_bag(table, t(z[key]), spec,
                                             mode=mode).numpy()
    res[f"bag_calls_{case}"] = np.asarray(
        [calls.count("all_to_all"), calls.count("psum")])

lm = place_on_mesh(transformer_from_jax(unflat(z, "lm"), lcfg, "cpu"), mesh,
                   rules["single_pod"], "cpu")
res["lm_experts_held"] = np.asarray(lm.layers[0].moe.wi.shape[0])
with torch.no_grad(), axis_rules(rules["single_pod"], mesh):
    res["lm"] = T.train_loss(lm, {"tokens": t(z["lm_tokens"])},
                             lcfg).numpy()

base = get_arch("deepfm").reduced()
for r, mode in (("single_pod", "psum"), ("a2a", "alltoall")):
    cfg = dataclasses.replace(base, emb_mode=mode)
    model = place_on_mesh(params_from_jax(unflat(z, "fm"), cfg, "cpu"),
                          mesh, rules[r], "cpu")
    res[f"fm_rows_{r}"] = np.asarray([model.table.shape[0],
                                      model.wide.shape[0]])
    with torch.no_grad(), axis_rules(rules[r], mesh):
        res[f"fm_{r}"] = recsys.forward_logits(model, t(z["fm_ids"]),
                                               cfg).numpy()

spec2 = ("data", "model")
block = local_block(t(z["elastic_x"]), spec2, mesh).clone()
res["elastic_old"] = block.numpy()
survivors = [0, 1, 2, 3]
mesh2 = (make_elastic_mesh(survivors, model_pref=4, device="cpu")
         if rank in survivors else None)
new = reshard({"x": block}, {"x": spec2}, mesh2, {"x": spec2},
              old_mesh=mesh)["x"]
if mesh2 is not None:
    res["elastic_new"] = new.numpy()
    res["elastic_new_shape"] = np.asarray(
        [mesh2.shape["data"], mesh2.shape["model"]])
np.savez(out_path, **res)
leave_group()
"""


def _flat(tree, prefix):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/#{i}"))
        return out
    return {prefix: np.asarray(tree)}


def _jax_moe_cfg():
    return jmoe.MoEConfig(**MOE)


def _inputs():
    """Every input, as numpy: ``repro``'s initialisers on this process's
    one JAX device, and numpy draws."""
    z = {}
    z.update(_flat(jmoe.moe_init(jax.random.PRNGKey(0), 16, _jax_moe_cfg(),
                                 jnp.float32), "moe"))
    rng = np.random.default_rng(1)
    for case, shape in MOE_X.items():
        z[f"moe_x_{case}"] = rng.standard_normal(shape).astype(np.float32)

    spec = jemb.EmbeddingSpec(BAG["vocab"], BAG["dim"],
                              pad_to_multiple=BAG["pad"])
    z["bag_table"] = np.asarray(jemb.init_table(jax.random.PRNGKey(0), spec))
    rng = np.random.default_rng(0)  # test_distributed.py:66's ids
    ids = np.stack([rng.integers(0, v, size=(16, 2))
                    for v in spec.vocab_sizes], 1)
    ids[:, :, 1] = np.where(rng.uniform(size=(16, 3)) < 0.5, -1, ids[:, :, 1])
    z["ids"] = ids.astype(np.int32)
    z["skew_ids"] = _skew_ids(spec)
    z["odd_ids"] = z["ids"][:12]  # 12 rows over the 8 ranks of the a2a batch

    lcfg = jtfm.TransformerConfig(name="t", dtype=jnp.float32,
                                  moe=_jax_moe_cfg(), **LM)
    z.update(_flat(jtfm.init_params(jax.random.PRNGKey(0), lcfg), "lm"))
    z["lm_tokens"] = np.random.default_rng(2).integers(
        0, LM["vocab"], (8, 32)).astype(np.int32)

    fcfg = jax_get_arch("deepfm").reduced()
    z.update(_flat(jrecsys.init_params(jax.random.PRNGKey(3), fcfg), "fm"))
    rng = np.random.default_rng(4)
    z["fm_ids"] = np.stack([rng.integers(0, v, size=(16, 1))
                            for v in fcfg.vocab_sizes], 1).astype(np.int32)
    z["elastic_x"] = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    return z


def _skew_ids(spec):
    """(16, 3, 4) ids whose batch rows 0 and 1 (the first rank's slice
    under ``recsys_a2a_rules`` on (2, 4)) send owner 0 (fused rows 0-44)
    sixteen requests against a ``cap`` of 12: row 0 all padding (a
    padding id goes to owner 0), then row 1's field 0, valid ids under
    45, past the cap.  The other rows are random with some padding."""
    rng = np.random.default_rng(5)
    ids = np.stack([rng.integers(0, v, size=(16, 4))
                    for v in spec.vocab_sizes], 1)
    ids = np.where(rng.uniform(size=ids.shape) < 0.25, -1, ids)
    ids[0] = -1
    ids[1, 0] = rng.integers(0, 45, size=4)
    return ids.astype(np.int32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The eight torch ranks' results (in rank order) and the JAX
    reference, run at once: ``{"torch": [...], "jax": {...}, "in":
    inputs}``."""
    tmp = tmp_path_factory.mktemp("mesh_ranks")
    z = _inputs()
    inp = tmp / "inputs.npz"
    np.savez(inp, **z)
    jax_env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                   JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                             "--xla_cpu_multi_thread_eigen=false")

    def jax_ref():
        res = subprocess.run(
            [sys.executable, "-c", _JAX_REF, str(inp), str(tmp / "jax.npz"),
             CONSTS], env=jax_env, cwd=REPO, capture_output=True, text=True,
            timeout=300)
        assert res.returncode == 0, res.stderr[-3000:]
        return dict(np.load(tmp / "jax.npz"))

    def torch_ranks():
        spawn_ranks(lambda r: ["-c", _TORCH_RANK, str(r), str(tmp / "rdv"),
                               str(inp), str(tmp / f"rank{r}.npz"), CONSTS],
                    WORLD, 120, env=rank_env(WORLD, {"OMP_NUM_THREADS": "1"}),
                    cwd=REPO)
        return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        fj, ft = pool.submit(jax_ref), pool.submit(torch_ranks)
        return {"torch": ft.result(), "jax": fj.result(), "in": z}


WHOLE_KEYS = ([f"moe_{c}" for c in MOE_X] + [f"moe_aux_{c}" for c in MOE_X]
              + [f"bag_{c}" for c in BAG_CASES] + ["lm", "fm_single_pod",
                                                   "fm_a2a"])


@pytest.mark.parametrize("key", WHOLE_KEYS)
def test_every_rank_returns_the_same_whole_output(ranks, key):
    first = ranks["torch"][0][key]
    for r in ranks["torch"][1:]:
        np.testing.assert_array_equal(r[key], first, err_msg=key)


def test_ranks_sit_on_the_mesh_row_by_row(ranks):
    for r, res in enumerate(ranks["torch"]):
        assert tuple(res["coords"]) == divmod(r, MESH[1])


@pytest.mark.parametrize("case", ["dm", "m"])
def test_moe_on_the_mesh_matches_repro(ranks, case):
    got, j = ranks["torch"][0], ranks["jax"]
    np.testing.assert_allclose(got[f"moe_{case}"], j[f"moe_{case}"],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got[f"moe_{case}"], j[f"moe_local_{case}"],
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("case", list(MOE_X))
def test_moe_aux_on_the_mesh_matches_repro(ranks, case):
    got, j = ranks["torch"][0], ranks["jax"]
    aux = float(got[f"moe_aux_{case}"])
    np.testing.assert_allclose(aux, j[f"moe_aux_{case}"], rtol=1e-5)
    assert np.isfinite(aux)
    assert 0.2 < aux / float(j[f"moe_local_aux_{case}"]) < 5.0


def test_moe_holds_only_its_experts(ranks):
    for res in ranks["torch"]:
        assert int(res["moe_experts_held"]) == MOE["n_experts"] // MESH[1]
        assert int(res["lm_experts_held"]) == MOE["n_experts"] // MESH[1]


def test_moe_replicated_tokens_read_zero_where_repro_wraps(ranks):
    """(1, 3, 16): T = 3 does not divide by the 4 shards, so each shard
    runs its own experts on every token.  The port reads 0 for another
    shard's expert and equals the local layer; ``repro``'s
    ``expert_out.at[loc_e, pos].get(mode="fill")`` wraps a negative
    ``loc_e`` (JAX normalises negative indices before it fills), so its
    mesh output parts from its local output.  Where it does not, the
    port equals it."""
    got, j = ranks["torch"][0]["moe_psum"], ranks["jax"]
    local, mesh_out = j["moe_local_psum"], j["moe_psum"]
    np.testing.assert_allclose(got, local, rtol=2e-4, atol=2e-5)
    same = np.all(np.isclose(mesh_out, local, rtol=2e-4, atol=2e-5), -1)
    assert not same.all(), "repro's wrap no longer shows: refile queue 3"
    np.testing.assert_allclose(got[same], mesh_out[same], rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("case", ["psum", "alltoall", "fallback",
                                  "indivisible"])
def test_embedding_bag_on_the_mesh_matches_repro(ranks, case):
    got, j = ranks["torch"][0][f"bag_{case}"], ranks["jax"]
    np.testing.assert_allclose(got, j[f"bag_{case}"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, j[f"bag_local_{case}"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("case,calls", [
    ("psum", (0, 1)), ("alltoall", (2, 0)), ("fallback", (0, 1)),
    ("skew", (2, 0)), ("indivisible", (0, 1))])
def test_embedding_bag_runs_the_body_repro_selects(ranks, case, calls):
    """psum: one sum over "model"; alltoall: one exchange of ids and one
    of rows; alltoall without "model" in the batch axes, or with a batch
    that does not divide over the exchange group: psum."""
    for res in ranks["torch"]:
        assert tuple(res[f"bag_calls_{case}"]) == calls


def test_skewed_alltoall_drops_as_repro(ranks):
    """The first rank sends owner 0 sixteen requests against a cap of 12:
    the last four, batch row 1's field 0, are dropped by both packages,
    so row 1 (the first that differs) is short of the local bag."""
    got, j = ranks["torch"][0]["bag_skew"], ranks["jax"]
    np.testing.assert_allclose(got, j["bag_skew"], rtol=1e-5, atol=1e-6)
    local = j["bag_local_skew"]
    differs = ~np.all(np.isclose(got, local, rtol=1e-5, atol=1e-6),
                      axis=(1, 2))
    assert differs.any() and int(np.argmax(differs)) == 1
    np.testing.assert_array_equal(got[1, 0], 0.0)
    assert np.abs(local[1, 0]).max() > 0


def test_lm_loss_on_the_mesh_matches_repro(ranks):
    got, j = float(ranks["torch"][0]["lm"]), ranks["jax"]
    assert abs(got - float(j["lm"])) < 1e-4
    assert abs(got - float(j["lm_local"])) < 5e-3


@pytest.mark.parametrize("rules", ["single_pod", "a2a"])
def test_deepfm_forward_on_the_mesh_matches_repro(ranks, rules):
    got, j = ranks["torch"][0][f"fm_{rules}"], ranks["jax"]
    np.testing.assert_allclose(got, j[f"fm_{rules}"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, j["fm_local"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rules,shards", [("single_pod", MESH[1]),
                                          ("a2a", WORLD)])
def test_deepfm_ranks_hold_only_their_rows(ranks, rules, shards):
    total = jax_get_arch("deepfm").reduced().spec.total_rows
    for res in ranks["torch"]:
        assert tuple(res[f"fm_rows_{rules}"]) == (total // shards,
                                                  total // shards)


@pytest.mark.parametrize("rank", range(WORLD))
def test_elastic_blocks_match_repro(ranks, rank):
    """Each rank's block on (2, 4) and, for survivors 0-3, on (1, 4)
    after ``reshard``, bit for bit against ``repro``'s shards."""
    got, j = ranks["torch"][rank], ranks["jax"]
    np.testing.assert_array_equal(got["elastic_old"],
                                  j[f"elastic_old_{rank}"])
    if rank < 4:
        np.testing.assert_array_equal(got["elastic_new"],
                                      j[f"elastic_new_{rank}"])
        np.testing.assert_array_equal(got["elastic_new_shape"],
                                      j["elastic_new_shape"])
    else:
        assert "elastic_new" not in got


@pytest.mark.parametrize("rules", RULES)
def test_axis_size_on_the_mesh_matches_repro(ranks, rules):
    table = {"single_pod": single_pod_rules(), "a2a": recsys_a2a_rules(False),
             "fsdp_ep": fsdp_ep_rules(False)}[rules]
    ranks_grid = tuple(tuple(range(i * MESH[1], (i + 1) * MESH[1]))
                       for i in range(MESH[0]))
    mesh = ModelMesh(ranks_grid, 0, torch.device("cpu"))
    with axis_rules(table, mesh):
        got = [axis_size(n) for n in AXIS_NAMES]
    assert got == list(ranks["jax"][f"axis_size_{rules}"])
