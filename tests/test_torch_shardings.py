"""The port's sharding rules (``repro_torch.launch.shardings``) against
``repro``'s (``repro.launch.shardings``), in process and without a mesh.

``repro``'s spec functions read only ``mesh.shape``, so a stub with a
``shape`` mapping stands in for the production meshes: (16, 16) over
("data", "model") and (2, 16, 16) over ("pod", "data", "model").  For
every architecture, under each of the four rule tables on the mesh it
names (``single_pod_rules`` and the 2-D ``fsdp_ep_rules`` and
``recsys_a2a_rules`` on the pod, ``multi_pod_rules`` and their 3-D
forms on the multipod) and both LM profiles, every port parameter's
block equals ``repro``'s ``_fix_spec(<spec fn>(...), shape, stub)``
block of the leaf it is converted from: the leaf's shape from
``jax.eval_shape`` of ``repro``'s ``init_params``, the port's from its
module built under ``FakeTensorMode`` (nothing allocated, arctic-480b
included).  Shapes only, exactly.
"""
import dataclasses
import functools

import numpy as np
import pytest

import jax
from jax.sharding import PartitionSpec as P

from repro.configs import get_arch as jax_get_arch
from repro.distributed import context as jctx
from repro.launch import shardings as jsh
from repro.models import gnn as jgnn
from repro.models import recsys as jrecsys
from repro.models import transformer as jtfm
from repro_torch.configs import get_arch, list_archs
from repro_torch.distributed import context as ctx
from repro_torch.launch import shardings as sh
from repro_torch.models.convert import repro_leaves


@dataclasses.dataclass
class Stub:
    shape: dict


MESHES = {"pod": Stub({"data": 16, "model": 16}),
          "multipod": Stub({"pod": 2, "data": 16, "model": 16})}
TABLES = {  # name: (repro's rules, the port's)
    "single_pod": (jctx.single_pod_rules, ctx.single_pod_rules),
    "multi_pod": (jctx.multi_pod_rules, ctx.multi_pod_rules),
    "fsdp_ep": (jctx.fsdp_ep_rules, ctx.fsdp_ep_rules),
    "a2a": (jctx.recsys_a2a_rules, ctx.recsys_a2a_rules),
}
ON_MESH = {"pod": ("single_pod", "fsdp_ep", "a2a"),
           "multipod": ("multi_pod", "fsdp_ep", "a2a")}


def _rules(table, mesh):
    j, t = TABLES[table]
    if table in ("single_pod", "multi_pod"):
        return j(), t()
    return j(mesh == "multipod"), t(mesh == "multipod")


def _cases():
    out = []
    for a in list_archs():
        profiles = (("baseline", "fsdp_ep") if get_arch(a).family == "lm"
                    else ("baseline",))
        for mesh, tables in ON_MESH.items():
            for table in tables:
                for p in profiles:
                    out.append((a, mesh, table, p))
    return out


@functools.lru_cache(maxsize=None)
def _repro_tree(arch_id):
    arch = jax_get_arch(arch_id)
    init = {"lm": jtfm.init_params, "recsys": jrecsys.init_params,
            "gnn": jgnn.init_params}[arch.family]
    return jax.eval_shape(lambda: init(jax.random.PRNGKey(0), arch.config))


@functools.lru_cache(maxsize=None)
def _port_model(arch_id):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.gnn import GNN
    from repro_torch.models.recsys import RecsysModel
    from repro_torch.models.transformer import Transformer

    arch = get_arch(arch_id)
    cls = {"lm": Transformer, "recsys": RecsysModel, "gnn": GNN}[arch.family]
    with FakeTensorMode():
        return cls(arch.config, device="cpu")


def _block(shape, spec, stub):
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None or d >= len(out):
            continue
        for a in (entry,) if isinstance(entry, str) else entry:
            out[d] //= stub.shape[a]
    return tuple(out)


def _repro_blocks(arch_id, stub, rules, profile):
    family = jax_get_arch(arch_id).family
    fn = {"lm": lambda p, l: jsh.lm_param_spec(p, l, rules, profile),
          "recsys": lambda p, l: jsh.recsys_param_spec(p, l, rules),
          "gnn": lambda p, l: jsh.gnn_param_spec(p, l, rules)}[family]
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            _repro_tree(arch_id))[0]:
        spec = jsh._fix_spec(fn(path, leaf), leaf.shape, stub)
        out[jsh._path_str(path)] = _block(leaf.shape, spec, stub)
    return out


@pytest.mark.parametrize("arch_id,mesh,table,profile", _cases())
def test_every_leaf_block_matches_repro(arch_id, mesh, table, profile):
    stub = MESHES[mesh]
    jrules, trules = _rules(table, mesh)
    want = _repro_blocks(arch_id, stub, jrules, profile)
    model = _port_model(arch_id)
    family = get_arch(arch_id).family
    specs = sh.param_specs(family, model, stub, trules, profile)
    leaves = repro_leaves(model)
    seen = set()
    for name, prm in model.named_parameters():
        path, transposed, stacked = leaves[name]
        got = sh.local_shape(tuple(prm.shape), specs[name], stub)
        if transposed:
            got = tuple(reversed(got))
        ref = want[path][1:] if stacked else want[path]
        assert got == ref, (name, path, got, ref)
        seen.add(path)
    assert seen == set(want)


@pytest.mark.parametrize("mesh,table", [(m, t) for m, ts in ON_MESH.items()
                                        for t in ts])
def test_batch_axes_match_repro(mesh, table):
    stub = MESHES[mesh]
    jrules, trules = _rules(table, mesh)
    for n in (1, 16, 32, 128, 512, 1000, 1000448, 262144):
        assert sh.batch_axes_for(trules, n, stub) == jsh.batch_axes_for(
            jrules, n, stub)


def test_fix_spec_matches_repro():
    rng = np.random.default_rng(0)
    axes = [None, "data", "model", ("data", "model"), ("pod", "data"),
            ("pod", "data", "model")]
    stub = MESHES["multipod"]
    for _ in range(300):
        spec = tuple(axes[i] for i in rng.integers(0, len(axes), size=3))
        shape = tuple(int(x) for x in rng.choice(
            [1, 2, 20, 32, 6912, 512, 1000, 30], size=3))
        want = tuple(jsh._fix_spec(P(*spec), shape, stub))
        assert sh._fix_spec(spec, shape, stub) == want, (spec, shape)


@dataclasses.dataclass
class DMStub:
    mesh_dim_names: tuple
    shape: tuple


def test_placements_follow_the_spec_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    m3 = DMStub(("pod", "data", "model"), (2, 16, 16))
    assert ctx.spec_placements((("pod", "data"), "model"), m3) == [
        Shard(0), Shard(0), Shard(1)]
    assert ctx.spec_placements((None, None), m3) == [Replicate()] * 3
    m2 = DMStub(("data", "model"), (16, 16))
    assert ctx.spec_placements(("model",), m2) == [Replicate(), Shard(0)]
    # an axis of one rank splits nothing
    assert ctx.spec_placements(("data", "model"), DMStub(
        ("data", "model"), (1, 4))) == [Replicate(), Shard(1)]


@pytest.mark.parametrize("rank", [0, 5, 11, 15])
def test_pod_mesh_indices_and_groups(rank):
    """A (2, 2, 4) ("pod", "data", "model") ``ModelMesh``: a rank's index
    along any axes is row-major over them in mesh order, its group the
    ranks that share its other indices, as ``numpy`` lays out
    ``arange(16).reshape(2, 2, 4)``; every group ``make_model_mesh`` makes
    is one of them."""
    import itertools

    import torch

    grid = np.arange(16).reshape(2, 2, 4)
    rows = tuple(tuple(int(r) for r in row) for row in grid.reshape(4, 4))
    mesh = ctx.ModelMesh(rows, rank, torch.device("cpu"), pods=2)
    p, d, m = (int(i) for i in np.argwhere(grid == rank)[0])
    assert mesh.shape == {"pod": 2, "data": 2, "model": 4}
    assert mesh.coords == (p, d, m)
    names = ("pod", "data", "model")
    made = ctx._mesh_group_sets(rows, 2)
    for n in (1, 2, 3):
        for axes in itertools.combinations(names, n):
            idx = [slice(None) if a in axes else c
                   for a, c in zip(names, (p, d, m))]
            want = tuple(int(r) for r in grid[tuple(idx)].reshape(-1))
            assert mesh.group_ranks(axes) == want
            assert mesh.axis_index(axes) == want.index(rank)
            assert mesh.axis_size(axes) == len(want)
            assert want in made
    with pytest.raises(ValueError, match="order"):
        mesh.axes(("data", "pod"))
    two = ctx.ModelMesh(rows, rank, torch.device("cpu"))
    assert two.axis_names == ("data", "model") and two.coords == divmod(
        rank, 4)
