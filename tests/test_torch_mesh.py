"""The port's model-parallel context (``repro_torch.distributed.context``
and ``elastic``) against ``repro``'s, in this process: the rule tables,
``logical_to_spec``, ``data_axis_names``, ``model_axis_name``,
``axis_size`` and ``constrain`` outside and inside ``axis_rules``, and
``choose_mesh_shape``; and the mesh's own arithmetic (a rank's axis
indices, its groups' ranks, its blocks) on meshes built without a
process group, which a collective over axes of size 1 never needs.
The ranks themselves run in ``tests/test_torch_mesh_ranks.py``."""
import pytest
import torch
import jax.numpy as jnp

from repro.distributed import context as jctx
from repro.distributed.elastic import choose_mesh_shape as jchoose
from repro_torch.distributed import context as ctx
from repro_torch.distributed.elastic import choose_mesh_shape

TABLES = {
    "single_pod": (jctx.single_pod_rules, ctx.single_pod_rules, ()),
    "multi_pod": (jctx.multi_pod_rules, ctx.multi_pod_rules, ()),
    "fsdp_ep": (jctx.fsdp_ep_rules, ctx.fsdp_ep_rules, (False,)),
    "fsdp_ep_multi": (jctx.fsdp_ep_rules, ctx.fsdp_ep_rules, (True,)),
    "a2a": (jctx.recsys_a2a_rules, ctx.recsys_a2a_rules, (False,)),
    "a2a_multi": (jctx.recsys_a2a_rules, ctx.recsys_a2a_rules, (True,)),
}
NAMES = [("batch", None, None), ("batch", "seq", "heads", None),
         ("batch", None, "vocab"), ("rows", None), ("experts", None, None),
         ("nodes",), ("fsdp_expert", "ff"), ("missing", "model")]


def spec(entries):
    """A spec with each one-axis tuple as its name, as ``PartitionSpec``
    stores it (``P(("data",))`` is ``P("data")``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def tables(name):
    jfn, tfn, args = TABLES[name]
    return jfn(*args), tfn(*args)


def grid(D, M):
    return tuple(tuple(range(i * M, (i + 1) * M)) for i in range(D))


def fake_mesh(D, M, rank):
    """Rank ``rank``'s view of a (D, M) mesh, no process group."""
    return ctx.ModelMesh(grid(D, M), rank, torch.device("cpu"))


@pytest.mark.parametrize("name", list(TABLES))
def test_rule_tables_match_repro(name):
    want, got = tables(name)
    assert dict(got) == dict(want)


@pytest.mark.parametrize("names", NAMES, ids=str)
@pytest.mark.parametrize("name", list(TABLES))
def test_logical_to_spec_matches_repro(name, names):
    jr, tr = tables(name)
    with jctx.axis_rules(jr), ctx.axis_rules(tr):
        assert spec(ctx.logical_to_spec(*names)) == spec(
            jctx.logical_to_spec(*names))


@pytest.mark.parametrize("name", list(TABLES))
def test_axis_names_match_repro(name):
    jr, tr = tables(name)
    with jctx.axis_rules(jr), ctx.axis_rules(tr):
        assert ctx.data_axis_names() == jctx.data_axis_names()
        assert ctx.model_axis_name() == jctx.model_axis_name()
        assert ctx.current_rules() == jctx.current_rules()
        assert ctx.current_mesh() is None


def test_outside_rules_everything_is_a_no_op():
    assert ctx.logical_to_spec("batch") == tuple(jctx.logical_to_spec("batch"))
    assert ctx.data_axis_names() == jctx.data_axis_names() == ()
    assert ctx.model_axis_name() is jctx.model_axis_name() is None
    assert ctx.axis_size("batch") == jctx.axis_size("batch") == 1
    x, jx = torch.ones(2, 3), jnp.ones((2, 3))
    assert ctx.constrain(x, "batch", None) is x
    assert jctx.constrain(jx, "batch", None) is jx


@pytest.mark.parametrize("name", list(TABLES))
def test_axis_size_without_a_mesh_is_one(name):
    jr, tr = tables(name)
    with jctx.axis_rules(jr), ctx.axis_rules(tr):
        for n in ("batch", "experts", "rows", "nodes", "missing"):
            assert ctx.axis_size(n) == jctx.axis_size(n) == 1


@pytest.mark.parametrize("shape", [(2, 4), (1, 4), (4, 1), (1, 1)])
def test_axis_size_reads_the_installed_mesh(shape):
    D, M = shape
    with ctx.axis_rules(ctx.recsys_a2a_rules(False), fake_mesh(D, M, 0)):
        assert ctx.axis_size("batch") == D * M
        assert ctx.axis_size("experts") == M
        assert ctx.axis_size("heads") == M
        assert ctx.axis_size("missing") == 1
    with ctx.axis_rules(ctx.multi_pod_rules(), fake_mesh(D, M, 0)):
        assert ctx.axis_size("batch") == D  # no "pod" axis: size 1


def test_constrain_returns_its_input_and_checks_the_names():
    x = torch.arange(6.0).reshape(2, 3)
    mesh = fake_mesh(2, 4, 5)
    with ctx.axis_rules(ctx.single_pod_rules(), mesh):
        assert ctx.constrain(x, "batch", "vocab") is x
        with pytest.raises(ValueError, match="dimensions"):
            ctx.constrain(x, "batch", None, None)
    with ctx.axis_rules(ctx.multi_pod_rules(), mesh):
        with pytest.raises(ValueError, match="pod"):
            ctx.constrain(x, "batch", None)
    with ctx.axis_rules(ctx.multi_pod_rules()):  # no mesh: names only
        assert ctx.constrain(x, "batch", None) is x


@pytest.mark.parametrize("n,pref,want", [
    (512, 16, (32, 16)), (496, 16, (31, 16)), (504, 16, (31, 16)),
    (7, 16, (1, 4)), (24, 8, (3, 8))])
def test_choose_mesh_shape_matches_repro(n, pref, want):
    assert choose_mesh_shape(n, pref) == jchoose(n, pref) == want


def test_choose_mesh_shape_matches_repro_on_a_grid():
    for n in range(1, 70):
        for pref in (1, 2, 3, 4, 6, 8, 16):
            assert choose_mesh_shape(n, pref) == jchoose(n, pref), (n, pref)


@pytest.mark.parametrize("rank", range(8))
def test_mesh_indices_and_groups(rank):
    mesh = fake_mesh(2, 4, rank)
    i, j = divmod(rank, 4)
    assert mesh.coords == (i, j)
    assert mesh.axis_index("data") == i
    assert mesh.axis_index("model") == j
    assert mesh.axis_index(("data", "model")) == rank
    assert mesh.axis_index(None) == 0
    assert mesh.group_ranks("model") == tuple(range(4 * i, 4 * i + 4))
    assert mesh.group_ranks("data") == (j, 4 + j)
    assert mesh.group_ranks(("data", "model")) == tuple(range(8))
    assert mesh.group_ranks(()) == (rank,)


def test_mesh_axes_are_checked():
    mesh = fake_mesh(2, 4, 0)
    assert mesh.axes(None) == () and mesh.axes("model") == ("model",)
    with pytest.raises(ValueError, match="order"):
        mesh.axes(("model", "data"))
    with pytest.raises(ValueError, match="pod"):
        mesh.axes(("pod", "data"))


@pytest.mark.parametrize("rank", range(8))
def test_local_block_is_the_ranks_slice(rank):
    """``repro``'s ``NamedSharding`` blocks on a (2, 4) mesh: a tuple of
    axes splits one dimension row-major over them."""
    x = torch.arange(128.0).reshape(16, 8)
    mesh = fake_mesh(2, 4, rank)
    i, j = divmod(rank, 4)
    assert torch.equal(ctx.local_block(x, ("data", "model"), mesh),
                       x[8 * i:8 * i + 8, 2 * j:2 * j + 2])
    assert torch.equal(ctx.local_block(x, (("data", "model"), None), mesh),
                       x[2 * rank:2 * rank + 2])
    assert torch.equal(ctx.local_block(x, ("model",), mesh),
                       x[4 * j:4 * j + 4])
    assert torch.equal(ctx.local_block(x, (None, "data"), mesh),
                       x[:, 4 * i:4 * i + 4])
    with pytest.raises(ValueError, match="split"):
        ctx.local_block(torch.zeros(6, 2), (("data", "model"),), mesh)


def test_one_rank_axes_need_no_group():
    """On a (1, 1) mesh every collective returns its input, and a gather
    or a reblock is the block itself: no process group is touched."""
    mesh = fake_mesh(1, 1, 0)
    x = torch.arange(6.0).reshape(3, 2)
    y = x[:1]
    assert mesh.all_to_all(y, ("data", "model")) is y
    assert torch.equal(mesh.psum(x, "model"), x)
    assert torch.equal(mesh.all_gather(x, "data"), x[None])
    assert torch.equal(mesh.pmean(x, ("data", "model")), x)
    assert ctx.gather_block(x, ("data", "model"), mesh) is x
    assert mesh.collectives == 0


def test_reblock_keeps_a_block_placed_alike():
    mesh = fake_mesh(1, 4, 2)
    x = torch.arange(8.0).reshape(4, 2)
    assert ctx.reblock(x, ("model", None), ("model", None), mesh) is x
    # "data" has one rank: rows over (data, model) are rows over model
    assert ctx.reblock(x, (("data", "model"), None), ("model", None),
                       mesh) is x
    assert mesh.collectives == 0


def test_axis_rules_nest_and_restore():
    mesh = fake_mesh(2, 4, 0)
    with ctx.axis_rules(ctx.single_pod_rules(), mesh):
        with ctx.axis_rules(ctx.recsys_a2a_rules(False)):
            assert ctx.current_mesh() is None
            assert ctx.data_axis_names() == ("data", "model")
        assert ctx.current_mesh() is mesh
        assert ctx.data_axis_names() == ("data",)
    assert ctx.current_rules() is None and ctx.current_mesh() is None


def test_make_model_mesh_needs_a_group(monkeypatch):
    monkeypatch.setattr(ctx.dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="process group"):
        ctx.make_model_mesh((1, 1), device="cpu")
    assert ctx.MESH_AXES == ("data", "model")


@pytest.mark.parametrize("rules,rows", [("single_pod", 32), ("a2a", 32),
                                        ("a2a", 8)])
def test_embedding_bag_on_a_mesh_takes_only_the_rank_block(rules, rows):
    """A rank holds its rows of the table under the rules' ``"rows"``
    entry (32 rows over "model", 4 ranks: 8; over (data, model), 8
    ranks: 4); the whole table, or another rule's block, raises before a
    collective is made."""
    from repro_torch.models.embedding import EmbeddingSpec, embedding_bag

    spec = EmbeddingSpec((20, 12), 4, pad_to_multiple=8)
    ok = {"single_pod": 8, "a2a": 4}[rules]
    assert spec.total_rows == 32 and rows != ok
    mesh = fake_mesh(2, 4, 0)
    ids = torch.zeros((8, 2, 1), dtype=torch.int32)
    table = ctx.single_pod_rules if rules == "single_pod" else (
        lambda: ctx.recsys_a2a_rules(False))
    with ctx.axis_rules(table(), mesh), pytest.raises(ValueError,
                                                       match="block"):
        embedding_bag(torch.zeros(rows, 4), ids, spec, mode="alltoall")
    assert mesh.collectives == 0


@pytest.mark.parametrize("held", [8, 1])
def test_moe_on_a_mesh_takes_only_the_rank_experts(held):
    """On a (2, 4) mesh a rank holds 2 of the 8 experts; all 8, or any
    other count, raises before a collective is made."""
    from repro_torch.models import moe

    cfg = moe.MoEConfig(n_experts=8, top_k=2, d_ff=8)
    m = moe.MoE(8, cfg, generator=torch.Generator().manual_seed(0),
                device="cpu")
    with torch.no_grad():
        for name in ("wi", "wg", "wo"):
            setattr(m, name, torch.nn.Parameter(getattr(m, name)[:held]))
    mesh = fake_mesh(2, 4, 0)
    x = torch.zeros(1, 8, 8)
    with ctx.axis_rules(ctx.single_pod_rules(), mesh), pytest.raises(
            ValueError, match="experts held"):
        moe.moe_apply(m, x, cfg)
    assert mesh.collectives == 0
