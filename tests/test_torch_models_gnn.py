"""Parity of the port's GNN (``repro_torch.models.gnn``,
``convert.gnn_from_jax``) and graph and LM generators
(``repro_torch.data.synthetic``) with ``repro``'s, on the CPU.

``repro``'s parameters cross through ``gnn_from_jax``; the graphs are
numpy from both packages' generators.  Outputs within rtol 1e-4 / atol
1e-5 (float32 matrix products and scatter sums in another order); the
generators array for array, equal.  Under ``max`` a node with no in-edge
makes non-finite outputs in ``repro`` (``segment_max`` fills an empty
segment with -inf): the port's non-finite entries must sit where
``repro``'s do, and the rest agree within the tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro.models import gnn as jgnn
from repro_torch import data
from repro_torch.models import gnn
from repro_torch.models.convert import gnn_from_jax

RTOL, ATOL = 1e-4, 1e-5
CPU = "cpu"
TINY = gnn.GNNConfig(
    name="tiny-gnn", n_layers=2, d_hidden=16, d_feat=8, n_vars=3, d_edge=4,
    dtype=torch.float32,
)


@pytest.fixture(autouse=True)
def _inference():
    with torch.inference_mode():
        yield


def jax_cfg(cfg):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = {torch.float32: jnp.float32,
                       torch.bfloat16: jnp.bfloat16}[cfg.dtype]
    return jgnn.GNNConfig(**fields)


def models(cfg, seed=0):
    params = jgnn.init_params(jax.random.PRNGKey(seed), jax_cfg(cfg))
    return params, gnn_from_jax(jax.tree.map(np.asarray, params), cfg, CPU)


def both(cfg, feats, edges, edge_mask=None):
    """(port output, repro output) as float32 numpy."""
    params, model = models(cfg)
    got = gnn.apply(model, torch.from_numpy(feats), torch.from_numpy(edges),
                    cfg, None if edge_mask is None
                    else torch.from_numpy(edge_mask))
    want = jgnn.apply(params, jnp.asarray(feats), jnp.asarray(edges),
                      jax_cfg(cfg), None if edge_mask is None
                      else jnp.asarray(edge_mask))
    return got.numpy(), np.asarray(want, np.float32)


def with_in_edges(g):
    """``g``'s edges plus a ring (i+1 -> i), so every node has an in-edge."""
    n = g.node_feats.shape[0]
    ring = np.stack([(np.arange(n) + 1) % n, np.arange(n)], 1)
    return np.concatenate([g.edges, ring.astype(np.int32)])


@pytest.mark.parametrize("aggregator", ["sum", "mean", "max"])
def test_apply_matches_repro(aggregator):
    cfg = dataclasses.replace(TINY, aggregator=aggregator)
    g = data.random_graph(50, 200, cfg.d_feat, cfg.n_vars, seed=0)
    got, want = both(cfg, g.node_feats, with_in_edges(g))
    assert got.shape == (50, cfg.n_vars)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("aggregator", ["sum", "mean", "max"])
def test_edge_mask_excludes_padding_as_repro(aggregator):
    cfg = dataclasses.replace(TINY, aggregator=aggregator)
    g = data.random_graph(25, 80, cfg.d_feat, cfg.n_vars, seed=3)
    edges = with_in_edges(g)
    bad = np.asarray([[0, 1], [3, 4], [7, 7]], np.int32)
    mask = np.asarray([True] * len(edges) + [False] * 3)
    got, want = both(cfg, g.node_feats, np.concatenate([edges, bad]), mask)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if aggregator == "sum":  # mean counts masked edges, max takes their 0s
        ref, _ = both(cfg, g.node_feats, edges)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_max_without_an_in_edge_is_non_finite_where_repro_is():
    cfg = dataclasses.replace(TINY, aggregator="max")
    g = data.random_graph(50, 200, cfg.d_feat, cfg.n_vars, seed=0)
    lonely = np.setdiff1d(np.arange(50), g.edges[:, 1])
    assert lonely.size  # the skewed draw leaves nodes with no in-edge
    got, want = both(cfg, g.node_feats, g.edges)
    finite = np.isfinite(want)
    assert not finite.all()
    assert np.array_equal(np.isfinite(got), finite)
    assert not np.isfinite(got[lonely]).any()
    np.testing.assert_allclose(got[finite], want[finite], rtol=RTOL,
                               atol=ATOL)


def test_aggregate_matches_segment_ops():
    rng = np.random.default_rng(2)
    N, E, D = 20, 60, 5
    dst = rng.integers(0, N - 3, E)  # the last 3 nodes get nothing
    msgs = rng.standard_normal((E, D)).astype(np.float32)
    for how in ("sum", "mean", "max"):
        got = gnn._aggregate(torch.from_numpy(msgs), torch.from_numpy(dst),
                             N, how)
        want = jgnn._aggregate(jnp.asarray(msgs), jnp.asarray(dst), N, how)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    assert (gnn._aggregate(torch.from_numpy(msgs), torch.from_numpy(dst), N,
                           "max")[-3:] == float("-inf")).all()
    with pytest.raises(ValueError):
        gnn._aggregate(torch.from_numpy(msgs), torch.from_numpy(dst), N, "p")


def test_batched_molecules_disjoint_and_as_repro():
    batch = data.batched_molecules(8, nodes_per=10, edges_per=20,
                                   d_feat=TINY.d_feat, n_vars=TINY.n_vars,
                                   seed=5)
    got, want = both(TINY, batch["node_feats"], batch["edges"])
    assert got.shape == (80, TINY.n_vars)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    feats2 = batch["node_feats"].copy()
    feats2[70:] += 100.0
    got2, _ = both(TINY, feats2, batch["edges"])
    np.testing.assert_allclose(got2[:10], got[:10], rtol=RTOL, atol=ATOL)


def test_bf16_apply_is_finite():
    cfg = dataclasses.replace(TINY, dtype=torch.bfloat16)
    model = gnn.init_params(torch.Generator().manual_seed(0), cfg)
    g = data.random_graph(40, 160, cfg.d_feat, cfg.n_vars, seed=1)
    out = gnn.apply(model, torch.from_numpy(g.node_feats),
                    torch.from_numpy(with_in_edges(g)), cfg)
    assert out.dtype == torch.bfloat16 and out.shape == (40, cfg.n_vars)
    assert torch.isfinite(out.float()).all()


def test_module_holds_repros_parameter_count():
    params, model = models(TINY)
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(params))


def test_gnn_converter_refuses_a_wrong_shape_and_a_missing_leaf():
    params, _ = models(TINY)
    tree = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError, match="edge_embed"):
        gnn_from_jax(dict(tree, edge_embed={"w": tree["edge_embed"]["w"][1:],
                                            "b": tree["edge_embed"]["b"]}),
                     TINY, CPU)
    with pytest.raises(KeyError, match="decoder"):
        gnn_from_jax({k: v for k, v in tree.items() if k != "decoder"},
                     TINY, CPU)


# ---------------------------------------------------------------------------
# the generators
# ---------------------------------------------------------------------------


def same_arrays(got: dict, want: dict):
    assert set(got) == set(want)
    for key in got:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("seed", [0, 7])
def test_random_graph_equals_repro(seed):
    g = data.random_graph(200, 1200, 8, 3, seed=seed)
    j = jdata.random_graph(200, 1200, 8, 3, seed=seed)
    same_arrays(dataclasses.asdict(g), dataclasses.asdict(j))


def test_neighbor_sample_and_pad_subgraph_equal_repro():
    g = data.random_graph(200, 1200, 8, 3, seed=4)
    jg = jdata.random_graph(200, 1200, 8, 3, seed=4)
    seeds = np.random.default_rng(0).choice(200, size=16, replace=False)
    sub = data.neighbor_sample(g, seeds, fanouts=(5, 3),
                               rng=np.random.default_rng(1))
    jsub = jdata.neighbor_sample(jg, seeds, fanouts=(5, 3),
                                 rng=np.random.default_rng(1))
    same_arrays(sub, jsub)
    same_arrays(data.pad_subgraph(sub, 512, 2048),
                jdata.pad_subgraph(jsub, 512, 2048))


def test_batched_molecules_equal_repro():
    same_arrays(data.batched_molecules(6, 10, 20, 8, 3, seed=5),
                jdata.batched_molecules(6, 10, 20, 8, 3, seed=5))


def test_lm_batches_equal_repro():
    it, jit = data.lm_batches(300, 4, 12, seed=3), jdata.lm_batches(
        300, 4, 12, seed=3)
    for _ in range(3):
        same_arrays(next(it), next(jit))
