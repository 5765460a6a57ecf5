"""Parity of the port's interaction datasets and §5.2 protocol
(``repro_torch.data.interactions``) with ``repro.data``'s.

Both are numpy and draw from one generator in the same order, so the
same seed must give equal arrays: every preset's train profiles and
held-out items, the item-item similarity S, and every user's candidates
and relevance, exactly.
"""
import numpy as np
import pytest

import repro.data as jd
import repro_torch.data as td

# top-K-similar candidate widths of the Figure-3 protocol
TOP_K = {"movielens-like": 30, "lastfm-like": 20, "jester-like": 20}


def _assert_same_dataset(got, want):
    assert (got.name, got.n_users, got.n_items) == (
        want.name, want.n_users, want.n_items)
    assert len(got.train) == len(want.train)
    for g, w in zip(got.train, want.train):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.test, want.test)


def test_presets_match():
    assert td.PRESETS == jd.interactions.PRESETS


@pytest.mark.parametrize("name", sorted(TOP_K))
def test_preset_split_matches_repro(name):
    _assert_same_dataset(td.load_preset(name), jd.load_preset(name))


@pytest.mark.parametrize("name", sorted(TOP_K))
def test_similarity_and_candidates_match_repro(name):
    ds_t, ds_j = td.load_preset(name), jd.load_preset(name)
    S_t, S_j = td.item_similarity(ds_t), jd.item_similarity(ds_j)
    assert S_t.dtype == np.float32
    np.testing.assert_array_equal(S_t, S_j)
    got = td.candidates_and_relevance(ds_t, S_t, TOP_K[name])
    want = jd.candidates_and_relevance(ds_j, S_j, TOP_K[name])
    assert sorted(got) == sorted(want)
    for u in want:
        np.testing.assert_array_equal(got[u][0], want[u][0])
        np.testing.assert_array_equal(got[u][1], want[u][1])


@pytest.mark.parametrize("seed", [1, 7])
def test_synth_interactions_other_seeds_match_repro(seed):
    cfg = dict(n_users=50, n_items=60, n_clusters=5, items_per_user=(4, 12))
    got = td.synth_interactions("small", seed=seed, **cfg)
    want = jd.synth_interactions("small", seed=seed, **cfg)
    _assert_same_dataset(got, want)
    np.testing.assert_array_equal(td.item_similarity(got, shrink=2.0),
                                  jd.item_similarity(want, shrink=2.0))
