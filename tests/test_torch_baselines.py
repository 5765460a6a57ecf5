"""Parity of the port's naive determinant greedy and reference
diversifiers (``repro_torch.core.greedy_naive``, ``.baselines``) with
``repro.core``'s, on the CPU.

The same numpy inputs (seeded) go through both.  The float64 naive
greedy must match ``repro``'s index for index and gain for gain (the
same numpy code); the batched-slogdet baseline, run in float64, must
select ``repro``'s oracle slate index for index.  MMR and greedy-avg run
in float32 and must match ``repro``'s index for index over seeds, theta
in {0, 0.3, 0.5, 1} and masks (none, partial, fewer selectable items
than k).  The inputs carry no ties by construction (continuous uniform
relevance, Gaussian features) apart from those the methods make
themselves (theta = 0's first step, where every score is 1), which both
break to the first index.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.core as jc
import repro_torch.core as tc
from repro_torch.core.greedy_naive import greedy_map_naive_vmapped

K = 10


def _kernel(seed, M=40, D=12):
    """A float64 DPP kernel L = Diag(r) F^T F Diag(r) of rank D."""
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((D, M))
    F /= np.linalg.norm(F, axis=0, keepdims=True)
    r = rng.uniform(0.5, 1.5, size=M)
    return (r[:, None] * (F.T @ F)) * r[None, :]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", ["full", "masked", "rank_deficient"])
def test_greedy_map_naive_matches_repro(seed, case):
    L = _kernel(seed, D=6 if case == "rank_deficient" else 12)
    mask = None
    if case == "masked":
        mask = np.random.default_rng(seed + 10).uniform(size=L.shape[0]) > 0.3
    want = jc.greedy_map_naive(L, K, eps=1e-6, mask=mask)
    got = tc.greedy_map_naive(L, K, eps=1e-6, mask=mask)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if case == "rank_deficient":  # the eq.-(20) stop at the rank
        assert (got[0] >= 0).sum() == 6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_naive_vmapped_float64_matches_repro_oracle(seed):
    L = _kernel(seed)
    want, _ = jc.greedy_map_naive(L, K)
    got = greedy_map_naive_vmapped(torch.from_numpy(L), K)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_naive_vmapped_never_stops_early():
    """``repro``'s vectorized baseline takes ``eps`` but fills every slot:
    past the kernel's rank every candidate's determinant is ~0, and the
    first maximal index is taken."""
    L = _kernel(0, D=4)
    got = greedy_map_naive_vmapped(torch.from_numpy(L), 6, eps=1e-3)
    want, _ = jc.greedy_map_naive(L, 6)
    np.testing.assert_array_equal(got[:4], want[:4])
    assert (got >= 0).all() and np.unique(got).size == 6


def _select_inputs(seed, M=50, D=8):
    rng = np.random.default_rng(seed)
    r = rng.uniform(size=M).astype(np.float32)
    F = rng.standard_normal((D, M)).astype(np.float32)
    F /= np.linalg.norm(F, axis=0, keepdims=True)
    return r, (F.T @ F).astype(np.float32), rng


def _mask(kind, rng, M):
    if kind == "none":
        return None
    if kind == "partial":
        return rng.uniform(size=M) > 0.4
    keep = np.zeros(M, bool)  # fewer selectable items than k
    keep[rng.choice(M, size=3, replace=False)] = True
    return keep


@pytest.mark.parametrize("fn", ["mmr_select", "greedy_avg_select"])
@pytest.mark.parametrize("mask_kind", ["none", "partial", "fewer_than_k"])
@pytest.mark.parametrize("theta", [0.0, 0.3, 0.5, 1.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_matches_repro(fn, mask_kind, theta, seed):
    r, S, rng = _select_inputs(seed)
    mask = _mask(mask_kind, rng, r.shape[0])
    want = np.asarray(getattr(jc, fn)(
        jnp.asarray(r), jnp.asarray(S), K, theta,
        None if mask is None else jnp.asarray(mask)))
    got = getattr(tc, fn)(torch.from_numpy(r), torch.from_numpy(S), K, theta,
                          None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.int32 and got.shape == (K,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fn", ["mmr_select", "greedy_avg_select"])
def test_select_past_the_mask_fills_with_index_0(fn):
    """With fewer selectable items than k, every later step's scores are
    all -inf and argmax takes index 0: ``repro``'s slate fills with 0 and
    so does the port's."""
    r, S, _ = _select_inputs(3)
    mask = np.zeros(r.shape[0], bool)
    mask[[7, 21, 30]] = True
    got = getattr(tc, fn)(torch.from_numpy(r), torch.from_numpy(S), K, 0.5,
                          torch.from_numpy(mask)).numpy()
    want = np.asarray(getattr(jc, fn)(jnp.asarray(r), jnp.asarray(S), K, 0.5,
                                      jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)
    assert sorted(got[:3]) == [7, 21, 30]
    assert (got[3:] == 0).all()
