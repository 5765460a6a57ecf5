"""Parity of the torch port's core (``repro_torch.core``) with ``repro.core``.

The same numpy inputs (``conftest.make_greedy_inputs``, seeded) go
through the JAX function and its torch counterpart on the CPU.  Slates
must match index for index; ``d_hist`` within the incremental oracle's
tolerance (rtol 3e-4, atol 1e-5: the two sum in different orders).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.core as jc
import repro_torch.core as tc
from conftest import make_greedy_inputs

RTOL, ATOL = 3e-4, 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_same(jres, tres):
    np.testing.assert_array_equal(np.asarray(jres.indices),
                                  tres.indices.numpy())
    np.testing.assert_array_equal(np.asarray(jres.n_selected),
                                  tres.n_selected.numpy())
    np.testing.assert_allclose(np.asarray(jres.d_hist), tres.d_hist.numpy(),
                               rtol=RTOL, atol=ATOL)
    assert tres.indices.dtype == torch.int32


@pytest.mark.parametrize("name", [
    "map_relevance", "normalize_columns", "similarity_from_features",
    "build_kernel_dense", "build_kernel_dense_raw", "scaled_features",
    "scaled_features_raw",
])
def test_kernel_matrix(name):
    rng = np.random.default_rng(0)
    F = rng.normal(size=(8, 40)).astype(np.float32)
    Fn = np.asarray(jc.normalize_columns(jnp.asarray(F)))
    r = rng.uniform(size=40).astype(np.float32)
    S = Fn.T @ Fn
    args = {
        "map_relevance": (r, 3.0),
        "normalize_columns": (F,),
        "similarity_from_features": (Fn,),
        "build_kernel_dense": (r, S, 2.0),
        "build_kernel_dense_raw": (r, S),
        "scaled_features": (Fn, r, 3.0),
        "scaled_features_raw": (Fn, r),
    }[name]
    want = getattr(jc, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                               else a for a in args])
    got = getattr(tc, name)(*[_t(a) if isinstance(a, np.ndarray) else a
                              for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _problem(seed, B, D=16, M=96, masked=False):
    V = np.asarray(make_greedy_inputs(seed, B, D, M))
    mask = None
    if masked:
        rng = np.random.default_rng(seed + 100)
        mask = rng.uniform(size=V.shape[:-2] + (M,)) > 0.3
    return V, mask


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rep", ["lowrank", "dense"])
def test_exact_core(rep, masked, batched):
    V, mask = _problem(1, 3 if batched else None, masked=masked)
    k = 12
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    if rep == "lowrank":
        jfn = jc.dpp_greedy_lowrank_batch if batched else jc.dpp_greedy_lowrank
        tfn = tc.dpp_greedy_lowrank_batch if batched else tc.dpp_greedy_lowrank
        X = V
    else:
        jfn = jc.dpp_greedy_dense_batch if batched else jc.dpp_greedy_dense
        tfn = tc.dpp_greedy_dense_batch if batched else tc.dpp_greedy_dense
        X = np.swapaxes(V, -1, -2) @ V
    _assert_same(jfn(jnp.asarray(X), k, 1e-6, jm), tfn(_t(X), k, 1e-6, tm))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("rep", ["lowrank", "dense"])
def test_windowed_core(rep, window, batched):
    V, mask = _problem(2, 2 if batched else None, masked=True)
    k = 16
    if rep == "lowrank":
        jfn = (jc.dpp_greedy_windowed_lowrank_batch if batched
               else jc.dpp_greedy_windowed_lowrank)
        tfn = (tc.dpp_greedy_windowed_lowrank_batch if batched
               else tc.dpp_greedy_windowed_lowrank)
        X = V
    else:
        jfn = (jc.dpp_greedy_windowed_batch if batched
               else jc.dpp_greedy_windowed)
        tfn = (tc.dpp_greedy_windowed_batch if batched
               else tc.dpp_greedy_windowed)
        X = np.swapaxes(V, -1, -2) @ V
    _assert_same(
        jfn(jnp.asarray(X), k, window, 1e-6, jnp.asarray(mask)),
        tfn(_t(X), k, window, 1e-6, _t(mask)),
    )


@pytest.mark.parametrize("window", [None, 3])
def test_eps_stop_tail(window):
    # D < k: the kernel's rank runs out and the tail holds -1 / 0.  Past
    # the rank the gains are float32 rounding noise (~1e-6 of the
    # diagonal), so eps sits well above it: a stop decided by noise would
    # depend on summation order, not on the algorithm.
    V, _ = _problem(3, None, D=5, M=64)
    k, eps = 12, 0.05
    if window is None:
        j = jc.dpp_greedy_lowrank(jnp.asarray(V), k, eps)
        t = tc.dpp_greedy_lowrank(_t(V), k, eps)
    else:
        j = jc.dpp_greedy_windowed_lowrank(jnp.asarray(V), k, window, eps)
        t = tc.dpp_greedy_windowed_lowrank(_t(V), k, window, eps)
    _assert_same(j, t)
    if window is None:
        assert int(t.n_selected) == 5
        assert (t.indices[5:] == -1).all() and (t.d_hist[5:] == 0).all()


def test_dpp_greedy_front_end():
    rng = np.random.default_rng(4)
    F = np.asarray(jc.normalize_columns(
        jnp.asarray(rng.normal(size=(10, 50)).astype(np.float32))))
    r = rng.uniform(size=50).astype(np.float32)
    for kw in ({"feats": F}, {"similarity": F.T @ F}):
        j = jc.dpp_greedy(jnp.asarray(r), 8, alpha=2.0,
                          **{a: jnp.asarray(b) for a, b in kw.items()})
        t = tc.dpp_greedy(_t(r), 8, alpha=2.0,
                          **{a: _t(b) for a, b in kw.items()})
        _assert_same(j, t)
    with pytest.raises(ValueError, match="exactly one"):
        tc.dpp_greedy(_t(r), 8)


def test_argmax_ties_lowest_index():
    # duplicated V columns: after picking one copy the other's gain is 0,
    # and among equal gains the lowest index wins, as in jnp.argmax
    V, _ = _problem(5, None, D=8, M=32)
    V = np.concatenate([V, V], axis=1)  # column i and i + 32 are equal
    _assert_same(jc.dpp_greedy_lowrank(jnp.asarray(V), 8, 1e-6),
                 tc.dpp_greedy_lowrank(_t(V), 8, 1e-6))
    first = int(tc.dpp_greedy_lowrank(_t(V), 1).indices[0])
    assert first < 32


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_greedy_map_matches_jax(backend, window):
    V, mask = _problem(6, 2, masked=True)
    k = 10
    jres = jc.greedy_map(jc.GreedySpec(k=k, window=window, backend="jnp"),
                         V=jnp.asarray(V), mask=jnp.asarray(mask[0]))
    tres = tc.greedy_map(tc.GreedySpec(k=k, window=window, backend=backend),
                         V=_t(V), mask=_t(mask[0]))
    _assert_same(jres, tres)


def test_greedy_map_single_dense():
    V, mask = _problem(7, None, masked=True)
    L = V.T @ V
    spec = dict(k=8, window=3)
    _assert_same(
        jc.greedy_map(jc.GreedySpec(**spec), L=jnp.asarray(L),
                      mask=jnp.asarray(mask)),
        tc.greedy_map(tc.GreedySpec(**spec), L=_t(L), mask=_t(mask)),
    )
    with pytest.raises(ValueError, match="low-rank V"):
        tc.greedy_map(tc.GreedySpec(k=4, backend="kernel"), L=_t(L))
    with pytest.raises(ValueError, match="exactly one"):
        tc.greedy_map(tc.GreedySpec(k=4))


@pytest.mark.parametrize("kw,err", [
    ({"k": 0}, tc.GreedySpecError),
    ({"k": 4, "window": 0}, tc.GreedySpecError),
    ({"k": 4, "backend": "jnp"}, tc.GreedySpecError),
    ({"k": 4, "tile_m": 128}, tc.GreedySpecError),  # torch backend
    ({"k": 4, "backend": "kernel", "tile_m": 100}, tc.GreedySpecError),
    ({"k": 4, "backend": "kernel", "tile_m": "auto"}, NotImplementedError),
    ({"k": 4, "backend": "sharded"}, tc.GreedySpecError),  # no mesh
    # chunked execution: the kernel and sharded backends only
    ({"k": 4, "chunk_size": 2}, tc.GreedySpecError),  # auto, no mesh
    ({"k": 4, "backend": "torch", "chunk_size": 2}, tc.GreedySpecError),
    ({"k": 4, "backend": "sharded", "mesh": object(), "chunk_size": 0},
     tc.GreedySpecError),
    ({"k": 4, "backend": "kernel", "mesh": object()}, tc.GreedySpecError),
])
def test_greedy_spec_validation(kw, err):
    with pytest.raises(err):
        tc.GreedySpec(**kw)
