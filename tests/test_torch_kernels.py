"""Parity of the port's greedy kernels (``repro_torch.kernels.dpp_greedy``)
with ``repro``'s Pallas kernels.

On the CPU every wrapper runs its kernel's plain PyTorch version:

* K1/K2 (resident) are held against ``repro``'s
  ``dpp_greedy(..., force_jnp=True)``: the Pallas resident kernels do not
  run on this tree's jax (no ``pl.store``/``pl.load``);
* K3/K4 (tiled) and ``eviction_coeffs`` are held against the Pallas
  tiled kernels in interpret mode (``tile_m=128``), which still run.

Slates index for index, ``d_hist`` within rtol 3e-4 / atol 1e-5.  The
CUDA kernels themselves run only on a card: see ``test_torch_gpu.py`` and
``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import make_greedy_inputs
from repro.kernels.dpp_greedy import dpp_greedy as jax_dpp_greedy
from repro.kernels.dpp_greedy.tiled import (
    dpp_greedy_tiled as jax_tiled,
    eviction_coeffs as jax_eviction_coeffs,
)
from repro_torch import obs
from repro_torch.kernels.dpp_greedy import (
    TilePolicy,
    dpp_greedy,
    dpp_greedy_kernel,
    dpp_greedy_resident,
    dpp_greedy_tiled,
    eviction_coeffs,
    resident_smem_bytes,
)
from repro_torch.kernels.dpp_greedy.tiled import pack_key, unpack_key

RTOL, ATOL = 3e-4, 1e-5


def _inputs(seed, B=2, D=16, M=256, masked=True):
    V = np.array(make_greedy_inputs(seed, B, D, M))
    rng = np.random.default_rng(seed + 7)
    mask = rng.uniform(size=(B, M)) > 0.25 if masked else np.ones((B, M), bool)
    return V, mask


def _assert_slates(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=RTOL, atol=ATOL)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("window", [None, 1, 4])
def test_resident_plain_matches_jax(window, masked):
    V, mask = _inputs(0, masked=masked)
    k = 16 if window is None else 24
    want = jax_dpp_greedy(jnp.asarray(V), k, jnp.asarray(mask), eps=1e-6,
                          force_jnp=True, window=window)
    got = dpp_greedy_kernel(torch.from_numpy(V), torch.from_numpy(mask), k,
                            window=window, eps=1e-6)
    _assert_slates(got, want)


@pytest.mark.parametrize("tile_m", [128, 256])
@pytest.mark.parametrize("window", [None, 4])
def test_tiled_plain_matches_pallas_interpret(window, tile_m):
    V, mask = _inputs(1)
    k = 10 if window is None else 16
    want = jax_tiled(jnp.asarray(V), jnp.asarray(mask), k, window=window,
                     eps=1e-6, tile_m=tile_m, interpret=True)
    got = dpp_greedy_tiled(torch.from_numpy(V), torch.from_numpy(mask), k,
                           window=window, eps=1e-6, tile_m=tile_m)
    _assert_slates(got, want)


@pytest.mark.parametrize("window", [None, 3])
def test_tiled_ragged_tail_matches_ref(window):
    # M = 200 is no multiple of the 64-wide tile: the last tile is masked
    V, mask = _inputs(2, M=200)
    k = 12
    want = jax_dpp_greedy(jnp.asarray(V), k, jnp.asarray(mask), eps=1e-6,
                          force_jnp=True, window=window)
    got = dpp_greedy_tiled(torch.from_numpy(V), torch.from_numpy(mask), k,
                           window=window, eps=1e-6, tile_m=64)
    _assert_slates(got, want)


@pytest.mark.parametrize("mode", ["resident", "tiled"])
def test_cross_tile_ties_pick_lowest_index(mode):
    # duplicated V columns across tiles (i and i + 128): equal gains in
    # two tiles must resolve to the lower global index, as jnp.argmax does
    V, mask = _inputs(3, M=128, masked=False)
    V = np.concatenate([V, V], axis=2)
    mask = np.ones((2, 256), bool)
    k = 10
    want = jax_tiled(jnp.asarray(V), jnp.asarray(mask), k, eps=1e-6,
                     tile_m=128, interpret=True)
    tV, tm = torch.from_numpy(V), torch.from_numpy(mask)
    if mode == "resident":
        got = dpp_greedy_kernel(tV, tm, k, eps=1e-6)
    else:
        got = dpp_greedy_tiled(tV, tm, k, eps=1e-6, tile_m=128)
    _assert_slates(got, want)
    assert (got[0][:, 0] < 128).all()


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("tile_m", [None, 64])
def test_eps_stop_tail(window, tile_m):
    # D < k: rank runs out, tail holds -1 / 0 (eps far above the float32
    # noise the gains decay to past the rank)
    V, mask = _inputs(4, D=6, M=128)
    k, eps = 12, 0.05
    want = jax_dpp_greedy(jnp.asarray(V), k, jnp.asarray(mask), eps=eps,
                          force_jnp=True, window=window)
    got = dpp_greedy(torch.from_numpy(V), k, torch.from_numpy(mask), eps=eps,
                     window=window, tile_m=tile_m)
    _assert_slates(got, want)
    if window is None:
        assert (got[0][:, 6:] == -1).all() and (got[1][:, 6:] == 0).all()


def test_eviction_coeffs_match_jax():
    rng = np.random.default_rng(5)
    B, w = 4, 5
    Cw = rng.normal(size=(B, w, w)).astype(np.float32)
    cj = rng.normal(size=(B, w)).astype(np.float32)
    dj2 = rng.uniform(0.5, 2.0, size=B).astype(np.float32)
    full = np.array([True, False, True, True])
    want = jax_eviction_coeffs(jnp.asarray(Cw), jnp.asarray(cj),
                               jnp.asarray(dj2), jnp.asarray(full), w)
    got = eviction_coeffs(torch.from_numpy(Cw), torch.from_numpy(cj),
                          torch.from_numpy(dj2), torch.from_numpy(full), w)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=1e-6,
                                   atol=1e-6)
    # identity where the window is not full
    np.testing.assert_array_equal(got[0][1].numpy(), np.ones(w - 1))
    np.testing.assert_array_equal(got[2][1].numpy(), cj[1])


def test_argmax_keys_roundtrip_and_order():
    vals = torch.tensor([float("-inf"), -3.5, -0.0, 0.0, 1e-30, 2.0, 2.0,
                         float("inf")])
    idx = torch.tensor([0, 7, 3, 2, 9, 5, 1, 4])
    keys = pack_key(vals, idx)
    v, i = unpack_key(keys)
    assert torch.equal(i, idx)
    assert torch.equal(v.view(torch.int32), vals.view(torch.int32))
    # unsigned 64-bit order == (value, then lowest index) order
    u = [int(x) & (2**64 - 1) for x in keys.tolist()]
    order = sorted(range(len(u)), key=lambda n: u[n])
    # equal 2.0s: the lower index (1, at position 6) ranks higher
    assert order == [0, 1, 2, 3, 4, 5, 6, 7]


@pytest.mark.parametrize("D,M,R,windowed,mode", [
    (100, 1000, 50, False, "resident"),  # default shortlist, exact
    (100, 1000, 10, True, "resident"),   # default shortlist, w = 10
    (100, 65536, 50, False, "tiled"),    # past the 227 KB block budget
    (100, 65536, 10, True, "tiled"),
])
def test_budget_model_decisions(D, M, R, windowed, mode):
    got, tm = TilePolicy().decide(D, M, R, windowed)
    assert got == mode
    fits = resident_smem_bytes(D, M, R, windowed) <= 232448
    assert fits == (mode == "resident")
    assert (tm is None) == (mode == "resident")
    assert TilePolicy(tile_m=256).decide(D, M, R, windowed) == ("tiled", 256)


@pytest.mark.parametrize("window", [None, 4])
def test_ops_modes_agree_and_are_recorded(window):
    V, mask = _inputs(6)
    tV, tm = torch.from_numpy(V), torch.from_numpy(mask)
    k = 12
    ref = dpp_greedy(tV, k, tm, eps=1e-6, window=window, force_ref=True)
    with obs.session(obs.ObsConfig(enabled=True)):
        res = dpp_greedy(tV, k, tm, eps=1e-6, window=window)
        tiled = dpp_greedy(tV, k, tm, eps=1e-6, window=window, tile_m=96)
        c = obs.registry().counter("dpp_kernel_dispatch_total")
        w = str(window is not None)
        assert c.value(mode="resident", windowed=w) == 1
        assert c.value(mode="tiled", windowed=w) == 1
    for got in (res, tiled):
        assert torch.equal(got[0], ref[0])
        torch.testing.assert_close(got[1], ref[1], rtol=RTOL, atol=ATOL)


def test_wrapper_rejects_other_devices():
    V = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dpp_greedy_resident(V, torch.empty((1, 8), device="meta"), 2, 1e-3)
