"""The resident kernels' cluster layout (``tiling.resident_cluster``,
``cluster_smem_bytes``) and their CPU wrappers.

K1/K2 run each user on a thread-block cluster of ``s`` CTAs; the policy
picks ``s`` and whether ``V`` and the greedy state (K1's Cholesky rows,
K2's ring) sit in the cluster's shared memory.  These tests hold the policy to its rules with a card-like
capacity (132 SMs, 228 KB of shared memory each), the shared-memory
count to the carve-up ``csrc/dpp_greedy.cu`` documents, and the
resident/tiled boundary to ``resident_smem_bytes``.  On the CPU the
wrappers run the plain versions whatever the layout, and match
``repro``'s jnp core (its Pallas resident kernels do not run on this
tree's jax).  The kernels themselves run only on a card:
``test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import make_greedy_inputs
from repro.kernels.dpp_greedy import dpp_greedy as jax_dpp_greedy
from repro_torch import obs
from repro_torch.kernels.dpp_greedy import (
    SMEM_BUDGET_BYTES,
    ClusterPlan,
    TilePolicy,
    cluster_smem_bytes,
    dpp_greedy,
    dpp_greedy_resident,
    dpp_greedy_resident_windowed,
    resident_cluster,
    resident_smem_bytes,
)
from repro_torch.kernels.dpp_greedy.dpp_greedy import cluster_plan, init_gains
from repro_torch.kernels.dpp_greedy.tiling import cluster_tile

RTOL, ATOL = 3e-4, 1e-5
SM_BYTES, SMS = 233472, 132  # an H100 SM's shared memory; its SM count


def card(s, smem, v_resident, state_resident):
    """Clusters of ``s`` CTAs a card like an H100 holds at once: CTAs an
    SM by shared memory (1 KB reserved a CTA), at most 8."""
    per_sm = min(8, SM_BYTES // (smem + 1024))
    return per_sm * SMS // s


@pytest.mark.parametrize("D,M,R,windowed,lanes,on_card,on_cpu", [
    # phase 1: 202,696 B a CTA; one user: the Cholesky rows fit beside V
    # at 4 CTAs (152,904 B), and 33 such clusters run at once
    (100, 1000, 50, False, 64, (2, True, False), (2, True, False)),
    (100, 1000, 50, False, 33, (4, True, True), (2, True, False)),
    (100, 1000, 50, False, 1, (4, True, True), (2, True, False)),
    (100, 1000, 10, True, 64, (2, True, True), (2, True, True)),  # phase 2
    (100, 1000, 10, True, 1, (2, True, True), (2, True, True)),
    (10, 200, 10, False, 512, (1, True, True), (1, True, True)),  # phase 10
    (10, 1000, 50, False, 1, (2, True, True), (1, True, False)),  # phase 11
    (100, 20000, 50, False, 2, (8, False, False), (8, False, False)),
    (100, 20000, 10, True, 2, (8, False, True), (8, False, True)),
    (100, 57000, 10, True, 2, (8, False, False), (8, False, False)),
    (16, 20000, 8, False, 2, (8, True, False), (8, True, False)),
])
def test_policy_picks_the_fewest_ctas_that_hold_v(D, M, R, windowed, lanes,
                                                  on_card, on_cpu):
    plan = resident_cluster(D, M, R, windowed, lanes, card)
    assert plan == ClusterPlan(*on_card)
    smem = cluster_smem_bytes(D, M, R, windowed, *plan)
    assert smem <= SMEM_BUDGET_BYTES
    if plan.v_resident:
        # one CTA fewer a user would not hold V (and K2's ring)
        for s in (1, 2, 4, 8):
            if s < plan.s and (windowed or not plan.state_resident):
                assert cluster_smem_bytes(D, M, R, windowed, s, True,
                                          windowed) > SMEM_BUDGET_BYTES
    if plan.state_resident and not windowed:
        # the rows widened the cluster only while every user's cluster
        # still runs at once
        assert lanes <= card(plan.s, smem, True, True)
    # without a card (the CPU) every layout that fits is placeable, but
    # how many clusters run at once is not known: no widening for the rows
    assert resident_cluster(D, M, R, windowed, lanes) == ClusterPlan(*on_cpu)


def test_policy_skips_a_cluster_size_the_card_cannot_place():
    def no_pairs(s, smem, v_resident, state_resident):
        return 0 if s == 2 else card(s, smem, v_resident, state_resident)

    # V fits at 4 CTAs, and so do the Cholesky rows beside it
    assert resident_cluster(100, 1000, 50, False, 64, no_pairs) == \
        ClusterPlan(4, True, True)
    with pytest.raises(ValueError, match="no resident cluster layout"):
        resident_cluster(100, 1000, 50, False, 64, lambda s, m, v, r: 0)


@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("D,M,R,windowed", [
    (100, 1000, 50, False), (100, 20000, 50, False), (32, 777, 20, False),
    (100, 1000, 10, True), (64, 512, 40, True), (100, 20000, 10, True),
])
def test_forced_cluster_size_decides_only_residency(D, M, R, windowed, s):
    plan = resident_cluster(D, M, R, windowed, 1, card, s=s)
    assert plan.s == s

    def fits(vres, sres):
        return cluster_smem_bytes(D, M, R, windowed, s, vres, sres) \
            <= SMEM_BUDGET_BYTES

    assert plan.v_resident == fits(True, windowed)
    assert plan.state_resident == fits(plan.v_resident, True)
    assert fits(plan.v_resident, plan.state_resident)


def _carve(D, M, R, windowed, s, vres, sres):
    """The CTA's buffers in csrc/dpp_greedy.cu's order, (name, floats)."""
    tile = -(-(-(-M // s)) // 4) * 4
    out = [("header", 24), ("d2", tile)]
    if sres:
        out.append(("state", R * tile))  # K2's ring, K1's Cholesky rows
    if vres:
        out.append(("V", D * tile))
    out.append(("vj", D))
    if not windowed:
        return out + [("cj", R)]
    out += [("cj", R), ("cjp", R), ("Cw", R * R), ("uw", R), ("cs", R),
            ("sn", R), ("win", R)]
    if s > 1:
        out += [("pcand", 2 * R), ("pwcol", 2 * R * R)]
    return out


@pytest.mark.parametrize("s", [1, 2, 8])
@pytest.mark.parametrize("D,M,R,windowed,vres,sres", [
    (100, 1000, 50, False, True, False),
    (100, 1000, 50, False, False, False),
    (100, 1000, 50, False, True, True),
    (32, 777, 20, False, True, True),
    (100, 1000, 10, True, True, True),
    (100, 20000, 10, True, False, True),
    (100, 57000, 10, True, False, False),
    (64, 512, 40, True, True, True),
])
def test_cluster_smem_bytes_is_the_kernels_carve_up(D, M, R, windowed, vres,
                                                    sres, s):
    carve = _carve(D, M, R, windowed, s, vres, sres)
    assert cluster_smem_bytes(D, M, R, windowed, s, vres, sres) == \
        4 * sum(n for _, n in carve)
    assert cluster_tile(M, s) * s >= M and cluster_tile(M, s) % 4 == 0
    # the slices staged by cp.async start 16-byte aligned
    at = 0
    for name, n in carve:
        if name in ("d2", "state", "V"):
            assert (4 * at) % 16 == 0, name
        at += n


@pytest.mark.parametrize("windowed", [False, True])
def test_resident_boundary_unchanged_and_every_resident_shape_laid_out(
        windowed):
    for D in (3, 10, 100, 400):
        for M in (32, 777, 1000, 20000, 50000, 57000, 60000):
            for R in ((4, 10, 40, 200) if windowed else (10, 50, 200)):
                fits = resident_smem_bytes(D, M, R, windowed) \
                    <= SMEM_BUDGET_BYTES
                try:
                    mode = TilePolicy().decide(D, M, R, windowed)[0]
                except ValueError:
                    continue  # D and R too large even tiled
                assert (mode == "resident") == fits, (D, M, R)
                if fits:
                    plan = resident_cluster(D, M, R, windowed, 64, card)
                    assert cluster_smem_bytes(D, M, R, windowed, *plan) \
                        <= SMEM_BUDGET_BYTES


def _inputs(seed, B=2, D=16, M=256):
    V = np.array(make_greedy_inputs(seed, B, D, M))
    mask = np.random.default_rng(seed + 7).uniform(size=(B, M)) > 0.25
    return V, mask


@pytest.mark.parametrize("plan", [None, ClusterPlan(1, True, False),
                                  ClusterPlan(4, True, True),
                                  ClusterPlan(8, False, True)])
@pytest.mark.parametrize("window", [None, 4])
def test_cpu_wrappers_run_plain_whatever_the_layout(window, plan):
    V, mask = _inputs(20)
    k = 12 if window is None else 20
    want = jax_dpp_greedy(jnp.asarray(V), k, jnp.asarray(mask), eps=1e-6,
                          force_jnp=True, window=window)
    tV = torch.from_numpy(V)
    d2 = init_gains(tV, torch.from_numpy(mask))
    if window is None:
        got = dpp_greedy_resident(tV, d2, k, 1e-6, plan=plan)
    else:
        got = dpp_greedy_resident_windowed(tV, d2, k, window, 1e-6,
                                           plan=plan)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window", [None, 4])
def test_dispatch_records_the_cluster_layout(window):
    V, mask = _inputs(21, D=32, M=512)
    k = 12 if window is None else 20
    R = k if window is None else window
    with obs.session(obs.ObsConfig(enabled=True)):
        got = dpp_greedy(torch.from_numpy(V), k, torch.from_numpy(mask),
                         eps=1e-6, window=window)
        reg = obs.registry()
        assert reg.counter("dpp_kernel_dispatch_total").value(
            mode="resident", windowed=str(window is not None)) == 1
        plan = resident_cluster(32, 512, R, window is not None, 2)
        assert reg.gauge("dpp_v_resident").value() == int(plan.v_resident)
        assert reg.gauge("dpp_smem_bytes_est").value() == cluster_smem_bytes(
            32, 512, R, window is not None, *plan)
    want = jax_dpp_greedy(jnp.asarray(V), k, jnp.asarray(mask), eps=1e-6,
                          force_jnp=True, window=window)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("cluster", [0, 3, 32])
def test_forced_cluster_must_be_a_cluster_size(cluster):
    with pytest.raises(ValueError, match="cluster must be one of"):
        cluster_plan(16, 256, 8, False, 2, torch.device("cpu"), cluster)
