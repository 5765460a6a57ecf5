"""K4, the windowed per-step kernel, on the CPU: its plain step against
``repro``'s Pallas step, and the whole-slate loop around it.

* One step of ``tiled_step_windowed_plain`` (the operands the kernel
  gets: keys, flags, the step-parity ring ids, tile argmax columns and
  window factor) is held against ``repro``'s ``tiled_update_windowed``
  in interpret mode, fed the same state with the rotations from
  ``repro``'s ``eviction_coeffs``: ring not full, ring full, an eps-stop
  mid-slate and the step after it, masked columns, and a winner in the
  ragged last tile.  C and d2 within rtol 3e-4 / atol 1e-5; what the
  step publishes for the next one (ring ids, the winner's column, the
  window factor, the next key) must equal what it describes exactly.
* ``dpp_greedy_tiled`` dispatches no tensor op between its step calls
  once its setup is done (``TorchDispatchMode``), exact and windowed.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import make_greedy_inputs
from repro.kernels.dpp_greedy.tiled import (
    eviction_coeffs as jax_eviction_coeffs,
    tiled_update_windowed as jax_tiled_update_windowed,
)
from repro_torch.kernels.dpp_greedy import tiled as tm

RTOL, ATOL = 3e-4, 1e-5
NEG_INF = float("-inf")


def _inputs(seed, B, D, M, boost=()):
    V = np.array(make_greedy_inputs(seed, B, D, M))
    V[:, :, list(boost)] *= 4.0  # picked first: the winners of steps 0..
    rng = np.random.default_rng(seed + 3)
    mask = rng.uniform(size=(B, M)) > 0.25
    mask[:, list(boost)] = True
    return torch.from_numpy(V), torch.from_numpy(mask)


def _capture(monkeypatch, V, mask, k, w, eps, tile_m, target):
    """Run the whole-slate loop on the plain steps; return the state
    before and after step ``target`` and the slate."""
    real = tm.tiled_step_windowed
    got = {}
    names = ("C", "d2", "keys", "flags", "win", "cand", "wcol")

    def spy(V, C, d2, keys, flags, sel, dh, win, cand, wcol, t, eps_,
            tile_m_):
        state = (C, d2, keys, flags, win, cand, wcol)
        if t == target:
            got["before"] = {n: x.clone() for n, x in zip(names, state)}
        real(V, C, d2, keys, flags, sel, dh, win, cand, wcol, t, eps_,
             tile_m_)
        if t == target:
            got["after"] = {n: x.clone() for n, x in zip(names, state)}

    monkeypatch.setattr(tm, "tiled_step_windowed", spy)
    got["slate"] = tm.dpp_greedy_tiled(V, mask, k, window=w, eps=eps,
                                       tile_m=tile_m)
    return got


def _pad(x, Mp, value):
    pad = [(0, 0)] * (x.ndim - 1) + [(0, Mp - x.shape[-1])]
    return np.pad(x, pad, constant_values=value)


CASES = {
    # name: (D, M, w, k, eps, tile_m, t, boosted columns)
    "ring_not_full": (16, 256, 4, 12, 1e-6, 64, 2, ()),
    "ring_full": (16, 256, 3, 12, 1e-6, 64, 7, ()),
    # rank 3 < w: every gain falls under eps at step 3, the ring not full
    "eps_stop": (3, 128, 4, 10, 0.05, 64, 3, ()),
    "after_eps_stop": (3, 128, 4, 10, 0.05, 64, 4, ()),
    # M = 200 in tiles of 64: the winner of step 4 lies in the last,
    # 8-column tile, with the ring full
    "ragged_last_tile": (16, 200, 3, 8, 1e-6, 64, 4, (193, 195, 196, 198,
                                                        199)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_k4_plain_step_matches_pallas_step(monkeypatch, case):
    D, M, w, k, eps, tile_m, t, boost = CASES[case]
    V, mask = _inputs(list(CASES).index(case), 2, D, M, boost)
    got = _capture(monkeypatch, V, mask, k, w, eps, tile_m, t)
    bef, aft = got["before"], got["after"]
    B = V.shape[0]
    p = t % 2
    eps2 = np.float32(eps) ** 2
    dj2, j = tm.unpack_key(bef["keys"][t])
    stopped = (bef["flags"][t] != 0) | (dj2 <= eps2)
    full = (t >= w) & ~stopped
    ring = bef["win"][p].long()
    ar = torch.arange(B)
    cj_pre = bef["C"][ar, :, j]
    Cw = bef["C"].gather(2, ring.clamp_min(0)[:, None, :].expand(B, w, w))
    Cw = torch.where((ring >= 0)[:, None, :], Cw, 0.0)
    cos, sin, cj_post, d2j = jax_eviction_coeffs(
        jnp.asarray(Cw.numpy()), jnp.asarray(cj_pre.numpy()),
        jnp.asarray(dj2.numpy()), jnp.asarray(full.numpy()), w)
    djp = jnp.sqrt(jnp.maximum(d2j, eps2))
    pos = min(t, w - 1)
    Mp = -(-M // tile_m) * tile_m
    for b in range(B):
        jb = int(j[b])
        Cb, d2b = jax_tiled_update_windowed(
            jnp.asarray(_pad(V[b].numpy(), Mp, 0.0)),
            jnp.asarray(_pad(bef["C"][b].numpy(), Mp, 0.0)),
            jnp.asarray(_pad(bef["d2"][b].numpy(), Mp, NEG_INF)),
            jnp.asarray(V[b, :, jb].numpy()), cj_post[b], djp[b],
            jnp.asarray(bool(stopped[b])), jnp.asarray(bool(full[b])),
            cos[b], sin[b], jnp.int32(jb), jnp.int32(0), jnp.int32(pos),
            w=w, tile_m=tile_m, interpret=True)
        np.testing.assert_allclose(aft["C"][b].numpy(),
                                   np.asarray(Cb)[:, :M], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(aft["d2"][b].numpy(),
                                   np.asarray(d2b)[:M], rtol=RTOL, atol=ATOL)
    # masked columns stay at -inf; the winner goes to -inf
    assert bool(torch.isneginf(aft["d2"][~mask]).all())
    live = ~stopped
    assert bool(torch.isneginf(aft["d2"][ar[live], j[live]]).all())
    # what the step publishes for step t + 1, parity 1 - p
    assert torch.equal(aft["flags"][t + 1], stopped.to(torch.int32))
    nv, nj = tm.unpack_key(aft["keys"][t + 1])
    mx, am = aft["d2"].max(dim=1)
    assert torch.equal(nv, mx) and torch.equal(nj, am)
    ids = aft["win"][1 - p].long()
    for b in range(B):
        if not live[b]:
            assert torch.equal(ids[b], ring[b])
            continue
        want = [int(x) for x in ring[b] if x >= 0][-(w - 1):] \
            if full[b] else [int(x) for x in ring[b] if x >= 0]
        want = want + [int(j[b])]
        assert ids[b].tolist() == want + [-1] * (w - len(want))
        nb = int(nj[b])
        assert torch.equal(aft["cand"][1 - p, b, nb // tile_m],
                           aft["C"][b, :, nb])
        for s, m in enumerate(want):
            assert torch.equal(aft["wcol"][1 - p, b, :, s], aft["C"][b, :, m])
    if case == "eps_stop":
        assert bool(stopped.all()) and t > 0
    if case == "after_eps_stop":
        assert bool((bef["flags"][t] != 0).all())
        assert torch.equal(aft["C"], bef["C"])
    if case == "ring_full":
        assert bool(full.all())
    if case == "ragged_last_tile":
        assert bool(full.all()) and bool((j >= 192).all())
        assert bool((got["slate"][0][:, :5] >= 192).all())


class _OpLog(TorchDispatchMode):
    """Every aten op dispatched, tagged with whether a step call was
    running and how many step calls had begun."""

    def __init__(self):
        super().__init__()
        self.ops, self.inside, self.begun = [], False, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append((str(func), self.inside, self.begun))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("window", [None, 3])
def test_whole_slate_loop_runs_no_op_between_steps(monkeypatch, window):
    V, mask = _inputs(9, 2, 8, 160)
    k, tile_m = 12, 64
    name = "tiled_step_exact" if window is None else "tiled_step_windowed"
    real = getattr(tm, name)
    log = _OpLog()

    def spy(*args):
        log.inside, log.begun = True, log.begun + 1
        try:
            return real(*args)
        finally:
            log.inside = False

    monkeypatch.setattr(tm, name, spy)
    with log:
        got = tm.dpp_greedy_tiled(V, mask, k, window=window, eps=1e-6,
                                  tile_m=tile_m)
    assert log.begun == k
    between = [op for op, inside, begun in log.ops if begun and not inside]
    assert between == []
    assert any(inside for _, inside, _ in log.ops)  # the plain steps ran
    want = tm.dpp_greedy_tiled(V, mask, k, window=window, eps=1e-6,
                               tile_m=tile_m)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
