"""The exact fused chunk kernel K5 with ``V`` in shared memory, on the CPU.

K5 keeps each tile's ``V`` slice in shared memory for the whole chunk
where the tile policy says it fits one block and the cooperative grid
still co-resides, as K6 does; otherwise ``V`` streams from device memory
every step.  Held here:

* the policy (``TilePolicy.decide(..., chunked=True)`` with a stand-in
  for the card's capacity): V in shared memory over two tiles of 512 at
  the default shortlist (D = 100, C = 1000, k = 50) for one lane and for
  64, streamed at the large pool and at 100 lanes;
* ``chunk_smem_bytes``' exact layout against the carve-up of
  ``csrc/chunk.cu``;
* the chunk path with the V-resident answer passed through
  (``dpp_greedy_stream_*``, whose wrappers run K5's plain version on
  CPU tensors) against ``repro``'s jnp streaming core: each chunk's
  slate, and the state after it (C, d2, t, stopped), and the dispatch
  telemetry that records the answer.

Slates index for index; ``d_hist``, C and d2 within the incremental
oracle's tolerance (rtol 3e-4, atol 1e-5).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import make_greedy_inputs
import repro.core as jc
from repro_torch import obs
from repro_torch.kernels.dpp_greedy import (
    TilePolicy,
    chunk_smem_bytes,
    chunk_v_resident,
    fused_chunk_exact,
)
from repro_torch.kernels.dpp_greedy.ops import (
    _stream_tile,
    dpp_greedy_stream_chunk,
    dpp_greedy_stream_init,
)
from repro_torch.kernels.dpp_greedy.tiling import SMEM_BUDGET_BYTES, round_up

RTOL, ATOL = 3e-4, 1e-5


def _card_like(smem):
    """A stand-in for ``chunk_capacity``: 132 SMs, each holding at most
    eight 256-thread blocks and 228 KB of shared memory (1 KB reserved
    per block)."""
    return 132 * min(8, 233472 // (smem + 1024))


@pytest.mark.parametrize("M,lanes,tile,vres", [
    # phase 6's one lane and phase 9's 64 slots: V, gains and staging of
    # 512 columns take 207,704 of a block's 232,448 B; one block per SM
    (1000, 1, 512, True),
    (1000, 64, 512, True),
    # the large pool: 121 V-resident tiles per lane cannot co-reside, so
    # V streams through tiles of 1024
    (65536, 4, 1024, False),
    # 100 lanes: 200 V-resident blocks do not fit a card of 132 SMs, one
    # whole-M streaming tile per lane does
    (1000, 100, 1000, False),
])
def test_exact_chunk_policy_keeps_v_resident_where_it_fits(M, lanes, tile,
                                                          vres):
    D, R = 100, 50
    mode, tm, got = TilePolicy().decide(D, M, R, False, chunked=True,
                                        lanes=lanes, capacity=_card_like)
    assert (tm or M) == tile
    assert mode == ("resident" if tile == M else "tiled")
    assert got == vres
    assert chunk_v_resident(D, M, tile, R, False, lanes, _card_like) == vres
    smem = chunk_smem_bytes(D, tile, R, False, vres)
    assert smem <= SMEM_BUDGET_BYTES
    assert lanes * -(-M // tile) <= _card_like(smem)
    if vres:
        # the fewest tiles: one fewer V-resident tile does not fit a block
        fewer = -(-M // tile) - 1
        wider = round_up(-(-M // fewer), 32)
        assert chunk_smem_bytes(D, wider, R, False, True) > SMEM_BUDGET_BYTES


@pytest.mark.parametrize("D,tile,R", [(100, 512, 50), (16, 1024, 12)])
@pytest.mark.parametrize("vres", [True, False])
def test_exact_chunk_smem_is_the_kernels_layout(D, tile, R, vres):
    # chunk.cu's K5 carves: gains (tile), V (D x tile) with vres, the
    # winner's V column (D) and Cholesky column (R), reduction scratch
    # (2 x 32)
    got = chunk_smem_bytes(D, tile, R, False, vres)
    assert got == 4 * (tile + (D * tile if vres else 0) + D + R + 64)
    assert chunk_smem_bytes(D, tile, R, False) == \
        chunk_smem_bytes(D, tile, R, False, False)


def _repro_chunks(V, mask, k, chunk, eps):
    spec = jc.GreedySpec(k=k, backend="jnp", eps=eps)
    st = jc.greedy_init(spec, V=jnp.asarray(V), mask=jnp.asarray(mask))
    out = []
    for _ in range(-(-k // chunk)):
        st, sel, dh = jc.greedy_chunk(spec, st, V=jnp.asarray(V),
                                      chunk_size=chunk)
        out.append((np.asarray(sel), np.asarray(dh), np.asarray(st.C),
                    np.asarray(st.d2), int(st.t), bool(st.stopped)))
    return out


@pytest.mark.parametrize("B", [None, 3])
def test_exact_chunks_with_v_resident_match_repro(B):
    D, M, k, chunk, eps = 100, 1000, 24, 8, 1e-6  # no step past k
    V = np.array(make_greedy_inputs(21, B, D, M))
    rng = np.random.default_rng(22)
    mask = rng.uniform(size=V.shape[:-2] + (M,)) > 0.2
    tV, tmask = torch.from_numpy(V), torch.from_numpy(mask)
    lanes = 1 if B is None else B
    tile, vres = _stream_tile(D, M, k, False, None, lanes,
                              torch.device("cpu"))
    assert (tile, vres) == (512, True)
    with obs.session(obs.ObsConfig(enabled=True)):
        st = dpp_greedy_stream_init(tV, k, tmask)
        reg = obs.registry()
        assert reg.gauge("dpp_v_resident").value() == 1
        assert reg.gauge("dpp_smem_bytes_est").value() == \
            chunk_smem_bytes(D, 512, k, False, True)
    want = [_repro_chunks(V if B is None else V[b],
                          mask if B is None else mask[b], k, chunk, eps)
            for b in range(lanes)]
    for c in range(-(-k // chunk)):
        # the V-resident answer passed through gives the state and slate
        # the streamed one gives
        again = [x.clone() for x in (st.C, st.d2, st.stopped)]
        t = st.t.to(torch.int32).expand(lanes).contiguous()
        ref = fused_chunk_exact(tV.reshape(lanes, D, M), *again[:2], t,
                                again[2], chunk, eps, tile, False)
        st, sel, dh = dpp_greedy_stream_chunk(tV, st, chunk, eps=eps)
        sel2, dh2 = sel.reshape(lanes, -1), dh.reshape(lanes, -1)
        assert torch.equal(sel2, ref[0]) and torch.equal(dh2, ref[1])
        assert torch.equal(st.C, again[0]) and torch.equal(st.d2, again[1])
        assert torch.equal(st.stopped, again[2])
        for b in range(lanes):
            jsel, jdh, jC, jd2, jt, jstop = want[b][c]
            np.testing.assert_array_equal(sel2[b].numpy(), jsel)
            np.testing.assert_allclose(dh2[b].numpy(), jdh, rtol=RTOL,
                                       atol=ATOL)
            # the port keeps C in row layout (R, M), repro columns (M, k)
            np.testing.assert_allclose(st.C[b].numpy(), jC.T, rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(st.d2[b].numpy(), jd2, rtol=RTOL,
                                       atol=ATOL)
            assert int(st.t) == jt
            assert bool(st.stopped[b]) == jstop
