"""Parity of the port's K7 (``scored_topk``) and K8 (``fm_interaction``)
with ``repro``'s Pallas kernels in interpret mode, on the shapes and
dtypes of ``tests/test_kernel_fm_topk.py``.

On the CPU each wrapper runs its kernel's plain PyTorch version; the
CUDA kernels are held against those on a card (``test_torch_gpu.py``,
``chip_smoke.py``).  K8's hand-written backward has no Pallas twin: its
plain version is held against a float64 gradcheck and ``jax.vjp`` of
``repro``'s ``fm_interaction_ref``.

Tolerances, with their reasons:
* K8: rtol 1e-5 / atol 1e-3.  Both sides sum F * D unit-normal products
  in float32, in another order, and ``(sum v)^2 - sum v^2`` cancels terms
  of size ~F * D, so the error is absolute (measured ~6e-5 at 26 x 32).
* K7 values: rtol 1e-5 / atol 1e-5 (float32 dot products of D
  unit-normal terms in another order).  Indices: as sets on Gaussian
  data (a float32 near-tie may swap neighbours); index for index on
  small-integer data, whose float32 dot products are exact in any order
  and tie often, so the (value descending, lowest index first) order of
  ``jax.lax.top_k`` is tested exactly.
"""
import jax
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.fm_interaction import fm_interaction as jax_fm
from repro.kernels.fm_interaction import fm_interaction_ref as jax_fm_ref
from repro.kernels.scored_topk import scored_topk as jax_topk
from repro.kernels.scored_topk.scored_topk import (
    scored_topk_kernel as jax_topk_blocks,
)
from repro_torch.kernels import cuda
from repro_torch.kernels.fm_interaction import (
    fm_interaction,
    fm_interaction_bwd_kernel,
    fm_interaction_bwd_ref,
    fm_interaction_kernel,
    fm_interaction_ref,
)
from repro_torch.kernels.scored_topk import (
    scored_topk,
    scored_topk_blocks,
    scored_topk_ref,
)
from repro_torch.kernels.scored_topk.scored_topk import block_rows

FM_RTOL, FM_ATOL = 1e-5, 1e-3
TK_RTOL, TK_ATOL = 1e-5, 1e-5
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _same(x_np, jdt, tdt):
    """The same values as a jax array and a torch tensor of the dtype."""
    j = jnp.asarray(x_np, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


@pytest.mark.parametrize("B,F,D", [(8, 4, 8), (64, 39, 16), (130, 26, 32)])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_fm_interaction_matches_pallas(B, F, D, dtypes):
    rng = np.random.default_rng(B + F + D)
    j, t = _same(rng.normal(size=(B, F, D)), *dtypes)
    want = np.asarray(jax_fm(j, block_b=32, interpret=True))
    got = fm_interaction(t, block_b=32)
    assert got.dtype == torch.float32 and got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, rtol=FM_RTOL, atol=FM_ATOL)
    np.testing.assert_allclose(fm_interaction_ref(t).numpy(), want,
                               rtol=FM_RTOL, atol=FM_ATOL)


def test_fm_interaction_identity():
    """0.5((sum v)^2 - sum v^2) == sum_{i<j} <v_i, v_j> (the FM identity)."""
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(5, 6, 4))
    slow = np.array([sum(emb[b, i] @ emb[b, j] for i in range(6)
                         for j in range(i + 1, 6)) for b in range(5)])
    got = fm_interaction(torch.from_numpy(emb.astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), slow, rtol=1e-4, atol=1e-4)


def test_fm_interaction_refuses_grad_and_force_ref_differentiates():
    """The wrapper no longer refuses a tensor that requires grad: K8 has a
    backward.  The wrapper, the kernel entry and ``force_ref`` give the
    same gradient (on the CPU, K8's plain backward against autograd of
    the plain forward)."""
    emb = torch.randn(4, 3, 2, requires_grad=True)
    g = torch.randn(4)
    grads = []
    for fn in (fm_interaction, fm_interaction_kernel,
               lambda x: fm_interaction(x, force_ref=True)):
        x = emb.detach().clone().requires_grad_(True)
        fn(x).backward(g)
        assert x.grad is not None and x.grad.shape == emb.shape
        grads.append(x.grad)
    torch.testing.assert_close(grads[0], grads[2], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(grads[1], grads[2], rtol=1e-6, atol=1e-6)
    with torch.inference_mode():
        x = emb.detach().clone()
        torch.testing.assert_close(fm_interaction(x), fm_interaction_ref(x))


@pytest.mark.parametrize("B,F,D", [(5, 4, 3), (3, 39, 10), (1, 1, 1)])
def test_fm_interaction_bwd_ref_passes_gradcheck(B, F, D):
    """In float64: autograd of the plain forward against finite
    differences, and the plain backward (also through ``FMInteraction``
    on the CPU) against that autograd."""
    rng = np.random.default_rng(B + F + D)
    emb = torch.from_numpy(rng.normal(size=(B, F, D))).requires_grad_(True)
    assert torch.autograd.gradcheck(fm_interaction_ref, (emb,))
    assert torch.autograd.gradcheck(fm_interaction, (emb,))
    g = torch.from_numpy(rng.normal(size=(B,)))
    (want,) = torch.autograd.grad(fm_interaction_ref(emb), emb, g)
    got = fm_interaction_bwd_ref(emb.detach(), g)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("B,F,D", [(8, 4, 8), (64, 39, 10), (130, 26, 32)])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_fm_interaction_bwd_matches_jax_grad(B, F, D, dtypes):
    """K8's backward (plain on the CPU) against ``jax.vjp`` of ``repro``'s
    ``fm_interaction_ref`` on the same input and output gradient: float32
    within rtol 1e-5 / atol 1e-5 (a sum of F unit-normal terms in another
    order, times g); bfloat16 within one bfloat16 ulp (both round a
    float32 gradient once)."""
    rng = np.random.default_rng(B * F + D)
    j, t = _same(rng.normal(size=(B, F, D)), *dtypes)
    g = rng.normal(size=(B,)).astype(np.float32)
    _, vjp = jax.vjp(jax_fm_ref, j)
    (want,) = vjp(jnp.asarray(g))
    got = fm_interaction_bwd_kernel(t, torch.from_numpy(g))
    assert got.dtype == t.dtype and got.shape == t.shape
    x = t.clone().requires_grad_(True)
    fm_interaction(x).backward(torch.from_numpy(g))
    assert torch.equal(x.grad, got)
    rtol, atol = (1e-5, 1e-5) if t.dtype == torch.float32 else (2 ** -7, 1e-5)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=atol)


def test_fm_interaction_cpu_counts_no_launch():
    cuda.reset_launch_counts()
    fm_interaction(torch.ones(3, 2, 2))
    assert cuda.launch_counts() == {}


@pytest.mark.parametrize("M,D,c,bm", [(1024, 16, 8, 256),
                                      (4096, 64, 128, 1024)])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_scored_topk_matches_pallas(M, D, c, bm, dtypes):
    rng = np.random.default_rng(M + D + c)
    je, te = _same(rng.normal(size=(M, D)), *dtypes)
    jq, tq = _same(rng.normal(size=(D,)), *dtypes)
    vals, idx = jax_topk(je, jq, c=c, block_m=bm, interpret=True)
    got_v, got_i = scored_topk(te, tq, c=c, block_m=bm)
    assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32
    np.testing.assert_allclose(got_v.numpy(), np.asarray(vals),
                               rtol=TK_RTOL, atol=TK_ATOL)
    assert set(got_i.tolist()) == set(np.asarray(idx).tolist())


@pytest.mark.parametrize("M,c,bm", [(1000, 8, 256), (130, 64, 128),
                                    (4097, 128, 1024), (100, 5, 8192)])
def test_scored_topk_ragged_m(M, c, bm):
    """M not a multiple of the block rows: rows past M never survive."""
    rng = np.random.default_rng(M + c)
    e = rng.normal(size=(M, 16)).astype(np.float32)
    q = rng.normal(size=(16,)).astype(np.float32)
    vals, idx = jax_topk(jnp.asarray(e), jnp.asarray(q), c=c, block_m=bm,
                         interpret=True)
    got_v, got_i = scored_topk(torch.from_numpy(e), torch.from_numpy(q),
                               c=c, block_m=bm)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(vals),
                               rtol=TK_RTOL, atol=TK_ATOL)
    assert set(got_i.tolist()) == set(np.asarray(idx).tolist())
    assert (got_i < M).all()


@pytest.mark.parametrize("M,D,c,bm", [
    (1000, 16, 8, 256), (4097, 16, 128, 1024), (130, 64, 64, 128),
    (5000, 8, 300, 1024), (3000, 4, 1000, 8192)])
def test_scored_topk_exact_ties_index_for_index(M, D, c, bm):
    """Small-integer data: exact dot products with many ties.  The global
    result and the block survivors equal ``repro``'s index for index."""
    rng = np.random.default_rng(M * 7 + c)
    e = rng.integers(-2, 3, size=(M, D)).astype(np.float32)
    q = rng.integers(-2, 3, size=(D,)).astype(np.float32)
    je, jq = jnp.asarray(e), jnp.asarray(q)
    te, tq = torch.from_numpy(e), torch.from_numpy(q)
    vals, idx = jax_topk(je, jq, c=c, block_m=bm, interpret=True)
    got_v, got_i = scored_topk(te, tq, c=c, block_m=bm)
    assert len(np.unique(np.asarray(vals))) < c  # the data does tie
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(vals))
    bv, bi = jax_topk_blocks(je, jq, c=c, block_m=bm, interpret=True)
    pv, pi = scored_topk_blocks(te, tq, c, bm)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(bi))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(bv))
    rv, ri = scored_topk_ref(te, tq, c)
    np.testing.assert_array_equal(ri.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(rv.numpy(), np.asarray(vals))


def test_scored_topk_force_ref_and_c_above_m():
    rng = np.random.default_rng(0)
    e = torch.from_numpy(rng.normal(size=(100, 8)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))
    with pytest.raises(ValueError, match="exceeds the candidate count"):
        scored_topk(e, q, c=101)
    with pytest.raises(ValueError, match="exceeds the candidate count"):
        jax_topk(jnp.asarray(e.numpy()), jnp.asarray(q.numpy()), c=101)
    for a, b in zip(scored_topk(e, q, c=5, force_ref=True),
                    scored_topk(e, q, c=5)):
        torch.testing.assert_close(a, b)


@pytest.mark.parametrize("M,c,block_m,want", [
    (100, 5, 8192, 128), (1000, 8, 256, 256), (130, 64, 128, 128),
    (4097, 128, 1024, 1024), (10**6, 1000, 8192, 8192),
    (3000, 1000, 8192, 3072), (50, 200, 64, 256)])
def test_block_rows_as_repro_sizes_them(M, c, block_m, want):
    assert block_rows(M, c, block_m) == want


def test_scored_topk_wrapper_refuses_odd_devices_and_shapes():
    e = torch.zeros(10, 4)
    with pytest.raises(ValueError, match="query"):
        scored_topk_blocks(e, torch.zeros(3), 2)
    with pytest.raises(ValueError, match="must be >= 1"):
        scored_topk_blocks(e, torch.zeros(4), 0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        scored_topk_blocks(e.to("meta"), torch.zeros(4, device="meta"), 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fm_interaction_kernel(torch.zeros(2, 3, 4, device="meta"))
