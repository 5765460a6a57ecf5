"""Parity of the port's optimizer, LR schedules and int8 error-feedback
compression (``repro_torch.optim``) with ``repro.optim``, on the CPU.

The same numpy trees (dicts of named arrays) go through both.
Tolerances, with their reasons:

* schedules: rtol 1e-6 / atol 1e-7 (one float32 cosine in each);
* ``global_norm`` and clipping: rtol 1e-6 (float32 sums of squares in
  another order);
* ten AdamW steps on float32 parameters: rtol 1e-4 / atol 1e-5 (the
  float32 update's elementwise ops may round apart by an ulp, and
  ``sqrt(v)`` feeds a division);
* on bfloat16 parameters: one bfloat16 ulp (rtol 2**-7, atol 1e-5): a
  float32 update an ulp apart can round to neighbouring bfloat16 values;
  the float32 moments stay within rtol 1e-4 / atol 1e-5;
* ``compress_int8``: the same int8 codes except where ``x / scale`` lies
  within 1e-5 of a half, and there one quantum apart at most (both round
  half to even; two frameworks may compute ``x / scale`` an ulp apart).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import (
    AdamWConfig as JaxAdamWConfig,
    adamw_init as jax_adamw_init,
    adamw_update as jax_adamw_update,
    compress_int8 as jax_compress_int8,
    constant_lr as jax_constant_lr,
    cosine_warmup as jax_cosine_warmup,
)
from repro.optim.adamw import (
    clip_by_global_norm as jax_clip,
    global_norm as jax_global_norm,
)
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    compress_int8,
    constant_lr,
    cosine_warmup,
    decompress_int8,
    ef_compress_grads,
    ef_init,
    global_norm,
)

SHAPES = {"w": (7, 5), "b": (5,), "table": (40, 8), "scale": ()}


def _tree(rng, scale=1.0):
    return {n: (rng.normal(size=s) * scale).astype(np.float32)
            for n, s in SHAPES.items()}


def _torch(tree, dtype=torch.float32):
    return {n: torch.from_numpy(np.array(a)).to(dtype) for n, a in tree.items()}


def _jax(tree, dtype=jnp.float32):
    return {n: jnp.asarray(a, dtype) for n, a in tree.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def test_adamw_config_fields_match_repro():
    assert AdamWConfig() == AdamWConfig(**vars(JaxAdamWConfig()))
    assert [f for f in vars(AdamWConfig())] == list(vars(JaxAdamWConfig()))


@pytest.mark.parametrize("warmup,total,floor", [
    (10, 100, 0.1), (20, 20, 0.1), (0, 50, 0.0), (5, 3, 0.3)])
def test_cosine_warmup_matches_repro(warmup, total, floor):
    steps = np.arange(0, total + 12, dtype=np.int32)
    want = np.asarray(jax_cosine_warmup(jnp.asarray(steps), warmup=warmup,
                                        total=total, floor=floor))
    got = cosine_warmup(torch.from_numpy(steps), warmup=warmup, total=total,
                        floor=floor)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert float(cosine_warmup(torch.tensor(0, dtype=torch.int32),
                               warmup=warmup, total=total)) == 0.0


def test_constant_lr_matches_repro():
    steps = np.arange(6, dtype=np.int32)
    got = constant_lr(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_constant_lr(jnp.asarray(steps))))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_repro(max_norm):
    tree = _tree(np.random.default_rng(1), 0.3)
    want_g, want_n = jax_clip(_jax(tree), max_norm)
    got_g, got_n = clip_by_global_norm(_torch(tree), max_norm)
    np.testing.assert_allclose(float(got_n), float(want_n), rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(_torch(tree))),
                               float(jax_global_norm(_jax(tree))), rtol=1e-6)
    for n in SHAPES:
        np.testing.assert_allclose(_np(got_g[n]), _np(want_g[n]), rtol=1e-6,
                                   atol=1e-7)


def test_clip_keeps_bf16_dtype():
    g = {"a": torch.full((4,), 3.0, dtype=torch.bfloat16)}
    out, norm = clip_by_global_norm(g, 1.0)
    assert out["a"].dtype == torch.bfloat16 and float(norm) == 6.0
    np.testing.assert_allclose(_np(out["a"]), 0.5, rtol=2 ** -8)


@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("dtypes", [(torch.float32, jnp.float32),
                                    (torch.bfloat16, jnp.bfloat16)],
                         ids=["f32", "bf16"])
def test_adamw_ten_steps_match_repro(dtypes, clip):
    tdt, jdt = dtypes
    rng = np.random.default_rng(7)
    init = _tree(rng)
    kw = dict(lr=0.01, weight_decay=0.1, grad_clip_norm=clip)
    cfg, jcfg = AdamWConfig(**kw), JaxAdamWConfig(**kw)
    p, jp = _torch(init, tdt), _jax(init, jdt)
    st, jst = adamw_init(p), jax_adamw_init(jp)
    assert all(m.dtype == torch.float32 for m in st["m"].values())
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    rtol = 1e-4 if tdt == torch.float32 else 2 ** -7
    for step in range(10):
        grads = _tree(rng, 0.5)
        scale = cosine_warmup(st["step"], warmup=3, total=10)
        jscale = jax_cosine_warmup(jst["step"], warmup=3, total=10)
        p, st, met = adamw_update(p, _torch(grads, tdt), st, cfg, scale)
        jp, jst, jmet = jax_adamw_update(jp, _jax(grads, jdt), jst, jcfg,
                                         jscale)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-5)
        assert int(st["step"]) == int(jst["step"]) == step + 1
        for n in SHAPES:
            assert p[n].dtype == tdt
            np.testing.assert_allclose(_np(p[n]), _np(jp[n]), rtol=rtol,
                                       atol=1e-5)
            for key in ("m", "v"):
                np.testing.assert_allclose(_np(st[key][n]), _np(jst[key][n]),
                                           rtol=1e-4, atol=1e-5)
        if step == 0:  # lr scale 0 at the first update: nothing moves
            for n in SHAPES:
                np.testing.assert_array_equal(_np(p[n]),
                                              _np(_torch(init, tdt)[n]))


def test_adamw_first_update_moves_moments_not_params():
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    st = adamw_init(p)
    g = {"w": torch.tensor([0.5, 0.5, -1.0])}
    p2, st2, _ = adamw_update(p, g, st, AdamWConfig(),
                              cosine_warmup(st["step"], warmup=5, total=10))
    np.testing.assert_array_equal(p2["w"].numpy(), [1.0, -2.0, 3.0])
    assert int(st2["step"]) == 1 and bool((st2["m"]["w"] != 0).all())


def test_adamw_matches_reference_math():
    """One AdamW step against a hand-rolled numpy reference (``repro``'s
    ``tests/test_substrate.py`` case)."""
    cfg = AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.01,
                      grad_clip_norm=None)
    w0 = np.asarray([1.0, -2.0, 3.0])
    gn = np.asarray([0.5, 0.5, -1.0])
    p = {"w": torch.tensor(w0, dtype=torch.float32)}
    p2, st2, _ = adamw_update(p, {"w": torch.tensor(gn, dtype=torch.float32)},
                              adamw_init(p), cfg)
    mh, vh = 0.1 * gn / (1 - 0.9), 0.01 * gn * gn / (1 - 0.99)
    ref = w0 - 0.1 * (mh / (np.sqrt(vh) + 1e-8) + 0.01 * w0)
    np.testing.assert_allclose(p2["w"].numpy(), ref, rtol=1e-6)
    assert int(st2["step"]) == 1


def test_adamw_converges_on_a_quadratic():
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0)
    p = {"w": torch.tensor([5.0, -3.0])}
    st = adamw_init(p)
    target = torch.tensor([1.0, 2.0])
    for _ in range(300):
        p, st, _ = adamw_update(p, {"w": 2 * (p["w"] - target)}, st, cfg)
    np.testing.assert_allclose(p["w"].numpy(), target.numpy(), atol=0.05)


def _near_half(x, scale):
    r = np.asarray(x, np.float64) / float(scale)
    return np.abs(np.abs(r - np.round(r)) - 0.5) <= 1e-5


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros", "tiny"])
def test_compress_int8_matches_repro(kind):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4096,)).astype(np.float32)
    if kind == "ties":  # exact halves of the scale: round half to even
        x = (rng.integers(-254, 255, size=4096) / 2.0).astype(np.float32)
        x[0] = 127.0
    elif kind == "zeros":
        x[:] = 0.0
    elif kind == "tiny":
        x *= 1e-14
    q, scale = compress_int8(torch.from_numpy(x))
    jq, jscale = jax_compress_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    assert np.float32(float(scale)) == np.float32(float(jscale))
    qa, ja = q.numpy().astype(np.int32), np.asarray(jq, np.int32)
    differ = qa != ja
    assert np.abs(qa - ja).max(initial=0) <= 1
    assert not (differ & ~_near_half(x, scale)).any()
    if kind == "ties":
        assert (qa == np.round(x)).all()  # scale 1: ties go to even
    np.testing.assert_allclose(decompress_int8(q, scale).numpy(),
                               np.asarray(jq, np.float32) * float(jscale),
                               rtol=1e-6, atol=float(scale) * differ.any())


def test_int8_roundtrip_bound():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1000,))
                         .astype(np.float32))
    q, s = compress_int8(x)
    assert float((decompress_int8(q, s) - x).abs().max()) <= float(s) * 0.5 + 1e-7


def test_error_feedback_telescopes():
    """Sum of EF-compressed grads ~ sum of true grads (bias cancels), as
    ``repro``'s ``tests/test_substrate.py`` checks its own."""
    rng = np.random.default_rng(1)
    grads = [{"w": torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))}
             for _ in range(50)]
    ef = ef_init(grads[0])
    total_c = np.zeros(64, np.float32)
    total_t = np.zeros(64, np.float32)
    for g in grads:
        cg, ef = ef_compress_grads(g, ef)
        total_c += cg["w"].numpy()
        total_t += g["w"].numpy()
    resid = ef.residual["w"].numpy()
    np.testing.assert_allclose(total_c, total_t - resid, rtol=1e-4, atol=1e-4)
    assert np.abs(resid).max() < 0.1


def test_error_feedback_matches_repro():
    from repro.optim import ef_compress_grads as jax_ef, ef_init as jax_ef_init

    rng = np.random.default_rng(2)
    tree = _tree(rng)
    ef, jef = ef_init(_torch(tree)), jax_ef_init(_jax(tree))
    for _ in range(5):
        g = _tree(rng, 0.1)
        cg, ef = ef_compress_grads(_torch(g), ef)
        jcg, jef = jax_ef(_jax(g), jef)
        for n in SHAPES:
            scale = float(np.abs(np.asarray(jcg[n])).max()) / 127 + 1e-12
            np.testing.assert_allclose(cg[n].numpy(), np.asarray(jcg[n]),
                                       rtol=1e-6, atol=1.01 * scale)
            np.testing.assert_allclose(ef.residual[n].numpy(),
                                       np.asarray(jef.residual[n]),
                                       rtol=1e-6, atol=1.01 * scale)
