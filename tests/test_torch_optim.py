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


# ---------------------------------------------------------------------------
# AdamW on DTensor parameters: four gloo ranks on a (2, 2) mesh
# ---------------------------------------------------------------------------

# name: (shape, placements by mesh axis ("data", "model"), dtype)
DT_LEAVES = {
    "w": ((8, 6), ("S0", "S1"), "float32"),  # FSDP x TP
    "table": ((40, 8), ("R", "S0"), "float32"),  # rows over "model"
    "bias": ((6,), ("R", "R"), "float32"),  # replicated
    "emb": ((12, 4), ("S0", "S0"), "bfloat16"),  # over the whole grid
}
DT_STEPS = 3

_DT_RANK = r"""
import json, sys
import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard
from repro_torch.distributed import context as dctx
from repro_torch.distributed import init_group, leave_group
from repro_torch.launch.dryrun import CollectiveCounter
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

r, rdv, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
leaves, steps = json.loads(sys.argv[4]), int(sys.argv[5])
init_group("gloo", r, 4, rdv)
mesh = make_host_mesh(2, 2, device="cpu")
pl = {"R": Replicate(), "S0": Shard(0), "S1": Shard(1)}
rng = np.random.default_rng(0)
whole = {n: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
    getattr(torch, dt)) for n, (s, _, dt) in leaves.items()}
grads = [{n: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
    getattr(torch, dt)) for n, (s, _, dt) in leaves.items()}
    for _ in range(steps)]
place = lambda n, t: dctx.as_dtensor(t, mesh, [pl[a] for a in leaves[n][1]])
res = {}
for clip in (None, 1.0):
    cfg = AdamWConfig(grad_clip_norm=clip)
    params = {n: place(n, t.clone()) for n, t in whole.items()}
    opt = adamw_init(params)
    res["placed"] = all(
        tuple(opt[k][n].placements) == tuple(params[n].placements)
        and opt[k][n].to_local().shape == params[n].to_local().shape
        and opt[k][n].dtype == torch.float32 for k in ("m", "v")
        for n in params)
    res["step_replicated"] = tuple(opt["step"].placements) == (
        Replicate(), Replicate())
    norms, counts = [], []
    for g in grads:
        coll = CollectiveCounter()
        with coll:
            _, opt, met = adamw_update(
                params, {n: place(n, t) for n, t in g.items()}, opt, cfg)
        counts.append(dict(coll.counts))
        norms.append(float(dctx.gathered(met["grad_norm"])))
    res[f"norms_{clip}"], res[f"counts_{clip}"] = norms, counts
    res[f"step_{clip}"] = int(dctx.gathered(opt["step"]))
    for n, p in params.items():
        np.save(f"{out}/r{r}_{clip}_{n}.npy",
                dctx.gathered(p).to(torch.float32).numpy())
        for k in ("m", "v"):
            np.save(f"{out}/r{r}_{clip}_{k}_{n}.npy",
                    dctx.gathered(opt[k][n]).numpy())
np.savez(f"{out}/inputs.npz", **{f"p_{n}": t.to(torch.float32).numpy()
                                 for n, t in whole.items()},
         **{f"g{i}_{n}": t.to(torch.float32).numpy()
            for i, g in enumerate(grads) for n, t in g.items()})
with open(f"{out}/r{r}.json", "w") as f:
    json.dump(res, f)
leave_group()
"""


@pytest.fixture(scope="module")
def dtensor_ranks(tmp_path_factory):
    import json

    from repro_torch.distributed import rank_env, spawn_ranks

    tmp = tmp_path_factory.mktemp("adamw_dtensor")
    spawn_ranks(lambda r: ["-c", _DT_RANK, str(r), str(tmp / "rdv"),
                           str(tmp), json.dumps(DT_LEAVES), str(DT_STEPS)],
                4, 120, env=rank_env(4, {"OMP_NUM_THREADS": "1"}))
    return tmp, [json.loads((tmp / f"r{r}.json").read_text())
                 for r in range(4)]


def _plain_steps(tmp, clip):
    """The same steps on plain tensors in this process."""
    z = np.load(tmp / "inputs.npz")
    dt = {n: getattr(torch, d) for n, (_, _, d) in DT_LEAVES.items()}
    params = {n: torch.from_numpy(z[f"p_{n}"]).to(dt[n]) for n in DT_LEAVES}
    opt = adamw_init(params)
    cfg = AdamWConfig(grad_clip_norm=clip)
    norms = []
    for i in range(DT_STEPS):
        _, opt, met = adamw_update(params, {
            n: torch.from_numpy(z[f"g{i}_{n}"]).to(dt[n]) for n in DT_LEAVES},
            opt, cfg)
        norms.append(float(met["grad_norm"]))
    return params, opt, norms


@pytest.mark.parametrize("r", range(4))
def test_adamw_init_places_moments_like_dtensor_parameters(dtensor_ranks, r):
    res = dtensor_ranks[1][r]
    assert res["placed"] and res["step_replicated"]
    assert res["step_None"] == res["step_1.0"] == DT_STEPS


def test_adamw_on_dtensor_blocks_keeps_the_plain_bits(dtensor_ranks):
    """Without clipping each rank's block runs the plain arithmetic: the
    gathered parameters and moments equal the plain tensors' bit for
    bit; the norm is a sum in another order (rtol 1e-6)."""
    tmp, res = dtensor_ranks
    params, opt, norms = _plain_steps(tmp, None)
    for r in range(4):
        np.testing.assert_allclose(res[r]["norms_None"], norms, rtol=1e-6)
        for n in DT_LEAVES:
            np.testing.assert_array_equal(
                np.load(tmp / f"r{r}_None_{n}.npy"), _np(params[n]))
            for k in ("m", "v"):
                np.testing.assert_array_equal(
                    np.load(tmp / f"r{r}_None_{k}_{n}.npy"),
                    opt[k][n].numpy())


def test_adamw_on_dtensor_blocks_clips_by_the_global_norm(dtensor_ranks):
    """With clipping the scale comes from the norm, a sum of the blocks'
    squares in another order: the clipped steps within rtol 1e-5 / atol
    1e-6 (one bfloat16 ulp on the bfloat16 leaf)."""
    tmp, res = dtensor_ranks
    params, opt, norms = _plain_steps(tmp, 1.0)
    for r in range(4):
        np.testing.assert_allclose(res[r]["norms_1.0"], norms, rtol=1e-6)
        for n, (_, _, dt) in DT_LEAVES.items():
            rtol = 2 ** -7 if dt == "bfloat16" else 1e-5
            np.testing.assert_allclose(np.load(tmp / f"r{r}_1.0_{n}.npy"),
                                       _np(params[n]), rtol=rtol, atol=1e-6)
            np.testing.assert_allclose(np.load(tmp / f"r{r}_1.0_m_{n}.npy"),
                                       opt["m"][n].numpy(), rtol=1e-5,
                                       atol=1e-6)


def test_global_norm_on_dtensors_is_one_all_reduce(dtensor_ranks):
    """Every leaf's share, however it is split, goes into one all-reduce
    over the whole mesh a step; the update itself calls no collective."""
    for res in dtensor_ranks[1]:
        for clip in ("None", "1.0"):
            assert res[f"counts_{clip}"] == [{"all-reduce": 1}] * DT_STEPS
