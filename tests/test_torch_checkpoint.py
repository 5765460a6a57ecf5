"""The port's checkpointer (``repro_torch.checkpoint``) against
``repro.checkpoint``'s on-disk layout, on the CPU.

Round trips are exact (the arrays are stored, not recomputed): float32,
bfloat16 (through its uint16 view) and int32 leaves come back bit for
bit, with their dtypes, on the skeleton's device.  A tree saved by each
package gives the same files, the same ``meta.json`` and the same
arrays, and each package restores the other's checkpoint.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_ckpt
from repro.configs import get_arch as jax_get_arch
from repro.models import recsys as jax_recsys
from repro_torch.checkpoint import (
    Checkpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.models import params_from_jax
from tests.test_torch_recsys import port_cfg


def _tree():
    rng = np.random.default_rng(0)
    return {
        "params": {
            "mlp.layers.0.weight": torch.from_numpy(
                rng.normal(size=(3, 4)).astype(np.float32)),
            "table": torch.from_numpy(rng.normal(size=(6, 2)).astype(
                np.float32)).to(torch.bfloat16),
        },
        "opt": {"step": torch.tensor(7, dtype=torch.int32),
                "m": [torch.arange(5, dtype=torch.float32)]},
    }


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return torch.zeros_like(tree)


def _leaves(tree, name=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{name}/{k}" if name else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{name}/{i}")
    else:
        yield name, tree


def test_round_trip_f32_bf16_int32(tmp_path):
    d = str(tmp_path / "ck")
    tree = _tree()
    path = save_checkpoint(d, 5, tree)
    assert os.path.basename(path) == "step_00000005"
    assert sorted(os.listdir(path)) == ["arrays.p0.npz", "meta.json"]
    assert latest_step(d) == 5
    step, got = restore_checkpoint(d, _skeleton(tree))
    assert step == 5
    want = dict(_leaves(tree))
    for name, leaf in _leaves(got):
        assert leaf.dtype == want[name].dtype, name
        assert torch.equal(leaf, want[name]), name
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["step"] == 5
    assert meta["names"] == sorted(want)
    assert meta["dtypes"] == {"opt/m/0": "float32", "opt/step": "int32",
                              "params/mlp.layers.0.weight": "float32",
                              "params/table": "bfloat16"}
    with np.load(os.path.join(path, "arrays.p0.npz")) as z:
        assert sorted(z.files) == sorted(n.replace("/", "|") for n in want)
        assert z["params|table"].dtype == np.uint16


def test_same_layout_as_repro(tmp_path):
    """One tree saved by each package: the same files, meta.json and
    arrays; each restores the other's."""
    tree = _tree()
    jtree = jax.tree.map(
        lambda t: jnp.asarray(t.to(torch.float32).numpy(),
                              jnp.bfloat16 if t.dtype == torch.bfloat16
                              else t.numpy().dtype), tree)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    save_checkpoint(ours, 3, tree)
    jax_ckpt.save_checkpoint(theirs, 3, jtree)
    assert os.listdir(ours) == os.listdir(theirs) == ["step_00000003"]
    a, b = (os.path.join(x, "step_00000003") for x in (ours, theirs))
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    assert json.load(open(os.path.join(a, "meta.json"))) == json.load(
        open(os.path.join(b, "meta.json")))
    with np.load(os.path.join(a, "arrays.p0.npz")) as za, \
            np.load(os.path.join(b, "arrays.p0.npz")) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for n in za.files:
            assert za[n].dtype == zb[n].dtype
            np.testing.assert_array_equal(za[n], zb[n])
    _, got = restore_checkpoint(theirs, _skeleton(tree))
    for (n, x), (_, y) in zip(_leaves(got), _leaves(tree)):
        assert x.dtype == y.dtype and torch.equal(x, y), n
    _, jgot = jax_ckpt.restore_checkpoint(
        ours, jax.tree.map(jnp.zeros_like, jtree))
    for x, y in zip(jax.tree.leaves(jgot), jax.tree.leaves(jtree)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(y, np.float32))


def test_async_save_and_gc_keep(tmp_path):
    d = str(tmp_path / "ck")
    ck = Checkpointer(d, keep=2)
    w = torch.zeros(8)
    for s in (1, 2, 3, 4):
        ck.save_async(s, {"w": w})
        w += 1.0  # the snapshot was taken before the thread started
    ck.wait()
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    assert latest_step(d) == 4
    for s in (3, 4):
        _, got = restore_checkpoint(d, {"w": torch.zeros(8)}, step=s)
        assert torch.equal(got["w"], torch.full((8,), float(s - 1)))


def test_failed_async_save_raises_from_wait(tmp_path):
    """A save that fails on its thread is not lost: ``wait`` raises it,
    once."""
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("a file where the directory should be")
    ck = Checkpointer(str(blocker))
    ck.save_async(1, {"w": torch.zeros(2)})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()  # the error was reported once


@pytest.mark.parametrize("bad", ["name", "shape", "missing"])
def test_mismatch_raises(tmp_path, bad):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, {"a": torch.zeros(3), "b": torch.zeros(2)})
    skel = {"a": torch.zeros(3), "b": torch.zeros(2)}
    if bad == "name":
        skel = {"a": torch.zeros(3), "c": torch.zeros(2)}
    elif bad == "shape":
        skel["b"] = torch.zeros(4)
    else:
        skel = {"a": torch.zeros(3)}
    match = "shape" if bad == "shape" else "tree mismatch"
    with pytest.raises(ValueError, match=match):
        restore_checkpoint(d, skel)


def test_torn_tmp_directory_is_ignored(tmp_path):
    d = tmp_path / "ck"
    save_checkpoint(str(d), 2, {"a": torch.ones(2)})
    torn = d / ".tmp.step_00000009.123"
    torn.mkdir()
    (torn / "arrays.p0.npz").write_bytes(b"half a file")
    (d / "step_00000011").mkdir()  # a step directory without meta.json
    assert latest_step(str(d)) == 2
    step, got = restore_checkpoint(str(d), {"a": torch.zeros(2)})
    assert step == 2 and torch.equal(got["a"], torch.ones(2))
    assert latest_step(str(tmp_path / "nowhere")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nowhere"), {"a": torch.zeros(2)})


def test_reads_repro_deepfm_checkpoint(tmp_path):
    """Reduced DeepFM's params saved by ``repro`` (the table in bfloat16)
    read in the port by name and, through ``params_from_jax``, give the
    model the in-memory conversion gives."""
    jcfg = jax_get_arch("deepfm").reduced()
    params = jax_recsys.init_params(jax.random.PRNGKey(0), jcfg)
    params = dict(params, table=params["table"].astype(jnp.bfloat16))
    d = str(tmp_path / "ck")
    jax_ckpt.save_checkpoint(d, 12, {"params": params})
    skel = jax.tree.map(lambda a: torch.zeros(a.shape), {"params": params})
    step, got = restore_checkpoint(d, skel)
    assert step == 12 and got["params"]["table"].dtype == torch.bfloat16
    as_numpy = lambda t: t.to(torch.float32).numpy()
    restored = params_from_jax(
        {k: (jax.tree.map(as_numpy, v) if isinstance(v, dict) else
             as_numpy(v)) for k, v in got["params"].items()},
        port_cfg(jcfg), device="cpu")
    direct = params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), params),
        port_cfg(jcfg), device="cpu")
    a, b = restored.state_dict(), direct.state_dict()
    assert list(a) == list(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name
