"""Fault-tolerant checkpointing (the torch counterpart of
``repro.checkpoint.checkpointer``, with its on-disk layout):

* **atomic commit** - arrays are written into
  ``<dir>/.tmp.step_{N:08d}.{pid}`` and the directory is ``os.rename``d
  to ``step_{N:08d}`` only after every file is flushed and fsynced; a
  crash mid-save never leaves a half-readable step;
* **async** - ``Checkpointer.save_async`` copies the tree to host memory,
  then saves it on a background thread (the next save joins the previous
  one), so the train loop never blocks on disk;
* **auto-resume** - ``latest_step`` scans for the newest committed step;
  restore checks names and shapes against a skeleton and returns tensors
  of the recorded dtypes on the skeleton's devices (bfloat16 round-trips
  through its uint16 view);
* **multi-host layout** - each rank writes only its ``arrays.p{rank}.npz``
  (the ``torch.distributed`` rank when a group is initialised, else 0);
  ``meta.json`` holds ``step``, ``dtypes`` and the sorted ``names``.

A tree is nested dicts (and lists or tuples) of tensors; a leaf's name
joins its keys with ``/`` (``params/mlp.layers.0.weight``, ``opt/step``),
and inside the ``.npz`` every ``/`` becomes ``|``.  The names and dtype
strings are numpy's, as ``repro`` writes them, so each package reads the
other's checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_SEP = "/"


def _map(tree, fn, prefix: str = ""):
    """``tree``'s structure (nested dicts, lists and tuples) with each
    leaf replaced by ``fn(name, leaf)``."""
    join = lambda key: f"{prefix}{_SEP}{key}" if prefix else str(key)
    if isinstance(tree, dict):
        return {k: _map(v, fn, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, join(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def _flatten_with_names(tree) -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    _map(tree, flat.__setitem__)
    return flat


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if (dist.is_available()
                               and dist.is_initialized()) else 0


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bfloat16 as its uint16 view."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _fsync_write(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Synchronous atomic save. Returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = os.path.join(directory, f".tmp.step_{step:08d}.{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat = _flatten_with_names(tree)
    meta = {"step": step,
            "dtypes": {n: _dtype_name(leaf) for n, leaf in flat.items()},
            "names": sorted(flat)}
    arrays = {n.replace(_SEP, "|"): _to_numpy(leaf)
              for n, leaf in flat.items()}
    _fsync_write(os.path.join(tmp, f"arrays.p{_rank()}.npz"),
                 lambda f: np.savez(f, **arrays))
    _fsync_write(os.path.join(tmp, "meta.json"),
                 lambda f: f.write(json.dumps(meta).encode()))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def latest_step(directory: str) -> Optional[int]:
    """The newest committed step in ``directory`` (a ``step_*`` directory
    holding ``meta.json``), None when there is none."""
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_")
        and os.path.isfile(os.path.join(directory, d, "meta.json"))
    ]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, skeleton: Any,
                       step: Optional[int] = None) -> Tuple[int, Any]:
    """Restore into the structure of ``skeleton`` (names and shapes
    checked); each tensor has its recorded dtype and lies on its skeleton
    leaf's device."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, f"arrays.p{_rank()}.npz")) as z:
        arrays = {n.replace("|", _SEP): z[n] for n in z.files}

    flat_skel = _flatten_with_names(skeleton)
    if sorted(flat_skel) != sorted(meta["names"]):
        missing = set(meta["names"]) ^ set(flat_skel)
        raise ValueError(f"checkpoint tree mismatch: {sorted(missing)[:5]} ...")

    def rebuild(name, skel_leaf):
        arr = arrays[name]
        if tuple(arr.shape) != tuple(skel_leaf.shape):
            raise ValueError(f"{name}: shape {arr.shape} != "
                             f"{tuple(skel_leaf.shape)}")
        if meta["dtypes"][name] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        device = (skel_leaf.device if isinstance(skel_leaf, torch.Tensor)
                  else None)
        return t.to(device)

    return step, _map(skeleton, rebuild)


def _to_host(tree):
    """``tree`` with every tensor copied to host memory (the snapshot a
    background save writes while the train loop moves on)."""
    return _map(tree, lambda _, t: t.detach().to("cpu", copy=True)
                if isinstance(t, torch.Tensor) else t)


class Checkpointer:
    """Async double-buffered checkpointer with retention.  A save that
    failed on its thread raises from the next ``wait`` (or
    ``save_async``), so a run never goes on past a commit it lost."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save_async(self, step: int, tree: Any):
        self.wait()
        tree = _to_host(tree)  # snapshot before the train loop mutates

        def work():
            try:
                save_checkpoint(self.directory, step, tree)
                self._gc()
            except Exception as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1])
            for d in os.listdir(self.directory)
            if d.startswith("step_")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
