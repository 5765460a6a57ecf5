"""Production-mesh dry run (the torch counterpart of
``repro.launch.dryrun``): build every (architecture x input shape) cell
on a fake world of the production mesh's size and record what one
rank's step holds, computes and communicates.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepfm \\
      --shape serve_p99 --mesh pod             # 16x16, 256 fake ranks
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch ... --mesh multipod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list
  ... --device cpu                              # fake CPU tensors

``repro`` lowers and compiles each cell for 512 host devices.  Here the
process joins a fake process group of the mesh's world size as rank 0
(``hostdev.fake_world``), builds the cell's arguments as fake tensors
placed as DTensors (``steps.build_cell``) and runs the step once under
``FakeTensorMode``: nothing is allocated and nothing launches (K8 takes
its shape-only route on fake CUDA tensors, its plain version on fake
CPU ones).  The record keeps ``repro``'s keys where torch sees the same
thing:

* ``memory_stats.static_args_per_chip_bytes``: the rank's argument
  bytes by ``repro``'s rule (each leaf's bytes times the fraction its
  placement leaves a rank); ``static_args_held_bytes``, the fake local
  blocks' own bytes, must equal it; ``fits_80gb_h100_args`` against the
  H100's 80 GB;
* ``coll_op_counts`` and ``coll_by_kind``: the collectives the rank
  calls (DTensor's redistributions and the ``local_map`` bodies'
  ``torch.distributed`` calls), by ``repro``'s kind names, and the bytes
  it puts into them times the chips (global, as ``repro``'s);
* ``flop_counter_per_rank``: ``FlopCounterMode``'s matmul-class FLOPs of
  the rank's local operations, beside ``model_flops``
  (``model_flops_per_step``) and ``useful_flops_ratio``.

It adds ``trace_s``, the mesh's device type, the card (name and power
limit, or "not measured" without one) and ``real_tensors_seen`` (0: every
tensor the step met was fake).  ``repro``'s HLO fields (its roofline
terms) are ROADMAP item 12f's.  Records go to
``experiments/dryrun_torch/<arch>__<shape>__<mesh>[__<profile>].json``.
"""
from __future__ import annotations

import argparse
import contextlib
import contextvars
import json
import os
import shutil
import subprocess
import time
import traceback
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, _FlopCounterMode

H100_HBM_BYTES = 80e9
PROFILES = ("baseline", "fsdp_ep", "fsdp_ep_remat", "flash_remat", "a2a_emb")
MESHES = {"pod": ((16, 16), False), "multipod": ((2, 16, 16), True)}

# torch.distributed ops -> (repro's kind, index of the argument the rank
# puts in)
_COLLECTIVES = {
    "_c10d_functional::all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional::all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional::all_reduce": ("all-reduce", 0),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional::reduce_scatter_tensor_coalesced": (
        "reduce-scatter", 0),
    "_c10d_functional::all_to_all_single": ("all-to-all", 0),
    "_c10d_functional::broadcast": ("broadcast", 0),
    "c10d::allreduce_": ("all-reduce", 0),
    "c10d::allgather_": ("all-gather", 1),
    "c10d::_allgather_base_": ("all-gather", 1),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d::reduce_scatter_": ("reduce-scatter", 1),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d::alltoall_base_": ("all-to-all", 1),
    "c10d::alltoall_": ("all-to-all", 1),
    "c10d::broadcast_": ("broadcast", 0),
}


_LIFTS = (torch.ops.aten.lift_fresh, torch.ops.aten.lift_fresh_copy)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


# set while DTensor runs an operation at the global shape only to learn
# its output's shape (``ShardingPropagator._propagate_tensor_meta``): no
# rank runs that operation, so neither counter counts it
_PROPAGATING: contextvars.ContextVar = contextvars.ContextVar(
    "dtensor_meta_propagation", default=False)


@contextlib.contextmanager
def uncounted_meta_propagation():
    """Inside, DTensor's global-shape shape propagation is marked for the
    counters to skip (it runs once for each new operation signature, so
    counting it would make a count depend on what ran before)."""
    from torch.distributed.tensor import DTensor

    prop = DTensor._op_dispatcher.sharding_propagator
    orig = prop._propagate_tensor_meta_non_cached

    def marked(op_schema):
        tok = _PROPAGATING.set(True)
        try:
            return orig(op_schema)
        finally:
            _PROPAGATING.reset(tok)

    prop._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        del prop._propagate_tensor_meta_non_cached


def _on_dtensors(types) -> bool:
    from torch.distributed.tensor import DTensor

    return any(issubclass(t, DTensor) for t in types)


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives this rank dispatches on its local tensors,
    by kind: ``counts`` and ``bytes`` (what the rank puts in).  An
    operation on DTensors is let through (``NotImplemented``) so that
    DTensor runs it with this mode still on the stack, and the local
    operations and redistributions it makes come back here.  ``real``
    counts the local tensors met that are neither fake nor meta, but for
    a constant lifted from the host (the dry run's check that nothing
    real ran and nothing was made on the card)."""

    def __init__(self):
        super().__init__()
        self.counts = defaultdict(int)
        self.bytes = defaultdict(int)
        self.real = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import is_fake

        if _on_dtensors(types):
            return NotImplemented
        kwargs = kwargs or {}
        if _PROPAGATING.get():
            return func(*args, **kwargs)
        lift = func._overloadpacket in _LIFTS  # a constant comes in real
        self.real += sum(
            1 for t in _tensors(list(args) + list(kwargs.values()))
            if not is_fake(t) and t.device.type != "meta"
            and not (lift and t.device.type == "cpu"))
        entry = _COLLECTIVES.get(func._schema.name)
        if entry is not None:
            kind, i = entry
            self.counts[kind] += 1
            self.bytes[kind] += sum(t.numel() * t.element_size()
                                    for t in _tensors(args[i]))
        return func(*args, **kwargs)


class _LocalFlopMode(_FlopCounterMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _on_dtensors(types):
            return NotImplemented
        if _PROPAGATING.get():
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


class LocalFlopCounter(FlopCounterMode):
    """``FlopCounterMode`` counting this rank's local operations: an
    operation on DTensors is let through to DTensor, and its FLOPs are
    counted once, by the local operation it runs here (not also at the
    global shape)."""

    def __enter__(self):
        self.flop_counts.clear()
        self.mod_tracker.__enter__()
        self.mode = _LocalFlopMode(self)
        self.mode.__enter__()
        return self


def card_line() -> str:
    """The card's ``name, power limit`` as ``nvidia-smi`` gives them, or
    "not measured" where there is none."""
    if shutil.which("nvidia-smi") is None:
        return "not measured"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=30)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else (
        "not measured")


def rules_for(profile: str, multi: bool):
    from repro_torch.distributed.context import (
        fsdp_ep_rules, multi_pod_rules, recsys_a2a_rules, single_pod_rules)

    if profile in ("fsdp_ep", "fsdp_ep_remat"):
        return fsdp_ep_rules(multi)
    if profile == "a2a_emb":
        return recsys_a2a_rules(multi)
    return multi_pod_rules() if multi else single_pod_rules()


def trace(cell, mesh, rules) -> dict:
    """Run ``cell``'s step once on ``mesh`` (a ``DeviceMesh``) under
    ``rules``: ``{"out", "flops", "counts", "bytes", "notes", "real",
    "trace_s"}``.  A serving cell runs without gradients; a training
    cell's step records them, and both counters see its backward (the
    recompute of its remat sites included) and AdamW."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import context as dctx

    mm = dctx.model_mesh_from_device_mesh(mesh)
    flops, coll = LocalFlopCounter(display=False), CollectiveCounter()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as st:
        if cell.fake_mode is not None:
            st.enter_context(cell.fake_mode)
        st.enter_context(dctx.axis_rules(rules, mm))
        notes = st.enter_context(dctx.collect_notes())
        st.enter_context(implicit_replication())
        if not cell.train:
            st.enter_context(torch.no_grad())
        st.enter_context(uncounted_meta_propagation())
        st.enter_context(flops)
        st.enter_context(coll)
        out = cell.step_fn(*cell.args)
    return {"out": out, "flops": int(flops.get_total_flops()),
            "counts": dict(coll.counts), "bytes": dict(coll.bytes),
            "notes": list(notes), "real": coll.real,
            "trace_s": time.perf_counter() - t0}


def record(arch_id, shape_name, mesh_name, profile, cell, mesh, res,
           device_type: str) -> dict:
    chips = mesh.size()
    rule, held = cell.static_bytes(mesh)
    notes = "; ".join(x for x in [cell.notes] + res["notes"] if x)
    return {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
        "chips": chips, "status": "ok", "profile": profile, "notes": notes,
        "model_flops": cell.model_flops_per_step,
        "flop_counter_per_rank": res["flops"],
        "useful_flops_ratio": (cell.model_flops_per_step
                               / (res["flops"] * chips)
                               if res["flops"] else 0.0),
        "memory_stats": {
            "static_args_per_chip_bytes": rule,
            "static_args_held_bytes": held,
            "fits_80gb_h100_args": bool(rule < H100_HBM_BYTES),
            "budget_bytes": H100_HBM_BYTES,
        },
        "coll_op_counts": dict(sorted(res["counts"].items())),
        "coll_by_kind": {k: v * chips for k, v in sorted(
            res["bytes"].items())},
        "trace_s": round(res["trace_s"], 3),
        "mesh_device_type": device_type,
        "card": card_line() if device_type == "cuda" else "not measured",
        "real_tensors_seen": res["real"],
    }


def record_path(out_dir, arch_id, shape_name, mesh_name, profile) -> str:
    suffix = "" if profile == "baseline" else f"__{profile}"
    return os.path.join(out_dir,
                        f"{arch_id}__{shape_name}__{mesh_name}{suffix}.json")


def _write(out_dir, rec, profile) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(record_path(out_dir, rec["arch"], rec["shape"], rec["mesh"],
                          profile), "w") as f:
        json.dump(rec, f, indent=1)


def dry_run(arch, shape, mesh, mesh_name: str, profile: str = "baseline",
            params=None, batch=None):
    """One cell of ``arch`` (an ``ArchSpec``) at ``shape`` on ``mesh`` (a
    ``DeviceMesh`` of this process's group) under ``profile``'s rules:
    ``(record, trace result)``.  Fake arguments unless ``params`` (and
    ``batch``) are given, as ``steps.build_cell`` takes them."""
    from repro_torch.launch.steps import build_cell

    multi = "pod" in (mesh.mesh_dim_names or ())
    rules = rules_for(profile, multi)
    cell = build_cell(arch, shape, mesh, rules, profile=profile,
                      params=params, batch=batch)
    res = trace(cell, mesh, rules)
    return record(arch.id, shape.name, mesh_name, profile, cell, mesh, res,
                  mesh.device_type), res


def run_cell(arch_id: str, shape_name: str, mesh_name: str, out_dir: str,
             profile: str = "baseline", device: str = "cuda") -> dict:
    """One cell on a fake world of the production mesh (this process
    joins it, one cell a process as ``run_dryruns`` runs them, or uses
    the fake world it is already in when that is large enough); writes
    and returns its record."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.hostdev import fake_world
    from repro_torch.launch.mesh import make_production_mesh

    arch = get_arch(arch_id)
    if shape_name in arch.skips:
        rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
               "status": "skipped", "reason": arch.skips[shape_name]}
        _write(out_dir, rec, profile)
        return rec
    dims, multi = MESHES[mesh_name]
    n = 1
    for d in dims:
        n *= d
    if not (dist.is_initialized() and dist.get_backend() == "fake"
            and dist.get_world_size() >= n):
        fake_world(n)
    mesh = make_production_mesh(multi_pod=multi, device=device)
    rec, _ = dry_run(arch, arch.shapes[shape_name], mesh, mesh_name, profile)
    _write(out_dir, rec, profile)
    return rec


def list_cells() -> str:
    """``repro``'s ``--list`` text: every (arch, shape), skips marked."""
    from repro_torch.configs import get_arch, list_archs

    lines = []
    for a in list_archs():
        spec = get_arch(a)
        for s in spec.shapes:
            mark = " [SKIP: " + spec.skips[s] + "]" if s in spec.skips else ""
            lines.append(f"{a:18s} {s}{mark}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=False)
    ap.add_argument("--shape", required=False)
    ap.add_argument("--mesh", choices=list(MESHES), default="pod")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--profile", default="baseline", choices=list(PROFILES))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' and the mesh's device type")
    args = ap.parse_args(argv)

    if args.list:
        print(list_cells())
        return 0

    try:
        rec = run_cell(args.arch, args.shape, args.mesh, args.out,
                       args.profile, args.device)
    except Exception as e:  # recorded, as repro records a failed cell
        traceback.print_exc()
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "profile": args.profile, "status": "error",
               "error_type": type(e).__name__,
               "error": traceback.format_exc()[-2000:]}
        _write(args.out, rec, args.profile)
        return 1
    print(json.dumps({k: rec.get(k) for k in (
        "arch", "shape", "mesh", "chips", "status", "profile",
        "flop_counter_per_rank", "model_flops", "useful_flops_ratio",
        "coll_op_counts", "trace_s")}, indent=1))
    if rec.get("memory_stats"):
        print("memory:", rec["memory_stats"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
