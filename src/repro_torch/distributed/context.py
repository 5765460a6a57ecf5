"""Candidate-axis meshes over ``torch.distributed`` (the torch counterpart
of ``repro/distributed/context.py``'s ``make_mesh_compat`` /
``shard_map_compat``, for the candidate axis only).

``repro`` shards the candidate axis with a single-controller
``shard_map`` over a ``("data",)`` mesh.  The port runs the same program
as P ranks of a process group, one process each: every rank gets the
same full request, keeps only its column shard, and calls the same
collectives in the same order.  A :class:`CandidateMesh` names the
group, this rank, the world size, the axis name and the device the
rank's shard lives on.

The two collectives ``repro.core.sharded`` uses move a few values a
user each step:

* :func:`global_argmax` (``repro``'s ``_global_argmax``): an all-gather
  of every shard's (best gain, its global id) in rank order, folded by
  gain, then by lowest rank.  Shards are contiguous, so the lowest rank
  holds the lowest global id: the fold breaks ties as a single-device
  argmax does.  It is not a MAX all-reduce of packed argmax keys, whose
  unsigned order a signed int64 reduction would not keep.
* :func:`bcast_from_owner` (``repro``'s ``_bcast_from_owner``): a SUM
  all-reduce of a vector that every rank but its owner zeroed.

Backends are ``nccl`` and ``gloo``, named by the caller and never
swapped on error, and ``fake`` (``torch.testing``'s fake process group:
every collective returns at once, so one process stands for a rank of
a production world, ``repro_torch.launch.hostdev.fake_world``).  gloo's
all-gather does not take CUDA tensors, so under gloo every collective
of a CUDA mesh stages its few values
through host tensors on purpose (which also synchronises the device);
NCCL keeps them on the card.  Several gloo ranks may share one card;
NCCL refuses two ranks of one communicator on one GPU.

:func:`init_group` joins a group by rendezvous on a file in a fresh
temporary directory (never a fixed port) with an explicit timeout,
:func:`leave_group` leaves it with a barrier first, and
:func:`spawn_ranks` starts the ranks of a group as subprocesses of this
interpreter (never ``fork``: a forked child cannot use CUDA that its
parent initialised), each with a time limit, and ends every rank when
one fails.

The model-parallel half (``repro``'s ``context.py:26-210``) follows the
candidate axis: :class:`ModelMesh` is a 2-D ``("data", "model")`` mesh
of the ranks of one group, with a process group for each data row (the
``"model"`` axis), each model column (``"data"``) and the whole mesh,
and per-axis collectives.  ``repro``'s four rule tables map logical
names to mesh axes; :func:`axis_rules` installs a table and a mesh for
the code inside it (a ``contextvars`` pair, as ``repro``'s), and
:func:`constrain` resolves names through the table and returns its
input, as ``with_sharding_constraint`` changes no value.  A parameter
that ``repro`` shards is held as this rank's block (:func:`local_block`);
activations are whole at every model-level boundary: a body that
``repro`` runs under ``shard_map`` takes its rank's slice of them on
entry and all-gathers its output on exit (:func:`gather_block`).  A
spec is a plain tuple, one entry a dimension: None (whole), an axis
name, or a tuple of axis names in mesh order.  A mesh may carry a
leading ``"pod"`` axis, so that ``multi_pod_rules``' ``("pod",
"data")`` resolve.

On DTensors (``torch.distributed.tensor``, the dry run's placements over
a ``DeviceMesh``, ``repro_torch.launch``) :func:`constrain` redistributes
to the resolved spec, as ``with_sharding_constraint`` reshards, and
:func:`place` places a tensor the code makes itself (a cache buffer);
a mesh axis that does not divide its dimension is dropped, the
partitioner's choice written down by :func:`note`.  A ``ModelMesh``
built over a ``DeviceMesh`` (:func:`model_mesh_from_device_mesh`) uses
its process groups, so the bodies that ``local_map`` enters see the
same groups as the DTensors around them.

The ``ModelMesh`` collectives are differentiable, for a loss that is the
same on every rank (a training step): a cotangent reaching a collective
is whole on each rank, so ``psum``'s backward passes it through,
``all_gather``'s keeps the rank's slice and ``all_to_all``'s exchanges
it back.  :func:`grad_placements` names what a ``local_map`` body's
input gradients are (a partial sum over the axes that split only the
work), and :func:`pinned` brings a DTensor's gradient back in its own
layout.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import functools
import itertools
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

BACKENDS = ("nccl", "gloo", "fake")
DEFAULT_TIMEOUT_S = 120.0


@dataclasses.dataclass(eq=False)
class CandidateMesh:
    """One rank's view of a 1-D candidate-axis mesh.

    ``timing=True`` makes every collective synchronise the device before
    and after it and add its host seconds to ``collective_s`` (and one
    to ``collectives``), so a caller can read the collectives' share of
    a run; off, the collectives run unsynchronised and uncounted."""

    group: object
    rank: int
    size: int
    axis_name: str
    device: torch.device
    backend: str
    timing: bool = False
    collective_s: float = 0.0
    collectives: int = 0

    def reset_timing(self, timing: bool = True) -> None:
        self.timing, self.collective_s, self.collectives = timing, 0.0, 0


def init_group(backend: str, rank: int, world_size: int, init_file,
               timeout_s: float = DEFAULT_TIMEOUT_S, device=None) -> None:
    """Join the default process group as ``rank`` of ``world_size`` by
    rendezvous on ``init_file`` (a path in a fresh directory that no
    earlier group used), with every collective bounded by
    ``timeout_s``.  ``nccl`` binds this process to ``device`` (default
    the current card) first."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl":
        dev = resolve_device("cuda" if device is None else device)
        if dev.type != "cuda":
            raise ValueError(f"nccl needs a CUDA device, got {dev}")
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=Path(init_file).resolve().as_uri(), rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s))


def leave_group() -> None:
    """Leave the default process group together: a barrier first, so no
    rank closes its connections while a peer still uses them (a gloo rank
    whose peer hung up early can abort at exit), then destroy the group.
    Call it on the success path only; a rank that raises exits without
    waiting for its peers."""
    dist.barrier()
    dist.destroy_process_group()


def make_mesh(group=None, axis_name: str = "data",
              device=None) -> CandidateMesh:
    """A :class:`CandidateMesh` over ``group`` (default: the default
    group, which :func:`init_group` or the caller initialised) whose
    shards live on ``device`` (default the card)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group "
            "(repro_torch.distributed.init_group or "
            "torch.distributed.init_process_group)")
    group = dist.group.WORLD if group is None else group
    backend = str(dist.get_backend(group))
    if backend not in BACKENDS:
        raise ValueError(f"unsupported backend {backend!r}; the candidate "
                         f"mesh runs on {BACKENDS}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an nccl mesh needs a CUDA device, got {dev}")
    return CandidateMesh(group, dist.get_rank(group),
                         dist.get_world_size(group), axis_name, dev, backend)


def shard_bounds(M: int, mesh: CandidateMesh):
    """``(base, Mloc)``: this rank's first global column and its shard
    width, ``M`` zero-padded to ``P * Mloc`` with ``Mloc = ceil(M / P)``."""
    Mloc = -(-M // mesh.size)
    return mesh.rank * Mloc, Mloc


@contextlib.contextmanager
def _collective(mesh: CandidateMesh):
    if not mesh.timing:
        yield
        return
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    yield
    if cuda:
        torch.cuda.synchronize(mesh.device)
    mesh.collective_s += time.perf_counter() - t0
    mesh.collectives += 1


def _staged(mesh, x: torch.Tensor) -> torch.Tensor:
    # gloo's collectives take host tensors only: stage on purpose
    if mesh.backend == "gloo" and x.is_cuda:
        return x.cpu()
    return x.contiguous()


def _gather(group, n: int, backend: str, y: torch.Tensor) -> torch.Tensor:
    # gloo has no all-gather into one tensor; a fake group stands for
    # nccl on the card and for gloo on the CPU
    if backend == "nccl" or (backend == "fake" and y.is_cuda):
        out = torch.empty((n,) + tuple(y.shape), dtype=y.dtype,
                          device=y.device)
        dist.all_gather_into_tensor(out, y, group=group)
        return out
    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y, group=group)
    return torch.stack(parts)


def _sum(group, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    y = y.clone() if y is x else y
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.to(x.device)


def all_gather(mesh: CandidateMesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: ``(P, *x.shape)`` on
    ``x``'s device."""
    with _collective(mesh):
        return _gather(mesh.group, mesh.size, mesh.backend,
                       _staged(mesh, x)).to(x.device)


def all_reduce_sum(mesh: CandidateMesh, x: torch.Tensor) -> torch.Tensor:
    """The element-wise sum of every rank's ``x``, on ``x``'s device."""
    with _collective(mesh):
        return _sum(mesh.group, x, _staged(mesh, x))


def gather_pairs(mesh: CandidateMesh, val: torch.Tensor, idx: torch.Tensor):
    """Every rank's (float32 ``val``, int64 ``idx``) pairs in rank order,
    in one all-gather: ``(P, *val.shape)`` each.  The values travel as
    their bits, so they arrive exactly."""
    bits = val.to(torch.float32).contiguous().view(torch.int32)
    both = all_gather(mesh, torch.stack([bits.to(torch.int64),
                                         idx.to(torch.int64)]))
    vals = both[:, 0].to(torch.int32).view(torch.float32)
    return vals, both[:, 1]


def global_argmax(mesh: CandidateMesh, val: torch.Tensor, gid: torch.Tensor):
    """The cross-shard argmax of each user's shard-local best ``(val (B,),
    global id gid (B,))``: ``(best gain (B,), global id (B,) int64,
    owner (B,) bool)``, ``owner`` true on the rank holding the winner.
    Ties go to the lowest rank, so the lowest global id."""
    vals, gids = gather_pairs(mesh, val, gid)
    p = torch.argmax(vals, dim=0)  # the first maximum: the lowest rank
    ar = torch.arange(val.shape[0], device=vals.device)
    return vals[p, ar], gids[p, ar], p == mesh.rank


def bcast_from_owner(mesh: CandidateMesh, z: torch.Tensor,
                     owner: torch.Tensor) -> torch.Tensor:
    """Each user's row of ``z (B, n)`` from the rank that owns it (one SUM
    all-reduce of the owner-masked rows)."""
    return all_reduce_sum(mesh, torch.where(owner[:, None], z, 0.0))


# ---------------------------------------------------------------------------
# The model-parallel mesh and repro's rule tables
# ---------------------------------------------------------------------------

AxisVal = Union[None, str, Sequence[str]]
MESH_AXES = ("data", "model")
POD_MESH_AXES = ("pod",) + MESH_AXES


# ``repro``'s rule tables (its DESIGN.md §4), copied: "dp" is the pure-data
# axis set; on the multi-pod mesh the pod axis composes with data.
def single_pod_rules() -> Mapping[str, AxisVal]:
    return {
        "batch": ("data",),
        "fsdp": ("data",),
        "model": "model",
        "experts": "model",
        "vocab": "model",
        "heads": "model",
        "kv_seq": "model",
        "ff": "model",
        "rows": "model",  # embedding-table rows
        "nodes": ("data", "model"),  # GNN full-graph node sharding
        "edges": ("data", "model"),
    }


def multi_pod_rules() -> Mapping[str, AxisVal]:
    return {
        "batch": ("pod", "data"),
        "fsdp": ("pod", "data"),
        "model": "model",
        "experts": "model",
        "vocab": "model",
        "heads": "model",
        "kv_seq": "model",
        "ff": "model",
        "rows": "model",
        "nodes": ("pod", "data", "model"),
        "edges": ("pod", "data", "model"),
    }


def fsdp_ep_rules(multi_pod: bool) -> Mapping[str, AxisVal]:
    """``repro``'s LM profile without tensor parallelism: dense parameters
    over every axis, activations batch x sequence ("model" carries the
    sequence), experts expert-parallel on "model"."""
    dp = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": dp,
        "seq": "model",
        "fsdp": dp + ("model",),
        "fsdp_expert": dp,  # experts already consume "model"
        "model": "model",
        "experts": "model",
        "vocab": "model",
        "heads": None,
        "kv_seq": "model",
        "ff": None,
        "rows": "model",
        "nodes": dp + ("model",),
        "edges": dp + ("model",),
    }


def recsys_a2a_rules(multi_pod: bool) -> Mapping[str, AxisVal]:
    """``repro``'s recsys profile: the batch over every axis, the table's
    rows exchanged by all-to-all instead of a dense psum."""
    base = dict(multi_pod_rules() if multi_pod else single_pod_rules())
    base["batch"] = (("pod", "data", "model") if multi_pod
                     else ("data", "model"))
    base["rows"] = base["batch"]  # table rows over the full device grid
    return base


@dataclasses.dataclass(eq=False)
class ModelMesh:
    """One rank's view of a 2-D ``("data", "model")`` mesh of ranks, or
    with ``pods > 1`` a 3-D ``("pod", "data", "model")`` one.

    ``ranks`` holds the mesh's global ranks row by row (the data index,
    then the model index; on a 3-D mesh the rows run pod by pod),
    ascending, so the ranks of any group in rank order are its axis
    order, row-major over a tuple of axes, as ``jax.lax.axis_index``
    numbers them.  ``groups`` maps the ranks of each group this rank
    belongs to (a data row is the ``"model"`` axis, a model column the
    ``"data"`` axis, and the whole mesh) to its process group; a mesh
    over a ``DeviceMesh`` (``device_mesh``) takes every group from it
    when first asked.  A collective over axes of size 1 returns its input
    and touches no group, so a (1, 1) mesh needs none.  ``collectives``
    and ``collective_bytes`` count the collectives this rank called over
    more than one rank and the bytes it put into them."""

    ranks: Tuple[Tuple[int, ...], ...]
    rank: int
    device: torch.device
    backend: str = "gloo"
    groups: dict = dataclasses.field(default_factory=dict)
    collectives: int = 0
    collective_bytes: int = 0
    pods: int = 1
    device_mesh: object = None

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return POD_MESH_AXES if self.pods > 1 else MESH_AXES

    @property
    def shape(self) -> dict:
        if self.pods > 1:
            return {"pod": self.pods, "data": len(self.ranks) // self.pods,
                    "model": len(self.ranks[0])}
        return {"data": len(self.ranks), "model": len(self.ranks[0])}

    @functools.cached_property
    def _coord_map(self) -> dict:
        d = len(self.ranks) // self.pods
        return {r: ((i // d, i % d, j) if self.pods > 1 else (i, j))
                for i, row in enumerate(self.ranks)
                for j, r in enumerate(row)}

    def _coords_of(self, rank: int) -> Tuple[int, ...]:
        if rank not in self._coord_map:
            raise ValueError(f"rank {rank} is not in the mesh {self.ranks}")
        return self._coord_map[rank]

    @property
    def coords(self) -> Tuple[int, ...]:
        return self._coords_of(self.rank)

    def axes(self, axes: AxisVal) -> Tuple[str, ...]:
        """``axes`` (None, a name or names) as a tuple of mesh axes in
        mesh order; an axis the mesh lacks (``"pod"`` on a 2-D mesh)
        raises, as a ``NamedSharding`` over it would."""
        axes = () if axes is None else (
            (axes,) if isinstance(axes, str) else tuple(axes))
        names = self.axis_names
        for a in axes:
            if a not in names:
                raise ValueError(f"the mesh has axes {names}, not {a!r}")
        if list(axes) != sorted(set(axes), key=names.index):
            raise ValueError(f"axes {axes} out of mesh order {names}")
        return axes

    def axis_size(self, axes: AxisVal) -> int:
        n = 1
        for a in self.axes(axes):
            n *= self.shape[a]
        return n

    def axis_index(self, axes: AxisVal) -> int:
        """This rank's index along ``axes``, row-major over them."""
        coords = dict(zip(self.axis_names, self.coords))
        idx = 0
        for a in self.axes(axes):
            idx = idx * self.shape[a] + coords[a]
        return idx

    def group_ranks(self, axes: AxisVal) -> Tuple[int, ...]:
        """The ranks that share this rank's indices off ``axes``."""
        axes = self.axes(axes)
        keep = [a not in axes for a in self.axis_names]
        mine = self.coords
        return tuple(
            r for row in self.ranks for r in row
            if all(c == m for c, m, k in
                   zip(self._coord_map[r], mine, keep) if k))

    def _group(self, axes: AxisVal):
        ranks = self.group_ranks(axes)
        if len(ranks) <= 1:
            return None, len(ranks)
        if ranks not in self.groups and self.device_mesh is not None:
            self.groups[ranks] = _device_mesh_group(self.device_mesh,
                                                    self.axes(axes))
        return self.groups[ranks], len(ranks)

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        self.collectives += 1
        self.collective_bytes += x.numel() * x.element_size()
        return _staged(self, x)

    def _all_to_all(self, x: torch.Tensor, axes: AxisVal) -> torch.Tensor:
        group, n = self._group(axes)
        if x.shape[0] != n:
            raise ValueError(f"all_to_all over {axes} needs {n} rows, got "
                             f"shape {tuple(x.shape)}")
        if group is None:
            return x
        y = self._staged(x)
        out = torch.empty_like(y)
        dist.all_to_all_single(out, y, group=group)
        return out.to(x.device)

    def _psum(self, x: torch.Tensor, axes: AxisVal) -> torch.Tensor:
        group, _ = self._group(axes)
        if group is None:
            return x
        return _sum(group, x, self._staged(x))

    def _all_gather(self, x: torch.Tensor, axes: AxisVal) -> torch.Tensor:
        group, n = self._group(axes)
        if group is None:
            return x[None]
        return _gather(group, n, self.backend, self._staged(x)).to(x.device)

    def all_to_all(self, x: torch.Tensor, axes: AxisVal) -> torch.Tensor:
        """``jax.lax.all_to_all(x, axes, 0, 0, tiled=False)``: ``x (n,
        ...)`` with ``n`` the axes' size; row ``k`` of the result is what
        rank ``k`` along ``axes`` sent this one as its row for it.  Its
        backward is the same all-to-all of the cotangent (the exchange is
        its own inverse)."""
        return _one_rank_or(_AllToAll, self._all_to_all, self, x, axes)

    def psum(self, x: torch.Tensor, axes: AxisVal) -> torch.Tensor:
        """The element-wise sum of ``x`` over ``axes``.  Its backward
        passes the cotangent through: the loss is the same on every rank,
        so the sum's cotangent is already whole on each."""
        return _one_rank_or(_PSum, self._psum, self, x, axes)

    def pmean(self, x: torch.Tensor, axes: AxisVal) -> torch.Tensor:
        return self.psum(x, axes) / self.axis_size(axes)

    def all_gather(self, x: torch.Tensor, axes: AxisVal) -> torch.Tensor:
        """Every rank's ``x`` along ``axes`` stacked in axis order: ``(n,
        *x.shape)``.  Its backward keeps this rank's slice of the
        cotangent (whole on every rank, as for :meth:`psum`)."""
        return _one_rank_or(_AllGather, self._all_gather, self, x, axes)


def _one_rank_or(fn, raw, mesh, x, axes):
    """The autograd ``Function`` ``fn`` (its forward ``raw``); over axes of
    one rank ``raw`` itself, which touches no group and returns ``x`` (or
    a view of it), so autograd sees through it."""
    if mesh._group(axes)[0] is None:
        return raw(x, axes)
    return fn.apply(mesh, x, axes)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh._all_to_all(x, axes)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.mesh._all_to_all(g.contiguous(), ctx.axes), None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x, axes):
        return mesh._psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return None, g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x, axes):
        ctx.index = mesh.axis_index(axes)
        return mesh._all_gather(x, axes)

    @staticmethod
    def backward(ctx, g):
        return None, g[ctx.index], None


def _device_mesh_group(dm, axes: Tuple[str, ...]):
    """The process group of ``dm`` over ``axes`` (this rank's): the axis's
    own group, or that of the axes flattened into one (made here, so
    outside any fake mode: ``model_mesh_from_device_mesh`` makes them
    all)."""
    if len(axes) == 1:
        return dm.get_group(axes[0])
    return dm[axes]._flatten().get_group()


def model_mesh_from_device_mesh(dm) -> ModelMesh:
    """A :class:`ModelMesh` over the ranks of a ``DeviceMesh`` with axes
    ``("data", "model")`` or ``("pod", "data", "model")``, whose
    collectives run on ``dm``'s groups (made when first used) and whose
    blocks live on ``dm``'s device type."""
    names = tuple(dm.mesh_dim_names or ())
    if names not in (MESH_AXES, POD_MESH_AXES):
        raise ValueError(f"a model mesh needs axes {MESH_AXES} or "
                         f"{POD_MESH_AXES}, got {names}")
    backend = str(dist.get_backend())
    if backend not in BACKENDS:
        raise ValueError(f"unsupported backend {backend!r}; the mesh runs "
                         f"on {BACKENDS}")
    grid = dm.mesh.reshape(-1, dm.mesh.shape[-1]).tolist()
    pods = dm.mesh.shape[0] if names == POD_MESH_AXES else 1
    mesh = ModelMesh(tuple(tuple(int(r) for r in row) for row in grid),
                     dist.get_rank(), torch.device(dm.device_type), backend,
                     pods=pods, device_mesh=dm)
    for n in range(1, len(names) + 1):
        for axes in itertools.combinations(names, n):
            mesh._group(axes)
    return mesh


def _mesh_group_sets(ranks, pods: int = 1) -> List[Tuple[int, ...]]:
    """Every group of a mesh in one fixed order (the whole mesh, each
    data row, each model column; on a 3-D mesh then every other set of
    axes), each rank set once, none of one rank."""
    rows = [tuple(row) for row in ranks]
    cols = [tuple(row[j] for row in ranks) for j in range(len(ranks[0]))]
    sets = [tuple(r for row in rows for r in row)] + rows + cols
    if pods > 1:
        view = ModelMesh(tuple(rows), rows[0][0], torch.device("cpu"),
                         pods=pods)
        for n in (1, 2):
            for axes in itertools.combinations(POD_MESH_AXES, n):
                for r in view._coord_map:
                    view.rank = r
                    sets.append(view.group_ranks(axes))
    out = []
    for s in sets:
        if len(s) > 1 and s not in out:
            out.append(s)
    return out


def make_model_mesh(shape: Tuple[int, ...], ranks: Optional[Sequence[int]] =
                    None, device=None) -> Optional[ModelMesh]:
    """A :class:`ModelMesh` of ``shape = (data, model)`` or ``(pod, data,
    model)`` over the default group (its ranks must be the world size),
    or over ``ranks``, a subset of it (:func:`repro_torch.distributed.
    elastic.make_elastic_mesh`'s survivors), laid out row by row in
    ascending order.  Over the whole group every rank makes every group
    in one order; over a subset only its members take part
    (``new_group``'s local synchronisation), and a rank outside it gets
    None.  Blocks live on ``device`` (default the card)."""
    if not dist.is_initialized():
        raise RuntimeError("make_model_mesh needs an initialised process "
                           "group (repro_torch.distributed.init_group)")
    if len(shape) not in (2, 3):
        raise ValueError(f"a mesh shape is (data, model) or (pod, data, "
                         f"model), got {shape}")
    pods = shape[0] if len(shape) == 3 else 1
    D, M = shape[-2:]
    world = dist.get_world_size()
    subset = ranks is not None
    ranks = sorted(range(world) if ranks is None else ranks)
    if pods * D * M != len(ranks) or (not subset and len(ranks) != world):
        raise ValueError(f"a {tuple(shape)} mesh over {len(ranks)} ranks "
                         f"(world size {world})")
    backend = str(dist.get_backend())
    if backend not in BACKENDS:
        raise ValueError(f"unsupported backend {backend!r}; the mesh runs "
                         f"on {BACKENDS}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an nccl mesh needs a CUDA device, got {dev}")
    grid = tuple(tuple(ranks[i * M:(i + 1) * M]) for i in range(pods * D))
    me = dist.get_rank()
    groups = {}
    for s in _mesh_group_sets(grid, pods):
        if subset and me not in s:
            continue
        g = dist.new_group(list(s), use_local_synchronization=subset)
        if me in s:
            groups[s] = g
    if me not in ranks:
        return None
    return ModelMesh(grid, me, dev, backend, groups, pods=pods)


_RULES: contextvars.ContextVar = contextvars.ContextVar("axis_rules",
                                                        default=None)
_MESH: contextvars.ContextVar = contextvars.ContextVar("model_mesh",
                                                       default=None)
_NOTES: contextvars.ContextVar = contextvars.ContextVar("mesh_notes",
                                                        default=None)


@contextlib.contextmanager
def axis_rules(rules: Optional[Mapping[str, AxisVal]],
               mesh: Optional[ModelMesh] = None):
    """Install a rule table and a mesh for the code inside."""
    tok = _RULES.set(rules)
    tok_m = _MESH.set(mesh)
    try:
        yield
    finally:
        _RULES.reset(tok)
        _MESH.reset(tok_m)


def current_mesh() -> Optional[ModelMesh]:
    return _MESH.get()


def current_rules() -> Optional[Mapping[str, AxisVal]]:
    return _RULES.get()


def data_axis_names() -> tuple:
    """Concrete mesh axes behind the logical batch/data axis."""
    rules = _RULES.get()
    if rules is None:
        return ()
    v = rules.get("batch")
    if v is None:
        return ()
    return (v,) if isinstance(v, str) else tuple(v)


def logical_to_spec(*names: Optional[str]) -> tuple:
    """The spec (a tuple, ``()`` without rules) the names resolve to."""
    rules = _RULES.get()
    if rules is None:
        return ()
    resolved = []
    for n in names:
        r = None if n is None else rules.get(n)
        resolved.append(tuple(r) if isinstance(r, (list, tuple)) else r)
    return tuple(resolved)


def constrain(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """``repro``'s sharding hint.  With rules the names are resolved, and
    with a mesh checked against it, as ``with_sharding_constraint``
    checks them.  A plain tensor is returned as it is; a DTensor is
    redistributed to the resolved spec (a mesh axis that does not divide
    its dimension dropped, see :func:`fix_spec`), as
    ``with_sharding_constraint`` reshards."""
    if _RULES.get() is None:
        return x
    if len(names) > x.dim():
        raise ValueError(f"{len(names)} names for a tensor of "
                         f"{x.dim()} dimensions")
    spec = logical_to_spec(*names)
    mesh = _MESH.get()
    if mesh is not None:
        for axes in spec:
            mesh.axes(axes)
    if is_dtensor(x):
        return _redistribute(x, spec, names)
    return x


def place(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """A tensor the code makes itself (every rank the same value, a cache
    buffer) as a DTensor placed by ``names`` when the installed mesh
    stands on a ``DeviceMesh``: each rank keeps its block, no collective.
    Anywhere else ``x`` itself (a DTensor is constrained)."""
    if is_dtensor(x):
        return constrain(x, *names)
    mesh = _MESH.get()
    if (_RULES.get() is None or mesh is None
            or getattr(mesh, "device_mesh", None) is None):
        return x
    dm = mesh.device_mesh
    spec = _fixed(logical_to_spec(*names), x.shape, dm, names)
    return as_dtensor(x, dm, spec_placements(spec, dm))


def as_dtensor(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """``x`` (the whole tensor, the same on every rank) as a DTensor on the
    ``DeviceMesh`` ``mesh`` under ``placements``: this rank keeps its block,
    cut by ``narrow`` (the mesh axes that split one dimension in mesh
    order, the first the outer split), with no collective.  The splits must
    be even (``fix_spec`` keeps only dividing axes).  It cuts only this
    rank's block, where ``distribute_tensor`` cuts every rank's."""
    from torch.distributed.tensor import DTensor, Shard

    local, coord = x, mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.shape[i]
            if local.shape[p.dim] % n:
                raise ValueError(f"dimension {p.dim} of {tuple(x.shape)} "
                                 f"does not split {n} ways")
            size = local.shape[p.dim] // n
            local = local.narrow(p.dim, coord[i] * size, size)
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


@contextlib.contextmanager
def collect_notes():
    """Collect what :func:`note` writes inside (a list, each line once)."""
    notes: List[str] = []
    tok = _NOTES.set(notes)
    try:
        yield notes
    finally:
        _NOTES.reset(tok)


def note(msg: str) -> None:
    """Write down a layout choice (a resharding the partitioner makes) for
    the :func:`collect_notes` around it; nothing outside one."""
    notes = _NOTES.get()
    if notes is not None and msg not in notes:
        notes.append(msg)


def _axes_of(entry: AxisVal) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def fix_spec(spec: Sequence[AxisVal], shape: Sequence[int],
             sizes: Mapping[str, int]) -> tuple:
    """``repro``'s ``_fix_spec``: each dimension keeps the longest prefix
    of its mesh axes whose size product divides it (and is at most it);
    ``sizes`` maps a mesh axis to its size."""
    fixed = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            fixed.append(entry)
            continue
        axes = list(_axes_of(entry))
        while axes:
            prod = 1
            for a in axes:
                prod *= sizes[a]
            if shape[i] % prod == 0 and shape[i] >= prod:
                break
            axes.pop()
        fixed.append(None if not axes else
                     (tuple(axes) if len(axes) != 1 else axes[0]))
    return tuple(fixed)


def spec_placements(spec: Sequence[AxisVal], mesh) -> list:
    """DTensor placements on ``mesh`` (a ``DeviceMesh``), one a mesh axis,
    of a spec: ``Shard(d)`` on every axis of more than one rank that
    splits dimension ``d`` (axes of one dimension in mesh order, so the
    first is the outer split, row-major as ``repro``'s), ``Replicate()``
    elsewhere (an axis of one rank splits nothing)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for a in _axes_of(entry):
            i = names.index(a)
            if mesh.shape[i] > 1:
                out[i] = Shard(dim)
    return out


def grad_placements(held: Sequence, work: Sequence) -> list:
    """The placements of the gradient of a ``local_map`` input held under
    ``held`` in a body whose work (its tokens, its batch) is split under
    ``work``: the input's own split on an axis that splits it; a partial
    sum on an axis that splits only the work (each rank's share of the
    gradient); whole elsewhere (every rank computed the same one)."""
    from torch.distributed.tensor import Partial, Shard

    return [h if isinstance(h, Shard) else
            (Partial() if isinstance(w, Shard) else h)
            for h, w in zip(held, work)]


def pinned(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself; on a DTensor, its gradient is redistributed to ``x``'s
    own placements on the way back.  DTensor hands a gradient back in the
    layout the operation that used ``x`` chose, and a backward that
    flattens two split dimensions into one (a linear layer's weight
    gradient) cannot take every layout."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(x.placements)
    return local_map(lambda t: t, out_placements=list(pl), in_placements=(pl,),
                     device_mesh=x.device_mesh)(x)


def _fixed(spec, shape, dm, names) -> tuple:
    sizes = dict(zip(dm.mesh_dim_names, dm.shape))
    fixed = fix_spec(spec, shape, sizes)
    for dim, (want, got) in enumerate(zip(spec, fixed)):
        if _axes_of(want) != _axes_of(got):
            note(f"{'/'.join(str(n) for n in names)} on "
                 f"{tuple(shape)}: dim {dim} keeps {got} of {want} "
                 f"(size {shape[dim]} does not split further)")
    return fixed


def _redistribute(x, spec, names):
    dm = x.device_mesh
    want = spec_placements(_fixed(spec, x.shape, dm, names), dm)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(dm, want)


def gathered(x: torch.Tensor) -> torch.Tensor:
    """The whole of a DTensor on this rank, as a plain tensor (an
    all-gather over every axis that splits it)."""
    from torch.distributed.tensor import Replicate

    full = [Replicate()] * x.device_mesh.ndim
    return x.redistribute(x.device_mesh, full).to_local()


def whole_units(x: torch.Tensor, dim: int, unit: int,
                what: str) -> torch.Tensor:
    """``x`` with dimension ``dim`` held in whole units of ``unit`` (the
    heads of a ``(..., H * dh)`` projection before its split into ``(...,
    H, dh)``): on a DTensor whose block of ``dim`` is not a whole number
    of units, that dimension is gathered first (written down by
    :func:`note`); anything else is returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim = dim % x.dim()
    pl = list(x.placements)
    split = [i for i, p in enumerate(pl) if p == Shard(dim)]
    n = 1
    for i in split:
        n *= x.device_mesh.shape[i]
    if n == 1 or (x.shape[dim] % n == 0 and (x.shape[dim] // n) % unit == 0):
        return x
    note(f"{what}: a block of {x.shape[dim]} / {n} is not whole units of "
         f"{unit}; gathered before the split")
    for i in split:
        pl[i] = Replicate()
    return x.redistribute(x.device_mesh, pl)


def axis_size(logical: str) -> int:
    """Product of the mesh-axis sizes a logical name maps to (1 outside a
    mesh)."""
    rules, mesh = _RULES.get(), _MESH.get()
    if rules is None or mesh is None:
        return 1
    val = rules.get(logical)
    if val is None:
        return 1
    size = 1
    for n in ((val,) if isinstance(val, str) else tuple(val)):
        size *= mesh.shape.get(n, 1)
    return size


def model_axis_name() -> Optional[str]:
    """Concrete mesh-axis name for the logical 'model' axis (or None)."""
    rules = _RULES.get()
    if rules is None:
        return None
    v = rules.get("model")
    if isinstance(v, (list, tuple)):
        return v[0] if v else None
    return v


def local_block(x: torch.Tensor, spec: Sequence[AxisVal],
                mesh: ModelMesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec`` (a view;
    dimensions past the spec are whole)."""
    for dim, axes in enumerate(spec):
        n = mesh.axis_size(axes)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of shape {tuple(x.shape)} "
                             f"does not split {n} ways over {axes}")
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.axis_index(axes) * size, size)
    return x


def gather_block(x: torch.Tensor, spec: Sequence[AxisVal],
                 mesh: ModelMesh) -> torch.Tensor:
    """The whole tensor from every rank's block ``x`` under ``spec``: one
    all-gather a sharded dimension (collective: every rank of those axes
    calls it)."""
    for dim, axes in enumerate(spec):
        if mesh.axis_size(axes) > 1:
            x = torch.cat(mesh.all_gather(x, axes).unbind(0), dim)
    return x


def reblock(x: torch.Tensor, held: Sequence[AxisVal],
            want: Sequence[AxisVal], mesh: ModelMesh) -> torch.Tensor:
    """This rank's block under ``want`` from its block ``x`` under
    ``held``: ``x`` itself where the two specs place it alike, else a
    gather to whole and a slice, as GSPMD reshards a ``shard_map``
    operand on entry."""
    def norm(spec):  # the same on every rank: no rank gathers alone
        return [tuple(a for a in mesh.axes(x) if mesh.shape[a] > 1)
                for x in spec]

    if norm(held) == norm(want):
        return x
    return local_block(gather_block(x, held, mesh), want, mesh)


# ---------------------------------------------------------------------------
# Ranks as subprocesses
# ---------------------------------------------------------------------------


class RankError(RuntimeError):
    """A rank of :func:`spawn_ranks` failed or passed its time limit; the
    others were ended.  ``rank`` is the failing rank, ``stderr`` the end
    of its error output, ``tails`` every rank's (``{rank: tail}``), all of
    them in the message: a peer's tail often says why the failing rank
    waited or aborted."""

    def __init__(self, msg: str, rank: int, stderr: str,
                 tails: Optional[dict] = None):
        self.rank, self.stderr = rank, stderr
        self.tails = tails if tails is not None else {rank: stderr}
        super().__init__(msg + "".join(
            f"\n--- rank {r} stderr (tail) ---\n{t}"
            for r, t in sorted(self.tails.items())))


def rank_env(world_size: int = 1, extra: Optional[dict] = None) -> dict:
    """The environment of a rank process: this one's, with the port's
    source directory on ``PYTHONPATH`` and, unless set, the loopback
    interface for gloo's and NCCL's sockets (the ranks run on this host)
    and an equal share of the host's cores for each rank's CPU threads
    (``OMP_NUM_THREADS``), so ``world_size`` ranks do not oversubscribe
    them."""
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    env.setdefault("OMP_NUM_THREADS",
                   str(max(1, (os.cpu_count() or 1) // world_size)))
    env.update(extra or {})
    return env


def spawn_ranks(argv: Callable[[int], Sequence[str]], world_size: int,
                timeout_s: float, env: Optional[dict] = None,
                cwd=None, tails: Optional[list] = None) -> List[str]:
    """Run ``world_size`` processes ``[sys.executable, *argv(rank)]``
    together and wait for all of them, at most ``timeout_s`` seconds in
    all.  Returns each rank's standard output.  When one exits non-zero
    or the time runs out, every rank still running is ended (terminate,
    then kill) and :class:`RankError` carries the failing rank's and
    every other rank's stderr tail.  ``tails``, when given, receives each
    rank's stderr tail in rank order either way (a caller that checks the
    ranks' results puts them in its own failure message)."""
    procs, files = [], []
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        for r in range(world_size):
            out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
            files.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, *argv(r)], stdout=out, stderr=err,
                stdin=subprocess.DEVNULL, env=env or rank_env(world_size),
                cwd=cwd))
        while failed is None:
            rcs = [p.poll() for p in procs]
            bad = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if bad:
                failed = (bad[0], f"rank {bad[0]} of {world_size} exited "
                                  f"with code {rcs[bad[0]]}")
            elif all(rc == 0 for rc in rcs):
                break
            elif time.monotonic() > deadline:
                late = next(r for r, rc in enumerate(rcs) if rc is None)
                failed = (late, f"rank {late} of {world_size} passed its "
                                f"time limit of {timeout_s:.0f} s")
            else:
                time.sleep(0.02)
    finally:
        _end(procs)
    texts = []
    for out, err in files:
        out.seek(0)
        err.seek(0)
        texts.append((out.read().decode(errors="replace"),
                      err.read().decode(errors="replace")))
        out.close()
        err.close()
    ends = [e[-4000:] for _, e in texts]
    if tails is not None:
        tails[:] = ends
    if failed is not None:
        r, msg = failed
        raise RankError(msg, r, ends[r], dict(enumerate(ends)))
    return [o for o, _ in texts]


def _end(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
