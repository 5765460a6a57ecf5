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
swapped on error.  gloo's all-gather does not take CUDA tensors, so
under gloo every collective of a CUDA mesh stages its few values
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
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

BACKENDS = ("nccl", "gloo")
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


def _staged(mesh: CandidateMesh, x: torch.Tensor) -> torch.Tensor:
    # gloo's all-gather takes host tensors only: stage on purpose
    if mesh.backend == "gloo" and x.is_cuda:
        return x.cpu()
    return x.contiguous()


def all_gather(mesh: CandidateMesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: ``(P, *x.shape)`` on
    ``x``'s device."""
    with _collective(mesh):
        y = _staged(mesh, x)
        if mesh.backend == "nccl":
            out = torch.empty((mesh.size,) + tuple(y.shape), dtype=y.dtype,
                              device=y.device)
            dist.all_gather_into_tensor(out, y, group=mesh.group)
        else:
            parts = [torch.empty_like(y) for _ in range(mesh.size)]
            dist.all_gather(parts, y, group=mesh.group)
            out = torch.stack(parts)
        return out.to(x.device)


def all_reduce_sum(mesh: CandidateMesh, x: torch.Tensor) -> torch.Tensor:
    """The element-wise sum of every rank's ``x``, on ``x``'s device."""
    with _collective(mesh):
        y = _staged(mesh, x)
        y = y.clone() if y is x else y
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.group)
        return y.to(x.device)


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
