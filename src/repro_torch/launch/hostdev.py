"""A fake world of ranks in one process (the torch counterpart of
``repro.launch.hostdev``, which forces XLA's host device count).

``repro``'s dry run makes 512 host devices by an XLA flag set before
jax starts.  The port's dry run joins a process group on
``torch.testing``'s fake backend instead: every collective returns at
once, without moving data, so this one process runs as ``rank`` of a
world of ``world_size`` ranks and sees the collectives that rank calls.
Only the dry-run entry point (``repro_torch.launch.dryrun``) fakes
ranks; everything else joins a real group
(``repro_torch.distributed.init_group``).
"""
from __future__ import annotations

import torch.distributed as dist


def fake_world(world_size: int, rank: int = 0) -> None:
    """Join a fake process group of ``world_size`` ranks as ``rank``.
    Refuses when this process already has a group."""
    if dist.is_initialized():
        raise RuntimeError(
            "a process group is already initialised; only the dry run "
            "fakes its world, in a process of its own")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
