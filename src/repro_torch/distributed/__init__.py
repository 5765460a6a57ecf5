"""Candidate-sharded execution over ``torch.distributed`` (the torch
counterpart of ``repro.distributed``, candidate axis only; the LM axis
rules are ROADMAP item 12c): ``CandidateMesh`` and its collectives,
``init_group``, ``leave_group``, ``make_mesh`` and ``spawn_ranks``
(``repro_torch.distributed.context``)."""
from repro_torch.distributed.context import (
    BACKENDS,
    CandidateMesh,
    RankError,
    all_gather,
    all_reduce_sum,
    bcast_from_owner,
    gather_pairs,
    global_argmax,
    init_group,
    leave_group,
    make_mesh,
    rank_env,
    shard_bounds,
    spawn_ranks,
)

__all__ = [
    "BACKENDS",
    "CandidateMesh",
    "RankError",
    "all_gather",
    "all_reduce_sum",
    "bcast_from_owner",
    "gather_pairs",
    "global_argmax",
    "init_group",
    "leave_group",
    "make_mesh",
    "rank_env",
    "shard_bounds",
    "spawn_ranks",
]
