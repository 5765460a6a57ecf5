"""Candidate-sharded execution over ``torch.distributed`` (the torch
counterpart of ``repro.distributed``, candidate axis only; the LM axis
rules are ROADMAP item 12c): ``CandidateMesh`` and its collectives,
``init_group``, ``leave_group``, ``make_mesh`` and ``spawn_ranks``
(``repro_torch.distributed.context``); and the fault-tolerance policies
the trainer feeds (``repro_torch.distributed.fault_tolerance``).
``repro``'s ``elastic`` mesh rebuild waits for the model-parallel mesh
(ROADMAP item 12c)."""
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
from repro_torch.distributed.fault_tolerance import (
    HeartbeatMonitor,
    HostState,
    RestartBudget,
    StragglerPolicy,
)

__all__ = [
    "BACKENDS",
    "CandidateMesh",
    "HeartbeatMonitor",
    "HostState",
    "RankError",
    "RestartBudget",
    "StragglerPolicy",
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
