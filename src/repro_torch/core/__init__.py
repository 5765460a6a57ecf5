"""The paper's primary contribution, ported to PyTorch: fast greedy DPP
MAP inference ("Div-DPP"), the kernel construction, the sliding-window
variant and the ``GreedySpec`` front door.

Also the resumable streaming layer (``streaming.py``: ``GreedyState``,
init/step/chunk, the slot substrate and the session delta updates) and
its generator ``greedy_map_chunks``.

And the evaluation side of the paper's §5: the naive determinant
greedy (``greedy_naive.py``: the float64 numpy oracle and the batched
``slogdet`` Figure-1 baseline), the reference diversifiers
(``baselines.py``: MMR, greedy-avg, Top-N, random) and the slate metrics
(``metrics.py``).

Not ported yet (ROADMAP queue 1): the sharded backend (item 9).
"""
from repro_torch.core.kernel_matrix import (
    build_kernel_dense,
    build_kernel_dense_raw,
    map_relevance,
    normalize_columns,
    scaled_features,
    scaled_features_raw,
    similarity_from_features,
)
from repro_torch.core.greedy_chol import (
    GreedyResult,
    dpp_greedy,
    dpp_greedy_dense,
    dpp_greedy_dense_batch,
    dpp_greedy_lowrank,
    dpp_greedy_lowrank_batch,
)
from repro_torch.core.windowed import (
    dpp_greedy_windowed,
    dpp_greedy_windowed_batch,
    dpp_greedy_windowed_lowrank,
    dpp_greedy_windowed_lowrank_batch,
)
from repro_torch.core.dispatch import (
    GreedySpec,
    GreedySpecError,
    greedy_map,
    greedy_map_chunks,
)
from repro_torch.core.greedy_naive import greedy_map_naive
from repro_torch.core.baselines import (
    greedy_avg_select,
    mmr_select,
    random_top_select,
    top_n_select,
)
from repro_torch.core.metrics import (
    log_det_objective,
    mean_slate_diversity,
    mean_slate_diversity_rows,
    recall_at_n,
    slate_diversity,
)
from repro_torch.core.streaming import (
    GreedyState,
    greedy_chunk,
    greedy_chunk_slots,
    greedy_init,
    greedy_slot_state,
    greedy_slots_init,
    greedy_state_extend,
    greedy_state_rescore,
    greedy_step,
    slot_pad_v,
    state_evict,
    state_splice,
)

__all__ = [
    "greedy_avg_select",
    "greedy_map_naive",
    "mmr_select",
    "log_det_objective",
    "mean_slate_diversity",
    "mean_slate_diversity_rows",
    "random_top_select",
    "recall_at_n",
    "slate_diversity",
    "top_n_select",
    "GreedyResult",
    "GreedySpec",
    "GreedySpecError",
    "GreedyState",
    "greedy_chunk",
    "greedy_chunk_slots",
    "greedy_init",
    "greedy_map",
    "greedy_map_chunks",
    "greedy_slot_state",
    "greedy_slots_init",
    "greedy_state_extend",
    "greedy_state_rescore",
    "greedy_step",
    "slot_pad_v",
    "state_evict",
    "state_splice",
    "dpp_greedy_windowed",
    "dpp_greedy_windowed_batch",
    "dpp_greedy_windowed_lowrank",
    "dpp_greedy_windowed_lowrank_batch",
    "build_kernel_dense",
    "build_kernel_dense_raw",
    "map_relevance",
    "normalize_columns",
    "scaled_features",
    "scaled_features_raw",
    "similarity_from_features",
    "dpp_greedy",
    "dpp_greedy_dense",
    "dpp_greedy_dense_batch",
    "dpp_greedy_lowrank",
    "dpp_greedy_lowrank_batch",
]
