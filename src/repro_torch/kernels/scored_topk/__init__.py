from repro_torch.kernels.scored_topk.ops import scored_topk
from repro_torch.kernels.scored_topk.ref import scored_topk_ref
from repro_torch.kernels.scored_topk.scored_topk import (
    launch_plan,
    scored_topk_blocks,
    scored_topk_blocks_plain,
    scored_topk_segments,
    scored_topk_segments_plain,
)

__all__ = [
    "launch_plan",
    "scored_topk",
    "scored_topk_blocks",
    "scored_topk_blocks_plain",
    "scored_topk_ref",
    "scored_topk_segments",
    "scored_topk_segments_plain",
]
