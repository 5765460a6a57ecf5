from repro_torch.kernels.dpp_greedy.dpp_greedy import (
    dpp_greedy_kernel,
    dpp_greedy_resident,
    dpp_greedy_resident_plain,
    dpp_greedy_resident_windowed,
    dpp_greedy_resident_windowed_plain,
)
from repro_torch.kernels.dpp_greedy.ops import (
    dpp_greedy,
    dpp_greedy_stream_chunk,
    dpp_greedy_stream_init,
    dpp_greedy_stream_pad,
)
from repro_torch.kernels.dpp_greedy.ref import dpp_greedy_ref
from repro_torch.kernels.dpp_greedy.tiled import (
    dpp_greedy_tiled,
    eviction_coeffs,
    fused_chunk_exact,
    fused_chunk_exact_plain,
    fused_chunk_windowed,
    fused_chunk_windowed_plain,
    tiled_step_exact,
    tiled_step_exact_plain,
    tiled_step_windowed,
    tiled_step_windowed_plain,
)
from repro_torch.kernels.dpp_greedy.tiling import (
    SMEM_BUDGET_BYTES,
    TilePolicy,
    chunk_smem_bytes,
    chunk_v_resident,
    resident_smem_bytes,
    tiled_smem_bytes,
)

__all__ = [
    "dpp_greedy",
    "dpp_greedy_kernel",
    "dpp_greedy_ref",
    "dpp_greedy_resident",
    "dpp_greedy_resident_plain",
    "dpp_greedy_resident_windowed",
    "dpp_greedy_resident_windowed_plain",
    "dpp_greedy_stream_chunk",
    "dpp_greedy_stream_init",
    "dpp_greedy_stream_pad",
    "dpp_greedy_tiled",
    "eviction_coeffs",
    "fused_chunk_exact",
    "fused_chunk_exact_plain",
    "fused_chunk_windowed",
    "fused_chunk_windowed_plain",
    "tiled_step_exact",
    "tiled_step_exact_plain",
    "tiled_step_windowed",
    "tiled_step_windowed_plain",
    "SMEM_BUDGET_BYTES",
    "TilePolicy",
    "chunk_smem_bytes",
    "chunk_v_resident",
    "resident_smem_bytes",
    "tiled_smem_bytes",
]
