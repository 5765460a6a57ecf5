from repro_torch.kernels.fm_interaction.fm_interaction import (
    fm_interaction_kernel,
)
from repro_torch.kernels.fm_interaction.ops import fm_interaction
from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref

__all__ = [
    "fm_interaction",
    "fm_interaction_kernel",
    "fm_interaction_ref",
]
