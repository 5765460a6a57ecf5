from repro_torch.kernels.fm_interaction.fm_interaction import (
    FMInteraction,
    fm_interaction_bwd_kernel,
    fm_interaction_kernel,
)
from repro_torch.kernels.fm_interaction.ops import fm_interaction
from repro_torch.kernels.fm_interaction.ref import (
    fm_interaction_bwd_ref,
    fm_interaction_ref,
)

__all__ = [
    "FMInteraction",
    "fm_interaction",
    "fm_interaction_bwd_kernel",
    "fm_interaction_bwd_ref",
    "fm_interaction_kernel",
    "fm_interaction_ref",
]
