"""Atomic, asynchronous checkpoints in ``repro``'s on-disk layout (the
torch counterpart of ``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpointer import (
    Checkpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "Checkpointer",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
]
