"""Fault-tolerant checkpointing: step-atomic save/restore, in the
reference's file format."""
from repro_torch.checkpoint.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "CheckpointManager",
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
]
