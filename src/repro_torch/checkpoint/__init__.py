"""Checkpoints in the reference's format (port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpointer import (
    CheckpointConfig,
    Checkpointer,
    ShardedCheckpointer,
    latest_step,
)

__all__ = ["CheckpointConfig", "Checkpointer", "ShardedCheckpointer", "latest_step"]
