"""Atomic step-directory checkpoints (mirrors ``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpoint import (
    CheckpointManager,
    latest_step,
    read_manifest,
    restore_leaves,
    restore_tree,
    save_leaves,
)

__all__ = ["CheckpointManager", "latest_step", "read_manifest", "restore_leaves",
           "restore_tree", "save_leaves"]
