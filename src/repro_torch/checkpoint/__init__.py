"""Atomic step-directory checkpoints (mirrors ``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpoint import read_manifest, restore_leaves, save_leaves

__all__ = ["read_manifest", "restore_leaves", "save_leaves"]
