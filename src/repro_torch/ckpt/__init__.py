"""Checkpoints in the reference's on-disk format (port of ``repro.ckpt``)."""
from .checkpoint import (CheckpointManager, CheckpointMismatchError,
                         CheckpointReader, restore_tree, save_tree)

__all__ = ["CheckpointManager", "CheckpointMismatchError",
           "CheckpointReader", "restore_tree", "save_tree"]
