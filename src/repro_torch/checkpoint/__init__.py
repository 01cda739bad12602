"""Checkpoints of the port (``repro.checkpoint``' twin), in the reference's
on-disk format."""
from .checkpoint import (CheckpointManager, latest_step, load_checkpoint,
                         save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "load_checkpoint",
           "save_checkpoint"]
