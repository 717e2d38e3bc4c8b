"""Checkpoints of the port, in the JAX package's on-disk format."""
from .checkpoint import (cleanup_old, latest_step, restore_checkpoint,
                         save_checkpoint)

__all__ = ["cleanup_old", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
