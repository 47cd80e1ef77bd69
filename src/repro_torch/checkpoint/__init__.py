"""Checkpoints of the port's states (the port of ``repro.checkpoint``)."""
from .checkpoint import CheckpointManager, load_pytree, save_pytree

__all__ = ["CheckpointManager", "load_pytree", "save_pytree"]
