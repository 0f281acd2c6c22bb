"""Checkpoints in the reference's format (`checkpoint.manager`), and the
reference's state trees carried across (`tree_from_jax`)."""
from repro_torch.checkpoint.manager import CheckpointManager, tree_from_jax

__all__ = ["CheckpointManager", "tree_from_jax"]
