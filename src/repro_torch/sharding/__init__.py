"""Placement of the engines' tensors on the shard mesh."""
