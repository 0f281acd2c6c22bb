"""Tensorized BGP query engine on PyTorch: planner, oracle, shard blocks,
scan/join primitives and the batched bucket engine."""
