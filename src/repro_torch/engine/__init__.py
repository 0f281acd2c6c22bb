"""Tensorized BGP query engine on PyTorch: planner, oracle, shard blocks,
scan/join primitives, the per-query federated engine (`local`,
`federated.make_engine` / `run_vmapped`) and the batched bucket engine."""
