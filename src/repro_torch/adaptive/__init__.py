"""Workload tracking and shard migration for the serving path.

  stats.py        WorkloadTracker — sliding-window per-template frequencies,
                  observed cut-join counts, per-shard load from served
                  requests (the server's shard-load gauges read it)
  repartition.py  incremental greedy unit moves under a migration budget
                  (frequency-weighted _unit_move_delta), full wawpart re-run
                  fallback for large drift
  migrate.py      MigrationPlan — per-shard triple deltas applied to the
                  ShardedKG (WorkloadServer.migrate owns the epoch bump)

Drift detection, the adaptive controller and hot-edge replication are not
part of the port yet.
"""
from repro_torch.adaptive.migrate import MigrationPlan
from repro_torch.adaptive.repartition import (RepartitionResult,
                                              full_repartition,
                                              incremental_repartition)
from repro_torch.adaptive.stats import (WorkloadSnapshot, WorkloadTracker,
                                        plan_shards)

__all__ = [
    "MigrationPlan", "RepartitionResult", "WorkloadSnapshot",
    "WorkloadTracker", "full_repartition", "incremental_repartition",
    "plan_shards",
]
