"""Adaptive repartitioning: live workload tracking, drift detection,
budget-bounded shard migration and hot cut-edge replication.

  stats.py        WorkloadTracker — sliding-window per-template frequencies,
                  observed cut-join counts, per-shard load from served
                  requests (the server's shard-load gauges read it)
  drift.py        DriftDetector — frequency-divergence threshold + unseen-
                  template triggers, graded none/incremental/full
  repartition.py  incremental greedy unit moves under a migration budget
                  (frequency-weighted _unit_move_delta), full wawpart re-run
                  fallback for large drift
  migrate.py      MigrationPlan — per-shard triple deltas applied to the
                  ShardedKG (WorkloadServer.migrate owns the epoch bump)
  replicate.py    plan_hot_replication — the hottest safe cut features to
                  copy onto their queries' primary shards under a triple
                  budget (WorkloadServer.replicate_hot applies it)
  controller.py   AdaptiveController — glues the above into WorkloadServer
"""
from repro_torch.adaptive.controller import AdaptiveConfig, AdaptiveController
from repro_torch.adaptive.drift import DriftDetector, DriftReport
from repro_torch.adaptive.migrate import MigrationPlan
from repro_torch.adaptive.repartition import (RepartitionResult,
                                              full_repartition,
                                              incremental_repartition)
from repro_torch.adaptive.stats import (WorkloadSnapshot, WorkloadTracker,
                                        plan_shards)

__all__ = [
    "AdaptiveConfig", "AdaptiveController", "DriftDetector", "DriftReport",
    "MigrationPlan", "RepartitionResult", "WorkloadSnapshot",
    "WorkloadTracker", "full_repartition", "incremental_repartition",
    "plan_shards",
]
