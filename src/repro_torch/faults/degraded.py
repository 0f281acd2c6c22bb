"""Replica-degraded placement: serve around a down shard, exactly.

The hot cut-edge replicas (`Partitioning.replicas`) are full per-unit
copies kept on extra shards for performance — here they double as spare
availability capacity (Peng et al.'s replicated fragments absorbing node
faults). When shard `down` stops answering:

* every unit whose **primary** home is `down` but which has a live
  replica re-homes onto its smallest live copy-holder (deterministic);
* every replica is **dropped** from the degraded placement — replicas
  are shard-granular and the owner-mask double-count rule
  (`Partitioning.can_replicate`) was proven against the *healthy*
  primary assignment, which the re-homing just changed. Degraded mode
  trades the replicas' gather savings for availability; correctness
  stays exact because the primary-only placement is unambiguous;
* units whose **only** copy lives on `down` stay (unreachably) assigned
  there and are returned as `lost` — templates routing through them
  cannot be answered exactly and must shed with a typed rejection.

The degraded `Partitioning` shares the healthy catalog, so plan/migration
unit resolution (`routing_units`) is identical on both sides, and every
covered template's re-planned answers are bit-identical to the healthy
run's: the same rows exist, they just moved to live shards.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.features import pattern_feature
from repro_torch.core.partitioner import Partitioning


def degraded_placement(part: Partitioning, down: int,
                       ) -> tuple[Partitioning, frozenset]:
    """(degraded placement, lost units) for `part` with shard `down` out.

    Raises ValueError when `down` is not a shard of this placement.
    The degraded placement is primary-only (``replicas={}``); `lost`
    holds the units whose only copy was on the down shard.
    """
    if not 0 <= down < part.n_shards:
        raise ValueError(f"shard {down} not in 0..{part.n_shards - 1}")
    unit_shard = dict(part.unit_shard)
    lost = set()
    for u, s in part.unit_shard.items():
        if s != down:
            continue
        live = sorted(t for t in part.replicas.get(u, ()) if t != down)
        if live:
            unit_shard[u] = live[0]
        else:
            lost.add(u)
    sizes = np.zeros(part.n_shards, dtype=np.int64)
    for u, s in unit_shard.items():
        sizes[s] += int(part.catalog.sizes.get(u, 0))
    degraded = Partitioning(part.n_shards, unit_shard, part.catalog,
                            sizes, method=part.method,
                            meta={**part.meta, "degraded_shard": down},
                            replicas={})
    return degraded, frozenset(lost)


def uncovered_templates(queries, part: Partitioning,
                        lost: frozenset) -> frozenset:
    """Template names that cannot be served exactly without `lost` units.

    A template is uncovered iff any of its patterns' routing units (the
    same `routing_units` resolution the planner uses) intersects the
    lost set — its plan could need rows whose only copy is unreachable.
    Everything else re-plans around the down shard and serves exactly.
    """
    shed = set()
    for q in queries:
        units: set = set()
        for pat in q.patterns:
            units.update(part.routing_units(pattern_feature(pat)))
        if units & lost:
            shed.add(q.name)
    return frozenset(shed)
