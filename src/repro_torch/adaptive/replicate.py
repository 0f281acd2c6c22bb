"""Hot cut-edge replication planning (beyond-paper; Harbi et al. / Peng
et al. partial fragment allocation).

WawPart's placement is strictly partition-only — `assign_triples` places
every triple exactly once. A live workload still pays a cross-shard gather
for every *cut* pattern (one whose routing units live off the query's
primary shard). This module scores those cut features by observed query
weight per replicated triple and proposes copying the hottest ones onto the
primary shard, so the planner's covered-by-ppn check turns the gather off.

The safety analysis lives in `Partitioning.can_replicate`; this module only
decides *which* of the safe candidates are worth their bytes, under a
triple budget. `WorkloadServer.replicate_hot` applies a plan: rebuilds the
ShardedKG with the copies appended, re-plans only the affected queries, and
bumps the serving epoch (invalidating the answer cache).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.features import DataUnit, Feature, pattern_feature
from repro_torch.core.partitioner import Partitioning
from repro_torch.kg.query import Query


@dataclass(frozen=True)
class ReplicationCandidate:
    """One replicable cut feature: copy `units` onto shard `target` to make
    the queries in `queries` lose one cross-shard gather each."""
    feature: Feature
    target: int
    units: tuple[DataUnit, ...]     # routing units lacking a copy on target
    triples: int                    # bytes-on-the-wire proxy: rows copied
    weight: float                   # summed observed weight of the queries
    queries: tuple[str, ...]

    @property
    def score(self) -> float:
        """Gathers saved per replicated triple — same currency as the
        partitioner's q/s terms in score_replicated_feature."""
        return self.weight / max(1, self.triples)


@dataclass
class ReplicationReport:
    """What plan_hot_replication decided: every safe candidate, the greedy
    budget-bounded selection, and the merged `replicas` map ready for
    `Partitioning.with_replicas` (empty when nothing scored under budget)."""

    candidates: list[ReplicationCandidate]
    chosen: list[ReplicationCandidate]
    replicas: dict[DataUnit, tuple[int, ...]] = field(default_factory=dict)
    budget_triples: int = 0

    @property
    def total_triples(self) -> int:
        """Rows the chosen replicas copy (the spent part of the budget)."""
        return sum(c.triples for c in self.chosen)


def _primary_shard(part: Partitioning, q: Query) -> tuple[int, list]:
    """Replicate the planner's routing: per-pattern primary homes and the
    ppn choice (most single-home patterns, lowest shard id breaks ties)."""
    homes = []
    for pat in q.patterns:
        units = [u for u in part.routing_units(pattern_feature(pat))
                 if u in part.unit_shard]
        homes.append((pat, tuple(units),
                      frozenset(part.unit_shard[u] for u in units)))
    counts = [0] * part.n_shards
    for _, _, h in homes:
        if len(h) == 1:
            counts[next(iter(h))] += 1
    ppn = max(range(part.n_shards), key=lambda s: (counts[s], -s))
    return ppn, homes


def score_hot_cut_features(part: Partitioning, queries: list[Query],
                           query_weights: dict[str, float] | None = None,
                           ) -> list[ReplicationCandidate]:
    """All safe replication candidates over the workload's cut patterns,
    hottest first. query_weights defaults to the paper's uniform
    1-per-query; a live deployment feeds WorkloadTracker counts instead."""
    acc: dict[tuple, dict] = {}
    for q in queries:
        w = 1.0 if query_weights is None else float(
            query_weights.get(q.name, 0.0))
        if w <= 0.0:
            continue
        ppn, homes = _primary_shard(part, q)
        for pat, units, h in homes:
            if not units or h <= {ppn}:
                continue            # local step: no gather to remove
            missing = tuple(u for u in units
                            if ppn not in part.unit_copies(u))
            if not all(part.can_replicate(u, ppn) for u in missing):
                continue
            key = (pattern_feature(pat), ppn, missing)
            ent = acc.setdefault(key, {"weight": 0.0, "queries": []})
            ent["weight"] += w
            ent["queries"].append(q.name)
    out = []
    for (feat, ppn, missing), ent in acc.items():
        triples = sum(part.catalog.sizes.get(u, 0) for u in missing)
        out.append(ReplicationCandidate(
            feature=feat, target=ppn, units=missing, triples=triples,
            weight=ent["weight"], queries=tuple(sorted(set(ent["queries"])))))
    out.sort(key=lambda c: (-c.score, c.triples, str(c.feature)))
    return out


def plan_hot_replication(part: Partitioning, queries: list[Query],
                         query_weights: dict[str, float] | None = None, *,
                         top_k: int = 4, budget_frac: float = 0.25,
                         ) -> ReplicationReport:
    """Greedy selection of the hottest safe candidates under a triple
    budget (`budget_frac` of the store). Returns the merged replicas map
    ready for `Partitioning.with_replicas`."""
    cands = score_hot_cut_features(part, queries, query_weights)
    budget = int(budget_frac * len(part.catalog.store))
    chosen: list[ReplicationCandidate] = []
    replicas: dict[DataUnit, set[int]] = {}
    spent = 0
    for c in cands:
        if len(chosen) >= top_k:
            break
        new_units = [u for u in c.units
                     if c.target not in replicas.get(u, set())
                     and c.target not in part.unit_copies(u)]
        cost = sum(part.catalog.sizes.get(u, 0) for u in new_units)
        if spent + cost > budget:
            continue
        for u in new_units:
            replicas.setdefault(u, set()).add(c.target)
        spent += cost
        chosen.append(c)
    return ReplicationReport(
        candidates=cands, chosen=chosen,
        replicas={u: tuple(sorted(ts)) for u, ts in sorted(replicas.items())},
        budget_triples=budget)
