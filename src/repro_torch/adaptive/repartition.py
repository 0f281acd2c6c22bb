"""Incremental, budget-bounded repartitioning (Harbi et al. direction).

A full Algorithm-2 re-run answers drift with a brand-new placement — and an
unbounded amount of data movement. The incremental path instead descends the
*frequency-weighted* placement objective by greedy unit moves, each scored
with `core.partitioner._unit_move_delta` under the observed query weights,
subject to:

  * migration budget — total triples moved <= budget_frac * dataset size;
  * balance — a move may not push shard imbalance beyond tolerance (or make
    an already-out-of-tolerance placement worse);
  * strict improvement — only moves with negative weighted traffic delta.

Unseen templates (features outside the catalog) cannot be helped by unit
moves; `full_repartition` rebuilds the catalog from the updated query set
and re-runs wawpart with the observed weights (the AWAPart fallback).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.features import DataUnit, query_features
from repro_torch.core.partitioner import (Partitioning, _placement_cost,
                                    _query_units, wawpart_partition)
from repro_torch.kg.query import Query
from repro_torch.kg.triples import TripleStore


@dataclass
class RepartitionResult:
    part: Partitioning              # the proposed placement
    mode: str                       # "incremental" | "full" | "noop"
    moved_units: list[DataUnit] = field(default_factory=list)
    moved_triples: int = 0
    budget_triples: int = 0
    cost_before: float = 0.0        # weighted placement cost
    cost_after: float = 0.0

    @property
    def improved(self) -> bool:
        return self.cost_after < self.cost_before


def _active_units(part: Partitioning, queries: list[Query],
                  query_weights: dict[str, float]) -> list[DataUnit]:
    """Units touched by queries the workload actually asks — the only moves
    that can change the weighted objective."""
    cat = part.catalog
    active: set[DataUnit] = set()
    for q in queries:
        if query_weights.get(q.name, 0.0) <= 0.0:
            continue
        for f in query_features(q):
            active.update(cat.feature_units.get(f, ()))
    return sorted(u for u in active
                  if u in part.unit_shard and cat.sizes.get(u, 0) > 0)


def _edge_index(queries: list[Query], cat,
                query_weights: dict[str, float],
                ) -> dict[DataUnit, list[tuple[float, frozenset[DataUnit]]]]:
    """unit -> weighted join edges touching it: (traffic weight, unit set).

    Same per-edge weights as core's `_unit_move_delta` (smaller side's data
    size x query frequency), but materialized once — the greedy loop scores
    |active units| x (n_shards-1) candidate moves per iteration, and
    re-deriving every query's pattern-unit sets for each score would sit
    directly on the serving path (drift responses run between batches).
    """
    index: dict[DataUnit, list[tuple[float, frozenset[DataUnit]]]] = {}
    for q in queries:
        w_q = float(query_weights.get(q.name, 0.0))
        if w_q <= 0.0:
            continue
        pu = dict(_query_units(q, cat))
        for i, j, _k in q.join_edges():
            us = pu[i] | pu[j]
            side_i = sum(cat.sizes.get(x, 0) for x in pu[i])
            side_j = sum(cat.sizes.get(x, 0) for x in pu[j])
            rec = (w_q * float(max(1, min(side_i, side_j))), us)
            for u in us:
                index.setdefault(u, []).append(rec)
    return index


def incremental_repartition(part: Partitioning, queries: list[Query],
                            query_weights: dict[str, float], *,
                            budget_frac: float = 0.10,
                            balance_tol: float = 0.15,
                            max_moves: int = 256) -> RepartitionResult:
    """Greedy steepest-descent unit moves under a triple-movement budget.

    Returns a new Partitioning sharing the input's catalog (same data units,
    new unit->shard map). mode="noop" when no affordable improving move
    exists — callers skip migration entirely in that case.
    """
    if not 0.0 <= budget_frac <= 1.0:
        raise ValueError(f"budget_frac must be in [0, 1], got {budget_frac}")
    cat = part.catalog
    n_shards = part.n_shards
    unit_shard = dict(part.unit_shard)
    sizes = part.shard_sizes.astype(np.int64).copy()
    total = int(sizes.sum())
    budget = int(budget_frac * total)
    mean = total / max(1, n_shards)

    def imbalance(sz: np.ndarray) -> float:
        return float(np.abs(sz - mean).max() / max(mean, 1.0))

    cost_before = _placement_cost(queries, cat, unit_shard, query_weights)
    cands = _active_units(part, queries, query_weights)
    edges = _edge_index(queries, cat, query_weights)
    moved: set[DataUnit] = set()
    moved_order: list[DataUnit] = []
    moved_triples = 0

    def move_delta(u: DataUnit, dst: int) -> float:
        """core _unit_move_delta against the precomputed edge index."""
        delta = 0.0
        for w, us in edges.get(u, ()):
            before = {unit_shard.get(x, -1) for x in us}
            after = {dst if x == u else unit_shard.get(x, -1) for x in us}
            was_local = len(before) == 1 and -1 not in before
            now_local = len(after) == 1 and -1 not in after
            if was_local != now_local:
                delta += w if was_local else -w
        return delta

    for _ in range(max_moves):
        if n_shards < 2:
            break
        cur_imb = imbalance(sizes)
        best = None   # (delta, size, unit, dst)
        for u in cands:
            if u in moved:
                continue
            u_size = cat.sizes.get(u, 0)
            if moved_triples + u_size > budget:
                continue
            src = unit_shard[u]
            for dst in range(n_shards):
                if dst == src:
                    continue
                after = sizes.copy()
                after[src] -= u_size
                after[dst] += u_size
                new_imb = imbalance(after)
                if new_imb > balance_tol + 1e-9 and new_imb > cur_imb:
                    continue
                delta = move_delta(u, dst)
                if delta >= -1e-9:
                    continue
                key = (delta, u_size, u, dst)
                if best is None or key < best:
                    best = key
        if best is None:
            break
        _, u_size, u, dst = best
        src = unit_shard[u]
        unit_shard[u] = dst
        sizes[src] -= u_size
        sizes[dst] += u_size
        moved.add(u)
        moved_order.append(u)
        moved_triples += u_size

    cost_after = _placement_cost(queries, cat, unit_shard, query_weights)
    new_part = Partitioning(
        n_shards, unit_shard, cat, sizes, method="wawpart",
        meta={**part.meta, "query_weights": dict(query_weights),
              "adapted_from": part.method,
              "moves": [repr(u) for u in moved_order]})
    return RepartitionResult(
        part=new_part, mode="incremental" if moved_order else "noop",
        moved_units=moved_order, moved_triples=moved_triples,
        budget_triples=budget, cost_before=cost_before,
        cost_after=cost_after)


def full_repartition(store: TripleStore, queries: list[Query],
                     query_weights: dict[str, float], *,
                     n_shards: int, balance_tol: float = 0.15,
                     old_part: Partitioning | None = None,
                     ) -> RepartitionResult:
    """Full wawpart re-run on the updated query set with observed weights —
    the large-drift fallback. Rebuilds the unit catalog, so templates unseen
    by the old partitioning get real data units. moved_triples is computed
    against old_part when given (full re-runs are not budget-bounded; the
    caller decides whether the movement is worth it)."""
    part = wawpart_partition(store, queries, n_shards=n_shards,
                             balance_tol=balance_tol,
                             query_weights=query_weights)
    moved = 0
    cost_before = cost_after = 0.0
    if old_part is not None:
        moved = int((old_part.assign_triples() != part.assign_triples()).sum())
        cost_before = _placement_cost(queries, old_part.catalog,
                                      old_part.unit_shard, query_weights)
        cost_after = _placement_cost(queries, part.catalog, part.unit_shard,
                                     query_weights)
    return RepartitionResult(part=part, mode="full", moved_triples=moved,
                             budget_triples=len(store),
                             cost_before=cost_before, cost_after=cost_after)
