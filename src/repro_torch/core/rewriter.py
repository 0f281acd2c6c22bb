"""Federated query rewriting (paper §3.2, Table 1).

Given a partitioning, each query is routed to the Primary Processing Node
(PPN) — the shard holding the most of its patterns' data — and every pattern
whose data lives elsewhere becomes a SERVICE block against that shard's
endpoint. Queries fully covered by one shard are not rewritten. The plan also
carries the distributed-join count (the paper's objective) and feeds the
tensorized engine, where SERVICE == an all-gather across the shard axis.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.features import pattern_feature
from repro_torch.core.partitioner import Partitioning
from repro_torch.kg.query import Query, TriplePattern, Var


@dataclass
class FederatedPlan:
    query: Query
    ppn: int
    pattern_homes: list[frozenset[int]]      # shards holding each pattern's data
    remote_patterns: dict[int, tuple[int, ...]] = field(default_factory=dict)
    n_distributed_joins: int = 0
    n_service_blocks: int = 0

    @property
    def is_local(self) -> bool:
        return self.n_service_blocks == 0


def rewrite(q: Query, part: Partitioning) -> FederatedPlan:
    cat = part.catalog
    homes: list[frozenset[int]] = []
    for pat in q.patterns:
        f = pattern_feature(pat)
        units = cat.feature_units.get(f)
        if units is None:
            # unseen query (not in the analyzed workload): fall back to the
            # units of the same predicate
            units = tuple(u for u in part.unit_shard if u.p == f.p)
        homes.append(frozenset(part.unit_shard[u] for u in units
                               if u in part.unit_shard))

    # PPN: shard holding the most patterns fully resident (paper: "maximum
    # number of features"); ties go to the lower shard id.
    counts = [0] * part.n_shards
    for h in homes:
        if len(h) == 1:
            counts[next(iter(h))] += 1
    ppn = max(range(part.n_shards), key=lambda s: (counts[s], -s))

    remote: dict[int, list[int]] = {}
    for i, h in enumerate(homes):
        off_ppn = sorted(h - {ppn})
        if off_ppn or not h:
            for s in (off_ppn or []):
                remote.setdefault(s, []).append(i)

    # distributed joins: a join edge is local iff both patterns' data lives
    # entirely on one common shard
    n_dist = 0
    for i, j, _k in q.join_edges():
        both = homes[i] | homes[j]
        if not (len(both) == 1):
            n_dist += 1

    return FederatedPlan(
        query=q, ppn=ppn, pattern_homes=homes,
        remote_patterns={s: tuple(v) for s, v in sorted(remote.items())},
        n_distributed_joins=n_dist,
        n_service_blocks=sum(1 for s in remote if s != ppn),
    )


def _term_sparql(t) -> str:
    return f"?{t.name}" if isinstance(t, Var) else f"<{t.term}>"


def _pattern_sparql(p: TriplePattern) -> str:
    return f"{_term_sparql(p.s)} {_term_sparql(p.p)} {_term_sparql(p.o)} ."


def to_sparql(plan: FederatedPlan, endpoints: list[str] | None = None) -> str:
    """Render the plan as a federated SPARQL query (Table 1 style)."""
    q = plan.query
    if endpoints is None:
        endpoints = [f"http://shard{i}:8890/sparql"
                     for i in range(max(plan.ppn + 1,
                                        *(s + 1 for s in plan.remote_patterns)
                                        if plan.remote_patterns else (1,)))]
    remote_idx = {i for pats in plan.remote_patterns.values() for i in pats}
    lines = [f"SELECT {' '.join('?' + v for v in q.select)} WHERE {{"]
    for i, pat in enumerate(q.patterns):
        if i not in remote_idx or plan.pattern_homes[i] == {plan.ppn}:
            lines.append(f"  {_pattern_sparql(pat)}")
    for s, pats in plan.remote_patterns.items():
        if s == plan.ppn:
            continue
        inner = " ".join(_pattern_sparql(q.patterns[i]) for i in pats)
        lines.append(f"  SERVICE <{endpoints[s]}> {{ {inner} }}")
    lines.append("}")
    return "\n".join(lines)


def workload_plans(queries: list[Query], part: Partitioning) -> list[FederatedPlan]:
    return [rewrite(q, part) for q in queries]
