"""Knowledge-graph partitioning (paper Algorithm 2) and baselines.

Pipeline: HAC dendrogram -> feature groups at cut -> statistics module scores
features claimed by several groups (replicated features F_R) and keeps each in
its best group (no replication) -> balancing module spreads unused features
F_X (and unclustered leftovers) largest-unit-into-smallest-shard.

Score of a replicated feature r w.r.t. candidate group g (paper line 6-8):
    S_R  = (p_c*w1 + q_c*w2 + s_c*w3) + (p_t*w4 + q_t*w5 + s_t*w6)
    score(r, g) = D_OR(r, g)*w7 + S_R(r, g)
with p = peer features that move together with r, q = queries using r,
s = data size of r's units, evaluated at shard level (c) and dataset level (t);
D_OR = number of workload join edges that stay local iff r is placed in g.
The paper does not publish w1..w7; they default to 1 and live in config.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.distance import jaccard_distance_matrix
from repro_torch.core.features import (DataUnit, Feature, UnitCatalog,
                                 build_unit_catalog, pattern_feature,
                                 query_features)
from repro_torch.core.hac import cut, linkage_numpy
from repro_torch.kg.query import Query
from repro_torch.kg.triples import TripleStore

DEFAULT_WEIGHTS = {f"w{i}": 1.0 for i in range(1, 8)}


def _qw(query_weights: dict[str, float] | None, q: Query) -> float:
    """Observed workload weight of a query (paper's q terms). None = the
    paper's uniform workload, every query counting 1."""
    if query_weights is None:
        return 1.0
    return float(query_weights.get(q.name, 0.0))


@dataclass
class Partitioning:
    n_shards: int
    unit_shard: dict[DataUnit, int]
    catalog: UnitCatalog
    shard_sizes: np.ndarray
    method: str = "wawpart"
    meta: dict = field(default_factory=dict)
    # unit -> extra shards holding a full copy of the unit's triples, on top
    # of its primary placement (hot cut-edge replication, Harbi et al. /
    # Peng et al.). assign_triples stays primary-only: replicas ride on top
    # of the paper's no-replication placement and only ShardedKG.build /
    # MigrationPlan.apply_kg materialize the copies.
    replicas: dict[DataUnit, tuple[int, ...]] = field(default_factory=dict)

    def feature_shards(self, f: Feature) -> frozenset[int]:
        units = self.catalog.feature_units.get(f)
        if units is None:  # feature outside the analyzed workload: spans p's units
            units = tuple(u for u in self.unit_shard if u.p == f.p
                          and (f.kind == "P" or u.o in (f.o, None)))
        return frozenset(self.unit_shard[u] for u in units if u in self.unit_shard)

    def routing_units(self, f: Feature) -> tuple[DataUnit, ...]:
        """Units a pattern with feature f can touch under this placement —
        the planner's shard-routing resolution, with the outside-workload
        fallback (every placed unit of the predicate). One definition, so
        the plan builder and the migration's changed-plan check can never
        disagree about which unit moves affect a query."""
        units = self.catalog.feature_units.get(f)
        if units is None:
            units = tuple(u for u in self.unit_shard if u.p == f.p)
        return units

    def assign_triples(self) -> np.ndarray:
        """Shard id per triple row (every triple exactly once — no
        replication). This invariant is load-bearing: migrations diff these
        arrays, and the engines' cross-shard gathers owner-mask *primary*
        shards, so a replicated copy must never appear here — `replicas` /
        `replica_rows` carry the extra copies separately."""
        store = self.catalog.store
        out = np.full(len(store), -1, dtype=np.int32)
        for u, s in self.unit_shard.items():
            rows = self.catalog.rows_of(u)
            out[rows] = s
        return out

    # ---- replication (beyond-paper: hot cut-edge replicas) -------------

    def unit_copies(self, u: DataUnit) -> frozenset[int]:
        """Every shard holding u's triples: primary placement + replicas."""
        prim = self.unit_shard.get(u)
        base = () if prim is None else (prim,)
        return frozenset(base) | frozenset(self.replicas.get(u, ()))

    def can_replicate(self, u: DataUnit, t: int) -> bool:
        """Whether a copy of u on shard t is safe for this workload.

        The engines' owner masks are shard-granular: a gather step counts
        *every* row on an owner shard that matches its scan, so a copy of u
        on t double-counts exactly when some workload pattern's owner set
        contains both t and another shard holding u. PO(p,o) scans match
        only the PO(p,o) unit (single-shard owner sets either way), but a
        bare P(p) pattern gathers over every shard holding primary p-units —
        so when the workload contains P(u.p), t must hold no primary unit
        of that predicate.
        """
        if u not in self.unit_shard or not (0 <= t < self.n_shards):
            return False
        if self.unit_shard[u] == t:
            return False
        if Feature("P", u.p) in self.catalog.feature_units:
            return not any(s == t for v, s in self.unit_shard.items()
                           if v.p == u.p)
        return True

    def with_replicas(self, replicas: dict[DataUnit, tuple[int, ...]]
                      ) -> "Partitioning":
        """Copy of this placement with `replicas` merged in (validated
        against `can_replicate`; a unit never holds two copies on one
        shard). Same catalog object, so plan/migration unit resolution is
        shared with the unreplicated placement."""
        merged = {u: set(ts) for u, ts in self.replicas.items()}
        for u, ts in replicas.items():
            for t in ts:
                if t in merged.get(u, ()):
                    continue
                if not self.can_replicate(u, int(t)):
                    raise ValueError(
                        f"cannot replicate {u!r} onto shard {t}: not a "
                        "placed unit, its own primary shard, or unsafe "
                        "under a bare P-pattern gather")
                merged.setdefault(u, set()).add(int(t))
        return Partitioning(
            self.n_shards, self.unit_shard, self.catalog, self.shard_sizes,
            method=self.method, meta=self.meta,
            replicas={u: tuple(sorted(ts)) for u, ts in sorted(merged.items())})

    def replica_rows(self) -> dict[int, np.ndarray]:
        """shard -> store row indices replicated onto it, in addition to
        `assign_triples`' primaries (sorted, deterministic)."""
        acc: dict[int, list[np.ndarray]] = {}
        for u in sorted(self.replicas):
            rows = self.catalog.rows_of(u)
            for t in self.replicas[u]:
                acc.setdefault(int(t), []).append(rows)
        return {s: np.sort(np.concatenate(rs)).astype(np.int64)
                for s, rs in sorted(acc.items())}

    @property
    def replicated_triples(self) -> int:
        return sum(self.catalog.sizes.get(u, 0) * len(ts)
                   for u, ts in self.replicas.items())

    def balance_report(self) -> dict:
        mean = float(self.shard_sizes.mean())
        dev = (self.shard_sizes - mean) / max(mean, 1.0)
        return {"sizes": self.shard_sizes.tolist(),
                "rel_dev": [round(float(x), 4) for x in dev]}


# ---------------------------------------------------------------------------
# statistics module
# ---------------------------------------------------------------------------

def _query_units(q: Query, cat: UnitCatalog) -> list[tuple[int, frozenset[DataUnit]]]:
    """Per-pattern unit sets for a query."""
    out = []
    for i, pat in enumerate(q.patterns):
        f = pattern_feature(pat)
        out.append((i, frozenset(cat.feature_units.get(f, ()))))
    return out


def _local_join_edges(q: Query, cat: UnitCatalog,
                      unit_of: dict[DataUnit, int]) -> tuple[int, int]:
    """(local, distributed) join-edge counts for a query under a placement."""
    pu = dict(_query_units(q, cat))
    local = dist = 0
    for i, j, _kind in q.join_edges():
        shards = {unit_of.get(u, -1) for u in (pu[i] | pu[j])}
        if len(shards) == 1 and -1 not in shards:
            local += 1
        else:
            dist += 1
    return local, dist


def score_replicated_feature(r: Feature, g: int, groups: dict[int, set[Feature]],
                             queries: list[Query], cat: UnitCatalog,
                             weights: dict[str, float],
                             query_weights: dict[str, float] | None = None,
                             ) -> float:
    qfeats = {q.name: query_features(q) for q in queries}
    group_feats = groups[g]
    # peers: features co-occurring with r in some query, present in group g
    peers_c = {f for q in queries if r in qfeats[q.name]
               for f in qfeats[q.name] if f != r and f in group_feats}
    peers_t = {f for q in queries if r in qfeats[q.name]
               for f in qfeats[q.name] if f != r}
    # q terms: observed query frequencies when a live workload is tracked,
    # the paper's uniform 1-per-query otherwise
    q_c = sum(_qw(query_weights, q) for q in queries if r in qfeats[q.name]
              and qfeats[q.name] & group_feats != set())
    q_t = sum(_qw(query_weights, q) for q in queries if r in qfeats[q.name])
    r_size = sum(cat.sizes.get(u, 0) for u in cat.feature_units.get(r, ()))
    g_size = sum(cat.sizes.get(u, 0) for f in group_feats
                 for u in cat.feature_units.get(f, ()))
    t_size = max(1, sum(cat.sizes.values()))
    s_c = r_size / max(1, g_size)
    s_t = r_size / t_size

    # D_OR: join edges of workload queries that become local when r sits with
    # g, each weighted by how often its query is actually asked
    d_or = 0.0
    for q in queries:
        if r not in qfeats[q.name]:
            continue
        pu = dict(_query_units(q, cat))
        r_units = set(cat.feature_units.get(r, ()))
        g_units = {u for f in group_feats for u in cat.feature_units.get(f, ())}
        for i, j, _k in q.join_edges():
            us = pu[i] | pu[j]
            if us & r_units and us <= (g_units | r_units):
                d_or += _qw(query_weights, q)

    w = weights
    s_r = (len(peers_c) * w["w1"] + q_c * w["w2"] + s_c * w["w3"]
           + len(peers_t) * w["w4"] + q_t * w["w5"] + s_t * w["w6"])
    return d_or * w["w7"] + s_r


# ---------------------------------------------------------------------------
# Algorithm 2
# ---------------------------------------------------------------------------

def _groups_from_labels(labels: np.ndarray, queries: list[Query],
                        ) -> dict[int, set[Feature]]:
    groups: dict[int, set[Feature]] = {}
    for qi, q in enumerate(queries):
        groups.setdefault(int(labels[qi]), set()).update(query_features(q))
    return {i: g for i, (_, g) in enumerate(sorted(groups.items()))}


def _resolve_replicated(groups: dict[int, set[Feature]], queries: list[Query],
                        cat: UnitCatalog, weights: dict[str, float],
                        query_weights: dict[str, float] | None = None) -> None:
    claimed: dict[Feature, list[int]] = {}
    for g, gf in groups.items():
        for f in gf:
            claimed.setdefault(f, []).append(g)
    for f, gs in sorted((f, gs) for f, gs in claimed.items() if len(gs) > 1):
        scores = {g: score_replicated_feature(f, g, groups, queries, cat,
                                              weights, query_weights)
                  for g in gs}
        keep = max(sorted(scores), key=lambda g: scores[g])
        for g in gs:
            if g != keep:
                groups[g].discard(f)


def _place_groups(groups: dict[int, set[Feature]], n_shards: int,
                  cat: UnitCatalog) -> tuple[dict[DataUnit, int], np.ndarray]:
    """Pack feature groups into shards (largest mass into emptiest shard),
    then spread unused units F_X largest-into-smallest (Algorithm 2 ln 16-19)."""
    group_units: dict[int, set[DataUnit]] = {}
    taken: set[DataUnit] = set()
    for g in sorted(groups):
        us: set[DataUnit] = set()
        # PO features claim their unit first (more specific than P residues)
        for f in sorted(groups[g]):
            for u in cat.feature_units.get(f, ()):
                if u not in taken:
                    us.add(u)
                    taken.add(u)
        group_units[g] = us

    def gmass(g: int) -> int:
        return sum(cat.sizes.get(u, 0) for u in group_units[g])

    sizes = np.zeros(n_shards, dtype=np.int64)
    unit_shard: dict[DataUnit, int] = {}
    for g in sorted(groups, key=gmass, reverse=True):
        tgt = int(np.argmin(sizes))
        for u in group_units[g]:
            unit_shard[u] = tgt
        sizes[tgt] += gmass(g)

    fx = [u for u in cat.units if u not in unit_shard]
    fx = _split_oversized(fx, cat, n_shards)
    for u in sorted(fx, key=lambda u: -cat.sizes.get(u, 0)):
        tgt = int(np.argmin(sizes))
        unit_shard[u] = tgt
        sizes[tgt] += cat.sizes.get(u, 0)
    return unit_shard, sizes


def _split_oversized(units: list[DataUnit], cat: UnitCatalog,
                     n_shards: int) -> list[DataUnit]:
    """Split unused units larger than ~half a balanced shard into hash
    chunks (they carry no workload joins, so splitting is free)."""
    total = max(1, sum(cat.sizes.values()))
    limit = max(1, total // (2 * n_shards))
    out: list[DataUnit] = []
    for u in units:
        size = cat.sizes.get(u, 0)
        if size <= limit or u.kind == "CHUNK":
            out.append(u)
            continue
        n_chunks = int(np.ceil(size / limit))
        for ci in range(n_chunks):
            cu = DataUnit("CHUNK", u.p, u.o, chunk=ci, n_chunks=n_chunks,
                          base_kind=u.kind)
            cat.sizes[cu] = int(cat.rows_of(cu).shape[0])
            out.append(cu)
    return out


def _placement_cost(queries: list[Query], cat: UnitCatalog,
                    unit_of: dict[DataUnit, int],
                    query_weights: dict[str, float] | None = None) -> float:
    """Workload-wide estimated distributed-join traffic (the paper's
    objective). With query_weights, each query's traffic is scaled by its
    observed frequency — the objective the adaptive repartitioner descends."""
    cost = 0.0
    for q in queries:
        w_q = _qw(query_weights, q)
        if w_q == 0.0:
            continue
        pu = dict(_query_units(q, cat))
        for i, j, _k in q.join_edges():
            shards = {unit_of.get(x, -1) for x in pu[i] | pu[j]}
            if len(shards) == 1 and -1 not in shards:
                continue
            side_i = sum(cat.sizes.get(x, 0) for x in pu[i])
            side_j = sum(cat.sizes.get(x, 0) for x in pu[j])
            cost += w_q * float(max(1, min(side_i, side_j)))
    return cost


def wawpart_partition(store: TripleStore, queries: list[Query], *,
                      n_shards: int = 3, linkage: str = "single",
                      cut_distance: float | None = None,
                      weights: dict[str, float] | None = None,
                      dist_matrix: np.ndarray | None = None,
                      balance_tol: float = 0.15,
                      query_weights: dict[str, float] | None = None,
                      ) -> Partitioning:
    """Algorithm 2. The dendrogram cut produces m >= n_shards feature groups;
    replicated features are resolved by score; groups are packed into shards;
    unused features balance the result. When cut_distance is None, the cut
    level is auto-selected by the paper's own objective: minimum estimated
    distributed-join traffic subject to shard balance within tolerance.

    query_weights ({query name: observed frequency}) makes the statistics
    module and the objective workload-aware in magnitude, not just shape —
    the adaptive subsystem passes tracked counts here; None keeps the
    paper's uniform one-count-per-query workload.
    """
    weights = {**DEFAULT_WEIGHTS, **(weights or {})}
    cat = build_unit_catalog(store, queries)
    n_q = len(queries)

    d = dist_matrix if dist_matrix is not None else jaccard_distance_matrix(queries)
    z = linkage_numpy(d, linkage)

    if cut_distance is not None:
        candidate_labels = [cut(z, n_q, distance=cut_distance)]
    else:  # fewer queries than shards: every cut level, down to singletons
        candidate_labels = [cut(z, n_q, n_clusters=m)
                            for m in range(min(n_shards, n_q), n_q + 1)]

    best = None
    for labels in candidate_labels:
        groups = _groups_from_labels(labels, queries)
        _resolve_replicated(groups, queries, cat, weights, query_weights)
        unit_shard, sizes = _place_groups(groups, n_shards, cat)
        _rebalance(queries, cat, unit_shard, sizes, tol=balance_tol,
                   query_weights=query_weights)
        traffic = _placement_cost(queries, cat, unit_shard, query_weights)
        mean = sizes.sum() / max(1, n_shards)
        imbalance = float(np.abs(sizes - mean).max() / max(mean, 1.0))
        key = (imbalance > balance_tol + 1e-9, traffic, imbalance)
        if best is None or key < best[0]:
            best = (key, labels, unit_shard, sizes)

    _key, labels, unit_shard, sizes = best
    return Partitioning(n_shards, unit_shard, cat, sizes, method="wawpart",
                        meta={"linkage": linkage, "labels": labels.tolist(),
                              "z": z.tolist(), "weights": weights,
                              "query_weights": dict(query_weights or {})})


def _unit_move_delta(u: DataUnit, dst: int, queries: list[Query],
                     cat: UnitCatalog, unit_of: dict[DataUnit, int],
                     query_weights: dict[str, float] | None = None) -> float:
    """Change in estimated distributed-join traffic if unit u moves to dst.

    A join edge's traffic weight is the smaller side's data size (what a
    federated SERVICE would ship), scaled by the query's observed frequency
    when query_weights is given. Negative delta = the move restores locality
    somewhere the workload actually goes.
    """
    delta = 0.0
    for q in queries:
        w_q = _qw(query_weights, q)
        if w_q == 0.0:
            continue
        pu = dict(_query_units(q, cat))
        for i, j, _k in q.join_edges():
            us = pu[i] | pu[j]
            if u not in us:
                continue
            before = {unit_of.get(x, -1) for x in us}
            after = {dst if x == u else unit_of.get(x, -1) for x in us}
            was_local = len(before) == 1 and -1 not in before
            now_local = len(after) == 1 and -1 not in after
            if was_local == now_local:
                continue
            side_i = sum(cat.sizes.get(x, 0) for x in pu[i])
            side_j = sum(cat.sizes.get(x, 0) for x in pu[j])
            w = w_q * float(max(1, min(side_i, side_j)))
            delta += w if was_local else -w
    return delta


def _rebalance(queries: list[Query], cat: UnitCatalog,
               unit_shard: dict[DataUnit, int], sizes: np.ndarray,
               *, tol: float = 0.15, max_moves: int = 512,
               query_weights: dict[str, float] | None = None) -> None:
    n_shards = sizes.shape[0]
    if n_shards < 2:
        return
    for _ in range(max_moves):
        mean = sizes.sum() / n_shards
        src = int(np.argmax(sizes))
        dst = int(np.argmin(sizes))
        if sizes[src] <= mean * (1 + tol) or src == dst:
            return
        surplus = float(sizes[src] - mean)
        cands = [u for u, s in unit_shard.items()
                 if s == src and 0 < cat.sizes.get(u, 0) <= surplus * 2]
        if not cands:  # only oversized units left: take the smallest mover
            cands = [u for u, s in unit_shard.items()
                     if s == src and cat.sizes.get(u, 0) > 0]
            if not cands:
                return
            cands = [min(cands, key=lambda x: cat.sizes[x])]
        # cheapest traffic delta first; among near-free moves prefer the one
        # that best fills the deficit
        deltas = {u: _unit_move_delta(u, dst, queries, cat, unit_shard,
                                      query_weights)
                  for u in cands}
        dmin = min(deltas.values())
        near = [u for u in cands if deltas[u] <= dmin + 1e-9] or cands
        u = min(near, key=lambda x: abs(cat.sizes[x] - surplus))
        unit_shard[u] = dst
        sizes[src] -= cat.sizes[u]
        sizes[dst] += cat.sizes[u]


def random_partition(store: TripleStore, queries: list[Query], *,
                     n_shards: int = 3, seed: int = 0) -> Partitioning:
    """Paper baseline: complete per-predicate triple sets randomly assigned."""
    rng = np.random.default_rng(seed)
    cat = build_unit_catalog(store, queries)
    preds = sorted({u.p for u in cat.units})
    pshard = {p: int(rng.integers(n_shards)) for p in preds}
    unit_shard = {u: pshard[u.p] for u in cat.units}
    sizes = np.zeros(n_shards, dtype=np.int64)
    for u, s in unit_shard.items():
        sizes[s] += cat.sizes.get(u, 0)
    return Partitioning(n_shards, unit_shard, cat, sizes, method="random",
                        meta={"seed": seed})


def centralized_partition(store: TripleStore, queries: list[Query]) -> Partitioning:
    """Everything on one node (the paper's Local/Remote Centralized baselines)."""
    cat = build_unit_catalog(store, queries)
    unit_shard = {u: 0 for u in cat.units}
    sizes = np.array([sum(cat.sizes.values())], dtype=np.int64)
    return Partitioning(1, unit_shard, cat, sizes, method="centralized")


def workload_join_stats(queries: list[Query], part: Partitioning,
                        query_weights: dict[str, float] | None = None) -> dict:
    """Workload-level local/distributed join counts + traffic under a
    placement. With query_weights, weighted_local/weighted_distributed scale
    each query's edge counts by its observed frequency — the cut-join rate a
    serving stream with that template mix would actually pay."""
    local = dist = 0
    w_local = w_dist = 0.0
    per_query = {}
    for q in queries:
        l, dd = _local_join_edges(q, part.catalog, part.unit_shard)
        local += l
        dist += dd
        w_q = _qw(query_weights, q)
        w_local += w_q * l
        w_dist += w_q * dd
        per_query[q.name] = {"local": l, "distributed": dd}
    traffic = _placement_cost(queries, part.catalog, part.unit_shard,
                              query_weights)
    return {"local": local, "distributed": dist, "traffic": traffic,
            "weighted_local": w_local, "weighted_distributed": w_dist,
            "per_query": per_query}
