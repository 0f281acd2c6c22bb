"""Physical plan construction: join order, shard routing, static capacities.

Mirrors the paper's Query Rewriter/Processor: the plan routes each pattern to
the shard(s) owning its feature data, picks the PPN, and marks which patterns
must be gathered across the shard axis (the tensor analogue of a SERVICE
block). Join order is chosen by selectivity estimates from the store's
predicate statistics — a beyond-paper planner optimization (the paper executes
patterns in query order); `order="paper"` keeps the faithful behavior.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.features import pattern_feature
from repro_torch.core.partitioner import Partitioning
from repro_torch.kg.query import Const, Query, Var
from repro_torch.kg.triples import TripleStore


def _pow2ceil(x: int) -> int:
    return 1 << max(3, int(np.ceil(np.log2(max(1, x)))))


@dataclass(frozen=True)
class PlanStep:
    pattern_idx: int                       # -1 marks a padding no-op step
    consts: tuple[int, int, int]           # term id, -1 = variable, -2 = no-match
    slots: tuple[tuple[int, int], ...]     # (triple_pos, var_col), deduped
    eqs: tuple[tuple[int, int], ...]       # intra-pattern equal positions
    shared: tuple[tuple[int, int], ...]
    new: tuple[tuple[int, int], ...]
    owners: tuple[int, ...]
    gather: bool
    scan_cap: int
    param_slots: tuple[tuple[int, int], ...] = ()  # (triple_pos, param_index)
    block_fanout_cap: int = 64   # max matches per join-key value per shard,
                                 # sized from data like scan_cap (batched
                                 # engine join-window width; overflow flag
                                 # still guards runtime drift, e.g. params)

    @property
    def is_noop(self) -> bool:
        return self.pattern_idx < 0


def noop_step(scan_cap: int) -> PlanStep:
    """Padding step: never matches, binds nothing, leaves the table untouched.

    Distinct from a real never-match step (a constant absent from the
    dictionary also yields -2 consts but legitimately annihilates the table);
    the pattern_idx=-1 sentinel is what marks padding.
    """
    return PlanStep(pattern_idx=-1, consts=(-2, -2, -2), slots=(), eqs=(),
                    shared=(), new=(), owners=(), gather=False,
                    scan_cap=int(scan_cap), block_fanout_cap=8)


@dataclass
class PhysicalPlan:
    query: Query
    ppn: int
    n_shards: int
    n_vars: int
    var_names: tuple[str, ...]
    steps: list[PlanStep]
    table_cap: int
    n_params: int = 0
    meta: dict = field(default_factory=dict)

    @property
    def n_gathers(self) -> int:
        return sum(1 for s in self.steps if s.gather)

    @property
    def cut_steps(self) -> tuple[int, ...]:
        """Step indices whose pattern's owner set is not covered by the PPN —
        the plan-level image of WawPart's partition cuts. On a real mesh each
        is exactly one cross-shard gather site, so `len(plan.cut_steps)` is
        the query's collective count (engine/batch.bucket_collectives lifts
        this to buckets)."""
        return tuple(i for i, s in enumerate(self.steps) if s.gather)

    @property
    def is_local(self) -> bool:
        return self.n_gathers == 0


def _estimate(pat, store: TripleStore) -> float:
    d = store.dictionary
    if isinstance(pat.p, Const):
        if pat.p.term not in d:
            return 0.0
        pid = d.id_of(pat.p.term)
        psize = store.p_feature_size(pid)
        if isinstance(pat.o, Const):
            if pat.o.term not in d:
                return 0.0
            base = store.po_feature_size(pid, d.id_of(pat.o.term))
        else:
            base = psize
        if isinstance(pat.s, Const):
            base = max(1.0, base / max(1, psize)) if base else 0.0
        return float(base)
    return float(len(store))


def choose_order(q: Query, store: TripleStore, mode: str = "selectivity") -> list[int]:
    n = len(q.patterns)
    if mode == "paper" or n <= 1:
        return list(range(n))
    est = {i: _estimate(q.patterns[i], store) for i in range(n)}
    remaining = set(range(n))
    bound: set[str] = set()
    order: list[int] = []
    while remaining:
        connected = [i for i in remaining
                     if bound and set(q.patterns[i].vars()) & bound]
        pool = connected or list(remaining)
        # prefer patterns whose join is on an already-bound var, most selective
        nxt = min(pool, key=lambda i: (est[i], i))
        order.append(nxt)
        remaining.discard(nxt)
        bound |= set(q.patterns[nxt].vars())
    return order


def make_plan(q: Query, part: Partitioning, *, order: str = "selectivity",
              cap_margin: float = 1.5, min_cap: int = 64,
              max_cap: int = 1 << 17,
              params: dict[tuple[int, int], int] | None = None,
              capacities: tuple[list[int], int] | None = None,
              forbid_ppn: frozenset | None = None) -> PhysicalPlan:
    """Build the physical plan for query q under a partitioning.

    params: {(pattern_idx, triple_pos): param_index} marks constants that are
    replaced at run time from a params vector (batched serving).
    capacities: optional ([scan_cap per step], table_cap) override; otherwise
    sized from a host-side oracle simulation of the chosen join order.
    forbid_ppn: shards excluded from the primary-processing-node choice
    (degraded serving must never home a plan's extraction on a down shard —
    the tie-break default is shard 0, which could be the dead one). Raises
    ValueError if every shard is forbidden.
    """
    store = part.catalog.store
    d = store.dictionary
    qvars = list(q.vars())
    vidx = {v: i for i, v in enumerate(qvars)}
    ord_idx = choose_order(q, store, order)

    # ---- shard routing (the paper's rewriter) --------------------------
    homes: list[frozenset[int]] = []
    pat_units: list[tuple] = []
    for pat in q.patterns:
        units = [u for u in part.routing_units(pattern_feature(pat))
                 if u in part.unit_shard]
        pat_units.append(tuple(units))
        homes.append(frozenset(part.unit_shard[u] for u in units))
    counts = [0] * part.n_shards
    for h in homes:
        if len(h) == 1:
            counts[next(iter(h))] += 1
    # ppn comes from *primary* homes only, so replication never moves a
    # query's primary shard — unaffected plans stay bit-identical.
    candidates = [s for s in range(part.n_shards)
                  if not forbid_ppn or s not in forbid_ppn]
    if not candidates:
        raise ValueError("forbid_ppn excludes every shard")
    ppn = max(candidates, key=lambda s: (counts[s], -s))

    # Replicas can make ppn self-sufficient for a pattern: when every
    # routing unit has a copy (primary or replica) on ppn, the step scans
    # ppn alone and the cross-shard gather disappears. Partial coverage
    # keeps the primary owner set — adding ppn there would double-count.
    owner_sets = list(homes)
    if part.replicas:
        for pi, units in enumerate(pat_units):
            if units and all(ppn in part.unit_copies(u) for u in units):
                owner_sets[pi] = frozenset({ppn})

    # ---- static capacities from host simulation ------------------------
    if capacities is None:
        from repro_torch.engine.oracle import evaluate_bgp
        sizes: list[tuple[int, int]] = []
        evaluate_bgp(store, q, order=ord_idx, sizes_out=sizes)
        # scan capacity is join-independent: exact per-pattern match counts
        # (an empty intermediate result must not shrink later scans)
        scan_counts = []
        for pi in ord_idx:
            pat = q.patterns[pi]
            ids = [d.id_of(t.term) if (isinstance(t, Const) and t.term in d)
                   else (-2 if isinstance(t, Const) else None)
                   for t in (pat.s, pat.p, pat.o)]
            if -2 in ids:
                scan_counts.append(0)
            else:
                scan_counts.append(int(store.scan(*ids).shape[0]))
        scan_caps = [min(max_cap, _pow2ceil(int(m * cap_margin) + 8))
                     for m in scan_counts]
        table_cap = min(max_cap, _pow2ceil(
            int(max([r for _, r in sizes] + [1]) * cap_margin) + 8))
    else:
        scan_caps, table_cap = [list(capacities[0]), capacities[1]]

    params = params or {}
    assign = None          # shard-per-triple, computed on first shared step
    steps: list[PlanStep] = []
    bound: set[int] = set()
    for step_i, pi in enumerate(ord_idx):
        pat = q.patterns[pi]
        consts = []
        for t in (pat.s, pat.p, pat.o):
            if isinstance(t, Const):
                consts.append(d.id_of(t.term) if t.term in d else -2)
            else:
                consts.append(-1)
        raw = [(pos, vidx[t.name]) for pos, t in enumerate((pat.s, pat.p, pat.o))
               if isinstance(t, Var)]
        seen: dict[int, int] = {}
        eqs: list[tuple[int, int]] = []
        slots: list[tuple[int, int]] = []
        for pos, col in raw:
            if col in seen:
                eqs.append((seen[col], pos))
            else:
                seen[col] = pos
                slots.append((pos, col))
        shared = tuple((pos, col) for pos, col in slots if col in bound)
        new = tuple((pos, col) for pos, col in slots if col not in bound)
        owners = tuple(sorted(owner_sets[pi]))
        gather = not (set(owners) <= {ppn}) if owners else True
        psl = tuple((pos, pidx) for (qpi, pos), pidx in sorted(params.items())
                    if qpi == pi)
        # per-shard join fan-out on the first shared key, from the data —
        # sizes the batched engine's merge-join window per step
        fanout = 1
        if shared:
            if assign is None:
                assign = part.assign_triples()
            tr = store.triples
            hit = np.ones(len(tr), dtype=bool)
            for pos, cid in enumerate(consts):
                if cid == -2:
                    hit[:] = False
                elif cid >= 0:
                    hit &= tr[:, pos] == cid
            for a, b in eqs:
                hit &= tr[:, a] == tr[:, b]
            rows = np.nonzero(hit)[0]
            if rows.size:
                if part.replicas:
                    # a replicated shard can hold more matches per join key
                    # than any single primary shard — bound globally
                    key = tr[rows, shared[0][0]].astype(np.int64)
                else:
                    key = (assign[rows].astype(np.int64) * (len(d) + 2)
                           + tr[rows, shared[0][0]])
                fanout = int(np.unique(key, return_counts=True)[1].max())
        bcap = min(max_cap, _pow2ceil(int(fanout * cap_margin) + 4))
        steps.append(PlanStep(
            pattern_idx=pi, consts=tuple(consts), slots=tuple(slots),
            eqs=tuple(eqs), shared=shared, new=new, owners=owners,
            gather=gather, scan_cap=int(scan_caps[step_i]), param_slots=psl,
            block_fanout_cap=bcap))
        bound |= {col for _, col in slots}

    n_params = (max(params.values()) + 1) if params else 0
    return PhysicalPlan(
        query=q, ppn=ppn, n_shards=part.n_shards, n_vars=len(qvars),
        var_names=tuple(qvars), steps=steps, table_cap=int(table_cap),
        n_params=n_params,
        meta={"order": ord_idx, "homes": [sorted(h) for h in homes]})


def pad_plan(plan: PhysicalPlan, n_steps: int,
             scan_caps: list[int] | None = None,
             table_cap: int | None = None) -> PhysicalPlan:
    """Pad a plan to a bucket shape: append no-op steps up to n_steps, lift
    per-step scan caps and the table cap to the bucket's (never shrink —
    capacities are correctness bounds, a smaller cap could drop solutions).
    """
    if n_steps < len(plan.steps):
        raise ValueError(f"cannot pad {len(plan.steps)}-step plan to {n_steps}")
    caps = list(scan_caps) if scan_caps is not None else \
        [s.scan_cap for s in plan.steps] + [8] * (n_steps - len(plan.steps))
    if len(caps) != n_steps:
        raise ValueError(f"scan_caps has {len(caps)} entries, want {n_steps}")
    steps: list[PlanStep] = []
    for i in range(n_steps):
        if i < len(plan.steps):
            s = plan.steps[i]
            steps.append(PlanStep(
                pattern_idx=s.pattern_idx, consts=s.consts, slots=s.slots,
                eqs=s.eqs, shared=s.shared, new=s.new, owners=s.owners,
                gather=s.gather, scan_cap=max(int(caps[i]), s.scan_cap),
                param_slots=s.param_slots,
                block_fanout_cap=s.block_fanout_cap))
        else:
            steps.append(noop_step(caps[i]))
    tcap = max(plan.table_cap, int(table_cap)) if table_cap is not None \
        else plan.table_cap
    return PhysicalPlan(
        query=plan.query, ppn=plan.ppn, n_shards=plan.n_shards,
        n_vars=plan.n_vars, var_names=plan.var_names, steps=steps,
        table_cap=tcap, n_params=plan.n_params,
        meta=dict(plan.meta, padded_from=len(plan.steps)))
