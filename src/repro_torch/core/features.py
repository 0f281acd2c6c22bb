"""Feature extraction from workload queries and the knowledge graph (paper §3.1).

Features:
  P(p)     — all triples sharing predicate p (pattern has a variable object),
  PO(p, o) — all triples sharing predicate p AND object o (constant object).
Join-shape features SS / OS / OO between pattern pairs are computed by
`Query.join_edges()` and consumed by the partitioner's statistics module.

The paper's worked example (Fig. 1) fixes the semantics we reproduce exactly:
  Q7 = {PO(type,Student), PO(type,Course), P(takesCourse), P(teacherOf)}   (4)
  Q9 = {PO(type,Student), PO(type,Faculty), PO(type,Course),
        P(advisor), P(takesCourse), P(teacherOf)}                          (6)
  dist(Q7,Q9) = 1 - 4/6 = 0.33

Data placement operates on *data units*: disjoint triple sets derived from the
workload features. For a predicate p with workload PO objects {o1..om}, the
units are PO(p,o1..om) plus a residue RES(p) holding p's remaining triples;
predicates only touched via P (or untouched) form a single ALL(p) unit. A P(p)
feature maps to every unit of p; a PO feature maps to its own unit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.kg.query import Const, Query, TriplePattern, Var
from repro_torch.kg.triples import TripleStore, P as PCOL, O as OCOL


@dataclass(frozen=True, order=True)
class Feature:
    kind: str  # "P" | "PO"
    p: str
    o: Optional[str] = None

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"P({self.p})" if self.kind == "P" else f"PO({self.p},{self.o})"


@dataclass(frozen=True, order=True)
class DataUnit:
    """A disjoint, atomically-placed set of triples.

    kind: "PO"    — triples with (p, o)
          "RES"   — triples with predicate p and object NOT in the workload's
                    PO-object set for p
          "ALL"   — every triple with predicate p (p has no workload PO
                    feature)
          "CHUNK" — hash-slice chunk/n_chunks of an unused ALL/RES unit; the
                    balancing module splits oversized unused units so balance
                    is achievable (workload units stay atomic)
    """
    kind: str
    p: str
    o: Optional[str] = None
    chunk: int = 0
    n_chunks: int = 1
    base_kind: str = "ALL"

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        core = f"{self.kind}({self.p}" + (f",{self.o})" if self.o else ")")
        if self.kind == "CHUNK":
            core += f"[{self.chunk}/{self.n_chunks}]"
        return core


def pattern_feature(pat: TriplePattern) -> Feature:
    if not isinstance(pat.p, Const):
        raise ValueError("variable predicates are outside the paper's feature model")
    if isinstance(pat.o, Const):
        return Feature("PO", pat.p.term, pat.o.term)
    return Feature("P", pat.p.term)


def query_features(q: Query) -> frozenset[Feature]:
    return frozenset(pattern_feature(pat) for pat in q.patterns)


def workload_features(queries: list[Query]) -> dict[str, frozenset[Feature]]:
    return {q.name: query_features(q) for q in queries}


# ---------------------------------------------------------------------------
# dataset side
# ---------------------------------------------------------------------------

@dataclass
class UnitCatalog:
    """All data units of a store w.r.t. a workload, with sizes and row indices."""
    units: list[DataUnit]
    sizes: dict[DataUnit, int]
    feature_units: dict[Feature, tuple[DataUnit, ...]]  # feature -> units it spans
    workload_units: frozenset[DataUnit]                 # units claimed by any feature
    store: TripleStore

    def rows_of(self, unit: DataUnit) -> np.ndarray:
        st = self.store
        d = st.dictionary
        if unit.p not in d:
            return np.empty((0,), dtype=np.int64)
        pid = d.id_of(unit.p)
        if unit.kind == "CHUNK":
            base = DataUnit(unit.base_kind, unit.p, unit.o)
            rows = self.rows_of(base)
            return rows[rows % unit.n_chunks == unit.chunk]
        if unit.kind == "ALL":
            return st.p_feature_rows(pid)
        if unit.kind == "PO":
            if unit.o not in d:
                return np.empty((0,), dtype=np.int64)
            return st.po_feature_rows(pid, d.id_of(unit.o))
        # RES: predicate rows minus the workload PO objects
        rows = st.p_feature_rows(pid)
        excl_obj = {d.id_of(u.o) for u in self.units
                    if u.kind == "PO" and u.p == unit.p and u.o in d}
        if not excl_obj:
            return rows
        objs = st.triples[rows, OCOL]
        keep = ~np.isin(objs, np.fromiter(excl_obj, dtype=np.int32))
        return rows[keep]


def build_unit_catalog(store: TripleStore, queries: list[Query]) -> UnitCatalog:
    d = store.dictionary
    feats: set[Feature] = set()
    for q in queries:
        feats |= query_features(q)

    po_objects: dict[str, set[str]] = {}
    p_features: set[str] = set()
    for f in feats:
        if f.kind == "PO":
            po_objects.setdefault(f.p, set()).add(f.o)  # type: ignore[arg-type]
        else:
            p_features.add(f.p)

    units: list[DataUnit] = []
    # predicates present in the data
    data_preds = [d.term_of(int(p)) for p in store.predicates]
    for p in sorted(set(data_preds) | set(po_objects) | p_features):
        if p in po_objects:
            for o in sorted(po_objects[p]):
                units.append(DataUnit("PO", p, o))
            units.append(DataUnit("RES", p))
        else:
            units.append(DataUnit("ALL", p))

    cat = UnitCatalog(units, {}, {}, frozenset(), store)
    sizes = {u: int(cat.rows_of(u).shape[0]) for u in units}
    # drop empty residues of predicates fully covered by PO units
    units = [u for u in units if not (u.kind == "RES" and sizes[u] == 0)]
    cat.units = units
    cat.sizes = {u: sizes[u] for u in units}

    unit_by_p: dict[str, list[DataUnit]] = {}
    for u in units:
        unit_by_p.setdefault(u.p, []).append(u)

    feature_units: dict[Feature, tuple[DataUnit, ...]] = {}
    for f in sorted(feats):
        if f.kind == "PO":
            feature_units[f] = (DataUnit("PO", f.p, f.o),)
        else:
            feature_units[f] = tuple(unit_by_p.get(f.p, ()))
    cat.feature_units = feature_units
    cat.workload_units = frozenset(u for us in feature_units.values() for u in us)
    return cat
