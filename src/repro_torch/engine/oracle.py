"""Host-side BGP evaluation oracle (vectorized numpy, set semantics).

Ground truth for the tensorized engine: evaluates a query against the full
store and returns the sorted set of solution mappings over the query's
variables. Used by tests ("federated == centralized == oracle") and by
benchmarks to size engine capacities.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kg.query import Const, Query, Var
from repro_torch.kg.triples import TripleStore


def _resolve(t, d) -> int | None:
    if isinstance(t, Const):
        # a constant absent from the dictionary matches nothing
        return d.id_of(t.term) if t.term in d else -2
    return None


def _pattern_slots(pat, vidx) -> tuple[list[tuple[int, int]], list[tuple[int, int]]]:
    """[(triple_pos, var_col)] with intra-pattern equality pairs."""
    raw = []
    for pos, t in enumerate((pat.s, pat.p, pat.o)):
        if isinstance(t, Var):
            raw.append((pos, vidx[t.name]))
    seen: dict[int, int] = {}
    eqs: list[tuple[int, int]] = []
    slots: list[tuple[int, int]] = []
    for pos, col in raw:
        if col in seen:
            eqs.append((seen[col], pos))
        else:
            seen[col] = pos
            slots.append((pos, col))
    return slots, eqs


def _encode(cols: list[np.ndarray], base: int) -> np.ndarray:
    key = np.zeros(cols[0].shape[0], dtype=np.int64)
    for c in cols:
        key = key * base + c.astype(np.int64)
    return key


def evaluate_bgp(store: TripleStore, q: Query,
                 order: list[int] | None = None,
                 sizes_out: list[tuple[int, int]] | None = None) -> np.ndarray:
    """(n_solutions, n_vars) int32 solutions over q.vars(), sorted, deduped.

    order: optional pattern evaluation order (planner's join order).
    sizes_out: if given, appended with (n_matches, n_rows_after) per step —
    used by the planner to size the engine's static capacities.
    """
    d = store.dictionary
    qvars = list(q.vars())
    vidx = {v: i for i, v in enumerate(qvars)}
    base = len(d) + 2

    rows = np.full((1, len(qvars)), -1, dtype=np.int64)
    bound: set[int] = set()
    patterns = [q.patterns[i] for i in order] if order is not None else q.patterns
    for pat in patterns:
        s, p, o = _resolve(pat.s, d), _resolve(pat.p, d), _resolve(pat.o, d)
        matches = store.scan(None if s is None else s,
                             None if p is None else p,
                             None if o is None else o)
        if -2 in (s, p, o):
            matches = matches[:0]
        slots, eqs = _pattern_slots(pat, vidx)
        for a, b in eqs:
            matches = matches[matches[:, a] == matches[:, b]]
        matches = matches.astype(np.int64)

        shared = [(pos, col) for pos, col in slots if col in bound]
        new = [(pos, col) for pos, col in slots if col not in bound]

        if not shared:
            # cartesian expansion
            r_idx = np.repeat(np.arange(rows.shape[0]), matches.shape[0])
            m_idx = np.tile(np.arange(matches.shape[0]), rows.shape[0])
        else:
            mkey = _encode([matches[:, pos] for pos, _ in shared], base)
            rkey = _encode([rows[:, col] for _, col in shared], base)
            order = np.argsort(mkey, kind="stable")
            mkey_s = mkey[order]
            lo = np.searchsorted(mkey_s, rkey, side="left")
            hi = np.searchsorted(mkey_s, rkey, side="right")
            counts = hi - lo
            r_idx = np.repeat(np.arange(rows.shape[0]), counts)
            # offsets within each row's match range
            total = int(counts.sum())
            starts = np.repeat(lo, counts)
            cum = np.concatenate(([0], np.cumsum(counts)))[:-1]
            offs = np.arange(total) - np.repeat(cum, counts)
            m_idx = order[starts + offs]

        if not new:
            # semijoin: keep each surviving row once
            keep = np.unique(r_idx)
            rows = rows[keep]
        else:
            out = rows[r_idx]
            for pos, col in new:
                out[:, col] = matches[m_idx, pos]
            rows = out
            bound |= {col for _, col in new}
        bound |= {col for _, col in shared}
        if sizes_out is not None:
            sizes_out.append((int(matches.shape[0]), int(rows.shape[0])))
        if rows.shape[0] == 0:
            break

    rows = np.unique(rows, axis=0) if rows.shape[0] else rows
    return rows.astype(np.int32)


def solution_count(store: TripleStore, q: Query) -> int:
    return int(evaluate_bgp(store, q).shape[0])
