"""Tensorized per-query BGP primitives: pattern scan and binding-table join.

The static-shape building blocks the per-query engine (`engine/federated`)
composes per plan step, as compositions over `engine/primitives`. The
baseline join is the paper-faithful expand-and-filter (every candidate
pair checked, like the federated nested-loop join a SPARQL endpoint
performs on SERVICE results); `join_step_sorted` is the sort-merge variant
of the optimized engine.

Tensors carry explicit leading dims ``(…)`` that broadcast: the engine
runs every function over (request batch, shard). Every entry point takes
``backend`` ("torch" | "cuda"): "cuda" routes the scan and its compaction
through the kg_scan kernel (`scan_select`), the expand join's selection
through the compat kernels (`compat_select`, no R x C matrix) and the
merge join's search and pair compaction through the kg_join kernels
(`join_select`, no pair mask; `join_ranges` where a second shared column
is verified). Results are bit-identical to the JAX package's
`engine/local`, dead rows included.
"""
from __future__ import annotations

import torch

from repro_torch.engine.primitives import (INT_MAX, compact, compat_select,
                                           eq_gates,
                                           join_ranges, join_select,
                                           pair_mask, scan_select, select_cap,
                                           static_kind_col, take, take_rows)

__all__ = ["NOMATCH", "scan_shard", "join_step", "join_step_sorted",
           "compact"]

NOMATCH = -2
_INT_MAX = int(INT_MAX)


def _lift(t: torch.Tensor, nd: int, tail: int) -> torch.Tensor:
    """A view of t with leading dims of size 1 added so that it has ``nd``
    leading dims before its ``tail`` trailing ones."""
    return t.reshape((1,) * (nd + tail - t.dim()) + tuple(t.shape))


def _distinct(t: torch.Tensor, tail: int) -> torch.Tensor:
    """A view of t with every broadcast (stride-0) leading dim cut to size
    1: work on it is done once per distinct instance, and its result
    broadcasts back."""
    cut = tuple(slice(0, 1) if size > 1 and stride == 0 else slice(None)
                for size, stride in zip(t.shape[:t.dim() - tail],
                                        t.stride()[:t.dim() - tail]))
    return t[cut]


def _take(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[..., idx]`` for values (…, M) broadcast against idx (…, X),
    read in place: a broadcast dim of values is not copied."""
    return take_rows(values[..., None], idx)[..., 0]


def scan_shard(triples: torch.Tensor, valid: torch.Tensor, s, p, o,
               eqs: tuple[tuple[int, int], ...], cap: int, *,
               backend: str = "torch"):
    """Match a triple pattern against shard blocks.

    triples: (…, N, 3) int32 (padded rows arbitrary), valid: (…, N) bool.
    s/p/o: ints or int32 tensors (…,); -1 = wildcard, -2 = never-match.
    Leading dims broadcast. Returns (matches (…, cap, 3), mask (…, cap),
    overflow (…,) bool): the hits in shard order, always compacted (the
    order of the matches sets the order of the rows a join expands),
    padded with -1 rows past min(cap, N).
    """
    dev = triples.device
    spo = torch.stack(torch.broadcast_tensors(
        *(torch.as_tensor(v, dtype=torch.int32, device=dev)
          for v in (s, p, o))), dim=-1)
    eq = torch.as_tensor(eq_gates(eqs), device=dev) if eqs else None
    n = triples.shape[-2]
    lead = torch.broadcast_shapes(triples.shape[:-2], valid.shape[:-1],
                                  spo.shape[:-1])
    _, idx, mm, total = scan_select(triples, valid.expand(*lead, n),
                                    min(cap, n), spo, eq, backend=backend,
                                    with_hit=False)
    m = take_rows(triples, idx)
    if m.shape[-2] < cap:  # shard smaller than the scan capacity: pad
        pad = cap - m.shape[-2]
        m = torch.nn.functional.pad(m, (0, 0, 0, pad), value=-1)
        mm = torch.nn.functional.pad(mm, (0, pad), value=False)
    return m, mm, total > cap


def _operands(table, tmask, matches, mmask):
    """The join's operands lifted to one count of leading dims (so that
    keys and row keys never read as `join_ranges`' unblocked form)."""
    nd = len(torch.broadcast_shapes(table.shape[:-2], tmask.shape[:-1],
                                    matches.shape[:-2], mmask.shape[:-1]))
    return (_lift(table, nd, 2), _lift(tmask, nd, 1),
            _lift(matches, nd, 2), _lift(mmask, nd, 1))


def _expand_rows(table, rows, matches, cands, new):
    """The expansion: table rows ``rows`` (…, X) with each new variable's
    column set from match ``cands`` (…, X)."""
    out = take_rows(table, rows)
    vals = take_rows(matches, cands)                              # (…, X, 3)
    for pos, col in new:
        out[..., col] = vals[..., pos]
    return out


def join_step(table: torch.Tensor, tmask: torch.Tensor,
              matches: torch.Tensor, mmask: torch.Tensor,
              shared: tuple[tuple[int, int], ...],
              new: tuple[tuple[int, int], ...], *,
              backend: str = "torch"):
    """Expand-and-filter join of the binding table with pattern matches.

    table: (…, R, V) int32, tmask: (…, R); matches: (…, C, 3), mmask:
    (…, C); leading dims broadcast. shared/new: ((triple_pos, var_col),
    …). Returns (table', tmask', overflow (…,)). One `compat_select`: cap
    0 for a semijoin (no new variable: rows kept once), cap R for an
    expansion, the first R compatible (row, match) pairs in row-major
    order; under "cuda" no R x C matrix is written.
    """
    R, V = table.shape[-2:]
    C = matches.shape[-2]
    kind, col = (torch.as_tensor(a, device=table.device)
                 for a in static_kind_col(shared, new, V))
    keep, order, omask, total = compat_select(
        table, tmask, matches, mmask, kind, col, R if new else 0,
        backend=backend)
    if not new:  # semijoin: keep surviving rows once
        return table, keep, torch.zeros_like(total, dtype=torch.bool)
    out = _expand_rows(table, order // C, matches, order % C, new)
    return out, omask, total > R


def join_step_sorted(table: torch.Tensor, tmask: torch.Tensor,
                     matches: torch.Tensor, mmask: torch.Tensor,
                     shared: tuple[tuple[int, int], ...],
                     new: tuple[tuple[int, int], ...], *,
                     max_per_row: int, backend: str = "torch"):
    """Sort-merge join: sort matches by the first shared key (stably, as
    the reference's argsort), locate a contiguous candidate range per
    table row, expand up to max_per_row candidates per row, verify the
    remaining shared columns during expansion.

    Arguments as `join_step`. max_per_row must cover the fan-out of the
    FIRST shared key; the overflow flag reports violations (counts past
    max_per_row, or more than R surviving pairs). Without a shared or a
    new variable it is `join_step`. With one shared column the ranges and
    the compaction of the (row, slot) pairs are one `join_select`, with no
    pair mask; with more, `join_ranges`, the pair mask, the verification
    and `select_cap`. Matches broadcast over leading dims are sorted once.
    """
    if not shared or not new:
        return join_step(table, tmask, matches, mmask, shared, new,
                         backend=backend)
    table, tmask, matches, mmask = _operands(table, tmask, matches, mmask)
    R = table.shape[-2]
    C = matches.shape[-2]
    K = max_per_row
    lead = torch.broadcast_shapes(table.shape[:-2], matches.shape[:-2])
    pos0, col0 = shared[0]

    mkey = torch.where(_distinct(mmask, 1), _distinct(matches, 2)[..., pos0],
                       _INT_MAX)
    mkey_s, m_order = torch.sort(mkey, dim=-1, stable=True)
    m_order = m_order.to(torch.int32)
    rkey = table[..., col0]
    if len(shared) == 1:
        lo, counts, order, omask, total = join_select(
            mkey_s[..., None, :], rkey, tmask, K, R, backend=backend)
        lo, counts = lo[..., 0, :], counts[..., 0, :]
    else:
        lo, hi = join_ranges(mkey_s[..., None, :], rkey, backend=backend)
        lo = lo[..., 0, :]
        counts = torch.where(tmask, hi[..., 0, :] - lo, 0)
        pair_ok = pair_mask(counts[..., None, :], K)              # (…, R, K)
        offs = torch.arange(K, dtype=torch.int32, device=table.device)
        src = (lo[..., None] + offs).clamp(0, C - 1).reshape(*lead, R * K)
        cand = _take(m_order, src)                                # (…, R K)
        vals = take_rows(matches, cand).reshape(*lead, R, K, 3)
        for pos, col in shared[1:]:
            pair_ok = pair_ok & (vals[..., pos] == table[..., col, None])
        order, omask, total = select_cap(pair_ok.reshape(*lead, R * K), R,
                                         backend=backend)
    rows = order // K
    src = (take(lo, rows) + order % K).clamp(0, C - 1)
    out = _expand_rows(table, rows, matches, _take(m_order, src), new)
    return out, omask, (counts.amax(dim=-1) > K) | (total > R)
