"""Shared scan/join primitives of the batched engine, on PyTorch tensors.

The tensorized BGP building blocks: the fused triple-pattern predicate, the
cumsum-based stable compaction, the expand-join compatibility matrix and
its selection (`compat_select`), the merge-join candidate-range search and
its compaction of (row, candidate) pairs (`join_select`). Every function
takes leading instance dims ``(…)`` — the batched engine runs them over
``(batch, shard)`` — and keeps every index and count int32.

Every function takes ``backend`` ("torch" | "cuda"): "torch" runs the plain
PyTorch formulation below on any device; "cuda" goes through the kernel ops
(`kernels/kg_scan`, `kernels/kg_join`), which launch the hand-written CUDA
kernels on CUDA tensors and use the same plain formulation on CPU tensors.
On the "cuda" backend a compaction is one launch of the kg_scan kernel's
select epilogue, which writes the selected positions without an (…, n)
prefix sum; the kg_join range search serves only the merge joins, and
its select epilogue compacts a merge join's pairs with no pair mask, and
the compat kernels' select epilogue an expand join's pairs with no
compatibility matrix. The engine's CUDA path calls no library scan or
search. The two backends are
bit-identical on every value that is ever read through a mask.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

EQ_PAIRS = ((0, 1), (0, 2), (1, 2))
INT_MAX = np.int32(2**31 - 1)

BACKENDS = ("torch", "cuda")


@dataclass(frozen=True)
class KernelBlocks:
    """Tile sizes of the query kernels — part of every engine cache key.

    The CUDA kernels of this package fix their own tiles (the scan's by
    `kernels/kg_scan/kernel.plan`, the range search's by
    `kernels/kg_join/kernel.plan`, the compat kernels' by
    `kernels/kg_join/kernel.compat_plan`), so these fields only key the
    cache and are validated as in the JAX package.
    """
    scan_rows: int = 1024
    join_rows: int = 256
    join_cols: int = 512

    def __post_init__(self):
        for f in ("scan_rows", "join_rows", "join_cols"):
            v = getattr(self, f)
            if not isinstance(v, int) or isinstance(v, bool) or v < 8:
                raise ValueError(f"KernelBlocks.{f} must be an int >= 8, "
                                 f"got {v!r}")


DEFAULT_BLOCKS = KernelBlocks()


def check_backend(backend: str, kernel_blocks=None) -> KernelBlocks:
    """Validate a backend choice; returns the resolved KernelBlocks."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if kernel_blocks is None:
        return DEFAULT_BLOCKS
    if not isinstance(kernel_blocks, KernelBlocks):
        raise ValueError(f"kernel_blocks must be a KernelBlocks or None, "
                         f"got {kernel_blocks!r}")
    return kernel_blocks


def take(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[..., idx]`` batched over leading dims, int32 indices kept
    int32 (one flat ``index_select``): values (…, M) broadcastable against
    idx (…, X); returns (…, X). Indices must lie in [0, M)."""
    lead = torch.broadcast_shapes(values.shape[:-1], idx.shape[:-1])
    m = values.shape[-1]
    values = values.expand(*lead, m).reshape(-1, m)
    idx = idx.expand(*lead, idx.shape[-1]).reshape(values.shape[0], -1)
    n_inst = values.shape[0]
    if n_inst * m < 2**31:
        base = torch.arange(n_inst, dtype=torch.int32,
                            device=idx.device) * m
        flat = (idx.to(torch.int32) + base[:, None]).reshape(-1)
    else:
        base = torch.arange(n_inst, dtype=torch.int64,
                            device=idx.device) * m
        flat = (idx.to(torch.int64) + base[:, None]).reshape(-1)
    out = values.reshape(-1).index_select(0, flat)
    return out.reshape(*lead, idx.shape[-1])


def take_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``rows[..., idx, :]`` batched over leading dims: rows (…, M, W),
    idx (…, X) int -> (…, X, W)."""
    w = rows.shape[-1]
    lead = torch.broadcast_shapes(rows.shape[:-2], idx.shape[:-1])
    index = idx.to(torch.int64).expand(*lead, idx.shape[-1])
    index = index[..., None].expand(*lead, idx.shape[-1], w)
    return torch.gather(rows.expand(*lead, *rows.shape[-2:]), -2, index)


# ---------------------------------------------------------------------------
# triple-pattern scan
# ---------------------------------------------------------------------------

def eq_gates(eqs: tuple[tuple[int, int], ...]) -> np.ndarray:
    """Static intra-pattern equality pairs -> (3,) gate vector over EQ_PAIRS
    (the data-driven encoding the batched engine and the kernels use)."""
    g = np.zeros((3,), bool)
    for pair in eqs:
        g[EQ_PAIRS.index(tuple(sorted(pair)))] = True
    return g


def scan_predicate(triples, valid, spo, eq=None):
    """Fused triple-pattern hit mask over shard blocks.

    triples: (…, N, 3) int32, valid: (…, N) bool; spo: (…, 3) int32 with
    -1 = wildcard, -2 = never-match; eq: (…, 3) bool gates over EQ_PAIRS or
    None. Leading dims broadcast. The kg_scan kernel evaluates exactly this
    formulation per row.
    """
    s, p, o = spo[..., 0:1], spo[..., 1:2], spo[..., 2:3]
    hit = valid
    hit = hit & ((s == -1) | (triples[..., 0] == s))
    hit = hit & ((p == -1) | (triples[..., 1] == p))
    hit = hit & ((o == -1) | (triples[..., 2] == o))
    hit = hit & (s != -2) & (p != -2) & (o != -2)
    if eq is not None:
        for k, (a, b) in enumerate(EQ_PAIRS):
            hit = hit & (~eq[..., k:k + 1]
                         | (triples[..., a] == triples[..., b]))
    return hit


def scan_hits(triples, valid, spo=None, eq=None, *, backend: str = "torch",
              with_cum: bool = True):
    """(hit, cum): the fused pattern predicate plus its inclusive int32
    hit-count prefix sum along the last dim (None unless ``with_cum``).
    With ``triples=None`` the predicate is ``valid`` itself (a plain mask
    prefix sum). Under "cuda" both run fused in the kg_scan kernel."""
    if backend == "cuda":
        from repro_torch.kernels.kg_scan.ops import scan_hits as kernel_scan
        return kernel_scan(triples, valid, spo, eq, with_cum=with_cum)
    hit = valid if triples is None else scan_predicate(triples, valid, spo,
                                                       eq)
    if not with_cum:
        return hit, None
    return hit, torch.cumsum(hit, dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# stable compaction
# ---------------------------------------------------------------------------

def select_from_cum(cum, cap: int):
    """Stable compaction from an inclusive prefix sum (…, n): (idx, sel,
    total) where idx[…, j] is the position of the j-th set entry (clamped
    past ``total``), sel = arange < total; idx int32 (…, k), total (…,).
    The plain formulation; on the card `scan_select` compacts without a
    prefix sum."""
    n = cum.shape[-1]
    k = min(cap, n)
    total = cum[..., -1]
    want = torch.arange(1, k + 1, dtype=torch.int32, device=cum.device)
    want = want.expand(*cum.shape[:-1], k).contiguous()
    idx = torch.searchsorted(cum, want, side="left", out_int32=True)
    idx = idx.clamp(0, n - 1)
    sel = torch.arange(k, device=cum.device) < total[..., None]
    return idx, sel, total


def scan_select(triples, valid, cap: int, spo=None, eq=None, *,
                backend: str = "torch", with_hit: bool = True):
    """(hit or None, idx, sel, total): the stable compaction of the fused
    pattern predicate's hits, ``select_from_cum(scan_hits(…)[1], cap)``;
    hit is None when ``triples`` is None (the compaction of ``valid``) or
    not ``with_hit``. Under "cuda" one kg_scan launch writes the selection
    directly, with no (…, n) prefix sum."""
    if backend == "cuda":
        from repro_torch.kernels.kg_scan.ops import scan_select as kernel_sel
        return kernel_sel(triples, valid, cap, spo, eq, with_hit=with_hit)
    hit, cum = scan_hits(triples, valid, spo, eq, backend=backend)
    idx, sel, total = select_from_cum(cum, cap)
    keep = triples is not None and with_hit
    return (hit if keep else None), idx, sel, total


def select_cap(mask, cap: int, *, backend: str = "torch"):
    """Stable compaction: (idx, sel, total) for the first ``cap`` set
    entries of ``mask`` (…, n): `scan_select` of the mask itself."""
    return scan_select(None, mask, cap, backend=backend)[1:]


def compact(matches, mask, cap: int, *, backend: str = "torch"):
    """Keep the first ``cap`` valid rows of matches (…, n, W) (post-gather
    compaction). Returns (matches', mask', overflow); rows past the valid
    prefix are clamped repeats of the last row, dead under mask'."""
    idx, sel, total = select_cap(mask, cap, backend=backend)
    m = take_rows(matches, idx)
    if m.shape[-2] < cap:           # source smaller than the capacity: pad
        pad = cap - m.shape[-2]
        m = torch.nn.functional.pad(m, (0, 0, 0, pad), value=-1)
        sel = torch.nn.functional.pad(sel, (0, pad), value=False)
    return m, sel, total > cap


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------

def static_kind_col(shared, new, n_vars: int):
    """((3,) kind, (3,) col) int32 arrays from a plan step's static
    shared/new tuples — the data-driven encoding (kind 0 = unused,
    1 = shared/join var, 2 = new var) shared with PlanData."""
    kind = np.zeros((3,), np.int32)
    col = np.zeros((3,), np.int32)
    for pos, c_ in shared:
        kind[pos], col[pos] = 1, min(c_, max(0, n_vars - 1))
    for pos, c_ in new:
        kind[pos], col[pos] = 2, min(c_, max(0, n_vars - 1))
    return kind, col


def compat_matrix(table, tmask, matches, mmask, kind, col, *,
                  backend: str = "torch"):
    """(…, R, C) bool expand-join compatibility matrix: row r joins match c
    iff both are live and every shared position's match value equals the
    row's bound variable. table (…, R, V), tmask (…, R), matches (…, C, 3),
    mmask (…, C), kind/col (…, 3) int32 as in static_kind_col/PlanData."""
    if backend == "cuda":
        from repro_torch.kernels.kg_join.ops import compat_matrix as kc
        return kc(table, tmask, matches, mmask, kind, col)
    V = table.shape[-1]
    compat = tmask[..., :, None] & mmask[..., None, :]
    for pos in range(3):
        cc = col[..., pos].clamp(0, V - 1)                       # (…,)
        tv = take(table, cc[..., None, None].expand(
            *cc.shape, table.shape[-2], 1))[..., 0]             # (…, R)
        eq = tv[..., :, None] == matches[..., None, :, pos]
        compat = compat & ((kind[..., pos] != 1)[..., None, None] | eq)
    return compat


def compat_select(table, tmask, matches, mmask, kind, col, cap: int, *,
                  backend: str = "torch"):
    """The expand join's selection: (keep (…, R), order (…, m), omask
    (…, m), total (…,)) with compat = `compat_matrix` of the same
    arguments, keep = tmask & compat.any(-1) (the semijoin's rows) and
    (order, omask, total) = ``select_cap`` of compat flattened to (…, R *
    C), m = min(cap, R * C) (the expansion's pairs, row-major). Under
    "cuda" the kg_join compat kernels write them with no R x C matrix."""
    if backend == "cuda":
        from repro_torch.kernels.kg_join.ops import compat_select as ks
        return ks(table, tmask, matches, mmask, kind, col, cap)
    compat = compat_matrix(table, tmask, matches, mmask, kind, col)
    R, C = compat.shape[-2:]
    order, omask, total = select_cap(
        compat.reshape(*compat.shape[:-2], R * C), cap)
    return tmask & compat.any(dim=-1), order, omask, total


def join_ranges(keys, rkey, *, backend: str = "torch"):
    """Merge-join candidate ranges: for sorted keys and table-row keys
    rkey, (lo, hi) with lo = #{keys < rkey} and hi = #{keys <= rkey} —
    searchsorted left/right on a sorted array, as int32.

    keys: (…, S_b, C) with rkey (…, R) -> (…, S_b, R) each; or keys (…, C)
    with rkey (…, R) -> (…, R). Invalid keys are INT_MAX-padded (which keeps
    them sorted); rkey < INT_MAX. Leading dims broadcast.
    """
    if backend == "cuda":
        from repro_torch.kernels.kg_join.ops import join_ranges as kr
        return kr(keys, rkey)
    blocked = keys.dim() == rkey.dim() + 1
    if blocked:
        rkey = rkey[..., None, :]
    lead = torch.broadcast_shapes(keys.shape[:-1], rkey.shape[:-1])
    keys = keys.expand(*lead, keys.shape[-1]).contiguous()
    rkey = rkey.expand(*lead, rkey.shape[-1]).contiguous()
    return (torch.searchsorted(keys, rkey, side="left", out_int32=True),
            torch.searchsorted(keys, rkey, side="right", out_int32=True))


def pair_mask(counts, k: int):
    """(…, R, S_b * k) bool merge-join pair mask from counts (…, S_b, R):
    slot w of (row r, block b) is set iff w < counts[…, b, r]. The small
    counts are made contiguous first: a strided operand would give the
    mask its strides and turn the reshape into a copy of the whole mask."""
    sb, r = counts.shape[-2:]
    offs = torch.arange(k, dtype=torch.int32, device=counts.device)
    row_counts = counts.transpose(-2, -1).contiguous()          # (…, R, Sb)
    return (offs < row_counts[..., None]).reshape(*counts.shape[:-2], r,
                                                  sb * k)


def join_select(keys, rkey, tmask, k: int, cap: int, *,
                backend: str = "torch"):
    """The merge join's ranges and the stable compaction of its (row,
    block, slot) pairs: (lo (…, S_b, R), counts (…, S_b, R), order (…, m),
    omask (…, m), total (…,)) with counts = where(tmask, hi - lo, 0), m =
    min(cap, R * S_b * k), and (order, omask, total) = ``select_cap`` of
    ``pair_mask(counts, k)`` flattened. keys (…, S_b, C), rkey (…, R),
    tmask (…, R); leading dims broadcast. Under "cuda" the kg_join kernel
    searches, then selects, in two launches, with no pair mask."""
    if backend == "cuda":
        from repro_torch.kernels.kg_join.ops import join_select as ks
        return ks(keys, rkey, tmask, k, cap)
    lead = torch.broadcast_shapes(keys.shape[:-2], rkey.shape[:-1],
                                  tmask.shape[:-1])
    lo, hi = join_ranges(keys.expand(*lead, *keys.shape[-2:]),
                         rkey.expand(*lead, rkey.shape[-1]))
    counts = torch.where(tmask[..., None, :], hi - lo, 0)
    flat = pair_mask(counts, k)
    flat = flat.reshape(*flat.shape[:-2], -1)
    return (lo, counts, *select_cap(flat, cap))
