"""Public join ops: leading-dim folding and dispatch for the kg_join
kernels (the merge join's range search and its select, the expand join's
compat matrix and its select).

A CPU tensor runs the plain version (`ref.py`); a CUDA tensor launches the
kernel, and anything the kernel does not take raises. There is no fallback
from the card to the plain version. Every kernel reads its inputs in
place, broadcast leading dims included. A meta tensor gets meta outputs
and its work counted in `kernels.meta_cost` (see the package's
docstring).
"""
from __future__ import annotations

import torch

import math

from repro_torch.kernels import is_meta, lead_strides, meta_cost, nbytes
from repro_torch.kernels.kg_join.kernel import (MAX_LEAD, compat_matrix_kernel,
                                                compat_select_kernel,
                                                ranges_kernel, select_kernel)
from repro_torch.kernels.kg_join.ref import (compat_matrix_ref,
                                             compat_select_ref,
                                             join_ranges_ref, join_select_ref)


def _fold(keys, rkey, tmask, lead):
    """keys (…, S_b, C), rkey (…, R) and tmask (…, R) or None as the
    kernels read them, over their broadcast leading dims ``lead``: last
    dims contiguous, strides over ``lead`` (0 where broadcast); more than
    MAX_LEAD leading dims are folded into one by a copy. Returns (keys,
    rkey, tmask, lead, strides)."""
    sb, c = keys.shape[-2:]
    r = rkey.shape[-1]
    if len(lead) > MAX_LEAD:
        keys = keys.expand(*lead, sb, c).reshape(-1, sb, c)
        rkey = rkey.expand(*lead, r).reshape(-1, r)
        if tmask is not None:
            tmask = tmask.expand(*lead, r).reshape(-1, r)
        lead = (keys.shape[0],)
    if c > 1 and keys.stride(-1) != 1:
        keys = keys.contiguous()
    if r > 1 and rkey.stride(-1) != 1:
        rkey = rkey.contiguous()
    if tmask is not None and r > 1 and tmask.stride(-1) != 1:
        tmask = tmask.contiguous()
    strides = (lead_strides(keys, 2, lead), lead_strides(rkey, 1, lead),
               lead_strides(tmask, 1, lead))
    return keys, rkey, tmask, tuple(lead), strides


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _search_ops(searches: int, c: int) -> int:
    """A binary search's operations, as the range search's bound counts
    them: two searches of ceil(log2(C + 1)) steps, 3 operations a step."""
    return searches * 2 * math.ceil(math.log2(c + 1)) * 3


def join_ranges(keys, rkey):
    """Candidate ranges (lo, hi) int32 of each table-row key in the sorted
    match keys — integer-identical to searchsorted left/right.

    keys (…, S_b, C) with rkey (…, R) -> (…, S_b, R); or keys (…, C) with
    rkey (…, R) -> (…, R). Keys are sorted per row with INT_MAX invalid
    padding; rkey < INT_MAX (term ids and the -1 unbound sentinel both
    qualify). Leading dims broadcast and are read in place.
    """
    if keys.device.type == "cpu":
        return join_ranges_ref(keys, rkey)
    blocked = keys.dim() == rkey.dim() + 1
    k = keys if blocked else keys[..., None, :]
    shape = torch.broadcast_shapes(k.shape[:-2], rkey.shape[:-1])
    if is_meta(keys):
        tail = (k.shape[-2], rkey.shape[-1]) if blocked \
            else (rkey.shape[-1],)
        lo, hi = _meta((*shape, *tail), torch.int32), \
            _meta((*shape, *tail), torch.int32)
        searches = shape.numel() * k.shape[-2] * rkey.shape[-1]
        meta_cost.add("join_ranges", ops=_search_ops(searches, k.shape[-1]),
                      n_bytes=nbytes(keys) + nbytes(rkey) + 8 * searches)
        return lo, hi
    kk, rk, _, lead, strides = _fold(k, rkey, None, shape)
    lo, hi = ranges_kernel(kk, rk, lead, strides)
    join_ranges.launches += 1
    tail = (keys.shape[-2], rkey.shape[-1]) if blocked else (rkey.shape[-1],)
    return lo.reshape(*shape, *tail), hi.reshape(*shape, *tail)


join_ranges.launches = 0


def join_select(keys, rkey, tmask, k: int, cap: int):
    """The merge join's searches and the stable compaction of its (row,
    block, slot) pairs, without the pair mask: (lo (…, S_b, R) int32,
    counts (…, S_b, R) int32, order (…, m) int32, omask (…, m) bool, total
    (…,) int32) with m = min(cap, R * S_b * k).

    counts = where(tmask, hi - lo, 0) of `join_ranges`; slot w of (row r,
    block b) is set iff w < counts[…, b, r] (w < k), and (order, omask,
    total) is ``select_cap`` of those slots flattened in (r, b, w) order,
    bit for bit: order[…, j] = r * S_b * k + b * k + w of the (j+1)-th set
    slot, R * S_b * k - 1 past total; total counts every set slot. keys
    (…, S_b, C) int32 sorted per block (INT_MAX-padded), rkey (…, R) int32
    < INT_MAX, tmask (…, R) bool; leading dims broadcast and are read in
    place. On the card it is two launches: a search launch that writes lo
    and counts, then the select.
    """
    if keys.device.type == "cpu":
        return join_select_ref(keys, rkey, tmask, k, cap)
    shape = torch.broadcast_shapes(keys.shape[:-2], rkey.shape[:-1],
                                   tmask.shape[:-1])
    if is_meta(keys):
        return _meta_join_select(keys, rkey, tmask, k, cap, shape)
    lo, counts, order, omask, total = select_kernel(
        *_fold(keys, rkey, tmask, shape), k, cap)
    join_select.launches += 1
    sb, r = keys.shape[-2], rkey.shape[-1]
    return (lo.reshape(*shape, sb, r), counts.reshape(*shape, sb, r),
            order.reshape(*shape, order.shape[-1]),
            omask.reshape(*shape, omask.shape[-1]), total.reshape(shape))


join_select.launches = 0


def _meta_join_select(keys, rkey, tmask, k, cap, shape):
    sb, c, r = keys.shape[-2], keys.shape[-1], rkey.shape[-1]
    m = min(cap, r * sb * k)
    searches = shape.numel() * sb * r
    meta_cost.add("join_select", ops=_search_ops(searches, c),
                  n_bytes=nbytes(keys) + nbytes(rkey) + nbytes(tmask)
                  + 8 * searches + shape.numel() * (m * 5 + 4))
    return (_meta((*shape, sb, r), torch.int32),
            _meta((*shape, sb, r), torch.int32),
            _meta((*shape, m), torch.int32), _meta((*shape, m), torch.bool),
            _meta(shape, torch.int32))


def _meta_compat(name, operands, shape, out_bytes) -> None:
    """The compat launch's bound with every pair live and every triple
    position tested: 3 integer compares a (row, match) pair."""
    r, c = operands[0].shape[-2], operands[2].shape[-2]
    meta_cost.add(name, ops=3 * shape.numel() * r * c,
                  n_bytes=sum(nbytes(t) for t in operands) + out_bytes)


# the compat operands and their trailing (non-leading) dims
_COMPAT_TAILS = (2, 1, 2, 1, 1, 1)


def _compat_lead(args) -> torch.Size:
    """The broadcast leading dims of the compat operands."""
    return torch.broadcast_shapes(*(t.shape[:t.dim() - n]
                                    for t, n in zip(args, _COMPAT_TAILS)))


def _fold_compat(args, lead):
    """(table, tmask, matches, mmask, kind, col) as the compat kernels read
    them: in place over their broadcast leading dims ``lead``, with each
    one's strides there (0 where broadcast); more than MAX_LEAD leading
    dims are folded into one by a copy. Returns (args, lead, strides)."""
    if len(lead) > MAX_LEAD:
        args = tuple(t.expand(*lead, *t.shape[t.dim() - n:])
                     .reshape(-1, *t.shape[t.dim() - n:])
                     for t, n in zip(args, _COMPAT_TAILS))
        lead = (args[0].shape[0],)
    strides = tuple(lead_strides(t, n, lead)
                    for t, n in zip(args, _COMPAT_TAILS))
    return args, tuple(lead), strides


def compat_matrix(table, tmask, matches, mmask, kind, col):
    """(…, R, C) bool expand-join compatibility matrix.

    table (…, R, V) int32, tmask (…, R) bool, matches (…, C, 3) int32,
    mmask (…, C) bool, kind/col (…, 3) int32; leading dims broadcast and
    are read in place.
    """
    if table.device.type == "cpu":
        return compat_matrix_ref(table, tmask, matches, mmask, kind, col)
    operands = (table, tmask, matches, mmask, kind, col)
    shape = _compat_lead(operands)
    r, c = table.shape[-2], matches.shape[-2]
    if is_meta(table):
        _meta_compat("compat_matrix", operands, shape, shape.numel() * r * c)
        return _meta((*shape, r, c), torch.bool)
    out = compat_matrix_kernel(*_fold_compat(operands, shape))
    compat_matrix.launches += 1
    return out.reshape(*shape, table.shape[-2], matches.shape[-2])


compat_matrix.launches = 0


def compat_select(table, tmask, matches, mmask, kind, col, cap: int):
    """The expand join's selection without its matrix: (keep (…, R) bool,
    order (…, m) int32, omask (…, m) bool, total (…,) int32) with
    m = min(cap, R * C), where compat = `compat_matrix` of the same
    arguments, keep = tmask & compat.any(-1) and (order, omask, total) =
    ``select_cap`` of compat flattened (…, R * C), bit for bit: order[…, j]
    = r * C + c of the (j+1)-th compatible pair in row-major order, R * C -
    1 past total; total counts every compatible pair. Leading dims
    broadcast and are read in place. On the card it is three launches
    (count, scan and, for cap > 0, write), and no (…, R, C) tensor is
    made.
    """
    if table.device.type == "cpu":
        return compat_select_ref(table, tmask, matches, mmask, kind, col, cap)
    operands = (table, tmask, matches, mmask, kind, col)
    shape = _compat_lead(operands)
    if is_meta(table):
        r = table.shape[-2]
        m = min(cap, r * matches.shape[-2])
        _meta_compat("compat_select", operands, shape,
                     shape.numel() * (r + m * 5 + 4))
        return (_meta((*shape, r), torch.bool),
                _meta((*shape, m), torch.int32),
                _meta((*shape, m), torch.bool), _meta(shape, torch.int32))
    keep, order, omask, total = compat_select_kernel(
        *_fold_compat(operands, shape), cap)
    compat_select.launches += 1
    return (keep.reshape(*shape, keep.shape[-1]),
            order.reshape(*shape, order.shape[-1]),
            omask.reshape(*shape, omask.shape[-1]), total.reshape(shape))


compat_select.launches = 0
