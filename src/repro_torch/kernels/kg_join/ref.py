"""Plain PyTorch versions of the kg_join kernels.

As with kg_scan, they are the engine's "torch" backend
(`engine/primitives.join_ranges` / `join_select` / `compat_matrix` /
`compat_select`): the CPU execution path and the yardstick the CUDA
kernels are held against on the card.
"""
from __future__ import annotations

from repro_torch.engine.primitives import (compat_matrix, compat_select,
                                           join_ranges, join_select)


def join_ranges_ref(keys, rkey):
    """(lo, hi) int32 candidate ranges: searchsorted left/right of each
    table-row key in the (per-block) sorted match keys. keys: (…, S_b, C)
    or (…, C) int32 with INT_MAX invalid padding; rkey: (…, R) < INT_MAX."""
    return join_ranges(keys, rkey, backend="torch")


def join_select_ref(keys, rkey, tmask, k: int, cap: int):
    """(lo, counts, order, omask, total) by the literal route: the ranges,
    the (row, block, slot) pair mask ``w < counts``, then ``select_cap``
    of the flattened mask (see primitives.join_select)."""
    return join_select(keys, rkey, tmask, k, cap, backend="torch")


def compat_matrix_ref(table, tmask, matches, mmask, kind, col):
    """(…, R, C) bool expand-join compatibility matrix (see primitives)."""
    return compat_matrix(table, tmask, matches, mmask, kind, col,
                         backend="torch")


def compat_select_ref(table, tmask, matches, mmask, kind, col, cap: int):
    """(keep, order, omask, total) by the literal route: the compat matrix,
    ``select_cap`` of it flattened, and ``tmask & compat.any(-1)`` (see
    primitives.compat_select)."""
    return compat_select(table, tmask, matches, mmask, kind, col, cap,
                         backend="torch")
