"""Plain PyTorch versions of the merge-join kernels.

As with kg_scan, they are the engine's "torch" backend
(`engine/primitives.join_ranges` / `compat_matrix`): the CPU execution path
and the yardstick the CUDA kernels are held against on the card.
"""
from __future__ import annotations

from repro_torch.engine.primitives import compat_matrix, join_ranges


def join_ranges_ref(keys, rkey):
    """(lo, hi) int32 candidate ranges: searchsorted left/right of each
    table-row key in the (per-block) sorted match keys. keys: (…, S_b, C)
    or (…, C) int32 with INT_MAX invalid padding; rkey: (…, R) < INT_MAX."""
    return join_ranges(keys, rkey, backend="torch")


def compat_matrix_ref(table, tmask, matches, mmask, kind, col):
    """(…, R, C) bool expand-join compatibility matrix (see primitives)."""
    return compat_matrix(table, tmask, matches, mmask, kind, col,
                         backend="torch")
