"""Public merge-join ops: leading-dim folding and dispatch for the kg_join
kernels.

A CPU tensor runs the plain version (`ref.py`); a CUDA tensor launches the
kernel, and anything the kernel does not take raises. There is no fallback
from the card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.kg_join.kernel import (compat_matrix_kernel,
                                                join_ranges_kernel)
from repro_torch.kernels.kg_join.ref import compat_matrix_ref, join_ranges_ref


def join_ranges(keys, rkey):
    """Candidate ranges (lo, hi) int32 of each table-row key in the sorted
    match keys — integer-identical to searchsorted left/right.

    keys (…, S_b, C) with rkey (…, R) -> (…, S_b, R); or keys (…, C) with
    rkey (…, R) -> (…, R). Keys are sorted per row with INT_MAX invalid
    padding; rkey < INT_MAX (term ids and the -1 unbound sentinel both
    qualify). Leading dims broadcast.
    """
    if keys.device.type == "cpu":
        return join_ranges_ref(keys, rkey)
    blocked = keys.dim() == rkey.dim() + 1
    k = keys if blocked else keys[..., None, :]
    lead = torch.broadcast_shapes(k.shape[:-2], rkey.shape[:-1])
    sb, c = k.shape[-2:]
    r = rkey.shape[-1]
    k = k.expand(*lead, sb, c).reshape(-1, sb, c).contiguous()
    rk = rkey.expand(*lead, r).reshape(-1, r).contiguous()
    lo, hi = join_ranges_kernel(k, rk)
    join_ranges.launches += 1
    shape = (*lead, sb, r) if blocked else (*lead, r)
    return lo.reshape(shape), hi.reshape(shape)


join_ranges.launches = 0


def compat_matrix(table, tmask, matches, mmask, kind, col):
    """(…, R, C) bool expand-join compatibility matrix.

    table (…, R, V) int32, tmask (…, R) bool, matches (…, C, 3) int32,
    mmask (…, C) bool, kind/col (…, 3) int32; leading dims broadcast.
    """
    if table.device.type == "cpu":
        return compat_matrix_ref(table, tmask, matches, mmask, kind, col)
    lead = torch.broadcast_shapes(table.shape[:-2], tmask.shape[:-1],
                                  matches.shape[:-2], mmask.shape[:-1],
                                  kind.shape[:-1], col.shape[:-1])
    r, v = table.shape[-2:]
    c = matches.shape[-2]

    def flat(t, *tail):
        return t.expand(*lead, *tail).reshape(-1, *tail).contiguous()

    out = compat_matrix_kernel(flat(table, r, v), flat(tmask, r),
                               flat(matches, c, 3), flat(mmask, c),
                               flat(kind, 3), flat(col, 3))
    compat_matrix.launches += 1
    return out.reshape(*lead, r, c)


compat_matrix.launches = 0
