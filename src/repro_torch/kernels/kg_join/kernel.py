"""ctypes bindings and launches of the kg_join CUDA kernels
(csrc/kg_join.cu): merge-join candidate ranges and the compat matrix.

Both take flat instance-major buffers: every leading dim of the op's
arguments is folded into one instance axis I.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import check, current_stream, library, ptr, require

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_RANGES_ARGS = [_P, _P, _P, _P, _L, _L, _L, _L, _P]
_COMPAT_ARGS = [_P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _L, _P]


def _entry(name: str, argtypes):
    fn = getattr(library("kg_join.cu"), name)
    if fn.argtypes != argtypes:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def join_ranges_kernel(keys, rkey):
    """(lo, hi) (I, S_b, R) int32 from keys (I, S_b, C) int32 (sorted per
    block, INT_MAX-padded) and rkey (I, R) int32, all contiguous CUDA."""
    require(keys, "keys", torch.int32, 3)
    require(rkey, "rkey", torch.int32, 2)
    n_inst, sb, c = keys.shape
    if rkey.shape[0] != n_inst:
        raise ValueError(f"rkey {tuple(rkey.shape)} does not match keys "
                         f"{tuple(keys.shape)}")
    r = rkey.shape[1]
    lo = torch.empty((n_inst, sb, r), dtype=torch.int32, device=keys.device)
    hi = torch.empty_like(lo)
    status = _entry("kg_join_ranges", _RANGES_ARGS)(
        ptr(keys), ptr(rkey), ptr(lo), ptr(hi), n_inst, sb, c, r,
        current_stream(keys.device))
    check(status, "kg_join_ranges")
    return lo, hi


def compat_matrix_kernel(table, tmask, matches, mmask, kind, col):
    """(I, R, C) bool compat matrix from table (I, R, V) int32, tmask (I, R)
    bool, matches (I, C, 3) int32, mmask (I, C) bool, kind/col (I, 3)
    int32, all contiguous CUDA."""
    require(table, "table", torch.int32, 3)
    require(tmask, "tmask", torch.bool, 2)
    require(matches, "matches", torch.int32, 3)
    require(mmask, "mmask", torch.bool, 2)
    require(kind, "kind", torch.int32, 2)
    require(col, "col", torch.int32, 2)
    n_inst, r, v = table.shape
    c = matches.shape[1]
    if (tmask.shape != (n_inst, r) or matches.shape != (n_inst, c, 3)
            or mmask.shape != (n_inst, c) or kind.shape != (n_inst, 3)
            or col.shape != (n_inst, 3) or v < 1):
        raise ValueError("compat_matrix operands do not agree: table "
                         f"{tuple(table.shape)}, tmask {tuple(tmask.shape)}, "
                         f"matches {tuple(matches.shape)}, mmask "
                         f"{tuple(mmask.shape)}, kind {tuple(kind.shape)}, "
                         f"col {tuple(col.shape)}")
    if n_inst > 65535 or -(-r // 64) > 65535:
        raise ValueError(f"compat_matrix grid too large: {n_inst} "
                         f"instances x {r} rows")
    out = torch.empty((n_inst, r, c), dtype=torch.bool, device=table.device)
    status = _entry("kg_compat_matrix", _COMPAT_ARGS)(
        ptr(table), ptr(tmask), ptr(matches), ptr(mmask), ptr(kind),
        ptr(col), ptr(out), n_inst, r, v, c, current_stream(table.device))
    check(status, "kg_compat_matrix")
    return out
