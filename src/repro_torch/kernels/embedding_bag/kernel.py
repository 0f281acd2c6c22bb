"""ctypes bindings and launches of the row-gather and bag-sum CUDA kernels
(csrc/embedding_bag.cu)."""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import check, current_stream, library, ptr, require

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _L, _L, _L, _P]
_BAG_ARGTYPES = [_P, _P, _P, _P, _L, _L, _L, _L, ctypes.c_int, _L, _L, _L,
                 _L, _P]
_BAG_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclass(frozen=True)
class BagPlan:
    """How a warp reads bags: each row as ``lanes`` vectors of ``width``
    elements (``vector_bytes`` a load), ``rows`` rows of different slots a
    step, ``groups`` bags a warp. A row of more than 32 vectors takes 32
    lanes, a row a step, a bag a warp, and is walked 32 vectors at a
    time."""
    width: int
    vector_bytes: int
    lanes: int
    rows: int
    groups: int


@functools.lru_cache(maxsize=256)
def bag_plan(d: int, bag: int, dtype, align: int = 16) -> BagPlan:
    """The bag-sum launch's lane layout for rows of ``d`` elements of
    ``dtype`` (float32 or bfloat16), ``bag`` slots a bag, and a table whose
    start is ``align``-byte aligned: the widest load (at most 16 bytes)
    that divides the row's bytes and the alignment, as many rows a step
    as fit a warp (at most the bag), and as many bags a warp as fit."""
    if dtype not in _BAG_DTYPES:
        raise ValueError(f"bag_sum takes float32 or bfloat16, got {dtype}")
    if d < 1 or bag < 0:
        raise ValueError(f"bag_sum needs d >= 1 and bag >= 0, got {d}, "
                         f"{bag}")
    esize = 4 if dtype == torch.float32 else 2
    vb = 16
    while vb > esize and ((d * esize) % vb or align % vb):
        vb //= 2
    width = vb // esize
    nvec = d // width
    if nvec > 32:
        return BagPlan(width, vb, 32, 1, 1)
    rows = max(1, min(32 // nvec, bag))
    return BagPlan(width, vb, nvec, rows, max(1, 32 // (nvec * rows)))


def _entry(name: str = "embedding_gather_rows", argtypes=_ARGTYPES):
    fn = getattr(library("embedding_bag.cu"), name)
    if fn.argtypes != argtypes:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def gather_rows_kernel(table, ids):
    """(N, D) float32 rows of a contiguous (V, D) float32 CUDA table at
    contiguous (N,) int32 CUDA ids. The table is read in place."""
    require(table, "table", torch.float32, 2)
    require(ids, "ids", torch.int32, 1)
    if ids.device != table.device:
        raise ValueError(f"ids on {ids.device}, table on {table.device}")
    v, d = table.shape
    n = ids.shape[0]
    out = torch.empty((n, d), dtype=torch.float32, device=table.device)
    status = _entry()(ptr(table), ptr(ids), ptr(out), v, d, n,
                      current_stream(table.device))
    check(status, "embedding_gather_rows")
    return out


def bag_sum_kernel(table, ids, weights):
    """(B, D) weighted bag sums in the table's dtype (float32 or bfloat16),
    accumulated in float32: a contiguous (V, D) CUDA table, contiguous
    (B, bag) int32 ids and (B, bag) float32 weights, or None for weights
    of 1. The table is read in place, in the widest loads its alignment
    allows (`bag_plan`)."""
    if table.dtype not in _BAG_DTYPES:
        raise ValueError(f"table must be float32 or bfloat16, got "
                         f"{table.dtype}")
    require(table, "table", table.dtype, 2)
    require(ids, "ids", torch.int32, 2)
    if weights is not None:
        require(weights, "weights", torch.float32, 2)
    for name, t in (("ids", ids), ("weights", weights)):
        if t is not None and t.device != table.device:
            raise ValueError(f"{name} on {t.device}, table on {table.device}")
    if weights is not None and weights.shape != ids.shape:
        raise ValueError(f"weights {tuple(weights.shape)} != ids "
                         f"{tuple(ids.shape)}")
    v, d = table.shape
    b, bag = ids.shape
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    at = table.data_ptr()
    p = bag_plan(d, bag, table.dtype, (at & -at) if at else 16)
    status = _entry("embedding_bag_sum", _BAG_ARGTYPES)(
        ptr(table), ptr(ids), ptr(weights), ptr(out), v, d, b, bag,
        _BAG_DTYPES[table.dtype], p.width, p.lanes, p.rows, p.groups,
        current_stream(table.device))
    check(status, "embedding_bag_sum")
    return out
