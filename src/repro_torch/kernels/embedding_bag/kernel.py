"""ctypes binding and launch of the row-gather CUDA kernel
(csrc/embedding_bag.cu)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import check, current_stream, library, ptr, require

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _L, _L, _L, _P]


def _entry():
    fn = library("embedding_bag.cu").embedding_gather_rows
    if fn.argtypes != _ARGTYPES:
        fn.argtypes = _ARGTYPES
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
