"""ctypes binding and launch of the Jaccard CUDA kernel (csrc/jaccard.cu)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import check, current_stream, library, ptr, require

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _L, _L, _P]
TILE = 128             # output tile edge, as kTile in the source


def _entry():
    fn = library("jaccard.cu").jaccard_distance
    if fn.argtypes != _ARGTYPES:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def jaccard_distance_kernel(m):
    """(Q, Q) float32 distances from a contiguous (Q, F) float32 CUDA
    tensor. Ragged Q and F are handled in the kernel: nothing is padded."""
    require(m, "m", torch.float32, 2)
    q, f = m.shape
    if f < 1:
        raise ValueError("m needs at least one feature column")
    if -(-q // TILE) > 65535:
        raise ValueError(f"jaccard takes at most {65535 * TILE} rows, got {q}")
    counts = torch.empty((q,), dtype=torch.float32, device=m.device)
    out = torch.empty((q, q), dtype=torch.float32, device=m.device)
    status = _entry()(ptr(m), ptr(counts), ptr(out), q, f,
                      current_stream(m.device))
    check(status, "jaccard_distance")
    return out
