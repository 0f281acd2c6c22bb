"""ctypes binding and launch of the kg_scan CUDA kernel (csrc/kg_scan.cu).

The kernel takes flat instance-major buffers: every leading dim of the
op's arguments is folded into one instance axis I, and per-instance
pattern constants and equality gates ride along as (I, 3) arrays.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import check, current_stream, library, ptr, require

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _L, _L, _P]
TILE = 1024            # rows per block, as kTile in the source


def _entry():
    fn = library("kg_scan.cu").kg_scan_hits
    if fn.argtypes != _ARGTYPES:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def scan_hits_kernel(triples, valid, spo, eq):
    """(hit (I, N) bool or None, cum (I, N) int32) from flat contiguous
    CUDA tensors: triples (I, N, 3) int32 or None, valid (I, N) bool,
    spo (I, 3) int32 (None with triples None), eq (I, 3) bool or None."""
    require(valid, "valid", torch.bool, 2)
    n_inst, n = valid.shape
    if n_inst > 65535:
        raise ValueError(f"kg_scan takes at most 65535 instances, "
                         f"got {n_inst}")
    if triples is not None:
        require(triples, "triples", torch.int32, 3)
        require(spo, "spo", torch.int32, 2)
        if triples.shape != (n_inst, n, 3) or spo.shape != (n_inst, 3):
            raise ValueError(f"triples {tuple(triples.shape)} / spo "
                             f"{tuple(spo.shape)} do not match valid "
                             f"{tuple(valid.shape)}")
        if eq is not None:
            require(eq, "eq", torch.bool, 2)
            if eq.shape != (n_inst, 3):
                raise ValueError(f"eq must be ({n_inst}, 3), got "
                                 f"{tuple(eq.shape)}")
    hit = None if triples is None else torch.empty_like(valid)
    cum = torch.empty((n_inst, n), dtype=torch.int32, device=valid.device)
    tiles = -(-n // TILE)
    scratch = torch.empty((n_inst, tiles), dtype=torch.int32,
                          device=valid.device)
    status = _entry()(ptr(triples), ptr(valid), ptr(spo), ptr(eq), ptr(hit),
                      ptr(cum), ptr(scratch), n_inst, n,
                      current_stream(valid.device))
    check(status, "kg_scan_hits")
    return hit, cum
