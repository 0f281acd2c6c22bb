"""ctypes binding and launch of the segment-sum CUDA kernel
(csrc/segment_spmm.cu)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import check, current_stream, library, ptr, require

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _L, _L, _L, ctypes.c_int, _P]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
INT32_MAX = 2 ** 31 - 1


def _entry():
    fn = library("segment_spmm.cu").segment_spmm_sorted
    if fn.argtypes != _ARGTYPES:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def segment_spmm_kernel(values, receivers, edge_mask, n_nodes: int):
    """(n_nodes, D) sums of the rows of contiguous (E, D) float32 or
    bfloat16 CUDA ``values`` sorted by their (E,) int32 ``receivers``
    (non-decreasing). ``edge_mask`` is an (E,) bool tensor of live edges or
    None (all live). Every output element is written."""
    if values.dtype not in _DTYPES:
        raise ValueError(f"values must be float32 or bfloat16, got "
                         f"{values.dtype}")
    require(values, "values", values.dtype, 2)
    require(receivers, "receivers", torch.int32, 1)
    if edge_mask is not None:
        require(edge_mask, "edge_mask", torch.bool, 1)
    e, d = values.shape
    for name, t in (("receivers", receivers), ("edge_mask", edge_mask)):
        if t is not None and (t.shape[0] != e or t.device != values.device):
            raise ValueError(f"{name} must be ({e},) on {values.device}")
    if not 0 <= n_nodes < INT32_MAX:
        raise ValueError(f"n_nodes must lie in [0, 2**31 - 1), got {n_nodes}")
    out = torch.empty((n_nodes, d), dtype=values.dtype, device=values.device)
    status = _entry()(ptr(values), ptr(receivers), ptr(edge_mask), ptr(out),
                      e, d, n_nodes, _DTYPES[values.dtype],
                      current_stream(values.device))
    check(status, "segment_spmm_sorted")
    return out
